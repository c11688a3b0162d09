"""ray_tpu_torch.rl.dreamer against ray_tpu.rl.dreamer on the same inputs.

One JAX initialization (``init_world_model``) drives both sides through
``params_from_jax``. JAX's draws are handed to the port: the update's
posterior noise is ``normal(split(k_seq, T)[t], (B, latent))`` and its
imagined actions' Gumbel noise ``gumbel(split(split(k_img, H)[h])[0],
(B*T, A))`` (``jax.random.categorical`` is Gumbel-argmax), with
``k_seq, k_img, _ = split(key, 3)``; ``act_step``'s are ``normal(kz)``
and ``gumbel(ka)`` with ``ka, kz = split(key)``. JAX's gradients are read
through an optax transformation that keeps them as its state.
Tolerances (f32, tiny geometry B 4, T 6, H 3, det 16, latent 4, hidden
16): the model steps 1e-6; the loss terms 1e-5 relative; every gradient
leaf within 1e-5 of that leaf's largest magnitude; params after one
``chain(clip_by_global_norm(100), adam)`` step 1e-5. JAX is imported
inside the tests.
"""

import functools

import numpy as np
import pytest
import torch

from ray_tpu_torch._device import tree_leaves, tree_map
from ray_tpu_torch.rl import DreamerConfig
from ray_tpu_torch.rl import dreamer as td
from ray_tpu_torch.rl.ppo import params_from_jax, params_to_numpy
from ray_tpu_torch.train import optim

STEP_TOL = 1e-6
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
UPDATE_TOL = 1e-5
OBS, ACTS, DET, LATENT, HIDDEN = 4, 2, 16, 4, 16
B, T, H = 4, 6, 3
STATIC = (H, 0.99, 0.95, 0.3, 1e-2)  # horizon, gamma, lam, free_bits, ent
LR = 3e-4


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _jax_opts():
    """(the gradient-keeping transformation, Dreamer's optimizer): one
    instance each, so the jitted update compiles once per optimizer."""
    import jax
    import jax.numpy as jnp
    import optax

    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    return keep, optax.chain(optax.clip_by_global_norm(100.0),
                             optax.adam(LR))


def _jax_params(seed=0):
    import jax
    from ray_tpu.rl.dreamer import init_world_model

    return init_world_model(jax.random.PRNGKey(seed), OBS, ACTS, DET,
                            LATENT, HIDDEN)


def _pairs(got, want):
    import jax

    out = []
    tree_map(lambda a, b: out.append((a, b)), got,
             jax.tree.map(np.asarray, want))
    return out


def _close(got, want, tol, label=""):
    for i, (a, b) in enumerate(_pairs(got, want)):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                   err_msg=f"{label} leaf {i}")


def _batch(firsts: str, seed=0):
    rng = np.random.default_rng(seed)
    is_first = np.zeros((B, T), np.float32)
    is_first[:, 0] = 1.0
    if firsts == "inside":  # episodes that start inside the window
        is_first[0, 3] = is_first[2, 1] = is_first[3, 5] = 1.0
    dones = np.zeros((B, T), np.float32)
    dones[0, 2] = dones[2, 0] = 1.0
    return {"obs": rng.normal(size=(B, T, OBS)).astype(np.float32),
            "actions": rng.integers(0, ACTS, (B, T)).astype(np.int32),
            "rewards": (rng.random((B, T)) < 0.8).astype(np.float32),
            "dones": dones, "is_first": is_first}


def _torch_batch(b):
    out = {k: _t(v) for k, v in b.items()}
    out["actions"] = out["actions"].long()
    return out


def _update_noise(key):
    import jax

    k_seq, k_img, _ = jax.random.split(key, 3)
    eps = np.stack([np.asarray(jax.random.normal(k, (B, LATENT)))
                    for k in jax.random.split(k_seq, T)])
    gum = np.stack([np.asarray(jax.random.gumbel(
        jax.random.split(k)[0], (B * T, ACTS)))
        for k in jax.random.split(k_img, H)])
    return {"eps": _t(eps), "gumbel": _t(gum)}


# ------------------------------------------------------------------ model --

def test_gru_and_kl_match_jax():
    import jax.numpy as jnp
    from ray_tpu.rl import dreamer as jd

    p = _jax_params()
    ours = params_from_jax(p, "cpu")
    rng = np.random.default_rng(1)
    h = rng.normal(size=(5, DET)).astype(np.float32)
    x = rng.normal(size=(5, LATENT + ACTS)).astype(np.float32)
    want = np.asarray(jd._gru(p["gru"], jnp.asarray(h), jnp.asarray(x)))
    got = td._gru(ours["gru"], _t(h), _t(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=STEP_TOL)
    args = [rng.normal(size=(5, 3, LATENT)).astype(np.float32) * s
            for s in (1.0, 0.5, 1.0, 0.5)]
    want = np.asarray(jd._kl(*map(jnp.asarray, args)))
    got = td._kl(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=STEP_TOL)


@pytest.mark.parametrize("first", [0.0, 1.0])
def test_obs_step_and_img_step_match_jax(first):
    import jax
    import jax.numpy as jnp
    from ray_tpu.rl import dreamer as jd

    p = _jax_params(1)
    ours = params_from_jax(p, "cpu")
    rng = np.random.default_rng(2)
    N = 6
    h = rng.normal(size=(N, DET)).astype(np.float32)
    z = rng.normal(size=(N, LATENT)).astype(np.float32)
    a1h = np.eye(ACTS, dtype=np.float32)[rng.integers(0, ACTS, N)]
    obs = rng.normal(size=(N, OBS)).astype(np.float32)
    is_first = np.full((N,), first, np.float32)
    is_first[0] = 1.0 - first
    key = jax.random.PRNGKey(3)
    jh, jz, (jmq, jlq) = jd._obs_step(p, jnp.asarray(h), jnp.asarray(z),
                                      jnp.asarray(a1h), jnp.asarray(obs),
                                      jnp.asarray(is_first), key)
    eps = _t(jax.random.normal(key, (N, LATENT)))
    th, tz, (tmq, tlq) = td._obs_step(ours, _t(h), _t(z), _t(a1h), _t(obs),
                                      _t(is_first), eps)
    for got, want in ((th, jh), (tz, jz), (tmq, jmq), (tlq, jlq)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=STEP_TOL, atol=STEP_TOL)
    for mean_latent in (True, False):
        jh, jz = jd._img_step(p, jnp.asarray(h), jnp.asarray(z),
                              jnp.asarray(a1h), key, mean_latent)
        th, tz = td._img_step(ours, _t(h), _t(z), _t(a1h), eps, mean_latent)
        for got, want in ((th, jh), (tz, jz)):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=STEP_TOL,
                                       atol=STEP_TOL)


@pytest.mark.parametrize("greedy", [False, True])
def test_act_step_matches_jax_with_its_gumbel_noise(greedy):
    import jax
    import jax.numpy as jnp
    from ray_tpu.rl.dreamer import act_step

    p = _jax_params(2)
    ours = params_from_jax(p, "cpu")
    rng = np.random.default_rng(4)
    N = 64
    h = rng.normal(size=(N, DET)).astype(np.float32)
    z = rng.normal(size=(N, LATENT)).astype(np.float32)
    a_prev = rng.integers(0, ACTS, N).astype(np.int32)
    obs = rng.normal(size=(N, OBS)).astype(np.float32)
    is_first = (rng.random(N) < 0.3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ja, jh, jz = act_step(ACTS, p, jnp.asarray(h), jnp.asarray(z),
                          jnp.asarray(a_prev), jnp.asarray(obs),
                          jnp.asarray(is_first), key, jnp.asarray(greedy))
    ka, kz = jax.random.split(key)
    noise = {"eps": _t(jax.random.normal(kz, (N, LATENT))),
             "gumbel": _t(jax.random.gumbel(ka, (N, ACTS)))}
    ta, th, tz = td.act_step(ACTS, ours, _t(h), _t(z), _t(a_prev), _t(obs),
                             _t(is_first), noise, greedy)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    if not greedy:
        assert len(set(ta.tolist())) == ACTS
    for got, want in ((th, jh), (tz, jz)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=STEP_TOL, atol=STEP_TOL)


# ----------------------------------------------------------------- update --

@pytest.mark.parametrize("firsts", ["inside", "start"])
def test_dreamer_update_losses_and_every_gradient_match_jax(firsts):
    import jax
    import jax.numpy as jnp
    from ray_tpu.rl.dreamer import dreamer_update

    keep, _ = _jax_opts()
    p = _jax_params(3)
    batch = _batch(firsts)
    bounds = np.asarray([0.0, 1.0], np.float32)
    key = jax.random.PRNGKey(6)
    _, jgrads, jm = dreamer_update(
        keep, STATIC, ACTS, p, keep.init(p),
        jax.tree.map(jnp.asarray, batch), jnp.asarray(bounds), key)
    ours = params_from_jax(p, "cpu")
    total, tm = td.dreamer_loss(STATIC, ACTS, ours, _torch_batch(batch),
                                _t(bounds), _update_noise(key))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_TOL, atol=1e-7, err_msg=k)
    grads = iter(torch.autograd.grad(total, tree_leaves(ours)))
    gtree = tree_map(lambda _: next(grads), ours)
    zero_leaves = 0
    for i, (g, w) in enumerate(_pairs(gtree, jgrads)):
        scale = float(np.abs(w).max())
        zero_leaves += scale == 0.0
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * max(scale, 1e-30),
                                   err_msg=f"gradient leaf {i}")
    # Every head takes a gradient: the actor through imagination, the
    # critic on its regression, the world model on its losses.
    assert zero_leaves <= 3  # the zero-initialized biases only, if any


def test_dreamer_update_step_matches_jax_after_clip_and_adam():
    import jax
    import jax.numpy as jnp
    from ray_tpu.rl.dreamer import dreamer_update

    _, jopt = _jax_opts()
    p = _jax_params(4)
    batch = _batch("inside", seed=1)
    bounds = np.asarray([0.0, 1.0], np.float32)
    key = jax.random.PRNGKey(7)
    jp, js, jm = dreamer_update(jopt, STATIC, ACTS, p, jopt.init(p),
                                jax.tree.map(jnp.asarray, batch),
                                jnp.asarray(bounds), key)
    ours = params_from_jax(p, "cpu")
    topt = optim.chain(optim.clip_by_global_norm(100.0), optim.adam(LR))
    ts = topt.init(ours)
    ours, ts, tm = td.dreamer_update(topt, STATIC, ACTS, ours, ts,
                                     _torch_batch(batch), _t(bounds),
                                     _update_noise(key))
    _close(ours, jp, UPDATE_TOL, "params")
    assert int(ts[1][0].count) == 1
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_TOL, atol=1e-7, err_msg=k)


# -------------------------------------------------------------- trainable --

def _tiny(**kw):
    return DreamerConfig(num_envs=4, env_steps_per_iter=48,
                         learning_starts=96, train_steps_per_iter=2,
                         batch_seqs=B, seq_len=T, horizon=H, det=DET,
                         latent=LATENT, hidden=HIDDEN, buffer_size=64,
                         device="cpu", **kw)


def test_dreamer_steps_past_learning_starts_and_checkpoints():
    algo = _tiny().build()
    first = algo.step()
    assert first["env_steps"] == 48 and "wm_loss" not in first
    ms = [algo.step() for _ in range(3)]  # the ring wraps at 64 rows
    assert algo._full and ms[-1]["env_steps"] == 192
    assert all(np.isfinite(m["wm_loss"]) and np.isfinite(m["actor_loss"])
               for m in ms[1:])
    assert int(algo.opt_state[1][0].count) == 2 * 3
    ckpt = algo.save_checkpoint()
    assert all(isinstance(x, np.ndarray)
               for x in tree_leaves(ckpt["params"]))
    other = _tiny().build()
    other.load_checkpoint(ckpt)
    for a, b in zip(tree_leaves(params_to_numpy(other.params)),
                    tree_leaves(params_to_numpy(algo.params))):
        np.testing.assert_array_equal(a, b)
    assert other.iteration == algo.iteration == 4
    assert int(other.opt_state[1][0].count) == 6
    other._collect(96)
    other.step()


def test_dreamer_trainable_follows_jax_step_for_step_given_its_draws():
    """The port's Trainable (acting, the ring, observation normalization,
    reward bounds, updates) against JAX's from JAX's params, fed the draws
    JAX's takes from its key: the same actions, episodes and ring, and
    params within 1e-5 after every iteration."""
    import jax
    from ray_tpu.rl.dreamer import DreamerConfig as JConfig

    kw = dict(num_envs=4, env_steps_per_iter=48, learning_starts=96,
              train_steps_per_iter=2, batch_seqs=B, seq_len=T, horizon=H,
              det=DET, latent=LATENT, hidden=HIDDEN, buffer_size=64, seed=3)
    jalgo = JConfig(**kw).build()
    jalgo.optimizer = _jax_opts()[1]  # the same chain: one compile
    jalgo.opt_state = jalgo.optimizer.init(jalgo.params)
    ours = DreamerConfig(**kw, device="cpu").build()
    ours.params = params_from_jax(jalgo.params, "cpu")
    ours.opt_state = ours.optimizer.init(ours.params)
    key = [jax.random.split(jax.random.PRNGKey(kw["seed"]))[0]]

    def next_key():
        key[0], k = jax.random.split(key[0])
        return k

    def act_noise():
        ka, kz = jax.random.split(next_key())
        return {"eps": _t(jax.random.normal(kz, (kw["num_envs"], LATENT))),
                "gumbel": _t(jax.random.gumbel(ka, (kw["num_envs"], ACTS)))}

    ours._act_noise = act_noise
    ours._update_noise = lambda: _update_noise(next_key())
    for it in range(4):
        jm, tm = jalgo.step(), ours.step()
        assert tm["env_steps"] == jm["env_steps"]
        assert tm["episode_return_mean"] == jm["episode_return_mean"]
        assert ours._ep_returns == jalgo._ep_returns
        for name in ("_obs", "_act", "_rew", "_done", "_first"):
            np.testing.assert_array_equal(getattr(ours, name),
                                          getattr(jalgo, name))
        np.testing.assert_array_equal(ours._obs_mean, jalgo._obs_mean)
        np.testing.assert_array_equal(ours._is_first, jalgo._is_first)
        _close(ours.params, jalgo.params, UPDATE_TOL, f"iteration {it}")
        for k in set(jm) - {"training_iteration", "env_steps",
                            "episode_return_mean"}:
            np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_TOL,
                                       atol=1e-6, err_msg=k)
    assert jalgo._full and "wm_loss" in tm


def test_ring_windows_never_straddle_the_write_seam():
    """Once the ring is full, every sampled window holds consecutive
    writes: with each slot's reward set to its write order, the rewards
    along a window rise by one."""
    algo = _tiny().build()
    algo._collect(96)
    n = algo.cfg.buffer_size
    assert algo._full and algo._idx != 0
    algo._rew[:] = (np.arange(n) - algo._idx) % n  # 0 = the oldest write
    for _ in range(200):
        r = algo._sample_batch()["rewards"].numpy()
        np.testing.assert_array_equal(np.diff(r, axis=1), 1.0)


def test_config_defaults_to_the_card_and_refuses_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    cfg = DreamerConfig()
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cfg.build()
