"""ray_tpu_torch.rl's PPO pieces, its update, the Anakin loop (over gloo
ranks too) and its Trainable, against ray_tpu.rl on the same inputs.

One JAX initialization (``ray_tpu.rl.ppo.init_policy``) drives both
sides through ``params_from_jax``; batches are drawn with numpy. JAX's
randomness is reproduced and handed to the port: ``ppo_update`` takes
the permutations ``ppo.py`` draws from its seed, Anakin's ``_update`` the
shift each epoch draws from its key, ``_act`` the actions JAX sampled.
Tolerances (f32): ``mlp_apply``, ``compute_gae`` and ``_act``'s logp
1e-6, its values 1e-6 of the largest (an ulp at ~10 is ~1e-6);
params and stats after 4 epochs x 4 minibatches of adam 1e-5, on one
device and over 2 gloo ranks against ``jax.pmap`` over 2 CPU devices
(the ranks bit-equal). JAX is imported inside the tests, and the ranks
import the port alone.
"""

import os
import pickle
import subprocess
import sys
import tempfile
from functools import partial

import numpy as np
import pytest
import torch

from ray_tpu_torch._device import tree_leaves, tree_map
from ray_tpu_torch._spawn import run_ranks
from ray_tpu_torch.rl import PPOConfig
from ray_tpu_torch.rl import anakin as tanakin
from ray_tpu_torch.rl import ppo as tppo
from ray_tpu_torch.train.optim import adam

F32_TOL = 1e-6
UPDATE_TOL = 1e-5
LR = 3e-4
STATIC = (0.2, 0.5, 0.01, 4, 4)  # clip, vf_coef, ent_coef, num_mb, epochs
RANK_TIMEOUT_S = 120


def _jax_params(seed=0, obs=4, actions=2, hidden=64):
    import jax
    from ray_tpu.rl.ppo import init_policy

    return init_policy(jax.random.PRNGKey(seed), obs, actions, hidden)


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _pairs(got, want) -> list:
    """(got, want) leaf pairs matched by dict key and list position (JAX's
    leaf order sorts dict keys; the port's keeps insertion order)."""
    out = []
    tree_map(lambda a, b: out.append((a, b)), got, _np_tree(want))
    return out


def _assert_trees_close(got, want, tol, label=""):
    for i, (a, b) in enumerate(_pairs(got, want)):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol,
                                   err_msg=f"{label} leaf {i}")


def _batch(rng, params, B):
    """A flat PPO batch whose behaviour log-probs come from ``params``'s
    policy plus noise (ratios near 1: some clip, some do not)."""
    from ray_tpu.rl.ppo import mlp_apply
    import jax

    obs = rng.normal(size=(B, 4)).astype(np.float32)
    actions = rng.integers(0, 2, B).astype(np.int32)
    logp_all = np.asarray(jax.nn.log_softmax(mlp_apply(params["pi"], obs)))
    logp = logp_all[np.arange(B), actions] + rng.normal(
        scale=0.3, size=B).astype(np.float32)
    return {"obs": obs, "actions": actions, "logp": logp.astype(np.float32),
            "advantages": rng.normal(size=B).astype(np.float32),
            "returns": rng.normal(size=B).astype(np.float32) * 5}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k == "actions"
            else torch.from_numpy(v) for k, v in batch.items()}


# ----------------------------------------------------------------- pieces --

def test_mlp_apply_and_params_layout_match_jax():
    from ray_tpu.rl.ppo import mlp_apply

    params = _jax_params(hidden=32)
    ours = tppo.params_from_jax(params, "cpu")
    assert isinstance(ours["pi"], list) and ours["pi"][0]["w"].shape == (4, 32)
    assert all(t.requires_grad for t in tree_leaves(ours))
    x = np.random.default_rng(0).normal(size=(7, 3, 4)).astype(np.float32)
    for head in ("pi", "vf"):
        got = tppo.mlp_apply(ours[head], torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(mlp_apply(params[head], x)),
                                   rtol=F32_TOL, atol=F32_TOL)
    for a, b in _pairs(tppo.params_to_numpy(ours), params):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b)


def test_init_policy_sizes_and_scales():
    p = tppo.init_policy(torch.Generator().manual_seed(0), 4, 3, 64)
    assert [l["w"].shape for l in p["pi"]] == [(4, 64), (64, 64), (64, 3)]
    assert [l["w"].shape for l in p["vf"]] == [(4, 64), (64, 64), (64, 1)]
    p = tppo.params_to_numpy(p)
    assert p["pi"][2]["w"].std() < 0.05  # scale_last 0.01
    assert 0.5 < p["vf"][2]["w"].std() < 1.5  # scale_last 1
    assert all(not l["b"].any() for l in p["pi"] + p["vf"])
    again = tppo.init_policy(torch.Generator().manual_seed(0), 4, 3, 64)
    assert all(np.array_equal(a, b.detach().numpy()) for a, b in
               zip(tree_leaves(p), tree_leaves(again)))


def test_compute_gae_matches_jax():
    import jax.numpy as jnp
    from ray_tpu.rl.ppo import compute_gae

    rng = np.random.default_rng(1)
    T, N = 33, 9
    r = rng.normal(size=(T, N)).astype(np.float32)
    v = rng.normal(size=(T, N)).astype(np.float32)
    d = rng.random((T, N)) < 0.1
    last = rng.normal(size=N).astype(np.float32)
    ja, jr = compute_gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(d),
                         jnp.asarray(last), 0.99, 0.95)
    pa, pr = tppo.compute_gae(torch.from_numpy(r), torch.from_numpy(v),
                              torch.from_numpy(d), torch.from_numpy(last),
                              0.99, 0.95)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=F32_TOL,
                               atol=F32_TOL)


def test_compute_gae_resets_at_done():
    adv, _ = tppo.compute_gae(torch.ones(2, 1), torch.zeros(2, 1),
                              torch.tensor([[True], [False]]),
                              torch.tensor([10.0]), 0.9, 1.0)
    assert adv[:, 0].tolist() == pytest.approx([1.0, 1.0 + 0.9 * 10.0])


def test_act_matches_jax_for_jax_actions():
    import jax.numpy as jnp
    from ray_tpu.rl.ppo import _act

    params = _jax_params()
    obs = np.random.default_rng(2).normal(size=(64, 4)).astype(np.float32)
    ja, jlp, jv = _act(params, jnp.asarray(obs), 7)
    ours = tppo.params_from_jax(params, "cpu")
    a, lp, v = tppo._act(ours, torch.from_numpy(obs),
                         actions=torch.from_numpy(np.array(ja)))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=F32_TOL,
                               atol=F32_TOL)
    # The values run to ~10, where an f32 ulp is ~1e-6 and both packages
    # sit ~2e-6 from the f64 value: 1e-6 of the largest |value|.
    scale = float(np.abs(np.asarray(jv)).max())
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0,
                               atol=F32_TOL * scale)


def test_gumbel_max_sampling_follows_the_policy():
    logits = torch.log(torch.tensor([[0.1, 0.6, 0.3]])).expand(20000, 3)
    gen = torch.Generator().manual_seed(0)
    freq = torch.bincount(tppo.sample_categorical(logits, gen),
                          minlength=3).float() / 20000
    assert torch.allclose(freq, torch.tensor([0.1, 0.6, 0.3]), atol=0.015)
    again = tppo.sample_categorical(logits, torch.Generator().manual_seed(0))
    assert torch.equal(again, tppo.sample_categorical(
        logits, torch.Generator().manual_seed(0)))


# ---------------------------------------------------------------- updates --

def test_ppo_update_matches_jax_with_its_permutations():
    import jax
    import optax
    from ray_tpu.rl.ppo import ppo_update

    params = _jax_params()
    rng = np.random.default_rng(3)
    B, seed = 256, 5
    batch = _batch(rng, params, B)
    opt = optax.adam(LR)
    jp, _, jstats = ppo_update(opt, STATIC, params, opt.init(params),
                               jax.tree.map(jax.numpy.asarray, batch), seed)
    num_mb, epochs = STATIC[3], STATIC[4]
    mb = B // num_mb
    idxs = np.stack([
        np.asarray(jax.random.permutation(k, B))[: num_mb * mb].reshape(
            num_mb, mb)
        for k in jax.random.split(jax.random.PRNGKey(seed), epochs)])
    ours = tppo.params_from_jax(params, "cpu")
    topt = adam(LR)
    pp, state, pstats = tppo.ppo_update(
        topt, STATIC, ours, topt.init(ours), _torch_batch(batch),
        torch.from_numpy(idxs).long())
    _assert_trees_close(pp, jp, UPDATE_TOL, "params")
    assert int(state[0].count) == epochs * num_mb
    for k in ("policy_loss", "vf_loss", "entropy"):
        np.testing.assert_allclose(float(pstats[k]), float(jstats[k]),
                                   rtol=UPDATE_TOL, atol=UPDATE_TOL)


def _jax_shifts(key, B, epochs):
    import jax

    return np.asarray([int(jax.random.randint(k, (), 0, B))
                       for k in jax.random.split(key, epochs)])


def test_rolled_idxs_match_jax_roll():
    import jax.numpy as jnp

    B, num_mb = 48, 4
    shifts = np.array([0, 5, 47, 13])
    got = tanakin.rolled_idxs(torch.from_numpy(shifts), B, num_mb)
    for e, s in enumerate(shifts):
        want = np.asarray(jnp.roll(jnp.arange(B), s).reshape(
            B // num_mb, num_mb).T)
        np.testing.assert_array_equal(got[e].numpy(), want)


def test_anakin_update_matches_jax_with_its_shifts():
    import jax
    import optax
    from ray_tpu.rl.anakin import _AXIS, _update

    params = _jax_params()
    B = 256
    batch = _batch(np.random.default_rng(4), params, B)
    key = jax.random.PRNGKey(9)
    opt = optax.adam(LR)
    dev = jax.devices()[:1]
    rep = lambda t: jax.device_put_replicated(t, dev)
    f = jax.pmap(partial(_update, opt, STATIC), axis_name=_AXIS, devices=dev)
    jp, _, jstats = f(rep(params), rep(opt.init(params)),
                      jax.tree.map(lambda x: x[None], batch), key[None])
    jp = jax.tree.map(lambda x: x[0], jp)
    shifts = _jax_shifts(key, B, STATIC[4])
    ours = tppo.params_from_jax(params, "cpu")
    topt = adam(LR)
    pp, _, pstats = tanakin._update(topt, STATIC, ours, topt.init(ours),
                                    _torch_batch(batch),
                                    torch.from_numpy(shifts))
    _assert_trees_close(pp, jp, UPDATE_TOL, "params")
    for k in ("policy_loss", "vf_loss", "entropy"):
        np.testing.assert_allclose(float(pstats[k]), float(jstats[k][0]),
                                   rtol=UPDATE_TOL, atol=UPDATE_TOL)


# ------------------------------------------------------------ over ranks --

def _rank_anakin(rank, world, store, tmp, port):
    """One gloo rank: the Anakin update on this rank's batch and shifts
    (gradients averaged over the group), then AnakinPPO for two calls;
    writes its params after each."""
    import torch.distributed as dist
    from ray_tpu_torch.train.backend import init_distributed

    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    data = np.load(os.path.join(tmp, "inputs.npz"))
    with open(os.path.join(tmp, "params.pkl"), "rb") as f:
        params = pickle.load(f)  # a numpy tree this test wrote
    ours = tppo.params_from_jax(params, "cpu")
    batch = {k[6:]: torch.from_numpy(data[k][rank]) for k in data.files
             if k.startswith("batch_")}
    batch["actions"] = batch["actions"].long()
    opt = adam(LR)
    pp, _, stats = tanakin._update(
        opt, STATIC, ours, opt.init(ours), batch,
        torch.from_numpy(data["shifts"][rank]), dist.group.WORLD)
    out = {"update": tppo.params_to_numpy(pp),
           "stats": {k: float(v) for k, v in stats.items()}}
    algo = PPOConfig(vectorized=True, num_envs=8, unroll_len=16,
                     num_minibatches=2, seed=3, device="cpu").build()
    eng = algo._engine
    out["n_local"], out["num_devices"] = eng.n_local, eng.num_devices
    out["anakin"] = []
    for _ in range(2):
        m = algo.train_step()
        out["anakin"].append(tppo.params_to_numpy(eng.params))
    out["metrics"] = m
    out["jax_loaded"] = [m_ for m_ in sys.modules
                         if m_ == "jax" or m_.startswith("jax.")
                         or m_ == "ray_tpu" or m_.startswith("ray_tpu.")]
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def test_anakin_over_two_gloo_ranks_matches_jax_pmap():
    import jax
    import optax
    from ray_tpu.rl.anakin import _AXIS, _update
    from ray_tpu_torch.train.backend import free_port

    devs = jax.devices()[:2]
    if len(devs) < 2:
        pytest.skip("needs 2 virtual CPU devices")
    params = _jax_params()
    B = 128
    rng = np.random.default_rng(6)
    batches = [_batch(rng, params, B) for _ in range(2)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    opt = optax.adam(LR)
    rep = lambda t: jax.device_put_replicated(t, devs)
    f = jax.pmap(partial(_update, opt, STATIC), axis_name=_AXIS, devices=devs)
    jp, _, _ = f(rep(params), rep(opt.init(params)), stacked, keys)
    shifts = np.stack([_jax_shifts(k, B, STATIC[4]) for k in keys])
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "inputs.npz"), shifts=shifts,
                 **{f"batch_{k}": v for k, v in stacked.items()})
        with open(os.path.join(tmp, "params.pkl"), "wb") as fh:
            pickle.dump(_np_tree(params), fh)
        run_ranks(_rank_anakin, 2, tmp, (tmp, free_port()), RANK_TIMEOUT_S)
        res = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                res.append(pickle.load(fh))  # written by this test's ranks
    for r in range(2):
        assert res[r]["jax_loaded"] == []
        assert res[r]["n_local"] == 4 and res[r]["num_devices"] == 2
        _assert_trees_close(res[r]["update"], jax.tree.map(lambda x: x[0], jp),
                            UPDATE_TOL, f"rank {r}")

    def equal(a, b):
        return all(np.array_equal(x, y) for x, y in _pairs(a, b))

    # The ranks' params bit-equal, after the update and after each call.
    assert equal(res[0]["update"], res[1]["update"])
    for call in range(2):
        assert equal(res[0]["anakin"][call], res[1]["anakin"][call])
    assert not equal(res[0]["anakin"][0], res[0]["anakin"][1])
    assert res[0]["metrics"] == res[1]["metrics"]
    assert res[0]["metrics"]["num_env_steps_sampled"] == 8 * 16


def test_pick_num_devices_without_a_group():
    assert tanakin.pick_num_devices(16) == 1
    assert tanakin.pick_num_devices(7) == 1


def test_rollout_driven_by_given_actions():
    """Given actions, the rollout steps the envs with them (the generator
    then feeds only the auto-resets): the same as stepping by hand."""
    from ray_tpu_torch.rl.vec_env import make_vec_env

    env = make_vec_env("CartPole-v1")
    params = tppo.init_policy(torch.Generator().manual_seed(1), 4, 2, 16)
    T, N = 40, 6
    actions = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2, (T, N)))
    state, obs = env.reset(N, torch.Generator().manual_seed(2))
    rollout = tanakin.make_rollout_fn(env, tanakin._apply_pi,
                                      tanakin._apply_vf, T)
    (s2, o2, ep_ret), traj, stats = rollout(
        params, state, obs, torch.zeros(N), torch.Generator().manual_seed(3),
        actions=actions)
    gen = torch.Generator().manual_seed(3)
    want_ret, done_sum, ret_sum = torch.zeros(N), 0.0, 0.0
    for t in range(T):
        _, lp, v = tppo._act(params, obs, actions=actions[t])
        assert torch.equal(traj["obs"][t], obs)
        assert torch.equal(traj["logp"][t], lp)
        assert torch.equal(traj["values"][t], v)
        state, obs, r, d = env.step(state, actions[t], gen)
        assert torch.equal(traj["rewards"][t], r)
        assert torch.equal(traj["dones"][t], d)
        want_ret = want_ret + r
        ret_sum += float((want_ret * d).sum())
        done_sum += float(d.sum())
        want_ret = torch.where(d, 0.0, want_ret)
    assert torch.equal(traj["actions"], actions) and torch.equal(o2, obs)
    assert torch.equal(ep_ret, want_ret) and done_sum > 0
    assert float(stats["count"]) == done_sum
    assert float(stats["ret_sum"]) == pytest.approx(ret_sum)


# ------------------------------------------------------------- trainables --

def test_anakin_learns_and_checkpoints():
    """Return rises by more than 10 over a few calls (as
    tests/test_rl_vec.py asks of JAX) and the params round-trip."""
    cfg = PPOConfig(vectorized=True, num_envs=16, unroll_len=64,
                    num_minibatches=4, seed=0, device="cpu",
                    extra={"iters_per_step": 4})
    algo = cfg.build()
    first = algo.train_step()
    assert first["num_env_steps_sampled"] == 4 * 16 * 64
    assert {"episode_return_mean", "policy_loss", "vf_loss",
            "entropy", "episodes_completed"} <= set(first)
    best = 0.0
    for _ in range(6):
        best = max(best, algo.train_step()["episode_return_mean"])
    assert best > first["episode_return_mean"] + 10, (first, best)
    ckpt = algo.save_checkpoint()
    assert all(isinstance(x, np.ndarray) for x in tree_leaves(ckpt["params"]))
    fresh = cfg.build()
    fresh.load_checkpoint(ckpt)
    for a, b in zip(tree_leaves(fresh._engine.params),
                    tree_leaves(algo._engine.params)):
        assert torch.equal(a, b)


_SYNC_OPS = {"aten::_local_scalar_dense", "aten::nonzero",
             "aten::masked_select", "aten::masked_scatter"}


def test_anakin_step_waits_for_the_host_once():
    """Inside one step() no op reads a tensor's value on the host (no
    item/bool/float, nonzero, boolean-mask op: their aten ops are
    counted under a dispatch mode), and the stats come back in one copy
    (Tensor.cpu counted)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.syncs = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func._schema.name
            if name in _SYNC_OPS:
                self.syncs.append(name)
            if name == "aten::index" and any(
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool
                    for i in (args[1] if len(args) > 1 else [])):
                self.syncs.append("boolean index")
            return func(*args, **(kwargs or {}))

    algo = PPOConfig(vectorized=True, num_envs=8, unroll_len=8,
                     num_minibatches=2, device="cpu",
                     extra={"iters_per_step": 2}).build()
    algo.train_step()  # a warm call
    copies = []
    real_cpu = torch.Tensor.cpu

    def counted_cpu(self, *a, **k):
        copies.append(tuple(self.shape))
        return real_cpu(self, *a, **k)

    torch.Tensor.cpu = counted_cpu
    try:
        with Count() as mode:
            algo.train_step()
    finally:
        torch.Tensor.cpu = real_cpu
    assert mode.syncs == []
    assert copies == [(2, 5)]  # [iters, 5 stats], once


def test_ppo_solves_cartpole():
    """The headline learning test on the EnvRunner path (as
    tests/test_rl.py holds JAX's PPO): best >= 150 within 50 steps."""
    torch.manual_seed(0)
    algo = PPOConfig(num_envs_per_runner=8, rollout_len=128, lr=3e-4,
                     seed=0, device="cpu").build()
    best = 0.0
    for _ in range(50):
        best = max(best, algo.train_step()["episode_return_mean"])
        if best >= 150.0:
            break
    algo.cleanup()
    assert best >= 150.0, f"PPO failed to learn CartPole: best {best}"


def test_ppo_checkpoint_crosses_to_and_from_jax():
    import jax.numpy as jnp
    from ray_tpu.rl import PPOConfig as JPPOConfig
    from ray_tpu.rl.ppo import mlp_apply

    obs = np.random.default_rng(8).normal(size=(16, 4)).astype(np.float32)
    jalgo = JPPOConfig(num_envs_per_runner=2, rollout_len=8, seed=1).build()
    ours = PPOConfig(num_envs_per_runner=2, rollout_len=8, seed=2,
                     device="cpu").build()
    try:
        # JAX -> port
        ours.load_checkpoint(jalgo.save_checkpoint())
        got = tppo.mlp_apply(ours.params["pi"], torch.from_numpy(obs))
        want = np.asarray(mlp_apply(jalgo.params["pi"], jnp.asarray(obs)))
        np.testing.assert_allclose(got.detach().numpy(), want,
                                   rtol=F32_TOL, atol=F32_TOL)
        # port -> JAX, after a step of the port's own
        ours.train_step()
        jalgo.load_checkpoint(ours.save_checkpoint())
        got = tppo.mlp_apply(ours.params["pi"], torch.from_numpy(obs))
        want = np.asarray(mlp_apply(jalgo.params["pi"], jnp.asarray(obs)))
        np.testing.assert_allclose(got.detach().numpy(), want,
                                   rtol=F32_TOL, atol=F32_TOL)
        assert jalgo.iteration == ours.iteration == 1
    finally:
        jalgo.cleanup()
        ours.cleanup()


def test_vectorized_falls_back_for_numpy_envs_and_refuses_sebulba():
    from ray_tpu_torch.rl.env import register_env

    class TinyEnv:
        observation_size = 2
        num_actions = 2

        def __init__(self, seed=0):
            self._t = 0

        def reset(self):
            self._t = 0
            return np.zeros(2, np.float32)

        def step(self, action):
            self._t += 1
            return (np.zeros(2, np.float32), 1.0, False, self._t >= 8)

    register_env("TinyPortEnv-v0", TinyEnv)
    algo = PPOConfig(env="TinyPortEnv-v0", vectorized=True,
                     num_envs_per_runner=2, rollout_len=16,
                     num_minibatches=2, seed=0, device="cpu").build()
    assert algo._engine is None and algo.runners is not None
    assert algo.train_step()["num_env_steps_sampled"] == 2 * 16
    with pytest.raises(NotImplementedError, match="Sebulba"):
        PPOConfig(vectorized=True, num_env_runners=2, device="cpu").build()
    with pytest.raises(NotImplementedError, match="actor runtime"):
        PPOConfig(num_env_runners=2, device="cpu").build()


def test_import_loads_neither_jax_nor_ray_tpu():
    code = ("import sys, ray_tpu_torch.rl, ray_tpu_torch.tune\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'ray_tpu' or "
            "m.startswith('ray_tpu.'))\n"
            "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


# ------------------------------------------------------------------ card --

@pytest.mark.cuda
def test_ppo_update_cuda_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(10)
    params = tppo.params_to_numpy(tppo.init_policy(
        torch.Generator().manual_seed(0), 4, 2, 64))
    B = 4096
    batch = {"obs": rng.normal(size=(B, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, B),
             "logp": np.full(B, np.log(0.5), np.float32),
             "advantages": rng.normal(size=B).astype(np.float32),
             "returns": rng.normal(size=B).astype(np.float32)}
    idxs = torch.stack([torch.randperm(B)[:B].reshape(4, B // 4)
                        for _ in range(4)])
    out = {}
    for dev in ("cpu", "cuda"):
        p = tppo.params_from_jax(params, dev)
        opt = adam(LR)
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        p, _, stats = tppo.ppo_update(opt, STATIC, p, opt.init(p), b,
                                      idxs.to(dev))
        out[dev] = (p, stats)
    for a, b in zip(tree_leaves(out["cuda"][0]), tree_leaves(out["cpu"][0])):
        torch.testing.assert_close(a.detach().cpu(), b.detach(),
                                   rtol=1e-4, atol=1e-4)
    for k, v in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k].cpu(), v, rtol=1e-4,
                                   atol=1e-4)
