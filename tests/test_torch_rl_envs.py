"""ray_tpu_torch.rl's environments, connectors, replay buffers and
EnvRunner against ray_tpu.rl's on the same inputs.

The numpy modules are the port's own copies: at the same seeds and
actions they must give identical outputs (exact). The batched torch envs
(``rl/vec_env.py``) take 256 states drawn with numpy and step once beside
``jax.vmap`` of JAX's single-env ``step``: CartPole within 1e-6 abs with
equal dones (f32 on both sides), Catch and GridWorld exactly. JAX is
imported inside the tests that compare against it, so the ``cuda`` tests
run on a card machine that has no JAX.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.rl import connectors as tc
from ray_tpu_torch.rl import vec_env as tv
from ray_tpu_torch.rl.env import CartPoleEnv, PendulumEnv, VectorEnv
from ray_tpu_torch.rl.env_runner import EnvRunner, EnvRunnerGroup
from ray_tpu_torch.rl.replay import PrioritizedReplayBuffer, ReplayBuffer

N = 256
CARTPOLE_TOL = 1e-6


def _cpu_gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------------ numpy copies --

@pytest.mark.parametrize("name", ["CartPole-v1", "Pendulum-v1"])
def test_numpy_env_matches_jax_package(name):
    from ray_tpu.rl import env as jenv
    from ray_tpu_torch.rl import env as penv

    rng = np.random.default_rng(3)
    for seed in range(3):
        a, b = penv.make_env(name, seed=seed), jenv.make_env(name, seed=seed)
        np.testing.assert_array_equal(a.reset(), b.reset())
        for _ in range(60):
            act = (rng.uniform(-3, 3, size=1) if name == "Pendulum-v1"
                   else int(rng.integers(0, 2)))
            ra, rb = a.step(act), b.step(act)
            for x, y in zip(ra, rb):
                np.testing.assert_array_equal(x, y)
            if ra[2] or ra[3]:
                np.testing.assert_array_equal(a.reset(), b.reset())


def test_vector_env_matches_jax_package():
    from ray_tpu.rl.env import VectorEnv as JVectorEnv

    a, b = VectorEnv("CartPole-v1", 6, seed=5), JVectorEnv("CartPole-v1", 6,
                                                            seed=5)
    np.testing.assert_array_equal(a.reset(), b.reset())
    rng = np.random.default_rng(0)
    for _ in range(80):
        acts = rng.integers(0, 2, 6)
        for x, y in zip(a.step(acts), b.step(acts)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a.last_terminals, b.last_terminals)
        np.testing.assert_array_equal(a.last_final_obs, b.last_final_obs)
    assert a.drain_episode_returns() == b.drain_episode_returns()


def test_unknown_env_and_register():
    from ray_tpu_torch.rl.env import make_env, register_env

    with pytest.raises(ValueError, match="register_env"):
        make_env("NoSuchEnv-v0")
    register_env("PortCartPole-v9", CartPoleEnv)
    assert isinstance(make_env("PortCartPole-v9"), CartPoleEnv)
    assert PendulumEnv.action_limit == 2.0


def _connector_pairs():
    from ray_tpu.rl import connectors as jc

    return [
        (tc.NormalizeObservations(clip=5.0), jc.NormalizeObservations(
            clip=5.0)),
        (tc.FrameStack(3), jc.FrameStack(3)),
        (tc.ClipObservations(-0.5, 0.5), jc.ClipObservations(-0.5, 0.5)),
        (tc.ConnectorPipeline([tc.NormalizeObservations(), tc.FrameStack(2)]),
         jc.ConnectorPipeline([jc.NormalizeObservations(),
                               jc.FrameStack(2)])),
    ]


def test_connectors_match_jax_package():
    from ray_tpu.rl import connectors as jc

    rng = np.random.default_rng(1)
    for a, b in _connector_pairs():
        for step in range(6):
            x = rng.normal(size=(4, 3)).astype(np.float32) * 3
            if step == 3:
                a.reset(1)
                b.reset(1)
            np.testing.assert_array_equal(a(x), b(x))
            if hasattr(a, "frozen_apply"):
                np.testing.assert_array_equal(a.frozen_apply(x),
                                              b.frozen_apply(x))
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        a.set_state(sa)
        x = rng.normal(size=(4, 3)).astype(np.float32)
        np.testing.assert_array_equal(a(x), b(x))
        assert getattr(a, "output_multiplier", 1) == getattr(
            b, "output_multiplier", 1)
    acts = rng.normal(size=(5, 2)) * 3
    np.testing.assert_array_equal(tc.ClipActions(2.0)(acts),
                                  jc.ClipActions(2.0)(acts))
    np.testing.assert_array_equal(tc.UnsquashActions(2.0)(acts),
                                  jc.UnsquashActions(2.0)(acts))


@pytest.mark.parametrize("prioritized", [False, True])
@pytest.mark.parametrize("action_size", [None, 2])
def test_replay_buffers_match_jax_package(prioritized, action_size):
    from ray_tpu.rl import replay as jr

    cls_p = PrioritizedReplayBuffer if prioritized else ReplayBuffer
    cls_j = jr.PrioritizedReplayBuffer if prioritized else jr.ReplayBuffer
    a = cls_p(50, 3, seed=7, action_size=action_size)
    b = cls_j(50, 3, seed=7, action_size=action_size)
    rng = np.random.default_rng(2)
    for _ in range(4):
        n = 20
        acts = (rng.integers(0, 2, n) if action_size is None
                else rng.normal(size=(n, action_size)))
        args = (rng.normal(size=(n, 3)), acts, rng.normal(size=n),
                rng.normal(size=(n, 3)), rng.integers(0, 2, n))
        a.add_batch(*args)
        b.add_batch(*args)
        sa, sb = a.sample(16), b.sample(16)
        assert sa.keys() == sb.keys()
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k])
        if prioritized:
            td = rng.normal(size=16)
            a.update_priorities(sa["idx"], td)
            b.update_priorities(sb["idx"], td)
    assert len(a) == len(b) == 50


def _fixed_act(params, obs, seed):
    """A deterministic policy both packages' EnvRunners can call."""
    r = np.random.default_rng(seed)
    n = len(obs)
    return (r.integers(0, 2, n), r.normal(size=n).astype(np.float32),
            obs.sum(-1).astype(np.float32))


def test_env_runner_matches_jax_package():
    from ray_tpu.rl.env_runner import EnvRunner as JEnvRunner

    kw = dict(seed=4, env_to_module=None, module_to_env=None)
    a = EnvRunner("CartPole-v1", 3, 40, lambda: (_fixed_act, None), **kw)
    b = JEnvRunner("CartPole-v1", 3, 40, lambda: (_fixed_act, None), **kw)
    for _ in range(2):
        sa, sb = a.sample(), b.sample()
        assert sa.keys() == sb.keys()
        for k in sa:
            np.testing.assert_array_equal(np.asarray(sa[k]),
                                          np.asarray(sb[k]), err_msg=k)


def test_env_runner_group_inline_and_runner_actors_refused():
    g = EnvRunnerGroup("CartPole-v1", num_envs_per_runner=2, rollout_len=8,
                       policy_factory=lambda: (_fixed_act, None), seed=1)
    (s,) = g.sample(None)
    assert s["obs"].shape == (8, 2, 4)
    assert g.connector_state() == {}
    with pytest.raises(NotImplementedError, match="actor runtime"):
        EnvRunnerGroup("CartPole-v1", num_runners=2,
                       policy_factory=lambda: (_fixed_act, None))


# -------------------------------------------------------- batched torch envs --

def _draw_states(name, rng):
    """N states and actions of env ``name`` drawn with numpy, covering
    terminations and time limits."""
    if name == "CartPole-v1":
        phys = np.stack([rng.uniform(-2.5, 2.5, N), rng.uniform(-2, 2, N),
                         rng.uniform(-0.25, 0.25, N),
                         rng.uniform(-2, 2, N)], -1).astype(np.float32)
        state = {"phys": phys,
                 "steps": rng.integers(480, 500, N).astype(np.int32)}
        return state, rng.integers(0, 2, N).astype(np.int32)
    if name == "Catch-v0":
        state = {"ball_x": rng.integers(0, 5, N).astype(np.int32),
                 "ball_y": rng.integers(0, 9, N).astype(np.int32),
                 "paddle_x": rng.integers(0, 5, N).astype(np.int32)}
        return state, rng.integers(0, 3, N).astype(np.int32)
    state = {"row": rng.integers(0, 5, N).astype(np.int32),
             "col": rng.integers(0, 5, N).astype(np.int32),
             "steps": rng.integers(30, 40, N).astype(np.int32)}
    return state, rng.integers(0, 4, N).astype(np.int32)


def _torch_state(state, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in state.items()}


@pytest.mark.parametrize("name", ["CartPole-v1", "Catch-v0", "GridWorld-v0"])
def test_vec_env_step_matches_jax(name):
    import jax
    import jax.numpy as jnp
    from ray_tpu.rl.vec_env import make_jax_env

    state, actions = _draw_states(name, np.random.default_rng(11))
    jenv = make_jax_env(name, auto_reset=False)
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    jstate["key"] = jax.random.split(jax.random.PRNGKey(0), N)
    js, jo, jr, jd = jax.vmap(jenv.step)(jstate, jnp.asarray(actions))
    penv = tv.make_vec_env(name, auto_reset=False)
    ps, po, pr, pd = penv.step(_torch_state(state),
                               torch.from_numpy(actions).long())
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    assert po.dtype == pr.dtype == torch.float32 and pd.dtype == torch.bool
    if name == "CartPole-v1":
        assert 0 < int(pd.sum()) < N  # both outcomes drawn
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=0,
                                   atol=CARTPOLE_TOL)
        np.testing.assert_allclose(ps["phys"].numpy(),
                                   np.asarray(js["phys"]), rtol=0,
                                   atol=CARTPOLE_TOL)
    else:
        np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    for k, v in ps.items():
        if k != "phys":
            assert v.dtype == torch.int32, k
            np.testing.assert_array_equal(v.numpy(), np.asarray(js[k]))


@pytest.mark.parametrize("name", ["CartPole-v1", "Catch-v0", "GridWorld-v0"])
def test_vec_env_reset_shapes_and_ranges(name):
    env = tv.make_vec_env(name)
    state, obs = env.reset(N, _cpu_gen(3))
    assert obs.shape == (N, env.observation_size)
    assert obs.dtype == torch.float32
    for v in state.values():
        assert v.shape[0] == N and "key" not in state
    if name == "CartPole-v1":
        assert float(obs.abs().max()) <= 0.05
        assert (state["steps"] == 0).all()
    elif name == "Catch-v0":
        assert set(state["ball_x"].tolist()) == set(range(5))
        assert (obs.sum(-1) == 2).all()
    else:
        assert (obs[:, 0] == 1).all()
    # The generator decides: the same seed, the same draw.
    _, again = env.reset(N, _cpu_gen(3))
    assert torch.equal(obs, again)


@pytest.mark.parametrize("name", ["CartPole-v1", "Catch-v0", "GridWorld-v0"])
def test_autoreset_replaces_only_done_rows(name):
    env = tv.make_vec_env(name)
    state, _ = _draw_states(name, np.random.default_rng(5))
    state = _torch_state(state)
    actions = torch.from_numpy(_draw_states(name, np.random.default_rng(
        6))[1]).long()
    fresh = env.reset(N, _cpu_gen(9))
    s1, o1, r1, d1 = env.env.step(state, actions)
    s2, o2, r2, d2 = env.step(state, actions, fresh=fresh)
    assert torch.equal(d1, d2) and torch.equal(r1, r2)
    assert 0 < int(d2.sum()) < N
    assert torch.equal(o2[d2], fresh[1][d2])
    assert torch.equal(o2[~d2], o1[~d2])
    for k in s2:
        assert torch.equal(s2[k][d2], fresh[0][k][d2])
        assert torch.equal(s2[k][~d2], s1[k][~d2])
    # Drawn from a generator: the same as the explicit fresh draw.
    s3, o3, _, _ = env.step(state, actions, _cpu_gen(9))
    assert torch.equal(o3, o2)


def test_catch_autoresets_after_nine_steps():
    env = tv.make_vec_env("Catch-v0")
    gen = _cpu_gen(0)
    state, _ = env.reset(8, gen)
    stay = torch.ones(8, dtype=torch.long)
    for t in range(9):
        state, obs, reward, done = env.step(state, stay, gen)
        assert bool(done.all()) == (t == 8)
    assert (state["ball_y"] == 0).all()
    assert set(reward.tolist()) <= {-1.0, 1.0}


def test_vec_env_registry():
    assert tv.is_vec_env("CartPole-v1") and not tv.is_vec_env("Pendulum-v1")
    assert isinstance(tv.make_vec_env("Catch-v0"), tv.AutoResetWrapper)
    assert isinstance(tv.make_vec_env("Catch-v0", auto_reset=False),
                      tv.VecCatch)
    with pytest.raises(ValueError, match="register_vec_env"):
        tv.make_vec_env("Nope-v0")
    tv.register_vec_env("ShortCartPole-v0", tv.VecCartPole)
    env = tv.make_vec_env("ShortCartPole-v0", max_steps=3)
    assert env.env.max_steps == 3


def test_vec_cartpole_parity_with_numpy_env():
    """From identical initial states under the same greedy policy, the
    batched torch CartPole reproduces the numpy CartPoleEnv's episodes
    (up to an f32-drift step at the termination boundary), as
    tests/test_rl_vec.py holds JAX's."""
    from ray_tpu_torch.rl.ppo import init_policy, mlp_apply

    params = init_policy(_cpu_gen(42), 4, 2, hidden=16)

    def greedy(obs):
        with torch.no_grad():
            return int(mlp_apply(params["pi"], torch.as_tensor(
                obs, dtype=torch.float32)).argmax())

    venv = tv.VecCartPole()
    for seed in range(4):
        penv = CartPoleEnv(seed=seed)
        obs0 = penv.reset().astype(np.float32)
        state = {"phys": torch.from_numpy(obs0)[None],
                 "steps": torch.zeros(1, dtype=torch.int32)}
        p_ret = v_ret = 0.0
        obs = obs0
        for _ in range(300):
            obs, r, term, trunc = penv.step(greedy(obs))
            p_ret += r
            if term or trunc:
                break
        vobs = torch.from_numpy(obs0)[None]
        for _ in range(300):
            state, vobs, r, done = venv.step(
                state, torch.tensor([greedy(vobs[0].numpy())]))
            v_ret += float(r[0])
            if bool(done[0]):
                break
        assert abs(p_ret - v_ret) <= 2.0, (seed, p_ret, v_ret)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["CartPole-v1", "Catch-v0", "GridWorld-v0"])
def test_vec_env_step_cuda_matches_cpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = tv.make_vec_env(name)
    state, actions = _draw_states(name, np.random.default_rng(12))
    fresh = env.reset(N, _cpu_gen(1))
    cpu = env.step(_torch_state(state), torch.from_numpy(actions).long(),
                   fresh=fresh)
    fresh_cuda = ({k: v.cuda() for k, v in fresh[0].items()},
                  fresh[1].cuda())
    gpu = env.step(_torch_state(state, "cuda"),
                   torch.from_numpy(actions).long().cuda(), fresh=fresh_cuda)
    assert torch.equal(gpu[3].cpu(), cpu[3])
    assert torch.equal(gpu[2].cpu(), cpu[2])
    tol = CARTPOLE_TOL if name == "CartPole-v1" else 0.0
    torch.testing.assert_close(gpu[1].cpu(), cpu[1], rtol=0, atol=tol)
    # A fresh draw on the card lands in range, from the card's generator.
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, obs = env.reset(N, gen)
    assert obs.device.type == "cuda" and obs.shape == cpu[1].shape
