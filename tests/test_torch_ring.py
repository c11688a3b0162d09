"""ray_tpu_torch's ring attention and its chunk kernels' twins against the
JAX package's, on the same inputs.

Inputs come from numpy with fixed seeds (the Llama params from the port's
seeded ``init_params``) and go through both sides. The JAX side runs its
Pallas chunk kernels as tests/test_ops.py runs them on the CPU (interpret
mode, ``attn_mod.INTERPRET``); the port runs K6/K7's plain twins, which is
what ``flash_attention_chunk`` does with CPU tensors.

Ranks: the tests over a process group spawn 2 ranks through
``ray_tpu_torch._spawn.run_ranks`` (``start_method="spawn"``) that meet in a
gloo group over a ``FileStore`` under a temporary directory, and import
torch and the port alone; JAX is imported only in the functions that
compute references. The ranks are joined within 120 s, then killed, and
the tests fail.

Tolerances:
- twins against the Pallas chunk kernels, bf16 inputs, both walking 64-wide
  kv tiles: one bf16 ulp of each output's largest value (out in f32, dq,
  dk, dv), lse within 2e-4 (l sums bf16 p in another order). The TPU
  kernel rounds each q head's dk/dv to bf16 before the f32 fold, where K7
  and its twin fold in f32 and round once: at GQA rep 2 that moves dk/dv
  by up to one ulp here;
- rings in f32 against JAX's rings: 2e-5 on the output and 1e-4 of each
  gradient's largest value (sums in other orders only);
- Llama: hidden states within 1e-4 of JAX's shard_map forward, f32; the
  all-reduced context-parallel gradients within 1e-4 of each leaf's largest
  value of the port's own sp_axis=None gradients.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu_torch._device import tree_leaves, tree_map
from ray_tpu_torch._spawn import run_ranks
from ray_tpu_torch.models import llama
from ray_tpu_torch.ops import attention as att
from ray_tpu_torch.ops import ring_attention as ra

RANK_TIMEOUT_S = 120
SP = 2  # ranks of the gloo ring


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _bf16_ulp_err(got, want) -> float:
    """Max abs error in bf16 ulps of the reference's largest value."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(got - want).max() / ulp)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# --------------------------------------------------------------------------
# K6/K7 twins against the Pallas chunk kernels
# --------------------------------------------------------------------------

S_CHUNK = 128
# (qpos offset, kpos offset): the diagonal chunk, a wholly visible past
# chunk, a wholly masked future chunk, offsets that are no multiple of 64.
POSITIONS = {"diagonal": (128, 128), "past": (256, 0), "future": (0, 256),
             "offset": (100, 37)}
CHUNK_CASES = [(rep, causal, where) for rep in (1, 2)
               for causal in (True, False) for where in POSITIONS
               if causal or where == "diagonal"]


def _chunk_inputs(rep, where, seed=0):
    h, d = 4, 64
    q, k, v, g, gl = _arrays([(1, h, S_CHUNK, d), (1, h // rep, S_CHUNK, d),
                              (1, h // rep, S_CHUNK, d), (1, h, S_CHUNK, d),
                              (1, h, S_CHUNK)], seed + rep)
    q0, k0 = POSITIONS[where]
    qpos = np.arange(S_CHUNK, dtype=np.int32) + q0
    kpos = np.arange(S_CHUNK, dtype=np.int32) + k0
    return q, k, v, g, gl, qpos, kpos


def _interpret():
    import ray_tpu.ops.attention as attn_mod

    class _Ctx:
        def __enter__(self):
            self.old = attn_mod.INTERPRET
            attn_mod.INTERPRET = True
            return attn_mod

        def __exit__(self, *exc):
            attn_mod.INTERPRET = self.old

    return _Ctx()


@pytest.mark.parametrize("rep,causal,where", CHUNK_CASES)
def test_chunk_fwd_twin_matches_pallas_interpret(rep, causal, where):
    """K6's twin (out f32, lse) against _flash_chunk_fwd_pallas on the same
    bf16 inputs and global positions, 64-wide kv blocks on both sides."""
    import jax.numpy as jnp

    q, k, v, _, _, qpos, kpos = _chunk_inputs(rep, where)
    with _interpret() as attn_mod:
        want_o, want_lse = attn_mod._flash_chunk_fwd_pallas(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
            jnp.asarray(qpos), jnp.asarray(kpos), causal, 0.125,
            block_q=64, block_k=64)
    bq, bk, bv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out, lse = att.flash_chunk_fwd_plain(bq, bk, bv, torch.from_numpy(qpos),
                                         torch.from_numpy(kpos), causal,
                                         0.125)
    assert out.dtype == lse.dtype == torch.float32
    assert np.isfinite(out.numpy()).all() and np.isfinite(lse.numpy()).all()
    assert _bf16_ulp_err(out, want_o) <= 1.0
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0,
                               atol=2e-4)
    if where == "future":  # wholly masked: the mean of v, lse ~ -6.9e29
        assert (lse.numpy() < -1e29).all()


@pytest.mark.parametrize("rep,causal,where", CHUNK_CASES)
def test_chunk_grads_match_pallas_interpret(rep, causal, where,
                                            monkeypatch):
    """K7's twin against _flash_chunk_bwd_pallas on the same bf16 inputs and
    residuals with a nonzero lse cotangent, then flash_attention_chunk's
    gradients end to end against JAX's flash_attention_chunk (loss on both
    out and lse), both in interpret mode with 64-wide kv blocks."""
    import jax
    import jax.numpy as jnp

    monkeypatch.setenv("RTPU_FLASH_BLOCK_K", "64")
    monkeypatch.setenv("RTPU_FLASH_BLOCK_Q", "64")
    q, k, v, g, gl, qpos, kpos = _chunk_inputs(rep, where, seed=10)
    bq, bk, bv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tqp, tkp = torch.from_numpy(qpos), torch.from_numpy(kpos)
    out, lse = att.flash_chunk_fwd_plain(bq, bk, bv, tqp, tkp, causal, 0.125)
    got = att.flash_chunk_bwd_plain(bq, bk, bv, tqp, tkp, out, lse,
                                    torch.from_numpy(g), torch.from_numpy(gl),
                                    causal, 0.125)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    with _interpret() as attn_mod:
        dq, dk, dv = attn_mod._flash_chunk_bwd_pallas(
            jq, jk, jv, jnp.asarray(qpos), jnp.asarray(kpos),
            jnp.asarray(out.numpy()), jnp.asarray(lse.numpy()),
            jnp.asarray(g), jnp.asarray(gl), causal, 0.125)
        want_e2e = jax.grad(
            lambda q, k, v: sum(
                (a.astype(jnp.float32) * w).sum() for a, w in zip(
                    attn_mod.flash_attention_chunk(
                        q, k, v, jnp.asarray(qpos), jnp.asarray(kpos),
                        causal, 0.125), (g, gl))),
            argnums=(0, 1, 2))(jq, jk, jv)
    fold = np.asarray(dk, np.float32).reshape(1, 4 // rep, rep, S_CHUNK, 64)
    want = (dq, fold.sum(2), np.asarray(dv, np.float32).reshape(
        1, 4 // rep, rep, S_CHUNK, 64).sum(2))
    tq, tk, tv = (t.clone().requires_grad_() for t in (bq, bk, bv))
    o, ls = att.flash_attention_chunk(tq, tk, tv, tqp, tkp, causal, 0.125)
    ((o * torch.from_numpy(g)).sum() + (ls * torch.from_numpy(gl)).sum()) \
        .backward()
    for name, a, w, e, we in zip(("dq", "dk", "dv"), got, want,
                                 (tq.grad, tk.grad, tv.grad), want_e2e):
        assert a.dtype == e.dtype == torch.bfloat16, name
        assert np.isfinite(a.float().numpy()).all(), name
        w = np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
        assert _bf16_ulp_err(a.float(), w) <= 1.0, (name, "residuals")
        assert _bf16_ulp_err(e.float(), we) <= 1.0, (name, "end to end")


def test_flash_attention_chunk_checks_positions_and_counts_no_cpu_launch():
    q, k, v = (torch.zeros((1, 2, 8, 16)) for _ in range(3))
    pos = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="qpos"):
        att.flash_attention_chunk(q, k, v, pos[:4], pos)
    before = (att.flash_chunk_fwd_cuda.launches,
              att.flash_chunk_bwd_cuda.launches)
    q.requires_grad_()
    out, lse = att.flash_attention_chunk(q, k, v, pos, pos)
    (out.sum() + lse.sum()).backward()
    assert (att.flash_chunk_fwd_cuda.launches,
            att.flash_chunk_bwd_cuda.launches) == before


def test_flash_attention_chunk_never_falls_back_off_the_cpu():
    q = torch.empty((1, 4, 64, 64), device="meta", dtype=torch.bfloat16)
    pos = torch.arange(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        att.flash_attention_chunk(q, q[:, :2], q[:, :2], pos, pos)


# --------------------------------------------------------------------------
# Tile classes: position cases where K6/K7 skip, mask or take whole tiles
# --------------------------------------------------------------------------

# (S, positions): "mixed" has rows that see no key (qpos 0.., kpos 30..)
# in the same 64-row tiles as rows that do; "shuffled" permutes the
# diagonal case's positions (seeded), so a tile's min and max are not its
# first and last; "long causal" is S 1024, 16 tiles a side, with masked,
# visible and partial pairs.
TILE_CASES = ("mixed", "shuffled", "long causal")
TILE_PARAMS = [(where, d, rep, causal) for where in TILE_CASES
               for d in (64, 128) for rep in (1, 4)
               for causal in (True, False)]


def tile_case_positions(where):
    """(qpos, kpos) int32 numpy vectors of a tile-class case."""
    if where == "mixed":
        return (np.arange(256, dtype=np.int32),
                np.arange(256, dtype=np.int32) + 30)
    if where == "shuffled":
        rng = np.random.default_rng(11)
        base = np.arange(256, dtype=np.int32) + 256
        return rng.permutation(base), rng.permutation(base)
    return np.arange(1024, dtype=np.int32), np.arange(1024, dtype=np.int32)


def _tile_inputs(where, d, rep, seed):
    h = 4
    qpos, kpos = tile_case_positions(where)
    sq, skv = qpos.size, kpos.size
    q, k, v, g, gl = _arrays([(1, h, sq, d), (1, h // rep, skv, d),
                              (1, h // rep, skv, d), (1, h, sq, d),
                              (1, h, sq)], seed)
    return q, k, v, g, gl, qpos, kpos


def _no_key_rows(qpos, kpos, causal):
    return qpos < kpos.min() if causal else np.zeros(qpos.size, bool)


@pytest.mark.parametrize("where,d,rep,causal", TILE_PARAMS)
def test_chunk_fwd_twin_matches_pallas_on_tile_classes(where, d, rep,
                                                       causal):
    """K6's twin against _flash_chunk_fwd_pallas (interpret mode, 64-wide
    tiles) where the kernel skips, masks or takes whole tiles: out within
    one bf16 ulp of its largest value, lse within 2e-4; rows that see no
    key finite with lse < -1e29."""
    import jax.numpy as jnp

    q, k, v, _, _, qpos, kpos = _tile_inputs(where, d, rep, seed=d + rep)
    scale = d ** -0.5
    with _interpret() as attn_mod:
        want_o, want_lse = attn_mod._flash_chunk_fwd_pallas(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
            jnp.asarray(qpos), jnp.asarray(kpos), causal, scale,
            block_q=64, block_k=64)
    bq, bk, bv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out, lse = att.flash_chunk_fwd_plain(bq, bk, bv, torch.from_numpy(qpos),
                                         torch.from_numpy(kpos), causal,
                                         scale)
    assert np.isfinite(out.numpy()).all() and np.isfinite(lse.numpy()).all()
    assert _bf16_ulp_err(out, want_o) <= 1.0
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0,
                               atol=2e-4)
    nokey = _no_key_rows(qpos, kpos, causal)
    assert nokey.any() == (causal and where == "mixed")
    assert (lse.numpy()[..., nokey] < -1e29).all()


@pytest.mark.parametrize("where,d,rep,causal", TILE_PARAMS)
def test_chunk_bwd_twin_matches_pallas_on_tile_classes(where, d, rep, causal,
                                                       monkeypatch):
    """K7's twin against _flash_chunk_bwd_pallas on the same residuals with
    a nonzero lse cotangent, 64-wide tiles, where the kernel skips, masks
    or takes whole tiles: dq, dk and dv within one bf16 ulp of each one's
    largest value (the TPU kernel rounds each q head's dk/dv to bf16
    before the f32 fold over the rep heads, the twin folds in f32 and
    rounds once)."""
    import jax.numpy as jnp

    monkeypatch.setenv("RTPU_FLASH_BLOCK_K", "64")
    monkeypatch.setenv("RTPU_FLASH_BLOCK_Q", "64")
    q, k, v, g, gl, qpos, kpos = _tile_inputs(where, d, rep, seed=20 + d)
    scale = d ** -0.5
    bq, bk, bv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tqp, tkp = torch.from_numpy(qpos), torch.from_numpy(kpos)
    out, lse = att.flash_chunk_fwd_plain(bq, bk, bv, tqp, tkp, causal, scale)
    got = att.flash_chunk_bwd_plain(bq, bk, bv, tqp, tkp, out, lse,
                                    torch.from_numpy(g), torch.from_numpy(gl),
                                    causal, scale)
    with _interpret() as attn_mod:
        dq, dk, dv = attn_mod._flash_chunk_bwd_pallas(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
            jnp.asarray(qpos), jnp.asarray(kpos), jnp.asarray(out.numpy()),
            jnp.asarray(lse.numpy()), jnp.asarray(g), jnp.asarray(gl),
            causal, scale)
    hkv, skv = 4 // rep, kpos.size
    want = [np.asarray(dq, np.float32)] + [
        np.asarray(t, np.float32).reshape(1, hkv, rep, skv, d).sum(2)
        for t in (dk, dv)]
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and np.isfinite(
            a.float().numpy()).all(), name
        w = np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
        assert _bf16_ulp_err(a.float(), w) <= 1.0, name


def _skipping_fwd(q, k, v, qpos, kpos, causal, scale):
    """K6's tile schedule in plain PyTorch: per 64-row q block, the online
    softmax of ``fwd_tile_step`` over the kv tiles that the classes of
    ``chunk_tile_bounds_plain`` keep (a masked tile is skipped unless the
    block holds a row that sees no key)."""
    n = att.BLOCK_N
    bounds = att.chunk_tile_bounds_plain(qpos, kpos)
    nq, nk = -(-qpos.numel() // n), -(-kpos.numel() // n)
    qb, kb = bounds[:2 * nq].view(nq, 2), bounds[2 * nq:-1].view(nk, 2)
    cmin = int(bounds[-1])
    qs, kr, vr, (o, m, l) = att.fwd_twin_begin(q, k, v, scale)
    outs, lses = [], []
    for i in range(nq):
        rows = slice(n * i, n * (i + 1))
        state = (o[:, :, rows], m[:, :, rows], l[:, :, rows])
        for j in range(nk):
            if causal and kb[j, 0] > qb[i, 1] and qb[i, 0] >= cmin:
                continue  # masked for every row of the block
            cols = slice(n * j, n * (j + 1))
            state = att.fwd_tile_step(state, qs[:, :, rows], kr[:, :, cols],
                                      vr[:, :, cols],
                                      qpos[rows] if causal else None,
                                      kpos[cols])
        out, lse = att.fwd_twin_end(state)
        outs.append(out)
        lses.append(lse)
    return torch.cat(outs, 2), torch.cat(lses, 2)


@pytest.mark.parametrize("where", TILE_CASES + ("ragged",))
@pytest.mark.parametrize("causal", [True, False])
def test_tile_skip_is_exact_on_the_twin(where, causal):
    """Skipping the tiles the positions mask wholly gives the full pass's
    out and lse bit for bit (a masked tile adds exp2(-1e30 - m) = 0, or is
    wiped by alpha = 0), rows that see no key included."""
    if where == "ragged":
        qpos = np.arange(200, dtype=np.int32) + 60
        kpos = np.arange(136, dtype=np.int32)
    else:
        qpos, kpos = tile_case_positions(where)
    q, k, v = _arrays([(1, 4, qpos.size, 64), (1, 2, kpos.size, 64),
                       (1, 2, kpos.size, 64)], 5)
    bq, bk, bv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tqp, tkp = torch.from_numpy(qpos), torch.from_numpy(kpos)
    want = att.flash_chunk_fwd_plain(bq, bk, bv, tqp, tkp, causal, 0.125)
    got = _skipping_fwd(bq, bk, bv, tqp, tkp, causal, 0.125)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_chunk_tile_bounds_plain_reads_any_order():
    """The pre-pass's twin: (min, max) of every 64-block of qpos then kpos,
    then min(kpos), on unsorted and ragged positions."""
    rng = np.random.default_rng(2)
    qpos = rng.permutation(200).astype(np.int32) - 50
    kpos = rng.permutation(70).astype(np.int32) + 7
    got = att.chunk_tile_bounds_plain(torch.from_numpy(qpos),
                                      torch.from_numpy(kpos)).numpy()
    want = []
    for pos in (qpos, kpos):
        for i in range(0, pos.size, 64):
            want += [pos[i:i + 64].min(), pos[i:i + 64].max()]
    want.append(kpos.min())
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want, np.int32))


# --------------------------------------------------------------------------
# The ring's schedule in one process against JAX's ring over 4 devices
# --------------------------------------------------------------------------

def _ring_inputs(h=4, hkv=2, s=256, d=32, seed=3):
    q, k, v = _arrays([(1, h, s, d), (1, hkv, s, d), (1, hkv, s, d)], seed)
    w = np.linspace(0.5, 1.5, q.size).reshape(q.shape).astype(np.float32)
    return q, k, v, w


def _jax_ring(q, k, v, w, sp, impl, causal=True):
    """(out, (dq, dk, dv)) of JAX's ring_attention_sharded at sp devices,
    with the loss sum(out * w)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops.ring_attention import ring_attention_sharded
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(sp=sp), jax.devices("cpu")[:sp])

    def run(q, k, v):
        return ring_attention_sharded(q, k, v, mesh, axis="sp",
                                      causal=causal, impl=impl)

    args = [jnp.asarray(a) for a in (q, k, v)]
    with _interpret():
        out = run(*args)
        grads = jax.grad(lambda *a: (run(*a) * w).sum(),
                         argnums=(0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [True, False])
def test_simulated_ring_matches_jax_ring_flash(causal):
    """simulate_ring at n = 4 (ring_flash_step on every chunk pair at global
    positions, no transport) against JAX's ring_attention_sharded(impl=
    "flash") on a 4-device CPU mesh: forward and q/k/v gradients, f32."""
    q, k, v, w = _ring_inputs(seed=4 + causal)
    want, want_g = _jax_ring(q, k, v, w, 4, "flash", causal)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ra.simulate_ring(tq, tk, tv, 4, causal)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=2e-5,
                               atol=2e-5)
    for name, got, ref in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                              want_g):
        assert _rel(got.numpy(), ref) < 1e-4, name


def test_ring_einsum_step_combine_matches_jax():
    import jax.numpy as jnp

    from ray_tpu.ops.ring_attention import _ring_step_combine as jax_step

    q, k, v, _ = _ring_inputs(h=2, hkv=2, s=64, d=16, seed=6)
    m0 = np.full((1, 2, 64), -1e30, np.float32)
    for qo, ko in ((64, 0), (64, 64), (70, 37), (0, 64)):
        want = jax_step(*(jnp.asarray(a) for a in (q, k, v)),
                        jnp.zeros((1, 2, 64, 16)), jnp.asarray(m0),
                        jnp.zeros((1, 2, 64)), 0.25, True, qo, ko, 64)
        got = ra._ring_step_combine(
            *(torch.from_numpy(a) for a in (q, k, v)),
            torch.zeros((1, 2, 64, 16)), torch.from_numpy(m0),
            torch.zeros((1, 2, 64)), 0.25, True, qo, ko)
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5,
                                       atol=1e-5)


# --------------------------------------------------------------------------
# Rings over 2 gloo ranks
# --------------------------------------------------------------------------

LLAMA_B, LLAMA_S = 2, 32


def _llama_batch():
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, llama.LlamaConfig.tiny().vocab_size,
                          (LLAMA_B, LLAMA_S)).astype(np.int64)
    return tokens, np.roll(tokens, -1, axis=1)


def _rank_main(rank: int, world: int, store: str, tmp: str) -> None:
    """One rank: every computation the gloo tests read, saved to
    rank<r>.pt."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    res = {}
    q, k, v, w = _ring_inputs()
    for impl in ("einsum", "flash"):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        out = ra.ring_attention_sharded(tq, tk, tv, None, True, impl=impl)
        # Each rank takes 1/world of the one global loss; all_gather's
        # backward sums the ranks' cotangents.
        ((out * torch.from_numpy(w)).sum() / world).backward()
        grads = [t.grad for t in (tq, tk, tv)]
        for g in grads:  # each rank holds its own shard's rows
            dist.all_reduce(g)
        res[impl] = (out.detach(), grads)

    cfg = llama.LlamaConfig.tiny()
    params = torch.load(os.path.join(tmp, "params.pt"))
    tokens, targets = _llama_batch()
    rows = slice(rank * LLAMA_S // world, (rank + 1) * LLAMA_S // world)
    tok = torch.from_numpy(tokens[:, rows])
    tgt = torch.from_numpy(targets[:, rows])
    pos = torch.arange(LLAMA_S)[rows]
    group = dist.group.WORLD
    with torch.no_grad():
        res["hidden"] = llama.forward_hidden(
            cfg, params, tok, positions=pos, sp_axis=group, remat="attn")
    leaves = tree_map(lambda t: t.clone().requires_grad_(), params)
    loss = llama.loss_fn(cfg, leaves, tok, tgt, positions=pos,
                         sp_axis=group, remat="attn+")
    loss.backward()
    grads = tree_map(lambda t: t.grad, leaves)
    for g in tree_leaves(grads):
        dist.all_reduce(g)
        g /= world  # the mean over the shards' equal token counts
    res["loss"] = loss.detach()
    res["grads"] = grads
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("gloo_ring"))
    params = llama.init_params(llama.LlamaConfig.tiny(), generator=5,
                               device="cpu")
    torch.save(params, os.path.join(tmp, "params.pt"))
    run_ranks(_rank_main, SP, tmp, (tmp,), RANK_TIMEOUT_S)
    return params, [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                    for r in range(SP)]


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_gloo_ring_matches_jax_ring(gloo_ranks, impl):
    """ring_attention_sharded (ring_attention_local per rank, _RingShift
    over gloo) on 2 ranks against JAX's ring at sp = 2, forward and q/k/v
    gradients, in both impls."""
    _, ranks = gloo_ranks
    q, k, v, w = _ring_inputs()
    want, want_g = _jax_ring(q, k, v, w, SP, impl)
    for res in ranks:  # every rank holds the gathered output
        out, grads = res[impl]
        np.testing.assert_allclose(out.numpy(), want, rtol=2e-5, atol=2e-5)
        for name, got, ref in zip(("dq", "dk", "dv"), grads, want_g):
            assert _rel(got.numpy(), ref) < 1e-4, (impl, name)


def test_gloo_llama_forward_matches_jax_shard_map(gloo_ranks):
    """forward_hidden with sp_axis = the 2-rank group and global positions
    against JAX's forward_hidden(..., sp_axis="sp") under shard_map on the
    tiny f32 config, from the same params."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ray_tpu.collective.xla_backend import shard_map
    from ray_tpu.models import llama as jax_llama
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh

    params, ranks = gloo_ranks
    tokens, _ = _llama_batch()
    mesh = build_mesh(MeshSpec(sp=SP), jax.devices("cpu")[:SP])
    jparams = tree_map(lambda t: jnp.asarray(t.numpy()), params)
    jcfg = jax_llama.LlamaConfig.tiny()

    def body(p, tok, pos):
        return jax_llama.forward_hidden(jcfg, p, tok, positions=pos,
                                        sp_axis="sp", remat="attn")

    want = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(P(), P(None, "sp"), P("sp")),
        out_specs=P(None, "sp", None), check_vma=False))(
            jparams, jnp.asarray(tokens.astype(np.int32)),
            jnp.arange(LLAMA_S))
    got = torch.cat([r["hidden"] for r in ranks], dim=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_gloo_llama_cp_grads_match_single_rank(gloo_ranks):
    """The 2-rank context-parallel loss's param gradients, all-reduced,
    against the port's own sp_axis=None gradients on the whole sequence;
    the mean of the shard losses against the whole-sequence loss."""
    params, ranks = gloo_ranks
    tokens, targets = _llama_batch()
    cfg = llama.LlamaConfig.tiny()
    leaves = tree_map(lambda t: t.clone().requires_grad_(), params)
    loss = llama.loss_fn(cfg, leaves, torch.from_numpy(tokens),
                         torch.from_numpy(targets), remat="attn+")
    loss.backward()
    np.testing.assert_allclose(
        np.mean([r["loss"].item() for r in ranks]), loss.item(), rtol=1e-5)
    want = tree_leaves(tree_map(lambda t: t.grad, leaves))
    for res in ranks:
        for i, (got, ref) in enumerate(zip(tree_leaves(res["grads"]),
                                           want)):
            assert _rel(got.numpy(), ref.numpy()) < 1e-4, i


def _failing_rank(rank: int, world: int, store: str, how: str) -> None:
    if rank == 1:
        if how == "raises":
            raise ValueError("rank 1 fails on purpose")
        time.sleep(60)


@pytest.mark.parametrize("how", ["raises", "hangs"])
def test_run_ranks_reports_failed_and_hung_ranks(tmp_path, how):
    """run_ranks names a rank that raised (with its traceback) or did not
    end in time (killed, not waited on), and lets the others end."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        run_ranks(_failing_rank, 2, str(tmp_path), (how,), timeout_s=20)
    if how == "raises":
        assert "rank 1 exited" in str(err.value)
        assert "rank 1 fails on purpose" in str(err.value)
    else:
        assert "1] did not end within 20" in str(err.value)
    assert time.monotonic() - t0 < 50
