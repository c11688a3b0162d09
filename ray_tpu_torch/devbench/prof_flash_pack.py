"""Head-packed flash-attention forward on the card: K8, K9 and K10, their
plain twins, and the profiling sweep that drives them.

Port of devbench/prof_flash_pack.py. On the TPU, packing put the q heads
that share a GQA kv head into one kernel invocation (a [pack*block_q, D]
tile), and three mask schedules tested how much of the causal mask's cost
the fully visible kv blocks could shed; the winner became K2. Here
(csrc/flash_packed_fwd.cu, K2's Hopper machinery: a TMA ring of K/V tiles
and ``wgmma`` for both products) one CTA owns one q tile of ``pack`` q
heads of one kv head, one warpgroup per 64 rows of one head, and stages
each K/V tile once for all of them, where K2 stages it once per q head.

- ``packed_fwd`` (K10): every kv tile up to the causal bound masked by
  global positions;
- ``packed_fwd_epi`` (K8): a mask-free loop over the fully visible tiles,
  then a masked loop over the partial-diagonal ones;
- ``packed_fwd_inl`` (K9): block_q == block_k; a mask-free loop over the
  tiles left of the diagonal, then the diagonal tile under one local
  triangular mask.

Each takes (q, k, v, causal, sm_scale, pack, block_q, block_k), q [B,H,S,D]
and k/v [B,Hkv,S,D], and returns (out in q's dtype, lse f32 natural-log).
On CUDA tensors it launches its kernel (bf16, D 64 or 128) and counts the
launch; on CPU tensors it runs its plain twin (``*_plain``), which walks
the kernel's schedule over the same block_k tiles with the arithmetic of
``ops.attention.fwd_tile_step`` (rows are independent, so ``pack`` only
groups them). Tiles: block_q and block_k in {64, 128}; pack in {1, 2, 4},
dividing H / Hkv, with pack * block_q <= 256 rows a CTA at D 64 and <= 128
at D 128 (the register file: see the kernel's notes); S a multiple of both
blocks; q and k/v of one length. Anything else raises, on either device.
For one block_k the three give the same bits, and at block_k 64 K2's: a
fully visible tile has nothing to mask, and a tile wholly past a row's
diagonal adds nothing.

Run:  python -m ray_tpu_torch.devbench.prof_flash_pack [--check]
      [--only SUBSTRING] [--device {cuda,cpu}]
``--check`` holds every variant against ``attention_reference`` at B1 H8
Hkv2 S1024 D64 causal (on the CPU through the twins); without it every
variant is timed on the card at B4 H32 Hkv8 S2048 D64 causal bf16
(``timed_slope_chain``) and printed with its TFLOP/s. A variant that fails
raises.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import statistics
import sys
import time

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.accelerators.flops import attention_flops
from ray_tpu_torch.ops import attention as att

B, S, H, KV, HD = 4, 2048, 32, 8, 64  # the profiling shape
CHECK_SHAPE = dict(b=1, h=8, hkv=2, s=1024, d=64)
L1, L2 = 8, 56  # calls in the short and the long chain
BLOCKS = (64, 128)
PACKS = (1, 2, 4)
# head_dim -> the most rows (pack * block_q) a CTA takes: four warpgroups
# of 64 rows at D 64, two at D 128 (the register file;
# csrc/flash_packed_fwd.cu).
MAX_ROWS = {64: 256, 128: 128}
# --check: out within this share of the reference's largest value. The
# reference runs in f32 on the bf16 inputs; the kernels round p and out to
# bf16 (tests/test_torch_attention.py's bf16-against-f32 tolerance).
CHECK_TOL = 2e-2

# kernel -> its C entry in csrc/flash_packed_fwd.cu
_ENTRY = {"masked": "rtt_packed_fwd", "epi": "rtt_packed_fwd_epi",
          "inl": "rtt_packed_fwd_inl"}
_LIBS: dict[str, ctypes.CDLL] = {}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def schedule(kind: str, qi: int, block_q: int, block_k: int, nkv: int,
             causal: bool) -> list[tuple[int, str | None]]:
    """The kv tiles that q tile ``qi`` visits, in order, each with its mask:
    None (mask-free), "global" (positions) or "local" (K9's diagonal tile,
    local row against local column). ``kind`` is "masked" (K10), "epi" (K8)
    or "inl" (K9); the kernels' loops, csrc/flash_packed_fwd.cu."""
    if not causal:
        return [(j, None) for j in range(nkv)]
    m0 = qi * block_q
    upper = min(-(-(m0 + block_q) // block_k), nkv)
    # K8: tile j is fully visible iff (j+1)*block_k - 1 <= m0.
    free = {"masked": 0, "epi": m0 // block_k, "inl": qi}[kind]
    mask = "local" if kind == "inl" else "global"
    return [(j, None if j < free else mask) for j in range(upper)]


def _check_args(kind, q, k, v, pack, block_q, block_k) -> None:
    """Raises ValueError on what the kernels do not take."""
    att._check_shapes(q, k, v)
    h, s = q.shape[1], q.shape[2]
    rep = h // k.shape[1]
    if k.shape[2] != s:
        raise ValueError(f"packed kernels take q and k/v of one length, got "
                         f"S {s} and {k.shape[2]}")
    if block_q not in BLOCKS or block_k not in BLOCKS:
        raise ValueError(f"block_q and block_k must be 64 or 128, got "
                         f"{block_q}, {block_k}")
    if pack not in PACKS or rep % pack:
        raise ValueError(f"pack must be 1, 2 or 4 and divide H / Hkv = {rep},"
                         f" got {pack}")
    most = MAX_ROWS.get(q.shape[-1], MAX_ROWS[64])
    if pack * block_q > most:
        raise ValueError(f"pack * block_q = {pack * block_q} rows a CTA, "
                         f"more than {most} at head_dim {q.shape[-1]}")
    if s % block_q or s % block_k:
        raise ValueError(f"S = {s} is ragged: not a multiple of block_q "
                         f"{block_q} and block_k {block_k}")
    if kind == "inl" and block_q != block_k:
        raise ValueError(f"packed_fwd_inl needs block_q == block_k, got "
                         f"{block_q} and {block_k}")


def _plain(kind, q, k, v, causal, sm_scale, pack, block_q, block_k):
    _check_args(kind, q, k, v, pack, block_q, block_k)
    b, h, s, _ = q.shape
    qs, kr, vr, state = att.fwd_twin_begin(q, k, v, sm_scale)
    pos = torch.arange(s, dtype=torch.int32, device=q.device)
    local = pos[:block_q]  # K9: block_q == block_k
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    for qi in range(s // block_q):
        rows = slice(qi * block_q, (qi + 1) * block_q)
        st = tuple(t[:, :, rows] for t in state)
        for j, mask in schedule(kind, qi, block_q, block_k, s // block_k,
                                causal):
            cols = slice(j * block_k, (j + 1) * block_k)
            qpos, kpos = {None: (None, None), "local": (local, local),
                          "global": (pos[rows], pos[cols])}[mask]
            st = att.fwd_tile_step(st, qs[:, :, rows], kr[:, :, cols],
                                   vr[:, :, cols], qpos, kpos)
        o, tile_lse = att.fwd_twin_end(st)
        out[:, :, rows] = o.to(q.dtype)
        lse[:, :, rows] = tile_lse
    return out, lse


def packed_fwd_plain(q, k, v, causal: bool, sm_scale: float, pack: int = 2,
                     block_q: int = 64, block_k: int = 64):
    """K10's arithmetic in plain PyTorch: (out, lse); see the module."""
    return _plain("masked", q, k, v, causal, sm_scale, pack, block_q,
                  block_k)


def packed_fwd_epi_plain(q, k, v, causal: bool, sm_scale: float,
                         pack: int = 2, block_q: int = 64, block_k: int = 64):
    """K8's arithmetic in plain PyTorch: (out, lse); see the module."""
    return _plain("epi", q, k, v, causal, sm_scale, pack, block_q, block_k)


def packed_fwd_inl_plain(q, k, v, causal: bool, sm_scale: float,
                         pack: int = 2, block_q: int = 64,
                         block_k: int | None = None):
    """K9's arithmetic in plain PyTorch: (out, lse); block_k defaults to
    block_q and must equal it."""
    return _plain("inl", q, k, v, causal, sm_scale, pack, block_q,
                  block_q if block_k is None else block_k)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the C signatures of a build of csrc/flash_packed_fwd.cu (this
    tree's, or an earlier one with the same interface) and returns it."""
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = [_P] * 5 + [_I] * 8 + [_F, _I, _P]
        fn.restype = _I
    lib.rtt_flash_packed_fwd_error_string.argtypes = [_I]
    lib.rtt_flash_packed_fwd_error_string.restype = ctypes.c_char_p
    lib.rtt_flash_packed_fwd_smem_bytes.argtypes = [_I] * 3
    lib.rtt_flash_packed_fwd_smem_bytes.restype = _I
    return lib


def _library() -> ctypes.CDLL:
    lib = _LIBS.get("lib")
    if lib is None:
        from ray_tpu_torch._native.build import load_library

        lib = _LIBS["lib"] = bind(load_library("flash_packed_fwd"))
    return lib


def smem_bytes(head_dim: int, block_k: int, rows: int) -> int:
    """Dynamic shared memory of a CTA of ``rows`` = pack * block_q q rows
    (the build's own formula; loads the library)."""
    return _library().rtt_flash_packed_fwd_smem_bytes(head_dim, block_k, rows)


def _launch(kind, q, k, v, causal, sm_scale, pack, block_q, block_k,
            lib=None):
    """One launch of ``lib`` (default: this tree's build) on CUDA tensors:
    (out, lse). Raises with the kernel's message if it refuses."""
    att._check_cuda(q, k, v)
    q, k, v = att._dense(q), att._dense(k), att._dense(v)
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _library() if lib is None else lib
    with torch.cuda.device(q.device):
        err = getattr(lib, _ENTRY[kind])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, k.shape[1], s, d, pack, block_q, block_k,
            sm_scale * att.LOG2E, int(causal),
            torch.cuda.current_stream().cuda_stream)
    if err:
        msg = lib.rtt_flash_packed_fwd_error_string(err).decode()
        raise RuntimeError(f"{_ENTRY[kind]} launch failed (q {tuple(q.shape)}"
                           f", pack {pack}, block_q {block_q}, block_k "
                           f"{block_k}): {msg}")
    return out, lse


def _run(wrapper, kind, q, k, v, causal, sm_scale, pack, block_q, block_k):
    if q.device.type == "cpu":
        return _plain(kind, q, k, v, causal, sm_scale, pack, block_q,
                      block_k)
    _check_args(kind, q, k, v, pack, block_q, block_k)
    res = _launch(kind, q, k, v, causal, sm_scale, pack, block_q, block_k)
    wrapper.launches += 1
    return res


def packed_fwd(q, k, v, causal: bool, sm_scale: float, pack: int = 2,
               block_q: int = 64, block_k: int = 64):
    """K10, every kv tile up to the causal bound masked: (out, lse)."""
    return _run(packed_fwd, "masked", q, k, v, causal, sm_scale, pack,
                block_q, block_k)


def packed_fwd_epi(q, k, v, causal: bool, sm_scale: float, pack: int = 2,
                   block_q: int = 64, block_k: int = 64):
    """K8, mask-free over the fully visible tiles, masked over the partial
    diagonal ones: (out, lse)."""
    return _run(packed_fwd_epi, "epi", q, k, v, causal, sm_scale, pack,
                block_q, block_k)


def packed_fwd_inl(q, k, v, causal: bool, sm_scale: float, pack: int = 2,
                   block_q: int = 64, block_k: int | None = None):
    """K9, mask-free left of the diagonal, the diagonal tile under a local
    triangular mask: (out, lse); block_k defaults to block_q and must
    equal it."""
    return _run(packed_fwd_inl, "inl", q, k, v, causal, sm_scale, pack,
                block_q, block_q if block_k is None else block_k)


packed_fwd.launches = 0      # K10 launches since the last reset
packed_fwd_epi.launches = 0  # K8
packed_fwd_inl.launches = 0  # K9

# schedule -> (wrapper, plain twin)
KERNELS = {"masked": (packed_fwd, packed_fwd_plain),
           "epi": (packed_fwd_epi, packed_fwd_epi_plain),
           "inl": (packed_fwd_inl, packed_fwd_inl_plain)}


def make_inputs(b, h, hkv, s, d, device, seed: int = 0):
    """Seeded bf16 q [b,h,s,d] and k, v [b,hkv,s,d] on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16)

    return rnd(b, h, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d)


def _prod(q, k, v, causal, sm_scale):
    fwd = att.flash_fwd_plain if q.device.type == "cpu" else att.flash_fwd_cuda
    return fwd(q, k, v, causal, sm_scale)


def variants(sm_scale: float = HD ** -0.5) -> dict:
    """name -> fn(q, k, v) -> (out, lse), causal: "prod" (K2, the shipped
    forward; its twin on the CPU), then every schedule x pack x tiles its
    kernel takes, named as the JAX script names them
    (``pack4_bq64_bk128``, ``epi_...``, ``inl_pack4_bq64``)."""
    causal = True
    out = {"prod": functools.partial(_prod, causal=causal, sm_scale=sm_scale)}
    for kind, prefix in (("masked", ""), ("epi", "epi_"), ("inl", "inl_")):
        for pack in PACKS:
            for bq in BLOCKS:
                for bk in BLOCKS:
                    if pack * bq > MAX_ROWS[HD] or (kind == "inl"
                                                    and bk != bq):
                        continue
                    name = f"{prefix}pack{pack}_bq{bq}" + (
                        "" if kind == "inl" else f"_bk{bk}")
                    out[name] = functools.partial(
                        KERNELS[kind][0], causal=causal, sm_scale=sm_scale,
                        pack=pack, block_q=bq, block_k=bk)
    return out


def timed_slope_chain(step, carry0: torch.Tensor, reps: int = 5) -> float:
    """Seconds one call of ``step`` adds to a chain. Chains of L1 and L2
    calls, each call's output fed in as the next call's input and the
    chain ended by reading one value (which waits for the device), are
    timed on the host clock; the result is the median over ``reps`` of
    (t(L2) - t(L1)) / (L2 - L1), so what a chain pays once (its first
    launch, the final read) cancels. The JAX script's timer
    (devbench/prof_flash_pack.py:33-52), with a device synchronisation in
    place of jit and scan."""
    def run(length):
        c = carry0
        for _ in range(length):
            c = step(c)
        return float(c.reshape(-1)[0])

    if carry0.is_cuda:
        torch.cuda.synchronize(carry0.device)
    run(L1)
    run(L2)
    slopes = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run(L1)
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        run(L2)
        t2 = time.perf_counter() - t0
        slopes.append((t2 - t1) / (L2 - L1))
    return statistics.median(slopes)


def check(device="cuda", only: str = "", print_fn=print) -> dict:
    """Every variant (whose name contains ``only``) against
    ``attention_reference`` in f32 at CHECK_SHAPE, causal; raises past
    CHECK_TOL of the reference's largest value or on a non-finite lse.
    Returns name -> max abs error of out."""
    dev = resolve_device(device)
    c = CHECK_SHAPE
    q, k, v = make_inputs(c["b"], c["h"], c["hkv"], c["s"], c["d"], dev)
    scale = c["d"] ** -0.5
    ref = att.attention_reference(q.float(), k.float(), v.float(),
                                  causal=True, sm_scale=scale)
    limit = CHECK_TOL * ref.abs().max().item()
    errs = {}
    for name, fn in variants(sm_scale=scale).items():
        if only not in name:
            continue
        out, lse = fn(q, k, v)
        err = (out.float() - ref).abs().max().item()
        print_fn(f"{name:22s} max|err| = {err:.5f}")
        if not (err <= limit and torch.isfinite(lse).all()):
            raise AssertionError(f"{name}: max abs err {err:.3e} against "
                                 f"attention_reference (limit {limit:.3e})"
                                 f" or a non-finite lse")
        errs[name] = err
    return errs


def sweep(only: str = "") -> list[dict]:
    """Times every variant (whose name contains ``only``) on the card at
    B4 H32 Hkv8 S2048 D64 causal bf16 with ``timed_slope_chain``: rows
    {name, ms, tflops}, TFLOP/s over the causal forward's FLOPs."""
    q, k, v = make_inputs(B, H, KV, S, HD, resolve_device("cuda"))
    flops = attention_flops(B, H, S, HD, causal=True)
    rows = []
    for name, fn in variants().items():
        if only not in name:
            continue
        ms = timed_slope_chain(lambda c: fn(c, k, v)[0], q) * 1e3
        tflops = flops / (ms * 1e-3) / 1e12
        print(f"{name:22s} {ms:8.4f} ms  {tflops:6.1f} TF/s")
        rows.append({"name": name, "ms": ms, "tflops": tflops})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devbench.prof_flash_pack",
        description="Head-packed flash forward kernels (K8-K10) against K2")
    ap.add_argument("--check", action="store_true",
                    help="hold every variant against attention_reference")
    ap.add_argument("--only", default="",
                    help="run only the variants whose name contains this")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.check:
        check(args.device, args.only)
        return 0
    if args.device != "cuda":
        print("the sweep times the card; on the CPU only --check runs",
              file=sys.stderr)
        return 2
    sweep(args.only)
    return 0


if __name__ == "__main__":
    sys.exit(main())
