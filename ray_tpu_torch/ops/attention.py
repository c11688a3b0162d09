"""Attention: plain references, and flash attention with hand-written CUDA
forward (csrc/flash_fwd.cu), fused backward (csrc/flash_bwd.cu) and split
backward (csrc/flash_bwd_dq.cu, csrc/flash_bwd_dkv.cu) kernels, and their
chunk variants for ring attention (csrc/flash_chunk_fwd.cu,
csrc/flash_chunk_bwd.cu, with their pre-pass csrc/chunk_tile_bounds.cu).

Port of ray_tpu/ops/attention.py, single device:

- ``attention_reference``: O(S^2) softmax attention, ground truth in tests;
- ``blockwise_attention``: online softmax over kv blocks, differentiable by
  autograd, O(S) activations;
- ``flash_attention(q, k, v, causal, sm_scale)``: a
  ``torch.autograd.Function``. On CUDA tensors its forward launches the K2
  kernel (out + natural-log lse) and its backward the K3 kernel (dq, dk,
  dv in one pass from the saved lse, dk/dv folded to the kv heads). On CPU
  tensors it runs the kernels' plain twins, ``flash_fwd_plain`` and
  ``flash_bwd_plain``, which repeat the kernels' arithmetic, roundings
  included. There is no fallback: on a CUDA tensor the kernels launch or
  the call raises;
- the backward's switch ``FUSED_BWD``, read once at import from
  ``RTPU_FLASH_FUSED_BWD`` (default "1"; "0" turns it off) and at call
  time by the backward, as the JAX package's is. True: K3, one kernel of
  five products per tile pair, whose dq is summed across its CTAs into an
  f32 buffer by reductions in no fixed order, so two runs on the same
  inputs differ in dq's last bits (dk/dv repeat bit for bit). False: the
  split backward, K4 (dq, each q tile's rows written once from registers)
  then K5 (dk/dv, each kv tile's rows written once), which folds the GQA
  heads inside the kernel: each q head's dk/dv
  rounded to bf16, the rep q heads of a kv head summed in f32 and rounded
  once more (the TPU contract, whose JAX wrapper folds after the per-head
  Pallas kernel). Seven products per tile pair, and the same bits on every
  run. Its twins are ``flash_bwd_dq_plain``, ``flash_bwd_dkv_plain`` (per
  q head, the TPU kernel's arithmetic) with ``fold_heads``, and
  ``flash_bwd_split_plain``; unlike K3 they apply the softmax scale to ds
  in f32 before its rounding instead of folding it into the operands;
- ``flash_attention_chunk(q, k, v, qpos, kpos, causal, sm_scale)``: local
  q against one visiting K/V chunk with global int32 positions, returning
  (out f32, lse f32), both differentiable. On CUDA tensors K6 (forward)
  and K7 (backward, with the lse cotangent); on CPU tensors their twins
  ``flash_chunk_fwd_plain`` and ``flash_chunk_bwd_plain``. Unlike the TPU
  kernels, K6/K7 skip the tiles that the positions mask wholly, by the
  tile bounds of a pre-pass (csrc/chunk_tile_bounds.cu, twin
  ``chunk_tile_bounds_plain``); the skip is exact, so the twins make the
  full pass and stay the arithmetic the kernels are held to.

Shapes: q [B, H, Sq, D], k/v [B, Hkv, Skv, D], GQA when Hkv < H; k/v are
never repeated on the kernel path. The kernels take bf16 and D in {64, 128},
any sequence length (the ragged tail is masked, where the Pallas wrapper
asserts ``S % block == 0``).
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

# The backward's switch: K3 (fused) when true, K4 + K5 (split) when
# false; see the module docstring. Tests flip it in a try/finally.
FUSED_BWD = os.environ.get("RTPU_FLASH_FUSED_BWD", "1") != "0"

NEG_INF = -1e30
LOG2E = 1.4426950408889634  # base-2 softmax, as the TPU kernels run it
LN2 = 0.6931471805599453
BLOCK_N = 64  # the kernels' kv tile; the forward twin walks the same tiles
_TWIN_Q_BLOCK = 256  # q rows per step of the backward twin (memory only)
HEAD_DIMS = (64, 128)


def _repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Expand kv heads to match query heads (GQA)."""
    hkv = k.shape[1]
    if hkv == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // hkv, dim=1)


def _scale(q: torch.Tensor, sm_scale: float | None) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])


def attention_reference(q, k, v, causal: bool = True,
                        sm_scale: float | None = None):
    """O(S^2) reference."""
    h, sq = q.shape[1], q.shape[2]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * _scale(q, sm_scale)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(k.shape[2], device=q.device)[None, :]
        logits = torch.where(kpos <= qpos, logits,
                             torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def blockwise_attention(q, k, v, causal: bool = True,
                        sm_scale: float | None = None, kv_block: int = 512):
    """Online-softmax attention over kv blocks (a Python loop in place of
    the JAX scan); differentiable by autograd."""
    b, h, sq, d = q.shape
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    skv = k.shape[2]
    kv_block = min(kv_block, skv)
    scale = _scale(q, sm_scale)
    qpos = torch.arange(sq, device=q.device)
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for start in range(0, skv, kv_block):
        kb = k[:, :, start:start + kv_block]
        vb = v[:, :, start:start + kv_block]
        kpos = torch.arange(start, start + kb.shape[2], device=q.device)
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kb.float()) * scale
        if causal:
            s = torch.where(kpos[None, :] <= qpos[:, None], s,
                            torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return (o / l[..., None]).to(q.dtype)


# --------------------------------------------------------------------------
# Plain twins of the kernels (CPU path; chip_smoke.py's comparisons)
# --------------------------------------------------------------------------

def _mask(s, qpos, kpos, causal):
    """-1e30 where kpos > qpos (causal); qpos/kpos are the rows' and the
    columns' positions. The twins slice only real rows and columns, so
    they need no mask past a sequence's end."""
    if not causal:
        return s
    ok = kpos[None, :] <= qpos[:, None]
    return torch.where(ok, s, torch.full_like(s, NEG_INF))


def fwd_twin_begin(q, k, v, sm_scale: float):
    """The forward kernels' operands and starting state, in plain PyTorch:
    (qs, k, v, state). qs = q*scale*log2e rounded to q's dtype once, held
    in f32; k repeated to the q heads in f32, v repeated in its dtype;
    state = (o, m, l) = (0, -1e30, 0) for every q row."""
    b, h, sq, d = q.shape
    qs = (q.float() * (sm_scale * LOG2E)).to(q.dtype).float()
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    return qs, _repeat_kv(k, h).float(), _repeat_kv(v, h), (o, m, l)


def fwd_tile_step(state, qs, k, v, qpos=None, kpos=None):
    """One kv tile of the forward kernels' base-2 online softmax, of any
    width (the kernel's block_k), for the rows of qs: s = qs.k^T in f32,
    -1e30 where kpos > qpos when positions are given; m' = max(m, rowmax
    s), p = exp2(s - m') rounded to v's dtype for both p.v and the row sum
    l, alpha = exp2(m - m'). A row that sees the whole tile, or (once m is
    finite) none of it, comes out the same masked or not."""
    o, m, l = state
    s = qs @ k.transpose(-1, -2)
    if qpos is not None:
        s = _mask(s, qpos, kpos, True)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp2(s - m_new[..., None]).to(v.dtype)
    alpha = torch.exp2(m - m_new)
    l = l * alpha + p.float().sum(dim=-1)
    o = o * alpha[..., None] + p.float() @ v.float()
    return o, m_new, l


def fwd_twin_end(state):
    """(out f32, lse f32 natural-log) from the online-softmax state."""
    o, m, l = state
    l = torch.clamp(l, min=1e-30)
    return o / l[..., None], (m + torch.log2(l)) * LN2


def flash_chunk_fwd_plain(q, k, v, qpos, kpos, causal: bool,
                          sm_scale: float):
    """The K6 kernel's arithmetic in plain PyTorch, which is K2's at given
    positions: (out f32, lse f32 natural-log) of q against one K/V chunk,
    masked by the global positions qpos [Sq] and kpos [Skv]; the online
    softmax of ``fwd_tile_step`` over the kernels' 64-wide kv tiles."""
    qs, k, v, state = fwd_twin_begin(q, k, v, sm_scale)
    for n0 in range(0, k.shape[2], BLOCK_N):
        cols = slice(n0, n0 + BLOCK_N)
        state = fwd_tile_step(state, qs, k[:, :, cols], v[:, :, cols],
                              qpos if causal else None, kpos[cols])
    return fwd_twin_end(state)


def _twin_bwd(q, k, v, qpos, kpos, do, lse, rowbias, causal: bool,
              sm_scale: float):
    """The backward kernels' arithmetic: (dq, dk, dv), dk/dv folded to the
    kv heads in f32. s is recomputed from the forward's rounded qs; p =
    exp2(s - lse*log2e); ds = p*(dp + rowbias), rowbias f32 per q row; p
    and ds rounded to the input dtype before their products; the scale
    rides q_sc = q*scale (dk) and k_sc = k*scale (dq), each rounded to the
    input dtype. ``do`` is dO in the input dtype."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dt = q.dtype
    kr = _repeat_kv(k, h).float()
    vr = _repeat_kv(v, h).float()
    k_sc = (kr * sm_scale).to(dt).float()
    lse2 = lse.float() * LOG2E
    dq = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, h, skv, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for m0 in range(0, sq, _TWIN_Q_BLOCK):
        rows = slice(m0, m0 + _TWIN_Q_BLOCK)
        qf = q[:, :, rows].float()
        qs = (qf * (sm_scale * LOG2E)).to(dt).float()
        q_sc = (qf * sm_scale).to(dt).float()
        dof = do[:, :, rows].float()
        s = _mask(qs @ kr.transpose(-1, -2), qpos[rows], kpos, causal)
        p = torch.exp2(s - lse2[:, :, rows, None])
        dp = dof @ vr.transpose(-1, -2)
        ds = (p * (dp + rowbias[:, :, rows, None])).to(dt).float()
        dv += p.to(dt).float().transpose(-1, -2) @ dof
        dk += ds.transpose(-1, -2) @ q_sc
        dq[:, :, rows] = ds @ k_sc
    if hkv != h:
        dk = dk.reshape(b, hkv, h // hkv, skv, d).sum(2)
        dv = dv.reshape(b, hkv, h // hkv, skv, d).sum(2)
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def _arange(n, device):
    return torch.arange(n, dtype=torch.int32, device=device)


def flash_fwd_plain(q, k, v, causal: bool, sm_scale: float):
    """The K2 kernel's arithmetic in plain PyTorch: (out in q's dtype,
    lse f32 natural-log); see ``flash_chunk_fwd_plain``."""
    o, lse = flash_chunk_fwd_plain(q, k, v, _arange(q.shape[2], q.device),
                                   _arange(k.shape[2], q.device), causal,
                                   sm_scale)
    return o.to(q.dtype), lse


def flash_bwd_plain(q, k, v, out, lse, g, causal: bool, sm_scale: float):
    """The K3 kernel's arithmetic in plain PyTorch: (dq, dk, dv); see
    ``_twin_bwd``, with rowbias = -delta and delta = rowsum(dO*O) in f32
    from dO rounded to the input dtype."""
    g = g.to(q.dtype)
    delta = (g.float() * out.float()).sum(-1)
    return _twin_bwd(q, k, v, _arange(q.shape[2], q.device),
                     _arange(k.shape[2], q.device), g, lse, -delta, causal,
                     sm_scale)


def flash_chunk_bwd_plain(q, k, v, qpos, kpos, out, lse, g_out, g_lse,
                          causal: bool, sm_scale: float):
    """The K7 kernel's arithmetic in plain PyTorch: (dq, dk, dv) with the
    lse cotangent, ds = p*(dp + (g_lse - delta)), delta = rowsum(g_out*out)
    in f32 from the f32 g_out; see ``_twin_bwd``."""
    delta = (g_out.float() * out.float()).sum(-1)
    return _twin_bwd(q, k, v, qpos, kpos, g_out.to(q.dtype), lse,
                     g_lse.float() - delta, causal, sm_scale)


def chunk_tile_bounds_plain(qpos, kpos):
    """The chunk kernels' pre-pass in plain PyTorch: an int32 vector of the
    (min, max) of every BLOCK_N-wide block of qpos, then of kpos, then
    min(kpos). K6 and K7 class each (q tile, kv tile) pair by it: masked
    (kmin > qmax, skipped unless the q tile holds a row that sees no key,
    qmin < min kpos), visible (kmax <= qmin) or partial."""
    def blocks(pos):
        n = pos.numel()
        nb = -(-n // BLOCK_N)
        big = torch.iinfo(torch.int32)
        lo = torch.full((nb * BLOCK_N,), big.max, dtype=torch.int32,
                        device=pos.device)
        hi = torch.full_like(lo, big.min)
        lo[:n] = pos
        hi[:n] = pos
        return torch.stack([lo.view(nb, BLOCK_N).amin(1),
                            hi.view(nb, BLOCK_N).amax(1)], 1).reshape(-1)

    qpos, kpos = qpos.to(torch.int32), kpos.to(torch.int32)
    return torch.cat([blocks(qpos), blocks(kpos), kpos.amin().reshape(1)])


def _twin_split(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
                dq_pass: bool):
    """The split kernels' arithmetic (K4 when ``dq_pass``, else K5). s is
    recomputed from the forward's rounded qs; p = exp2(s - lse*log2e); ds =
    p*(dp - delta)*scale in f32, then rounded to the input dtype (K3
    folds the scale into the operands instead); dq = ds.k and dk = ds^T.q
    with k and q unscaled, dv = bf16(p)^T.dO. dk/dv come out per q head,
    [B, H, Skv, D]. ``do`` is dO in the input dtype, delta f32."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    dt = q.dtype
    kr = _repeat_kv(k, h).float()
    vr = _repeat_kv(v, h).float()
    lse2 = lse.float() * LOG2E
    qpos, kpos = _arange(sq, q.device), _arange(skv, q.device)
    if dq_pass:
        dq = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    else:
        dk = torch.zeros((b, h, skv, d), dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
    for m0 in range(0, sq, _TWIN_Q_BLOCK):
        rows = slice(m0, m0 + _TWIN_Q_BLOCK)
        qf = q[:, :, rows].float()
        qs = (qf * (sm_scale * LOG2E)).to(dt).float()
        s = _mask(qs @ kr.transpose(-1, -2), qpos[rows], kpos, causal)
        p = torch.exp2(s - lse2[:, :, rows, None])
        dof = do[:, :, rows].float()
        dp = dof @ vr.transpose(-1, -2)
        ds = (p * (dp - delta[:, :, rows, None]) * sm_scale).to(dt).float()
        if dq_pass:
            dq[:, :, rows] = ds @ kr
        else:
            dv += p.to(dt).float().transpose(-1, -2) @ dof
            dk += ds.transpose(-1, -2) @ qf
    return dq.to(dt) if dq_pass else (dk.to(dt), dv.to(dt))


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool,
                       sm_scale: float):
    """The K4 kernel's arithmetic in plain PyTorch: dq [B,H,Sq,D] in q's
    dtype; see ``_twin_split``."""
    return _twin_split(q, k, v, do, lse, delta, causal, sm_scale, True)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool,
                        sm_scale: float):
    """The K5 kernel's arithmetic in plain PyTorch: (dk, dv) per q head,
    [B,H,Skv,D] in q's dtype; see ``_twin_split``."""
    return _twin_split(q, k, v, do, lse, delta, causal, sm_scale, False)


def fold_heads(t: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    """Per-q-head dk or dv [B, H, S, D] -> [B, Hkv, S, D]: each kv head's
    rep q heads summed in f32 and rounded once to t's dtype (the JAX
    wrapper's fold, ray_tpu/ops/attention.py:1063-1069)."""
    b, h, s, d = t.shape
    if h == num_kv_heads:
        return t
    return t.float().reshape(b, num_kv_heads, h // num_kv_heads, s, d) \
        .sum(2).to(t.dtype)


def _split_bwd(dq_fn, dkv_fn, q, k, v, out, lse, g, causal, sm_scale):
    """dO = g in q's dtype, delta = rowsum(dO*O) in f32 (as K3's wrapper),
    then the dq pass and the dk/dv pass (``dkv_fn`` returns dk/dv folded
    to the kv heads)."""
    do = g.to(q.dtype)
    delta = (do.float() * out.float()).sum(-1)
    dq = dq_fn(q, k, v, do, lse, delta, causal, sm_scale)
    dk, dv = dkv_fn(q, k, v, do, lse, delta, causal, sm_scale)
    return dq, dk, dv


def _dkv_folded_plain(q, k, v, do, lse, delta, causal: bool,
                      sm_scale: float):
    """K5's output in plain PyTorch: its twin's per-q-head dk/dv folded
    to [B,Hkv,Skv,D] by ``fold_heads``."""
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, sm_scale)
    return fold_heads(dk, k.shape[1]), fold_heads(dv, k.shape[1])


def flash_bwd_split_plain(q, k, v, out, lse, g, causal: bool,
                          sm_scale: float):
    """The split backward in plain PyTorch: (dq, dk, dv) from K4's and
    K5's twins and the fold, dk/dv [B,Hkv,Skv,D]."""
    return _split_bwd(flash_bwd_dq_plain, _dkv_folded_plain, q, k, v, out,
                      lse, g, causal, sm_scale)


# --------------------------------------------------------------------------
# CUDA launches
# --------------------------------------------------------------------------

_LIBS: dict[str, ctypes.CDLL] = {}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of each library's launch function rtt_<name>: pointers, then
# B, H, Hkv, Sq, Skv, D, then the scales, causal and the stream.
_ARGTYPES = {
    "flash_fwd": [_P] * 5 + [_I] * 6 + [_F, _I, _P],
    "flash_bwd": [_P] * 9 + [_I] * 6 + [_F, _F, _I, _P],
    "flash_bwd_dq": [_P] * 7 + [_I] * 6 + [_F, _F, _I, _P],
    "flash_bwd_dkv": [_P] * 9 + [_I] * 6 + [_F, _F, _I, _P],
    "flash_chunk_fwd": [_P] * 8 + [_I] * 6 + [_F, _I, _P],
    "flash_chunk_bwd": [_P] * 13 + [_I] * 6 + [_F, _F, _I, _P],
    # the chunk kernels' pre-pass: qpos, kpos, out, Sq, Skv, stream
    "chunk_tile_bounds": [_P] * 3 + [_I] * 2 + [_P],
}


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        from ray_tpu_torch._native.build import load_library

        lib = load_library(name)
        launch = getattr(lib, f"rtt_{name}")
        launch.argtypes = _ARGTYPES[name]
        launch.restype = _I
        err_fn = getattr(lib, f"rtt_{name}_error_string")
        err_fn.argtypes = [_I]
        err_fn.restype = ctypes.c_char_p
        smem_fn = getattr(lib, f"rtt_{name}_smem_bytes")
        smem_fn.argtypes = [_I]
        smem_fn.restype = _I
        if name == "flash_bwd_dkv":  # its f32 fold scratch at D 128
            lib.rtt_flash_bwd_dkv_fold_floats.argtypes = [_I] * 4
            lib.rtt_flash_bwd_dkv_fold_floats.restype = ctypes.c_longlong
        _LIBS[name] = lib
    return lib


def kernel_smem_bytes(name: str, head_dim: int) -> int:
    """Dynamic shared memory a CTA of kernel ``name`` (a key of
    ``_ARGTYPES``) takes at ``head_dim`` (the build's own constant; loads
    the library)."""
    return getattr(_library(name), f"rtt_{name}_smem_bytes")(head_dim)


def _check_cuda(q, k, v):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention kernels need q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention kernels take bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernels take head_dim 64 or 128, "
                         f"got {d}")


def _dense(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _raise_on(lib, name: str, err: int, shape) -> None:
    if err:
        msg = getattr(lib, f"rtt_{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed (q {tuple(shape)}): "
                           f"{msg}")


def flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float):
    """Launch K2: (out bf16 [B,H,Sq,D], lse f32 [B,H,Sq])."""
    _check_cuda(q, k, v)
    q, k, v = _dense(q), _dense(k), _dense(v)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _library("flash_fwd")
    with torch.cuda.device(q.device):
        err = lib.rtt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, hkv, sq, skv, d, sm_scale * LOG2E,
            int(causal), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "flash_fwd", err, q.shape)
    flash_fwd_cuda.launches += 1
    return out, lse


flash_fwd_cuda.launches = 0  # K2 launches since the last reset


def flash_bwd_cuda(q, k, v, out, lse, g, causal: bool, sm_scale: float):
    """Launch K3: (dq [B,H,Sq,D], dk, dv [B,Hkv,Skv,D]), all bf16. The
    kernel makes delta = rowsum(dO*O) in f32 itself, from dO = g in q's
    dtype and the forward's out (the JAX wrapper leaves delta to XLA), and
    sums dq across its CTAs into a zeroed f32 buffer, cast here."""
    _check_cuda(q, k, v)
    if out.shape != q.shape or g.shape != q.shape:
        raise ValueError(f"flash_bwd_cuda: out {tuple(out.shape)} and g "
                         f"{tuple(g.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    g = _dense(g.to(q.dtype))
    out = _dense(out.to(q.dtype))
    q, k, v = _dense(q), _dense(k), _dense(v)
    lse = _dense(lse.float())
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dq_acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _library("flash_bwd")
    with torch.cuda.device(q.device):
        err = lib.rtt_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), out.data_ptr(), dq_acc.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, hkv, sq, skv, d, sm_scale,
            sm_scale * LOG2E, int(causal),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "flash_bwd", err, q.shape)
    flash_bwd_cuda.launches += 1
    return dq_acc.to(q.dtype), dk, dv


flash_bwd_cuda.launches = 0  # K3 launches since the last reset


def _split_inputs(q, k, v, do, lse, delta):
    _check_cuda(q, k, v)
    return (_dense(q), _dense(k), _dense(v), _dense(do.to(q.dtype)),
            _dense(lse.float()), _dense(delta.float()))


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool,
                      sm_scale: float):
    """Launch K4: dq [B,H,Sq,D] bf16 from dO, lse and delta = rowsum(dO*O)
    (f32, [B,H,Sq]); each q tile's rows are written once, no atomics."""
    q, k, v, do, lse, delta = _split_inputs(q, k, v, do, lse, delta)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    lib = _library("flash_bwd_dq")
    with torch.cuda.device(q.device):
        err = lib.rtt_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, hkv, sq,
            skv, d, sm_scale, sm_scale * LOG2E, int(causal),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "flash_bwd_dq", err, q.shape)
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0  # K4 launches since the last reset


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool,
                       sm_scale: float):
    """Launch K5: (dk, dv) folded to the kv heads inside the kernel,
    [B,Hkv,Skv,D] bf16 (each q head's dk/dv rounded to bf16, then summed
    in f32 and rounded once: ``fold_heads`` of ``flash_bwd_dkv_plain``);
    each kv tile's rows are written once."""
    q, k, v, do, lse, delta = _split_inputs(q, k, v, do, lse, delta)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _library("flash_bwd_dkv")
    n_fold = lib.rtt_flash_bwd_dkv_fold_floats(b, hkv, skv, d)
    fold = (torch.empty(n_fold, dtype=torch.float32, device=q.device)
            if n_fold else None)
    with torch.cuda.device(q.device):
        err = lib.rtt_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if fold is None else fold.data_ptr(), b, h, hkv, sq, skv, d,
            sm_scale, sm_scale * LOG2E, int(causal),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "flash_bwd_dkv", err, q.shape)
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dkv_cuda.launches = 0  # K5 launches since the last reset


def flash_bwd_split_cuda(q, k, v, out, lse, g, causal: bool,
                         sm_scale: float):
    """The split backward on the card: K4, then K5 with the GQA fold
    inside; (dq, dk, dv) bf16, dk/dv [B,Hkv,Skv,D]. The same bits on every
    run."""
    return _split_bwd(flash_bwd_dq_cuda, flash_bwd_dkv_cuda, q, k, v, out,
                      lse, g, causal, sm_scale)


def chunk_tile_bounds_cuda(qpos, kpos):
    """Launch the chunk kernels' pre-pass (csrc/chunk_tile_bounds.cu): the
    int32 vector of ``chunk_tile_bounds_plain`` from int32 qpos/kpos on
    the card."""
    if not (qpos.is_cuda and kpos.device == qpos.device):
        raise ValueError(f"chunk_tile_bounds needs qpos and kpos on one CUDA "
                         f"device, got {qpos.device}, {kpos.device}")
    qpos = _dense(qpos.to(torch.int32))
    kpos = _dense(kpos.to(torch.int32))
    sq, skv = qpos.numel(), kpos.numel()
    blocks = -(-sq // BLOCK_N) + -(-skv // BLOCK_N)
    out = torch.empty(2 * blocks + 1, dtype=torch.int32, device=qpos.device)
    lib = _library("chunk_tile_bounds")
    with torch.cuda.device(qpos.device):
        err = lib.rtt_chunk_tile_bounds(
            qpos.data_ptr(), kpos.data_ptr(), out.data_ptr(), sq, skv,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "chunk_tile_bounds", err, qpos.shape)
    chunk_tile_bounds_cuda.launches += 1
    return out


chunk_tile_bounds_cuda.launches = 0  # pre-pass launches since the last reset


def _chunk_positions(q, qpos, kpos):
    qpos = _dense(qpos.to(device=q.device, dtype=torch.int32))
    kpos = _dense(kpos.to(device=q.device, dtype=torch.int32))
    return qpos, kpos, chunk_tile_bounds_cuda(qpos, kpos)


def flash_chunk_fwd_cuda(q, k, v, qpos, kpos, causal: bool,
                         sm_scale: float):
    """Launch K6: (out f32 [B,H,Sq,D], lse f32 [B,H,Sq]) of q against one
    visiting K/V chunk, masked by the int32 global positions qpos [Sq]
    and kpos [Skv]. The pre-pass gives K6 the positions' tile bounds, by
    which it skips the kv tiles that the mask hides wholly."""
    _check_cuda(q, k, v)
    q, k, v = _dense(q), _dense(k), _dense(v)
    qpos, kpos, bounds = _chunk_positions(q, qpos, kpos)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _library("flash_chunk_fwd")
    with torch.cuda.device(q.device):
        err = lib.rtt_flash_chunk_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
            kpos.data_ptr(), bounds.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, hkv, sq, skv, d, sm_scale * LOG2E,
            int(causal), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "flash_chunk_fwd", err, q.shape)
    flash_chunk_fwd_cuda.launches += 1
    return out, lse


flash_chunk_fwd_cuda.launches = 0  # K6 launches since the last reset


def flash_chunk_bwd_cuda(q, k, v, qpos, kpos, out, lse, g_out, g_lse,
                         causal: bool, sm_scale: float):
    """Launch K7: (dq [B,H,Sq,D], dk, dv [B,Hkv,Skv,D]), all bf16, from the
    f32 cotangents of out and lse. delta = rowsum(g_out*out) in f32 and
    dO = g_out in q's dtype are computed here, as the JAX wrapper leaves
    them to XLA; dq is summed in an f32 buffer by the kernel's atomics."""
    _check_cuda(q, k, v)
    delta = _dense((g_out.float() * out.float()).sum(-1))
    do = _dense(g_out.to(q.dtype))
    q, k, v = _dense(q), _dense(k), _dense(v)
    qpos, kpos, bounds = _chunk_positions(q, qpos, kpos)
    lse = _dense(lse.float())
    g_lse = _dense(g_lse.float())
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dq_acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _library("flash_chunk_bwd")
    with torch.cuda.device(q.device):
        err = lib.rtt_flash_chunk_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
            kpos.data_ptr(), bounds.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), g_lse.data_ptr(), dq_acc.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, hkv, sq, skv, d, sm_scale,
            sm_scale * LOG2E, int(causal),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "flash_chunk_bwd", err, q.shape)
    flash_chunk_bwd_cuda.launches += 1
    return dq_acc.to(q.dtype), dk, dv


flash_chunk_bwd_cuda.launches = 0  # K7 launches since the last reset


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q [B,H,Sq,D] and k/v "
                         f"[B,Hkv,Skv,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (GQA needs H % Hkv == 0)")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        if q.device.type == "cpu":
            out, lse = flash_fwd_plain(q, k, v, causal, sm_scale)
        else:
            out, lse = flash_fwd_cuda(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        cpu = q.device.type == "cpu"
        if FUSED_BWD:
            bwd = flash_bwd_plain if cpu else flash_bwd_cuda
        else:
            bwd = flash_bwd_split_plain if cpu else flash_bwd_split_cuda
        dq, dk, dv = bwd(q, k, v, out, lse, g, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: float | None = None) -> torch.Tensor:
    """Flash attention, differentiable: K2 forward and K3 backward (K4 +
    K5 when ``FUSED_BWD`` is false) on CUDA tensors, their plain
    twins on CPU tensors. The saved residuals are (q, k, v, out, lse), so
    the backward never re-runs the forward."""
    _check_shapes(q, k, v)
    return _FlashAttention.apply(q, k, v, causal, _scale(q, sm_scale))


class _FlashChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, causal, sm_scale):
        cpu = q.device.type == "cpu"
        fwd = flash_chunk_fwd_plain if cpu else flash_chunk_fwd_cuda
        out, lse = fwd(q, k, v, qpos, kpos, causal, sm_scale)
        ctx.save_for_backward(q, k, v, qpos, kpos, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, qpos, kpos, out, lse = ctx.saved_tensors
        cpu = q.device.type == "cpu"
        bwd = flash_chunk_bwd_plain if cpu else flash_chunk_bwd_cuda
        dq, dk, dv = bwd(q, k, v, qpos, kpos, out, lse, g_out, g_lse,
                         ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


def flash_attention_chunk(q, k, v, qpos, kpos, causal: bool = True,
                          sm_scale: float | None = None):
    """(out f32 [B,H,Sq,D], lse f32 natural-log [B,H,Sq]) for local q
    against one visiting K/V chunk, GQA-native, with GLOBAL int positions
    qpos [Sq] and kpos [Skv] shared by every batch row and head (ring
    attention's step offsets). Both outputs are differentiable, so a
    cross-chunk log-sum-exp combine backpropagates exactly: K6 forward and
    K7 backward on CUDA tensors, their plain twins on CPU tensors."""
    _check_shapes(q, k, v)
    if qpos.shape != (q.shape[2],) or kpos.shape != (k.shape[2],):
        raise ValueError(f"flash_attention_chunk: qpos {tuple(qpos.shape)} "
                         f"and kpos {tuple(kpos.shape)} must be [Sq] = "
                         f"[{q.shape[2]}] and [Skv] = [{k.shape[2]}]")
    return _FlashChunk.apply(q, k, v, qpos, kpos, causal, _scale(q, sm_scale))
