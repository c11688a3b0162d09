"""Attention: plain references, and flash attention with hand-written CUDA
forward (csrc/flash_fwd.cu) and fused backward (csrc/flash_bwd.cu) kernels.

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
  the call raises.

Shapes: q [B, H, Sq, D], k/v [B, Hkv, Skv, D], GQA when Hkv < H; k/v are
never repeated on the kernel path. The kernels take bf16 and D in {64, 128},
any sequence length (the ragged tail is masked, where the Pallas wrapper
asserts ``S % block == 0``).
"""

from __future__ import annotations

import ctypes
import math

import torch

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
# Plain twins of the two kernels (CPU path; chip_smoke.py's comparisons)
# --------------------------------------------------------------------------

def _mask(s, q0, k0, sq_total, skv_total, causal):
    """-1e30 where kpos > qpos (causal) or past either sequence's end."""
    qpos = torch.arange(q0, q0 + s.shape[-2], device=s.device)[:, None]
    kpos = torch.arange(k0, k0 + s.shape[-1], device=s.device)[None, :]
    ok = (kpos < skv_total) & (qpos < sq_total)
    if causal:
        ok = ok & (kpos <= qpos)
    return torch.where(ok, s, torch.full_like(s, NEG_INF))


def flash_fwd_plain(q, k, v, causal: bool, sm_scale: float):
    """The K2 kernel's arithmetic in plain PyTorch: (out in q's dtype,
    lse f32 natural-log). qs = q*scale*log2e rounded to q's dtype once; s
    in f32; base-2 online softmax over the kernel's 64-wide kv tiles; p
    rounded to v's dtype for p.v and for the row sum l."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    k = _repeat_kv(k, h).float()
    v = _repeat_kv(v, h)
    qs = (q.float() * (sm_scale * LOG2E)).to(q.dtype).float()
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for n0 in range(0, skv, BLOCK_N):
        s = _mask(qs @ k[:, :, n0:n0 + BLOCK_N].transpose(-1, -2), 0, n0,
                  sq, skv, causal)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp2(s - m_new[..., None]).to(v.dtype)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.float().sum(dim=-1)
        o = o * alpha[..., None] + p.float() @ v[:, :, n0:n0 + BLOCK_N].float()
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = (o / l[..., None]).to(q.dtype)
    lse = (m + torch.log2(l)) * LN2
    return out, lse


def flash_bwd_plain(q, k, v, out, lse, g, causal: bool, sm_scale: float):
    """The K3 kernel's arithmetic in plain PyTorch: (dq, dk, dv), dk/dv
    folded to the kv heads in f32. s is recomputed from the forward's
    rounded qs; p = exp2(s - lse*log2e); ds = p*(dp - delta) with delta =
    rowsum(dO*O) in f32; p and ds rounded to the input dtype before their
    products; the scale rides q_sc = q*scale (dk) and k_sc = k*scale (dq),
    each rounded to the input dtype."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dt = q.dtype
    kr = _repeat_kv(k, h).float()
    vr = _repeat_kv(v, h).float()
    k_sc = (kr * sm_scale).to(dt).float()
    g = g.to(dt)
    delta = (g.float() * out.float()).sum(-1)
    lse2 = lse.float() * LOG2E
    dq = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, h, skv, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for m0 in range(0, sq, _TWIN_Q_BLOCK):
        rows = slice(m0, m0 + _TWIN_Q_BLOCK)
        qf = q[:, :, rows].float()
        qs = (qf * (sm_scale * LOG2E)).to(dt).float()
        q_sc = (qf * sm_scale).to(dt).float()
        do = g[:, :, rows].float()
        s = _mask(qs @ kr.transpose(-1, -2), m0, 0, sq, skv, causal)
        p = torch.exp2(s - lse2[:, :, rows, None])
        dp = do @ vr.transpose(-1, -2)
        ds = (p * (dp - delta[:, :, rows, None])).to(dt).float()
        dv += p.to(dt).float().transpose(-1, -2) @ do
        dk += ds.transpose(-1, -2) @ q_sc
        dq[:, :, rows] = ds @ k_sc
    if hkv != h:
        dk = dk.reshape(b, hkv, h // hkv, skv, d).sum(2)
        dv = dv.reshape(b, hkv, h // hkv, skv, d).sum(2)
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------
# CUDA launches
# --------------------------------------------------------------------------

_LIBS: dict[str, ctypes.CDLL] = {}


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        from ray_tpu_torch._native.build import load_library

        lib = load_library(name)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "flash_fwd":
            lib.rtt_flash_fwd.argtypes = [p] * 5 + [i] * 6 + [f, i, p]
            lib.rtt_flash_fwd.restype = i
        else:
            lib.rtt_flash_bwd.argtypes = [p] * 9 + [i] * 6 + [f, f, i, p]
            lib.rtt_flash_bwd.restype = i
        err_fn = getattr(lib, f"rtt_{name}_error_string")
        err_fn.argtypes = [i]
        err_fn.restype = ctypes.c_char_p
        smem_fn = getattr(lib, f"rtt_{name}_smem_bytes")
        smem_fn.argtypes = [i]
        smem_fn.restype = i
        _LIBS[name] = lib
    return lib


def kernel_smem_bytes(name: str, head_dim: int) -> int:
    """Dynamic shared memory a CTA of ``name`` ("flash_fwd"/"flash_bwd")
    takes at ``head_dim`` (the build's own constant; loads the library)."""
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
    """Launch K3: (dq [B,H,Sq,D], dk, dv [B,Hkv,Skv,D]), all bf16. delta =
    rowsum(dO*O) in f32 is computed here, as the JAX wrapper leaves it to
    XLA; dq is summed in an f32 buffer by the kernel's atomics."""
    _check_cuda(q, k, v)
    g = _dense(g.to(q.dtype))
    q, k, v = _dense(q), _dense(k), _dense(v)
    lse = _dense(lse.float())
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    delta = _dense((g.float() * out.float()).sum(-1))
    dq_acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _library("flash_bwd")
    with torch.cuda.device(q.device):
        err = lib.rtt_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, hkv, sq, skv, d, sm_scale,
            sm_scale * LOG2E, int(causal),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "flash_bwd", err, q.shape)
    flash_bwd_cuda.launches += 1
    return dq_acc.to(q.dtype), dk, dv


flash_bwd_cuda.launches = 0  # K3 launches since the last reset


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
        bwd = flash_bwd_plain if q.device.type == "cpu" else flash_bwd_cuda
        dq, dk, dv = bwd(q, k, v, out, lse, g, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: float | None = None) -> torch.Tensor:
    """Flash attention, differentiable: K2 forward and K3 backward on CUDA
    tensors, their plain twins on CPU tensors. The saved residuals are (q,
    k, v, out, lse), so the backward never re-runs the forward."""
    _check_shapes(q, k, v)
    return _FlashAttention.apply(q, k, v, causal, _scale(q, sm_scale))
