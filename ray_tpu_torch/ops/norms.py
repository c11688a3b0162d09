"""RMSNorm: hand-written CUDA kernel (csrc/rms_norm.cu) + plain version.

Port of ray_tpu/ops/norms.py. ``rms_norm`` launches the CUDA kernel for
CUDA tensors and runs ``rms_norm_reference`` only for tensors on the CPU.
There is no fallback: a failed build, a refused launch or an unsupported
shape raises. Unlike the Pallas wrapper, which falls back to the reference
when ``rows % block_rows != 0``, the kernel takes every row count.

Gradients: on a CUDA tensor that requires a gradient, the launch sits in
a ``torch.autograd.Function`` (``_RmsNormFn``). Its forward is the kernel;
its backward is the VJP of ``rms_norm_reference`` in plain tensor ops on
the card, as the JAX package's ``_rms_bwd`` is ``jax.vjp`` of its
reference computed by XLA rather than by a Pallas kernel. A backward
kernel is later work. Without a gradient to track (serving, under
``no_grad``/``inference_mode``) the kernel is launched directly.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def rms_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch twin of ray_tpu.ops.norms.rms_norm_reference."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def _check(x: torch.Tensor, weight: torch.Tensor) -> int:
    d = x.shape[-1]
    if tuple(weight.shape) != (d,):
        raise ValueError(f"rms_norm weight shape {tuple(weight.shape)} != "
                         f"({d},)")
    if x.dtype not in _DTYPE_CODES or weight.dtype not in _DTYPE_CODES:
        raise TypeError(f"rms_norm takes float32/float16/bfloat16, got "
                        f"{x.dtype} and {weight.dtype}")
    return d


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2, -1) + eps) * weight, statistics in f32, cast
    back to x's dtype. x: [..., d]; weight: [d] in its own dtype."""
    d = _check(x, weight)
    if x.device.type == "cpu" and weight.device.type == "cpu":
        return rms_norm_reference(x, weight, eps)
    if d <= 0 or d % 8:  # the kernel's 16-byte vectors; the plain path takes any d
        raise ValueError(f"rms_norm's kernel needs a last dim that is a "
                         f"positive multiple of 8, got {d}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RmsNormFn.apply(x, weight, eps)
    return _rms_norm_cuda(x, weight, eps, d)


rms_norm.launches = 0  # kernel launches since the last reset


class _RmsNormFn(torch.autograd.Function):
    """Kernel forward; backward = VJP of the plain reference (JAX's
    ``_rms_bwd``), recomputed from the saved input in plain tensor ops."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms_norm_cuda(x, weight, eps, x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_(ctx.needs_input_grad[0])
            wd = weight.detach().requires_grad_(ctx.needs_input_grad[1])
            y = rms_norm_reference(xd, wd, ctx.eps)
            wrt = [t for t in (xd, wd) if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, g))
        dx = next(grads) if ctx.needs_input_grad[0] else None
        dw = next(grads) if ctx.needs_input_grad[1] else None
        return dx, dw, None


_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from ray_tpu_torch._native.build import load_library

        lib = load_library("rms_norm")
        lib.rtt_rms_norm.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p]
        lib.rtt_rms_norm.restype = ctypes.c_int
        lib.rtt_error_string.argtypes = [ctypes.c_int]
        lib.rtt_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _aligned(t: torch.Tensor, align: int) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % align == 0 else t.clone()


def _rms_norm_cuda(x: torch.Tensor, weight: torch.Tensor, eps: float,
                   d: int) -> torch.Tensor:
    if not (x.is_cuda and weight.device == x.device):
        raise ValueError(f"rms_norm kernel needs x and weight on one CUDA "
                         f"device, got {x.device} and {weight.device}")
    lib = _library()
    vec = 16 // x.element_size()  # elements per 16-byte access of x
    x2 = _aligned(x, 16)
    w2 = _aligned(weight, weight.element_size() * vec)
    y = torch.empty_like(x2)
    rows = x2.numel() // d
    if rows == 0:
        return y.view(x.shape)
    dev = x.device.index
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            err = _launch(lib, x2, w2, y, rows, d, eps)
    else:
        err = _launch(lib, x2, w2, y, rows, d, eps)
    if err:
        raise RuntimeError(f"rms_norm kernel launch failed "
                           f"(rows={rows}, d={d}, {x.dtype}): "
                           f"{lib.rtt_error_string(err).decode()}")
    rms_norm.launches += 1
    return y.view(x.shape)


def _launch(lib, x, w, y, rows, d, eps) -> int:
    return lib.rtt_rms_norm(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d,
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[w.dtype], eps,
        torch.cuda.current_stream().cuda_stream)
