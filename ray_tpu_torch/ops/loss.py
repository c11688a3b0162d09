"""Fused softmax cross-entropy over a large vocabulary.

Port of ray_tpu/ops/loss.py. The final ``hidden @ head`` projection and
log-softmax never materialise the [B, S, V] logits: the forward walks
sequence chunks, reduces each chunk's f32 logits to logsumexp and target
logit and drops them; the backward (a ``torch.autograd.Function``)
recomputes each chunk's logits from the saved hidden states and
accumulates dx and dhead. The products are plain matrix products, as the
JAX package leaves them to XLA: bf16 inputs with f32 outputs
(``torch.mm(..., out_dtype=torch.float32)`` on the card, f32 products of
the exactly widened inputs on the CPU).
"""

from __future__ import annotations

import torch


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] -> f32, accumulating in f32 from a and b's own
    dtype (JAX's ``preferred_element_type=jnp.float32``)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk(s: int, chunk: int) -> int:
    chunk = min(chunk, s)
    return chunk if s % chunk == 0 else s  # one chunk when ragged


class _FusedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, head_w, targets, mask, chunk):
        b, s, h = x.shape
        c = _chunk(s, chunk)
        lse = torch.empty((b, s), dtype=torch.float32, device=x.device)
        tgt = torch.empty_like(lse)
        for s0 in range(0, s, c):
            logits = _mm_f32(x[:, s0:s0 + c].reshape(-1, h), head_w)
            lse[:, s0:s0 + c] = torch.logsumexp(logits, dim=-1).view(b, c)
            tgt[:, s0:s0 + c] = logits.gather(
                1, targets[:, s0:s0 + c].reshape(-1, 1)).view(b, c)
        if mask is None:
            mask_f = torch.ones((b, s), dtype=torch.float32, device=x.device)
        else:
            mask_f = mask.float()
        denom = torch.clamp(mask_f.sum(), min=1.0)
        nll = ((lse - tgt) * mask_f).sum() / denom
        ctx.save_for_backward(x, head_w, targets, lse, mask_f, denom)
        ctx.chunk = c
        return nll

    @staticmethod
    def backward(ctx, g):
        x, head_w, targets, lse, mask_f, denom = ctx.saved_tensors
        b, s, h = x.shape
        c = ctx.chunk
        w = (mask_f * (g / denom)).to(torch.float32)
        dx = torch.empty_like(x)
        dhead = torch.zeros(head_w.shape, dtype=torch.float32,
                            device=x.device)
        head_t = head_w.t()
        for s0 in range(0, s, c):
            xb = x[:, s0:s0 + c].reshape(-1, h)
            logits = _mm_f32(xb, head_w)
            p = torch.exp(logits - lse[:, s0:s0 + c].reshape(-1, 1))
            p.scatter_add_(1, targets[:, s0:s0 + c].reshape(-1, 1),
                           torch.full((b * c, 1), -1.0, device=x.device))
            dlogits = p * w[:, s0:s0 + c].reshape(-1, 1)
            dx[:, s0:s0 + c] = _mm_f32(dlogits.to(head_w.dtype),
                                       head_t).view(b, c, h).to(x.dtype)
            dhead += _mm_f32(xb.t(), dlogits.to(x.dtype))
        return dx, dhead.to(head_w.dtype), None, None, None


def fused_cross_entropy(x: torch.Tensor, head_w: torch.Tensor,
                        targets: torch.Tensor,
                        mask: torch.Tensor | None = None,
                        chunk: int = 512) -> torch.Tensor:
    """Mean next-token NLL over unmasked positions without [B, S, V]
    logits. x [B, S, H] final hidden states; head_w [H, V]; targets [B, S]
    integer ids; mask [B, S] weights (None = all ones). ``chunk`` is the
    sequence chunk; when it does not divide S the whole sequence is one
    chunk, as in the JAX op."""
    return _FusedCrossEntropy.apply(x, head_w, targets.long(), mask,
                                    int(chunk))
