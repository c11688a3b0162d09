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

Vocabulary-parallel (``tp_group``): the head holds this rank's
``V / tp`` columns, from ``vocab_start``. Each chunk's logsumexp is
taken over the local columns, and the ranks' logsumexps are gathered and
combined (a logsumexp of tp values, exact for one); the target logit is
the one rank's that holds the target, all-reduced. The backward returns
this rank's part of dx (the caller's tp conjugate sums it) and the local
columns' dhead. With a one-rank group the arithmetic is the function's
without one, bit for bit.
"""

from __future__ import annotations

import os

import torch


def _env_int(name: str, default: int) -> int:
    """A positive int from the environment; unset, unparsable or <= 0
    gives ``default`` (the JAX package's ``_env_int``)."""
    v = os.environ.get(name)
    if not v:
        return default
    try:
        n = int(v)
    except ValueError:
        return default
    return n if n > 0 else default


def default_ce_chunk(default: int = 512) -> int:
    """Sequence-chunk size for :func:`fused_cross_entropy`, overridable by
    ``RTPU_CE_CHUNK`` (the train-step autotuner sets it per candidate).
    Larger chunks take fewer steps but a bigger [B, chunk, V] f32 logits
    workspace, the loss's largest transient. JAX reads it once, when the
    step is traced; the eager port reads it at every ``loss_fn`` call, so
    a measurement runs its warm-up and timed steps inside the
    candidate's ``applied_env()``, not only the step's construction."""
    return _env_int("RTPU_CE_CHUNK", default)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] -> f32, accumulating in f32 from a and b's own
    dtype (JAX's ``preferred_element_type=jnp.float32``)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk(s: int, chunk: int) -> int:
    chunk = min(chunk, s)
    return chunk if s % chunk == 0 else s  # one chunk when ragged


def _local_targets(targets, v0: int, v: int):
    """Targets as local columns of a head holding ``v`` columns from
    ``v0`` (clamped), and where they fall inside it."""
    local = targets - v0
    inside = (local >= 0) & (local < v)
    return local.clamp(0, v - 1), inside


class _FusedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, head_w, targets, mask, chunk, group, v0):
        import torch.distributed as dist

        b, s, h = x.shape
        c = _chunk(s, chunk)
        lse = torch.empty((b, s), dtype=torch.float32, device=x.device)
        tgt = torch.empty_like(lse)
        cols, inside = _local_targets(targets, v0, head_w.shape[1])
        for s0 in range(0, s, c):
            logits = _mm_f32(x[:, s0:s0 + c].reshape(-1, h), head_w)
            lse[:, s0:s0 + c] = torch.logsumexp(logits, dim=-1).view(b, c)
            tgt[:, s0:s0 + c] = logits.gather(
                1, cols[:, s0:s0 + c].reshape(-1, 1)).view(b, c)
        if group is not None:  # the ranks' columns: one logsumexp, one
            parts = lse.new_empty((dist.get_world_size(group) * b, s))
            dist.all_gather_into_tensor(parts, lse, group=group)
            lse = torch.logsumexp(parts.view(-1, b, s), dim=0)
            tgt = torch.where(inside, tgt, tgt.new_zeros(()))
            dist.all_reduce(tgt, group=group)  # target logit
        if mask is None:
            mask_f = torch.ones((b, s), dtype=torch.float32, device=x.device)
        else:
            mask_f = mask.float()
        denom = torch.clamp(mask_f.sum(), min=1.0)
        nll = ((lse - tgt) * mask_f).sum() / denom
        ctx.save_for_backward(x, head_w, cols, inside, lse, mask_f, denom)
        ctx.chunk = c
        return nll

    @staticmethod
    def backward(ctx, g):
        x, head_w, cols, inside, lse, mask_f, denom = ctx.saved_tensors
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
            p.scatter_add_(1, cols[:, s0:s0 + c].reshape(-1, 1),
                           torch.where(inside[:, s0:s0 + c].reshape(-1, 1),
                                       -1.0, 0.0))
            dlogits = p * w[:, s0:s0 + c].reshape(-1, 1)
            dx[:, s0:s0 + c] = _mm_f32(dlogits.to(head_w.dtype),
                                       head_t).view(b, c, h).to(x.dtype)
            dhead += _mm_f32(xb.t(), dlogits.to(x.dtype))
        return (dx, dhead.to(head_w.dtype), None, None, None, None, None)


class _LogitsF32(torch.autograd.Function):
    """x [N, H] @ head [H, V] -> f32 logits; the backward's products
    round the f32 cotangent to the inputs' dtype first, as the fused
    loss's backward does."""

    @staticmethod
    def forward(ctx, x, head_w):
        ctx.save_for_backward(x, head_w)
        return _mm_f32(x, head_w)

    @staticmethod
    def backward(ctx, g):
        x, head_w = ctx.saved_tensors
        dx = _mm_f32(g.to(head_w.dtype), head_w.t()).to(x.dtype)
        dhead = _mm_f32(x.t(), g.to(x.dtype)).to(head_w.dtype)
        return dx, dhead


def logits_f32(x: torch.Tensor, head_w: torch.Tensor) -> torch.Tensor:
    """x [..., H] @ head_w [H, V] -> f32 logits [..., V], accumulated in
    f32 from the inputs' own dtype (JAX's ``einsum(...,
    preferred_element_type=jnp.float32)``): bf16 tensor-core products on
    the card, not an f32 GEMM of widened inputs."""
    lead = x.shape[:-1]
    out = _LogitsF32.apply(x.reshape(-1, x.shape[-1]), head_w)
    return out.view(*lead, head_w.shape[1])


def fused_cross_entropy(x: torch.Tensor, head_w: torch.Tensor,
                        targets: torch.Tensor,
                        mask: torch.Tensor | None = None,
                        chunk: int = 512, tp_group=None,
                        vocab_start: int = 0) -> torch.Tensor:
    """Mean next-token NLL over unmasked positions without [B, S, V]
    logits. x [B, S, H] final hidden states; head_w [H, V]; targets [B, S]
    integer ids; mask [B, S] weights (None = all ones). ``chunk`` is the
    sequence chunk; when it does not divide S the whole sequence is one
    chunk, as in the JAX op. With ``tp_group``, head_w is this rank's
    columns ``vocab_start`` .. ``+ head_w.shape[1]`` of the whole head
    (see the module docstring)."""
    return _FusedCrossEntropy.apply(x, head_w, targets.long(), mask,
                                    int(chunk), tp_group, int(vocab_start))
