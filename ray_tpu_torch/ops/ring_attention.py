"""Ring attention: exact attention over a sequence sharded across the ranks
of a ``torch.distributed`` process group, with K/V chunks rotating around
the ring by point-to-point sends.

Port of ray_tpu/ops/ring_attention.py. There the ring is a mesh axis
inside ``shard_map`` and the rotation is ``lax.ppermute``; here the axis is
a process group whose rank order is the shard order, and the rotation is
``_RingShift``: one ``batch_isend_irecv`` to rank (my + 1) mod n from rank
(my - 1) mod n, whose backward shifts the gradients the other way (what
``ppermute``'s transpose does). Each rank holds S/n of the sequence; at
step t it attends its local q against the chunk owned by (my - t) mod n,
then passes that chunk on. The shift is blocking: overlapping it with the
step is later work.

Causality across chunks: positions are global (chunk index * chunk length
+ local offset); a visiting chunk wholly in the future is masked and the
combine gives it weight 0.

``impl``: "flash" runs each step through ``flash_attention_chunk`` (K6/K7
on CUDA tensors, their twins on CPU tensors) and combines the per-chunk
(out, lse) by log-sum-exp; "einsum" materializes each step's scores; "auto"
takes flash for CUDA tensors and einsum for CPU tensors, as JAX takes
flash on the TPU only.
"""

from __future__ import annotations

import math
import warnings

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.attention import (
    NEG_INF,
    _repeat_kv,
    flash_attention_chunk,
)


def _ring_step_combine(q, k, v, o, m, l, scale, causal, q_offset, kv_offset):
    """One online-softmax accumulation of local q against a visiting kv
    chunk (k/v already repeated to q's heads), at the chunks' global
    position offsets."""
    sq, skv = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(skv, device=q.device)[None, :] + kv_offset
        s = torch.where(kpos <= qpos, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p.to(v.dtype), v).float()
    return o_new, m_new, l_new


def ring_flash_step(q, kc, vc, qpos, kpos, o, lse, causal: bool,
                    scale: float):
    """One ring step of the flash path: ``flash_attention_chunk`` of local q
    against the visiting chunk (kc, vc) at global positions (qpos, kpos),
    then the log-sum-exp combine of its normalized (out, lse) into the
    running (o, lse), all f32. A wholly masked chunk arrives with lse ~
    -6.9e29 and gets weight exp(lse - lse_new) = 0."""
    o_t, lse_t = flash_attention_chunk(q, kc, vc, qpos, kpos, causal, scale)
    lse_new = torch.logaddexp(lse, lse_t)
    w_old = torch.exp(lse - lse_new)[..., None]
    w_new = torch.exp(lse_t - lse_new)[..., None]
    return o * w_old + o_t * w_new, lse_new


def _peer(group, group_rank: int) -> int:
    return dist.get_global_rank(group, group_rank) if group is not None \
        else group_rank


class _RingShift(torch.autograd.Function):
    """Send each tensor to group rank (my + 1) mod n and receive the
    previous rank's; the backward sends the gradients to (my - 1) mod n."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return _shift(group, tensors, +1)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_shift(ctx.group, grads, -1))


def _shift(group, tensors, direction: int):
    n = dist.get_world_size(group)
    my = dist.get_rank(group)
    to = _peer(group, (my + direction) % n)
    frm = _peer(group, (my - direction) % n)
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, to, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, frm, group) for t in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(recvs)


def _ring_schedule(my: int, n: int, chunk: int, device):
    """Rank ``my`` of ``n``'s schedule: its q positions, then for each step t
    the owner of the visiting chunk, src = (my - t) mod n, with that
    chunk's positions. Positions are global: owner * chunk + offset."""
    local = torch.arange(chunk, dtype=torch.int32, device=device)
    return my * chunk + local, [(src, src * chunk + local)
                                for src in ((my - t) % n for t in range(n))]


def ring_attention_local(q, k, v, axis, causal: bool = True,
                         sm_scale: float | None = None, impl: str = "auto"):
    """Per-rank body: q [B, H, S/n, D] and k/v [B, Hkv, S/n, D] are this
    rank's shard of the sequence; ``axis`` is the process group (None: the
    default group) whose rank order is the shard order. Returns this
    shard's attention output in q's dtype. The rotation after the last
    step would only bring the chunks home, so it is skipped; with n = 1 no
    point-to-point op is issued."""
    b, h, sq, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    n = dist.get_world_size(axis)
    my = dist.get_rank(axis)
    if impl == "auto":
        impl = "einsum" if q.device.type == "cpu" else "flash"
    if impl not in ("flash", "einsum"):
        raise ValueError(f"ring attention impl {impl!r}: 'auto', 'flash' "
                         f"or 'einsum'")
    qpos, steps = _ring_schedule(my, n, sq, q.device)
    if impl == "einsum":
        k = _repeat_kv(k, h)
        v = _repeat_kv(v, h)
        m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
    else:
        lse = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                         device=q.device)
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    kc, vc = k, v
    for t, (src, kpos) in enumerate(steps):
        if impl == "einsum":
            o, m, l = _ring_step_combine(q, kc, vc, o, m, l, scale, causal,
                                         my * sq, src * sq)
        else:
            o, lse = ring_flash_step(q, kc, vc, qpos, kpos, o, lse, causal,
                                     scale)
        if t < n - 1:
            kc, vc = _RingShift.apply(axis, kc, vc)
    if impl == "einsum":
        o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.to(q.dtype)


def ring_attention_sharded(q, k, v, group=None, causal: bool = True,
                           sm_scale: float | None = None,
                           impl: str = "auto"):
    """Global-array entry: q [B, H, S, D] and k/v [B, Hkv, S, D], the same
    on every rank of ``group``. Each rank takes its shard of the sequence,
    runs the ring, and the global output comes back through the
    differentiable all-gather. Its backward sums the ranks' cotangents, so
    ranks that each take 1/n of one global loss get that loss's gradient
    for their own shard."""
    n = dist.get_world_size(group)
    my = dist.get_rank(group)
    s = q.shape[2]
    if s % n:
        raise ValueError(f"sequence length {s} does not split over {n} "
                         f"ranks")
    rows = slice(my * (s // n), (my + 1) * (s // n))
    out = ring_attention_local(q[:, :, rows], k[:, :, rows], v[:, :, rows],
                               group, causal, sm_scale, impl)
    from torch.distributed.nn.functional import all_gather

    with warnings.catch_warnings():  # it warns of a successor it prefers
        warnings.simplefilter("ignore", FutureWarning)
        parts = all_gather(out, group=group)
    return torch.cat(parts, dim=2)


def simulate_ring(q, k, v, n: int, causal: bool = True,
                  sm_scale: float | None = None):
    """The flash ring's schedule for n virtual ranks in one process, without
    the transport: virtual rank r runs ``_ring_schedule(r, n, ...)``, the
    schedule ``ring_attention_local`` runs, taking each visiting chunk from
    the global k/v instead of a shift, through the same
    ``ring_flash_step``. Returns the global output [B, H, S, D] in q's
    dtype; differentiable. It checks the ring's arithmetic where only one
    device is at hand."""
    s = q.shape[2]
    if s % n:
        raise ValueError(f"sequence length {s} does not split over {n}")
    chunk = s // n
    b, h, _, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    outs = []
    for r in range(n):
        qpos, steps = _ring_schedule(r, n, chunk, q.device)
        o = torch.zeros((b, h, chunk, d), dtype=torch.float32,
                        device=q.device)
        lse = torch.full((b, h, chunk), NEG_INF, dtype=torch.float32,
                         device=q.device)
        for src, kpos in steps:
            rows = slice(src * chunk, (src + 1) * chunk)
            o, lse = ring_flash_step(q[:, :, r * chunk:(r + 1) * chunk],
                                     k[:, :, rows], v[:, :, rows], qpos,
                                     kpos, o, lse, causal, scale)
        outs.append(o.to(q.dtype))
    return torch.cat(outs, dim=2)
