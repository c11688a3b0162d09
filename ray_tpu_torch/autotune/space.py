"""Train-step candidate space: every tuning dimension the port's step has.

Port of ray_tpu/autotune/space.py. A ``Candidate`` is one fully-specified
train-step configuration. Its ``label`` keeps the JAX package's
``b{batch}/{remat}/{attn}/{opt}`` prefix and appends the other dimensions
only when they deviate from the defaults, so labels of the two packages
name the same configurations.

The flash block knobs are not ported: ``flash_block_q``/``flash_block_k``
set the Pallas kernels' VMEM tiles (``RTPU_FLASH_BLOCK_Q/K``), while the
port's Hopper kernels fix their tiles when they are built and read no
such variable. ``candidate_space(include_kernel_knobs=True)`` therefore
yields the ``ce_chunk`` variants only, and ``env_overrides()`` of a
candidate with a flash block set raises ``NotImplementedError`` (ROADMAP
Queue B: flash tile candidates for the Hopper kernels).
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class Candidate:
    """One train-step configuration the autotuner can price and measure."""

    batch: int
    remat: str                      # scalar policy or "pol:N,pol:N" spec
    attn: str = "flash"
    opt: str = "lowmem"             # "lowmem" (compact moments) | "adamw"
    zero1: bool = False             # ZeRO-1 sharded weight update
    grad_accum: int = 1             # microbatches per step
    flash_block_q: int | None = None   # None = kernel default (512)
    flash_block_k: int | None = None
    ce_chunk: int | None = None        # None = fused-CE default (512)

    @property
    def label(self) -> str:
        parts = [f"b{self.batch}", self.remat.replace(",", "|"), self.attn,
                 self.opt]
        if self.zero1:
            parts.append("z1")
        if self.grad_accum > 1:
            parts.append(f"ga{self.grad_accum}")
        # bk rides the label whenever SET (even when equal to bq): an
        # explicit bk compiles differently from "bk inherits the env/512
        # default", and the label keys the persistent measurement cache —
        # conflating the two would bank one config's number as the other's.
        if self.flash_block_q:
            parts.append(f"bq{self.flash_block_q}")
        if self.flash_block_k:
            parts.append(f"bk{self.flash_block_k}")
        if self.ce_chunk:
            parts.append(f"ck{self.ce_chunk}")
        return "/".join(parts)

    def step_options(self) -> dict:
        """kwargs for make_llama_train_step beyond (batch, remat, attn)."""
        out: dict = {}
        if self.zero1:
            out["zero1"] = True
        if self.grad_accum > 1:
            out["grad_accum"] = self.grad_accum
        return out

    def env_overrides(self) -> dict[str, str]:
        """Process-env knobs the step reads (ops/loss.default_ce_chunk, at
        every call). A flash block raises: see the module docstring."""
        if self.flash_block_q or self.flash_block_k:
            raise NotImplementedError(
                f"candidate {self.label}: flash block sizes are the Pallas "
                f"kernels' tiles; the port's Hopper kernels fix theirs when "
                f"they are built (ROADMAP Queue B: flash tile candidates)")
        env = {}
        if self.ce_chunk:
            env["RTPU_CE_CHUNK"] = str(self.ce_chunk)
        return env

    @contextlib.contextmanager
    def applied_env(self):
        """Set the env knobs for this candidate and restore the previous
        values after. The port reads them at every step, so the steps to
        measure run inside this context, not only the step's
        construction. ``os.environ`` is the process's: this is not for
        trials that run at once in one process (Tune's trials are threads
        of one), only for one candidate at a time."""
        saved = {}
        try:
            for k, v in self.env_overrides().items():
                saved[k] = os.environ.get(k)
                os.environ[k] = v
            yield
        finally:
            for k, old in saved.items():
                if old is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = old


def _per_layer_mixes(num_layers: int) -> list[str]:
    """Mixed per-layer remat specs worth trying. Total saved bytes vs total
    recompute FLOPs is what matters (every layer's residuals live until its
    backward step regardless of depth), so the useful mixes are
    half-and-half blends between adjacent uniform policies — the midpoints
    of the memory/recompute trade that a scalar policy cannot express.
    These are exactly the configs that exploit a leftover HBM margin too
    small for the next uniform policy up."""
    half = num_layers // 2
    rest = num_layers - half
    return [
        f"attn+:{half},attn:{rest}",   # between 'attn' and 'attn+'
        f"dots:{half},attn:{rest}",    # between 'attn' and 'dots'
        f"dots:{half},attn+:{rest}",   # between 'attn+' and 'dots'
    ]


def candidate_space(num_layers: int,
                    batches: tuple[int, ...] = (4, 5, 6, 8, 12, 16),
                    attn: str = "flash",
                    opt: str = "lowmem",
                    include_zero1: bool = True,
                    include_grad_accum: bool = True,
                    include_kernel_knobs: bool = True) -> list[Candidate]:
    """The search space of the JAX package less its flash block variants.
    Structured, not a full cross product: every
    (batch x remat) point is present — the HBM model prunes the ones that
    cannot fit, so enumerating 'too big' configs is free — while the
    orthogonal dimensions (ZeRO-1, grad accumulation, CE chunk sizes)
    attach to the historically competitive bases rather than
    multiplying the whole grid."""
    remats = ["attn", "attn+", "dots", "dots+"] + _per_layer_mixes(num_layers)
    cands = [Candidate(batch=b, remat=r, attn=attn, opt=opt)
             for b in batches for r in remats]

    if include_zero1:
        # ZeRO-1 costs nothing at dp=1 and divides optimizer HBM by the
        # data-parallel world elsewhere; pair it with the batches that the
        # freed HBM could promote to a richer remat.
        cands += [Candidate(batch=b, remat=r, attn=attn, opt=opt, zero1=True)
                  for b in batches[:4] for r in ("attn", "attn+", "dots")]
    if include_grad_accum:
        # Microbatching: big effective batches at small-activation cost —
        # the HBM lever that lets b16/b32 class candidates fit at all.
        cands += [
            Candidate(batch=b, remat=r, attn=attn, opt=opt, grad_accum=ga)
            for (b, ga) in ((8, 2), (16, 2), (16, 4), (32, 4))
            for r in ("attn", "attn+")
        ]
    if include_kernel_knobs:
        # CE chunk variants around the defending champion shapes (the
        # flash block variants of the JAX space are not ported).
        for b in batches[:2]:
            for ck in (256, 1024):
                cands.append(Candidate(batch=b, remat="attn", attn=attn,
                                       opt=opt, ce_chunk=ck))
    # de-dup while preserving order (mixes can collide at small layer counts)
    seen: set[str] = set()
    out = []
    for c in cands:
        if c.label not in seen:
            seen.add(c.label)
            out.append(c)
    return out


def legacy_candidates(rows: list[tuple]) -> list[Candidate]:
    """Adapt the old hand-written (batch, remat, attn, opt) rows."""
    return [Candidate(batch=b, remat=r, attn=a, opt=o) for b, r, a, o in rows]


def with_overrides(cand: Candidate, **kw) -> Candidate:
    return replace(cand, **kw)
