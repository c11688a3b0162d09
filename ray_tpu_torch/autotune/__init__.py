"""ray_tpu_torch.autotune: the memory-model-guided train-step autotuner.

Port of ray_tpu.autotune: candidates across the configuration space the
port's training step supports (batch x remat policy, per-layer mixes
included, x ZeRO-1 x gradient accumulation x the fused loss's CE chunk),
an analytic peak-memory prediction for each (no step built), pruning
against the card's memory (``device_hbm_budget_bytes``), a ranking of the
survivors, and measurement of the top few by the caller's
``measure_fn``, with a JSON cache keyed by device kind + geometry.

Not ported: the flash block knobs (the Hopper kernels fix their tiles;
``autotune.space``), and ``parallel/hlo_stats.py`` (``compiled_hbm_bytes``
reads XLA's compiled HLO): a port measurement reads
``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``
instead and records ``hbm_source: "torch.cuda.max_memory_allocated"``.
"""

from ray_tpu_torch.autotune.model import (
    HbmPrediction,
    device_hbm_budget_bytes,
    predict_hbm,
)
from ray_tpu_torch.autotune.search import (
    AutotuneCache,
    SearchResult,
    autotune_train_configs,
)
from ray_tpu_torch.autotune.space import Candidate, candidate_space

__all__ = [
    "AutotuneCache",
    "Candidate",
    "HbmPrediction",
    "SearchResult",
    "autotune_train_configs",
    "candidate_space",
    "device_hbm_budget_bytes",
    "predict_hbm",
]
