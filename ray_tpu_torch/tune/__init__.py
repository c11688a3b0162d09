"""ray_tpu_torch.tune: hyperparameter search over trial actors.

Port of ray_tpu.tune on the port's in-process runtime (reference:
python/ray/tune/ — Tuner tuner.py:43, TuneController
execution/tune_controller.py:67, searchers search/, schedulers
schedulers/, Trainable trainable/). The RL algorithms subclass its
``Trainable``. Not ported: the JAX package's usage telemetry on import.
Importing it builds no kernel and starts no thread.
"""

from ray_tpu_torch.tune.schedulers import (
    AsyncHyperBandScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import (
    BasicVariantGenerator,
    TPESearcher,
    Searcher,
    choice,
    grid_search,
    loguniform,
    quniform,
    randint,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.trainable import Trainable, get_checkpoint, report
from ray_tpu_torch.tune.trial import Trial
from ray_tpu_torch.tune.tuner import ResultGrid, TuneConfig, Tuner, TuneResult

__all__ = [
    "Tuner", "TuneConfig", "ResultGrid", "TuneResult", "Trial",
    "Trainable", "report", "get_checkpoint",
    "grid_search", "uniform", "loguniform", "quniform", "randint", "choice",
    "sample_from", "Searcher", "BasicVariantGenerator", "TPESearcher",
    "TrialScheduler", "FIFOScheduler", "AsyncHyperBandScheduler",
    "MedianStoppingRule", "PopulationBasedTraining",
]
