from .search import choice, grid_search, loguniform, randint, uniform  # noqa: F401
from .schedulers import (  # noqa: F401
    ASHAScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
)
from .tpe import Searcher, TPESearcher  # noqa: F401
from .tuner import ResultGrid, TuneConfig, Tuner, TrialResult  # noqa: F401
