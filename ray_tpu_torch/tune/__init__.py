"""ray_tpu_torch.tune — experiment sweeps (Ray Tune equivalent).

Search spaces (grid/random domains), trial schedulers (ASHA, median
stopping), and a Tuner running concurrent trial actors with early stop.
Report from a trainable with ray_tpu_torch.train.report(...) (or its
alias tune.report).

Port of `ray_tpu/tune/__init__.py`: the same exports.
"""

from ..train.session import get_checkpoint, report  # noqa: F401  (tune aliases)
from .schedulers import (  # noqa: F401
    Exploit,
    PopulationBasedTraining,
    ASHAScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    TrialScheduler,
)
from .search import (  # noqa: F401
    choice,
    generate_variants,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from .tuner import ResultGrid, Trial, TrialStatus, TuneConfig, Tuner  # noqa: F401
