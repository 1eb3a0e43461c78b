"""The nine baselines the paper compares against (Tables I/II), on the
cohort engine they and ``ucfl`` share
(:mod:`repro_torch.core.baselines.common`). Importing the package
registers each in :data:`repro_torch.core.strategy.REGISTRY`."""
from repro_torch.core.baselines import (  # noqa: F401
    cfl,
    ditto,
    fedavg,
    fedfomo,
    fedprox,
    local,
    oracle,
    pfedme,
    scaffold,
)
