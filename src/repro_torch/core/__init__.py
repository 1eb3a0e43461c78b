from repro_torch.core import ucfl  # noqa: F401  (registers "ucfl")
from repro_torch.core import baselines  # noqa: F401  (registers the nine baselines)
from repro_torch.core.strategy import REGISTRY, FedConfig, Strategy  # noqa: F401
from repro_torch.federated.participation import Cohort, ParticipationConfig  # noqa: F401
