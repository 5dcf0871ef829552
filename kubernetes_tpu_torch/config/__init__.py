"""Config surface: Policy API, ComponentConfig, algorithm providers,
Configurator factory (pkg/scheduler/{api,apis/config,algorithmprovider,
factory}); the port's own copy of `kubernetes_tpu.config`."""

from .componentconfig import (
    KubeSchedulerConfiguration,
    LeaderElectionConfig,
    load_component_config,
    parse_component_config,
)
from .factory import Configurator
from .policy import (
    DEFAULT_HARD_POD_AFFINITY_WEIGHT,
    DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE,
    Policy,
    PolicyError,
    parse_policy,
)
from .provider import (
    KNOWN_PREDICATES,
    KNOWN_PRIORITIES,
    PROVIDERS,
    VOLUME_PREDICATES,
    default_predicates,
    default_priorities,
    get_provider,
)

__all__ = [
    "KubeSchedulerConfiguration",
    "LeaderElectionConfig",
    "load_component_config",
    "parse_component_config",
    "Configurator",
    "DEFAULT_HARD_POD_AFFINITY_WEIGHT",
    "DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE",
    "Policy",
    "PolicyError",
    "parse_policy",
    "KNOWN_PREDICATES",
    "KNOWN_PRIORITIES",
    "PROVIDERS",
    "VOLUME_PREDICATES",
    "default_predicates",
    "default_priorities",
    "get_provider",
]
