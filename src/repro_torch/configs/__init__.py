"""Model configs of the port (copied schema) + registry."""
from repro_torch.configs.base import *  # noqa: F401,F403
from repro_torch.configs.registry import ASSIGNED, CONFIGS, get_config  # noqa: F401
