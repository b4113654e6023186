"""Config: seamless-m4t-medium  [arXiv:2308.11596].  The port's copy of
``repro/configs/seamless_m4t_medium.py``: the dims from the registry, plus the
reduced smoke variant."""
from repro_torch.models.registry import get_config

ARCH = "seamless-m4t-medium"
CONFIG = get_config(ARCH)
REDUCED = CONFIG.reduced()
