"""Config: granite-8b  [arXiv:2405.04324].  The port's copy of
``repro/configs/granite_8b.py``: the dims from the registry, plus the
reduced smoke variant."""
from repro_torch.models.registry import get_config

ARCH = "granite-8b"
CONFIG = get_config(ARCH)
REDUCED = CONFIG.reduced()
