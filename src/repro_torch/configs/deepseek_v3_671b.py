"""Config: deepseek-v3-671b  [arXiv:2412.19437].  The port's copy of
``repro/configs/deepseek_v3_671b.py``: the dims from the registry, plus the
reduced smoke variant."""
from repro_torch.models.registry import get_config

ARCH = "deepseek-v3-671b"
CONFIG = get_config(ARCH)
REDUCED = CONFIG.reduced()
