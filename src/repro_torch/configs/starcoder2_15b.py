"""Config: starcoder2-15b  [arXiv:2402.19173].  The port's copy of
``repro/configs/starcoder2_15b.py``: the dims from the registry, plus the
reduced smoke variant."""
from repro_torch.models.registry import get_config

ARCH = "starcoder2-15b"
CONFIG = get_config(ARCH)
REDUCED = CONFIG.reduced()
