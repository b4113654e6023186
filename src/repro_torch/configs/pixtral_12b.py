"""Config: pixtral-12b  [hf:mistralai/Pixtral-12B-2409].  The port's copy of
``repro/configs/pixtral_12b.py``: the dims from the registry, plus the
reduced smoke variant."""
from repro_torch.models.registry import get_config

ARCH = "pixtral-12b"
CONFIG = get_config(ARCH)
REDUCED = CONFIG.reduced()
