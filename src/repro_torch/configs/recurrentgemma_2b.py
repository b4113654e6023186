"""Config: recurrentgemma-2b  [arXiv:2402.19427].  The port's copy of
``repro/configs/recurrentgemma_2b.py``: the dims from the registry, plus
the reduced smoke variant."""
from repro_torch.models.registry import get_config

ARCH = "recurrentgemma-2b"
CONFIG = get_config(ARCH)
REDUCED = CONFIG.reduced()
