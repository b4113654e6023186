"""Config: falcon-mamba-7b  [arXiv:2410.05355].  The port's copy of
``repro/configs/falcon_mamba_7b.py``: the dims from the registry, plus the
reduced smoke variant."""
from repro_torch.models.registry import get_config

ARCH = "falcon-mamba-7b"
CONFIG = get_config(ARCH)
REDUCED = CONFIG.reduced()
