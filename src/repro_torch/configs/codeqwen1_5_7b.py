"""Config: codeqwen1.5-7b  [hf:Qwen/CodeQwen1.5-7B].  The port's copy of
``repro/configs/codeqwen1_5_7b.py``: the dims from the registry, plus the
reduced smoke variant."""
from repro_torch.models.registry import get_config

ARCH = "codeqwen1.5-7b"
CONFIG = get_config(ARCH)
REDUCED = CONFIG.reduced()
