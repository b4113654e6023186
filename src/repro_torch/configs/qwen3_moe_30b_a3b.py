"""Config: qwen3-moe-30b-a3b  [hf:Qwen/Qwen3-30B-A3B].  The port's copy of
``repro/configs/qwen3_moe_30b_a3b.py``: the dims from the registry, plus the
reduced smoke variant."""
from repro_torch.models.registry import get_config

ARCH = "qwen3-moe-30b-a3b"
CONFIG = get_config(ARCH)
REDUCED = CONFIG.reduced()
