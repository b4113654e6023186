"""Config: qwen1.5-110b  [hf:Qwen/Qwen1.5-110B (arch family: Qwen1.5, QKV
bias)].  The port's copy of ``repro/configs/qwen1_5_110b.py``: the dims
from the registry, plus the reduced smoke variant."""
from repro_torch.models.registry import get_config

ARCH = "qwen1.5-110b"
CONFIG = get_config(ARCH)
REDUCED = CONFIG.reduced()
