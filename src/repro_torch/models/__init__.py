"""Models: the paper's MLP as a flat parameter vector (``mlp``), and the
LLMs of the registry (``config``, ``registry``, ``layers``): the dense
transformers (``transformer``), the mamba1 SSM (``ssm``) and the Griffin
hybrid (``hybrid``)."""
from repro_torch.models import hybrid, ssm, transformer  # noqa: F401
from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.registry import (ARCHS, Model, build_model,  # noqa: F401
                                         get_config, get_model, list_archs)
