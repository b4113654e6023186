"""Models: the paper's MLP as a flat parameter vector (``mlp``), and the
LLMs of the registry (``config``, ``registry``, ``layers``): the dense
transformers and the vlm backbone (``transformer``), the mixture of
experts with MLA (``moe``), the mamba1 SSM (``ssm``), the Griffin hybrid
(``hybrid``) and the audio enc-dec (``encdec``)."""
from repro_torch.models import (encdec, hybrid, moe, ssm,  # noqa: F401
                                transformer)
from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.registry import (ARCHS, Model, build_model,  # noqa: F401
                                         get_config, get_model, list_archs)
