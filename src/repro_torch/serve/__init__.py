"""Serving: prefill and batched greedy decode over the model API
(counterpart of ``repro/serve``)."""
from repro_torch.serve.serving import (generate, make_prefill,  # noqa: F401
                                       make_serve_step)
