"""Unified architecture config covering all six assigned families.

Counterpart of ``repro/models/config.py``, field for field; ``dtype`` is a
torch dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config type for dense / moe / hybrid / ssm / vlm / audio archs.

    Family-specific fields default to "off"; each family's builder only reads
    the fields it understands.  ``reduced()`` produces the CPU smoke-test
    variant of the same family (2 layers, d_model<=512, <=4 experts).
    """

    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    mlp_act: str = "silu"            # silu (swiglu) | gelu (plain 2-matrix)
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- attention variants -------------------------------------------------
    #: sliding-window size; None = full attention. Set per-shape by the
    #: launcher for long_500k on attention archs (the "SW variant").
    sliding_window: Optional[int] = None

    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    n_experts_active: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0      # deepseek: leading dense layers
    router_aux_weight: float = 1e-3

    # --- MLA (deepseek-v3) ---------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False                # multi-token-prediction extra block

    # --- hybrid (recurrentgemma) ----------------------------------------------
    #: repeating block pattern, e.g. ("rec", "rec", "attn")
    block_pattern: Tuple[str, ...] = ()
    lru_width: int = 0
    attn_window: int = 0
    conv1d_width: int = 4

    # --- SSM (mamba1) ----------------------------------------------------------
    ssm_state: int = 0
    d_inner: int = 0
    dt_rank: int = 0

    # --- enc-dec (seamless) ----------------------------------------------------
    n_enc_layers: int = 0
    cross_attention: bool = False

    # --- modality frontend (stubbed per brief) ---------------------------------
    modality: str = "text"           # text | vision | audio
    #: embeddings-per-request supplied by the stub frontend (patches/frames)
    frontend_tokens: int = 0
    frontend_dim: int = 0

    param_dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Natively sub-quadratic in sequence length (no SW variant needed)."""
        return self.family in ("ssm", "hybrid")

    def with_sliding_window(self, window: int) -> "ModelConfig":
        return dataclasses.replace(self, sliding_window=window)

    def reduced(self) -> "ModelConfig":
        """CPU smoke-test variant: same family/topology, tiny dims."""
        d_model = min(self.d_model, 128)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        repl = dict(
            n_layers=2 if not self.block_pattern else max(2, len(self.block_pattern)),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=32,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
        )
        if self.n_experts:
            repl.update(n_experts=4, n_experts_active=2,
                        n_shared_experts=min(self.n_shared_experts, 1),
                        moe_d_ff=64, first_dense_layers=min(self.first_dense_layers, 1))
        if self.use_mla:
            repl.update(q_lora_rank=min(self.q_lora_rank, 64) or 0,
                        kv_lora_rank=64, qk_nope_head_dim=32,
                        qk_rope_head_dim=16, v_head_dim=32, head_dim=None)
        if self.lru_width:
            repl.update(lru_width=d_model, attn_window=64)
        if self.d_inner:
            repl.update(d_inner=2 * d_model, dt_rank=max(1, d_model // 16),
                        ssm_state=8)
        if self.n_enc_layers:
            repl.update(n_enc_layers=2)
        if self.frontend_tokens:
            repl.update(frontend_tokens=16, frontend_dim=64)
        if self.sliding_window is not None:
            repl.update(sliding_window=32)
        return dataclasses.replace(self, **repl)

    def param_count(self) -> int:
        """Analytic N for MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE)."""
        from repro_torch.models.registry import analytic_param_count
        return analytic_param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models.registry import analytic_param_count
        return analytic_param_count(self, active_only=True)
