"""Architecture registry: the 10 assigned archs as selectable configs plus a
uniform functional Model API (init / forward / loss).  Counterpart of
``repro/models/registry.py``: ``ARCHS`` is a data copy of the JAX
package's table, field for field.

``build_model`` builds every family (dense, vlm, moe, ssm, hybrid and the
audio enc-dec), with the decode API (``init_cache``/``decode_step``: a
cache the step updates in place).  With parameters that carry a leading
worker dim (the LLM trainer's), ``loss`` returns one loss per worker, and
so do its metrics.  A batch holds ``tokens`` (..., B, S), and ``patches``
(..., B, P, frontend_dim) for the vlm arch (the loss is over the text
positions only) or ``frames`` (..., B, T_frames, d_model) for the audio
one; the moe loss is ``xent + 0.1·mtp + aux``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import encdec, hybrid, moe, ssm, transformer
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# the assigned architectures (exact dims from the assignment sheet)
# ---------------------------------------------------------------------------

ARCHS: Dict[str, ModelConfig] = {
    # [hf:Qwen/Qwen1.5-0.5B family scaled to 110B card] — QKV bias
    "qwen1.5-110b": ModelConfig(
        name="qwen1.5-110b", family="dense", n_layers=80, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=49152, vocab_size=152064,
        head_dim=128, qkv_bias=True, mlp_act="silu", rope_theta=1e6),
    # [hf:Qwen/CodeQwen1.5-7B] — qwen1.5 arch, MHA (kv=32)
    "codeqwen1.5-7b": ModelConfig(
        name="codeqwen1.5-7b", family="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=32, d_ff=13440, vocab_size=92416,
        head_dim=128, qkv_bias=True, mlp_act="silu", rope_theta=1e6),
    # [arXiv:2402.19173] — GQA kv=4, RoPE, gelu MLP, biases
    "starcoder2-15b": ModelConfig(
        name="starcoder2-15b", family="dense", n_layers=40, d_model=6144,
        n_heads=48, n_kv_heads=4, d_ff=24576, vocab_size=49152,
        head_dim=128, qkv_bias=True, mlp_act="gelu_mlp", rope_theta=1e5),
    # [arXiv:2405.04324] — llama-arch code model
    "granite-8b": ModelConfig(
        name="granite-8b", family="dense", n_layers=36, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=49152,
        head_dim=128, mlp_act="silu", rope_theta=1e4),
    # [arXiv:2412.19437] — MLA, 1 shared + 256 routed top-8, MTP
    "deepseek-v3-671b": ModelConfig(
        name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
        n_heads=128, n_kv_heads=128, d_ff=18432, vocab_size=129280,
        mlp_act="silu", rope_theta=1e4,
        n_experts=256, n_experts_active=8, n_shared_experts=1,
        moe_d_ff=2048, first_dense_layers=3,
        use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128, mtp=True),
    # [hf:Qwen/Qwen3-30B-A3B] — 128 experts top-8, GQA kv=4
    "qwen3-moe-30b-a3b": ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=4, d_ff=768, vocab_size=151936,
        head_dim=128, mlp_act="silu", rope_theta=1e6,
        n_experts=128, n_experts_active=8, moe_d_ff=768),
    # [arXiv:2402.19427] — RG-LRU + local attn 1:2, MQA window 2048
    "recurrentgemma-2b": ModelConfig(
        name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
        n_heads=10, n_kv_heads=1, d_ff=7680, vocab_size=256000,
        head_dim=256, mlp_act="geglu", rope_theta=1e4,
        block_pattern=("rec", "rec", "attn"), lru_width=2560,
        attn_window=2048, conv1d_width=4),
    # [hf:mistralai/Pixtral-12B-2409] — pixtral-ViT (stub) + mistral-nemo
    "pixtral-12b": ModelConfig(
        name="pixtral-12b", family="vlm", n_layers=40, d_model=5120,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=131072,
        head_dim=128, mlp_act="silu", rope_theta=1e6,
        modality="vision", frontend_tokens=256, frontend_dim=1024),
    # [arXiv:2410.05355] — mamba1 arch, attention-free
    "falcon-mamba-7b": ModelConfig(
        name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
        n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=65024,
        d_inner=8192, ssm_state=16, dt_rank=256, conv1d_width=4),
    # [arXiv:2308.11596] — enc-dec, stub mel/conv frontend
    "seamless-m4t-medium": ModelConfig(
        name="seamless-m4t-medium", family="audio", n_layers=12, d_model=1024,
        n_heads=16, n_kv_heads=16, d_ff=4096, vocab_size=256206,
        head_dim=64, mlp_act="gelu_mlp", rope_theta=1e4,
        n_enc_layers=12, cross_attention=True, modality="audio",
        frontend_tokens=1024, frontend_dim=1024),
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)


# ---------------------------------------------------------------------------
# uniform model API
# ---------------------------------------------------------------------------

class Model(NamedTuple):
    cfg: ModelConfig
    #: init(key, device="cuda") -> params
    init: Callable[..., Any]
    #: forward(params, batch, remat=True) -> (logits, aux_loss)
    forward: Callable[..., Any]
    #: loss(params, batch, remat=True) -> (loss, metrics); loss has the
    #: params' leading (worker) dims
    loss: Callable[..., Any]
    #: init_cache(batch, max_seq, dtype=None, device="cuda") -> cache
    init_cache: Callable[..., Any]
    #: decode_step(params, cache, token, pos) -> (logits, cache); the cache
    #: is updated in place (JAX donates it)
    decode_step: Callable[..., Any]


def _xent(logits: Tensor, labels: Tensor, mask: Optional[Tensor] = None,
          lead: int = 0) -> Tensor:
    """Mean token cross-entropy, log-softmax in f32; the ``lead`` leading
    dims are kept (one loss per worker)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    ll = ll.reshape(ll.shape[:lead] + (-1,))
    if mask is not None:
        m = mask.reshape(ll.shape).to(ll.dtype)
        return -torch.sum(ll * m, -1) / torch.clamp_min(torch.sum(m, -1), 1.0)
    return -torch.mean(ll, -1)


#: the module of each family
FAMILIES = {"dense": transformer, "vlm": transformer, "moe": moe,
            "ssm": ssm, "hybrid": hybrid, "audio": encdec}


def build_model(cfg: ModelConfig) -> Model:
    fam = cfg.family
    if fam not in FAMILIES:
        raise ValueError(f"unknown family {fam!r}")
    module = FAMILIES[fam]

    def init(key: int, device="cuda"):
        return module.init_params(key, cfg, device)

    def zero(logits: Tensor) -> Tensor:
        return torch.zeros((), device=logits.device)

    if fam == "moe":
        def forward(params, batch, remat=True):
            logits, aux, _ = moe.lm_forward(params, cfg, batch["tokens"],
                                            remat=remat)
            return logits, aux
    elif fam == "audio":
        def forward(params, batch, remat=True):
            logits = encdec.lm_forward(params, cfg, batch["tokens"],
                                       batch["frames"], remat=remat)
            return logits, zero(logits)
    elif fam == "vlm":
        def forward(params, batch, remat=True):
            logits = transformer.lm_forward(
                params, cfg, batch["tokens"],
                frontend_embeds=batch.get("patches"), remat=remat)
            return logits, zero(logits)
    else:
        def forward(params, batch, remat=True):
            logits = module.lm_forward(params, cfg, batch["tokens"],
                                       remat=remat)
            return logits, zero(logits)

    def loss(params, batch, remat=True):
        tokens = batch["tokens"]
        lead = params["embed"]["table"].dim() - 2
        if fam == "moe":
            logits, aux, mtp_logits = moe.lm_forward(
                params, cfg, tokens, remat=remat, return_mtp=cfg.mtp)
            l = _xent(logits[..., :-1, :], tokens[..., 1:], lead=lead)
            metrics = {"xent": l, "aux": aux}
            if mtp_logits is not None:       # predict t+2
                l_mtp = _xent(mtp_logits[..., :-2, :], tokens[..., 2:],
                              lead=lead)
                metrics["mtp"] = l_mtp
                l = l + 0.1 * l_mtp
            return l + aux, metrics
        logits, _ = forward(params, batch, remat)
        if fam == "vlm":        # the loss only on the text positions
            logits = logits[..., -tokens.shape[-1]:, :]
        l = _xent(logits[..., :-1, :], tokens[..., 1:], lead=lead)
        return l, {"xent": l}

    def init_cache(batch: int, max_seq: int, dtype=None, device="cuda",
                   **kw):
        return module.init_cache(cfg, batch, max_seq, dtype=dtype,
                                 device=device, **kw)

    def decode_step(params, cache, token, pos):
        return module.decode_step(params, cfg, cache, token, pos)

    return Model(cfg, init, forward, loss, init_cache, decode_step)


def get_model(name: str, reduced: bool = False,
              sliding_window: Optional[int] = None) -> Model:
    cfg = get_config(name)
    if reduced:
        cfg = cfg.reduced()
    if sliding_window is not None and cfg.family not in ("ssm", "hybrid"):
        cfg = cfg.with_sliding_window(sliding_window)
    return build_model(cfg)


# ---------------------------------------------------------------------------
# analytic parameter counts (roofline MODEL_FLOPS = 6·N·D)
# ---------------------------------------------------------------------------

def analytic_param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    V = cfg.vocab_size
    embed = V * d

    def attn_params() -> int:
        hd = cfg.hd
        if cfg.use_mla:
            q_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            q = (d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads * q_head
                 if cfg.q_lora_rank else d * cfg.n_heads * q_head)
            kv = d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
            up = cfg.n_heads * cfg.kv_lora_rank * (cfg.qk_nope_head_dim
                                                   + cfg.v_head_dim)
            o = cfg.n_heads * cfg.v_head_dim * d
            return q + kv + up + o
        return d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)

    def mlp_params(f: int) -> int:
        return 3 * d * f if cfg.mlp_act in ("silu", "geglu") else 2 * d * f

    if cfg.family in ("dense", "vlm"):
        per_layer = attn_params() + mlp_params(cfg.d_ff)
        return embed + cfg.n_layers * per_layer

    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        dense_l = attn_params() + mlp_params(cfg.d_ff)
        E_counted = cfg.n_experts_active if active_only else cfg.n_experts
        routed = E_counted * 3 * d * cfg.moe_d_ff
        shared = cfg.n_shared_experts * 3 * d * cfg.moe_d_ff
        router = d * cfg.n_experts
        moe_l = attn_params() + routed + shared + router
        total = embed + nd * dense_l + (cfg.n_layers - nd) * moe_l
        if cfg.mtp:
            total += moe_l + 2 * d * d
        return total

    if cfg.family == "ssm":
        di, n, r = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
        per_layer = (d * 2 * di + cfg.conv1d_width * di
                     + di * (r + 2 * n) + r * di + di * n + di + di * d)
        return embed + cfg.n_layers * per_layer

    if cfg.family == "hybrid":
        dw = cfg.lru_width
        rec = d * dw * 2 + cfg.conv1d_width * dw + 2 * dw * dw + dw + dw * d
        attn = attn_params()
        mlp_l = mlp_params(cfg.d_ff)
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if cfg.block_pattern[i % len(cfg.block_pattern)] == "attn")
        n_rec = cfg.n_layers - n_attn
        return embed + n_rec * (rec + mlp_l) + n_attn * (attn + mlp_l)

    if cfg.family == "audio":
        enc_l = attn_params() + mlp_params(cfg.d_ff)
        dec_l = 2 * attn_params() + mlp_params(cfg.d_ff)
        return embed + cfg.n_enc_layers * enc_l + cfg.n_layers * dec_l

    raise ValueError(cfg.family)


def packed_param_count(cfg: ModelConfig) -> int:
    """Every parameter ``init_params`` builds, so the length D of the
    trainer's packed (W, D) buffers: the analytic count plus what it leaves
    out (norm scales and biases; the vlm's projector; MLA's q and kv
    norms; the MTP block's norms)."""
    d, L_ = cfg.d_model, cfg.n_layers
    qkv_bias = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd \
        if cfg.qkv_bias else 0
    mlp_bias = cfg.d_ff + d if cfg.mlp_act == "gelu_mlp" else 0
    if cfg.family in ("dense", "vlm"):
        per_layer = 2 * d + qkv_bias + mlp_bias
        extra = cfg.frontend_dim * d if cfg.modality == "vision" else 0
        return analytic_param_count(cfg) + L_ * per_layer + d + extra
    if cfg.family == "moe":
        # two norms a block, MLA's kv (and q) norm or the qkv biases; the
        # routed and shared experts are gated (no biases)
        attn_norms = (cfg.kv_lora_rank + cfg.q_lora_rank if cfg.use_mla
                      else qkv_bias)
        per_block = 2 * d + attn_norms
        n_dense = cfg.first_dense_layers
        mtp = per_block + d if cfg.mtp else 0     # its block and mtp_norm
        return (analytic_param_count(cfg) + L_ * per_block
                + n_dense * mlp_bias + d + mtp)
    if cfg.family == "ssm":
        # the norm, the b/c/dt norms, the conv and dt_proj biases
        per_layer = d + 2 * cfg.ssm_state + cfg.dt_rank + 2 * cfg.d_inner
        return analytic_param_count(cfg) + L_ * per_layer + d
    if cfg.family == "hybrid":
        # two norms a layer; a recurrent one adds the conv and both gate
        # biases
        n_rec = sum(1 for i in range(L_) if cfg.block_pattern[
            i % len(cfg.block_pattern)] == "rec")
        return (analytic_param_count(cfg) + 2 * d * L_
                + 3 * cfg.lru_width * n_rec + d)
    if cfg.family == "audio":
        # layernorms (scale and bias): two an encoder layer, three a
        # decoder layer, and the two final ones
        enc = 4 * d + qkv_bias + mlp_bias
        dec = 6 * d + 2 * qkv_bias + mlp_bias
        return (analytic_param_count(cfg) + cfg.n_enc_layers * enc
                + L_ * dec + 4 * d)
    raise ValueError(cfg.family)
