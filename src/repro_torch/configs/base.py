"""Config system (own copy of ``repro.configs.base``): the model,
federation and input-shape configurations.

Every field of the reference's ``ModelConfig`` is here, and every family
runs: dense, MoE, RWKV6 (family ``"ssm"``), the Mamba hybrid (jamba), vlm
(llama-3.2-vision) and audio (seamless-m4t); ``get_config(name)`` resolves
every arch id of ``ARCH_IDS``.
``reduced(cfg)`` produces the CPU-smoke variant of the same family
(2 layers, d_model <= 512, <= 4 experts), as in the reference.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace
from typing import Optional

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    # 'einsum' = GShard one-hot dispatch (baseline), 'scatter' = gather/scatter
    dispatch: str = "einsum"
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM (used by jamba hybrid)."""

    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 'Finch' data-dependent decay linear attention."""

    head_dim: int = 64
    decay_lora: int = 64
    token_shift: bool = True


@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 0  # 0 -> d_model // num_heads
    # pattern: 'full', 'swa' (all layers sliding window), 'local_global'
    # (alternating, gemma2), 'chunked' (block-local, llama4-style)
    pattern: str = "full"
    window: int = 4096
    logit_softcap: float = 0.0  # 0 = disabled; gemma2 uses 50.0
    rope_theta: float = 10000.0
    qk_norm: bool = False


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    # family: 'dense' | 'moe' | 'ssm' (rwkv6) | 'hybrid' (jamba) |
    #         'vlm' | 'audio' (enc-dec)
    family: str = "dense"
    num_layers: int = 4
    d_model: int = 256
    d_ff: int = 1024
    vocab_size: int = 32000
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # hybrid (jamba): one attention layer every `attn_every` layers
    attn_every: int = 0
    # MoE interleave: MoE FFN every `moe_every` layers (jamba=2, mixtral=1)
    moe_every: int = 1
    # vlm: cross-attention image layers every `cross_attn_every` layers
    cross_attn_every: int = 0
    num_image_tokens: int = 1024
    # audio enc-dec
    encoder_layers: int = 0
    num_audio_frames: int = 1024
    tie_embeddings: bool = False
    gated_mlp: bool = True  # SwiGLU (3 mats) vs classic MLP (2 mats, granite)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # final-logit softcap (gemma2)
    final_softcap: float = 0.0
    source: str = ""  # citation

    @property
    def head_dim(self) -> int:
        a = self.attention
        return a.head_dim if a.head_dim else self.d_model // a.num_heads

    def param_count(self) -> int:
        """Analytic total parameter count (embedding included)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        a = self.attention
        attn = (d * hd * a.num_heads + 2 * d * hd * a.num_kv_heads
                + hd * a.num_heads * d)
        n_mats = 3 if self.gated_mlp else 2
        dense_ffn = n_mats * d * f
        total = 0
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            p = 2 * d  # norms
            if kind in ("attn", "cross"):
                p += attn
                if kind == "cross":  # cross layer = self block + cross block
                    p += attn + 2 * d
            elif kind == "ssm":
                di = d * (self.ssm.expand if self.ssm else 2)
                n = self.ssm.state_dim if self.ssm else 16
                dtr = self._dt_rank()
                p += 2 * d * di + di * self.ssm.conv_width
                p += di * (dtr + 2 * n) + dtr * di + di * d + 2 * di
            elif kind == "rwkv":
                p += 5 * d * d  # r,k,v,g,o time-mix projections
                p += 2 * d * (self.rwkv.decay_lora if self.rwkv else 64)
                p += d * d + 2 * d * f  # channel-mix: r + k + v
            if kind != "rwkv":
                if self._is_moe_layer(i):
                    p += (self.moe.num_experts * n_mats * d * f
                          + d * self.moe.num_experts)
                else:
                    p += dense_ffn
            total += p
        total += v * d + d
        if not self.tie_embeddings:
            total += v * d
        if self.family == "audio":
            total += self.encoder_layers * (attn + dense_ffn + 2 * d)
        return total

    def _dt_rank(self) -> int:
        if not self.ssm:
            return 0
        return self.ssm.dt_rank or -(-self.d_model // 16)

    def _is_moe_layer(self, i: int) -> bool:
        every = max(self.moe_every, 1)
        return bool(self.moe) and i % every == every - 1

    def layer_kind(self, i: int) -> str:
        """'attn' | 'ssm' | 'rwkv' | 'cross' for layer i (the FFN is
        ``_is_moe_layer``'s)."""
        if self.family == "ssm":
            return "rwkv"
        if self.family == "audio":
            return "cross"  # every decoder layer cross-attends the encoder
        if self.family == "hybrid":
            ae = max(self.attn_every, 1)
            return "attn" if (i % ae == ae - 1) else "ssm"
        if self.family == "vlm" and self.cross_attn_every:
            ce = self.cross_attn_every
            if i % ce == ce - 1:
                return "cross"
        return "attn"

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts instead of all)."""
        if not self.moe:
            return self.param_count()
        n_moe_layers = sum(1 for i in range(self.num_layers)
                           if self._is_moe_layer(i))
        n_mats = 3 if self.gated_mlp else 2
        inactive = ((self.moe.num_experts - self.moe.top_k) * n_mats
                    * self.d_model * self.d_ff)
        return self.param_count() - n_moe_layers * inactive


# ---------------------------------------------------------------------------
# Federation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FederationConfig:
    algorithm: str = "fedpbc"  # fedpbc|fedavg|fedavg_all|fedau|mifa|fedavg_known_p|f3ast
    num_clients: int = 16
    local_steps: int = 5
    # placement: 'simulated' (batched clients), 'stacked_data', 'pod_silo'
    placement: str = "simulated"
    scheme: str = "bernoulli"  # bernoulli|markov|cyclic
    time_varying: bool = False
    gamma: float = 0.5          # Eq. (9) fluctuation
    period: int = 40            # Eq. (9) sine period
    delta: float = 0.02         # p_i clip lower bound
    sigma0: float = 10.0        # lognormal class-weight spread
    alpha: float = 0.1          # Dirichlet non-IID
    cyclic_length: int = 100
    cyclic_reset: bool = False
    fedau_K: int = 50
    f3ast_beta: float = 0.01
    f3ast_cap: int = 10
    known_p: bool = False


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


ARCH_IDS = (
    "rwkv6-3b",
    "deepseek-coder-33b",
    "granite-34b",
    "smollm-135m",
    "jamba-1.5-large-398b",
    "llama-3.2-vision-90b",
    "gemma2-9b",
    "seamless-m4t-medium",
    "mixtral-8x22b",
    "llama4-maverick-400b-a17b",
)



def get_config(name: str) -> ModelConfig:
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCH_IDS)}")
    module = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{module}").CONFIG


def reduced(cfg: ModelConfig, d_model: int = 256, layers: int = 2) -> ModelConfig:
    """Reduced smoke-test variant of the same family (<=512 d_model, <=4
    experts), the reference's ``reduced`` field for field."""
    a = cfg.attention
    heads = max(2, min(4, a.num_heads))
    kv = max(1, min(heads, a.num_kv_heads if a.num_kv_heads < a.num_heads
                    else heads))
    while heads % kv:
        kv -= 1
    att = replace(a, num_heads=heads, num_kv_heads=kv,
                  head_dim=d_model // heads, window=min(a.window, 64))
    kw = dict(num_layers=layers, d_model=d_model, d_ff=2 * d_model,
              vocab_size=512, attention=att,
              num_image_tokens=min(cfg.num_image_tokens, 16),
              num_audio_frames=min(cfg.num_audio_frames, 16))
    if cfg.moe:
        kw["moe"] = replace(cfg.moe, num_experts=min(4, cfg.moe.num_experts))
    if cfg.ssm:
        kw["ssm"] = replace(cfg.ssm, state_dim=8)
    if cfg.rwkv:
        kw["rwkv"] = replace(cfg.rwkv, head_dim=d_model // heads,
                             decay_lora=16)
    if cfg.family == "hybrid":
        kw["attn_every"] = 2
    if cfg.family == "vlm":
        kw["cross_attn_every"] = 2
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
    return replace(cfg, **kw)


def long_context_capable(cfg: ModelConfig) -> bool:
    """True if the arch may run long_500k (sub-quadratic / bounded-cache
    attention)."""
    if cfg.family in ("ssm", "hybrid"):
        return True
    if cfg.family == "audio":
        return False
    return cfg.attention.pattern in ("swa", "local_global", "chunked")


def applicable_shapes(cfg: ModelConfig):
    return [s for s in INPUT_SHAPES.values()
            if s.name != "long_500k" or long_context_capable(cfg)]
