"""Config system (own copy of ``repro.configs.base``): the model and
federation configurations.

The dense family and RWKV6 (family ``"ssm"``) are ported so far.
``get_config(name)`` resolves an arch id like ``"smollm-135m"`` or
``"rwkv6-3b"``; the reference's other ids raise ``NotImplementedError``
until the rest of the model zoo is ported (ROADMAP Queue 1 item 7).
``reduced(cfg)`` produces the CPU-smoke variant of the same family
(2 layers, d_model <= 512), as in the reference.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace
from typing import Optional

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


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
    """The dense and RWKV fields of the reference ``ModelConfig`` (the
    MoE / Mamba / VLM / audio fields wait for the model zoo)."""

    name: str = "model"
    # family: 'dense' | 'ssm' (rwkv6); the reference's others are not ported
    family: str = "dense"
    num_layers: int = 4
    d_model: int = 256
    d_ff: int = 1024
    vocab_size: int = 32000
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    rwkv: Optional[RWKVConfig] = None
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
        ffn = (3 if self.gated_mlp else 2) * d * f
        if self.layer_kind(0) == "rwkv":
            # r, k, v, g, o time-mix projections, the decay LoRA, and the
            # channel mix's r, k, v (the reference's count: the mixes,
            # decay base, bonus and ln_x vectors are left out)
            layer = (2 * d + 5 * d * d
                     + 2 * d * (self.rwkv.decay_lora if self.rwkv else 64)
                     + d * d + 2 * d * f)
        else:
            layer = 2 * d + attn + ffn
        total = self.num_layers * layer + v * d + d
        if not self.tie_embeddings:
            total += v * d
        return total

    def layer_kind(self, i: int) -> str:
        """'rwkv' or 'attn' for layer i (the reference's other kinds
        belong to families not ported)."""
        return "rwkv" if self.family == "ssm" else "attn"


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

# the arch ids whose config module is ported
PORTED = ("smollm-135m", "rwkv6-3b")


def get_config(name: str) -> ModelConfig:
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCH_IDS)}")
    if name not in PORTED:
        raise NotImplementedError(
            f"{name!r} is not ported yet (ROADMAP Queue 1 item 7: the model "
            f"zoo); ported: {PORTED}")
    module = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{module}").CONFIG


def reduced(cfg: ModelConfig, d_model: int = 256, layers: int = 2) -> ModelConfig:
    """Reduced smoke-test variant of the same family: the reference's
    ``reduced`` for the dense and RWKV fields (<= 4 heads, d_ff =
    2 d_model, vocab 512, window <= 64; RWKV head_dim d_model / heads,
    decay LoRA 16)."""
    a = cfg.attention
    heads = max(2, min(4, a.num_heads))
    kv = max(1, min(heads, a.num_kv_heads if a.num_kv_heads < a.num_heads
                    else heads))
    while heads % kv:
        kv -= 1
    att = replace(a, num_heads=heads, num_kv_heads=kv,
                  head_dim=d_model // heads, window=min(a.window, 64))
    kw = {}
    if cfg.rwkv:
        kw["rwkv"] = replace(cfg.rwkv, head_dim=d_model // heads,
                             decay_lora=16)
    return replace(cfg, num_layers=layers, d_model=d_model,
                   d_ff=2 * d_model, vocab_size=512, attention=att, **kw)
