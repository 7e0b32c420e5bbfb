"""Model configuration system: one dataclass covers all 10 assigned
architecture families (dense / GQA / MoE / SSM / hybrid), plus the input
shape sets used by the dry-run and benchmarks."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List

_REGISTRY: Dict[str, "ModelConfig"] = {}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    d_ff: int = 0
    # gemma2-style alternating local/global attention
    local_window: int = 0        # 0 = all-global
    alt_local_global: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0            # per-expert FFN width
    # SSM (mamba)
    ssm_version: int = 0         # 1 | 2
    d_state: int = 0
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64           # mamba2 head dim
    # hybrid (zamba2): shared attention block every k mamba layers
    shared_attn_every: int = 0
    # modality frontend stub: inputs are precomputed embeddings
    embed_inputs: bool = False
    # norm eps
    eps: float = 1e-6
    # MoE expert-capacity factor (C = ceil(S*K/E * cf)); E/K => no drops
    moe_capacity_factor: float = 1.25
    # notes / provenance
    source: str = ""

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(self.d_model // 16, 1)

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.head_dim

    def n_params(self) -> int:
        """Approximate parameter count (used for MODEL_FLOPS roofline)."""
        d, L = self.d_model, self.n_layers
        p = self.vocab * d  # embedding (tied head assumed separate: x2 below)
        p += self.vocab * d  # lm head
        if self.family in ("dense", "moe"):
            attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads \
                * self.d_head + self.n_heads * self.d_head * d
            if self.family == "dense":
                ffn = 3 * d * self.d_ff
            else:
                ffn = 3 * d * self.d_expert * (self.n_experts
                                               + self.n_shared_experts) \
                    + d * self.n_experts
            p += L * (attn + ffn)
        elif self.family == "ssm":
            di, dn, dtr = self.d_inner, self.d_state, self.dt_rank
            per = 2 * d * di + di * self.d_conv + di * (dtr + 2 * dn) \
                + dtr * di + di * dn + di + di * d
            p += L * per
        elif self.family == "hybrid":
            di, dn = self.d_inner, self.d_state
            nh = self.n_ssm_heads
            per = 2 * d * di + di * self.d_conv + di * 2 * dn + 2 * nh \
                + di * d
            p += L * per
            attn = d * self.n_heads * self.d_head * 2 \
                + 2 * d * self.n_kv_heads * self.d_head + 3 * d * self.d_ff
            p += attn  # one shared block
        return int(p)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed top-k + shared)."""
        if self.family != "moe":
            return self.n_params()
        d, L = self.d_model, self.n_layers
        p = 2 * self.vocab * d
        attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads \
            * self.d_head + self.n_heads * self.d_head * d
        ffn = 3 * d * self.d_expert * (self.top_k + self.n_shared_experts) \
            + d * self.n_experts
        return int(p + L * (attn + ffn))


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Archs able to lower long_500k (sub-quadratic / O(1)-state decode).
LONG_CONTEXT_OK = ("zamba2-2.7b", "falcon-mamba-7b")


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # import all config modules lazily
        from . import all_configs  # noqa: F401
    return _REGISTRY[name]


def list_configs() -> List[str]:
    from . import all_configs  # noqa: F401
    return sorted(_REGISTRY)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.shared_attn_every == 0
                     else 2 * max(cfg.shared_attn_every, 1)),
        d_model=128,
        vocab=256,
        d_ff=256 if cfg.d_ff else 0,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_head=32 if cfg.n_heads else 0,
        n_experts=8 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        n_shared_experts=cfg.n_shared_experts,
        d_expert=64 if cfg.d_expert else 0,
        d_state=min(cfg.d_state, 16) if cfg.d_state else 0,
        head_dim=32 if cfg.family == "hybrid" else cfg.head_dim,
        local_window=min(cfg.local_window, 64) if cfg.local_window else 0,
        name=cfg.name + "-smoke",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
