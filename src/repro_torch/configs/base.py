"""Architecture configuration system (PyTorch port).

A copy of ``repro.configs.base``: every architecture is a frozen
dataclass registered in ``ARCH_REGISTRY`` under its public id
(``--arch <id>``). Configs are pure data — models consume them, the
launcher looks them up, and tests call ``.reduced()`` for a CPU-sized
variant of the same family. The port keeps its own copy so that it never
imports the JAX package; field names, defaults and ``reduced()`` are
identical, which is what lets a test build the same model on both sides.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

# block kinds of the layer-stack pattern
ATTN = "attn"          # attention + dense MLP block
MOE = "moe"            # attention + MoE block
SSM = "ssm"            # Mamba2 block (attention-free)
HYBRID_ATTN = "hattn"  # attention block inside an SSM stack (Zamba2)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    experts_per_token: int          # top-k
    d_ff_expert: int
    capacity_factor: float = 1.25
    shared_expert: bool = False     # llama4-style shared expert
    dense_residual: bool = False    # arctic-style parallel dense FFN
    router_aux_weight: float = 0.01
    impl: str = "einsum"            # einsum (GShard) | sort


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | vlm | audio | cnn
    n_layers: int
    d_model: int
    n_heads: int                    # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int                       # dense MLP hidden (0 if none)
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    citation: str = ""

    # attention details
    qk_norm: bool = False
    attn_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    sliding_window: int = 0         # 0 = full attention
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    mlp_act: str = "silu"           # silu (SwiGLU) | gelu (plain MLP)

    # mixture-of-experts / ssm sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_period: int = 0     # zamba2: every Nth block is shared attention

    # encoder-decoder (whisper backbone)
    enc_dec: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0            # fixed encoder length (audio frames)

    # modality frontend stubs
    frontend: str = "none"          # none | vision | audio
    n_prefix_tokens: int = 0        # vision patches prepended to text

    # numerics
    param_dtype: str = "bfloat16"
    activ_dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def supports_long_decode(self) -> bool:
        """True if a 500k-token decode is representable (sub-quadratic
        state): SSM/hybrid natively, attention archs through the
        sliding-window variant; the enc-dec audio backbone has no
        long-decode analogue."""
        return not self.enc_dec

    def block_pattern(self) -> Tuple[str, ...]:
        """Per-layer block kinds, length == n_layers (decoder stack)."""
        if self.arch_type == "moe":
            return (MOE,) * self.n_layers
        if self.arch_type == "ssm":
            return (SSM,) * self.n_layers
        if self.arch_type == "hybrid":
            p = self.hybrid_attn_period
            return tuple(HYBRID_ATTN if i % p == p - 1 else SSM
                         for i in range(self.n_layers))
        return (ATTN,) * self.n_layers

    def n_params(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, hd = self.d_model, self.head_dim
        total = self.vocab_size * d + d                   # embed + final norm
        if not self.tie_embeddings:
            total += self.vocab_size * d                  # lm head

        def attn_params() -> int:
            n = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
            n += self.n_heads * hd * d + 2 * d            # out proj, pre norms
            if self.qk_norm:
                n += 2 * hd
            return n

        def mlp_params(ff: int) -> int:
            return (3 if self.mlp_act == "silu" else 2) * d * ff

        def ssm_params() -> int:
            s = self.ssm
            di, nh, g = s.d_inner(d), s.n_heads(d), s.n_groups
            n = d * (2 * di + 2 * g * s.d_state + nh)     # in_proj
            n += s.d_conv * (di + 2 * g * s.d_state)      # conv
            n += 3 * nh                                   # A_log, D, dt_bias
            n += di * d + d + di                          # out_proj, norms
            return n

        for kind in self.block_pattern():
            if kind in (ATTN, HYBRID_ATTN):
                total += attn_params() + mlp_params(self.d_ff)
            elif kind == MOE:
                m = self.moe
                total += attn_params() + d * m.n_experts  # + router
                total += m.n_experts * 3 * d * m.d_ff_expert
                if m.shared_expert:
                    total += 3 * d * m.d_ff_expert
                if m.dense_residual:
                    total += mlp_params(self.d_ff)
            else:
                total += ssm_params()
        if self.enc_dec:
            # encoder blocks, a cross-attention per decoder block, and
            # the encoder's position table
            total += self.n_encoder_layers * (attn_params()
                                              + mlp_params(self.d_ff))
            total += self.n_layers * attn_params() + self.encoder_seq * d
        return total

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE top-k instead of all experts)."""
        if self.moe is None:
            return self.n_params()
        per = 3 * self.d_model * self.moe.d_ff_expert
        idle = (self.moe.n_experts - self.moe.experts_per_token) * per
        return self.n_params() - self.n_layers * idle

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """CPU-sized smoke variant of the same family (<=512 d_model etc.)."""
        changes: Dict = dict(
            n_layers=2,
            d_model=min(self.d_model, 128),
            vocab_size=min(self.vocab_size, 512),
            param_dtype="float32",
            activ_dtype="float32",
        )
        if self.n_heads:
            hd = 32
            nh = max(2, min(4, self.n_heads))
            nkv = 1 if self.n_kv_heads < self.n_heads else nh
            changes.update(n_heads=nh, n_kv_heads=nkv, head_dim=hd)
        if self.d_ff:
            changes["d_ff"] = 256
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=min(4, self.moe.n_experts),
                experts_per_token=min(2, self.moe.experts_per_token),
                d_ff_expert=128, capacity_factor=4.0)
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=32, chunk=16)
        if self.hybrid_attn_period:
            changes["hybrid_attn_period"] = 2
            changes["n_layers"] = 4
        if self.enc_dec:
            changes.update(n_encoder_layers=2, encoder_seq=16)
        if self.n_prefix_tokens:
            changes["n_prefix_tokens"] = 4
        if self.sliding_window:
            changes["sliding_window"] = 16
        return dataclasses.replace(self, **changes)

    def with_sliding_window(self, window: int) -> "ArchConfig":
        return dataclasses.replace(self, sliding_window=window)


# ---------------------------------------------------------------------------
ARCH_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        ARCH_REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ArchConfig:
    if name not in ARCH_REGISTRY:
        # import side-effect registration
        from repro_torch.configs import all_configs  # noqa: F401
    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]()


def list_archs() -> Sequence[str]:
    from repro_torch.configs import all_configs  # noqa: F401
    return sorted(ARCH_REGISTRY)
