"""Model configuration + layer-pattern machinery.

Every assigned architecture is expressed as a ``ModelConfig`` whose
``pattern`` is the repeating unit of layer kinds (e.g. gemma3's
5 local + 1 global attention).  The transformer stacks each pattern
position's parameters over units and loops over the units, plus an
unrolled remainder when ``n_layers % len(pattern) != 0``.  A copy of the
JAX package's framework-free module.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

__all__ = ["MoEConfig", "EncoderConfig", "ModelConfig", "LayerKind"]

# layer kinds understood by transformer.py
LayerKind = str  # "attn" | "attn_local" | "cross_attn" | "rglru" | "mlstm" | "slstm"


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    dense_residual: bool = False      # arctic: dense MLP in parallel w/ MoE
    dense_d_ff: int = 0               # width of the dense residual branch


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder (conv frontend stubbed to precomputed frames)."""
    n_layers: int
    n_frames: int = 1500              # post-conv frame count at train shape
    dec_len: int = 512                # decoder tokens at train shape


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|hybrid|ssm|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 => d_model // n_heads
    # attention variants
    qk_norm: bool = False             # qwen3
    qkv_bias: bool = False            # qwen1.5
    rope_theta: float = 10_000.0
    sliding_window: int = 0           # 0 = full attention (for *_local kinds)
    pattern: tuple[LayerKind, ...] = ("attn",)
    # moe / vlm / audio extras
    moe: MoEConfig | None = None
    n_image_tokens: int = 576         # vlm stub frontend output length
    encoder: EncoderConfig | None = None
    # hybrid/ssm extras
    rglru_width: int = 0              # recurrence width (0 => d_model)
    conv1d_width: int = 4
    # embedding/misc
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"                 # mlp activation: silu (swiglu) | gelu
    # training-time memory knobs (per-arch defaults; launcher may override)
    remat: bool = True
    optimizer: str = "adamw"          # "adafactor" for the very largest
    opt_state_dtype: str = "float32"  # "bfloat16" for the very large models
    logits_softcap: float = 0.0
    # scan over pattern units (flat HLO; production default).  The dry-run
    # sets False for its roofline pass: XLA's analytical cost model counts
    # while-loop bodies ONCE, so exact FLOP/byte/collective accounting
    # needs the layers unrolled (EXPERIMENTS.md §Method).
    scan_layers: bool = True
    # -- beyond-paper performance levers (EXPERIMENTS.md §Perf) -------------
    # shard attention scores over the query-sequence dim instead of heads
    # (wins when n_kv_heads < TP size: kills the replicated S x S scores)
    seq_parallel_attn: bool = False
    # block-banded computation for sliding-window layers: only the
    # in-window (2W per query) score band is computed/materialized
    banded_local_attn: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_rep(self) -> int:
        return self.n_heads // self.n_kv_heads

    def layer_kinds(self) -> list[LayerKind]:
        """Expanded per-layer kind list of length n_layers."""
        unit = list(self.pattern)
        kinds = (unit * ((self.n_layers + len(unit) - 1) // len(unit)))
        return kinds[: self.n_layers]

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def n_remainder(self) -> int:
        return self.n_layers % len(self.pattern)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # -- parameter count (for 6ND roofline MODEL_FLOPS) ----------------------
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.hd
        nq, nkv = self.n_heads, self.n_kv_heads
        n = 0
        kinds = self.layer_kinds()
        for kind in kinds:
            if kind in ("attn", "attn_local", "cross_attn"):
                n += d * nq * hd + 2 * d * nkv * hd + nq * hd * d  # qkvo
                if self.qkv_bias:
                    n += (nq + 2 * nkv) * hd
                n += 2 * d  # norms
            if kind in ("attn", "attn_local", "cross_attn", "mlstm", "slstm"):
                pass
            if kind == "rglru":
                w = self.rglru_width or d
                n += 2 * d * w + w * d + 3 * w  # in/gate proj, out proj, gates
                n += 2 * d
            if kind in ("mlstm", "slstm"):
                w = self.d_model
                n += 4 * d * w + w * d  # qkv+gates projections (approx exact below)
                n += 2 * d
            # mlp / moe attached to every unit layer except pure-recurrent xlstm
            if kind in ("attn", "attn_local", "cross_attn"):
                if self.moe is not None:
                    if active_only:
                        n += self.moe.top_k * 3 * d * self.d_ff
                    else:
                        n += self.moe.n_experts * 3 * d * self.d_ff
                    n += d * self.moe.n_experts  # router
                    if self.moe.dense_residual:
                        n += 3 * d * self.moe.dense_d_ff
                elif self.d_ff:
                    nmul = 3 if self.act == "silu" else 2
                    n += nmul * d * self.d_ff
        n += self.vocab * d  # embeddings (tied)
        if not self.tie_embeddings:
            n += self.vocab * d
        if self.encoder is not None:
            enc = self.encoder
            per = (d * nq * hd + 2 * d * nkv * hd + nq * hd * d + 2 * d * self.d_ff
                   + 2 * d)
            # decoder cross-attn blocks add another attention per layer
            n += enc.n_layers * per
            n += len(kinds) * (d * nq * hd + 2 * d * nkv * hd + nq * hd * d)
        return n
