"""Configuration dataclasses for models, shapes, meshes and runs.

Every assigned architecture is expressed as a ``ModelConfig``; the launcher
combines it with a ``ShapeConfig`` (one of the four assigned input shapes) and
a ``MeshConfig`` to produce a concrete job. ``RunConfig`` carries the
performance knobs that the Crispy HBM planner and the perf hillclimb iterate
over (remat policy, microbatching, sharding variants, attention impl).

The PyTorch package keeps its own copy of these dataclasses: field names and
defaults are the JAX package's, except ``RunConfig.attn_impl``, whose
hand-written-kernel setting is called ``"kernel"`` here and is the default.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    first_dense_layers: int = 0          # leading dense layers (deepseek-v3: 3)
    d_ff_dense: int = 0                  # ff dim of those dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2
    impl: str = "dense"                  # "dense" (GShard einsum) | "ep_tp" (expert//model psum)


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256                     # SSD chunk length
    n_groups: int = 1


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style shared transformer blocks interleaved with SSM blocks."""
    period: int = 6                      # shared attn applied every `period` SSM blocks
    n_shared_sets: int = 2               # alternating shared weight sets
    shared_d_ff: int = 0                 # ff of the shared block (0 -> model d_ff)


@dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder/decoder split. Frontend is a stub: input_specs()
    provides precomputed frame embeddings of shape (B, enc_len, d_model)."""
    n_encoder_layers: int = 12
    enc_len: int = 1500


@dataclass(frozen=True)
class CrossAttnConfig:
    """Llama-3.2-vision-style gated cross-attention layers. Frontend is a
    stub: input_specs() provides patch embeddings (B, n_media_tokens, d)."""
    period: int = 5                      # every `period`-th layer cross-attends
    n_media_tokens: int = 1601


# ---------------------------------------------------------------------------
# ModelConfig
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                          # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                      # 0 -> d_model // n_heads
    # attention
    attention_kind: str = "gqa"          # gqa | mla | none
    rope_kind: str = "full"              # full | partial | 2d | none
    rope_fraction: float = 1.0
    rope_theta: float = 10000.0
    # mlp
    mlp_kind: str = "swiglu"             # swiglu | relu2 | gelu
    # optional components
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    cross_attn: Optional[CrossAttnConfig] = None
    mtp_depth: int = 0                   # deepseek-v3 multi-token-prediction heads
    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int = 0              # 0 = disabled
    source: str = ""                     # provenance note "[arXiv:...; tier]"

    def __post_init__(self):
        if self.d_head == 0 and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    # -- derived ----------------------------------------------------------
    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (whisper is enc-dec)

    def param_count(self) -> int:
        """Analytic parameter count: shapes of the model's parameters on
        ``torch.device("meta")``, nothing allocated."""
        from repro_torch.models.model import analytic_param_count
        return analytic_param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import analytic_param_count
        return analytic_param_count(self, active_only=True)

    def reduced(self, **over) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests and Crispy profiling
        ladders: few layers, narrow width, small vocab — same code paths."""
        d_model = over.pop("d_model", 64)
        n_heads = max(2, min(self.n_heads, 4)) if self.n_heads else 0
        n_kv = max(1, min(self.n_kv_heads, 2)) if self.n_kv_heads else 0
        kw = dict(
            n_layers=over.pop("n_layers", 4 if self.hybrid is None else 4),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_head=d_model // n_heads if n_heads else 0,
            d_ff=over.pop("d_ff", 128),
            vocab_size=over.pop("vocab_size", 256),
        )
        if self.moe is not None:
            kw["moe"] = replace(
                self.moe, n_experts=over.pop("n_experts", 8), top_k=2,
                d_ff_expert=64, first_dense_layers=min(self.moe.first_dense_layers, 1),
                d_ff_dense=96)
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
            kw["d_head"] = 0
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=16, chunk=32)
        if self.hybrid is not None:
            kw["hybrid"] = replace(self.hybrid, period=2)
            kw["n_layers"] = 4
        if self.encdec is not None:
            kw["encdec"] = EncDecConfig(n_encoder_layers=2, enc_len=16)
        if self.cross_attn is not None:
            kw["cross_attn"] = CrossAttnConfig(period=2, n_media_tokens=16)
            kw["n_layers"] = 4
        if self.mtp_depth:
            kw["mtp_depth"] = 1
        kw.update(over)
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Shapes (assigned grid)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                            # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


# ---------------------------------------------------------------------------
# Mesh / run
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def dp(self) -> int:
        n = 1
        for ax, s in zip(self.axes, self.shape):
            if ax in ("pod", "data"):
                n *= s
        return n

    @property
    def tp(self) -> int:
        for ax, s in zip(self.axes, self.shape):
            if ax == "model":
                return s
        return 1


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))


@dataclass(frozen=True)
class RunConfig:
    """Performance/distribution knobs — the hillclimb surface."""
    microbatches: int = 1                # gradient accumulation steps
    remat: str = "boundaries"            # nothing | dots | boundaries
    zero1: bool = True                   # shard optimizer state over data axis
    param_dtype: str = "float32"         # master/param storage dtype
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"        # adam m/v storage (bf16 = compressed)
    attn_impl: str = "kernel"            # kernel | full | blocked | zigzag
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    seq_shard: bool = False              # sequence parallelism for prefill
    fsdp_experts: bool = False           # 2D-shard expert weights over data axis
    fsdp_params: bool = False            # FSDP dense weights over data axis
    scan_layers: bool = True
    donate: bool = True
    grad_compression: bool = False       # bf16 all-reduce w/ error feedback
    accum_dtype: str = "float32"         # microbatch gradient accumulator
    kv_cache_dtype: str = "compute"      # "compute" | "int8" (quantized KV)

    def with_(self, **kw) -> "RunConfig":
        return replace(self, **kw)


def cell_id(arch: str, shape: str) -> str:
    return f"{arch}:{shape}"
