"""Configurations of the port (port of ``repro/configs/base.py``).

Two families, as in the reference:

* ``ModelConfig`` (with ``MoEConfig``, ``SSMConfig``) — the ten LM
  architectures; one module per arch under ``repro_torch.configs`` exposes
  ``config()`` (full size) and ``reduced()`` (CPU smoke), looked up by
  ``registry.get_config`` / ``get_reduced``.  The port runs the ``dense``
  family; the others are data only until their model code is ported
  (ROADMAP Queue 1 item 17).
* ``HGNNConfig`` — the paper's HGNN workloads.

Field names, defaults and ``__post_init__`` equal the reference's, so one
set of keyword arguments builds the same model in both packages (a test
holds them equal).  ``use_pallas`` keeps its name and means "run the
hand-written kernels": the Hopper CUDA kernels of ``repro_torch/kernels``
in place of the TPU's Pallas kernels.  The knobs of the reference's mesh
(``pad_heads_to_mesh``, ``fsdp``, ``seq_shard_activations``, ...) are kept
as fields; on one device only ``pad_heads_to_mesh`` changes what is
computed (zero-padded heads).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# LM architecture configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block config (not run by the port yet)."""

    n_experts: int
    top_k: int
    d_ff_expert: int
    # Arctic runs a dense FFN *in parallel* with the MoE FFN ("dense residual").
    dense_residual_ff: int = 0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block config (not run by the port yet)."""

    d_state: int
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256  # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # Sliding-window attention width; 0 = full causal attention.
    sliding_window: int = 0
    # Encoder-decoder (seamless-m4t): n_layers applies to each side.
    enc_layers: int = 0
    dec_layers: int = 0
    # Modality frontend stub: number of precomputed embeddings prepended.
    frontend: Optional[str] = None  # vision | audio
    n_frontend_embeds: int = 0
    # zamba2: one shared attention block applied every `shared_attn_period`
    # Mamba2 layers.
    shared_attn_period: int = 0
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # Optimizer / memory knobs of training (not ported yet).
    optimizer: str = "adamw"  # adamw | adafactor
    opt_state_dtype: str = "float32"
    remat: str = "full"  # none | dots | full
    # q/kv-chunk length of the plain chunked (online-softmax) attention.
    attn_chunk: int = 512
    # Hand-written kernels (flash_attention, decode_attention) in place of
    # the plain attention; the name is the reference's.
    use_pallas: bool = False
    # Pad attention heads up to a multiple of 16 (zero-initialized slices),
    # as the reference does for its 16-way model axis.
    pad_heads_to_mesh: bool = False
    # Mesh knobs of the reference; no-ops on one device.
    decode_kv_shard_seq: bool = True
    fsdp: bool = True
    fsdp_experts: bool = True
    seq_shard_activations: bool = True
    n_microbatches: int = 1

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# Archs for which long_500k is runnable (sub-quadratic decode path).
LONG_CONTEXT_ARCHS = ("mamba2-2.7b", "zamba2-1.2b", "h2o-danube-3-4b")


def long_context_supported(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid") or cfg.sliding_window > 0


# ---------------------------------------------------------------------------
# HGNN configs (the paper's workloads)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HGNNConfig:
    model: str = "han"  # rgcn | han | magnn | gcn
    dataset: str = "imdb"  # imdb | acm | dblp | reddit
    hidden: int = 64
    n_classes: int = 8
    n_heads: int = 8  # GAT heads in Neighbor Aggregation
    attn_hidden: int = 128  # semantic-attention hidden dim
    max_degree: int = 64  # padded-neighbor cap (dense [N, K] layout)
    max_instances: int = 16  # MAGNN instances sampled per target node
    # Optimized execution path: stacked subgraphs (inter-subgraph
    # parallelism), concat-free SA, optionally the hand-written kernels.
    fused: bool = False
    # Hand-written kernels (Hopper CUDA) on the hot loop; the name is the
    # reference's, where it selects the Pallas kernels.
    use_pallas: bool = False
    # Degree-bucketed padded NA layout (>1); ported for RGCN, not for HAN.
    degree_buckets: int = 0
    # Fused NA→SA epilogue: the semantic-score pass-1 partial accumulates
    # inside the NA kernel, saving one full [P, N, D] read.  Stacked only.
    fuse_na_sa: bool = False
    # Graph-partitioned execution (>= 1); not ported yet.
    partitions: int = 0
    # Stacked FP->NA->SA layers; the graph-side index tables are built once.
    layers: int = 1
    # Request-path sampled serving (>= 1); not ported yet.
    fanout: int = 0
    sample_ladder: Tuple[Tuple[int, int], ...] = ()
    # Hot-feature residency (>= 1): hot rows kept per node type (one
    # device; the partitioned and serving parts are not ported yet).
    cache_rows: int = 0
    # Async stage-graph schedule (>= 1); not ported yet.
    overlap: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.layers < 1:
            raise ValueError(
                f"HGNNConfig.layers must be >= 1 (got {self.layers})")

    def replace(self, **kw) -> "HGNNConfig":
        return dataclasses.replace(self, **kw)
