"""Configuration for the port (dense decoder and SSM fields).

A copy of the parts of ``repro/config.py`` the ported slices read: the
frozen :class:`ModelConfig` with ``padded_vocab``/``resolved_head_dim``/
``scaled``, :class:`SSMConfig` (the Mamba2 mixer), :class:`MLAConfig`
(multi-head latent attention), the arch registry, and
the fields of :class:`ParallelConfig`, :class:`GuardConfig` and
:class:`RunConfig` that the training steps read (one device and the
hecaton grid), with the JAX package's defaults, and
:class:`CheckpointConfig` whole.  MoE/hybrid/enc-dec fields arrive
with the slices that use them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek/MiniCPM3 style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) mixer hyper-parameters."""
    state_dim: int = 128        # N (ssm_state)
    head_dim: int = 64          # P
    expand: int = 2             # d_inner = expand * d_model
    n_groups: int = 1           # B/C groups
    conv_kernel: int = 4
    chunk_size: int = 128       # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads
    mlp_kind: str = "swiglu"                # swiglu | relu2 | gelu | geglu
    norm_kind: str = "rmsnorm"              # rmsnorm | layernorm
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    embed_dropout: float = 0.0              # train mode only
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (as the JAX package pads)."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)


OVERLAP_MODES = ("none", "ring", "bidir", "fused")
COMM_DTYPES = ("bf16", "int8")
STRATEGIES = ("hecaton", "megatron")
RESIDUAL_LAYOUTS = ("seq", "replicated")
POD_ROLES = ("data", "pipeline")


@dataclass(frozen=True)
class ParallelConfig:
    """The fields of ``repro.config.ParallelConfig`` that the ported steps
    read: the strategy over the grid (data x mx x my; one device when all
    are 1): hecaton's 2D tiling, or the megatron baseline's 1D ``model``
    axis of mx * my ranks with its residual layout; the overlap mode and
    wire dtype, and the step's microbatching, gradient rounding, remat and
    fused loss, and the pod axis (``pods``, ``pod_axis_role``: more data
    parallelism, or the 1F1B pipeline).  The grid step always keeps its
    AdamW moments ZeRO-1 sharded over the data axes and solves the
    attention layout as the JAX package's "auto".  ``strategy``, ``overlap``, ``comm_dtype``,
    ``residual``, ``pods``, ``pod_axis_role`` and ``microbatches`` are
    validated as the JAX package validates them: a typo raises."""
    strategy: str = "hecaton"               # hecaton | megatron
    data: int = 1
    mx: int = 1
    my: int = 1
    overlap: str = "none"                   # none | ring | bidir | fused
    comm_dtype: str = "bf16"                # bf16 | int8 (the ring hops' wire)
    microbatches: int = 1
    # per-microbatch gradient rounding before the fp32 sum: fp32 | bf16
    grad_reduce_dtype: str = "bf16"
    remat: str = "fusion"                   # none | fusion | full
    fused_loss: bool = True                 # fp32 head logits -> lse - gold
    # megatron's residual stream between blocks: "seq" (tokens sharded over
    # the model axis, Korthikanti sequence parallel) or "replicated" (the
    # classic 1D layout); hecaton's tiling is token-sharded either way, and a
    # sequence the model ring cannot divide runs "replicated"
    residual: str = "seq"
    # the pod axis in front of the grid (pods > 1): "pipeline" runs one
    # contiguous stage of the block stack per pod under a 1F1B schedule
    # (parallel/pipeline.py); "data", the JAX package's default, makes the
    # pods more data parallelism (the batch over ("pod", "data")), which the
    # launcher runs as a data axis of pods * data ranks (train._grid_shape)
    pods: int = 1
    pod_axis_role: str = "data"             # data | pipeline

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"strategy={self.strategy!r} not in {STRATEGIES}")
        if self.residual not in RESIDUAL_LAYOUTS:
            raise ValueError(f"residual={self.residual!r} not in {RESIDUAL_LAYOUTS}")
        if self.overlap not in OVERLAP_MODES:
            raise ValueError(f"overlap={self.overlap!r} not in {OVERLAP_MODES}")
        if self.comm_dtype not in COMM_DTYPES:
            raise ValueError(f"comm_dtype={self.comm_dtype!r} not in {COMM_DTYPES}")
        if self.pod_axis_role not in POD_ROLES:
            raise ValueError(f"pod_axis_role={self.pod_axis_role!r} not in {POD_ROLES}")
        if self.pods < 1:
            raise ValueError(f"pods={self.pods} must be >= 1")
        if self.microbatches < 1:
            raise ValueError(f"microbatches={self.microbatches} must be >= 1")
        if self.pod_axis_role == "pipeline" and self.pods < 2:
            raise ValueError("pod_axis_role='pipeline' requires pods > 1 "
                             f"(got pods={self.pods}); use pod_axis_role='data' for "
                             "single-pod meshes")

    @property
    def pipeline_enabled(self) -> bool:
        """True when the pod axis runs 1F1B stages (``parallel/pipeline.py``)."""
        return self.pod_axis_role == "pipeline" and self.pods > 1

    @property
    def pipeline_stages(self) -> int:
        return self.pods if self.pipeline_enabled else 1

    def with_(self, **overrides) -> "ParallelConfig":
        return dataclasses.replace(self, **overrides)


@dataclass(frozen=True)
class GuardConfig:
    """``repro.config.GuardConfig``: the in-graph skip-update guard reads
    ``grad_spike_factor``/``grad_ewma_alpha``; the loop-side
    ``runtime/guard.TrainingGuard`` the loss fields, ``patience`` and
    ``skip_cap``; ``hang_timeout`` arms the ``Watchdog`` (0: off);
    ``rollback`` is the supervisor's retire-and-blocklist policy."""
    grad_spike_factor: float = 10.0   # skip when gnorm > f * EWMA
    grad_ewma_alpha: float = 0.1      # EWMA decay for accepted grad norms
    loss_spike_factor: float = 2.0
    loss_ewma_alpha: float = 0.1
    patience: int = 3
    skip_cap: int = 3
    hang_timeout: float = 0.0
    rollback: bool = True

    def __post_init__(self):
        assert self.grad_spike_factor > 1.0, self.grad_spike_factor
        assert 0.0 < self.grad_ewma_alpha <= 1.0, self.grad_ewma_alpha
        assert self.loss_spike_factor > 1.0, self.loss_spike_factor
        assert 0.0 < self.loss_ewma_alpha <= 1.0, self.loss_ewma_alpha
        assert self.patience >= 1 and self.skip_cap >= 1
        assert self.hang_timeout >= 0.0


@dataclass(frozen=True)
class CheckpointConfig:
    """``repro.config.CheckpointConfig``: the persistence policy of the
    training loop (``checkpoint/manager.py``), every field and check.

    ``async_`` selects the AsyncCheckpointManager: the step boundary only
    snapshots the state into a reusable host staging arena and a
    background thread writes and publishes it; ``staging="sync"`` makes
    that manager block instead.  ``max_inflight`` bounds the arena's
    slots (acquiring one blocks while that many snapshots are unwritten).
    ``writers`` logical writers persist disjoint shard sets with a crc32
    per shard, and a step publishes only once ``quorum`` partial
    manifests verified (None: all) and every shard is covered.
    ``verify`` re-checks every shard's length and crc32 on restore.
    ``writer_procs`` runs each writer as an OS process
    (``runtime/procs.py``) with a ``writer_timeout`` heartbeat lease and
    ``reassign`` orphan-range reassignments per save."""
    every: int = 50                  # save cadence in steps
    keep: int = 3                    # published checkpoints retained by GC
    async_: bool = True              # background writer vs blocking save
    staging: str = "host"            # "host" (staged async) | "sync"
    max_inflight: int = 2            # double-buffered staging arena slots
    durable: bool = False            # fsync data + dirs around the publish
    writers: int = 1                 # logical writer-group size
    quorum: Optional[int] = None     # partial manifests required (None: all)
    verify: bool = True              # checksum-verify shards on restore
    writer_procs: bool = False       # writers as OS processes (fleet)
    writer_timeout: float = 5.0      # heartbeat-lease deadline, seconds
    reassign: int = 1                # orphan-range reassignments per save

    def __post_init__(self):
        assert self.every >= 1, f"ckpt every={self.every} must be >= 1"
        assert self.keep >= 1, f"ckpt keep={self.keep} must be >= 1"
        assert self.max_inflight >= 1, self.max_inflight
        assert self.staging in ("host", "sync"), (
            f"staging={self.staging!r} not in ('host', 'sync')")
        assert self.writers >= 1, f"writers={self.writers} must be >= 1"
        if self.quorum is not None:
            assert 1 <= self.quorum <= self.writers, (
                f"quorum={self.quorum} must be in [1, writers={self.writers}]")
        assert self.writer_timeout > 0, (
            f"writer_timeout={self.writer_timeout} must be > 0")
        assert self.reassign >= 0, f"reassign={self.reassign} must be >= 0"


@dataclass(frozen=True)
class RunConfig:
    """``repro.config.RunConfig``: the run's shape and the optimizer."""
    shape_name: str
    mode: str                        # train | prefill | decode
    seq_len: int
    global_batch: int
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100


_REGISTRY: Dict[str, ModelConfig] = {}
_SMOKE_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    _SMOKE_REGISTRY[cfg.name] = smoke
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ModelConfig:
    _ensure_loaded()
    return _SMOKE_REGISTRY[name]


def _ensure_loaded():
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401  (registers everything)
