"""Configuration dataclasses of the port: the counterpart of
``repro.configs.base``.

Every architecture is an ``ArchConfig``, every input-shape cell a
``ShapeConfig``, and the paper's technique (Enoki state management) an
``EnokiConfig``, and the distribution and training setup ``MeshConfig``,
``ParallelConfig`` and ``TrainConfig``, field for field as in the
reference.  The values of every enum equal the reference's, which is how
tests map one onto the other.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class BlockKind(str, enum.Enum):
    """Kinds of residual blocks a layer stack can be built from."""

    ATTN = "attn"              # full (GQA/MQA/MHA) attention
    MOE = "moe"                # mixture-of-experts MLP
    MLP = "mlp"                # dense MLP (SwiGLU/GeGLU/GELU)
    MAMBA2 = "mamba2"          # SSD state-space block
    MLSTM = "mlstm"            # xLSTM matrix-memory block
    SLSTM = "slstm"            # xLSTM scalar-memory block (sequential)
    SHARED_ATTN = "shared_attn"  # zamba2-style weight-shared attention


class Activation(str, enum.Enum):
    SWIGLU = "swiglu"
    GEGLU = "geglu"
    GELU = "gelu"
    RELU = "relu"


class AttnImpl(str, enum.Enum):
    """Which attention implementation the model uses."""

    REFERENCE = "reference"    # kv-block online-softmax loop (plain torch)
    FLASH = "flash"            # the flash-attention kernel (plain version on the CPU)
    QSCAN = "qscan"            # q-block loop, full-row softmax (no carried acc)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int              # per-expert hidden dim
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    shared_expert: bool = False  # kimi-k2 has a shared expert alongside routed ones
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64        # N (per-head state size)
    conv_width: int = 4
    expand: int = 2            # d_inner = expand * d_model
    head_dim: int = 64         # Mamba2 head dim (d_inner / n_heads)
    chunk_size: int = 128      # SSD chunk length


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8       # 1-in-8 layers are sLSTM (7:1 per paper)
    num_heads: int = 4
    proj_factor_mlstm: float = 2.0   # mLSTM up-projection factor
    proj_factor_slstm: float = 1.333  # sLSTM ffn factor
    chunk_size: int = 64


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture.  Field values are the exact assigned numbers."""

    name: str
    family: str                # ssm | vlm | moe | hybrid | dense | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    activation: Activation = Activation.SWIGLU
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # zamba2: one shared attention block applied every `shared_attn_every` layers
    shared_attn_every: int = 0
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    # vlm / audio frontends are stubs: inputs arrive as precomputed embeddings
    frontend_stub: Optional[str] = None   # "clip_patches" | "audio_frames" | None
    num_patches: int = 0       # vlm: patch tokens prepended to text
    sliding_window: int = 0    # >0 enables sliding-window attention in long mode
    max_seq_len: int = 131_072

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    def param_count(self) -> int:
        """Analytic total parameter count (embedding + blocks + head)."""
        from repro_torch.models.model_zoo import analytic_param_count

        return analytic_param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model_zoo import analytic_param_count

        return analytic_param_count(self, active_only=True)


class StepKind(str, enum.Enum):
    TRAIN = "train"            # full fwd+bwd+optimizer step
    PREFILL = "prefill"        # forward over full sequence, builds KV cache
    DECODE = "decode"          # one new token against an existing KV cache


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    step: StepKind

    @property
    def is_serving(self) -> bool:
        return self.step is not StepKind.TRAIN


# The four assigned LM shapes (identical across archs).
SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", seq_len=4_096, global_batch=256, step=StepKind.TRAIN),
    ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, step=StepKind.PREFILL),
    ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, step=StepKind.DECODE),
    ShapeConfig("long_500k", seq_len=524_288, global_batch=1, step=StepKind.DECODE),
)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


class ReplicationPolicy(str, enum.Enum):
    """The three data placements evaluated in the paper (§4.3 / Fig 5)."""

    CLOUD_CENTRAL = "cloud_central"  # state on one node; every access remote
    PEER_FETCH = "peer_fetch"        # state on owner node; reads fetch on demand (SyncMesh)
    REPLICATED = "replicated"        # Enoki: local replica everywhere, async anti-entropy


@dataclasses.dataclass(frozen=True)
class EnokiConfig:
    """Paper-technique knobs, threaded through train/serve steps."""

    policy: ReplicationPolicy = ReplicationPolicy.REPLICATED
    replication_period: int = 8      # anti-entropy every R steps (staleness bound)
    compress_deltas: bool = False    # int8-quantise anti-entropy payloads
    outer_lr: float = 0.7            # DiLoCo outer Nesterov LR (training keygroups)
    outer_momentum: float = 0.9
    store_slots: int = 64            # KV arena capacity (keys per keygroup)
    value_bytes: int = 1024          # max value payload per slot (microbench arena)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def is_multi_pod(self) -> bool:
        return "pod" in self.axes


SINGLE_POD_MESH = MeshConfig(shape=(16, 16), axes=("data", "model"))
MULTI_POD_MESH = MeshConfig(shape=(2, 16, 16), axes=("pod", "data", "model"))


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How a given (arch, shape, mesh) cell is sharded.  On one card only
    ``remat`` and ``optimizer`` change what a train step does; the sharding
    fields are kept for the mesh slice."""

    fsdp: bool = False           # shard params over "data" (ZeRO-3 style)
    zero1: bool = True           # shard optimizer state over "data"
    seq_shard: bool = False      # shard sequence dim over "model" (prefill SP)
    remat: str = "none"          # none | block | full — activation checkpointing
    use_scan: bool = True        # scan over layers (keeps HLO small)
    optimizer: str = "adamw"     # adamw | adafactor
    moe_impl: str = "auto"       # auto (XLA propagation) | ep (shard_map)
    flash_decode: bool = False   # shard_map partial-softmax decode attention
    attn_impl: str = "reference"  # reference | qscan | flash


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    seed: int = 0
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
