from repro_torch.configs.base import (
    MULTI_POD_MESH,
    SHAPES,
    SHAPES_BY_NAME,
    SINGLE_POD_MESH,
    Activation,
    ArchConfig,
    AttnImpl,
    BlockKind,
    EnokiConfig,
    MeshConfig,
    MoEConfig,
    ParallelConfig,
    ReplicationPolicy,
    SSMConfig,
    ShapeConfig,
    StepKind,
    TrainConfig,
    XLSTMConfig,
)
from repro_torch.configs.registry import (
    ARCH_IDS,
    cells,
    get_arch,
    get_shape,
    reduced,
    reduced_shape,
    shape_applicable,
)

__all__ = [
    "Activation", "ArchConfig", "AttnImpl", "BlockKind", "EnokiConfig",
    "MeshConfig", "MoEConfig", "MULTI_POD_MESH", "ParallelConfig",
    "ReplicationPolicy", "SHAPES", "SHAPES_BY_NAME", "SINGLE_POD_MESH",
    "SSMConfig", "ShapeConfig", "StepKind", "TrainConfig", "XLSTMConfig",
    "ARCH_IDS", "cells", "get_arch", "get_shape", "reduced", "reduced_shape",
    "shape_applicable",
]
