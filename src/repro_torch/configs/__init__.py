from repro_torch.configs.base import (
    Activation,
    ArchConfig,
    AttnImpl,
    EnokiConfig,
    MoEConfig,
    ReplicationPolicy,
    SHAPES,
    SHAPES_BY_NAME,
    SSMConfig,
    ShapeConfig,
    StepKind,
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
    "Activation", "ArchConfig", "AttnImpl", "EnokiConfig", "MoEConfig",
    "ReplicationPolicy", "SHAPES", "SHAPES_BY_NAME", "SSMConfig",
    "ShapeConfig", "StepKind", "XLSTMConfig",
    "ARCH_IDS", "cells", "get_arch", "get_shape", "reduced", "reduced_shape",
    "shape_applicable",
]
