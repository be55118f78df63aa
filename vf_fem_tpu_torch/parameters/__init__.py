"""Parameter transforms (counterpart of ``vf_fem_tpu.parameters``)."""

from . import transform
from .transform import (
    ConstantSubset,
    ExtractSubset,
    FunctionTransform,
    Identity,
    LayerModuli,
    Scale,
    TractionShape,
    Transform,
    TransformComposition,
    TransformFromModel,
)

__all__ = [
    "transform",
    "ConstantSubset",
    "ExtractSubset",
    "FunctionTransform",
    "Identity",
    "LayerModuli",
    "Scale",
    "TractionShape",
    "Transform",
    "TransformComposition",
    "TransformFromModel",
]
