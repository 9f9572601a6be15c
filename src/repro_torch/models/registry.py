"""Model registry: construction behind the ``registry`` model names.

``parse_model`` turns a spec string into a :class:`ModelSpec` — one
architecture (``"cnn"``) or a "+"-joined cohort (``"cnn+mlp"``) whose
parts go to devices round-robin (:meth:`ModelSpec.partition`).  The
FIRST part is the global (server-side) architecture.
"""
from __future__ import annotations

import dataclasses

from ..registry import MODELS, canonical_model
from .cnn import CNN
from .mlp import MLPClassifier
from .transformer import TransformerClassifier


def build_model(name: str, input_shape, num_classes: int):
    """Construct one registered classifier for a task geometry."""
    name = canonical_model(name)
    if name == "cnn":
        return CNN(num_classes, tuple(input_shape))
    if name == "mlp":
        return MLPClassifier(num_classes, tuple(input_shape))
    return TransformerClassifier(num_classes, tuple(input_shape))


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A parsed model spec: one or more canonical architecture names;
    ``parts[0]`` is the global/server architecture."""
    parts: tuple

    @property
    def name(self) -> str:
        return "+".join(self.parts)

    @property
    def mixed(self) -> bool:
        return len(self.parts) > 1

    def partition(self, num_devices: int) -> tuple:
        """Per-device architecture names, cycling through ``parts``."""
        return tuple(self.parts[d % len(self.parts)]
                     for d in range(num_devices))

    def build(self, input_shape, num_classes: int):
        """Construct the global (server-side) architecture."""
        return build_model(self.parts[0], input_shape, num_classes)


def parse_model(spec) -> ModelSpec:
    """Parse ``"cnn"`` or ``"cnn+mlp"`` into a :class:`ModelSpec`; each
    atom resolves through ``canonical_model``.  A composite of identical
    atoms collapses to the single architecture."""
    if isinstance(spec, ModelSpec):
        return spec
    parts = tuple(canonical_model(p) for p in str(spec).split("+"))
    if len(set(parts)) == 1:
        parts = parts[:1]
    return ModelSpec(parts)


__all__ = ["MODELS", "ModelSpec", "build_model", "parse_model"]
