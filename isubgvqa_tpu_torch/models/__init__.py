"""Models of the port (the eval and training forward of the config of
record under each of the four samplers)."""

from .build import build_model, make_aimle_states, resolve_device
from .isubgvqa import ISubGVQA, ModelOutput

__all__ = ["build_model", "make_aimle_states", "resolve_device", "ISubGVQA",
           "ModelOutput"]
