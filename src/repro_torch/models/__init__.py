"""The language model of the port (forward path): `Model`, `build_model`."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
