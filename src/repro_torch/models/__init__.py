from .common import make_param
from .model import Model, ModelConfig

__all__ = ["Model", "ModelConfig", "make_param"]
