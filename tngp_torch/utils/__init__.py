from .colors import linear_to_srgb, srgb_to_linear
from .config import TrainConfig

__all__ = ["TrainConfig", "srgb_to_linear", "linear_to_srgb"]
