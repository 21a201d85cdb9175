from .config import TrainConfig

__all__ = ["TrainConfig"]
