from .common import MLP
from .ngp import NGPNetwork

__all__ = ["MLP", "NGPNetwork"]
