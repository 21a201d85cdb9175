from .common import MLP
from .dnerf import DNeRFNetwork
from .ngp import NGPNetwork

__all__ = ["MLP", "DNeRFNetwork", "NGPNetwork"]
