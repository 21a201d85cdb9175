from .common import MLP
from .dnerf import DNeRFBasisNetwork, DNeRFHyperNetwork, DNeRFNetwork
from .ngp import NGPNetwork

__all__ = ["MLP", "DNeRFBasisNetwork", "DNeRFHyperNetwork", "DNeRFNetwork", "NGPNetwork"]
