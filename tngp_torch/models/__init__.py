from .common import MLP
from .dnerf import DNeRFBasisNetwork, DNeRFHyperNetwork, DNeRFNetwork
from .ngp import NGPNetwork
from .sdf import SDFNetwork

__all__ = ["MLP", "DNeRFBasisNetwork", "DNeRFHyperNetwork", "DNeRFNetwork", "NGPNetwork",
           "SDFNetwork"]
