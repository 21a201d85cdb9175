from .ccnerf import CCConfig, CCNeRF
from .common import MLP
from .dnerf import DNeRFBasisNetwork, DNeRFHyperNetwork, DNeRFNetwork
from .ngp import NGPNetwork
from .sdf import SDFNetwork
from .tensorf import TensoRFNetwork

__all__ = ["CCConfig", "CCNeRF", "MLP", "DNeRFBasisNetwork", "DNeRFHyperNetwork",
           "DNeRFNetwork", "NGPNetwork", "SDFNetwork", "TensoRFNetwork"]
