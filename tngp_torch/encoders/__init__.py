from .modules import SHEncoder, WindowGridEncoder, get_encoder

__all__ = ["SHEncoder", "WindowGridEncoder", "get_encoder"]
