from .modules import FreqEncoder, SHEncoder, WindowGridEncoder, get_encoder

__all__ = ["FreqEncoder", "SHEncoder", "WindowGridEncoder", "get_encoder"]
