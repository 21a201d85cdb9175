from .modules import (
    FreqEncoder,
    GridEncoder,
    IdentityEncoder,
    SHEncoder,
    WindowGridEncoder,
    get_encoder,
)

__all__ = ["FreqEncoder", "GridEncoder", "IdentityEncoder", "SHEncoder", "WindowGridEncoder",
           "get_encoder"]
