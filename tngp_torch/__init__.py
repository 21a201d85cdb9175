"""tngp_torch — the PyTorch/CUDA port of `tngp` for one NVIDIA H100.

The JAX package `tngp/` stays the reference; this package mirrors its module
layout (`tngp_torch/ops/march.py` is the counterpart of `tngp/ops/march.py`,
and so on) and imports neither JAX nor anything of `tngp`.  Every Pallas
kernel on a ported path is a hand-written CUDA kernel (`csrc/`), each with a
plain PyTorch version beside it: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise.

Ported so far: the instant-NGP eval render (`render.render_rays_eval`) and
training step (`render.render_rays_train`, `train.Trainer`).
"""

__version__ = "0.1.0"
