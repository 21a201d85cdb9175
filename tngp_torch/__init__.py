"""tngp_torch — the PyTorch/CUDA port of `tngp` for one NVIDIA H100.

The JAX package `tngp/` stays the reference; this package mirrors its module
layout (`tngp_torch/ops/march.py` is the counterpart of `tngp/ops/march.py`,
and so on) and imports neither JAX nor anything of `tngp`.  Every Pallas
kernel on a ported path is a hand-written CUDA kernel (`csrc/`), each with a
plain PyTorch version beside it: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise.

Ported so far: the instant-NGP eval render (`render.render_rays_eval`, the
frame renderer `render.FrameRenderer`) and training step
(`render.render_rays_train`, `train.Trainer` with checkpoints in the JAX
package's format), its entry point (`python -m tngp_torch.cli.main_nerf`:
the transforms.json loader, training, validation, test renders and mesh
export), and D-NeRF training on the window encoder (`models.DNeRFNetwork`,
`train.DNeRFTrainer`); `diagnostics.device_parity` holds the kernels against
independent plain versions on the card.
"""

__version__ = "0.1.0"
