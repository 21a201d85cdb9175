"""The whole frame's share of the chip's bf16 peak (989 TFLOP/s): the
forward FLOPs (`reference.forward_flops`) of every sample the frames
composited (`last_render_stats["valid_samples"]`) over the window's
host-clock seconds."""

from benchmark.roofline import PEAK_BF16_FLOPS


def read(rec):
    if rec.get("kind") != "eval" or "valid_samples" not in rec:
        return None
    return 100.0 * rec["flops_fwd"] * rec["valid_samples"] / (rec["window_s"] * PEAK_BF16_FLOPS)
