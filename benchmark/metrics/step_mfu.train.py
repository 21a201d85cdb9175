"""The whole training step's share of the chip's bf16 peak (989 TFLOP/s):
model FLOPs of the window's steps (each kept sample's forward,
`reference.forward_flops`, and its backward at twice that) over the
window's host-clock seconds."""

from benchmark.roofline import PEAK_BF16_FLOPS


def read(rec):
    if rec.get("kind") != "train" or "samples_kept" not in rec:
        return None
    return 100.0 * 3 * rec["flops_fwd"] * rec["samples_kept"] / (rec["window_s"] * PEAK_BF16_FLOPS)
