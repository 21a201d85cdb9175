"""Share of the HBM roofline of the window encoder's table gradient in
training steps (`window_bwd_zero_kernel` and `window_bwd_kernel`): the bytes
its profiled calls must move (`roofline.encoder_bwd_bytes`) at 3.35 TB/s
over the two kernels' device time."""

from benchmark.roofline import bound_share


def read(rec):
    if rec.get("kind") != "train" or "encoder_bwd" not in rec:
        return None
    e = rec["encoder_bwd"]
    return bound_share(e["bytes"], e["s"])
