"""Share of the HBM roofline of the general scatter-add (`scatter_add_any`)
in training steps: the bytes its profiled calls must move (`roofline.
add_bytes` of their shapes) at 3.35 TB/s over the device time of the
operations launched inside the calls."""

from benchmark.roofline import bound_share


def read(rec):
    if rec.get("kind") != "train" or "scatter_any" not in rec:
        return None
    sa = rec["scatter_any"]
    return bound_share(sa["bytes"], sa["s"])
