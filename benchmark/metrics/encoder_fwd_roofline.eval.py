"""Share of the HBM roofline of the window encoder's forward kernel in the
profiled frames: the bytes its calls must move (`roofline.encoder_bytes`) at
3.35 TB/s over their device time."""

from benchmark.roofline import bound_share


def read(rec):
    if rec.get("kind") != "eval" or "encoder" not in rec:
        return None
    e = rec["encoder"]
    return bound_share(e["fwd_bytes"], e["fwd_s"])
