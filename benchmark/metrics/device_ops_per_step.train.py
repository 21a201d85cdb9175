"""Device operations a training step launches, counted in the profiled span's
device trace (kernels, copies and sets) over its steps."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("span", {}).get("device_ops"):
        return None
    return rec["span"]["device_ops"] / rec["span_steps"]
