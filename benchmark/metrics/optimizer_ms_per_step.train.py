"""Device milliseconds of one Adam step: the device operations launched
inside the benchmark's range around the optimizer's `step`, by the profiled
span's trace, per step."""


def read(rec):
    if rec.get("kind") != "train" or "optimizer_s" not in rec:
        return None
    s, n = rec["optimizer_s"]
    return 1e3 * s / n if n and s > 0 else None
