"""Device milliseconds a step of the march (`tngp.render.march`: `near_far`,
the march kernels, `ladder_samples`): the device operations launched inside
the span's ranges in the profiled span, over its steps (`spans.by_name`)."""

from benchmark.spans import value


def read(rec):
    return value(rec, "train", "tngp.render.march", "device_ms")
