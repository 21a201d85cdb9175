"""Device milliseconds a step of the compositor (`tngp.render.composite`, the
results with it): the device operations launched inside the span's ranges in
the profiled span, over its steps (`spans.by_name`)."""

from benchmark.spans import value


def read(rec):
    return value(rec, "train", "tngp.render.composite", "device_ms")
