"""Device milliseconds a frame of the compositor (`tngp.render.composite`): the
device operations launched inside the span's ranges in the profiled span,
over its frames (`spans.by_name`)."""

from benchmark.spans import value


def read(rec):
    return value(rec, "eval", "tngp.render.composite", "device_ms")
