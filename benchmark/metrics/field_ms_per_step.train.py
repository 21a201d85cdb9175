"""Device milliseconds a step of the field's queries (`tngp.render.field`): the
device operations launched inside the span's ranges in the profiled span,
over its steps (`spans.by_name`)."""

from benchmark.spans import value


def read(rec):
    return value(rec, "train", "tngp.render.field", "device_ms")
