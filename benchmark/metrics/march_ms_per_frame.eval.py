"""Device milliseconds a frame of the march (`tngp.render.march`: first pass
and rounds, the round compaction): the device operations launched inside the
span's ranges in the profiled span, over its frames (`spans.by_name`)."""

from benchmark.spans import value


def read(rec):
    return value(rec, "eval", "tngp.render.march", "device_ms")
