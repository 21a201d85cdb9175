"""Device milliseconds a step of the backward (`tngp.train.backward`;
autograd's launches from its device thread count by time, the scatter-adds
in it included): the device operations launched inside the span's ranges in
the profiled span, over its steps (`spans.by_name`)."""

from benchmark.spans import value


def read(rec):
    return value(rec, "train", "tngp.train.backward", "device_ms")
