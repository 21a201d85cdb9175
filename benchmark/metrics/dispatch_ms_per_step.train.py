"""Host milliseconds of one training step (`tngp.train.step`), by the
program's aggregate over the window's unprofiled steps: the host's
dispatch, which paces a step whose device work is shorter."""

from benchmark.spans import value


def read(rec):
    return value(rec, "train", "tngp.train.step", "host_ms")
