"""Host milliseconds a frame spent other than waiting on reads: the frame's
span (`tngp.frame`) less `tngp.frame.read` and `tngp.frame.to_host`, by the
program's aggregate over the window's unprofiled frames."""

from benchmark.spans import value

WAITS = ("tngp.frame.read", "tngp.frame.to_host")


def read(rec):
    frame = value(rec, "eval", "tngp.frame", "host_ms")
    if frame is None:
        return None
    return frame - sum(value(rec, "eval", n, "host_ms") or 0.0 for n in WAITS)
