"""Host milliseconds a frame spent waiting on its reads from the device
(`tngp.frame.read`, one a counted host read, and the image's copy
`tngp.frame.to_host`), by the program's aggregate over the window's
unprofiled frames."""

from benchmark.spans import value

WAITS = ("tngp.frame.read", "tngp.frame.to_host")


def read(rec):
    if value(rec, "eval", "tngp.frame", "host_ms") is None:
        return None
    return sum(value(rec, "eval", n, "host_ms") or 0.0 for n in WAITS)
