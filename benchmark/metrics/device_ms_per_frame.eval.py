"""Device milliseconds of one 800x800 frame: the union of the device
operations' busy intervals in the profiled span over its frames.  The
device's work alone, steadier than the host-paced rate beside it."""


def read(rec):
    if rec.get("kind") != "eval" or not rec.get("span", {}).get("busy_s"):
        return None
    return 1e3 * rec["span"]["busy_s"] / rec["span_frames"]
