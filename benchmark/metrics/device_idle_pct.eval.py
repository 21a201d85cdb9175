"""Share of the profiled frames' span in which no operation ran on the
device: 1 - the union of the device operations' busy intervals over the
span's wall."""


def read(rec):
    if rec.get("kind") != "eval" or not rec.get("span", {}).get("busy_s"):
        return None
    sp = rec["span"]
    return 100.0 * (1.0 - sp["busy_s"] / sp["window_s"])
