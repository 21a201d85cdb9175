"""Device milliseconds of one occupancy-grid update: the device operations
launched inside the benchmark's range around the trainer's `update_grid`,
by the profiled span's trace, per update."""


def read(rec):
    if rec.get("kind") != "train" or "grid_update_s" not in rec:
        return None
    s, n = rec["grid_update_s"]
    return 1e3 * s / n if n and s > 0 else None
