"""Device-to-host reads the frame renderer makes a frame, counted by the
program (`last_render_stats["host_reads"]`) over the window's frames."""


def read(rec):
    if rec.get("kind") != "eval" or "host_reads_mean" not in rec:
        return None
    return rec["host_reads_mean"]
