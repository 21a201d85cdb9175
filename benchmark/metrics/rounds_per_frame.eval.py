"""Residual rounds the frame renderer runs a frame, counted by the program
(`last_render_stats["rounds"]`) over the window's frames."""


def read(rec):
    if rec.get("kind") != "eval" or "rounds_mean" not in rec:
        return None
    return rec["rounds_mean"]
