"""Occupied ladder rungs a training ray marches to, counted by the program
(`run_steps`' num_points) over the window's steps, per ray."""


def read(rec):
    if rec.get("kind") != "train" or "num_points_mean" not in rec:
        return None
    return rec["num_points_mean"] / rec["rays_per_step"]
