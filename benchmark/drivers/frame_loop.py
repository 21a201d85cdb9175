"""Driver kind "frame_loop": one client renders full frames back to back
(a closed loop), each from request to the image on the host.

Set-up builds the trainer from the configuration, its weights drawn on the
card from the mix's `field_seed`, trains it `setup_steps` steps at
`setup_num_rays` rays (the schedule of the configuration's `iters`), so
that every run renders the same field, and renders `warmup_frames`
frames.  The window then renders frames of `width` x `height` at orbit
poses until `--seconds` have passed: a ring of `ring` azimuths at `radius`
and `elevation`, turned by an angle drawn from the field seed and visited
in an order drawn from `--seed`, so that every seed renders the same views
in another order.  A traced run profiles `profile_frames` frames once a
third of the window has passed, from the next frame that starts the
ring's order again: with `profile_frames` = `ring`, every pose once.  A frame with rays that the round cap left
alive counts as failed.

Once the window has closed, the reference renders `checked_frames` of the
window's frames, drawn from the seed, from the state the frames render
(the EMA of the weights and the occupancy grid).  That state is the
program's own, so it is held to plain checks of its own: the set-up's
first `checked_steps` steps against the reference's from the benchmark's
weights, the EMA's update on the last set-up step, the occupancy bits
against the density grid, and a held-out view, drawn from the seed and
rendered by the reference from that state, against its image
(`val_mse`).

A traced run also turns the program's spans on over the window
(`util.HostSpans`) and reduces the profiled span's events by program span
(`spans.by_name`, `record["spans"]`); an untraced run leaves them off and
hooks nothing."""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from .. import checks, spans, trace, util
from ..harness import Outcome
from ..models import hooks
from ..reference import volume
from ..roofline import bound_share, encoder_bytes

# the faults a frame cell can have, planted by `_break_training` (the set-up's
# training) and `_break` (the frames), for the harness's tests
FAULTS = ["frozen_state", "half_batch", "altered_answer"]


# encoder forward calls whose inputs a traced run keeps for the roofline
# (`util.encoder_calls`): about two frames' worth
ENCODER_CALLS = 16


def faults(program) -> list:
    """The faults a cell of this driver can have (its configuration's program
    module adds none here)."""
    return FAULTS


def tiny(tf: dict, limits: dict) -> None:
    """Cut the mix to a size the CPU runs in seconds, for the harness's tests."""
    tf.update(setup_num_rays=256, setup_steps=200, width=20, height=16, chunk=128,
              warmup_frames=1, profile_frames=1)
    # 200 steps of a narrow field on six 24x24 views read ~17 dB on a
    # held-out view, where the cell's field reads ~37 dB
    limits["val_mse"] = 0.05


def orbit_pose(phi: float, radius: float, elevation: float) -> np.ndarray:
    """Camera-to-world pose at azimuth `phi` on a ring around the origin,
    looking at it (the camera looks down its +z)."""
    theta = np.pi / 2 - elevation * np.sin(2 * phi + 0.7)
    c = radius * np.array([np.sin(theta) * np.sin(phi), np.cos(theta),
                           np.sin(theta) * np.cos(phi)])
    forward = -c / np.linalg.norm(c)
    right = np.cross(forward, np.array([0.0, -1.0, 0.0]))
    right /= np.linalg.norm(right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.stack([right, np.cross(right, forward), forward], axis=-1)
    pose[:3, 3] = c
    return pose


def frame_poses(tf: dict, seed: int) -> list:
    """The ring's poses, turned by the field seed's angle, in the order of
    `seed`."""
    o = tf["orbit"]
    turn = np.random.default_rng([int(tf["field_seed"]), 7]).uniform(0.0,
                                                                     2 * math.pi / o["ring"])
    order = np.random.default_rng([int(seed), 7]).permutation(o["ring"])
    return [orbit_pose(turn + 2 * math.pi * k / o["ring"], o["radius"], o["elevation"])
            for k in order]


def _break_training(tr, faults) -> None:
    """Break the set-up's training underneath, for the harness's own tests."""
    if "frozen_state" in faults:  # a step that leaves its state unchanged
        tr.optimizer.step = lambda *a, **k: None


def _break(tr, faults) -> None:
    """Break the frames underneath, for the harness's own tests."""
    faults = set(faults) - {"frozen_state"}
    real = tr.render_image

    def broken(*a, **k):
        img, dep = real(*a, **k)
        img = img.copy()
        if "altered_answer" in faults:  # the image altered where it is made
            img += 0.02
        if "half_batch" in faults:  # half the pixels left unrendered
            img[img.shape[0] // 2:] = 1.0
        return img, dep

    if faults:
        tr.render_image = broken


def run(ctx) -> Outcome:
    cfg, tf, dev, prog, ref = ctx.cfg, ctx.traffic, ctx.device, ctx.program, ctx.reference
    data = util.load_scene(cfg)
    weights = ref.make_weights(cfg, tf["field_seed"], dev)
    inputs0 = {k: v.clone() for k, v in weights.items()}  # the reference's copy
    tr = prog.build_trainer(cfg, data, tf["setup_num_rays"], weights, tf["field_seed"], dev,
                            eval_budget=tf["eval_budget"])
    del weights
    _break_training(tr, ctx.faults)
    util.note(f"{time.time() - ctx.t_start:.3f} s: trainer built")
    n_chk = tf["checked_steps"]
    first = hooks.watched_steps(tr, n_chk)
    first["start"] = {"weights": inputs0}  # the benchmark's weights, not the program's copy
    tr.run_steps(tf["setup_steps"] - n_chk - 1)
    ema = hooks.ema_step(tr)
    util.note(f"{time.time() - ctx.t_start:.3f} s: {tf['setup_steps']} set-up steps done")
    W, H, chunk = tf["width"], tf["height"], tf["chunk"]
    poses = frame_poses(tf, ctx.seed)
    for k in range(tf["warmup_frames"]):
        tr.render_image(poses[k % len(poses)], W=W, H=H, chunk=chunk)
    _break(tr, ctx.faults)
    frames, times, cuts, stats = [], [], [], []
    record = {"kind": "eval", "flops_fwd": ref.forward_flops(cfg)}
    todo_profile = ctx.trace
    profiled, prof_s = [], 0.0  # the frames rendered under the profiler, its seconds
    with util.HostSpans(ctx.trace) as host_spans:  # the window starts
        util.sync(dev)
        setup_s = time.time() - ctx.t_start
        t0 = util.clock(dev)
        while True:
            # the profiled frames start a third into the window, at the ring's
            # first pose in this run's order, so that the same poses are profiled
            if (todo_profile and time.perf_counter() - t0 >= ctx.seconds / 3
                    and len(frames) % len(poses) == 0):
                todo_profile = False
                a = util.clock(dev)
                with host_spans.left_out(), util.profiled(dev) as span, \
                        util.encoder_calls(ENCODER_CALLS) as enc:
                    for _ in range(tf["profile_frames"]):
                        profiled.append(len(frames))
                        _frame(tr, poses[len(frames) % len(poses)], W, H, chunk, frames,
                               times, cuts, stats)
                prof_s = time.perf_counter() - a  # with the profiler's own processing
                record["span_events"], record["encoder_inputs"] = span["events"], enc
                record["span_frames"] = len(profiled)
            else:
                _frame(tr, poses[len(frames) % len(poses)], W, H, chunk, frames, times, cuts,
                       stats)
            if (time.perf_counter() - t0 >= ctx.seconds
                    and len(frames) >= tf["checked_frames"] and not todo_profile):
                break
        t1 = util.clock(dev)
    host = host_spans.totals
    window_s = t1 - t0
    n_frames = len(frames)
    failed = int((torch.stack(cuts) > 0).sum())
    # the rate of work outside the profiled span, for the share of the chip's peak
    record.update(window_s=window_s - prof_s, frames=n_frames,
                  rounds_mean=float(np.mean([s["rounds"] for s in stats])),
                  host_reads_mean=float(np.mean([s["host_reads"] for s in stats])),
                  valid_samples=float(sum(s["valid_samples"] for i, s in enumerate(stats)
                                          if i not in profiled)))
    peak = util.peak_memory(dev)
    p90 = statistics.quantiles(times, n=10)[8] if n_frames >= 2 else times[0]
    e2e = {"eval_rays_per_s": n_frames * W * H / window_s, "frame_ms_p90": 1e3 * p90,
           "setup_s": setup_s}
    util.note(f"set-up {setup_s:.3f} s, window {window_s:.3f} s, {n_frames} frames (p90 over "
              f"{n_frames}: {1e3 * p90:.2f} ms, median {1e3 * statistics.median(times):.2f} ms), "
              f"rounds {[s['rounds'] for s in stats[:8]]}, cut frames {failed}")
    span_rec = _reduce_trace(record, cfg, host)
    if span_rec:
        busy = span_rec["busy_s"] / len(profiled)
        free = record["window_s"] / (n_frames - len(profiled))
        util.note(f"device busy {1e3 * busy:.3f} ms a frame in the profiled span, against "
                  f"{1e3 * free:.3f} ms a frame outside it: idle {100 * (1 - busy / free):.1f} %")

    # the program's state goes; the reference renders frames the window made
    rng = np.random.default_rng([int(ctx.seed), 11])
    picked = sorted(rng.choice(n_frames, size=min(tf["checked_frames"], n_frames),
                               replace=False).tolist())
    state = hooks.state_for_reference(tr)
    grid = hooks.grid_state(tr)
    intr = data[1] * np.array([W / data[2].shape[2], H / data[2].shape[1]] * 2, np.float32)
    views = hooks.train_views(cfg, data, dev)
    del tr
    util.free(dev)
    t_ref = time.perf_counter()
    got = checks.follow(ref, cfg, first)
    offs = checks.exact_offs(first, got, cfg, views, data[1])
    offs["grid_bits_off"] += volume.grid_bits_off(grid["density_grid"], grid["bitfield"], cfg)
    lv = checks.leaves_compared(got)
    n = checks.numbers(checks.program_side(first), got, lv)
    nums = {f"first.{k}": n[k] for k in checks.STEP_NUMBERS}
    ema_gap = checks.ema_gap(ema)
    util.note(f"first steps: program losses {first['losses']}, reference {got['losses']}; "
              f"each step's colour rmse {n['color_rmse_steps']}, loss gap "
              f"{n['loss_gap_steps']}; leaves compared {lv}; EMA gap {ema_gap!r}")
    ctl = {}
    if ctx.control:  # the reference one precision down in the program's place
        c = checks.numbers(checks.control_side(checks.follow(ref, cfg, first, "low")), got, lv)
        ctl.update({f"first.{k}": c[k] for k in checks.STEP_NUMBERS},
                   ema_gap=checks.ema_gap(ema, low=True))
    del got, first, views, ema
    util.free(dev)
    val_mse = _val_mse(ref, cfg, data, state, ctx.seed)
    if ctx.control:
        ctl["val_mse"] = _val_mse(ref, cfg, data, state, ctx.seed, "low")
    img_rmse = dep_rmse = 0.0
    ctl.update(image_rmse=0.0, depth_rmse=0.0)
    for i in picked:
        pose_i = poses[i % len(poses)]
        img_r, dep_r = ref.render_frame(state["weights"], state["bitfield"], cfg, pose_i, intr,
                                        H, W)
        e_img, e_dep = _rmse(frames[i], img_r, dep_r)
        util.note(f"frame {i}: image rmse {e_img}, depth rmse {e_dep} "
                  f"({time.perf_counter() - t_ref:.2f} s of reference so far)")
        img_rmse, dep_rmse = max(img_rmse, e_img), max(dep_rmse, e_dep)
        if ctx.control:  # the reference one precision down in the program's place
            low = ref.render_frame(state["weights"], state["bitfield"], cfg, pose_i, intr, H,
                                   W, precision="low")
            c_img, c_dep = _rmse(low, img_r, dep_r)
            ctl.update(image_rmse=max(ctl["image_rmse"], c_img),
                       depth_rmse=max(ctl["depth_rmse"], c_dep))
    if ctx.control:
        record["control"] = ctl
    util.note(f"reference {time.perf_counter() - t_ref:.2f} s")
    lim = ctx.limits
    values = {**offs, "ema_gap": ema_gap, "val_mse": val_mse, **nums,
              "image_rmse": img_rmse, "depth_rmse": dep_rmse}
    return Outcome(attempted=n_frames, failed=failed, e2e=e2e, record=record,
                   checks=[(k, v, lim[k]) for k, v in values.items()],
                   memory_peak_bytes=peak, trace=span_rec)


def _val_mse(ref, cfg: dict, data, state: dict, seed: int, precision: str = "f32") -> float:
    """Mean squared error against its image of a held-out view, drawn from
    the seed, rendered by the reference at the scene's size from the
    program's trained state (EMA weights and occupancy bits)."""
    poses, intr, images = data
    i = int(np.random.default_rng([int(seed), 13]).integers(cfg["scene"]["n_val"]))
    H, W = images.shape[1:3]
    img, _ = ref.render_frame(state["weights"], state["bitfield"], cfg, poses[i], intr, H, W,
                              precision=precision)
    gt = torch.as_tensor(np.asarray(images[i, ..., :3]), device=img.device).reshape(-1, 3)
    mse = float(((img - gt) ** 2).mean())
    util.note(f"held-out view {i}: mse {mse!r} (PSNR {-10 * math.log10(max(mse, 1e-30)):.2f} dB)")
    return mse


def _rmse(frame, img_r: torch.Tensor, dep_r: torch.Tensor) -> tuple:
    """Root mean square gaps (image, depth) of a frame (image [H, W, 3],
    depth [H, W]) from the reference's."""
    img = torch.as_tensor(frame[0], device=img_r.device).reshape(-1, 3)
    dep = torch.as_tensor(frame[1], device=dep_r.device).reshape(-1)
    return (float(torch.sqrt(((img - img_r) ** 2).mean())),
            float(torch.sqrt(((dep - dep_r) ** 2).mean())))


def _frame(tr, pose, W, H, chunk, frames, times, cuts, stats) -> None:
    """One frame, timed from the request to the image on the host."""
    a = time.perf_counter()
    img, dep = tr.render_image(pose, W=W, H=H, chunk=chunk)
    times.append(time.perf_counter() - a)
    frames.append((img, dep))
    cuts.append(tr.last_render_cut.sum())
    stats.append(tr.last_render_stats)


def _reduce_trace(record: dict, cfg: dict, host: dict) -> dict:
    """The traced span's numbers into `record` (and the busy / window /
    breakdown of the result line), with the program's spans a frame
    (`record["spans"]`, from the events and the window's host totals
    `host`); the raw events and inputs are dropped."""
    events = record.pop("span_events", None)
    enc = record.pop("encoder_inputs", None)
    if not events:
        return {}
    red = trace.reduce_span(events)
    record["span"] = {k: red[k] for k in ("window_s", "busy_s", "device_ops")}
    record["encoder"] = {
        "fwd_s": sum(e.dur for e in trace.launched_in(events, trace.host_spans(
            events, "bench.encoder_fwd")) if "window_fwd_kernel" in e.name) / 1e9,
        "fwd_bytes": sum(encoder_bytes(x, w, cfg, enc["block"]) for x, w in enc["fwd"]),
    }
    by_span = spans.reduce(events)
    record["spans"] = spans.by_name(by_span, record["span_frames"], host, "tngp.frame")
    e = record["encoder"]
    util.note(f"encoder roofline: fwd {bound_share(e['fwd_bytes'], e['fwd_s'])} % over "
              f"{len(enc['fwd'])} calls; span {record['span']}")
    util.note(f"spans a frame: {record['spans']}; idle by span {spans.idle_by_span(by_span)}; "
              f"inside spans: device {by_span.get('covered')}, idle {by_span.get('idle_covered')}")
    return red
