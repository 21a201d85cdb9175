"""Driver kind "train_loop": training steps of one trainer, back to back.

Set-up builds the trainer from the configuration, its weights drawn on the
card from the mix's `field_seed`, so that every run trains the same field
at the same sizes, and drives it through `warmup_steps` steps: the first
`checked_steps` of them with the benchmark watching (`hooks.watched_steps`),
and, where the configuration's program module has a `watch_stage`, the
stage it records (TensoRF's last upsample).  The trainer's draws then start
afresh from `--seed`.  The window runs `run_steps` in chunks of
`chunk_steps` (the grid-update interval) until `--seconds` have passed; a
traced run profiles `profile_steps` of them once a third of the window has
passed.  Once the window has closed, `checked_steps` more steps run
watched, from the state the window left.  The reference follows both runs
of watched steps, the first from the benchmark's own weights and the last
from the snapshot of the trainer's state (weights, Adam's moments, grid)
that they started from, and works out the watched stage again; the numbers
compared are returned with their limits (benchmark/limits/<cell>.json).
The faults of the harness's tests are planted by `_break` before set-up,
and a program module's own (`faults`) by its `plant` once the window has
closed.

A traced run also turns the program's spans on over the window
(`util.HostSpans`) and reduces the profiled span's events by program span
(`spans.by_name`, `record["spans"]`); an untraced run leaves them off and
hooks nothing."""

from __future__ import annotations

import contextlib
import statistics
import time

import torch

from .. import checks, spans, trace, util
from ..harness import Outcome
from ..models import hooks
from ..roofline import add_bytes, bound_share, encoder_bwd_bytes

# the faults a training cell can have, planted by `_break` (the harness's tests)
FAULTS = ["frozen_state", "half_batch", "altered_answer"]


def faults(program) -> list:
    """The faults a cell of this driver can have: `FAULTS`, and those its
    configuration's program module (`benchmark/models/<arch>.py`) gives as
    its own `FAULTS`, which its `plant` breaks once the window has closed."""
    return FAULTS + list(getattr(program, "FAULTS", ()))


def tiny(tf: dict, limits: dict) -> None:
    """Cut the mix to a size the CPU runs in seconds, for the harness's tests."""
    tf.update(num_rays=128, warmup_steps=8, chunk_steps=16, profile_steps=16)


def _break(tr, faults) -> None:
    """Break the timed path underneath, for the harness's own tests (`run`
    puts the trainer module's functions back)."""
    from tngp_torch.train import trainer as mod

    if "frozen_state" in faults:  # a step that leaves its state unchanged
        real_make = tr.make_optimizer

        def make():
            opt, sched = real_make()
            opt.step = lambda *a, **k: None
            return opt, sched

        tr.make_optimizer = make  # also the optimizers of later upsamples
        tr.optimizer.step = lambda *a, **k: None
    if "half_batch" in faults:  # every other ray left out, the mean over the rest
        real = mod.masked_mean

        def half(per_ray, ray_mask, *a, **k):
            keep = torch.arange(ray_mask.shape[0], device=ray_mask.device) % 2 == 0
            return real(per_ray, ray_mask & keep, *a, **k)

        mod.masked_mean = half
    if "altered_answer" in faults:  # the rendered colours altered where made
        real_render = mod.render_rays_train

        def shifted(*a, **k):
            out = real_render(*a, **k)
            out["image"] = out["image"] + 0.02
            return out

        mod.render_rays_train = shifted


def run(ctx) -> Outcome:
    from tngp_torch.train import trainer as mod

    saved = (mod.masked_mean, mod.render_rays_train)
    try:
        return _run(ctx)
    finally:
        mod.masked_mean, mod.render_rays_train = saved


def _run(ctx) -> Outcome:
    cfg, tf, dev, prog, ref = ctx.cfg, ctx.traffic, ctx.device, ctx.program, ctx.reference
    data = util.load_scene(cfg)
    weights = ref.make_weights(cfg, tf["field_seed"], dev)
    inputs0 = {k: v.clone() for k, v in weights.items()}  # the reference's copy
    tr = prog.build_trainer(cfg, data, tf["num_rays"], weights, tf["field_seed"], dev)
    del weights
    _break(tr, ctx.faults)
    util.note(f"{time.time() - ctx.t_start:.3f} s: trainer built")
    n_chk = tf["checked_steps"]
    stage = getattr(prog, "watch_stage", None)
    with (stage(tr) if stage else contextlib.nullcontext({})) as seen:
        first = hooks.watched_steps(tr, n_chk)
        tr.run_steps(tf["warmup_steps"] - n_chk)
    first["start"] = {"weights": inputs0}  # the benchmark's weights, not the program's copy
    hooks.reseed(tr, ctx.seed)
    chunk = tf["chunk_steps"]
    losses, pts, budgets, ends = [], [], [], []
    record = {"kind": "train", "rays_per_step": tf["num_rays"],
              "flops_fwd": ref.forward_flops(cfg)}
    todo_profile = ctx.trace
    profiled, prof_s = [], 0.0  # the chunks run under the profiler, its seconds
    steps = 0
    with util.HostSpans(ctx.trace) as host_spans:  # the window starts
        util.sync(dev)
        setup_s = time.time() - ctx.t_start
        t0 = util.clock(dev)
        while True:
            if todo_profile and time.perf_counter() - t0 >= ctx.seconds / 3:
                todo_profile = False
                a = util.clock(dev)
                with host_spans.left_out(), util.profiled(dev) as span, \
                        util.scatter_any_calls() as sca, util.any_kernel_calls() as anyk, \
                        util.encoder_bwd_calls() as encb, \
                        util.spans_around(tr, "update_grid", "bench.update_grid"), \
                        util.spans_around(tr.optimizer, "step", "bench.optimizer_step"):
                    for _ in range(max(1, tf["profile_steps"] // chunk)):
                        profiled.append(len(pts))
                        l, p, _ = tr.run_steps(chunk)
                        losses.append(l), pts.append(p), budgets.append(tr.tier_M)
                        steps += chunk
                prof_s = time.perf_counter() - a  # with the profiler's own processing
                record["span_steps"] = len(profiled) * chunk
                record["span_events"], record["scatter_calls"] = span["events"], sca
                record["scatter_any_shapes"], record["encoder_bwd_calls"] = anyk, encb
            else:
                l, p, _ = tr.run_steps(chunk)
                losses.append(l), pts.append(p), budgets.append(tr.tier_M)
                steps += chunk
            ends.append(time.perf_counter())
            if time.perf_counter() - t0 >= ctx.seconds and not todo_profile:
                break
        t1 = util.clock(dev)
    host = host_spans.totals
    window_s = t1 - t0
    all_losses = torch.cat(losses)
    failed = int((~torch.isfinite(all_losses)).sum())
    pts_all = torch.stack(pts).float()  # [chunks, chunk]
    kept = torch.minimum(pts_all, torch.tensor(budgets, device=pts_all.device)[:, None]).sum(1)
    kept[profiled] = 0.0
    # the rate of work outside the profiled span, for the share of the chip's peak
    record.update(window_s=window_s - prof_s, steps=steps,
                  num_points_mean=float(pts_all.mean()), samples_kept=float(kept.sum()))
    peak = util.peak_memory(dev)
    e2e = {"train_rays_per_s": tf["num_rays"] * steps / window_s, "setup_s": setup_s}
    util.note(f"set-up {setup_s:.3f} s, window {window_s:.3f} s, {steps} steps, "
              f"mean num_points {record['num_points_mean']:.1f} (first chunk "
              f"{float(pts_all[0].mean()):.1f}, last {float(pts_all[-1].mean()):.1f}), "
              f"last losses {float(all_losses[-chunk:].mean()):.6f}, resolution "
              f"{getattr(tr.model, 'resolution', None)}, budgets {sorted(set(budgets))}; "
              f"ms a step by chunk (quartiles, unprofiled): {_chunk_ms(ends, t0, chunk, profiled)}")
    span_rec = _reduce_trace(record, host, cfg)
    if span_rec:
        busy = span_rec["busy_s"] / record["span_steps"]
        free = record["window_s"] / (steps - record["span_steps"])
        util.note(f"device busy {1e3 * busy:.3f} ms a step in the profiled span, against "
                  f"{1e3 * free:.3f} ms a step outside it: idle {100 * (1 - busy / free):.1f} %")

    # the steps after the window, watched; then the program's state goes
    if hasattr(prog, "plant"):
        prog.plant(tr, ctx.faults)
    after = hooks.watched_steps(tr, n_chk)
    views = hooks.train_views(cfg, data, dev)
    intr = data[1]
    del tr
    util.free(dev)
    t_ref = time.perf_counter()
    runs = {"first": first, "after": after}
    offs = {"feed_rays_off": 0, "grid_bits_off": 0, "march_off": 0}
    nums, ctl = {}, {}
    for tag, w in runs.items():
        got = checks.follow(ref, cfg, w)
        for k, v in checks.exact_offs(w, got, cfg, views, intr).items():
            offs[k] += v
        lv = checks.leaves_compared(got)
        side = checks.program_side(w)
        n = checks.numbers(side, got, lv)
        nums.update({f"{tag}.{k}": n[k] for k in checks.STEP_NUMBERS})
        util.note(f"{tag} steps: program losses {w['losses']}, reference {got['losses']}; "
                  f"each step's colour rmse {n['color_rmse_steps']}, loss gap "
                  f"{n['loss_gap_steps']}; leaves compared {lv}; first gradients of opposite "
                  f"sign {checks.sign_flips(w['grads'], got['grads'])}")
        for k in got["grad_norms"]:
            util.note(f"{tag} {k}: first gradient {side['grad_norms'][k]!r} "
                      f"[{got['grad_norms'][k]!r}], change {w['change_norms'][k]!r} "
                      f"[{got['change_norms'][k]!r}]")
        if ctx.control:  # the reference one precision down in the program's place
            low = checks.follow(ref, cfg, w, precision="low")
            c = checks.numbers(checks.control_side(low), got, lv)
            ctl.update({f"{tag}.{k}": c[k] for k in checks.STEP_NUMBERS})
        del got
    stage_nums = ref.stage_numbers(seen, cfg) if hasattr(ref, "stage_numbers") else {}
    if ctx.control and stage_nums:
        ctl.update({k: v for k, v in ref.stage_numbers(seen, cfg, "low").items()
                    if not k.endswith("_off")})
    util.note(f"reference {time.perf_counter() - t_ref:.2f} s; stage {stage_nums}")
    if ctx.control:
        record["control"] = ctl
    lim = ctx.limits
    values = {**offs, **stage_nums, **nums}
    checks_ = [(n, values[n], lim[n]) for n in values]
    return Outcome(attempted=steps, failed=failed, e2e=e2e, record=record, checks=checks_,
                   memory_peak_bytes=peak, trace=span_rec)


def _chunk_ms(ends: list, t0: float, chunk: int, profiled: list) -> list:
    """Quartiles of the host's ms a step over the window's unprofiled chunks
    (from each chunk's return to the next's; the host paces these cells)."""
    ms = [1e3 * (b - a) / chunk for i, (a, b) in enumerate(zip([t0] + ends, ends))
          if i not in profiled]
    return [round(q, 3) for q in statistics.quantiles(ms, n=4)] if len(ms) >= 2 else ms


def _reduce_trace(record: dict, host: dict, cfg: dict) -> dict:
    """The traced span's numbers into `record` (and the busy / window /
    breakdown of the result line), with the program's spans a step
    (`record["spans"]`, from the events and the window's host totals
    `host`); the raw events are dropped."""
    events = record.pop("span_events", None)
    if not events:
        return {}
    red = trace.reduce_span(events)
    record["span"] = {k: red[k] for k in ("window_s", "busy_s", "device_ops")}
    record["grid_update_s"] = trace.span_device_s(events, "bench.update_grid")
    record["optimizer_s"] = trace.span_device_s(events, "bench.optimizer_step")
    calls = record.pop("scatter_calls")
    record["scatter_any"] = {"s": trace.span_device_s(events, "bench.scatter_any")[0],
                             "bytes": sum(add_bytes(*c) for c in calls)}
    enc = record.pop("encoder_bwd_calls")
    if enc:
        record["encoder_bwd"] = {"s": trace.kernel_seconds(red["kernel_s"], "window_bwd"),
                                 "bytes": sum(encoder_bwd_bytes(m, w, cfg) for m, w in enc)}
    by_span = spans.reduce(events)
    record["spans"] = spans.by_name(by_span, record["span_steps"], host, "tngp.train.step")
    sa = record["scatter_any"]
    util.note(f"scatter_add_any {bound_share(sa['bytes'], sa['s'])} % over {len(calls)} calls; "
              f"span {record['span']}, grid update {record['grid_update_s']}, optimizer "
              f"{record['optimizer_s']}, encoder table gradient {record.get('encoder_bwd')}, "
              f"{len(record['scatter_any_shapes'])} any-form launches")
    util.note(f"spans a step: {record['spans']}; idle by span {spans.idle_by_span(by_span)}; "
              f"inside spans: device {by_span.get('covered')}, idle {by_span.get('idle_covered')}")
    return red
