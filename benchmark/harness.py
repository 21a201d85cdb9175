"""The benchmark's driver: finds a cell of BENCHMARK.json by name, its
configuration, its traffic mix and its per-layer metrics by the names
there, runs the cell once and prints the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run is one process: set-up (imports, kernel load, scene, weights from
the seed on the card, set-up training, warm-up), a measured window of
`--seconds`, then the check of what the window produced against the plain
reference.  The last line of standard output is one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), device, with `--trace 1` breakdown, and
last `checks`, each number compared beside its limit (also the last lines
of standard error).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tngp")  # top-level module names
CACHE_DIR = ROOT / ".bench_cache"  # compile caches, fixed paths inside the checkout


def pin_caches() -> None:
    """Point every compile cache at a fixed directory inside the checkout
    (the port's own kernels build into tngp_torch/_build/ there), and keep
    libraries from loading JAX by themselves."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_ext"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.makedirs(CACHE_DIR / sub, exist_ok=True)  # torch does not make them
        os.environ[var] = str(CACHE_DIR / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


@dataclass
class Outcome:
    """What a driver hands back from one run."""

    attempted: int
    failed: int
    e2e: dict  # end-to-end metric name -> value, setup_s among them
    record: dict  # what the per-layer readers read
    checks: list  # (name, value, limit): correct where every value <= its limit
    memory_peak_bytes: int = 0
    trace: dict = field(default_factory=dict)  # busy_s, window_s, breakdown


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str, root: Path = ROOT) -> dict:
    """(bench, cell, configuration, traffic, limits) of the cell `name`: the
    limits of `correct` are the cell's own, benchmark/limits/<cell>.json."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(root / conf["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    return {"bench": bench, "cell": cell, "cfg": cfg, "traffic": traffic,
            "limits": load_json(BENCH_DIR / "limits" / f"{name}.json")}


def cell_metrics(bench: dict, cell: str) -> tuple:
    """(end-to-end metrics, per-layer metrics) that the cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if cell in m.get("workloads", [cell]) and m["moves"] in names]
    return e2e, per


def metric_reader(name: str):
    """The `read(record)` function of per-layer metric `name`
    (benchmark/metrics/<name>.py)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             faults=(), control: bool = False) -> Outcome:
    """Run the cell of `spec` (`cell_spec`) on `device` and return its
    Outcome; `faults` breaks the timed path underneath, for the tests, and
    `control` adds the control's numbers (`record["control"]`) for
    benchmark/control.py."""
    cfg, traffic = spec["cfg"], spec["traffic"]
    ctx = SimpleNamespace(
        cfg=cfg, traffic=traffic, seed=int(seed), seconds=float(seconds), trace=bool(trace),
        device=device, t_start=t_start, faults=set(faults), control=control,
        limits=spec["limits"],
        program=importlib.import_module(f"benchmark.models.{cfg['arch']}"),
        reference=importlib.import_module(f"benchmark.reference.{cfg['arch']}"))
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    return driver.run(ctx)


def is_correct(checks) -> bool:
    """`correct`: there are numbers to compare and each is within its limit."""
    return bool(checks) and all(v <= lim for _, v, lim in checks)


def result_line(spec: dict, out: Outcome, trace: bool, device_info: dict) -> dict:
    """The result's JSON object, `checks` last."""
    e2e, per = cell_metrics(spec["bench"], spec["cell"]["name"])
    metrics = {}
    if trace:
        for m in per:
            v = metric_reader(m["name"])(out.record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in e2e:
            if m["name"] in out.e2e:
                metrics[m["name"]] = {"value": float(out.e2e[m["name"]]), "unit": m["unit"]}
    correct = is_correct(out.checks)
    dev = dict(device_info, memory_peak_bytes=int(out.memory_peak_bytes))
    line = {"correct": correct, "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = float(out.trace.get("busy_s", 0.0))
        dev["window_s"] = float(out.trace.get("window_s", 0.0))
        if out.trace.get("breakdown"):
            line["breakdown"] = out.trace["breakdown"]
    line["checks"] = {n: {"value": float(v), "limit": float(lim)} for n, v, lim in out.checks}
    return line


def parse_args(argv):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    pin_caches()
    spec = cell_spec(args.workload)
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), dev, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3
    line = result_line(spec, out, bool(args.trace), info)
    for n, c in line["checks"].items():
        print(f"check {n} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
