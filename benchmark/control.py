"""The readings that the limits of `correct` are set from, for one cell:
for each seed, the numbers the cell compares for the program (its sound
runs) and for the control, the plain reference one precision below the
configuration's (`precision="low"`) put in the program's place; with
`--faults`, also the program's numbers with each fault planted underneath
(the faults of the harness's tests).  The benchmark's own runs never run
the control or a fault.  Each line says whether the program's numbers and
the control's, the control's in the program's place, come out `correct`
under the cell's limits, as a run's would.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 ... \\
        [--seconds S] [--faults half_batch altered_answer ...] [--out FILE]

On the card, at the cell's own sizes: the set-up and checks of a run, with
a window of `--seconds` (0: only as long as the check needs, the frames to
check or one chunk of steps).  A training cell's steps after the window
start from the state the window left, so their readings are taken with
the cell's own window.  One JSON line a seed on standard
output (and appended to FILE): seed, program (name -> number), control
(name -> number), program_correct, control_correct, and with faults,
faults (fault -> name -> number) and faults_correct (fault -> correct)."""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from benchmark import harness

    harness.pin_caches()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card visible", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        out = harness.run_cell(spec, seed, args.seconds, False, dev, time.time(),
                               control=True)
        lim = {n: lim for n, _, lim in out.checks}
        ctl = out.record["control"]
        line = {"seed": seed, "program": {n: v for n, v, _ in out.checks}, "control": ctl,
                "program_correct": harness.is_correct(out.checks),
                # the control in the program's place: its numbers where it has them
                "control_correct": harness.is_correct(
                    [(n, ctl.get(n, v), lim[n]) for n, v, _ in out.checks]),
                "setup_s": out.e2e["setup_s"], "attempted": out.attempted}
        if args.faults:
            runs = {f: harness.run_cell(spec, seed, args.seconds, False, dev, time.time(),
                                        [f]).checks for f in args.faults}
            line["faults"] = {f: {n: v for n, v, _ in c} for f, c in runs.items()}
            line["faults_correct"] = {f: harness.is_correct(c) for f, c in runs.items()}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
