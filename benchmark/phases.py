"""The host cost of one program span site (`tngp_torch.utils.profiling.span`):

    python3 benchmark/phases.py --site-cost

prints the host ns of one `with span(...)` site with both sinks off and with
the aggregate on, as one JSON line.  A traced run of the benchmark turns the
aggregate on over its window (`util.HostSpans`), so this is what the spans
add to a traced run's host readings a site.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def site_cost(n: int = 1_000_000) -> dict:
    """Host ns of one `with span(...)` site, both sinks off and with the
    aggregate on, less an empty loop's ns a turn (best of three)."""
    from tngp_torch.utils.profiling import enable_spans, span

    def loop_empty():
        for _ in range(n):
            pass

    def loop_span():
        for _ in range(n):
            with span("tngp.cost"):
                pass

    def best(fn):
        out = []
        for _ in range(3):
            t = time.perf_counter_ns()
            fn()
            out.append(time.perf_counter_ns() - t)
        return min(out) / n

    base = best(loop_empty)
    off = best(loop_span) - base
    enable_spans(True)
    on = best(loop_span) - base
    enable_spans(False)
    return {"site_ns_off": off, "site_ns_aggregate": on, "turns": n}


def main(argv) -> int:
    if argv != ["--site-cost"]:
        print(__doc__, file=sys.stderr)
        return 2
    print(json.dumps(site_cost()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
