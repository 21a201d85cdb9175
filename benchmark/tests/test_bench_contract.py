"""BENCHMARK.json against the benchmark's contract: its keys, every name,
unit and word against the allowed characters, each file found by name,
the bounds and the run length."""

import json
import re

from benchmark import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTHS = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|proj|head|expan|per_tok)")


def _line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (harness.ROOT / p).is_dir()
    for w in BENCH["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"]), w


def test_run_seconds_fits_the_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)


def test_entries_have_exactly_their_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, want in keys.items():
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == want, e["name"]


def test_configs_found_by_name():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg and not WIDTHS.search(k), k
        assert (harness.BENCH_DIR / "models" / f"{cfg['arch']}.py").is_file()
        assert (harness.BENCH_DIR / "reference" / f"{cfg['arch']}.py").is_file()
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_cells_and_metrics_found_by_name():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for w in BENCH["workloads"]:
        tf = harness.load_json(harness.BENCH_DIR / "traffic" / f"{w['traffic']}.json")
        assert (harness.BENCH_DIR / "drivers" / f"{tf['driver']}.py").is_file()
        ends, per = harness.cell_metrics(BENCH, w["name"])
        assert "setup_s" in {m["name"] for m in ends} and len(ends) >= 2 and per
        for m in per:
            assert m["moves"] in {e["name"] for e in ends}
