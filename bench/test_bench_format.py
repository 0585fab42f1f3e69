"""``BENCHMARK.json`` resolves to files under ``bench/`` and keeps to its
format: names, units and sizes, one reader a metric, one file a
configuration and traffic mix, and a window short enough that 24 cells,
14 runs each, are measured within 43,200 s."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"]), word
            assert (ROOT / word).is_file()


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries_have_their_keys_and_names(group):
    for e in BENCH[group]:
        extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
        assert KEYS[group] <= set(e) <= KEYS[group] | extra, e
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e and k != "source" or (k == "source" and group == "configs"):
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))


def test_metrics_units_sources_and_bounds():
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_configurations_cells_and_traffic_resolve():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert set(configs) == used and 1 <= len(configs) <= 24
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for c in configs.values():
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("bench/")
        cfg = json.loads(path.read_text())
        assert (ROOT / "bench" / "systems" / f"{cfg['system']}.py").is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs)) and 1 <= len(pairs) <= 24
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_set_up_another_end_to_end_metric_and_a_layer(cell):
    def reports(m):
        return cell in m.get("workloads", [cell])

    e2e = [m["name"] for m in BENCH["end_to_end"] if reports(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reports(m) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        if reports(m):
            mover = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
            assert reports(mover), (m["name"], cell)


def test_window_fits_the_check_with_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
