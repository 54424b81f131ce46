"""BENCHMARK.json against the benchmark's contract: keys, names, units,
and every name found as a file of the harness."""
import json
import re

import pytest

from tiny import BENCH, ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
M = json.loads((ROOT / "BENCHMARK.json").read_text())
# BENCHMARK.json, and with the entries of the cells not yet enrolled
BOTH = pytest.mark.parametrize("M", [M, manifest()],
                               ids=["enrolled", "with_pending"])


def line_ok(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert 1 <= len(M["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in M["paths"])
    assert len(M["command"]) <= 32 and all(line_ok(w) for w in M["command"])
    assert (ROOT / M["command"][1]).is_file()


@BOTH
def test_configs(M):
    assert 1 <= len(M["configs"]) <= 24
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert c["file"].startswith("benchmarks/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])


@BOTH
def test_workloads_have_their_files(M):
    cells = M["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line_ok(w["why"])
        spec = json.loads((BENCH / "workloads" / f"{w['name']}.json")
                          .read_text())
        assert spec["config"] == w["config"] and spec["why"] == w["why"]
        assert (BENCH / "portbench" / "entries"
                / f"{spec['entry']}.py").is_file()
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


@BOTH
def test_metrics(M):
    e2e, per = M["end_to_end"], M["per_layer"]
    names = [m["name"] for m in e2e + per]
    assert len(names) == len(set(names))
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    cells = {w["name"] for w in M["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in e2e if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line_ok(m["layer"])
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        moved = [x for x in e2e if x["name"] == m["moves"]][0]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", cells)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells


@BOTH
def test_every_cell_reports_enough(M):
    e2e, per = M["end_to_end"], M["per_layer"]
    for w in M["workloads"]:
        reported = [m["name"] for m in e2e
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in per)
