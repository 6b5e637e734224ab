"""BENCHMARK.json against the benchmark's contract, and every cell's
files found by name, also a configuration, mix, kind and per-layer
metric that arrive as new files and entries alone."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from rtbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(man):
    assert set(man) == KEYS
    assert 1 <= len(man["command"]) <= 32
    assert all(line(w) for w in man["command"])
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
        assert (harness.ROOT / p).is_dir()
    for w in man["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in man["paths"])
    assert isinstance(man["run_seconds"], int)
    assert 1 <= man["run_seconds"] <= 51
    # the check's time for 24 cells fits its 43,200 s
    n = 24
    runs = 2 + 14 * n
    assert runs * (man["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    assert len(json.dumps(man)) <= 64 * 1024


def test_configs(man):
    names = [c["name"] for c in man["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    files = set()
    used = {w["config"] for w in man["workloads"]}
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in man["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        conf = harness.config(man, c["name"])
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert harness.writer(conf["scene"]["writer"]).write


def test_workloads(man):
    cells = man["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        assert w["chips"] in (1, 4) and line(w["why"])
        mix = harness.mix(w["traffic"])
        assert harness.kind(mix["kind"]).run
        lim = json.loads((harness.BENCH / "limits"
                          / f"{w['name']}.json").read_text())
        assert all(v >= 0 for v in lim.values())


def test_metrics(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert 1 <= len(man["per_layer"]) <= 128
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and line(m["layer"])
        assert m["moves"] in e2e
        assert hasattr(harness.metric_reader(m["name"]), "read")
        for cell in m.get("workloads", []):
            assert harness.applies(e2e[m["moves"]], cell)
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in man["workloads"]:
        got = {m["name"] for m in harness.cell_metrics(man, w["name"],
                                                        False)}
        assert "setup_s" in got and len(got) >= 2
        assert harness.cell_metrics(man, w["name"], True)


def test_new_files_are_found(man, tmp_path):
    """A configuration, mix, kind and per-layer metric added as files and
    entries, with no file edited, are found by name."""
    root = tmp_path / "checkout"
    bench = root / "rtbench"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "configs" / "dummy-box.json").write_text(json.dumps(
        {"source": "https://example.org/box", "reduced": [],
         "scene": {"writer": "cornell", "params": {}},
         "render_config": {"max_depth": 1}}))
    (bench / "mixes" / "dummy-mix.json").write_text(json.dumps(
        {"kind": "dummy", "width": 8, "height": 8}))
    (bench / "kinds" / "dummy.py").write_text(
        "def run(ctx):\n    return {'passes': 7}\n")
    (bench / "metrics" / "dummy_metric.per.py").write_text(
        "def read(record):\n    return record.get('dummy')\n")
    new = json.loads(json.dumps(man))
    new["configs"].append({"name": "dummy-box", "source":
                           "https://example.org/box",
                           "file": "rtbench/configs/dummy-box.json",
                           "reduced": [], "why": "a test"})
    new["workloads"].append({"name": "dummy-box.dummy-mix",
                             "config": "dummy-box", "traffic": "dummy-mix",
                             "chips": 1, "why": "a test"})
    new["per_layer"].append({"name": "dummy_metric.per", "unit": "ms",
                             "better": "lower", "source": "host_clock",
                             "layer": "device", "moves": "setup_s",
                             "workloads": ["dummy-box.dummy-mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    got = harness.manifest(root)
    cell = harness.cell(got, "dummy-box.dummy-mix")
    conf = harness.config(got, cell["config"], root)
    assert conf["render_config"] == {"max_depth": 1}
    mix = harness.mix(cell["traffic"], bench)
    assert harness.kind(mix["kind"], bench).run(None) == {"passes": 7}
    read = harness.read_per_layer(got, cell["name"],
                                  {"dummy": 2.5, "load_s": 1.0}, bench)
    assert read["dummy_metric.per"] == {"value": 2.5, "unit": "ms"}
    assert "load_s" not in read          # it lists the cells it reads
    # the existing cells are unchanged by the additions
    for w in man["workloads"]:
        assert harness.cell_metrics(got, w["name"], True) == \
            harness.cell_metrics(man, w["name"], True)
