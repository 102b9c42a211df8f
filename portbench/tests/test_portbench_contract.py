"""``BENCHMARK.json`` against the benchmark contract's grammar, and every
configuration, traffic mix, limit file, reference and metric found by its
name, also when a later change adds them as new files."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import core

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}\Z")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    for c in BENCH["configs"]:
        assert set(c) == KEYS["config"]
    for w in BENCH["workloads"]:
        assert set(w) == KEYS["workload"]
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert set(m) - {"workloads"} == KEYS[kind]


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in paths)
            assert (ROOT / w).is_file()


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    metrics = [m["name"] for k in ("end_to_end", "per_layer")
               for m in BENCH[k]]
    for group in (names[: len(BENCH["configs"])],
                  names[len(BENCH["configs"]):], metrics):
        assert len(set(group)) == len(group)
    for n in names + metrics:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and line(w["why"])
    for k in ("end_to_end", "per_layer"):
        for m in BENCH[k]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
            assert m["source"] in SOURCES
    for m in BENCH["per_layer"]:
        assert line(m["layer"])


def test_cells_and_metrics_hang_together():
    configs = {c["name"] for c in BENCH["configs"]}
    cells = {w["name"]: w for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {w["config"] for w in cells.values()} == configs
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in cells.values())
    assert all(w["chips"] in (1, 4) for w in cells.values())
    assert four <= max(len(cells) // 4, 1)
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
        assert set(m.get("workloads", cells)) <= set(cells)
    for name, w in cells.items():
        own = [m for m in e2e.values() if core.reports(m, w)]
        assert len(own) >= 2, name
        assert any(core.reports(m, w) for m in BENCH["per_layer"]), name
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for c in m["workloads"]:
            assert core.reports(e2e[m["moves"]], cells[c])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_run_seconds_fit_the_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_files():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and path.suffix == ".json"
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"]
        assert set(cfg["assumed"]) <= set(cfg)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(cell):
    c = core.Cell(BENCH, cell, ROOT)
    assert c.generator().run
    assert c.reference()
    assert set(c.limits) and all("limit" in v for v in c.limits.values())
    for m in c.per_layer:
        assert core.load_module("metrics", m["name"]).read


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_metric_has_a_reader(metric):
    assert callable(core.load_module("metrics", metric).read)


NEW = {
    "config": {"name": "toy-48k-2ch", "source": "https://example.org/toy",
               "file": "portbench/configs/toy-48k-2ch.json",
               "reduced": [], "why": "a configuration added as files"},
    "workload": {"name": "toy-hour", "config": "toy-48k-2ch",
                 "traffic": "toy-hour", "chips": 1,
                 "why": "a cell added as files"},
    "metric": {"name": "toy_ms", "unit": "ms", "better": "lower",
               "source": "host_clock", "layer": "device",
               "moves": "batch_s_per_rec_h", "workloads": ["toy-hour"]},
}


def test_new_cell_config_and_metric_found_without_edits(tmp_path):
    """A copy of the benchmark gains a configuration, traffic mix, limit
    file, reference and metric as new files and entries; the harness of
    the copy finds them, and no file it had changed."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(NEW["config"])
    bench["workloads"].append(NEW["workload"])
    bench["end_to_end"][0]["workloads"].append("toy-hour")
    bench["per_layer"].append(NEW["metric"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    pb = tmp_path / "portbench"
    (pb / "configs" / "toy-48k-2ch.json").write_text(json.dumps(
        {"name": "toy-48k-2ch", "rate_hz": 48000, "channels": 2,
         "assumed": []}))
    (pb / "reference" / "toy-48k-2ch.py").write_text("SIGN = 1\n")
    (pb / "traffic" / "toy-hour.json").write_text(json.dumps(
        {"generator": "chain_batch", "recording_s": 3600}))
    (pb / "limits" / "toy-hour.json").write_text(json.dumps(
        {"toy_err": {"limit": 1.0}}))
    (pb / "metrics" / "toy_ms.py").write_text(
        "def read(r, trace):\n    return 1.0\n")
    probe = (
        "import json\n"
        "from portbench import core\n"
        "c = core.Cell(core.load_benchmark('.'), 'toy-hour', '.')\n"
        "print(json.dumps([c.config['rate_hz'], c.traffic['generator'],\n"
        "    c.reference().SIGN, sorted(c.limits),\n"
        "    [m['name'] for m in c.per_layer],\n"
        "    [m['name'] for m in c.end_to_end],\n"
        "    core.load_module('metrics', 'toy_ms').read(None, None),\n"
        "    c.generator().__file__]))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                         capture_output=True, text=True, check=True,
                         env={"PYTHONPATH": str(tmp_path),
                              "PATH": "/usr/bin:/bin"})
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got[:4] == [48000, "chain_batch", 1, ["toy_err"]]
    assert got[4] == ["toy_ms"]
    assert got[5] == ["batch_s_per_rec_h", "setup_s"]
    assert got[6] == 1.0
    assert Path(got[7]).resolve() == (pb / "generators" /
                                      "chain_batch.py").resolve()
    for p, data in before.items():
        assert p.read_bytes() == data, p
