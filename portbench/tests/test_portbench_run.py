"""Whole runs of the harness without a card: the command refuses to run,
no process of it holds JAX or the JAX package, and each cell, driven on the
CPU at a tiny size past the look for a card, reads ``correct`` true as it
stands and false with its timed path broken underneath."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import core

ROOT = Path(__file__).resolve().parents[2]
BENCH = core.load_benchmark(ROOT)
SEED = 2**33 + 12345

#: each cell at a size the CPU runs in seconds: fewer channels, a shorter
#: recording; the scrub at 24 kHz with a 1.5 s window
TINY = {
    "chain-hour": {"config": {"channels": 4},
                   "traffic": {"recording_s": 1.0, "chunk_frames": 1 << 15}},
    "detect-hour": {"config": {"channels": 4},
                    "traffic": {"recording_s": 2.0,
                                "chunk_frames": 1 << 16}},
    "scrub-window": {"config": {"channels": 2, "rate_hz": 24000,
                                "lowpass_hz": 10000.0, "buffer_s": 1.5,
                                "back_s": 0.5},
                     "traffic": {"recording_s": 10.0, "view_s": [4.0, 4.5],
                                 "cutoffs_hz": [8000.0, 10000.0],
                                 "check_from": 2, "check_steps": 1}},
}

IMPORTS = """
import sys
sys.path.insert(0, {root!r})
from portbench import core
bench = core.load_benchmark({root!r})
for w in bench["workloads"]:
    cell = core.Cell(bench, w["name"], {root!r})
    cell.generator(), cell.reference()
    for m in cell.per_layer:
        core.load_module("metrics", m["name"])
import audian_torch.models, audian_torch.analysis.events
import audian_torch.ops.cuda.chain, audian_torch.ops.cuda.envdet
import audian_torch.data, audian_torch.view.render, audian_torch.utils.trace
print(sorted({{m.split(".")[0] for m in sys.modules}} & set(core.FORBIDDEN)))
"""


def test_no_jax_in_the_harness_and_what_it_loads():
    out = subprocess.run([sys.executable, "-c",
                          IMPORTS.format(root=str(ROOT))],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def command(cwd, workload="chain-hour"):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = command(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_command_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def tiny_run(cell, monkeypatch):
    import audian_torch.analysis.events as events

    if cell == "detect-hour":
        monkeypatch.setattr(events, "_CHUNK",
                            TINY[cell]["traffic"]["chunk_frames"])
    return core.run_cell(BENCH, cell, SEED, 0.2, 0, "cpu", ROOT,
                         overrides=TINY[cell])


@pytest.mark.parametrize("cell", list(TINY))
def test_sound_run_is_correct(cell, monkeypatch):
    res = tiny_run(cell, monkeypatch)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    names = {m["name"] for m in BENCH["end_to_end"] if core.reports(
        m, {"name": cell})}
    assert set(res["metrics"]) == names
    assert all(v["value"] > 0 for v in res["metrics"].values())


# -- faults planted under the timed path ------------------------------------

def _altered(out):
    out[0][0, out[0].shape[1] // 2] += 1e-3
    return out


def _half(out):
    C = out[0].shape[0]
    out[0][C // 2 :] = 0
    out[1][C // 2 :] = 0
    out[2][:, C // 2 :] = 0
    for v in out[3].values():
        v[C // 2 :] = 0
    return out


def chain_fault(kind, monkeypatch):
    from audian_torch.ops.fused import FusedChainCF

    real = FusedChainCF.chain_cf
    prev = {}

    def broken(self, x_ext, n, stats=False, outputs=None):
        out = real(self, x_ext, n, stats=stats)
        if kind == "unchanged":
            # the output of the last call of the shape, not this one's
            out, prev[n] = prev.get(n, out), out
            return out
        return _altered(out) if kind == "altered" else _half(out)

    monkeypatch.setattr(FusedChainCF, "chain_cf", broken)


def detect_fault(kind, monkeypatch):
    from audian_torch.ops.cuda.envdet import EnvDetKernel

    real = EnvDetKernel.__call__
    prev = []

    def broken(self, xw, off0):
        env = real(self, xw, off0)
        if kind == "unchanged":
            prev.append(env)
            return prev.pop(0) if len(prev) > 1 else env
        if kind == "altered":
            env[env.shape[0] // 2, 0] += 1e-3 * env.abs().max()
        else:
            env[:, env.shape[1] // 2 :] = 0
        return env

    monkeypatch.setattr(EnvDetKernel, "__call__", broken)


def scrub_fault(kind, monkeypatch):
    from audian_torch.data.data import Trace
    from audian_torch.graph.nodes import FilterNode
    from audian_torch.view.render import TraceTiler

    if kind == "unchanged":
        real = Trace.update

        def broken(self, **kwargs):
            if "lowpass_cutoff" in kwargs and len(kwargs) == 1:
                return None
            return real(self, **kwargs)

        monkeypatch.setattr(Trace, "update", broken)
    elif kind == "altered":
        real = TraceTiler.tile

        def broken(self, trace, t0, t1, channel=None):
            times, vals = real(self, trace, t0, t1, channel)
            vals = vals.copy()
            vals[len(vals) // 2] += 1e-3
            return times, vals

        monkeypatch.setattr(TraceTiler, "tile", broken)
    else:
        real = FilterNode.compute

        def broken(self, source, lead, n_out, params):
            y = real(self, source, lead, n_out, params)
            y[:, y.shape[1] // 2 :] = 0
            return y

        monkeypatch.setattr(FilterNode, "compute", broken)


FAULTS = {"chain-hour": chain_fault, "detect-hour": detect_fault,
          "scrub-window": scrub_fault}


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", list(TINY))
def test_broken_run_is_not_correct(cell, kind, monkeypatch):
    FAULTS[cell](kind, monkeypatch)
    res = tiny_run(cell, monkeypatch)
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0



@pytest.mark.parametrize("values, want", [([1.0, 3.0, 2.0], 3.0),
                                          ([1.0, float("nan")], None)])
def test_a_number_reads_its_worst_sample(values, want):
    got = core.worst(values)
    assert got == want if want is not None else got != got
    assert core.judge({"x": {"limit": 2.5}}, {"x": got})[0] is False
