"""One run of one cell: find its configuration, traffic, reference, limits
and per-layer metrics by the names in ``BENCHMARK.json``, let the traffic's
generator set up, measure and check, and assemble the result line.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by name:

- ``configs/<config>.json`` (the ``file`` of the configuration's entry)
  and ``reference/<config>.py``, its plain reference;
- ``traffic/<traffic>.json``, whose ``generator`` names
  ``generators/<generator>.py``;
- ``limits/<cell>.json``, the limit of each number the cell compares;
- ``metrics/<metric>.py`` for each per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
#: modules that no process of the benchmark may hold, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "audian_tpu")


def load_benchmark(root):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_module(kind, name):
    """``<kind>/<name>.py`` of the harness as the module
    ``portbench.<kind>.<name>`` (the name's dots and dashes made
    underscores)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(HERE)}")
    importlib.import_module(f"portbench.{kind}")
    mod = f"portbench.{kind}." + name.replace(".", "_").replace("-", "_")
    if mod in sys.modules:
        return sys.modules[mod]
    spec = importlib.util.spec_from_file_location(mod, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod] = module
    spec.loader.exec_module(module)
    return module


def read_json(kind, name):
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(HERE)}")
    return json.loads(path.read_text())


def reports(metric, cell):
    """Whether ``cell`` reports ``metric`` (an entry of ``end_to_end`` or
    ``per_layer``)."""
    return cell["name"] in metric.get("workloads", [cell["name"]])


class Cell:
    """A cell's entries and files, by the names in the benchmark."""

    def __init__(self, bench, workload, root):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r}; the benchmark has "
                           f"{', '.join(cells)}")
        self.entry = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads(
            (Path(root) / self.config_entry["file"]).read_text())
        self.traffic = read_json("traffic", self.entry["traffic"])
        self.limits = read_json("limits", workload)
        self.end_to_end = [m for m in bench["end_to_end"]
                           if reports(m, self.entry)]
        self.per_layer = [m for m in bench["per_layer"]
                          if reports(m, self.entry)]

    def generator(self):
        return load_module("generators", self.traffic["generator"])

    def reference(self):
        return load_module("reference", self.entry["config"])


def process_age():
    """Seconds since this process started (``/proc``), or ``None``."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


class Run:
    """What a generator works with: the cell, the seed, the window's length,
    the device, the variant (``program``, or ``control``: the next
    precision below the configuration's in the program's place), and the
    records the metrics read."""

    def __init__(self, cell, seed, seconds, trace, device, t_start,
                 variant="program", overrides=None):
        self.cell = cell
        self.config = dict(cell.config, **(overrides or {}).get("config",
                                                                 {}))
        self.traffic = dict(cell.traffic, **(overrides or {}).get("traffic",
                                                                  {}))
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.cuda = str(device).startswith("cuda")
        self.variant = variant
        self.rng = np.random.default_rng(self.seed % (1 << 63))
        self._t_start = t_start
        self.setup_s = None
        #: what the metrics read: host seconds by name, the sizes of the
        #: window's calls by kind, the program's spans by kind
        self.host = {}
        self.calls = {}
        self.spans = {}
        self.memory_peak = 0

    def setup_done(self):
        """Mark the end of set-up (the first timed step comes next)."""
        self.sync()
        age = process_age()
        self.setup_s = (age if age is not None
                        else time.perf_counter() - self._t_start)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def read_peak(self):
        """The window's peak device memory, read before the references
        run."""
        if self.cuda:
            self.memory_peak = int(torch.cuda.max_memory_allocated(
                self.device))

    def free(self):
        """Hand the cached blocks of freed program state back (before the
        references run)."""
        if self.cuda:
            torch.cuda.empty_cache()

    def record(self, name, value):
        self.host.setdefault(name, []).append(value)


def worst(values):
    """The largest of the samples' readings of a number, NaN if any is."""
    values = list(values)
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def judge(limits, checks):
    """``(correct, lines)``: every number compared (the worst of the
    samples) against its limit."""
    ok = True
    out = {}
    for name, value in checks.items():
        if name not in limits:
            raise KeyError(f"no limit for the compared number {name!r}")
        lim = float(limits[name]["limit"])
        good = math.isfinite(value) and value <= lim
        ok &= good
        out[name] = {"value": value, "limit": lim}
    missing = set(limits) - set(checks)
    if missing:
        raise KeyError(f"numbers not compared: {sorted(missing)}")
    return ok, out


def run_cell(bench, workload, seed, seconds, trace, device, root,
             t_start=None, variant="program", overrides=None):
    """Run one cell and return the result line's dict (without the device
    description, which :func:`main` adds)."""
    cell = Cell(bench, workload, root)
    r = Run(cell, seed, seconds, trace, device,
            time.perf_counter() if t_start is None else t_start, variant,
            overrides)
    out = cell.generator().run(r)
    samples = out["samples"]
    names = dict.fromkeys(k for s in samples for k in s)
    correct, checks = judge(cell.limits, {
        k: worst(s[k] for s in samples if k in s) for k in names})
    failed = sum(any(not v <= checks[k]["limit"] for k, v in s.items())
                 for s in samples)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = load_module("metrics", m["name"]).read(r, out["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(out["e2e"], setup_s=r.setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(failed), "metrics": metrics,
              "memory_peak_bytes": r.memory_peak}
    if trace and out["trace"] is not None:
        t = out["trace"]
        result["busy_s"], result["window_s"] = t.busy_s, t.window_s
        result["breakdown"] = t.breakdown
    result["checks"] = checks
    return result


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(args, t_start):
    root = HERE.parent
    bench = load_benchmark(root)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips[args.workload]:
        print(f"portbench: the cell needs {chips[args.workload]} CUDA "
              f"card(s); this machine has {have}", file=sys.stderr)
        return 3
    res = run_cell(bench, args.workload, args.seed, args.seconds,
                   args.trace, "cuda:0", root, t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)}",
              file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips[args.workload],
              "memory_peak_bytes": res.pop("memory_peak_bytes")}
    for key in ("busy_s", "window_s"):
        if key in res:
            device[key] = res.pop(key)
    checks = res.pop("checks")
    line = dict(res, device=device, checks=checks)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0
