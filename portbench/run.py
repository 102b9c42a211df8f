"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n>
        --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``audian_torch``.  It makes the
cell's inputs from the seed, sets up and warms up, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output: the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics from a
``torch.profiler`` trace of the window.  It needs a CUDA card and exits
non-zero, printing no result, without one.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    # build and kernel caches at fixed paths inside the checkout (the
    # port's own kernels build into build/audian_torch/<hash>/ there)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    # the checkout's root, not this folder, leads the path: the harness's
    # modules are imported as portbench.<name>
    here = ROOT / "portbench"
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != here]
    from portbench import core

    return core.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
