"""The controls on the card: each cell with the next precision below the
configuration's float32 in the program's place (the chain and the
detector's envelope at their one-TF32-pass rung, the scrub's windows and
tiles from the reference in TF32) reads ``correct`` false on three seeds.

By default at a size a test run holds (a tenth of an hour, a 20 s
window); ``PORTBENCH_FULL=1`` runs the cells' own sizes.  Each seed's
numbers are printed as one JSON line.  On the card:

    python3 -m pytest -p no:cacheprovider --confcutdir=portbench -m card -s \\
        portbench/tests/test_portbench_card.py
"""

import json
import os
from pathlib import Path

import pytest
import torch

from portbench import core

ROOT = Path(__file__).resolve().parents[2]
BENCH = core.load_benchmark(ROOT)
SEEDS = (2**31 + 101, 2**32 + 202, 3 * 2**31 + 303)
SMALL = {
    "chain-hour": {"traffic": {"recording_s": 360.0}},
    "detect-hour": {"traffic": {"recording_s": 360.0}},
    "scrub-window": {"config": {"buffer_s": 20.0, "back_s": 5.0}},
}


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    full = os.environ.get("PORTBENCH_FULL") == "1"
    for seed in SEEDS:
        res = core.run_cell(BENCH, cell, seed, 3.0, 0, "cuda:0", ROOT,
                            variant="control",
                            overrides=None if full else SMALL[cell])
        print(json.dumps({"cell": cell, "seed": seed, "full": full,
                          "correct": res["correct"],
                          "checks": res["checks"]}))
        assert not res["correct"], res["checks"]
