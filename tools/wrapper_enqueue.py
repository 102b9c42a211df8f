"""The host's enqueue of the kernel wrappers' public calls on the CUDA card,
for any checkout of the repository.

    python3 tools/wrapper_enqueue.py [TREE]

imports ``audian_torch`` from ``TREE`` (a checkout; this one by default),
builds its kernels, and prints one JSON object: the microseconds a call of
``x + 1``, ``copy_add1`` and ``copy_pm_add1`` on 16 x 4096 float32 and of
``window_matmul`` on 16 x 65536 float32 (256 taps, 64 outputs, stride 64,
its split held as a bank's owner holds it) take on the host,
``perf_counter`` over ``CALLS`` calls with no synchronize inside, the
median of ``ROUNDS`` rounds.  It uses the wrappers' public names and its
own timing loop only, so that an older tree's wrappers can be timed in the
same call as this one's (``tools/probe_copy_trials.py --parent-tree``).
"""

import json
import sys
import time
from pathlib import Path

C, T = 16, 4096
CALLS = 2000
ROUNDS = 5


def host_us(torch, fn):
    """The median over ROUNDS of the host's microseconds a call of fn."""
    fn()
    out = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        a = time.perf_counter()
        for _ in range(CALLS):
            fn()
        out.append((time.perf_counter() - a) / CALLS * 1e6)
    torch.cuda.synchronize()
    return sorted(out)[len(out) // 2]


def main():
    tree = Path(sys.argv[1] if len(sys.argv) > 1 else
                Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("wrapper_enqueue: CUDA is not available", file=sys.stderr)
        return 2
    from audian_torch.ops.cuda import probes as P
    from audian_torch.ops.cuda.window_matmul import BankSplit, window_matmul

    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.randn((C, T), generator=gen, device=dev)
    xpm = x.reshape(1, C, T)
    xw = torch.randn((C, 1 << 16), generator=gen, device=dev)
    w = torch.randn((256, 64), generator=gen, device=dev)
    split = BankSplit()
    nframes = ((1 << 16) - 256) // 64 + 1
    out = {
        "x + 1": host_us(torch, lambda: x + 1.0),
        "copy_add1": host_us(torch, lambda: P.copy_add1(x, T)),
        "copy_pm_add1": host_us(torch, lambda: P.copy_pm_add1(xpm)),
        "window_matmul": host_us(torch, lambda: window_matmul(
            xw, w, 64, nframes, split=split)),
    }
    print(json.dumps({"tree": str(tree), "host_us": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
