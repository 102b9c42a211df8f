"""Time the window_matmul kernel with three forms of its split of A.

``split_fast`` in ``audian_torch/csrc/window_matmul.cu`` splits each
premapped input value into TF32 hi and lo between the kernel's ``wgmma``s.
This script builds the kernel three times, each with another body of that
function, and times each build on the three per-stage ``bioacoustics``
stages (filter, rectified envelope, PSD) at 16 ch x 2^20 float32, as lone
calls and 10 calls back to back, in the order A B C C B A, twice:

- ``truncated lo``: the source as it stands (lo left for the tensor cores
  to truncate);
- ``rounded lo``: lo rounded as hi is (an earlier form, which turns some
  NaNs into finite values);
- ``rounded lo, NaN kept``: the same with hi of a NaN set to the canonical
  NaN.

Each build is also held against ``window_matmul_plain`` (1e-5 of the
output scale) and on an input holding a NaN and an infinity, where it
must leave the plain version's non-finite outputs and no others; the
script prints what each build does there.  It needs one CUDA card and
``nvcc``; the builds go to ``build/split_ab/`` beside the package.

    python3 tools/window_matmul_split_ab.py
"""

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from audian_torch.models import get_preset  # noqa: E402
from audian_torch.ops.cuda import _build  # noqa: E402
from audian_torch.ops.cuda import window_matmul as wmm  # noqa: E402

CSRC = ROOT / "audian_torch" / "csrc"
OUT = ROOT / "build" / "split_ab"
HI = "(__float_as_uint(x) + 0x1000u) & 0xFFFFE000u"
LO_ROUNDED = "(__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u"
VARIANTS = {
    "truncated lo": None,
    "rounded lo": f"  hi = {HI};\n  lo = {LO_ROUNDED};\n",
    "rounded lo, NaN kept": (f"  hi = x == x ? {HI} : 0x7FFFFFFFu;\n"
                             f"  lo = {LO_ROUNDED};\n"),
}
CALLS = 10


def source(body):
    """window_matmul.cu with ``split_fast``'s body replaced by ``body``."""
    text = (CSRC / "window_matmul.cu").read_text()
    if body is None:
        return text
    pat = re.compile(r"(void split_fast\(float x, uint32_t& hi,\s*"
                     r"uint32_t& lo\) \{\n)(.*?)(\}\n)", re.S)
    new, n = pat.subn(lambda m: m.group(1) + body + m.group(3), text)
    if n != 1:
        raise RuntimeError("split_fast not found in window_matmul.cu")
    return new


def build():
    """One library a variant (with chain.cu for the error strings), all
    compiled at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for i, (name, body) in enumerate(VARIANTS.items()):
        src = OUT / f"v{i}.cu"
        src.write_text(source(body))
        procs[name] = subprocess.Popen(
            [nvcc, *_build._FLAGS, "-shared", "-I", str(CSRC), "-o",
             str(OUT / f"v{i}.so"), str(src), str(CSRC / "chain.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"v{i}.so"))
        for fn, (args, res) in _build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
        libs[name] = lib
    return libs


def event_ms(fn, calls=1, reps=5):
    """Median CUDA-event time of ``calls`` calls back to back, over
    ``reps`` runs after a warm-up, divided by ``calls``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return sorted(times)[len(times) // 2]


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    libs = build()
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s")
    fc = get_preset("bioacoustics").fused(96000.0, eps=2e-6, device=dev)
    gen = torch.Generator().manual_seed(0)
    C, n = 16, 1 << 20
    x = (0.3 * torch.randn((C, n), generator=gen)).to(dev)
    xf = torch.nn.functional.pad(x, (fc.filt_halo, 0))
    xe = torch.nn.functional.pad(x, (fc.env_halo, fc.env_delay))
    B = fc.block
    stages = {
        "filter": (xf, fc.filt_w, B, -(-n // B), None, "cf"),
        "envelope": (xe, fc.env_w, B, -(-(n + fc.env_delay) // B),
                     "rectify", "cf"),
        "psd": (x, fc.spec_w, fc.hop, (n - fc.nfft) // fc.hop + 1, None,
                "fco"),
    }
    wants = {k: wmm.window_matmul_plain(*a) for k, a in stages.items()}
    bad_x = x[:3, :50001].clone()
    bad_x[0, 1000] = bad_x[2, 49000] = float("nan")
    bad_x[1, 20000] = float("inf")
    bad_args = (bad_x, fc.env_w, 128, 400, "rectify", "cf")
    bad_want = ~torch.isfinite(wmm.window_matmul_plain(*bad_args))
    times = {name: {k: ([], []) for k in stages} for name in libs}
    order = list(libs) + list(libs)[::-1]
    for name in order * 2:
        _build._lib = libs[name]
        for k, args in stages.items():
            held = wmm.BankSplit()

            def run():
                return wmm.window_matmul(*args, split=held)

            got = run()
            want = wants[k]
            err = float((got - want).abs().max() / want.abs().max())
            if err > 1e-5:
                raise RuntimeError(f"{name} {k}: relative error {err:.3e}")
            times[name][k][0].append(event_ms(run))
            times[name][k][1].append(event_ms(run, calls=CALLS))
    for name, lib in libs.items():
        _build._lib = lib
        got = wmm.window_matmul(*bad_args)
        same = bool(torch.equal(~torch.isfinite(got), bad_want))
        lone = sum(min(v[0]) for v in times[name].values())
        lone_max = sum(max(v[0]) for v in times[name].values())
        b2b = sum(min(v[1]) for v in times[name].values())
        b2b_max = sum(max(v[1]) for v in times[name].values())
        print(f"{name}: three stages {lone:.4f}-{lone_max:.4f} ms as lone "
              f"calls, {b2b:.4f}-{b2b_max:.4f} back to back; " + "; ".join(
                  f"{k} {min(v[0]):.4f}/{min(v[1]):.4f}"
                  for k, v in times[name].items())
              + f"; non-finite outputs as the plain version's: {same}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0] if card.stdout else
          torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
