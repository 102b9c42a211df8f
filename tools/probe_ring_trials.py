"""Knock-out trials of the two ring kernels of ``csrc/probes.cu``.

``pm_roundtrip_kernel`` and ``select_pm_kernel`` run a persistent grid
whose blocks claim items from a counter and bulk-copy them into a ring of
shared-memory stages.  This script builds ``csrc/probes.cu`` several times,
each copy with one change written into its text, and times every build on
the probes' headline input (16 ch x 2^22 float32, M = 8, blocks of 8192)
beside the PyTorch call that computes the same function (``x + 1`` for the
round trip, one strided ``torch.add`` of the transposed view for the
selection), in turns, as lone calls and 10 calls back to back (device
time: the host's enqueue of one call overlaps the card's work on the one
before):

- ``as built``: the source as it stands;
- ``ring 4 x 4096``, ``ring 2 x 4096``, ``ring 4 x 2048``: the round
  trip's ring of four 16 KB stages (this kernel's first form), two 16 KB,
  four 8 KB (as built: two of 8 KB);
- ``static items``: both kernels walking item ``blockIdx + k gridDim``
  instead of claiming items from the counter;
- ``no relay``: the round trip writing each stage + 1 straight out, with
  no phase-major buffer (not the probe any more: what the relay costs);
- ``no stores``: the round trip relaying and reading back but storing
  nothing (what its loads alone take).

Every build that computes the function is held against it bit for bit
(the round trip) or within 2^-20 max|x| (the selection).  Beside them, the
reference copies of ``tools/probe_ring_copies.cu`` (the same 16-byte
loads and stores launched one-shot, as a persistent grid, and as a
persistent grid that claims tiles), ``torch.amax`` (reads alone) and
``fill_`` (writes alone), and the host's enqueue of each wrapper, of the
bare launcher called through ctypes and of ``x + 1``.  It needs one CUDA
card and ``nvcc``; the builds go to ``build/ring_trials/`` beside the
package, the table also to ``build/ring_trials/trials.json``.

    python3 tools/probe_ring_trials.py
"""

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from audian_torch.ops.cuda import _build  # noqa: E402
from audian_torch.ops.cuda import probes as P  # noqa: E402
from audian_torch.probes._common import card_line, median_ms  # noqa: E402

OUT = ROOT / "build" / "ring_trials"
C, T, N, M = 16, 1 << 22, 8192, 8
REPS = 10
ROUNDS = 3

_RT_CLAIM = ("      for (int s = 0;;) {\n"
             "        const long long it = (long long)atomicAdd(next, 1ULL);")
_RT_STATIC = ("      for (int s = 0, k = 0;; ++k) {\n"
              "        const long long it = blockIdx.x + (long long)k * "
              "gridDim.x;")
_SEL_CLAIM = "        if (lane == 0) it = (long long)atomicAdd(next, 1ULL);"
_SEL_STATIC = "        it = blockIdx.x + (long long)s * gridDim.x;"
_RELAY = """        float* p = pm + ((4 * f) & (M - 1)) * row + q0 + ((4 * f) >> lgm);
        p[0] = v.x + 1.0f;
        p[row] = v.y + 1.0f;
        p[2 * row] = v.z + 1.0f;
        p[3 * row] = v.w + 1.0f;"""
_STRAIGHT = """        reinterpret_cast<float4*>(y + (it / nblk) * T + (it % nblk) * N +
                                  j * sw)[f] =
            make_float4(v.x + 1.0f, v.y + 1.0f, v.z + 1.0f, v.w + 1.0f);"""
_OUT_LOOP = "    for (int f = tid; f < N / 4; f += RT_CONS) {"
_STORE = "      dst[f] = make_float4(p[0], p[row], p[2 * row], p[3 * row]);"
_NO_STORE = ("      if (p[0] == 1234.5f && p[row] == -3.25f)\n"
             "        dst[f] = make_float4(p[0], p[row], p[2 * row], "
             "p[3 * row]);")


def _ring(chunk, ring):
    return [("constexpr int RT_CHUNK = 2048;",
             f"constexpr int RT_CHUNK = {chunk};"),
            ("constexpr int RT_RING = 2;", f"constexpr int RT_RING = {ring};")]


#: name -> (edits of csrc/probes.cu, computes the function)
VARIANTS = {
    "as built": ([], True),
    "ring 4 x 4096": (_ring(4096, 4), True),
    "ring 2 x 4096": (_ring(4096, 2), True),
    "ring 4 x 2048": (_ring(2048, 4), True),
    "static items": ([(_RT_CLAIM, _RT_STATIC), (_SEL_CLAIM, _SEL_STATIC)],
                     True),
    "no relay": ([(_RELAY, _STRAIGHT),
                  (_OUT_LOOP, "    for (int f = tid; f < 0; f += RT_CONS) {")],
                 True),
    "no stores": ([(_STORE, _NO_STORE)], False),
}


def _nvcc(src, out):
    return subprocess.Popen(
        [_build._nvcc(), *_build._FLAGS, "-shared", "-I",
         str(ROOT / "audian_torch" / "csrc"), "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build():
    """Every variant and the reference copies, one nvcc each, all at
    once; the libraries by name."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = (ROOT / "audian_torch" / "csrc" / "probes.cu").read_text()
    procs = {}
    for name, (edits, _) in VARIANTS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the source has no single {old!r}")
            src = src.replace(old, new)
        path = OUT / (name.replace(" ", "_") + ".cu")
        path.write_text(src)
        procs[name] = _nvcc(path, path.with_suffix(".so"))
    procs["copies"] = _nvcc(ROOT / "tools" / "probe_ring_copies.cu",
                            OUT / "copies.so")
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / (name.replace(" ", "_") + ".so")
                                     if name != "copies"
                                     else OUT / "copies.so"))
    for name in VARIANTS:
        for fn, (args, res) in _build._SIGNATURES.items():
            if fn.startswith("probe_"):
                getattr(libs[name], fn).argtypes = args
                getattr(libs[name], fn).restype = res
        # the wrappers' error messages
        libs[name].audian_cuda_error_string = \
            _build.load_library().audian_cuda_error_string
    libs["copies"].ring_copy_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return libs


def times(fn):
    return {"lone": median_ms(fn, reps=REPS),
            "b2b": median_ms(fn, reps=REPS, calls=10)}


def host_us(fn, n=200):
    torch.cuda.synchronize()
    a = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - a) / n * 1e6
    torch.cuda.synchronize()
    return us


def main():
    if not torch.cuda.is_available():
        print("probe_ring_trials: CUDA is not available", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    libs = build()
    dev = torch.device("cuda", 0)
    x = torch.randn((C, T), generator=torch.Generator(dev).manual_seed(0),
                    device=dev)
    view = x.reshape(C, T // P.GROUP, P.GROUP // 8, 8).transpose(2, 3)
    out = torch.empty(view.shape, device=dev)
    y = torch.empty_like(x)
    nxt = torch.zeros(1, dtype=torch.int64, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    copies = libs["copies"].ring_copy_launch
    want_rt = x + 1.0
    want_sel = P.select_pm_add1_plain(x)
    tol = 2.0 ** -20 * float(x.abs().max())

    calls = {
        "x + 1": lambda: x + 1.0,
        "strided add": lambda: torch.add(view, 1.0, out=out),
        "amax (reads)": lambda: torch.amax(x),
        "fill_ (writes)": lambda: y.fill_(1.0),
    }
    for kind, label in enumerate(("copy one-shot", "copy persistent static",
                                  "copy persistent claimed")):
        calls[label] = (lambda k=kind: copies(k, x.data_ptr(), y.data_ptr(),
                                              x.numel() // 4, sms,
                                              nxt.data_ptr(), stream))
    kernels = {}
    for name, (_, computes) in VARIANTS.items():
        _build._lib = libs[name]
        rt = P.pm_roundtrip_add1(x, N, M)
        sel = P.select_pm_add1(x)
        torch.cuda.synchronize()
        if computes:
            ok = (torch.equal(rt, want_rt)
                  and float((sel - want_sel).abs().max()) <= tol)
            print(f"{name}: {'holds' if ok else 'DIFFERS'}", flush=True)
            if not ok:
                return 1
        kernels[f"round trip, {name}"] = (
            name, lambda: P.pm_roundtrip_add1(x, N, M))
        if name in ("as built", "static items"):
            kernels[f"selection HIGHEST, {name}"] = (
                name, lambda: P.select_pm_add1(x))
            kernels[f"selection DEFAULT, {name}"] = (
                name, lambda: P.select_pm_add1(x, precision="default"))

    rows = {k: {"lone": [], "b2b": []} for k in [*calls, *kernels]}
    for r in range(ROUNDS):
        order = list(calls.items()) + [(k, f) for k, (_, f) in
                                       kernels.items()]
        for label, fn in (order if r % 2 == 0 else order[::-1]):
            lib = kernels.get(label, (None,))[0]
            if lib is not None:
                _build._lib = libs[lib]
            t = times(fn)
            for k in ("lone", "b2b"):
                rows[label][k].append(t[k])
    _build._lib = libs["as built"]
    host = {"x + 1": host_us(calls["x + 1"]),
            "pm_roundtrip_add1": host_us(
                lambda: P.pm_roundtrip_add1(x, N, M)),
            "select_pm_add1": host_us(lambda: P.select_pm_add1(x)),
            "bare launcher (ctypes)": host_us(
                lambda: libs["as built"].probe_select_pm_add1_launch(
                    x.data_ptr(), y.data_ptr(), C, T, 0, nxt.data_ptr(),
                    stream))}
    torch.cuda.synchronize()
    bound = 8 * x.numel() / 3.35e12 * 1e3
    print(f"ms over {ROUNDS} rounds (lone calls | 10 back to back); the "
          f"bytes bound {bound:.4f} ms  [{card}]")
    for label, t in rows.items():
        print(f"  {label:36s} " + " ".join(f"{v:.4f}" for v in t["lone"])
              + " | " + " ".join(f"{v:.4f}" for v in t["b2b"]), flush=True)
    print("  host enqueue (us a call): " + ", ".join(
        f"{k} {v:.1f}" for k, v in host.items()))
    (OUT / "trials.json").write_text(json.dumps(
        {"card": card, "bound_ms": bound, "ms": rows, "host_us": host},
        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
