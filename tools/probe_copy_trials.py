"""Trials of the probes' device copies ``copy_add1`` and ``copy_pm_add1``
(``csrc/probes.cu``: both run ``copy_flat_kernel``) and of the kernel
wrappers' host enqueue.

Device time: ``csrc/probes.cu`` is built several times, each copy with
one change written into its text (the vectors a thread ``COPY_U``, the
threads a block ``COPY_NT``, streaming cache hints on the loads and
stores), and with ``--baseline`` another source (e.g. an older
``probes.cu``) beside them.  Every build runs both copies in turns with
the PyTorch call that computes the same function (``x + 1``, ``xpm + 1``
on the program-major tensor): call, kernel, kernel, call, each the median
of ``REPS`` runs of a lone call and of ``CALLS`` calls back to back (the
card's time: the host's enqueue of a call overlaps the work of the one
before), over ``ROUNDS`` rounds.  Shapes: 16 ch x 2^22 float32 in blocks
of 8192 (the probes' headline) and 16 ch x 2^20 (the call-scaling sweep's
smallest).  Every build is held bit for bit against ``x + 1`` first.

Host enqueue: the microseconds a call of each step of a wrapper takes on
a small tensor (16 x 4096 float32), ``perf_counter`` over ``HOST_CALLS``
calls with no synchronize inside, the median of ``HOST_ROUNDS`` rounds:
the bare launcher through ctypes, each piece a wrapper adds to it (the
shared launch path's, ``_build.launch``, beside the forms it replaced),
the whole wrappers, and ``x + 1``.

With ``--parent-tree`` another checkout (e.g. the parent commit's,
unpacked into a directory that ``.gitignore`` lists): the wrappers' public
calls timed on the host by ``tools/wrapper_enqueue.py`` in that tree and
in this one, in turns (parent, this, this, parent), one process each.

It needs one CUDA card and ``nvcc``; the builds go to
``build/copy_trials/`` beside the package, the table also to
``build/copy_trials/trials.json``.

    python3 tools/probe_copy_trials.py [--baseline OLD_PROBES_CU]
                                       [--parent-tree OLD_CHECKOUT]
"""

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from audian_torch.ops.cuda import _build  # noqa: E402
from audian_torch.ops.cuda import probes as P  # noqa: E402
from audian_torch.probes._common import (card_line, host_us,  # noqa: E402
                                         median_ms)

OUT = ROOT / "build" / "copy_trials"
C, N = 16, 8192
SIZES = (1 << 22, 1 << 20)
REPS = 10
CALLS = 10
ROUNDS = 3
HOST_T = 4096
HOST_CALLS = 2000
HOST_ROUNDS = 5

_U = "constexpr int COPY_U = 4;"
_NT = "constexpr int COPY_NT = 256;"
_LOAD = "  return __ldcs(p);"
_STORE = "  __stcs(p, v);"
_LOAD_NC = """  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;"""

#: name -> edits of csrc/probes.cu (as built: 4 vectors a thread, 256
#: threads a block, __ldcs / __stcs)
VARIANTS = {
    "as built": [],
    "plain loads and stores": [(_LOAD, "  return *p;"),
                               (_STORE, "  *p = v;")],
    "ld.nc no_allocate": [(_LOAD, _LOAD_NC)],
    "U 1": [(_U, _U.replace("4", "1"))],
    "U 2": [(_U, _U.replace("4", "2"))],
    "U 8": [(_U, _U.replace("4", "8"))],
    "NT 128": [(_NT, _NT.replace("256", "128"))],
    "NT 128, U 1": [(_NT, _NT.replace("256", "128")),
                    (_U, _U.replace("4", "1"))],
    "NT 512": [(_NT, _NT.replace("256", "512"))],
}


def _nvcc(src, out):
    return subprocess.Popen(
        [_build._nvcc(), *_build._FLAGS, "-shared", "-I",
         str(ROOT / "audian_torch" / "csrc"), "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(baseline):
    """Every variant (and the baseline source), one nvcc each, all at once;
    the libraries by name."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = (ROOT / "audian_torch" / "csrc" / "probes.cu").read_text()
    sources = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the source has no single {old!r}")
            src = src.replace(old, new)
        sources[name] = src
    if baseline:
        sources["baseline"] = Path(baseline).read_text()
    procs = {}
    for name, src in sources.items():
        path = OUT / (re.sub(r"\W+", "_", name) + ".cu")
        path.write_text(src)
        procs[name] = (_nvcc(path, path.with_suffix(".so")),
                       path.with_suffix(".so"))
    libs = {}
    errors = _build.load_library().audian_cuda_error_string
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, (args, res) in _build._SIGNATURES.items():
            if fn.startswith("probe_") and hasattr(lib, fn):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
        lib.audian_cuda_error_string = errors
        libs[name] = lib
    return libs


def host_steps(dev, lib):
    """Each piece of a copy wrapper's enqueue alone (the shared launch
    path's and the forms it replaced), the bare launcher, the wrappers and
    ``x + 1``: microseconds a call."""
    x = torch.randn((C, HOST_T), device=dev)
    xpm = x.reshape(1, C, HOST_T)
    y = torch.empty_like(x)
    xp, yp = x.data_ptr(), y.data_ptr()
    stream = _build.stream(dev)
    bare = lib.probe_copy_add1_launch

    def counted():
        pass

    counted.launches = 0

    def locked_library():
        with _build._lock:
            return _build._lib

    steps = {
        "x + 1": lambda: x + 1.0,
        "bare launcher (ctypes)": lambda: bare(xp, yp, C, HOST_T, HOST_T,
                                               stream),
        "torch.empty_like": lambda: torch.empty_like(x),
        "x.data_ptr()": lambda: x.data_ptr(),
        "copy_add1's checks": lambda: P._copy_args(x, "copy_add1", 2,
                                                   HOST_T),
        "was: current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "now: _build.stream(dev)": lambda: _build.stream(dev),
        "was: current_device() and a nullcontext":
            lambda: (torch.cuda.current_device(),
                     contextlib.nullcontext().__enter__()),
        "now: torch._C._cuda_getDevice()": torch._C._cuda_getDevice,
        "was: load_library() under the lock": locked_library,
        "now: load_library()": _build.load_library,
        "count_launch (a lock and a count)":
            lambda: _build.count_launch(counted),
        "check(0)": lambda: _build.check(0, "copy"),
        "_build.launch of the bare launcher":
            lambda: _build.launch(counted, "copy", bare, dev, xp, yp, C,
                                  HOST_T, HOST_T),
        "copy_add1 (the wrapper)": lambda: P.copy_add1(x, HOST_T),
        "copy_pm_add1 (the wrapper)": lambda: P.copy_pm_add1(xpm),
    }
    return {k: host_us(f, HOST_CALLS, HOST_ROUNDS)
            for k, f in steps.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another probes.cu to time as "
                    "'baseline' beside the source as built")
    ap.add_argument("--parent-tree", help="another checkout whose wrappers' "
                    "host enqueue is timed in turns with this one's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_copy_trials: CUDA is not available", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    libs = build(args.baseline)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    rows = {}
    for T in SIZES:
        x = torch.randn((C, T), generator=gen, device=dev)
        xpm = x.reshape(C, T // N, N).transpose(0, 1).contiguous()
        want, want_pm = x + 1.0, xpm + 1.0
        tag = f"2^{T.bit_length() - 1}"
        kernels = {}
        for name, lib in libs.items():
            _build._lib = lib
            ok = (torch.equal(P.copy_add1(x, N), want)
                  and torch.equal(P.copy_pm_add1(xpm), want_pm))
            torch.cuda.synchronize()
            print(f"{name} at {tag}: {'holds' if ok else 'DIFFERS'}",
                  flush=True)
            if not ok:
                return 1
            kernels[name] = lib
        pairs = [("copy_add1", lambda: x + 1.0,
                  lambda: P.copy_add1(x, N)),
                 ("copy_pm_add1", lambda: xpm + 1.0,
                  lambda: P.copy_pm_add1(xpm))]
        for r in range(ROUNDS):
            for name, lib in (list(kernels.items()) if r % 2 == 0
                              else list(kernels.items())[::-1]):
                for kname, call, kern in pairs:
                    _build._lib = lib
                    row = rows.setdefault(f"{kname} {tag}, {name}", {})
                    for k, n in (("lone", 1), ("b2b", CALLS)):
                        t = [median_ms(f, reps=REPS, calls=n)
                             for f in (call, kern, kern, call)]
                        row.setdefault(k, []).append(min(t[1:3]))
                        row.setdefault(f"torch {k}", []).append(
                            min(t[0], t[3]))
        del x, xpm, want, want_pm
    _build._lib = libs["as built"]
    host = host_steps(dev, libs["as built"])
    torch.cuda.synchronize()
    turns = []
    if args.parent_tree:
        for tree in (args.parent_tree, ROOT, ROOT, args.parent_tree):
            out = subprocess.run(
                [sys.executable, str(ROOT / "tools" / "wrapper_enqueue.py"),
                 str(tree)], capture_output=True, text=True, check=True,
                timeout=600)
            turns.append(json.loads(out.stdout.strip().splitlines()[-1]))
    bounds = {f"2^{T.bit_length() - 1}": 8 * C * T / 3.35e12 * 1e3
              for T in SIZES}
    print(f"ms over {ROUNDS} rounds, each the faster of two in turns with "
          f"the torch call (x + 1, xpm + 1): the kernel lone | its call lone "
          f"|| the kernel {CALLS} back to back | its call; the bytes bounds "
          f"{bounds}  [{card}]")
    for label, t in rows.items():
        print(f"  {label:40s} " + " || ".join(
            " | ".join(" ".join(f"{v:.4f}" for v in t[k])
                       for k in (mode, f"torch {mode}"))
            for mode in ("lone", "b2b")), flush=True)
    print(f"host enqueue, us a call ({HOST_CALLS} calls on {C} x {HOST_T} "
          f"float32, the median of {HOST_ROUNDS} rounds):")
    for k, v in host.items():
        print(f"  {k:40s} {v:7.2f}")
    if turns:
        print("the wrappers' host enqueue, us a call, in turns (parent, this "
              "tree, this tree, parent; tools/wrapper_enqueue.py):")
        for k in turns[0]["host_us"]:
            print(f"  {k:40s} " + " ".join(
                f"{t['host_us'][k]:7.2f}" for t in turns))
    (OUT / "trials.json").write_text(json.dumps(
        {"card": card, "bound_ms": bounds, "ms": rows, "host_us": host,
         "wrapper_turns": turns}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
