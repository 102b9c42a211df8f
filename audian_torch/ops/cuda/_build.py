"""Build the CUDA kernels from ``audian_torch/csrc/*.cu`` and load them.

``nvcc`` compiles each source for ``sm_90a`` (one process a source, all
started together, with ``csrc/`` on the include path) and links the
objects into one shared library with a plain C interface, at first use,
into ``build/audian_torch/<source-hash>/libaudian_torch_kernels.so`` beside
the package.  The hash covers the sources, the shared headers
(``csrc/*.cuh``) and the flags, so an edit to any of them rebuilds and an
unchanged tree reuses the library.  The library is loaded with
ctypes; nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SMEM_LIMIT", "build_dir", "check", "count_launch",
           "library_path", "load_library", "ptxas_report"]

#: shared memory one block may use on Hopper (232,448 bytes); above 48 KB
#: the launchers opt in with cudaFuncSetAttribute
SMEM_LIMIT = 232448

_PKG = Path(__file__).resolve().parents[2]
_CSRC = _PKG / "csrc"
_LIBNAME = "libaudian_torch_kernels.so"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "audian_cuda_error_string": ([_I], ctypes.c_char_p),
    "chain_tile_max": ([], _I),
    "chain_tap_pad": ([], _I),
    "chain_warps": ([], _I),
    "chain_smem_bytes": ([_I, _I, _I, _I, _I, _I, _I], _LL),
    "chain_launch": ([_P, _I, _LL, _I, _LL, _P, _I, _P, _I, _I, _I, _I, _I,
                      _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                      _P], _I),
    "window_matmul_scratch_words": ([_I, _I], _LL),
    "window_matmul_launch": ([_P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I,
                              _P, _P, _P], _I),
    "conv_probe_launch": ([_P, _I, _P, _I, _I, _I, _P, _P, _P], _I),
    "conv_rate_launch": ([_P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P], _I),
    "envdet_tile_max": ([], _I),
    "envdet_tile_min": ([], _I),
    "envdet_smem_bytes": ([_I, _I, _I, _I], _LL),
    "envdet_launch": ([_P, _I, _LL, _I, _P, _I, _I, _P, _I, _I, _I, _I, _I,
                       _I, _P, _P], _I),
}

_lock = threading.Lock()
_lib = None
#: guards the wrappers' launch counters, which threads share
_count_lock = threading.Lock()


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def build_dir():
    """The directory of the library for the current sources, headers and
    flags."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sorted([*_CSRC.glob("*.cu"), *_CSRC.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return _PKG.parent / "build" / "audian_torch" / digest.hexdigest()[:16]


def library_path():
    """The kernel library's path for the current sources and flags."""
    return build_dir() / _LIBNAME


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _run(cmds, log):
    """Run the commands at once, appending each one's output to ``log``;
    raise if any fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    log.extend(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))
    for proc, o in zip(procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{o}")


def _build(out):
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [out.with_name(f"{src.stem}.{tag}.o") for src in _sources()]
    tmp = out.with_name(f"{out.name}.{tag}")
    log = []
    try:
        _run([[nvcc, *_FLAGS, "-I", str(_CSRC), "-c", "-o", str(obj),
               str(src)]
              for src, obj in zip(_sources(), objs)], log)
        _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]], log)
        os.replace(tmp, out)
    finally:
        (out.parent / "nvcc.log").write_text("".join(log))
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)


def load_library():
    """The kernel library, built first if needed (thread-safe, once per
    process)."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
        return _lib


def ptxas_report():
    """What ``ptxas -v`` said about each kernel in the last build (registers,
    shared memory, spills), or '' when the library was built elsewhere."""
    log = build_dir() / "nvcc.log"
    return log.read_text() if log.exists() else ""


def check(code, what):
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = load_library().audian_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def count_launch(wrapper):
    """Add one to ``wrapper.launches`` (thread-safe: the per-device
    workers of :func:`audian_torch.parallel.map_files` launch at once)."""
    with _count_lock:
        wrapper.launches += 1
