"""Strided-window matrix product: ``y[f] = p(x[:, f*S : f*S + K]) @ w``.

The wrapper :func:`window_matmul` launches the CUDA kernel
(``csrc/window_matmul.cu``, the port of
``audian_tpu/ops/pallas/window_matmul.py:_kernel``) on a CUDA tensor and
runs the plain PyTorch version :func:`window_matmul_plain` on a CPU
tensor; any other device raises.  The kernel runs TF32 warpgroup
``wgmma`` products with the frames on M and ``w``'s columns on N, three
passes (3xTF32) at ``precision`` HIGHEST and HIGH, one at DEFAULT (its own
template instance, whose ring carries only ``w``'s hi part): ``w`` split
into its TF32 parts once per bank (:func:`split_w`, held beside the bank
by its owner in a :class:`BankSplit`) and streamed through a ring of
bulk copies, the
input staged as one span a tile of 128 frames (or, where the span does
not fit, as each stage's window rows), the geometry chosen here
(:func:`plan`, whose :func:`smem_bytes` mirrors the kernel's).  It serves
the per-stage form of the fused chain (the Toeplitz filter and envelope
banks and the Hann-DFT analysis matrix), both stages of the IFIR envelope
and the two stages of the song-detection
:class:`audian_torch.ops.envdet.EnvDet` (int16 PCM through the
``"dequant"`` premap, the decimating envelope bank through ``"square"``).
"""

from __future__ import annotations

import math
from collections import namedtuple
from functools import lru_cache

import numpy as np
import torch

from ..raw16 import dequant16
from ..sos import full_fp32
from ._build import SMEM_LIMIT, launch, load_library
from .precision import DEFAULT, HIGHEST, MATMUL_RUNGS
from .precision import check as check_precision

__all__ = ["FRAMES", "PREMAPS", "WIDTHS", "BankSplit", "Plan",
           "column_blocks", "plan", "smem_bytes", "span_shift", "split_w",
           "window_matmul", "window_matmul_plain"]

#: elementwise maps applied to ``x`` while the windows are built: the
#: identity, (pi/2)|v|, the PCM-16 dequantizer (k/2^15 on int16 input,
#: the identity on float32) and v*v
PREMAPS = (None, "rectify", "dequant", "square")
_LAYOUTS = ("fco", "cf")

#: frames a kernel item (``F`` in csrc/window_matmul.cu): two consumer
#: warpgroups of 64
FRAMES = 128
#: the column-block widths the kernel is built for (the N of its wgmmas)
WIDTHS = (128, 136, 176)
#: 8-tap steps a ring stage, taps a window row of rows mode, most stages,
#: the mbarriers (``SPS``, ``ROW_TAPS``, ``RING_MAX``, ``NBAR`` in
#: csrc/window_matmul.cu)
_SPS = 2
_ROW_TAPS = 128
_RING_MAX = 8
_NBAR = 4 + 2 * _RING_MAX
#: the geometry modes (``Mode`` in csrc/window_matmul.cu)
MODES = ("span", "rows")
#: span chunks tried, in bytes (the largest of the fewest bank conflicts
#: wins)
_CHUNK_BYTES = (1024, 512, 256)

#: ``mode``: "span" or "rows"; ``N`` and ``ncb``: the column blocks;
#: ``lsh``: log2 of the span chunk in samples; ``nbuf``: span buffers;
#: ``ring``: ring stages; ``smem``: the block's shared memory in bytes
Plan = namedtuple("Plan", "mode N ncb lsh nbuf ring smem")


def column_blocks(O):
    """``(N, blocks)``: the narrowest width of :data:`WIDTHS` that covers
    ``O`` columns in as few blocks as the widest one does."""
    nb = -(-int(O) // WIDTHS[-1])
    per = -(-int(O) // nb)
    N = next(w for w in WIDTHS if w >= per)
    return N, -(-int(O) // N)


def _geometry(K, O, S, es, N, mode, lsh, nbuf, one=False):
    """``(stage bytes, A-buffer bytes, A buffers)`` as ``geometry`` in
    csrc/window_matmul.cu computes them: a stage holds w's two steps (hi
    and lo, or with ``one`` hi alone), an A buffer a span or, in rows mode,
    128 window rows of a unit's taps."""
    V = -(-int(K) // 8)
    stage = _SPS * (1 if one else 2) * 8 * N * 4
    if mode != "span":
        return stage, FRAMES * (_ROW_TAPS * es + 16), 2
    e = 16 // es - 1 + (FRAMES - 1) * int(S) + 8 * V
    chunks = -(-e // (1 << lsh))
    return stage, chunks * ((es << lsh) + 16), nbuf


def smem_bytes(K, O, S, es, N, mode, lsh, nbuf, ring, one=False):
    """Shared memory of one kernel block (``window_matmul_smem_bytes`` in
    csrc/window_matmul.cu): the ring's stages, the A buffers and the
    mbarriers; ``one`` for the one-pass (DEFAULT) instance."""
    stage, span, nbuf = _geometry(K, O, S, es, N, mode, lsh, nbuf, one)
    return ring * stage + nbuf * span + 8 * _NBAR


def span_byte(e, es, lsh):
    """Byte of span sample ``e`` in shared memory (``span_byte`` in
    csrc/window_matmul.cu): chunks of ``2^lsh`` samples, each followed by
    16 bytes of padding."""
    return es * e + 16 * (e >> lsh)


def bank_conflicts(S, es, lsh):
    """The mean, over the span's alignments and the taps of two chunks,
    of the worst bank's distinct words in one warp's A-fragment load
    (lanes ``(g, t)`` at sample ``off + g S + k + t``)."""
    g = np.arange(8)[None, :, None]
    t = np.arange(4)[None, None, :]
    off, k = np.meshgrid(np.arange(16 // es), np.arange(0, 2 << lsh, 4),
                         indexing="ij")
    e = (off.reshape(-1, 1, 1) + k.reshape(-1, 1, 1) + g * int(S) + t)
    word = np.sort(span_byte(e, es, lsh).reshape(len(e), 32) // 4, axis=1)
    new = np.ones_like(word, dtype=bool)
    new[:, 1:] = word[:, 1:] != word[:, :-1]
    counts = np.zeros((len(word), 32), np.int64)
    rows = np.repeat(np.arange(len(word)), 32).reshape(word.shape)
    np.add.at(counts, (rows[new], word[new] % 32), 1)
    return float(counts.max(axis=1).mean())


@lru_cache(maxsize=256)
def span_shift(S, es):
    """log2 of the span chunk in samples for stride ``S`` and ``es`` bytes
    a sample: the largest of :data:`_CHUNK_BYTES` with the fewest bank
    conflicts (:func:`bank_conflicts`)."""
    cands = [(bank_conflicts(S, es, (cb // es).bit_length() - 1), -cb)
             for cb in _CHUNK_BYTES]
    best = min(cands)
    return (-best[1] // es).bit_length() - 1


@lru_cache(maxsize=256)
def plan(K, O, S, es, one=False):
    """The kernel's geometry for a (K, O) bank at stride ``S`` over
    ``es``-byte samples, for three TF32 passes or (``one``) one: span mode
    with two span buffers where they fit beside a ring of 4 stages, else
    one; rows mode where no span fits (two buffers of 128 window rows of a
    unit's 128 taps)."""
    N, ncb = column_blocks(O)
    lsh = span_shift(int(S), es)
    for nbuf in (2, 1):
        stage, span, _ = _geometry(K, O, S, es, N, "span", lsh, nbuf, one)
        ring = min(_RING_MAX,
                   (SMEM_LIMIT - 8 * _NBAR - nbuf * span) // stage)
        if ring >= 4:
            return Plan("span", N, ncb, lsh, nbuf, ring,
                        smem_bytes(K, O, S, es, N, "span", lsh, nbuf, ring,
                                   one))
    stage, rows, _ = _geometry(K, O, S, es, N, "rows", 0, 2, one)
    ring = min(_RING_MAX, (SMEM_LIMIT - 8 * _NBAR - 2 * rows) // stage)
    return Plan("rows", N, ncb, 0, 2, ring,
                smem_bytes(K, O, S, es, N, "rows", 0, 2, ring, one))


def _check_args(x, w, stride, nframes, premap, out_layout):
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError("x must be (C, n) and w (K, O)")
    if premap not in PREMAPS:
        raise ValueError(f"premap must be one of {PREMAPS}, got {premap!r}")
    if out_layout not in _LAYOUTS:
        raise ValueError(f"out_layout must be one of {_LAYOUTS}")
    if int(stride) < 1 or int(nframes) < 0:
        raise ValueError("stride must be >= 1 and nframes >= 0")
    if x.dtype == torch.int16 and premap != "dequant":
        raise TypeError("int16 x (PCM-16) takes premap='dequant'")


def _reshape_out(y, out_layout):
    """(C, nframes, O) -> the requested layout."""
    if out_layout == "fco":
        return y.permute(1, 0, 2).contiguous()
    return y.reshape(y.shape[0], -1)


@full_fp32()
def window_matmul_plain(x, w, stride, nframes, premap=None, out_layout="fco",
                        *, precision=HIGHEST):
    """Plain PyTorch version of :func:`window_matmul`: the frames as an
    ``unfold`` view of the zero-extended stream, then one ``matmul`` in
    full float32 whatever ``precision`` (checked)."""
    check_precision(precision, MATMUL_RUNGS)
    _check_args(x, w, stride, nframes, premap, out_layout)
    C, n = x.shape
    K, O = w.shape
    if nframes == 0:
        return _reshape_out(w.new_zeros((C, 0, O)), out_layout)
    need = (nframes - 1) * stride + K
    if need > n:
        x = torch.nn.functional.pad(x, (0, need - n))
    if premap == "dequant" and x.dtype == torch.int16:
        x = dequant16(x)
    elif premap == "rectify":
        x = (math.pi / 2) * torch.abs(x)
    elif premap == "square":
        x = x * x
    frames = x[:, :need].unfold(1, K, stride)               # (C, nf, K)
    return _reshape_out(frames @ w, out_layout)


def split_w(w):
    """``w`` (K, O) float32 on the card split into its TF32 hi and lo
    parts for the kernel's column blocks (:func:`column_blocks`), in its
    order (``split_w_kernel``): an int32 tensor of
    ``window_matmul_split_words(K, O, N)`` words.  Counted in
    ``split_w.launches``."""
    if w.device.type != "cuda":
        raise ValueError(f"split_w runs on cuda, not {w.device}")
    lib = load_library()
    K, O = w.shape
    N = column_blocks(O)[0]
    wt = torch.empty(lib.window_matmul_split_words(K, O, N),
                     dtype=torch.int32, device=w.device)
    launch(split_w, "window_matmul split", lib.window_matmul_split_launch,
           w.device, w.data_ptr(), K, O, N, wt.data_ptr())
    return wt


split_w.launches = 0


class BankSplit:
    """One bank's :func:`split_w`, kept by the bank's owner beside the
    bank and handed to :func:`window_matmul` (``split=``): made at the
    first call on the card, made anew when the bank is another tensor or
    other memory, or was edited in place (its version moved; a copy
    through ``.data`` is not seen, as autograd does not see it).  The
    split is made on the stream of the call that makes it; a call on
    another stream is ordered after it as after any tensor made on one
    stream and read on another."""

    __slots__ = ("_w", "_key", "_wt")

    def __init__(self):
        self._w = self._key = self._wt = None

    def __call__(self, w):
        key = (w.data_ptr(), w._version)
        wt = self._wt
        if w is not self._w or key != self._key:
            wt = split_w(w)
            self._w, self._key, self._wt = w, key, wt
        return wt


def window_matmul(x, w, stride, nframes, premap=None, out_layout="fco", *,
                  split=None, precision=HIGHEST):
    """``y[f, c, :] = p(x[c, f*stride : f*stride + K]) @ w`` for
    ``f < nframes``, with ``x`` zero-extended past its end.

    x : (C, n) float32, or int16 PCM-16 with ``premap="dequant"``;
        channels-first.  w : (K, O) float32.
    premap : one of :data:`PREMAPS`.
    out_layout : "fco" returns (nframes, C, O); "cf" the channels-first
        stream (C, nframes*O).
    split : the :class:`BankSplit` that holds ``w``'s TF32 split across
        calls (the bank's owner keeps one beside the bank); without it a
        call on the card splits ``w`` first, one launch more.
    precision : HIGHEST (the default) or HIGH, three TF32 passes; DEFAULT,
        one (:mod:`.precision`); anything else raises ValueError.

    A CUDA tensor runs the kernel (counted in ``window_matmul.launches``);
    a CPU tensor runs :func:`window_matmul_plain`.
    """
    if x.device.type == "cpu":
        return window_matmul_plain(x, w, stride, nframes, premap, out_layout,
                                   precision=precision)
    one = check_precision(precision, MATMUL_RUNGS) == DEFAULT
    if x.device.type != "cuda":
        raise ValueError(f"window_matmul runs on cuda or cpu, not {x.device}")
    _check_args(x, w, stride, nframes, premap, out_layout)
    if x.dtype not in (torch.float32, torch.int16) or w.dtype != torch.float32:
        raise TypeError("window_matmul takes float32 (or int16) x and "
                        "float32 w")
    if w.device != x.device:
        raise ValueError("x and w must be on the same device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    C, n = x.shape
    K, O = w.shape
    S, nframes = int(stride), int(nframes)
    if C > 65535:
        raise ValueError(f"at most 65535 channels (one grid row each), "
                         f"got {C}")
    y = torch.empty((C, nframes, O) if out_layout == "cf"
                    else (nframes, C, O), dtype=torch.float32,
                    device=x.device)
    if nframes == 0 or C == 0 or O == 0:
        return y.reshape(C, nframes * O) if out_layout == "cf" else y
    if (nframes + 64) * S + K >= 2**31 or n >= 2**31:
        raise ValueError("window_matmul indexes a channel with 32-bit "
                         "offsets: (nframes + 64) * stride + K and n must "
                         "stay below 2^31")
    p = plan(K, O, S, x.element_size(), one)
    wt = split_w(w) if split is None else split(w)
    # launched on the tensor's device: the current device may be another
    launch(window_matmul, "window_matmul", load_library().window_matmul_launch,
           x.device, x.data_ptr(), int(x.dtype == torch.int16), n, C,
           wt.data_ptr(), K, O, S, nframes, PREMAPS.index(premap),
           _LAYOUTS.index(out_layout), y.data_ptr(), p.N,
           MODES.index(p.mode), p.lsh, p.nbuf, p.ring, int(one))
    return y.reshape(C, nframes * O) if out_layout == "cf" else y


window_matmul.launches = 0
