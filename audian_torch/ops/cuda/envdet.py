"""Single-pass song-detection envelope: int16 or float32 PCM -> zero-phase
band-pass -> square -> decimating envelope low-pass -> ``2 sqrt(max(e, 0))``.

:class:`EnvDetKernel` is the port of
``audian_tpu/ops/pallas/envdet.py:EnvDetKernel``: the same constructor,
``window_need`` and static contract (the window's first output sits at
exactly ``hb``).  The CUDA kernel (``csrc/envdet.cu``) reads the
time-first window as it is: the band-pass runs on the tensor cores as
Toeplitz products (3xTF32 wgmma, ``csrc/wgmma_conv.cuh``) against the taps
split on the host (``bp_split``, as the chain's), and the decimating
envelope as a sum over ``step`` polyphase streams of correlations with
``q = ceil(ll / step)`` taps each (:func:`phase_taps`, reversed and padded
into ``lp_phase``) in fp32 FMAs.  :func:`geometry` is the block geometry
the kernel computes, :func:`smem_bytes` its shared memory and
:func:`pick_tile` the host's tile choice.

:func:`envdet` launches the kernel on a CUDA tensor and runs the plain
PyTorch version :func:`envdet_plain` on a CPU tensor; any other device
raises.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...utils import round_up
from ..envdet import EnvDetDesign, _float_window
from ..raw16 import dequant16
from ..sos import _fir_valid_cf, full_fp32
from ._build import SMEM_LIMIT, check, count_launch, load_library
from .chain import _split_taps, stream_rows

#: shared memory of the SM that two resident blocks share (228 KB, less
#: the 1 KB the runtime reserves for each block)
SMEM_PAIR = 233472 - 2 * 1024

__all__ = ["EnvDetKernel", "envdet", "envdet_plain", "geometry",
           "phase_rows", "phase_taps", "pick_tile", "smem_bytes"]

#: decimated outputs per kernel block, at most and at least (``TILE_MAX``
#: and ``TILE_MIN`` in csrc/envdet.cu); tiles are multiples of 64
TILE_MAX = 4096
TILE_MIN = 64
#: threads of a kernel block and stage-2 outputs a thread (``NT`` and
#: ``OUT`` in csrc/envdet.cu)
_THREADS = 256
_OUT = 8


def geometry(lb, ll, step, tile):
    """The kernel's block geometry (``geometry`` in csrc/envdet.cu) for
    ``tile`` outputs: ``(q, q8, ny, ncols1, nu1, zs, npg)`` -- the taps of
    a phase of stage 2 and their padded row, the band-passed samples of a
    tile, its output columns of 64, the rows of a plane of the split input
    stream, the words of one phase of y² and stage 2's phase shares."""
    q = -(-ll // step)
    q8 = -(-q // 8) * 8
    ny = (tile - 1) * step + ll
    ncols1 = -(-ny // 64)
    nu1 = stream_rows(max(ncols1, 64), lb - 1)
    ng = min(tile // _OUT, _THREADS)
    return q, q8, ny, ncols1, nu1, tile + q8 + _OUT, _THREADS // ng


def smem_bytes(lb, ll, step, tile):
    """Shared memory of one envdet block (``envdet_smem_bytes`` in
    csrc/envdet.cu): the split input span (512 bytes a row of both parts;
    stage 2's phase shares reuse it where they fit) and the polyphase y²
    in fp32; the taps are read through L1."""
    *_, nu1, zs, npg = geometry(lb, ll, step, tile)
    return max(512 * nu1, 4 * npg * tile) + 4 * step * zs


def pick_tile(lb, ll, step):
    """The host's tile, a multiple of 64 up to :data:`TILE_MAX` that fits
    one block: the one with the least band-pass work an output on the
    busier of the two warpgroups (64-column chunks, alternating), a
    quarter more where two blocks do not fit one SM (then one block's
    window loads do not overlap the other's products); the widest of
    equals.  ``None`` when not even :data:`TILE_MIN` fits."""
    best, best_score = None, None
    for t in range(TILE_MAX, TILE_MIN - 1, -64):
        smem = smem_bytes(lb, ll, step, t)
        if smem > SMEM_LIMIT:
            continue
        chunks = -(-geometry(lb, ll, step, t)[3] // 64)
        score = 128 * -(-chunks // 2) / t
        if 2 * smem > SMEM_PAIR:
            score *= 1.25
        if best_score is None or score < best_score:
            best, best_score = t, score
    return best


def phase_taps(g_lp, step):
    """``(step, q)`` float32 taps of the polyphase envelope: row ``p``
    holds ``t_p[m] = g_r[step (q-1-m) + p]`` with ``g_r`` the reversed
    ``g_lp`` (zero past its end), so that ``e[j] = sum_m g_lp[m]
    u[j step + ll-1 - m] = sum_p sum_m t_p[m] z_p[j + q-1 - m]`` with
    ``z_p[n] = u[step n + p]``."""
    g = np.asarray(g_lp, np.float32)[::-1]
    ll = len(g)
    q = -(-ll // step)
    k = step * (q - 1 - np.arange(q))[None, :] + np.arange(step)[:, None]
    return np.where(k < ll, g[np.minimum(k, ll - 1)], 0.0).astype(np.float32)


def phase_rows(g_lp, step):
    """The kernel's stage-2 taps: ``(step, q8)`` float32, row ``p`` holding
    ``r_p[m] = g_lp[ll-1 - step m - p]`` (zero past the taps and up to
    ``q8``, a multiple of 8), so that ``e[j] = sum_p sum_m r_p[m]
    z_p[j + m]`` with ``z_p[n] = u[step n + p]``: the rows of
    :func:`phase_taps` reversed."""
    t = phase_taps(g_lp, step)[:, ::-1]
    q8 = -(-t.shape[1] // 8) * 8
    return np.ascontiguousarray(np.pad(t, [(0, 0), (0, q8 - t.shape[1])]))


class EnvDetKernel(EnvDetDesign):
    """The whole envelope in one kernel pass; the first output must sit at
    exactly ``hb`` (``__call__`` rejects other offsets).  Raises ValueError
    when the headroom is smaller than the combined look-back of the two
    filters, or when one output's span does not fit a block's shared
    memory (callers then take :class:`audian_torch.ops.envdet.EnvDet`)."""

    def _build(self):
        if self.hb < self.lead2 + self.lb - 1 - self.d_bp:
            raise ValueError("window headroom smaller than the combined "
                             "filter look-back")
        self.tile = pick_tile(self.lb, self.ll, self.step)
        if self.tile is None:
            raise ValueError(
                f"one envelope output spans {self.lb} + {self.ll} taps, "
                f"more than a block's shared memory holds")
        self.g_bp = self._tensor(self.g_bp_np)
        self.g_lp = self._tensor(self.g_lp_np)
        self.bp_split = self._tensor(_split_taps(self.g_bp_np))
        self.lp_phase = self._tensor(phase_rows(self.g_lp_np, self.step))

    def __call__(self, xw, off0):
        """Envelope of one window ``xw (W, C)`` (float32 or raw int16) with
        the first output at window sample ``off0 == hb``: ``(nout, C)``."""
        if int(off0) != self.hb:
            raise ValueError(
                f"single-pass envelope kernel requires the first output "
                f"at exactly hb={self.hb} (got {off0}); use the "
                f"two-stage EnvDet for unaligned windows")
        return envdet(self, xw)


def _check_window(xw):
    """The window rules of both forms: a contiguous time-first ``(W, C)``
    tensor, raw int16 or floating."""
    if xw.ndim != 2:
        raise ValueError(f"xw must be a (W, C) window, got {tuple(xw.shape)}")
    if xw.dtype != torch.int16 and not torch.is_floating_point(xw):
        raise TypeError(f"xw must be int16 or floating, not {xw.dtype}")
    if not xw.is_contiguous():
        raise ValueError(
            f"xw must be a contiguous (W, C) window (time-first, the "
            f"channels of a sample adjacent), got strides {xw.stride()}")


@full_fp32()
def envdet_plain(ed, xw):
    """Plain PyTorch version of :func:`envdet`: ``conv1d`` of the
    dequantized window with ``g_bp``, the square, then ``conv1d`` with
    ``g_lp`` at ``stride=step``, in full float32."""
    _check_window(xw)
    x = xw.T
    x = dequant16(x) if x.dtype == torch.int16 else x.to(torch.float32)
    # y over [s0, s1] feeds the outputs; x over [x0, s1 + d_bp] feeds y
    s0 = ed.hb - ed.lead2
    s1 = ed.hb + (ed.nout - 1) * ed.step + ed.d_lp
    x0 = s0 + ed.d_bp - (ed.lb - 1)
    x1 = s1 + ed.d_bp + 1
    seg = x[:, x0:x1]
    if seg.shape[1] < x1 - x0:
        seg = F.pad(seg, (0, x1 - x0 - seg.shape[1]))
    y = _fir_valid_cf(seg, ed.g_bp)                       # y[s0 .. s1]
    w = torch.flip(ed.g_lp, (0,)).reshape(1, 1, -1)
    e = F.conv1d((y * y).unsqueeze(1), w, stride=ed.step).squeeze(1)
    return (2.0 * torch.sqrt(torch.clamp_min(e, 0.0))).T


def envdet(ed, xw):
    """The envelope of ``ed`` (an :class:`EnvDetKernel`) over one window
    ``xw (W, C)``, first output at ``ed.hb``: ``(nout, C)`` float32.

    ``xw`` must be contiguous; the kernel reads it as it lies (float
    types other than float32 are converted first).  A CUDA tensor runs
    the kernel (counted in ``envdet.launches``); a CPU tensor runs
    :func:`envdet_plain`.
    """
    if xw.device.type == "cpu":
        return envdet_plain(ed, xw)
    if xw.device.type != "cuda":
        raise ValueError(f"envdet runs on cuda or cpu, not {xw.device}")
    _check_window(xw)
    if xw.device != ed.g_bp.device:
        raise ValueError(f"xw is on {xw.device}, the envelope's design on "
                         f"{ed.g_bp.device}")
    x = _float_window(xw)
    W, C = x.shape
    env = torch.empty((C, ed.nout), dtype=torch.float32, device=xw.device)
    if C == 0:
        return env.T
    lib = load_library()
    # launched on the tensor's device: the current device may be another
    with torch.cuda.device(xw.device):
        code = lib.envdet_launch(
            x.data_ptr(), int(x.dtype == torch.int16), W, C,
            ed.bp_split.data_ptr(), ed.lb, ed.d_bp, ed.lp_phase.data_ptr(),
            ed.ll, ed.d_lp, ed.step, ed.nout, ed.hb, ed.tile, env.data_ptr(),
            torch.cuda.current_stream(xw.device).cuda_stream)
    check(code, "envdet")
    count_launch(envdet)
    return env.T


envdet.launches = 0
