"""Single-pass song-detection envelope: int16 or float32 PCM -> zero-phase
band-pass -> square -> decimating envelope low-pass -> ``2 sqrt(max(e, 0))``.

:class:`EnvDetKernel` is the port of
``audian_tpu/ops/pallas/envdet.py:EnvDetKernel``: the same constructor,
``window_need`` and static contract (the window's first output sits at
exactly ``hb``).  :func:`envdet` launches the CUDA kernel
(``csrc/envdet.cu``) on a CUDA tensor and runs the plain PyTorch version
:func:`envdet_plain` on a CPU tensor; any other device raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...utils import round_up
from ..envdet import EnvDetDesign, _float_window
from ..raw16 import dequant16
from ..sos import _fir_valid_cf, full_fp32
from ._build import SMEM_LIMIT, check, load_library

__all__ = ["EnvDetKernel", "envdet", "envdet_plain", "smem_bytes"]

#: decimated outputs per kernel block at most (``T`` in csrc/envdet.cu)
TILE_MAX = 512
#: stage-1 samples per thread (``R1`` in csrc/envdet.cu)
_R1 = 9


def smem_bytes(lb, ll, step, tile):
    """Shared memory of one envdet block (``smem_bytes`` in
    csrc/envdet.cu): the staged input, the squared band-passed stream and
    both tap vectors."""
    lb_pad = round_up(lb, _R1)
    ny = (tile - 1) * step + ll
    nx = ny + lb_pad + _R1 - 1
    return 4 * (nx + ny + lb_pad + ll)


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
        # the widest tile whose span fits one block: 512 outputs at the
        # song detector's design (94 KB, 10 % of the stream recomputed as
        # halo); longer kernels or larger steps halve it
        tile = TILE_MAX
        while tile > 1 and smem_bytes(self.lb, self.ll, self.step,
                                      tile) > SMEM_LIMIT:
            tile //= 2
        if smem_bytes(self.lb, self.ll, self.step, tile) > SMEM_LIMIT:
            raise ValueError(
                f"one envelope output spans {self.lb} + {self.ll} taps, "
                f"more than a block's shared memory holds")
        self.tile = tile
        self.g_bp = self._tensor(self.g_bp_np)
        self.g_lp = self._tensor(self.g_lp_np)

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
    if xw.ndim != 2:
        raise ValueError(f"xw must be a (W, C) window, got {tuple(xw.shape)}")


def envdet_plain(ed, xw):
    """Plain PyTorch version of :func:`envdet`: ``conv1d`` of the
    dequantized window with ``g_bp``, the square, then ``conv1d`` with
    ``g_lp`` at ``stride=step``, in full float32."""
    _check_window(xw)
    full_fp32()
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

    A CUDA tensor runs the kernel (counted in ``envdet.launches``); a CPU
    tensor runs :func:`envdet_plain`.
    """
    if xw.device.type == "cpu":
        return envdet_plain(ed, xw)
    if xw.device.type != "cuda":
        raise ValueError(f"envdet runs on cuda or cpu, not {xw.device}")
    _check_window(xw)
    if xw.device != ed.g_bp.device:
        raise ValueError(f"xw is on {xw.device}, the envelope's design on "
                         f"{ed.g_bp.device}")
    if xw.dtype != torch.int16 and not torch.is_floating_point(xw):
        raise TypeError(f"xw must be int16 or floating, not {xw.dtype}")
    # channels-first for the kernel: one transposing copy, as the JAX call
    x_cf = _float_window(xw).T.contiguous()
    C, W = x_cf.shape
    if C > 65535:
        raise ValueError(f"at most 65535 channels (one grid row each), "
                         f"got {C}")
    env = torch.empty((C, ed.nout), dtype=torch.float32, device=xw.device)
    if C == 0:
        return env.T
    code = load_library().envdet_launch(
        x_cf.data_ptr(), int(x_cf.dtype == torch.int16), W, C,
        ed.g_bp.data_ptr(), ed.lb, ed.d_bp, ed.g_lp.data_ptr(), ed.ll,
        ed.d_lp, ed.step, ed.nout, ed.hb, ed.tile, env.data_ptr(),
        torch.cuda.current_stream(xw.device).cuda_stream)
    check(code, "envdet")
    envdet.launches += 1
    return env.T


envdet.launches = 0
