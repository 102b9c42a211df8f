"""The benchmark probes' kernels (``csrc/probes.cu``), each beside its
plain PyTorch version: the device-copy floor (:func:`copy_add1`,
:func:`copy_pm_add1`), the chain's output floor (:func:`outputs_floor`)
and the phase-major relayout of the IFIR envelope (:func:`pm_forward`,
:func:`pm_inverse`, :func:`pm_roundtrip_add1`, :func:`select_pm_add1`).

They replace the Pallas probes of ``benchmarks/``:
``call_scaling_bench.py:copy_kernel`` and ``dma_floor_bench.py:copy_kernel``
(and ``phase_restructure_bench.py:k_base``), ``dma_floor_bench.py``'s
``copy_pm_kernel`` and ``outputs_kernel``, and
``phase_restructure_bench.py``'s ``k_reshape`` and ``k_matmul``.
``k_matmul`` computes nothing as written (its ``_selection_mats`` builds
one non-zero matrix of eight, and its last reshape fails to trace):
:func:`select_pm_add1` computes what its docstring describes, the
group-local relayout by 0/1 selection products (:func:`selection_mats`)
on the tensor cores, at the precision rungs of :mod:`.precision`.

:func:`pm_forward` and :func:`pm_inverse` are the relayouts of
``FusedChainCF``'s IFIR envelope (``ops/fused.py``); they read a row
stride, so a slice of a wider stream needs no copy first.

Each wrapper launches its kernel on a CUDA tensor (counted in its
``launches``) and runs its plain version on a CPU tensor; a failed launch
raises, and any other device raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import SMEM_LIMIT, launch, load_library
from .precision import DEFAULT, HIGHEST, MATMUL_RUNGS
from .precision import check as check_precision

__all__ = ["COPY_TILE", "GROUP", "MAX_STRIDE", "PHASES", "copy_add1",
           "copy_add1_plain", "copy_grid", "copy_pm_add1",
           "copy_pm_add1_plain", "outputs_floor",
           "outputs_floor_plain", "pm_forward", "pm_forward_plain",
           "pm_inverse", "pm_inverse_plain", "pm_roundtrip_add1",
           "pm_roundtrip_add1_plain", "roundtrip_grid", "roundtrip_row",
           "roundtrip_smem_bytes", "select_grid", "select_pm_add1",
           "select_pm_add1_plain", "select_smem_bytes", "selection_mats"]

#: the phase counts the round trip takes (the IFIR strides 4 and 8);
#: pm_forward and pm_inverse take any stride up to :data:`MAX_STRIDE`
PHASES = (4, 8)
#: samples of a relayout tile (``TS`` in csrc/probes.cu), the largest stride
MAX_STRIDE = 4096
#: samples of a selection group: 128 lanes of each of its 8 phases
GROUP = 1024
_PHASES = 8
#: the copies' tile (``COPY_*`` in csrc/probes.cu): threads of a block,
#: 16-byte vectors a thread, words a block
COPY_NT = 256
COPY_U = 4
COPY_TILE = 4 * COPY_NT * COPY_U
#: shared memory of an SM (228 KB; 1 KB a block of it reserved)
SM_SMEM = 233472
#: the round trip's ring (``RT_*`` in csrc/probes.cu): samples of a stage,
#: stages, blocks an SM the grid aims at
RT_CHUNK = 2048
RT_RING = 2
RT_PER_SM = 2
#: the selection products' ring (``SEL_*``): stages of 64 rows, each row's
#: 128 samples at a pitch of 144 words; U's 16 steps of 8 x 128 words
SELECT_RING = 4
SELECT_PITCH = 144
_U_WORDS = 16 * 8 * 128


def _device_of(x, name):
    """'cpu' or 'cuda' for ``x``'s device; ValueError for any other."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return x.device.type


def _check_f32(x, name, ndim):
    if x.dtype != torch.float32 or x.dim() != ndim:
        raise TypeError(f"{name} takes a {ndim}-d float32 tensor, got "
                        f"{x.dtype} of shape {tuple(x.shape)}")


def _contiguous_on_card(x, name):
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")


# -- the copies ---------------------------------------------------------------

def copy_grid(n):
    """Blocks of the copies' one-shot grid over ``n`` words
    (``probe_copy_grid``): a tile of :data:`COPY_TILE` words each."""
    return -(-int(n) // COPY_TILE)


def _check_block(T, block, name):
    if int(block) < 1:
        raise ValueError(f"{name}: block must be positive, got {block}")
    if T % int(block):
        raise ValueError(f"{name}: {T} samples are not whole blocks of "
                         f"{block}")


def _copy_args(x, name, ndim, block=None):
    """The copies' checks in one pass over ``x``'s attributes, in the order
    and with the errors of :func:`_device_of`, :func:`_check_f32`,
    :func:`_check_block` (where ``block`` is given) and, on the card,
    :func:`_contiguous_on_card`.  Returns whether ``x`` lies on the CPU."""
    on_cpu = x.is_cpu
    if not (on_cpu or x.is_cuda):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.float32 or x.ndim != ndim:
        _check_f32(x, name, ndim)
    if block is not None:
        _check_block(x.shape[1], block, name)
    if not (on_cpu or x.is_contiguous()):
        _contiguous_on_card(x, name)
    return on_cpu


def copy_add1_plain(x, block=8192):
    """``x + 1``: the plain version of :func:`copy_add1`."""
    _check_f32(x, "copy_add1", 2)
    _check_block(x.shape[1], block, "copy_add1")
    return x + 1.0


def copy_add1(x, block=8192):
    """``y = x + 1`` over ``x`` (C, T) float32, T whole (C, ``block``)
    column blocks (the probes' device-copy floor).  ``block`` is the
    reference's Pallas block and is checked, but the card's grid does not
    follow it: the kernel runs over the tensor's words as one flat range
    (:func:`copy_grid`), so every ``block`` runs the same kernel."""
    if _copy_args(x, "copy_add1", 2, block):
        return copy_add1_plain(x, block)
    y = torch.empty_like(x)
    C, T = x.shape
    if C and T:
        launch(copy_add1, "copy_add1", load_library().probe_copy_add1_launch,
               x.device, x.data_ptr(), y.data_ptr(), C, T, int(block))
    return y


copy_add1.launches = 0


def copy_pm_add1_plain(x):
    """``x + 1``: the plain version of :func:`copy_pm_add1`."""
    _check_f32(x, "copy_pm_add1", 3)
    return x + 1.0


def copy_pm_add1(x):
    """``y = x + 1`` over program-major ``x`` (nprog, C, N) float32: the
    kernel of :func:`copy_add1`, over the tensor's words as one flat range
    (:func:`copy_grid`)."""
    if _copy_args(x, "copy_pm_add1", 3):
        return copy_pm_add1_plain(x)
    y = torch.empty_like(x)
    if x.numel():
        launch(copy_pm_add1, "copy_pm_add1",
               load_library().probe_copy_pm_add1_launch, x.device,
               x.data_ptr(), y.data_ptr(), *x.shape)
    return y


copy_pm_add1.launches = 0


def _outputs_shapes(C, T, block, nbins):
    nprog, F = T // block, block // 128
    return [(C, T), (C, T), (nprog, F, C, nbins), (nprog, 1, C),
            (nprog, 1, C), (nprog, C, nbins)]


def _check_outputs(x, block, nbins):
    _check_f32(x, "outputs_floor", 2)
    _check_block(x.shape[1], block, "outputs_floor")
    if int(block) % 128 or int(nbins) < 1:
        raise ValueError(f"outputs_floor takes blocks of whole 128-sample "
                         f"frames and nbins >= 1, got {block}, {nbins}")


def outputs_floor_plain(x, block=8192, nbins=129):
    """The plain version of :func:`outputs_floor`, the reference's
    ``outputs_kernel`` over every program at once."""
    _check_outputs(x, block, nbins)
    C, T = x.shape
    nprog, F = T // block, block // 128
    xb = x.reshape(C, nprog, block)
    y, e = x + 1.0, x + 2.0
    so = x.new_zeros((nprog, F, C, nbins)) + xb[0, :, 0].reshape(-1, 1, 1, 1)
    po = xb[:, :, 0].T.reshape(nprog, 1, C).contiguous()
    go = xb[:, :, 1].T.reshape(nprog, 1, C).contiguous()
    qo = x.new_zeros((nprog, C, nbins)) + xb[0, :, 2].reshape(-1, 1, 1)
    return y, e, so, po, go, qo


def outputs_floor(x, block=8192, nbins=129):
    """The chain's six output blocks with no compute, for ``x`` (C, T)
    float32 in programs of ``block`` samples (``F = block / 128`` frames):
    ``y = x + 1`` and ``e = x + 2`` (C, T), the PSD (nprog, F, C, nbins)
    and ``qo`` (nprog, C, nbins) filled with each program's ``x[0, 0]``
    and ``x[0, 2]``, and ``po`` / ``go`` (nprog, 1, C) its columns 0 and
    1 (the reference's ``outputs_kernel``, the output floor of the
    chain)."""
    if _device_of(x, "outputs_floor") == "cpu":
        return outputs_floor_plain(x, block, nbins)
    _check_outputs(x, block, nbins)
    _contiguous_on_card(x, "outputs_floor")
    C, T = x.shape
    outs = [torch.empty(s, dtype=torch.float32, device=x.device)
            for s in _outputs_shapes(C, T, int(block), int(nbins))]
    if C and T:
        launch(outputs_floor, "outputs_floor",
               load_library().probe_outputs_floor_launch, x.device,
               x.data_ptr(), C, T, int(block), int(nbins),
               *(o.data_ptr() for o in outs))
    return tuple(outs)


outputs_floor.launches = 0


# -- the phase-major relayouts ------------------------------------------------

def _check_phases(M, name):
    if int(M) not in PHASES:
        raise ValueError(f"{name} takes M in {PHASES}, got {M}")
    return int(M)


def _check_stride(M, name):
    if not 1 <= int(M) <= MAX_STRIDE:
        raise ValueError(f"{name} takes a stride M from 1 to {MAX_STRIDE}, "
                         f"got {M}")
    return int(M)


def _row_stride_ok(x, name):
    if x.stride(1) != 1:
        raise ValueError(f"{name} takes rows of unit stride")


def pm_forward_plain(u, M):
    """The torch relayout ``u (C, M Q) -> (C M, Q)``, ``out[c M + m, q] =
    u[c, m + M q]``: the plain version of :func:`pm_forward` (what
    ``FusedChainCF`` ran before the kernel)."""
    _check_f32(u, "pm_forward", 2)
    C, n = u.shape
    M = _check_stride(M, "pm_forward")
    if n % M:
        raise ValueError(f"pm_forward: {n} samples are not whole groups "
                         f"of {M}")
    Q = n // M
    return u.reshape(C, Q, M).transpose(1, 2).reshape(C * M, Q)


def pm_forward(u, M):
    """``u`` (C, M Q) float32, rows of unit stride at any row stride (a
    column slice of a wider stream), to the contiguous phase-major
    ``(C M, Q)``: ``out[c M + m, q] = u[c, m + M q]``, M up to
    :data:`MAX_STRIDE`."""
    if _device_of(u, "pm_forward") == "cpu":
        return pm_forward_plain(u, M)
    _check_f32(u, "pm_forward", 2)
    M = _check_stride(M, "pm_forward")
    C, n = u.shape
    if n % M:
        raise ValueError(f"pm_forward: {n} samples are not whole groups "
                         f"of {M}")
    _row_stride_ok(u, "pm_forward")
    Q = n // M
    out = torch.empty((C * M, Q), dtype=torch.float32, device=u.device)
    if C and Q:
        if C > 65535:
            raise ValueError(f"pm_forward takes at most 65535 channels, "
                             f"got {C}")
        launch(pm_forward, "pm_forward",
               load_library().probe_pm_forward_launch, u.device,
               u.data_ptr(), u.stride(0) if C > 1 else n, C, Q, M,
               out.data_ptr())
    return out


pm_forward.launches = 0


def pm_inverse_plain(e, M):
    """The torch relayout ``e (C M, Q) -> (C, M Q)``, ``out[c, m + M q] =
    e[c M + m, q]``: the plain version of :func:`pm_inverse`."""
    _check_f32(e, "pm_inverse", 2)
    CM, Q = e.shape
    M = _check_stride(M, "pm_inverse")
    if CM % M:
        raise ValueError(f"pm_inverse: {CM} rows are not whole channels "
                         f"of {M} phases")
    return e.reshape(CM // M, M, Q).transpose(1, 2).reshape(CM // M, Q * M)


def pm_inverse(e, M):
    """``e`` (C M, Q) float32, rows of unit stride at any row stride, back
    to the contiguous stream ``(C, M Q)``: ``out[c, m + M q] = e[c M + m,
    q]``, M up to :data:`MAX_STRIDE`."""
    if _device_of(e, "pm_inverse") == "cpu":
        return pm_inverse_plain(e, M)
    _check_f32(e, "pm_inverse", 2)
    M = _check_stride(M, "pm_inverse")
    CM, Q = e.shape
    if CM % M:
        raise ValueError(f"pm_inverse: {CM} rows are not whole channels "
                         f"of {M} phases")
    _row_stride_ok(e, "pm_inverse")
    C = CM // M
    out = torch.empty((C, Q * M), dtype=torch.float32, device=e.device)
    if C and Q:
        if C > 65535:
            raise ValueError(f"pm_inverse takes at most 65535 channels, "
                             f"got {C}")
        launch(pm_inverse, "pm_inverse",
               load_library().probe_pm_inverse_launch, e.device,
               e.data_ptr(), e.stride(0) if CM > 1 else Q, C, Q, M,
               out.data_ptr())
    return out


pm_inverse.launches = 0


def roundtrip_row(block, M):
    """Words of one of the round trip's phase rows (``rt_row``): ``block /
    M`` rounded up to 4 mod 8, so that rows four apart lie 16 banks
    apart."""
    q = int(block) // int(M)
    return q + ((4 - q) & 7)


def roundtrip_smem_bytes(block, M):
    """Shared memory of one :func:`pm_roundtrip_add1` block
    (``probe_pm_roundtrip_smem_bytes``): the ring's stages of up to
    :data:`RT_CHUNK` samples, the M phase rows, and two mbarriers and an
    item index a stage."""
    stage = min(int(block), RT_CHUNK)
    return (4 * RT_RING * stage + 4 * int(M) * roundtrip_row(block, M)
            + 24 * RT_RING)


def roundtrip_grid(C, T, block, M, sms):
    """Blocks of the round trip's persistent grid on ``sms`` SMs
    (``probe_pm_roundtrip_grid``): :data:`RT_PER_SM` an SM where their
    shared memory fits, no more than the ``C T / block`` items."""
    per_sm = max(1, min(RT_PER_SM,
                        SM_SMEM // (roundtrip_smem_bytes(block, M) + 1024)))
    return min(int(C) * (int(T) // int(block)), per_sm * int(sms))


def _check_roundtrip(x, block, M):
    _check_f32(x, "pm_roundtrip_add1", 2)
    M = _check_phases(M, "pm_roundtrip_add1")
    _check_block(x.shape[1], block, "pm_roundtrip_add1")
    if int(block) % 32 or roundtrip_smem_bytes(int(block), M) > SMEM_LIMIT:
        raise ValueError(f"pm_roundtrip_add1 takes blocks of whole 32-sample "
                         f"groups whose phase rows fit one block's shared "
                         f"memory beside its ring, got {block}")
    return M


def pm_roundtrip_add1_plain(x, block=8192, M=8):
    """The reference's ``k_reshape`` over every block at once: each (C,
    ``block``) block to phase-major, + 1, and back."""
    M = _check_roundtrip(x, block, M)
    C, T = x.shape
    nprog, Q = T // block, block // M
    u = x.reshape(C, nprog, Q, M).transpose(2, 3).reshape(C, nprog, M * Q)
    u = u + 1.0
    return u.reshape(C, nprog, M, Q).transpose(2, 3).reshape(C, T)


def pm_roundtrip_add1(x, block=8192, M=8):
    """``y = x + 1`` by way of the relayout: each (C, ``block``) block of
    ``x`` (C, T) float32 to phase-major, + 1, and back, one row of a block
    in shared memory at a time (a persistent grid, :func:`roundtrip_grid`,
    each block's rows bulk-copied into a ring of stages while the last
    one is relaid)."""
    if _device_of(x, "pm_roundtrip_add1") == "cpu":
        return pm_roundtrip_add1_plain(x, block, M)
    M = _check_roundtrip(x, block, M)
    _contiguous_on_card(x, "pm_roundtrip_add1")
    C, T = x.shape
    y = torch.empty_like(x)
    if C and T:
        # the kernel's item counter, zeroed by the launcher; freed on
        # return, its memory goes only to later work on this stream
        nxt = torch.empty(1, dtype=torch.int64, device=x.device)
        launch(pm_roundtrip_add1, "pm_roundtrip_add1",
               load_library().probe_pm_roundtrip_add1_launch, x.device,
               x.data_ptr(), y.data_ptr(), C, T, int(block), M,
               nxt.data_ptr())
    return y


pm_roundtrip_add1.launches = 0


# -- the selection products ---------------------------------------------------

def selection_mats():
    """The selection matrices of the group-local relayout, (8, 8, 128, 128)
    float32: ``S[b, m, i, k] = 1`` iff ``128 b + i == m + 8 k``, so that
    phase row ``m`` of a group of 1024 samples is ``sum_b X_b @ S[b, m]``
    over its 8 source blocks ``X_b`` of 128 samples.  Built from the
    phase count alone: the probes carry no other parameter."""
    L = GROUP // _PHASES
    b, m, i, k = np.ix_(*(np.arange(n) for n in (_PHASES, _PHASES, L, L)))
    return (L * b + i == m + _PHASES * k).astype(np.float32)


def select_smem_bytes():
    """Shared memory of one :func:`select_pm_add1` block
    (``probe_select_pm_smem_bytes``): U, the ring's stages of 64 rows at
    :data:`SELECT_PITCH`, and two mbarriers and an item index a stage."""
    return 4 * (_U_WORDS + SELECT_RING * 64 * SELECT_PITCH) + 24 * SELECT_RING


def select_grid(C, T, sms):
    """Blocks of the selection's persistent grid on ``sms`` SMs
    (``probe_select_pm_grid``): one an SM, no more than the items (the 8
    source blocks of each tile of 64 rows of 1024 samples)."""
    items = -(-int(C) * (int(T) // GROUP) // 64) * 8
    return min(items, int(sms))


def _check_select(x):
    _check_f32(x, "select_pm_add1", 2)
    if x.shape[1] % GROUP:
        raise ValueError(f"select_pm_add1: {x.shape[1]} samples are not "
                         f"whole groups of {GROUP}")


def select_pm_add1_plain(x, *, precision=HIGHEST):
    """The plain version of :func:`select_pm_add1`: the relayout as a
    reshape and transpose, exact whatever ``precision`` (checked)."""
    check_precision(precision, MATMUL_RUNGS)
    _check_select(x)
    C, T = x.shape
    L = GROUP // _PHASES
    return x.reshape(C, T // GROUP, L, _PHASES).transpose(2, 3).reshape(
        C, T) + 1.0


def select_pm_add1(x, *, precision=HIGHEST):
    """The group-local phase-major relayout by 0/1 selection products on
    the tensor cores, + 1: ``y[c, 1024 g + 128 m + k] = x[c, 1024 g + m +
    8 k] + 1`` for ``x`` (C, T) float32, T a multiple of 1024.
    ``precision``: HIGHEST or HIGH, two TF32 passes (x's hi and lo parts;
    the 0/1 operand is exact), within 2^-22 |x|; DEFAULT one, x rounded to
    TF32, within 2^-11 |x| (:mod:`.precision`).  A NaN or an infinity makes
    the 128 outputs its row and 128-sample source block feed NaN (at
    DEFAULT, where x has no lo part, an infinity's own output, inf x 1 +
    1, stays infinite).  On the
    card a persistent grid (:func:`select_grid`) bulk-copies each tile's
    source blocks into a ring of stages while two warpgroups multiply."""
    one = check_precision(precision, MATMUL_RUNGS) == DEFAULT
    if _device_of(x, "select_pm_add1") == "cpu":
        return select_pm_add1_plain(x, precision=precision)
    _check_select(x)
    _contiguous_on_card(x, "select_pm_add1")
    y = torch.empty_like(x)
    C, T = x.shape
    if C and T:
        # the item counter, as the round trip's
        nxt = torch.empty(1, dtype=torch.int64, device=x.device)
        launch(select_pm_add1, "select_pm_add1",
               load_library().probe_select_pm_add1_launch, x.device,
               x.data_ptr(), y.data_ptr(), C, T, int(one), nxt.data_ptr())
    return y


select_pm_add1.launches = 0
