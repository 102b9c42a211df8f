"""The precision rungs of the tensor-core kernels, emulated on the CPU.

``audian_torch.ops.cuda.precision`` names the JAX package's values
(``lax.Precision`` and the split-bf16 sentinels of
``audian_tpu/ops/pallas/chain.py``); on the card

- HIGHEST and HIGH run three TF32 passes (``test_torch_tf32x3``'s
  arithmetic), DEFAULT one (hi*hi, hi rounded by ``cvt.rna.tf32``, which
  keeps a NaN a NaN);
- BF16X3 and BF16X4 split each operand into bf16 hi = bf16(x) and lo =
  bf16(x - hi), both rounded to nearest even, and sum hi*hi + hi*lo +
  lo*hi (and lo*lo) in fp32, on 64 x 16 Toeplitz slices over an
  octet-major stream (``csrc/wgmma_conv.cuh``), with A gathered from the
  host's pair vectors (``pair_taps``) and the PSD's B from bf16 slices of
  16 rows (``psd_slices_bf16``);
- light units (the core's 128-tap units whose summed L1 mass stays under
  a thousandth of the taps', ``light_units``) run one pass, hi*hi, at
  every rung.

The helpers below emulate each rung on the bit patterns and are held
against the JAX package at the same precision (its Pallas kernels in
interpret mode on the CPU, where DEFAULT and the split passes run in exact
float32) and against float64, at the budgets of chip_smoke.py's phase 17:
the fp32 contract (1e-5, 0.013 dB) at HIGHEST and at the JAX default
(HIGHEST, BF16X3, BF16X3); a split-bf16 filter within 1e-5 of the HIGHEST
one, BF16X4 at least as close as BF16X3; DEFAULT within 1e-2 of each
output's scale; light units within 1e-6 / 5e-6 / 0.05 dB of every unit in
full on the headline design and within 1e-5 on a design whose light mass
sits at the boundary.  The MMA's own summation order is not emulated.
"""

import math
from functools import lru_cache

import numpy as np
import pytest
import scipy.signal as sps
import torch
import jax.numpy as jnp
from jax import lax

from audian_tpu.ops import FilterDesign as JaxDesign
from audian_tpu.ops.envdet import EnvDet as JaxEnvDet
from audian_tpu.ops.envdet import _dequant, _square
from audian_tpu.ops.fused import _rectify
from audian_tpu.ops.pallas import chain as jax_chain
from audian_tpu.ops.pallas.envdet import EnvDetKernel as JaxEnvDetKernel
from audian_tpu.ops.pallas.window_matmul import window_matmul as jax_wm

from audian_torch import convert
from audian_torch.models import get_preset
from audian_torch.ops import sos as port_sos
from audian_torch.ops.cuda import precision as P
from audian_torch.ops.cuda._build import SMEM_LIMIT
from audian_torch.ops.cuda.chain import (LIGHT_MASS_FRAC, TAP_PAD, TILES,
                                         ChainKernel, _pair_columns,
                                         _split_taps, bf16_rne, core_steps,
                                         geometry, light_units, pair_taps,
                                         pick_tile, psd_slices_bf16,
                                         smem_bytes, split_bf16, stream_rows,
                                         unit_masses, unit_steps)
from audian_torch.ops.cuda.envdet import EnvDetKernel
from audian_torch.ops.cuda.window_matmul import (_geometry, column_blocks,
                                                 plan, window_matmul,
                                                 window_matmul_plain)
from audian_torch.ops.cuda.window_matmul import smem_bytes as wm_smem_bytes
from audian_torch.ops.design import FilterDesign, design_filter
from audian_torch.ops.envdet import EnvDet
from test_torch_tf32x3 import (RATE, SOS_E, SOS_F, TOL, TOL_PSD_DB, _stream,
                               _window_case, b_operand, chains, chunks,
                               psd_db_err, psd_operand, quad_major, rna,
                               split, trunc)

RUNGS = {"(H,H,H)": (P.HIGHEST,) * 3,
         "(H,B3,B3)": (P.HIGHEST, P.BF16X3, P.BF16X3),
         "(B3,B3,B3)": (P.BF16X3,) * 3,
         "(B4,B3,B3)": (P.BF16X4, P.BF16X3, P.BF16X3),
         "(D,D,D)": (P.DEFAULT,) * 3}
JAX_VALUES = {P.HIGHEST: lax.Precision.HIGHEST, P.HIGH: lax.Precision.HIGH,
              P.DEFAULT: lax.Precision.DEFAULT, P.BF16X3: jax_chain.BF16X3,
              P.BF16X4: jax_chain.BF16X4}
TOL_DEFAULT = 1e-2          # one TF32 pass, times each output's scale
TOL_LIGHT = (1e-6, 5e-6, 0.05)


# -- the bf16 arithmetic --------------------------------------------------

def bf16(x):
    """float32 ``x`` rounded to bf16 (to nearest even) on its bit pattern,
    as ``cvt.rn.bf16`` rounds it; a NaN becomes the quiet NaN."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    r = torch.where(torch.isnan(x), torch.full_like(r, 0x7FC00000), r)
    r = torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32)
    return r.view(torch.float32)


def split16(x):
    hi = bf16(x)
    return hi, bf16(x - hi)


def cvt_rna(x):
    """``cvt.rna.tf32.f32``: :func:`rna`, and a NaN of any payload the
    canonical NaN 0x7FFFFFFF, which the tensor cores (reading the top 19
    bits) still read as a NaN."""
    nan = torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(torch.float32)
    return torch.where(torch.isnan(x), nan, rna(x))


def passes(kind, ah, al, bh, bl):
    """A step's sum in the core's kind (0 TF32X3, 1 TF32X1, 2 BF16X3,
    3 BF16X4, 4 one bf16 pass), the small passes first."""
    if kind in (1, 4):
        return ah @ bh
    t = ah @ bl
    if kind == 3:
        t = al @ bl + t
    return (t + al @ bh) + ah @ bh


# -- the octet-major stream and the bf16 operands -------------------------

def om_half(i, nu):
    """Half-word of sample ``i`` in one part of an octet-major stream
    (``wgconv::om_half``)."""
    return 8 * (((i >> 3) & 7) * nu + (i >> 6)) + (i & 7)


def octet_major(x, nu):
    """``x (B, n)`` written into an octet-major stream ``(B, 64 nu)``, zero
    past its end."""
    out = torch.zeros(x.shape[0], 64 * nu, dtype=x.dtype)
    i = torch.arange(min(x.shape[1], 64 * nu))
    out[:, om_half(i, nu)] = x[:, : len(i)]
    return out


def b_operand16(halves, nu, row0, v, N):
    """``B_v (B, 16, N)`` as the descriptor of a bf16 step reads it: start
    ``8 (2 (v % 4) nu + v // 4 + row0)`` half-words, ``LBO = 8 nu`` between
    the two k-octets, ``SBO = 64`` between 8-column groups, each core matrix
    eight rows of 8 half-words."""
    k = torch.arange(16)[:, None]
    U = torch.arange(N)[None, :]
    addr = (8 * (2 * (v % 4) * nu + v // 4 + row0) + (k // 8) * 8 * nu
            + (U // 8) * 64 + (U % 8) * 8 + k % 8)
    return halves[:, addr]


def unpair(words):
    """The (low, high) bf16 halves of pair words, as float32."""
    u = words.to(torch.int64) & 0xFFFFFFFF
    lo = ((u & 0xFFFF) << 16)
    hi = u & 0xFFFF0000
    f = [torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)
         .view(torch.float32) for h in (lo, hi)]
    return f[0], f[1]


def a_operand16(pairs, T, D, v):
    """``A_v (64, 16)`` (hi, lo) gathered as each thread of the warpgroup
    gathers it from the pair vectors: a0 = P[m0], a1 = P[m0 + 8], a2 =
    P[m0 - 8], a3 = a0, with m0 = 16 w + g - 2 t + D - 16 v, each word
    (A[row][2 t'], A[row][2 t' + 1]) in its (low, high) halves."""
    w, g, t = torch.meshgrid(torch.arange(4), torch.arange(8),
                             torch.arange(4), indexing="ij")
    m0 = (TAP_PAD + 16 * w + g - 2 * t + D - 16 * v).reshape(-1)
    r0 = (16 * w + g).reshape(-1)
    c0 = (2 * t).reshape(-1)
    words = torch.cat([m0, m0 + 8, m0 - 8, m0])
    rows = torch.cat([r0, r0 + 8, r0, r0 + 8])
    cols = torch.cat([c0, c0, c0 + 8, c0 + 8])
    out = []
    for part in (0, 1):
        n = T + 2 * TAP_PAD
        lo, hi = unpair(pairs[part * n : (part + 1) * n][words])
        A = torch.zeros(64, 16)
        A[rows, cols], A[rows, cols + 1] = lo, hi
        out.append(A)
    return tuple(out)


def a_operand32(tp, T, D, v):
    """``A_v (64, 8)`` (hi, lo) from the TF32 split taps."""
    n = torch.arange(64)[:, None]
    k = torch.arange(8)[None, :]
    idx = TAP_PAD + D + n - k - 8 * v
    return tp[idx], tp[idx + T + 2 * TAP_PAD]


@lru_cache(maxsize=None)
def _a16(pairs_key, T, D, v):
    return a_operand16(torch.from_numpy(np.frombuffer(pairs_key,
                                                      np.int32).copy()),
                       T, D, v)


def conv_rung(src, taps, D, ncols, N=64, mode=0, phase=0, light=None):
    """``out[b, i] = sum_m taps[m] src[b, i + D - m]`` for ``i < 64
    ncols`` as a kernel stage runs it in the core's ``mode``: the source
    split and written quad-major (TF32) or octet-major (bf16), the stage's
    chunks of ``N`` columns, each over the units from ``phase``, a unit
    flagged in ``light`` in one pass, each unit's partial added to the
    total in fp32."""
    taps = np.asarray(taps, np.float32)
    T = len(taps)
    bf = mode >= 2
    kw = 16 if bf else 8
    units = unit_steps(T, D, kw, phase)
    plan_ = chunks(ncols, N)
    nu = stream_rows(max([ncols] + [w for _, _, w in plan_]), D, kw)
    if bf:
        hi, lo = split16(src)
        parts = (octet_major(hi, nu), octet_major(lo, nu))
        key = pair_taps(taps).tobytes()
    else:
        hi, lo = split(src) if mode == 0 else (rna(src), torch.zeros_like(src))
        parts = (quad_major(hi, nu), quad_major(lo, nu))
        tp = torch.from_numpy(_split_taps(taps))
    out = torch.zeros(src.shape[0], 64, ncols)
    for col0, start, w in plan_:
        total = torch.zeros(src.shape[0], 64, w)
        for u, (vb, ve) in enumerate(units):
            kind = mode
            if light is not None and light[u]:
                kind = 4 if bf else 1
            part = torch.zeros_like(total)
            for v in range(vb, ve):
                if bf:
                    ah, al = _a16(key, T, D, v)
                    bh = b_operand16(parts[0], nu, col0, v, w)
                    bl = b_operand16(parts[1], nu, col0, v, w)
                else:
                    ah, al = a_operand32(tp, T, D, v)
                    bh = b_operand(parts[0], nu, col0, v, w)
                    bl = b_operand(parts[1], nu, col0, v, w)
                part = part + passes(kind, ah, al, bh, bl)
            total = total + part
        for U in range(max(start, col0), min(col0 + w, ncols)):
            out[:, :, U] = total[:, :, U - col0]
    return out.transpose(1, 2).reshape(src.shape[0], 64 * ncols)


def psd_operand16(slices, nfft):
    """``(hi, lo)`` of a bf16 PSD's B operand, ``(nfft, nfft)``, read from
    the host's slices as the kernel's descriptors read them: slice ``(cg,
    kk)`` holds rows ``16 kk ..``, columns ``128 cg ..``; a part's core
    matrices sit 2048 bytes apart along K (LBO) and 128 along N (SBO)."""
    h = torch.from_numpy(np.ascontiguousarray(slices).view(np.uint16)
                         .astype(np.int64) << 16)
    words = torch.where(h >= 1 << 31, h - (1 << 32), h).to(
        torch.int32).view(torch.float32)
    nk = nfft // 16
    k = torch.arange(16)[:, None]
    c = torch.arange(128)[None, :]
    out = []
    for part in (0, 1):
        B = torch.zeros(nfft, nfft)
        for cg in range(nfft // 128):
            for kk in range(nk):
                base = (cg * nk + kk) * 4096 + part * 2048
                addr = base + (k // 8) * 1024 + (c // 8) * 64 + (c % 8) * 8 \
                    + k % 8
                B[16 * kk : 16 * kk + 16, 128 * cg : 128 * cg + 128] = \
                    words[addr]
        out.append(B)
    return tuple(out)


def chain_rung(ck, x_ext, n, light=True):
    """The chain kernel's arithmetic at ``ck``'s rungs over ``x_ext = [hb |
    n | ha...]``, at the host's tile, light units as flagged (or every unit
    in full): ``(y, e, psd)`` shaped (C, n), (C, n), (n // 128, C,
    nbins)."""
    x = x_ext.float() / 32768.0 if x_ext.dtype == torch.int16 \
        else x_ext.float()
    C = x.shape[0]
    Tf, L, tj = len(ck.h), len(ck.g), ck.tile
    mf, me, ms = ck.modes
    ylen = tj + ck.lead + ck.tail
    xspan = ylen + Tf - 1
    ntiles = -(-n // tj)
    x = torch.nn.functional.pad(x, (0, ck.hb + ntiles * tj + xspan))
    src = torch.stack([x[:, ck.hb + j * tj - ck.lead - (Tf - 1):][:, :xspan]
                       for j in range(ntiles)], 1).reshape(-1, xspan)
    ys = conv_rung(src, ck.h.numpy(), Tf - 1, ylen // 64, 64, mf, ck.phase_f,
                   ck.light_f if light else None)
    y = ys[:, ck.lead : ck.lead + tj].reshape(C, -1)[:, :n]
    ncols = tj // 64
    e = conv_rung((math.pi / 2) * ys.abs(), ck.g.numpy(), ck.lead + ck.delay,
                  ncols, 128 if ncols >= 256 else 64, me, ck.phase_e,
                  ck.light_e if light else None)
    e = e.clamp_min(0.0) if ck.env_clamp else e
    e = e.reshape(C, -1)[:, :n]
    nfft = ck.nfft
    fr = torch.stack([ys[:, ck.lead + 128 * f : ck.lead + 128 * f + nfft]
                      for f in range(tj // 128)], 1)
    if ms >= 2:
        fh, fl = split16(fr)
        bh, bl = psd_operand16(ck.ws_operand.numpy(), nfft)
    else:
        fh, fl = split(fr) if ms == 0 else (cvt_rna(fr), None)
        bh, bl = psd_operand(ck.ws_slices, nfft)
    s = passes(ms, fh, fl, bh, bl)
    re, im = s[..., 0::2], s[..., 1::2]
    p = re * re + im * im
    psd = torch.cat([re[..., :1] ** 2, p[..., 1:], im[..., :1] ** 2], -1)
    psd = psd.reshape(C, -1, ck.nbins)[:, : n // 128].transpose(0, 1)
    return y, e, psd


# -- the names -----------------------------------------------------------------

def test_names_and_stage_precisions():
    assert P.RUNGS == ("highest", "high", "default", "bf16x3", "bf16x4")
    assert (P.BF16X3, P.BF16X4) == (jax_chain.BF16X3, jax_chain.BF16X4)
    from audian_torch.ops.cuda import chain as port_chain
    assert (port_chain.BF16X3, port_chain.BF16X4) == (P.BF16X3, P.BF16X4)
    assert P.stage_precisions(P.DEFAULT) == (P.DEFAULT,) * 3
    assert P.stage_precisions([P.HIGHEST, P.BF16X3, P.BF16X4]) == \
        (P.HIGHEST, P.BF16X3, P.BF16X4)
    assert [P.core_mode(p) for p in P.RUNGS] == [0, 0, 1, 2, 3]
    assert ChainKernel.DEFAULT_PRECISION == (P.HIGHEST,) * 3
    for bad in ("fast", None, 3, (P.HIGHEST, P.HIGHEST), lax.Precision.HIGH):
        with pytest.raises(ValueError):
            P.stage_precisions(bad)
    with pytest.raises(ValueError):
        P.check(P.BF16X3, P.MATMUL_RUNGS)


@pytest.mark.parametrize("rung", list(JAX_VALUES))
def test_convert_carries_the_jax_values(rung):
    assert convert.precision_from_jax(JAX_VALUES[rung]) == rung
    assert convert.precision_from_jax(rung) == rung
    triple = (lax.Precision.HIGHEST, JAX_VALUES[rung], jax_chain.BF16X3)
    assert convert.precision_from_jax(triple) == (P.HIGHEST, rung, P.BF16X3)


def test_convert_refuses_unknown_values():
    assert convert.precision_from_jax(None) is None
    for bad in ("bf16x2", 1.0, (lax.Precision.HIGHEST,) * 2):
        with pytest.raises(ValueError):
            convert.precision_from_jax(bad)


# -- bf16 rounding and the layouts ---------------------------------------------

def test_bf16_rounds_like_torch():
    """RNE on the bit patterns against ``torch.bfloat16``: random words,
    ties to even both ways, the largest finite values (to inf), NaN of any
    payload, infinities, subnormals and signed zeros."""
    rng = np.random.default_rng(42)
    words = rng.integers(0, 1 << 32, 20000, dtype=np.uint64).astype(np.uint32)
    special = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x3F807FFF,
                        0x3F808001, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F7FFF,
                        0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001,
                        0xFFFFFFFF, 0x00000001, 0x80008000, 0x00000000,
                        0x80000000], np.uint32)
    x = torch.from_numpy(np.concatenate([words, special]).view(np.float32))
    want = x.to(torch.bfloat16).to(torch.float32)
    for got in (bf16(x), torch.from_numpy(bf16_rne(x.numpy()))):
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan].view(torch.int32),
                           want[~nan].view(torch.int32))
    # ties: 1 + 2^-8 (odd neighbour below is even) and 1 + 3 2^-8
    t = torch.tensor([1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8)])
    assert bf16(t).tolist() == [1.0, 1 + 2**-6, -1.0]


def test_split_bf16_is_the_tpu_split_rounded():
    """The host's split: hi = bf16(x), lo = bf16(x - hi); the JAX split's
    lo is the f32 remainder, which the TPU's DEFAULT pass rounds to bf16:
    the same parts, summing to x within 2^-16."""
    rng = np.random.default_rng(42)
    x = rng.standard_normal(4096).astype(np.float32)
    hi, lo = split_bf16(x)
    jh, jl = (np.asarray(v) for v in jax_chain._split_bf16(jnp.asarray(x)))
    assert np.array_equal(hi, jh)
    assert np.array_equal(lo, bf16_rne(jl))
    for part in (hi, lo):
        assert not (part.view(np.uint32) & 0xFFFF).any()
    err = np.abs(hi.astype(np.float64) + lo - x) / np.abs(x)
    assert err.max() <= 2.0**-16
    th, tl = split16(torch.from_numpy(x))
    assert np.array_equal(th.numpy(), hi) and np.array_equal(tl.numpy(), lo)


@pytest.mark.parametrize("nu", [73, 141, 283])
def test_octet_major_layout_round_trip(nu):
    """Every sample of an octet-major stream has its own half-word, the
    bf16 descriptor of a step reads ``src[64 (col0 + U) + 16 v + k]``, for
    any step, column offset and width, and a warp's eight consecutive
    octets land in eight distinct 16-byte bank groups (``nu`` odd)."""
    i = torch.arange(64 * nu)
    halves = om_half(i, nu)
    assert len(set(halves.tolist())) == 64 * nu
    assert int(halves.max()) < 64 * nu
    src = torch.arange(64 * nu, dtype=torch.float64)[None]
    stream = octet_major(src, nu)
    for v in (0, 1, 3, 4, 7, 11):
        for col0, N in ((0, 64), (5, 8), (nu - 64 - 3, 128 - 64)):
            got = b_operand16(stream, nu, col0, v, N)[0]
            k = torch.arange(16)[:, None]
            U = torch.arange(N)[None, :]
            assert torch.equal(got, (64 * (col0 + U) + 16 * v + k).double())
    groups = (torch.arange(8) * nu) % 8
    assert len(set(groups.tolist())) == 8


@pytest.mark.parametrize("T, D", [(142, 141), (1135, 1207), (511, 510),
                                  (54, 53), (7, 80)])
def test_k16_steps_cover_exactly_the_true_taps(T, D):
    """The 64 x 16 slices of steps ``[v_lo, v_hi]`` meet every tap, the
    first and the last slice meet one, their reach stays inside the pad,
    and the units of 128 taps (8 steps) from any base cover the steps once
    each."""
    for kw in (8, 16):
        v_lo, v_hi = core_steps(T, D, kw)
        lo = lambda v: D - kw * v - (kw - 1)     # noqa: E731
        hi = lambda v: D - kw * v + 63           # noqa: E731
        assert lo(v_hi) <= 0 <= hi(v_hi) and lo(v_lo) <= T - 1 <= hi(v_lo)
        assert hi(v_hi + 1) < 0
        assert v_lo == 0 or lo(v_lo - 1) > T - 1
        assert lo(v_hi) - 1 >= -TAP_PAD and hi(v_lo) < T + TAP_PAD
        for phase in range(128 // kw):
            units = unit_steps(T, D, kw, phase)
            steps_ = [v for vs, ve in units for v in range(vs, ve)]
            assert steps_ == list(range(v_lo, v_hi + 1))
            assert all(0 < ve - vs <= 128 // kw for vs, ve in units)


def test_pair_taps_hold_each_register():
    """Word ``TAP_PAD + m`` of a part holds the bf16 bits of ``taps[m]``
    low and ``taps[m - 1]`` high; gathered as the kernel's threads gather
    it, every 64 x 16 slice is the Toeplitz slice of the bf16 parts."""
    rng = np.random.default_rng(42)
    taps = rng.standard_normal(37).astype(np.float32)
    pairs = torch.from_numpy(pair_taps(taps))
    hi, lo = split_bf16(taps)
    n = len(taps) + 2 * TAP_PAD
    assert pairs.shape == (2 * n,)
    for part, ref in ((0, hi), (1, lo)):
        low, high = unpair(pairs[part * n : (part + 1) * n])
        pad = np.pad(ref, TAP_PAD)
        assert np.array_equal(low.numpy(), pad)
        assert np.array_equal(high.numpy(), np.concatenate([[0], pad[:-1]]))
    D = 60
    for v in core_steps(len(taps), D, 16):
        ah, al = a_operand16(pairs, len(taps), D, v)
        nn = np.arange(64)[:, None]
        kk = np.arange(16)[None, :]
        m = nn - kk + D - 16 * v
        ok = (m >= 0) & (m < len(taps))
        for A, ref in ((ah, hi), (al, lo)):
            want = np.where(ok, ref[np.clip(m, 0, len(taps) - 1)], 0.0)
            assert np.array_equal(A.numpy(), want)


def test_psd_slices_bf16_follow_the_descriptor(chains):
    """A bf16 PSD's slices, read as the kernel's descriptors read them,
    give back the bf16 split of the pair-interleaved analysis matrix; a
    slice of 16 bf16 rows takes a TF32 slice's 8 KB, so there are half as
    many."""
    _, tc = chains
    ck = tc.chain_kernel
    ws = _pair_columns(ck.ws.numpy())
    sl = psd_slices_bf16(ws)
    bh, bl = psd_operand16(sl, ck.nfft)
    hi, lo = split_bf16(ws)
    assert np.array_equal(bh.numpy(), hi) and np.array_equal(bl.numpy(), lo)
    assert 2 * sl.nbytes == ck.ws_slices.numel() * 4


# -- the chain at each rung ------------------------------------------------------

@lru_cache(maxsize=None)
def _rung_kernels(name, designs):
    """The port's ChainKernel and the JAX FusedChainKernel of the test
    design (``test_torch_tf32x3.chains``) at one rung, from the same values
    (through ``convert``)."""
    jc, tc = designs
    jvals = tuple(JAX_VALUES[p] for p in RUNGS[name])
    prec = convert.precision_from_jax(jvals)
    ck = tc.chain_kernel
    port = ChainKernel(RATE, tc._h_filt, tc._g_env, tc.env_delay,
                       ck.spec_w.numpy(), ck.nbins, env_clamp=ck.env_clamp,
                       nfft=ck.nfft, device="cpu", precision=prec)
    # one tile of 4096 outputs covers the test's stream: the emulation's
    # cost, not its sums, depends on the tile (each output's units are
    # summed alike at any tile)
    port.tile = 4096
    jk = jax_chain.FusedChainKernel(
        RATE, jc._h_filt, jc._g_env, jc.env_delay, np.asarray(jc.spec_w),
        jc.nbins, env_clamp=jc.env_clamp, nfft=jc.nfft, precision=jvals)
    return port, jk


@lru_cache(maxsize=None)
def _rung_outputs(name, designs, n=3968):
    port, jk = _rung_kernels(name, designs)
    q = _stream(port, n, seed=3)
    got = chain_rung(port, torch.from_numpy(q), n)
    want = tuple(np.asarray(a) for a in jk(jnp.asarray(q), n))
    return q, got, want


@pytest.mark.parametrize("name", list(RUNGS))
def test_chain_rung_matches_jax_and_scipy(name, chains):
    """Each rung's decomposition against the JAX kernel at the same
    precision and against scipy float64: the fp32 contract where the
    filter is HIGHEST, a split-bf16 filter within 1e-5, DEFAULT within
    1e-2 of each output's scale."""
    q, (y, e, s), (jy, je, js) = _rung_outputs(name, chains)
    port, _ = _rung_kernels(name, chains)
    n = y.shape[1]
    sig = q[:, port.hb :].astype(np.float64) / 32768.0
    ys = sps.sosfilt(SOS_F, sig, axis=1)[:, :n]
    es = np.maximum(sps.sosfiltfilt(SOS_E, (np.pi / 2) * np.abs(
        sps.sosfilt(SOS_F, sig, axis=1)), axis=1), 0.0)[:, :n]
    d = port.delay
    if name == "(D,D,D)":
        for got, want in ((y, jy), (e, je), (s, js)):
            scale = float(np.abs(want).max())
            assert float(np.abs(got.numpy() - want).max()) <= \
                TOL_DEFAULT * scale
        assert float(np.abs(y.numpy() - ys).max()) <= \
            TOL_DEFAULT * float(np.abs(ys).max())
        return
    tol_y = TOL
    assert float(np.abs(y.numpy() - jy).max()) <= tol_y
    assert float(np.abs(y.numpy() - ys).max()) <= tol_y
    assert float(np.abs(e.numpy() - je).max()) <= TOL
    assert float(np.abs(e.numpy()[:, d : n - d] - es[:, d : n - d]).max()) \
        <= TOL
    assert psd_db_err(s.numpy(), js) <= TOL_PSD_DB


def test_jax_default_rung_keeps_the_filter_and_splits_the_rest(chains):
    """(HIGHEST, BF16X3, BF16X3) against (HIGHEST,) * 3: the filtered
    stream bit for bit, the envelope and PSD different but within the
    contract (tests/test_fused.py:181-210)."""
    _, (y3, e3, s3), _ = _rung_outputs("(H,H,H)", chains)
    _, (yb, eb, sb), _ = _rung_outputs("(H,B3,B3)", chains)
    assert torch.equal(y3, yb)
    de = float((eb - e3).abs().max())
    assert 0 < de < TOL
    assert float((sb - s3).abs().max()) > 0
    assert psd_db_err(sb.numpy(), s3.numpy()) <= TOL_PSD_DB


def test_bf16x4_filter_tightens_the_x3_split(chains):
    """Against the HIGHEST filter a BF16X3 filter lands within 1e-5 and a
    BF16X4 one at least as close (tests/test_fused.py:244-267)."""
    y_hi = _rung_outputs("(H,H,H)", chains)[1][0]
    d3 = float((_rung_outputs("(B3,B3,B3)", chains)[1][0] - y_hi).abs().max())
    d4 = float((_rung_outputs("(B4,B3,B3)", chains)[1][0] - y_hi).abs().max())
    assert 0 < d3 < TOL
    assert d4 <= d3


# -- light units -------------------------------------------------------------------

@lru_cache(maxsize=None)
def _headline():
    fc = get_preset("bioacoustics").fused(96000.0, eps=2e-6, device="cpu")
    return fc


def _greedy(mass, budget):
    light = set()
    for u in sorted(range(len(mass)), key=lambda u: mass[u]):
        if mass[u] > budget:
            break
        budget -= mass[u]
        light.add(u)
    return light


def _brute_masses(taps, D, kw, phase):
    """Each unit's worst-row L1 mass, summed tap by tap from the slices."""
    a = np.abs(np.asarray(taps, np.float64))
    out = []
    for vs, ve in unit_steps(len(a), D, kw, phase):
        best = 0.0
        for n in range(64):
            m = sum(a[n - k + D - kw * v] for v in range(vs, ve)
                    for k in range(kw) if 0 <= n - k + D - kw * v < len(a))
            best = max(best, m)
        out.append(best)
    return out


@pytest.mark.parametrize("kw", [8, 16])
def test_light_units_on_the_headline_design(kw):
    """The core's units of the headline filter (eps 2e-6) and envelope by
    the JAX rule at the core's own granularity: the masses by brute force,
    the greedy under a thousandth of the taps' mass, the base that leaves
    the most steps light; the filter and the envelope each have light
    units (the JAX flags of the banks stay as the record)."""
    fc = _headline()
    ck = ChainKernel(96000.0, fc._h_filt, fc._g_env, fc.env_delay,
                     fc.chain_kernel.spec_w.numpy(), fc.nbins, device="cpu",
                     precision=P.HIGHEST if kw == 8 else P.BF16X3)
    for taps, D, phase, flags in (
            (fc._h_filt, len(fc._h_filt) - 1, ck.phase_f, ck.light_f),
            (fc._g_env, ck.lead + ck.delay, ck.phase_e, ck.light_e)):
        assert (phase, flags) == light_units(taps, D, kw)
        total = float(np.abs(taps).sum())
        mass = unit_masses(taps, D, kw, phase)
        if len(taps) < 200:
            assert np.allclose(mass, _brute_masses(taps, D, kw, phase),
                               rtol=1e-12, atol=0)
        light = _greedy(mass, LIGHT_MASS_FRAC * total)
        assert flags == tuple(u in light for u in range(len(mass)))
        assert any(flags) and not all(flags)
        assert sum(m for m, f in zip(mass, flags) if f) <= \
            LIGHT_MASS_FRAC * total
        best = max(sum(ve - vs for u, (vs, ve) in enumerate(
            unit_steps(len(taps), D, kw, p)) if u in _greedy(
                unit_masses(taps, D, kw, p), LIGHT_MASS_FRAC * total))
            for p in range(128 // kw))
        spans = unit_steps(len(taps), D, kw, phase)
        assert sum(ve - vs for (vs, ve), f in zip(spans, flags) if f) == best
    jk = jax_chain.FusedChainKernel._active
    assert ck.act_f == jk(ck.wf) and ck.act_e == jk(ck.we)


def _light_vs_full(taps, D, mode, src, ncols, N=64):
    phase, light = light_units(taps, D, 16 if mode >= 2 else 8)
    a = conv_rung(src, taps, D, ncols, N, mode, phase, light)
    b = conv_rung(src, taps, D, ncols, N, mode, phase, None)
    return float((a - b).abs().max())


@pytest.mark.parametrize("mode", [0, 2])
def test_light_units_against_every_unit_full(mode):
    """The headline filter (at HIGHEST) and envelope with their light
    units in one pass (TF32 at HIGHEST, bf16 at BF16X3, the JAX default's
    envelope) against every unit in full, on a gated tone plus noise:
    inside 1e-6 and 5e-6, and non-zero: the demotion is live."""
    fc = _headline()
    ck = fc.chain_kernel
    rng = np.random.default_rng(42)
    n = 64 * 40 + 2048
    t = np.arange(n) / 96000.0
    x = 0.5 * np.sin(2 * np.pi * 5000 * t) * (np.sin(2 * np.pi * 30 * t) > 0)
    x = torch.from_numpy((x + 0.05 * rng.standard_normal((2, n))).astype(
        np.float32))
    if mode == 0:
        dy = _light_vs_full(fc._h_filt, len(fc._h_filt) - 1, mode, x, 24)
        assert 0 < dy < TOL_LIGHT[0]
    de = _light_vs_full(fc._g_env, ck.lead + ck.delay, mode,
                        (math.pi / 2) * x.abs(), 8)
    assert 0 < de < TOL_LIGHT[1]


def boundary_taps(taps, nblocks=3):
    """``taps`` with a flat alternating-sign tail over ``nblocks`` 128-tap
    blocks of 0.98 of the light budget (tests/test_device_tpu.py:266-274;
    chip_smoke.py builds the same)."""
    mass = float(np.abs(taps).sum())
    total = 0.98 * LIGHT_MASS_FRAC * mass / (1.0 - 0.98 * LIGHT_MASS_FRAC)
    tail = np.full(nblocks * 128, total / (nblocks * 128))
    tail[1::2] *= -1.0
    return np.concatenate([np.asarray(taps, np.float64), tail])


@pytest.mark.parametrize("mode", [0, 2])
def test_light_units_at_the_boundary(mode):
    """The adversarial design of tests/test_device_tpu.py:256-316 on the
    core's units: the light mass just under the budget, full-scale signals
    sign-matched to the tail (Nyquist alternation, DC, clipped noise, a
    square wave); the demoted stage within 1e-5 of every unit full: the
    filter at HIGHEST, the envelope at HIGHEST and BF16X3."""
    fc = _headline()
    kw = 16 if mode >= 2 else 8
    rng = np.random.default_rng(7)
    n = 64 * 16 + 2048
    sig = torch.from_numpy(np.stack([
        np.tile([1.0, -1.0], n // 2), np.ones(n),
        np.clip(rng.standard_normal(n) / 3.0, -1.0, 1.0),
        np.sign(np.sin(2 * np.pi * 30000.0 * np.arange(n) / 96000.0))]
    ).astype(np.float32))
    designs = [boundary_taps(fc._g_env)]
    if mode == 0:
        designs.insert(0, boundary_taps(fc._h_filt))
    for taps in designs:
        D = len(taps) - 1
        phase, light = light_units(taps, D, kw)
        mass = unit_masses(taps, D, kw, phase)
        share = sum(m for m, f in zip(mass, light) if f) / float(
            np.abs(taps).sum())
        assert 0.5 * LIGHT_MASS_FRAC < share <= LIGHT_MASS_FRAC
        if len(taps) > 1000:      # the envelope: a 64-column slice is enough
            assert _light_vs_full(taps, D, mode, sig[:, :64 * 2 + D + 16],
                                  2) < TOL
        else:
            assert _light_vs_full(taps, D, mode, sig, 16) < TOL


# -- window_matmul at DEFAULT ------------------------------------------------------

def window_one_pass(x, w, S, nframes, premap):
    """``window_matmul`` at DEFAULT as the kernel sums it: one TF32 pass,
    A rounded by ``cvt.rna`` (a NaN stays a NaN) and w's hi part, in blocks
    of 128 taps."""
    K = w.shape[0]
    x = x.float() / 32768.0 if x.dtype == torch.int16 else x.float()
    if premap == "rectify":
        x = (math.pi / 2) * x.abs()
    elif premap == "square":
        x = x * x
    need = (nframes - 1) * S + K
    x = torch.nn.functional.pad(x, (0, max(0, need - x.shape[1])))
    fr = x[:, :need].unfold(1, K, S)
    acc = 0.0
    for k0 in range(0, K, 128):
        acc = acc + cvt_rna(fr[..., k0 : k0 + 128]) @ rna(w[k0 : k0 + 128])
    return acc


WINDOW_NAMES = ["bioacoustics filter", "bioacoustics envelope",
                "bioacoustics psd", "EnvDet band-pass, dequant",
                "EnvDet decimating envelope, square"]


@pytest.mark.parametrize("name", WINDOW_NAMES)
def test_window_matmul_default_matches_jax(name):
    """The one-pass sum against the JAX ``window_matmul(precision=
    DEFAULT)`` (exact on the CPU) and float64, within 1e-2 of the output
    scale; the port's plain version at DEFAULT is exact float32."""
    w, S, nfr, premap = _window_case(name)
    K = w.shape[0]
    rng = np.random.default_rng(42)
    n = (nfr - 1) * S + K - 21
    x = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
    if premap == "dequant":
        x = np.round(np.clip(x, -1, 1) * 32767).astype(np.int16)
    got = window_one_pass(torch.from_numpy(x), w, S, nfr, premap).numpy()
    jp = {None: None, "rectify": _rectify, "dequant": _dequant,
          "square": _square}[premap]
    want = np.asarray(jax_wm(jnp.asarray(x), jnp.asarray(w.numpy()), S, nfr,
                             premap=jp, out_layout="fco",
                             precision=lax.Precision.DEFAULT)).transpose(
        1, 0, 2)
    plain = window_matmul(torch.from_numpy(x), w, S, nfr, premap,
                          precision=P.DEFAULT).transpose(0, 1).numpy()
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= TOL_DEFAULT * scale
    assert float(np.abs(plain - want).max()) <= TOL * scale
    assert float(np.abs(got - want).max()) > 0


@pytest.mark.parametrize("bits", [0x7FFFF000, 0x7F800001, 0xFFFFFFFF])
def test_window_default_keeps_nan(bits):
    """One pass keeps a NaN of any payload a NaN (``cvt.rna``), where the
    3-pass split's integer rounding of hi may turn it finite or infinite
    and leaves it to lo (test_torch_tf32x3.test_window_split_keeps_nan)."""
    x = torch.tensor([bits - (1 << 32) if bits >= 1 << 31 else bits],
                     dtype=torch.int32).view(torch.float32)
    assert bool(torch.isnan(cvt_rna(x)))
    assert bool(torch.isnan(trunc(cvt_rna(x))))


@pytest.mark.parametrize("bad", [P.BF16X3, P.BF16X4, "fast",
                                 lax.Precision.HIGHEST])
def test_window_matmul_refuses_other_rungs(bad):
    x = torch.zeros(1, 300)
    w = torch.zeros(128, 8)
    for fn in (window_matmul, window_matmul_plain):
        with pytest.raises(ValueError):
            fn(x, w, 128, 2, precision=bad)


# -- EnvDet and EnvDetKernel --------------------------------------------------------

ENV_DESIGN = (8000.0, (1500.0, 3000.0), 900.0)


def _env_sos():
    rate, band, cutoff = ENV_DESIGN
    return (sps.butter(1, band, "bandpass", fs=rate, output="sos"),
            sps.butter(1, cutoff, "lowpass", fs=rate, output="sos"))


@pytest.mark.parametrize("rung", [P.HIGHEST, P.HIGH, P.DEFAULT])
def test_envdet_takes_the_matmul_rungs(rung):
    """Both forms take HIGHEST, HIGH and DEFAULT (the port's CPU call is
    the exact plain version, as the JAX package's DEFAULT is exact on its
    CPU backend): each within 1e-5 of the JAX EnvDet at the same
    precision; the kernel's band-pass runs its rung's mode with light
    units."""
    sos = _env_sos()
    args = (4, 300, 2048)
    jprec = JAX_VALUES[rung]
    port_k = EnvDetKernel(*(FilterDesign.from_sos(s) for s in sos), *args,
                          precision=convert.precision_from_jax(jprec),
                          device="cpu")
    port_2 = EnvDet(*(FilterDesign.from_sos(s) for s in sos), *args,
                    precision=rung, device="cpu")
    jd = JaxEnvDet(*(JaxDesign.from_sos(s) for s in sos), *args,
                   precision=jprec)
    jk = JaxEnvDetKernel(*(JaxDesign.from_sos(s) for s in sos), *args,
                         precision=jprec)
    assert port_k.mode == (1 if rung == P.DEFAULT else 0)
    assert port_k.precision == port_2.precision == rung
    rng = np.random.default_rng(42)
    W = port_k.window_need(2048)
    xw = np.round(np.clip(0.3 * rng.standard_normal((W, 2)), -1, 1)
                  * 32767).astype(np.int16)
    want = np.asarray(jd(jnp.asarray(xw), 2048))
    scale = float(np.abs(want).max())
    for got in (port_k(torch.from_numpy(xw), 2048),
                port_2(torch.from_numpy(xw), 2048),
                np.asarray(jk(jnp.asarray(xw), 2048))):
        assert float(np.abs(np.asarray(got) - want).max()) <= TOL * scale


@pytest.mark.parametrize("bad", [P.BF16X3, P.BF16X4, "fast"])
def test_envdet_refuses_the_split_rungs(bad):
    """The split-bf16 rungs are refused by both forms, as the JAX
    package's decimating stage cannot take them."""
    fd, ed = (FilterDesign.from_sos(s) for s in _env_sos())
    for cls in (EnvDet, EnvDetKernel):
        with pytest.raises(ValueError):
            cls(fd, ed, 4, 300, 2048, precision=bad, device="cpu")


@pytest.mark.parametrize("mode", [0, 1])
def test_envdet_band_pass_rungs(mode):
    """The detector's band-pass (511 taps) on the core at 3xTF32 and one
    pass, its light units in one pass, against float64: within 1e-5 and
    1e-2 of the scale, and the light units within 1e-5 of every unit
    full."""
    fd = FilterDesign.from_sos(sps.butter(1, (1000.0, 10000.0), "bandpass",
                                          fs=96000.0, output="sos"))
    ed = FilterDesign.from_sos(sps.butter(1, 500.0, "lowpass", fs=96000.0,
                                          output="sos"))
    k = EnvDetKernel(fd, ed, 19, 300, 4096,
                     precision=(P.HIGHEST, P.DEFAULT)[mode], device="cpu")
    assert k.mode == mode and any(k.light)
    rng = np.random.default_rng(42)
    ncols = 4
    x = torch.from_numpy((0.3 * rng.standard_normal(
        (2, 64 * ncols + k.lb + 16))).astype(np.float32))
    got = conv_rung(x, k.g_bp_np, k.lb - 1, ncols, 64, mode, k.phase,
                    k.light)
    full = conv_rung(x, k.g_bp_np, k.lb - 1, ncols, 64, mode, k.phase)
    ref = torch.nn.functional.conv1d(
        x.double()[:, None], torch.flip(k.g_bp.double(), (0,))[None, None]
    )[:, 0, : 64 * ncols]
    scale = float(ref.abs().max())
    tol = (TOL, TOL_DEFAULT)[mode]
    assert float((got.double() - ref).abs().max()) <= tol * scale
    assert float((got - full).abs().max()) <= TOL * scale


# -- the FIR path ---------------------------------------------------------------------

def test_fir_default_scopes_the_tf32_flags(monkeypatch):
    """``sosfilt_fir``, ``sosfiltfilt_sym`` and ``_conv1d_same_causal`` at
    DEFAULT allow TF32 in cuBLAS and cuDNN for the call only and leave
    both flags as they found them; HIGHEST runs with both off; the split
    rungs are refused.  On the CPU every rung is exact float32."""
    seen = []
    conv1d = torch.nn.functional.conv1d

    def spy(*a, **k):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return conv1d(*a, **k)

    monkeypatch.setattr(port_sos.F, "conv1d", spy)
    kernels = FilterDesign.from_sos(design_filter(RATE, 1000.0,
                                                  8000.0)).fir
    rng = np.random.default_rng(42)
    x = torch.from_numpy(rng.standard_normal((3000, 2)).astype(np.float32))
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        for flags in ((False, True), (True, False)):
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags
            outs = {}
            for rung in (P.DEFAULT, P.HIGHEST, P.HIGH):
                seen.clear()
                outs[rung] = port_sos.sosfilt_fir(kernels, x, precision=rung)
                port_sos.sosfiltfilt_sym(kernels.h, 10, x, precision=rung)
                port_sos._conv1d_same_causal(x, kernels.h, precision=rung)
                want = (rung == P.DEFAULT,) * 2
                assert seen and all(s == want for s in seen)
                assert (torch.backends.cuda.matmul.allow_tf32,
                        torch.backends.cudnn.allow_tf32) == flags
            assert torch.equal(outs[P.DEFAULT], outs[P.HIGHEST])
            for bad in (P.BF16X3, "fast"):
                with pytest.raises(ValueError):
                    port_sos.sosfilt_fir(kernels, x, precision=bad)
                assert (torch.backends.cuda.matmul.allow_tf32,
                        torch.backends.cudnn.allow_tf32) == flags
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# -- shared memory and plans ------------------------------------------------------------

def chain_smem_formula(Tf, delay, lead, tail, tile, mode_f, mode_e):
    """``geometry``/``smem_bytes`` of csrc/chain.cu, written out: each
    stream part 256 (TF32) or 128 (bf16) bytes a row of its own rows."""
    def rows(ncols, D, mode):
        kw = 16 if mode >= 2 else 8
        return ((64 * ncols + D + kw - 1 + 63) // 64) | 1

    def part(mode, nu):
        return (128 if mode >= 2 else 256) * nu

    ylen = tile + lead + tail
    xspan = ylen + Tf - 1
    nu_f = rows(max(ylen // 64, 64), Tf - 1, mode_f)
    nu_e = rows(max(tile // 64, 64), lead + delay, mode_e)
    x = max(2 * part(mode_f, nu_f), 2 * part(mode_e, nu_e), 8 * 16384)
    y = max(4 * ylen, (4 * xspan + 32 + 15) & ~15)
    return x + y + 8 * (3 + 2 * 8)


MODE_PAIRS = [(0, 0), (1, 1), (0, 2), (2, 2), (3, 2), (2, 0)]


@pytest.mark.parametrize("modes", MODE_PAIRS)
def test_chain_smem_and_tile_for_every_mode(modes):
    """The host's shared-memory formula equals the kernel's for the
    stages' modes, the tile it picks is the widest that fits, and a bf16
    stage never narrows it."""
    n_designs = 0
    for nfft in (128, 256, 512):
        for Tf in (63, 175, 1023):
            for L in (15, 1393, 4001, 9001, 14511, 16001):
                delay = (L - 1) // 2
                lead, tail, _ = geometry(Tf, L, delay, nfft)
                for tile in TILES:
                    assert smem_bytes(Tf, L, delay, lead, tail, nfft, tile,
                                      modes) == chain_smem_formula(
                        Tf, delay, lead, tail, tile, *modes)
                tile = pick_tile(Tf, L, delay, nfft, modes)
                base = pick_tile(Tf, L, delay, nfft)
                if tile is None:
                    assert base is None
                    continue
                n_designs += 1
                assert smem_bytes(Tf, L, delay, lead, tail, nfft, tile,
                                  modes) <= SMEM_LIMIT
                wider = [t for t in TILES if t > tile]
                if wider:
                    assert smem_bytes(Tf, L, delay, lead, tail, nfft,
                                      min(wider), modes) > SMEM_LIMIT
                assert base is None or tile >= base
    assert n_designs > 30


@pytest.mark.parametrize("name", ["bioacoustics filter",
                                  "bioacoustics envelope", "bioacoustics psd",
                                  "EnvDet decimating envelope, square"])
def test_window_plan_for_one_pass(name):
    """The one-pass (DEFAULT) plan: the ring's stage carries w's hi part
    alone (half the bytes), the plan fits, takes the three-pass one's mode
    with at least its span buffers and a ring of 4 or more, and its shared
    memory is the kernel's formula."""
    w, S, _, premap = _window_case(name)
    K, O = w.shape
    es = 2 if premap == "dequant" else 4
    p1, p3 = plan(K, O, S, es, True), plan(K, O, S, es)
    N, ncb = column_blocks(O)
    s1 = _geometry(K, O, S, es, N, p1.mode, p1.lsh, p1.nbuf, True)[0]
    s3 = _geometry(K, O, S, es, N, p3.mode, p3.lsh, p3.nbuf)[0]
    assert s1 == 2 * 8 * N * 4 and s3 == 2 * s1
    assert p1.mode == p3.mode and p1.ring >= 4 and p1.nbuf >= p3.nbuf
    assert p1.smem == wm_smem_bytes(K, O, S, es, p1.N, p1.mode, p1.lsh,
                                    p1.nbuf, p1.ring, True) <= SMEM_LIMIT
    assert p1.smem == p1.ring * s1 + p1.nbuf * _geometry(
        K, O, S, es, N, p1.mode, p1.lsh, p1.nbuf, True)[1] + 8 * (4 + 16)
