"""The envdet kernel's tensor-core decomposition, emulated on the CPU.

``csrc/envdet.cu`` reads the time-first window ``(W, C)`` as it lies and
runs both filters as 3xTF32 Toeplitz-block products (``conv_mma`` in
``csrc/toeplitz_mma.cuh``, with the TF32 split of ``test_torch_tf32x3``):

- stage 1, the band-pass, gathers its 16 x 8 tap slices from the host's
  split taps (``EnvDetKernel.bp_split``) by the kernel's index formula and
  multiplies them with row-offset views of the block's input span, split
  once, in blocks of 16 steps;
- the epilogue squares each sample and writes it in polyphase layout,
  ``z_p[n] = y^2[step n + p]``, one stream of ``zs`` words a phase;
- stage 2 sums, over the phases, correlations of ``q = ceil(ll / step)``
  phase taps (``phase_taps``, split into ``EnvDetKernel.lp_split``) with
  ``z_p``; the warps share the phases and add their sums in warp order.

Each piece is held against float64 over the same float32 taps and against
the JAX package: its Pallas ``window_matmul`` over the same banks for the
stages, its Pallas ``EnvDetKernel`` (interpret mode on the CPU) for whole
windows, at 1e-5 of the output scale.  The MMA's own summation order is
not emulated; chip_smoke.py holds the kernel to the same budget on the
card.  The shared-memory formula, the gate that leaves long designs to
``EnvDet``, and the wrapper's window rules are checked here too.
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch
import jax.numpy as jnp

from audian_tpu.ops import FilterDesign as JaxDesign
from audian_tpu.ops.envdet import _dequant, _square
from audian_tpu.ops.pallas.envdet import EnvDetKernel as JaxEnvDetKernel
from audian_tpu.ops.pallas.window_matmul import window_matmul as jax_wm

from audian_torch.analysis import events
from audian_torch.ops.cuda import envdet as envdet_mod
from audian_torch.ops.cuda._build import SMEM_LIMIT
from audian_torch.ops.cuda.chain import TAP_PAD
from audian_torch.ops.cuda.envdet import (TILE_MAX, EnvDetKernel, envdet,
                                          geometry, phase_taps, smem_bytes)
from audian_torch.ops.design import FilterDesign
from audian_torch.ops.envdet import EnvDet, _decimating_bank
from test_torch_tf32x3 import split, steps

TOL = 1e-5
HB = 2048
SMALL = (8000.0, (1500.0, 3000.0), 900.0)    # 63 + 63 taps
DETECT = (96000.0, (1000.0, 10000.0), 500.0)  # the CLI's: 511 + 1023 taps


def _sos(rate, band, cutoff):
    return (sps.butter(1, band, "bandpass", fs=rate, output="sos"),
            sps.butter(1, cutoff, "lowpass", fs=rate, output="sos"))


def _kernel(design, step, nout, hb=HB):
    return EnvDetKernel(*(FilterDesign.from_sos(s) for s in _sos(*design)),
                        step, nout, hb, device="cpu")


def _jax_kernel(design, step, nout, hb=HB):
    return JaxEnvDetKernel(*(JaxDesign.from_sos(s) for s in _sos(*design)),
                           step, nout, hb)


def _window(dtype, W, C=2, seed=3):
    x = np.random.default_rng(seed).standard_normal((W, C)).astype(
        np.float32)
    if dtype == "int16":
        return np.round(np.clip(0.3 * x, -1, 1) * 32767).astype(np.int16)
    return 0.3 * x


# -- the kernel's arithmetic ------------------------------------------------

def conv_mma_tc(src, tp, T, D, ntiles, nphase=1, src_phase=0, tap_phase=0,
                groups=1):
    """``conv_mma``: ``out[b, i] = sum_ph sum_{m<T} taps_ph[m] src[b,
    ph src_phase + i + D - m]`` for ``i < 128 ntiles``, with ``src`` the
    split stream ``(hi, lo)`` and the slices gathered from the host's
    split taps ``tp`` (``[hi | lo]`` blocks ``tap_phase`` apart); the work
    units (blocks of 16 steps of each phase) shared by ``groups`` warp
    groups whose sums are added in group order."""
    hi, lo = src
    v_lo, v_hi = steps(T, D)
    nvb = (v_hi - v_lo + 16) // 16
    units = nphase * nvb
    per = -(-units // groups)
    nn = torch.arange(16)[:, None]
    kk = torch.arange(8)[None, :]
    U = torch.arange(8 * ntiles)[None, :]
    total = 0.0
    for grp in range(groups):
        acc = torch.zeros(hi.shape[0], 16, 8 * ntiles)
        for u in range(grp * per, min((grp + 1) * per, units)):
            ph, ub = divmod(u, nvb)
            vb = v_lo + 16 * ub
            part = torch.zeros_like(acc)
            for v in range(vb, min(vb + 16, v_hi + 1)):
                idx = ph * tap_phase + TAP_PAD + D + nn - kk - 8 * v
                ah, al = tp[idx], tp[idx + T + 2 * TAP_PAD]
                col = ph * src_phase + 16 * U + 8 * v + kk.T
                bh, bl = hi[:, col], lo[:, col]
                part = part + ((ah @ bl + al @ bh) + ah @ bh)
            acc = acc + part
        total = total + acc
    return total.transpose(1, 2).reshape(hi.shape[0], -1)


def polyphase(u, step, zs):
    """The epilogue's layout: ``u`` (B, ny) at word ``(i % step) zs +
    i // step`` of a zeroed ``(B, step zs)`` stream."""
    i = torch.arange(u.shape[1])
    z = torch.zeros(u.shape[0], step * zs)
    z[:, (i % step) * zs + i // step] = u
    return z


def stage1_tc(ed, span):
    """Stage 1 over staged spans ``(B, xwords)``: y over ``ny`` samples."""
    _, ny, nt1, _, _, _ = geometry(ed.lb, ed.ll, ed.step, ed.tile)
    return conv_mma_tc(split(span), ed.bp_split, ed.lb, ed.lb - 1,
                       nt1)[:, :ny]


def stage2_tc(ed, y):
    """Stage 2 over band-passed spans ``(B, ny)``: e over the tile."""
    q, _, _, nt2, _, zs = geometry(ed.lb, ed.ll, ed.step, ed.tile)
    z = polyphase(y * y, ed.step, zs)
    e = conv_mma_tc(split(z), ed.lp_split, q, q - 1, nt2, ed.step, zs,
                    2 * (q + 2 * TAP_PAD), groups=envdet_mod._NWARP)
    return e[:, : ed.tile]


def spans(ed, xw):
    """Each block's staged input span, ``(ntile C, xwords)``, channel
    fastest as the grid: dequantized, zero past ``nx`` and outside
    ``[0, W)``."""
    x = xw.float() / 32768.0 if xw.dtype == torch.int16 else xw.float()
    W, C = x.shape
    _, ny, _, _, xwords, _ = geometry(ed.lb, ed.ll, ed.step, ed.tile)
    ntile = -(-ed.nout // ed.tile)
    j0 = torch.arange(ntile) * ed.tile
    x0 = ed.hb + j0 * ed.step + ed.d_lp - (ed.ll - 1) + ed.d_bp - (ed.lb - 1)
    s = x0[:, None] + torch.arange(xwords)[None, :]
    ok = (torch.arange(xwords) < ny + ed.lb - 1)[None, :] & (s >= 0) & (s < W)
    sp = torch.where(ok[..., None], x[s.clamp(0, W - 1)], 0.0)
    return sp.permute(0, 2, 1).reshape(ntile * C, xwords)


def envdet_tc(ed, xw):
    """The kernel's arithmetic over a window ``xw (W, C)``: (nout, C)."""
    C = xw.shape[1]
    e = stage2_tc(ed, stage1_tc(ed, spans(ed, xw)))
    env = 2.0 * torch.sqrt(torch.clamp_min(e, 0.0))
    return env.reshape(-1, C, ed.tile).transpose(1, 2).reshape(-1, C)[
        : ed.nout]


def envdet_f64(ed, xw):
    """The envelope in float64 over the same float32 taps."""
    x = torch.as_tensor(xw).double().T
    if str(xw.dtype).endswith("int16"):
        x = x / 32768.0
    s0, s1 = ed.hb - ed.lead2, ed.hb + (ed.nout - 1) * ed.step + ed.d_lp
    x0, x1 = s0 + ed.d_bp - (ed.lb - 1), s1 + ed.d_bp + 1
    seg = torch.nn.functional.pad(x[:, x0:x1], (0, max(0, x1 - x.shape[1])))
    g = torch.flip(ed.g_bp.double(), (0,)).reshape(1, 1, -1)
    y = torch.nn.functional.conv1d(seg[:, None], g)[:, 0]
    g = torch.flip(ed.g_lp.double(), (0,)).reshape(1, 1, -1)
    e = torch.nn.functional.conv1d((y * y)[:, None], g, stride=ed.step)[:, 0]
    return (2.0 * torch.sqrt(e.clamp_min(0.0))).T


def assert_close(got, want, scale, what):
    err = float(np.abs(np.asarray(got, np.float64)
                       - np.asarray(want, np.float64)).max())
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"


# -- the host's tap layout and the polyphase stream -------------------------

@pytest.mark.parametrize("step", [1, 3, 7, 19])
def test_phase_taps_sum_to_the_envelope(step):
    """``sum_p sum_m t_p[m] z_p[j + q-1 - m]`` is the envelope sum ``sum_m
    g_lp[m] u[j step + ll-1 - m]`` term for term (float64, random u)."""
    rng = np.random.default_rng(step)
    g = rng.standard_normal(1023).astype(np.float32)
    tp = phase_taps(g, step).astype(np.float64)
    q = tp.shape[1]
    assert tp.shape == (step, -(-1023 // step))
    nout = 40
    u = rng.standard_normal((nout - 1) * step + 1023 + step * q)
    want = [sum(float(g[m]) * u[j * step + 1022 - m] for m in range(1023))
            for j in range(nout)]
    got = [sum(tp[p] @ u[step * (j + q - 1 - np.arange(q)) + p]
               for p in range(step)) for j in range(nout)]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # the taps of each phase keep their float32 values: no tap is lost
    assert np.count_nonzero(tp) == np.count_nonzero(g)


@pytest.mark.parametrize("step", [1, 3, 7, 19])
def test_polyphase_layout_round_trip(step):
    """The epilogue's words ``(i % step) zs + i // step`` are distinct, sit
    before each phase's zero tail and inside the stream; reading ``z_p[n]
    = z[p zs + n]`` gives back ``u[step n + p]`` exactly, and stage 2's
    reads (``128 nt2 + q + 14`` words a phase) stay inside ``zs``."""
    q, ny, _, nt2, _, zs = geometry(511, 1023, step, TILE_MAX)
    u = torch.from_numpy(np.random.default_rng(step).standard_normal(
        (2, ny)).astype(np.float32))
    z = polyphase(u, step, zs).reshape(2, step, zs)
    i = np.arange(ny)
    words = (i % step) * zs + i // step
    assert len(set(words.tolist())) == ny and words.max() < step * zs
    for p in range(step):
        nv = -(-(ny - p) // step)          # the kernel's zero-tail start
        assert torch.equal(z[:, p, :nv], u[:, p::step])
        assert not bool(z[:, p, nv:].any())
    assert 128 * nt2 + q + 14 <= zs


def test_split_taps_follow_the_kernel_layout():
    """``bp_split`` is ``[hi | lo]`` of the band-pass with TAP_PAD zeros
    each side, ``lp_split`` one such block a phase; the slices the kernel
    gathers cover every true tap of each."""
    ed = _kernel(DETECT, 19, 300)
    q = -(-ed.ll // ed.step)
    hi, lo = split(ed.g_bp)
    n = ed.lb + 2 * TAP_PAD
    assert ed.bp_split.shape == (2 * n,)
    assert torch.equal(ed.bp_split[TAP_PAD : TAP_PAD + ed.lb], hi)
    assert torch.equal(ed.bp_split[n + TAP_PAD : n + TAP_PAD + ed.lb], lo)
    assert not bool(ed.bp_split[:TAP_PAD].any())
    blocks = ed.lp_split.reshape(ed.step, 2, q + 2 * TAP_PAD)
    taps = torch.from_numpy(phase_taps(ed.g_lp_np, ed.step))
    hi, lo = split(taps)
    assert torch.equal(blocks[:, 0, TAP_PAD : TAP_PAD + q], hi)
    assert torch.equal(blocks[:, 1, TAP_PAD : TAP_PAD + q], lo)
    for T in (ed.lb, q):
        v_lo, v_hi = steps(T, T - 1)
        # A_v holds taps[T - 1 - 8 v + (-7 .. 15)]
        assert v_lo == 0 and T - 1 - 8 * v_hi - 7 <= 0
        assert T - 1 - 8 * v_hi - 7 > -TAP_PAD and T - 1 + 15 < T + TAP_PAD


# -- the stages ---------------------------------------------------------------

@pytest.mark.parametrize("design", [SMALL, DETECT], ids=["8k", "96k"])
def test_stage1_toeplitz_slices(design):
    """Stage 1 over one int16 span per block against float64 and the JAX
    package's window_matmul (dequant premap) over the band-pass bank."""
    ed = _kernel(design, 19, 300)
    _, ny, nt1, _, xwords, _ = geometry(ed.lb, ed.ll, ed.step, ed.tile)
    q16 = _window("int16", xwords, C=2, seed=5).T.copy()    # (2, xwords)
    y = stage1_tc(ed, torch.from_numpy(q16).float() / 32768.0)
    x64 = torch.from_numpy(q16).double()[:, None] / 32768.0
    g = torch.flip(ed.g_bp.double(), (0,)).reshape(1, 1, -1)
    y64 = torch.nn.functional.conv1d(x64, g)[:, 0, :ny]
    bank = EnvDet(*(FilterDesign.from_sos(s) for s in _sos(*design)), 19,
                  300, HB, device="cpu").w_bp
    yj = np.asarray(jax_wm(jnp.asarray(q16), jnp.asarray(bank.numpy()), 128,
                           nt1, premap=_dequant, out_layout="fco"))
    yj = yj.transpose(1, 0, 2).reshape(2, -1)[:, :ny]
    scale = float(y64.abs().max())
    assert_close(y, y64, scale, "stage 1 vs float64")
    assert_close(y, yj, scale, "stage 1 vs JAX")


@pytest.mark.parametrize("step", [1, 3, 7, 19])
def test_stage2_polyphase_sum(step):
    """Stage 2 (the square, the polyphase layout and the sum over phases of
    Toeplitz MMAs) over a band-passed span against float64 and the JAX
    package's window_matmul (square premap) over the decimating bank."""
    ed = _kernel(DETECT, step, 600)
    _, ny, _, nt2, _, _ = geometry(ed.lb, ed.ll, ed.step, ed.tile)
    y = torch.from_numpy((0.2 * np.random.default_rng(step).standard_normal(
        (2, ny))).astype(np.float32))
    e = stage2_tc(ed, y)
    u = (y.double() ** 2)[:, None]
    g = torch.flip(ed.g_lp.double(), (0,)).reshape(1, 1, -1)
    e64 = torch.nn.functional.conv1d(u, g, stride=step)[:, 0, : ed.tile]
    b2 = _decimating_bank(ed.g_lp_np, step)
    need = (nt2 - 1) * 128 * step + b2.shape[0]
    yp = np.pad(y.numpy(), [(0, 0), (0, max(0, need - ny))])
    ej = np.asarray(jax_wm(jnp.asarray(yp), jnp.asarray(b2), 128 * step, nt2,
                           premap=_square, out_layout="fco"))
    ej = ej.transpose(1, 0, 2).reshape(2, -1)[:, : ed.tile]
    scale = float(e64.abs().max())
    assert_close(e, e64, scale, "stage 2 vs float64")
    assert_close(e, ej, scale, "stage 2 vs JAX")


# -- whole windows ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("step", [1, 3, 7, 19])
def test_envdet_decomposition_matches_jax(step, dtype):
    nout = 2048 // step
    x = _window(dtype, 40000)
    ed = _kernel(SMALL, step, nout)
    got = envdet_tc(ed, torch.from_numpy(x))
    want = np.asarray(_jax_kernel(SMALL, step, nout)(x, HB))
    ref = envdet_f64(ed, x)
    assert got.shape == want.shape == (nout, 2)
    scale = float(ref.abs().max())
    assert_close(got, want, scale, "kernel arithmetic vs JAX EnvDetKernel")
    assert_close(got, ref, scale, "kernel arithmetic vs float64")


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_envdet_decomposition_detector_design(dtype):
    """The song detector's 96 kHz design (511 + 1023 taps, step 19) over a
    short window: two blocks a channel, the second one partial."""
    nout = 300
    ed = _kernel(DETECT, 19, nout)
    assert ed.tile == TILE_MAX and nout % ed.tile
    x = _window(dtype, ed.window_need(HB) + 100, seed=7)
    got = envdet_tc(ed, torch.from_numpy(x))
    want = np.asarray(_jax_kernel(DETECT, 19, nout)(x, HB))
    ref = envdet_f64(ed, x)
    scale = float(ref.abs().max())
    assert_close(got, want, scale, "kernel arithmetic vs JAX EnvDetKernel")
    assert_close(got, ref, scale, "kernel arithmetic vs float64")


# -- shared memory and the gate -----------------------------------------------

@pytest.mark.parametrize("cutoff,step,tile", [
    (500.0, 19, 256),      # the CLI's default: two blocks an SM
    (500.0, 1, 256),
    (200.0, 48, 128),      # the CLI's 200 Hz design: the tile halves
])
def test_smem_bytes_follows_the_geometry(cutoff, step, tile):
    """``smem_bytes`` is the split span (or the stage-2 meeting point)
    plus the split polyphase stream, and the host takes the widest tile
    that fits a block."""
    fd, edes = (FilterDesign.from_sos(s)
                for s in _sos(96000.0, (1000.0, 10000.0), cutoff))
    ed = EnvDetKernel(fd, edes, step, 5000, events.detect_halo(fd, edes),
                      device="cpu")
    q, ny, nt1, nt2, xwords, zs = geometry(ed.lb, ed.ll, step, ed.tile)
    assert ed.tile == tile
    assert (q, ny) == (-(-ed.ll // step), (tile - 1) * step + ed.ll)
    assert xwords >= 128 * nt1 + ed.lb - 1 + 15 and xwords % 32 == 0
    assert zs >= 128 * nt2 + q - 1 + 15 and zs % 32 == 0
    want = 4 * (max(2 * xwords, (envdet_mod._NWARP - 1) * 128 * nt2)
                + 2 * step * zs)
    assert smem_bytes(ed.lb, ed.ll, step, tile) == want <= SMEM_LIMIT
    if tile < TILE_MAX:
        assert smem_bytes(ed.lb, ed.ll, step, 2 * tile) > SMEM_LIMIT
    if (cutoff, step) == (500.0, 19):
        assert want == 104960


def test_gate_on_both_sides():
    """The CLI design takes the kernel; a 100 Hz envelope at the CLI's
    step (96) spans more than a block holds at any tile, so the kernel
    refuses it and the chunk driver takes the two-stage EnvDet."""
    fd = FilterDesign.from_sos(_sos(*DETECT)[0])
    cpu = torch.device("cpu")
    for cutoff, cls in ((500.0, EnvDetKernel), (100.0, EnvDet)):
        edes = FilterDesign.from_sos(_sos(96000.0, (1000.0, 10000.0),
                                          cutoff)[1])
        step = int(round(96000.0 / (10 * cutoff)))
        halo = events.detect_halo(fd, edes)
        ed, _ = events._make_envdet(fd, edes, step, halo, cpu)
        assert type(ed) is cls
        if cls is EnvDet:
            assert smem_bytes(ed.lb, ed.ll, step, 1) > SMEM_LIMIT
            with pytest.raises(ValueError, match="shared memory"):
                EnvDetKernel(fd, edes, step, 5000, halo, device="cpu")


# -- the wrapper's window rules -----------------------------------------------

@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("C", [1, 3, 16])
def test_time_first_window_any_channel_count(C, dtype):
    """A contiguous ``(W, C)`` window, int16 or float32, goes through the
    wrapper as it lies (its plain version on the CPU) and through the
    kernel's arithmetic, both against the JAX package."""
    step, nout = 7, 150
    x = _window(dtype, 4096, C=C, seed=C)
    ed = _kernel(SMALL, step, nout)
    want = np.asarray(_jax_kernel(SMALL, step, nout)(x, HB))
    scale = float(np.abs(want).max())
    xt = torch.from_numpy(x)
    assert xt.is_contiguous() and xt.shape == (4096, C)
    for got in (envdet(ed, xt), envdet_tc(ed, xt)):
        assert got.shape == (nout, C)
        assert_close(got, want, scale, f"C = {C}")


@pytest.mark.parametrize("view", ["transposed", "strided"])
def test_non_contiguous_window_refused(view):
    """The kernel reads rows ``C`` samples apart: a view with other
    strides is refused with a clear error (no hidden copy)."""
    ed = _kernel(SMALL, 7, 150)
    x = torch.from_numpy(_window("int16", 4096, C=4))
    xv = (x.T.contiguous().T if view == "transposed" else x[:, ::2])
    assert xv.ndim == 2 and not xv.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        envdet(ed, xv)
    with pytest.raises(ValueError, match="contiguous"):
        ed(xv, HB)
    with pytest.raises(TypeError, match="int16 or floating"):
        envdet(ed, x.to(torch.int32))
