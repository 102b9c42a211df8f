"""The benchmark probes' kernels (``audian_torch/ops/cuda/probes.py``,
``csrc/probes.cu``) and sweeps (``audian_torch.probes``) on the CPU.

The plain versions are held bit for bit against the reference's own Pallas
kernel bodies (``benchmarks/*_bench.py``, imported by file path), run
through ``pl.pallas_call`` with the reference's ``BlockSpec`` s at a grid
of 2 in interpret mode: every operation is ``+ 1``, ``+ 2`` or a copy in
float32.  The reference's ``k_matmul`` computes nothing (its
``_selection_mats`` builds one non-zero matrix of eight, and its last
reshape fails to trace), a divergence recorded here: the port's selection
products compute what its docstring describes.  The IFIR envelope, whose
relayouts now go through ``pm_forward`` / ``pm_inverse``, stays bit for
bit the torch-copy composition and within 2e-6 of the JAX package's
(``tests/test_torch_fused.py``'s budget).  The CUDA kernels themselves run
only on the card (``chip_smoke.py`` phase 18)."""

import functools
import importlib.util
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from threadpoolctl import threadpool_limits

from audian_tpu.ops import design_envelope_filter
from audian_tpu.ops.fused import FusedChainCF as JaxChain

from audian_torch.convert import ARRAY_KEYS, IFIR_KEYS, chain_from_arrays
from audian_torch.ops.cuda import _build, chain as chain_mod
from audian_torch.ops.cuda import envdet as envdet_mod
from audian_torch.ops.cuda import probes as P
from audian_torch.ops.cuda import window_matmul as wm_mod
from audian_torch.ops.cuda.window_matmul import window_matmul
from audian_torch.probes import (_common, call_scaling, dma_floor,
                                  phase_restructure)

REPO = Path(__file__).resolve().parents[1]
C = 16
TOL_IFIR = 2e-6


def _bench(name):
    """A probe module of ``benchmarks/``, imported by its file path."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return {n: _bench(n) for n in ("dma_floor_bench", "call_scaling_bench",
                                   "phase_restructure_bench")}


def _x(total, seed=0, bad=True):
    """(16, total) float32 from a seeded numpy generator; with ``bad`` a
    NaN and two infinities where the copies, fills and columns carry
    them."""
    x = np.random.default_rng(seed).standard_normal((C, total)).astype(
        np.float32)
    if bad:
        x[3, 5] = np.nan
        x[0, total // 2] = np.inf       # program 1's x[0, 0] at grid 2
        x[7, 1] = -np.inf               # a go column
    return x


def _vmem(shape, index):
    return pl.BlockSpec(shape, index, memory_space=pltpu.VMEM)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)      # NaNs in the same places


def _row_copy(kernel, x, N):
    """The reference's ``run_copy`` / ``run_pallas`` call over ``x``."""
    f = pl.pallas_call(
        kernel, grid=(x.shape[1] // N,),
        in_specs=[_vmem((C, N), lambda i: (0, i))],
        out_specs=_vmem((C, N), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)
    return np.asarray(f(jnp.asarray(x)))


# -- the copies against the reference's kernel bodies ------------------------

@pytest.mark.parametrize("N", [4096, 8192])
def test_dma_copy_matches_reference(ref, N):
    x = _x(2 * N)
    got = P.copy_add1(torch.from_numpy(x), N)
    _same(got, _row_copy(ref["dma_floor_bench"].copy_kernel, x, N))
    _same(dma_floor.run_copy(torch.from_numpy(x), N), got)


def test_call_scaling_copy_matches_reference(ref):
    mod = ref["call_scaling_bench"]
    x = _x(2 * mod.N, seed=1)
    got = call_scaling.run_kernel(torch.from_numpy(x))
    _same(got, _row_copy(mod.copy_kernel, x, mod.N))
    _same(call_scaling.run_torch(torch.from_numpy(x)), got)


@pytest.mark.parametrize("N", [8192, 32768])
def test_copy_pm_matches_reference(ref, N):
    x = _x(2 * N, seed=2)
    xpm = dma_floor.to_program_major(torch.from_numpy(x), N)
    np.testing.assert_array_equal(
        xpm.numpy(), x.reshape(C, 2, N).transpose(1, 0, 2))
    f = pl.pallas_call(
        ref["dma_floor_bench"].copy_pm_kernel, grid=(2,),
        in_specs=[_vmem((1, C, N), lambda i: (i, 0, 0))],
        out_specs=_vmem((1, C, N), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((2, C, N), jnp.float32),
        interpret=True)
    want = np.asarray(f(jnp.asarray(xpm.numpy())))
    _same(P.copy_pm_add1(xpm), want)
    _same(dma_floor.run_copy_pm(xpm), want)


@pytest.mark.parametrize("nbins", [129, 128, 256])
def test_outputs_match_reference(ref, nbins):
    """The chain's six output blocks, as the reference's ``run_outputs``
    builds them (N = 8192, F = 64 frames a program)."""
    N, nprog = 8192, 2
    F, total = N // 128, 2 * N
    x = _x(total, seed=3)
    x[0, 2] = -0.0                     # the fills add it to zeros
    specs = [
        _vmem((C, N), lambda i: (0, i)), _vmem((C, N), lambda i: (0, i)),
        _vmem((1, F, C, nbins), lambda i: (i, 0, 0, 0)),
        _vmem((1, 1, C), lambda i: (i, 0, 0)),
        _vmem((1, 1, C), lambda i: (i, 0, 0)),
        _vmem((1, C, nbins), lambda i: (i, 0, 0))]
    shapes = [(C, total), (C, total), (nprog, F, C, nbins), (nprog, 1, C),
              (nprog, 1, C), (nprog, C, nbins)]
    f = pl.pallas_call(
        ref["dma_floor_bench"].outputs_kernel, grid=(nprog,),
        in_specs=[_vmem((C, N), lambda i: (0, i))], out_specs=specs,
        out_shape=[jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes],
        compiler_params=pltpu.CompilerParams(
            vmem_limit_bytes=100 * (1 << 20)),
        interpret=True)
    want = f(jnp.asarray(x))
    got = P.outputs_floor(torch.from_numpy(x), N, nbins)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _same(g, w)
    assert np.signbit(got[5].numpy()[0]).sum() == 0     # 0 + -0 is +0
    assert np.isinf(got[2].numpy()[1]).all()            # program 1's fill
    for g, w in zip(dma_floor.run_outputs(torch.from_numpy(x), N, nbins),
                    got):
        _same(g, w)
    assert dma_floor.outputs_bytes(C, total, N, nbins) == 4 * sum(
        int(np.prod(s)) for s in shapes[:1] + shapes)


# -- the phase-major relayout -------------------------------------------------

def _restructure(ref, kernel, x, **kw):
    mod = ref["phase_restructure_bench"]
    f = pl.pallas_call(
        functools.partial(kernel, **kw), grid=(2,),
        in_specs=[_vmem((mod.C, mod.N), lambda i: (0, i))],
        out_specs=_vmem((mod.C, mod.N), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)
    return np.asarray(f(jnp.asarray(x)))


def test_restructure_baseline_and_reshape_match_reference(ref):
    mod = ref["phase_restructure_bench"]
    assert (mod.C, mod.M, mod.N) == (phase_restructure.C, phase_restructure.M,
                                     phase_restructure.N)
    x = _x(2 * mod.N, seed=4)
    xt = torch.from_numpy(x)
    _same(phase_restructure.run_base(xt), _restructure(ref, mod.k_base, x))
    want = _restructure(ref, mod.k_reshape, x)
    _same(phase_restructure.run_reshape(xt), want)
    _same(P.pm_roundtrip_add1(xt, mod.N, mod.M), want)
    _same(phase_restructure.run_torch_reshape(xt), want)


def test_reference_k_matmul_computes_nothing(ref):
    """The reference's fault, a divergence the port does not copy: its
    selection matrices hold ones in the first of eight only, and its
    kernel's last reshape of a (C N / 1024, 128) array into (C, N) fails
    to trace."""
    mod = ref["phase_restructure_bench"]
    mats = mod._selection_mats()
    assert [float(m.sum()) for m in mats] == [128.0] + [0.0] * 7
    with pytest.raises(TypeError, match="cannot reshape"):
        _restructure(ref, mod.k_matmul, _x(2 * mod.N, bad=False), mats=mats)


def _group_pm(x, M=8):
    """numpy: within each group of 128 M samples, phase row m holds
    samples m, m + M, m + 2 M, ..."""
    out = np.empty_like(x)
    G = 128 * M
    for g in range(x.shape[1] // G):
        for m in range(M):
            out[:, g * G + 128 * m : g * G + 128 * (m + 1)] = \
                x[:, g * G + m : (g + 1) * G : M]
    return out


def test_selection_matrices():
    """One 1 in each output lane across the 8 source blocks; the kernel's
    one matrix U is each S[b, m]'s non-zero columns; the sum of products
    over b is the group-local relayout."""
    S = P.selection_mats()
    assert S.shape == (8, 8, 128, 128) and S.dtype == np.float32
    np.testing.assert_array_equal(S.sum(axis=(0, 2)), np.ones((8, 128)))
    np.testing.assert_array_equal(S.sum(axis=(1, 3)), np.ones((8, 128)))
    # the one matrix the kernel multiplies by: U[i, 16 m + j] = 1 iff
    # i == m + 8 j
    i, col = np.ix_(np.arange(128), np.arange(128))
    U = (i == col // 16 + 8 * (col % 16)).astype(np.float32)
    np.testing.assert_array_equal(U.sum(axis=0), np.ones(128))
    np.testing.assert_array_equal(U.sum(axis=1), np.ones(128))
    for b in range(8):
        for m in range(8):
            np.testing.assert_array_equal(S[b, m][:, 16 * b : 16 * b + 16],
                                          U[:, 16 * m : 16 * m + 16])
            assert S[b, m].sum() == 16
    x = _x(4 * P.GROUP, seed=5, bad=False)
    X = x.reshape(C, 4, 8, 128).astype(np.float64)
    prod = np.einsum("cgbi,bmik->cgmk", X, S.astype(np.float64))
    np.testing.assert_array_equal(prod.reshape(C, -1).astype(np.float32),
                                  _group_pm(x))


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_select_plain_is_group_relayout(precision):
    x = _x(3 * P.GROUP, seed=6)
    want = _group_pm(x) + np.float32(1.0)
    got = P.select_pm_add1(torch.from_numpy(x), precision=precision)
    _same(got, want)
    _same(phase_restructure.run_select(torch.from_numpy(x), precision), want)


def test_select_refuses():
    x = torch.zeros((2, P.GROUP))
    with pytest.raises(ValueError):
        P.select_pm_add1(x, precision="bf16x3")
    with pytest.raises(ValueError):
        P.select_pm_add1(torch.zeros((2, P.GROUP + 128)))


def _pm_numpy(u, M):
    C_, n = u.shape
    out = np.empty((C_ * M, n // M), np.float32)
    for c in range(C_):
        for m in range(M):
            out[c * M + m] = u[c, m::M]
    return out


@pytest.mark.parametrize("M", [4, 8])
@pytest.mark.parametrize("n_u", [4096 + 164 * 8, 4096 + 97 * 4])
def test_pm_relayouts_on_slices(M, n_u):
    """``u[:, :n_u]`` of a wider stream, as stage A leaves it (a ragged
    n_u: no whole 128-sample block), and ``e_pm[:, :q]`` of a wider one:
    the plain relayouts equal the torch reshape and transpose and the
    numpy index formula, and invert each other."""
    n_u -= n_u % M
    wide = torch.from_numpy(_x(-(-n_u // 128) * 128 + 128, seed=7))
    u = wide[:, :n_u]
    assert not u.is_contiguous()
    Q = n_u // M
    u_pm = P.pm_forward(u, M)
    _same(u_pm, u.reshape(C, Q, M).transpose(1, 2).reshape(C * M, Q))
    _same(u_pm, _pm_numpy(u.numpy(), M))
    e_wide = torch.from_numpy(
        np.random.default_rng(8).standard_normal((C * M, Q + 100)).astype(
            np.float32))
    e_pm = e_wide[:, :Q]
    back = P.pm_inverse(e_pm, M)
    _same(back, e_pm.reshape(C, M, Q).transpose(1, 2).reshape(C, n_u))
    _same(P.pm_forward(back, M), e_pm.contiguous())
    _same(P.pm_inverse(u_pm, M), u.contiguous())


def test_pm_refuses():
    u = torch.zeros((2, 64))
    for M in (0, P.MAX_STRIDE + 1):
        with pytest.raises(ValueError):
            P.pm_forward(u, M)
    with pytest.raises(ValueError):
        P.pm_forward(torch.zeros((2, 30)), 8)
    with pytest.raises(ValueError):
        P.pm_inverse(torch.zeros((12, 5)), 8)
    with pytest.raises(ValueError):
        P.pm_forward(torch.zeros((2, 64), device="meta"), 8)
    with pytest.raises(TypeError):
        P.pm_forward(torch.zeros((2, 64), dtype=torch.float64), 8)
    with pytest.raises(ValueError):
        P.pm_roundtrip_add1(torch.zeros((2, 8192)), 8192, 16)


# -- the IFIR envelope on the relayouts ---------------------------------------

@pytest.fixture(scope="module")
def ifir_pair():
    """The JAX package's IFIR chain at 48 kHz / 500 Hz, and the port's
    rebuilt from its arrays (the factors fitted once)."""
    with threadpool_limits(1):
        jc = JaxChain(48000.0, env_sos=design_envelope_filter(48000.0, 500.0),
                      eps=1e-8, ifir=True)
    assert jc.env_mode == "ifir"
    arrays = {k: getattr(jc, k) for k in ARRAY_KEYS + IFIR_KEYS}
    arrays = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in arrays.items()}
    return jc, chain_from_arrays(arrays, device="cpu")


def _torch_copy_envelope(tc, y):
    """The IFIR envelope with the torch relayouts it ran before (the
    relayouts' plain versions)."""
    C_, n = y.shape
    B, M = tc.block, tc.ifir_M
    n_pad = -(-n // M) * M
    xp = torch.nn.functional.pad(y, (tc.env_halo, tc.env_delay + n_pad - n))
    n_u = n_pad + (tc.ifir_Lg - 1) * M
    u = window_matmul(xp, tc.env_i_w, B, -(-n_u // B), premap="rectify",
                      out_layout="cf")[:, :n_u]
    q_out = n_pad // M
    u_pm = P.pm_forward_plain(u, M)
    e_pm = window_matmul(u_pm, tc.env_g_w, B, -(-q_out // B),
                         out_layout="cf")[:, :q_out]
    e = P.pm_inverse_plain(e_pm, M)
    return torch.clamp_min(e[:, :n], 0.0)


@pytest.mark.parametrize("n", [12000, 11997])
def test_ifir_envelope_unchanged(ifir_pair, n):
    jc, tc = ifir_pair
    rng = np.random.default_rng(9)
    t = np.arange(n) / 48000.0
    x = np.sin(2 * np.pi * 5000.0 * t) * (np.sin(2 * np.pi * 6.0 * t) > 0)
    y = np.stack([x, 0.5 * x, -x]) + 0.05 * rng.standard_normal((3, n))
    y = y.astype(np.float32)
    got = tc.envelope_cf(torch.from_numpy(y))
    _same(got, _torch_copy_envelope(tc, torch.from_numpy(y)))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jc.envelope_cf(jnp.asarray(y))),
        atol=TOL_IFIR)


# -- the sweeps on the CPU ----------------------------------------------------

def test_sweeps_follow_the_reference_order():
    rows = dma_floor.sweep(device="cpu", channels=2, total=1 << 15,
                           blocks=(4096, 8192), pm_blocks=(8192,),
                           nbins=(129, 128))
    assert [r["label"] for r in rows] == [
        "copy rows N=4096", "copy rows N=8192", "copy contiguous N=8192",
        "y+e+psd(129)+stats", "y+e+psd(128)+stats", "copy rows N=8192 again"]
    rows += call_scaling.sweep(device="cpu", channels=2, powers=(13, 14))
    rows += phase_restructure.sweep(device="cpu", channels=2, nprog=2)
    assert [r["kernel"] for r in rows[-6:]] == [
        "copy_add1", "pm_roundtrip_add1", "torch", "select_pm_add1",
        "select_pm_add1", "copy_add1"]
    assert [r["label"] for r in rows[6:10]] == [
        "kernel copy 2^13 (0 MB in)", "torch  copy 2^13",
        "kernel copy 2^14 (0 MB in)", "torch  copy 2^14"]
    # a CPU run times nothing: no host time stands in for a card's
    assert all(r["ms"] is None and r["gbps"] is None for r in rows)
    assert rows[0]["bytes"] == 2 * 4 * 2 * (1 << 15)


def test_probe_main_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (dma_floor, call_scaling, phase_restructure):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main()


# -- how a probe row is timed -------------------------------------------------

def test_measure_times_back_to_back_beside_a_lone_call(monkeypatch):
    """A row's ``ms`` is CALLS calls back to back (as the reference times
    its probes), its rates from it; the lone call is ``lone_ms``."""
    asked = []

    def fake(fn, device=None, reps=_common.REPS, calls=1):
        asked.append(calls)
        return 0.2 if calls > 1 else 0.25

    monkeypatch.setattr(_common, "median_ms", fake)
    row = _common.measure("copy_add1", "copy rows N=8192", lambda: None,
                          2 * 4 * 16 << 22, 1 << 22, torch.device("cuda", 0))
    assert _common.CALLS == 8 and sorted(asked) == [1, _common.CALLS]
    assert row["ms"] == 0.2 and row["lone_ms"] == 0.25
    assert row["gbps"] == pytest.approx((2 * 4 * 16 << 22) / 0.2 / 1e6)
    text = _common.line(row)
    assert "0.2000 ms/call" in text and "lone call 0.2500 ms" in text


# -- the lean launch path -----------------------------------------------------

def _wrappers():
    return [P.copy_add1, P.copy_pm_add1, P.outputs_floor, P.pm_forward,
            P.pm_inverse, P.pm_roundtrip_add1, P.select_pm_add1,
            chain_mod.chain, envdet_mod.envdet, wm_mod.window_matmul,
            wm_mod.split_w]


def test_launches_count_exactly_from_threads():
    """Every wrapper's ``launches`` can be set to 0 and then counts each
    launch of several threads exactly."""
    old = sys.getswitchinterval()
    saved = {w: w.launches for w in _wrappers()}
    sys.setswitchinterval(1e-6)
    try:
        for w in _wrappers():
            w.launches = 0
        workers = [threading.Thread(target=lambda: [
            _build.count_launch(w) for _ in range(300)
            for w in _wrappers()]) for _ in range(8)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in workers)
        assert {w.__name__: w.launches for w in _wrappers()} == {
            w.__name__: 8 * 300 for w in _wrappers()}
    finally:
        sys.setswitchinterval(old)
        for w, n in saved.items():
            w.launches = n


def test_cpu_tensors_run_the_plain_versions():
    """A CPU tensor takes the plain version and counts no launch; the
    results are the plain versions' bit for bit."""
    x = torch.from_numpy(_x(1 << 13, bad=False))
    before = {w: w.launches for w in _wrappers()}
    pairs = [(P.copy_add1(x, 4096), P.copy_add1_plain(x, 4096)),
             (P.copy_pm_add1(x.reshape(2, C, -1)),
              P.copy_pm_add1_plain(x.reshape(2, C, -1))),
             (P.outputs_floor(x, 4096), P.outputs_floor_plain(x, 4096)),
             (P.pm_forward(x, 8), P.pm_forward_plain(x, 8)),
             (P.pm_inverse(x, 8), P.pm_inverse_plain(x, 8)),
             (P.pm_roundtrip_add1(x, 4096), P.pm_roundtrip_add1_plain(x,
                                                                     4096)),
             (P.select_pm_add1(x), P.select_pm_add1_plain(x))]
    for got, want in pairs:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert {w: w.launches for w in _wrappers()} == before


@pytest.mark.parametrize("call", [
    lambda m: P.copy_add1(m, 1024),
    lambda m: P.copy_pm_add1(m.reshape(1, 4, 1024)),
    lambda m: P.outputs_floor(m, 1024),
    lambda m: P.pm_forward(m, 2),
    lambda m: P.pm_inverse(m, 2),
    lambda m: P.pm_roundtrip_add1(m, 1024, 4),
    lambda m: P.select_pm_add1(m),
    lambda m: wm_mod.window_matmul(m, torch.empty((2, 2), device="meta"), 1,
                                   2),
    lambda m: wm_mod.split_w(m),
])
def test_another_device_raises(call):
    """Neither cuda nor cpu: ValueError, as before the launch path was
    shared."""
    with pytest.raises(ValueError, match="meta"):
        call(torch.empty((4, 1024), device="meta"))


def test_load_library_takes_no_lock_once_loaded(monkeypatch):
    """Once loaded, the library is handed out while another thread holds
    the build lock."""
    lib = object()
    monkeypatch.setattr(_build, "_lib", lib)
    got = []
    with _build._lock:
        t = threading.Thread(target=lambda: got.append(_build.load_library()))
        t.start()
        t.join(timeout=10)
    assert got == [lib]
