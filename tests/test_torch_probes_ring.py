"""The ring kernels of the benchmark probes (``csrc/probes.cu``:
``pm_roundtrip_kernel`` and ``select_pm_kernel``) and the copies'
one-shot ``copy_flat_kernel``, their addressing emulated on the CPU.

Both kernels run a persistent grid whose blocks walk their items while a
producer bulk-copies each item's rows into a ring of shared-memory stages.
The emulations below follow the kernels' index arithmetic word for word,
block by block over the grid that the host's plan gives
(:func:`~audian_torch.ops.cuda.probes.roundtrip_grid`,
:func:`~audian_torch.ops.cuda.probes.select_grid`, here for a few SMs so
that the items are not a multiple of the grid):

- the round trip: each item's row piece copied in stages of up to
  ``RT_CHUNK`` samples, unpadded; each thread's 16-byte word of a stage
  relaid to four phase rows of the padded phase-major buffer, + 1 there;
  the buffer read back four phase rows a 16-byte store.  The buffer holds
  the item's phase-major relayout + 1, every word written once, and both
  the relay and the read-back touch 32 distinct banks a warp instruction;
- the selection products: each item (64 rows x one source block) copied a
  row at a time at a pitch of ``SELECT_PITCH`` words; the A fragments
  read from the stage with 16-byte loads that fall in distinct banks for
  each quarter-warp; U built by the kernel's word formula and read back
  through its wgmma descriptor; the products in the wgmma's D layout,
  summed as the tensor cores sum them (a 0/1 operand: each output is one
  product, hi and lo parts added in float32), and the accumulators stored
  by the epilogue's map.

The copies' kernel runs ``copy_add1`` and ``copy_pm_add1`` over the
tensor's words as one flat range: the blocks of the grid mirror
(:func:`~audian_torch.ops.cuda.probes.copy_grid`) each take a tile of
``COPY_U`` x ``COPY_NT`` 16-byte vectors, all a thread's loads before its
stores, the last ``n % 4`` words one a thread of the last block; a tensor
not 16-byte aligned takes the same tiles word by word.  Every word is
written exactly once.

Each result is held bit for bit against the plain version (the selection
against the plain relayout of its own TF32 parts) and, for the selection,
within the card's budget of ``chip_smoke.py`` (2^-20 max|x| at HIGHEST,
2^-10 at DEFAULT).  chip_smoke.py phase 18 checks the plan formulas
against the library's own on the card.
"""

import numpy as np
import pytest
import torch

from audian_torch.ops.cuda import probes as P
from audian_torch.ops.cuda._build import SMEM_LIMIT

TOL_SELECT = {"highest": 2.0 ** -20, "default": 2.0 ** -10}


def _x(C, T, seed, bad=()):
    x = np.random.default_rng(seed).standard_normal((C, T)).astype(
        np.float32)
    for c, t, v in bad:
        x[c, t] = v
    return x


def _distinct_banks(words):
    """Whether the words of one access (a warp's 32, or a quarter-warp's
    8 x 4) lie in distinct banks, one word a bank."""
    words = np.asarray(words).reshape(-1)
    return len(words) == 32 and len(set(int(w) % 32 for w in words)) == 32


# -- the round trip -----------------------------------------------------------

def _pm_words(f, M, row, q0=0):
    """Phase-major words of thread f's 16-byte word (four samples): phases
    4 f mod M .. + 3 of column q0 + 4 f / M, one row apart."""
    lgm = int(M).bit_length() - 1
    f = np.asarray(f)[..., None]
    return ((4 * f) & (M - 1)) * row + q0 + ((4 * f) >> lgm) \
        + row * np.arange(4)


def _claims(items, grid, seed):
    """The counter's items in order, each to the block that claims next
    (a seeded draw: blocks claim at their own pace), then one claim past
    the end for every block."""
    rng = np.random.default_rng(seed)
    return [(it, int(rng.integers(grid))) for it in range(items)]


def emulate_roundtrip(x, block, M, sms, seed=0):
    """``pm_roundtrip_kernel`` over ``x`` (C, T): the items claimed from
    the counter by the blocks of the grid, each block's producer stages,
    its consumers' relay into the phase-major rows and their stores.
    Returns y and the block that took each item."""
    C, T = x.shape
    sw = min(block, P.RT_CHUNK)
    row = P.roundtrip_row(block, M)
    grid = P.roundtrip_grid(C, T, block, M, sms)
    nblk = T // block
    nch = -(-block // sw)
    y = np.full_like(x, np.nan)
    # a block's ring, its count of stages and its phase-major rows
    ring = np.zeros((grid, P.RT_RING, sw), np.float32)
    s = [0] * grid
    pm = np.full((grid, M * row), np.float32(-7.0))  # no word of it is x + 1
    taken = {}
    for it, blk in _claims(C * nblk, grid, seed):
        taken[it] = blk
        c, j_blk = divmod(it, nblk)
        src = x[c, j_blk * block:(j_blk + 1) * block]
        written = np.zeros(M * row, np.int64)
        for j in range(nch):
            st = s[blk] % P.RT_RING
            n = min(sw, block - j * sw)
            ring[blk, st, :n] = src[j * sw:j * sw + n]      # the bulk copy
            f = np.arange(n // 4)
            q0 = (j * sw) // M
            words = _pm_words(f, M, row, q0)
            pm[blk, words] = ring[blk, st, :n].reshape(-1, 4) \
                + np.float32(1.0)
            np.add.at(written, words.reshape(-1), 1)
            s[blk] += 1
        # the relayout stays: pm holds the item's phase rows + 1, each word
        # once, the rows' padding untouched
        Q = block // M
        rows = pm[blk].reshape(M, row)
        np.testing.assert_array_equal(
            rows[:, :Q], src.reshape(Q, M).T + np.float32(1.0))
        assert (written.reshape(M, row)[:, :Q] == 1).all()
        assert (written.reshape(M, row)[:, Q:] == 0).all()
        f = np.arange(block // 4)
        y[c, j_blk * block:(j_blk + 1) * block] = \
            pm[blk][_pm_words(f, M, row)].reshape(-1)
    return y, taken


def _plain_rt(x, block, M):
    return P.pm_roundtrip_add1_plain(torch.from_numpy(x), block, M).numpy()


@pytest.mark.parametrize("M", [4, 8])
@pytest.mark.parametrize("C, block, nprog, sms", [
    (4, 8192, 3, 5),         # the headline block, 12 items on a grid of 10
    (3, 6176, 3, 4),         # C = 3, the last stage of an item short
    (2, 96, 7, 3),           # items smaller than a stage
])
def test_roundtrip_emulation_is_plain_bit_for_bit(M, C, block, nprog, sms):
    T = block * nprog
    x = _x(C, T, seed=11, bad=((0, 5, np.nan), (C - 1, T - 1, np.inf),
                              (C // 2, block + 3, -np.inf)))
    want = _plain_rt(x, block, M)
    for seed in (0, 1):
        y, taken = emulate_roundtrip(x, block, M, sms, seed)
        np.testing.assert_array_equal(y, want)
    # every item once, on a grid that does not divide them
    items = C * nprog
    assert sorted(taken) == list(range(items))
    grid = P.roundtrip_grid(C, T, block, M, sms)
    assert grid <= items and (items % grid or items == grid)


@pytest.mark.parametrize("M", [4, 8])
@pytest.mark.parametrize("block", [8192, 6176, 4096 + 32, 96])
def test_roundtrip_banks(M, block):
    """Each warp instruction of the relay's and the read-back's scalar
    accesses touches 32 distinct banks (the phase rows padded to 4 mod 8
    words); an unpadded row length would not at M = 8."""
    row = P.roundtrip_row(block, M)
    assert row % 8 == 4 and row >= block // M
    sw = min(block, P.RT_CHUNK)
    for j in range(-(-block // sw)):
        n = min(sw, block - j * sw)
        for f0 in range(0, n // 4 - 31, 32):
            w = _pm_words(np.arange(f0, f0 + 32), M, row, (j * sw) // M)
            for k in range(4):
                assert _distinct_banks(w[:, k])
            # the stage's 16-byte words, a quarter-warp at a time
            for q in range(4):
                f = np.arange(f0 + 8 * q, f0 + 8 * q + 8)
                assert _distinct_banks(4 * f[:, None] + np.arange(4))
    if M == 8 and block // M % 8 == 0:
        w = _pm_words(np.arange(32), M, block // M)
        assert not _distinct_banks(w[:, 0])


def test_roundtrip_plan():
    """The shared-memory formula: two stages of up to 2048 samples, the
    phase rows, and two mbarriers and an item index a stage; two blocks an
    SM at the headline (room for four: the grid takes two), blocks up to
    53,984 samples accepted (the earlier kernel's two padded rows stopped
    at 28,576)."""
    assert (P.RT_CHUNK, P.RT_RING, P.RT_PER_SM) == (2048, 2, 2)
    assert P.roundtrip_smem_bytes(8192, 8) == 4 * 2 * 2048 + 4 * 8 * 1028 + 48
    assert P.roundtrip_smem_bytes(8192, 4) == 4 * 2 * 2048 + 4 * 4 * 2052 + 48
    assert P.roundtrip_smem_bytes(96, 8) == 4 * 2 * 96 + 4 * 8 * 12 + 48
    assert P.roundtrip_grid(16, 1 << 22, 8192, 8, 132) == 264
    assert P.roundtrip_grid(3, 5 * 6176, 6176, 4, 132) == 15
    big = 53984
    assert P.roundtrip_smem_bytes(big, 8) <= SMEM_LIMIT
    assert P.roundtrip_smem_bytes(big + 32, 8) > SMEM_LIMIT
    assert P.roundtrip_smem_bytes(big + 32, 4) > SMEM_LIMIT
    assert P.roundtrip_grid(1, 4 * big, big, 8, 132) == 4
    assert P.roundtrip_grid(16, 16 * big, big, 8, 132) == 132
    x = torch.from_numpy(_x(1, big, seed=12))
    assert torch.equal(P.pm_roundtrip_add1(x, big, 8), x + 1.0)
    with pytest.raises(ValueError):
        P.pm_roundtrip_add1(torch.zeros((1, big + 32)), big + 32, 8)


# -- the selection products ---------------------------------------------------

def rna(x):
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it."""
    u = x.view(np.uint32).astype(np.int64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def u_words():
    """U as the kernel's ``build_u`` writes it: 16 k8 steps of K-major core
    matrices, element (k, n) of a step at word 512 (k >> 2) + 32 (n >> 3) +
    4 (n & 7) + (k & 3); source sample i is K index t + 4 (r4 & 1) of step
    2 p + (r4 >> 1) (i = 16 p + 4 t + r4), output jj of phase m column n =
    16 m + 8 ((jj >> 1) & 1) + 2 (jj >> 2) + (jj & 1)."""
    u = np.zeros(16 * 8 * 128, np.float32)
    i = np.arange(128)
    p, t, r4 = i >> 4, (i >> 2) & 3, i & 3
    step, q = 2 * p + (r4 >> 1), r4 & 1
    m, jj = i & 7, i >> 3
    n = 16 * m + 8 * ((jj >> 1) & 1) + 2 * (jj >> 2) + (jj & 1)
    u[step * 1024 + 512 * q + 32 * (n >> 3) + 4 * (n & 7) + t] = 1.0
    return u


def u_steps():
    """B of each step, (16, 8, 128), read through the kernel's descriptor
    (LBO 2048 bytes between the K halves, SBO 128 between 8-row groups
    along N)."""
    k, n = np.ix_(np.arange(8), np.arange(128))
    word = 512 * (k >> 2) + 32 * (n >> 3) + 4 * (n & 7) + (k & 3)
    return np.stack([u_words()[1024 * s + word] for s in range(16)])


# thread (w, g, t) of a consumer warpgroup, as index arrays
W, G_, T_ = np.ix_(np.arange(4), np.arange(8), np.arange(4))


def stage_words(h, p):
    """Stage words of each thread's 16-byte A load of row h's samples
    16 p + 4 t .. + 3, (4, 8, 4, 4)."""
    return ((16 * W + G_ + 8 * h) * P.SELECT_PITCH + 16 * p + 4 * T_)[
        ..., None] + np.arange(4)


def a_matrices(stage):
    """A of the 16 steps (16, 64, 8) from one stage as the consumers read
    it: a0 = row 0's sample 16 p + 4 t + 2 e (K index t of step 2 p + e),
    a1 row 1's, a2 and a3 the next sample of each (K index t + 4)."""
    A = np.zeros((16, 64, 8), np.float32)
    rows = (16 * W + G_) * np.ones_like(T_)
    tt = T_ * np.ones_like(W * G_)
    for p in range(4 * 2):
        v = [stage[stage_words(h, p)] for h in range(2)]   # (4, 8, 4, 4)
        for e in range(2):
            s = 2 * p + e
            A[s, rows, tt] = v[0][..., 2 * e]
            A[s, rows + 8, tt] = v[1][..., 2 * e]
            A[s, rows, tt + 4] = v[0][..., 2 * e + 1]
            A[s, rows + 8, tt + 4] = v[1][..., 2 * e + 1]
    return A


def emulate_select(x, precision, sms, seed=0):
    """``select_pm_kernel`` over ``x`` (C, T): the items claimed from the
    counter by the blocks of the grid, each block's producer copying rows
    into its ring (the warpgroups taking alternate stages), the consumers'
    fragment reads, the products against U in the wgmma's D layout, the
    epilogue's stores.  Returns y and the (block, warpgroup) that took
    each item."""
    C, T = x.shape
    G = T // P.GROUP
    R = C * G
    xr = x.reshape(R, P.GROUP)
    nitems = -(-R // 64) * 8
    grid = P.select_grid(C, T, sms)
    B = u_steps().astype(np.float64)
    y = np.full((R, P.GROUP), np.nan, np.float32)
    ring = np.zeros((grid, P.SELECT_RING, 64 * P.SELECT_PITCH), np.float32)
    s = [0] * grid                      # a block's count of stages
    taken = {}
    with np.errstate(invalid="ignore", over="ignore"):
        for it, blk in _claims(nitems, grid, seed):
            k = s[blk]
            s[blk] += 1
            taken.setdefault(it, []).append((blk, k % 2))
            tile, b = divmod(it, 8)
            st = k % P.SELECT_RING
            rows = min(64, R - 64 * tile)
            view = ring[blk, st].reshape(64, P.SELECT_PITCH)
            view[:rows, :128] = xr[64 * tile:64 * tile + rows,
                                   128 * b:128 * b + 128]
            A = a_matrices(ring[blk, st])
            if precision == "default":
                parts = [rna(A)]
            else:
                hi = rna(A)
                parts = [rna(A - hi), hi]               # lo first
            D = np.zeros((64, 128), np.float32)
            for part in parts:
                # one product a column (U is a permutation): exact in
                # float64, then added to the float32 accumulators
                prod = np.einsum("smk,skn->mn", part.astype(np.float64),
                                 B)
                D = (D + prod.astype(np.float32)).astype(np.float32)
            # the thread's accumulators d[4 j + e] = D[16 w + g + 8 (e
            # >> 1)][8 j + 2 t + (e & 1)], stored as row h's phase m:
            # d[8 m + 2 h + {0, 1, 4, 5}] at 128 m + 16 b + 4 t .. + 3
            for h in range(2):
                for m in range(8):
                    idx = 8 * m + 2 * h + np.array([0, 1, 4, 5])
                    j, e = idx >> 2, idx & 3
                    w4, g4, t4 = (a[..., None] for a in (W, G_, T_))
                    drow = 16 * w4 + g4 + 8 * (e >> 1) + 0 * t4
                    dcol = 8 * j + 2 * t4 + (e & 1) + 0 * (w4 + g4)
                    vals = D[drow, dcol] + np.float32(1.0)
                    r = 64 * tile + 16 * w4 + g4 + 8 * h + 0 * (t4 + j)
                    out = 128 * m + 16 * b + 4 * t4 + np.arange(4) \
                        + 0 * r
                    ok = r < R
                    y[r[ok], out[ok]] = vals[ok]
    return y.reshape(C, T), taken


def _tf32_relayout(x, precision):
    """The plain relayout + 1 of the value the tensor cores sum: x rounded
    to TF32 (DEFAULT), or its hi and lo parts added in float32."""
    if precision == "default":
        v = rna(x)
    else:
        hi = rna(x)
        with np.errstate(invalid="ignore"):
            v = (rna(x - hi) + hi).astype(np.float32)
    return P.select_pm_add1_plain(torch.from_numpy(v)).numpy()


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("C, groups, sms", [
    (2, 32, 7),       # R = 64, one tile: 8 items on a grid of 7
    (3, 37, 5),       # C = 3, R = 111: the last tile 47 rows
    (1, 72, 5),       # R = 72: the last tile 8 rows
])
def test_select_emulation(precision, C, groups, sms):
    T = P.GROUP * groups
    x = _x(C, T, seed=13)
    for seed in (0, 1):
        y, taken = emulate_select(x, precision, sms, seed)
        np.testing.assert_array_equal(y, _tf32_relayout(x, precision))
    plain = P.select_pm_add1_plain(torch.from_numpy(x)).numpy()
    tol = TOL_SELECT[precision] * float(np.abs(x).max())
    assert float(np.abs(y - plain).max()) <= tol
    # every item once; both warpgroups of a block busy where it has two
    nitems = -(-(C * groups) // 64) * 8
    assert sorted(taken) == list(range(nitems))
    assert all(len(v) == 1 for v in taken.values())
    grid = P.select_grid(C, T, sms)
    assert {wg for v in taken.values() for _, wg in v} == {0, 1}
    assert nitems % grid or nitems == grid


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_select_nan_spreads_over_its_row_and_block(precision):
    """One NaN (or infinity) in a source block makes exactly the 128
    outputs of its row in that block non-finite: y[c, 1024 g + 128 m +
    16 b + j] for every phase m and j < 16, all NaN but, at DEFAULT (no lo
    part), an infinity's own output (inf x 1 + 1)."""
    C, groups = 3, 37
    T = P.GROUP * groups
    for c, g, b, i, v in ((1, 5, 3, 77, np.nan), (2, 36, 7, 0, np.inf),
                          (0, 0, 0, 127, -np.inf)):
        x = _x(C, T, seed=14)
        x[c, P.GROUP * g + 128 * b + i] = v
        y, _ = emulate_select(x, precision, 4)
        want = np.zeros((C, T), bool)
        for m in range(8):
            base = P.GROUP * g + 128 * m + 16 * b
            want[c, base:base + 16] = True
        np.testing.assert_array_equal(~np.isfinite(y), want)
        own = (c, P.GROUP * g + 128 * (i % 8) + 16 * b + i // 8)
        if precision == "default" and np.isinf(v):
            assert y[own] == v and np.isnan(y).sum() == 127
        else:
            assert np.isnan(y).sum() == 128


def test_select_stage_banks():
    """Each quarter-warp's 16-byte A loads from a stage touch 32 distinct
    banks at the pitch of 144 words (rows 16 banks apart); at a pitch of
    128, as an unpadded copy would land, two rows share theirs."""
    for h in range(2):
        for p in range(8):
            words = stage_words(h, p)                   # (w, g, t, 4)
            for w in range(4):
                for q in range(4):                      # lanes 8 q .. 8 q + 7
                    assert _distinct_banks(words[w, 2 * q:2 * q + 2])
    flat = (np.arange(2)[:, None] * 128 + 4 * np.arange(4))[..., None] \
        + np.arange(4)
    assert not _distinct_banks(flat)


def test_select_u_is_the_permutation():
    """U read back through the descriptor, in the kernel's A order
    (source sample i = 16 p + 4 t + 2 e + q at K index t + 4 q of step
    2 p + e) and D order (output jj of phase m at column 16 m + 8 ((jj >>
    1) & 1) + 2 (jj >> 2) + (jj & 1)), is U[i, 16 m + jj] = 1 iff i = m +
    8 jj."""
    B = u_steps()
    assert B.sum() == 128 and set(np.unique(B)) == {0.0, 1.0}
    got = np.zeros((128, 128), np.float32)
    for s in range(16):
        p, e = divmod(s, 2)
        for k in range(8):
            t, q = k & 3, k >> 2
            i = 16 * p + 4 * t + 2 * e + q
            for n in range(128):
                m, r = divmod(n, 16)
                jj = 4 * ((r & 7) >> 1) + 2 * (r >> 3) + (r & 1)
                got[i, 16 * m + jj] += B[s, k, n]
    i, col = np.ix_(np.arange(128), np.arange(128))
    np.testing.assert_array_equal(got, (i == col // 16 + 8 * (col % 16)))


def test_select_plan():
    """U, four stages of 64 rows at the padded pitch and eight mbarriers
    fit one block; one block an SM, no more than the items."""
    assert P.select_smem_bytes() == 4 * (16384 + 4 * 64 * 144) + 96
    assert P.select_smem_bytes() <= SMEM_LIMIT
    assert 4 * (16384 + 5 * 64 * 144) + 120 > SMEM_LIMIT   # no fifth stage
    assert P.select_grid(16, 1 << 22, 132) == 132
    assert P.select_grid(3, 37 * 1024, 132) == 16
    assert P.select_grid(1, 1024, 132) == 8


# -- the copies' one-shot kernel ----------------------------------------------

def emulate_copy(x):
    """``copy_flat_kernel`` over ``x`` (a contiguous CPU tensor): its path
    from the alignment of ``x`` and of a fresh ``y`` (16 bytes, as the
    launcher's ``aligned16``), each block's tile over the grid mirror.
    Returns y (NaN where no thread wrote) and each word's count of
    writes."""
    xs = x.reshape(-1).numpy()
    n = xs.size
    y = np.full(n, np.nan, np.float32)
    writes = np.zeros(n, np.int64)
    grid = P.copy_grid(n)
    vec = x.data_ptr() % 16 == 0 and torch.empty_like(x).data_ptr() % 16 == 0
    t = np.arange(P.COPY_NT)
    one = np.float32(1.0)

    def put(words):
        words = words[words < n]
        y[words] = xs[words] + one
        np.add.at(writes, words, 1)

    for b in range(grid):
        w0 = b * P.COPY_TILE
        if not vec:
            for u in range(4 * P.COPY_U):
                put(w0 + u * P.COPY_NT + t)
            continue
        n4, i0 = n // 4, w0 // 4 + t
        for u in range(P.COPY_U):
            i = i0 + u * P.COPY_NT
            i = i[i < n4]
            put((4 * i[:, None] + np.arange(4)).reshape(-1))
        if b == grid - 1:
            put(4 * n4 + t[t < n % 4])
    return y.reshape(x.shape), writes, vec


def _copy_input(shape, offset=0, seed=7):
    """A contiguous float32 tensor of ``shape`` at ``offset`` words into a
    fresh buffer (a NaN and an infinity planted), as a view."""
    n = int(np.prod(shape))
    buf = torch.from_numpy(_x(1, n + offset + 8, seed)[0]).clone()
    x = buf[offset:offset + n].view(shape)
    x.reshape(-1)[n // 2] = float("nan")
    x.reshape(-1)[n - 1] = float("inf")
    return x


@pytest.mark.parametrize("shape, offset, vec", [
    ((3, 4100), 0, True),       # the last tile in part
    ((3, 4099), 0, True),       # a scalar tail of one word
    ((16, 1 << 12), 0, True),   # whole tiles
    ((1, 7), 0, True),          # below one tile: one vector, three words
    ((5, 3, 96), 0, True),      # program-major (nprog, C, N)
    ((3, 4100), 4, True),       # a view at a 16-byte aligned offset
    ((3, 4100), 1, False),      # a view at an odd offset: the scalar path
    ((5, 3, 96), 3, False),
])
def test_copy_emulation_writes_each_word_once(shape, offset, vec):
    x = _copy_input(shape, offset)
    assert x.is_contiguous() and (x.storage_offset() == offset)
    y, writes, took_vec = emulate_copy(x)
    assert took_vec == vec
    assert (writes == 1).all()
    want = (P.copy_add1_plain(x, shape[1]) if len(shape) == 2
            else P.copy_pm_add1_plain(x))
    np.testing.assert_array_equal(y.view(np.int32), want.numpy().view(
        np.int32))
    # the wrappers' CPU path is the plain version
    got = P.copy_add1(x, shape[1]) if len(shape) == 2 else P.copy_pm_add1(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_copy_grid():
    """One block a tile of COPY_TILE words, none for an empty tensor; the
    headline 16 ch x 2^22 is 16384 one-shot blocks."""
    assert P.COPY_TILE == 4 * P.COPY_NT * P.COPY_U == 4096
    assert [P.copy_grid(n) for n in (0, 1, 7, 4096, 4097, 12300)] == [
        0, 1, 1, 1, 2, 4]
    assert P.copy_grid(16 << 22) == 16384
