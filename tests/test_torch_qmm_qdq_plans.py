"""What the CPU can hold of B4's and B1's Hopper designs.

The kernels run only on a GPU (``test_torch_kernels_cuda.py``,
``chip_smoke.py``).  Their geometry is planned on the host, and B4's
cheaper division has a host half, so here:

* ``qdq_launch_plan`` (B4): the scalar head, the float4 body and the
  scalar tail compute every element exactly once, for numel 1, 3, 4, 5,
  4k + 1 and more than one grid-stride sweep, x at storage offsets of 0-3
  elements, and per-channel rows with cols % 4 != 0, whose columns the
  kernel advances without a division (emulated here against the modulo);
  the body stores vectors only where the output is aligned too, and the
  grid stays inside its cap;
* B4's arithmetic (``quant_dequant_host_half``: ``x * exact_inverse(s)``
  where that inverse exists, else ``x / s``) equals ``quant_dequant_plain``
  bit for bit in all 8 rounding-mode names, on ±0, ±inf, NaN, subnormals,
  .5 ties and values near the clip bounds, at scales whose reciprocal is
  subnormal, overflows or is negative, and per column on a row that mixes
  powers of two with other scales;
* ``qmm_launch_plan`` (B1 / B2's CUDA-core body) at TFC's layers and the
  other shapes of the paths: every output tile is covered once, every k
  lies in exactly one cluster rank's range, the ranks' reduce slices
  partition the tile, the cluster size is at most 8 and divides its grid
  axis, shared memory fits the card, and vector and flat staging are
  chosen only where alignment holds;
* a float32 emulation of the split's order of sums (each rank's range in
  K order, the partials in rank order) stays within the order bound of
  ``quant_matmul_plain`` on randn and equals it on dyadic x.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import quant_dequant as qd  # noqa: E402
from repro_torch.kernels import quant_matmul as qm  # noqa: E402

MODES = ("ROUND", "CEIL", "FLOOR", "UP", "DOWN", "HALF_UP", "HALF_DOWN",
         "ROUND_TO_ZERO")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, every NaN counted equal to every NaN (signed
    zeros apart)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        torch.where(na, 0.0, a).view(torch.int32),
        torch.where(nb, 0.0, b).view(torch.int32))


# ------------------------------------------------------------------ B4

@pytest.mark.parametrize("x_phase", range(4))
@pytest.mark.parametrize("numel,cols,max_blocks", [
    (1, 1, qd.QDQ_MAX_BLOCKS), (3, 3, qd.QDQ_MAX_BLOCKS),
    (4, 4, qd.QDQ_MAX_BLOCKS), (5, 5, qd.QDQ_MAX_BLOCKS),
    (4 * 37 + 1, 7, qd.QDQ_MAX_BLOCKS), (4 * 1024 + 1, 6, qd.QDQ_MAX_BLOCKS),
    (9 * 4096 + 3, 13, 2),             # beyond one sweep of a 2-block grid
    (3 * 4096 * 4 + 2, 3, 1)])         # several trips of one block
def test_qdq_plan_covers_every_element_once(numel, cols, max_blocks, x_phase):
    p = qd.qdq_launch_plan(numel, cols, True, x_phase, x_phase, max_blocks)
    assert p.head == min((4 - x_phase) % 4, numel)
    assert p.head + 4 * p.nvec + p.tail == numel and 0 <= p.tail < 4
    assert p.ovec == 1 and p.wide == 0 and 1 <= p.blocks <= max_blocks
    assert p.head + p.tail <= qd.QDQ_THREADS
    counts = np.bincount(p.element_visits(), minlength=numel)
    assert counts.size == numel and (counts == 1).all()
    if max_blocks < qd.QDQ_MAX_BLOCKS and p.nvec:
        assert p.nvec > p.sweep              # the grid-stride loop is exercised


def _kernel_columns(p: qd.QdqPlan) -> np.ndarray:
    """The column of every body element as the kernel finds it: one
    modulo per thread, then adds and one compare (and the wrap inside a
    vector) -- in the kernel's loop order, beside the element index."""
    T = qd.QDQ_THREADS
    dj, dt = 4 * T % p.cols, 4 * p.sweep % p.cols
    idx, col = [], []
    for b in range(p.blocks):
        for t in range(T):
            v0 = b * T * p.unroll + t
            c0 = (p.head + 4 * v0) % p.cols
            while v0 < p.nvec:
                c = c0
                for j in range(p.unroll):
                    v = v0 + j * T
                    if v < p.nvec:
                        for k in range(4):
                            ck = c + k
                            while ck >= p.cols:
                                ck -= p.cols
                            idx.append(p.head + 4 * v + k)
                            col.append(ck)
                    c += dj
                    if c >= p.cols:
                        c -= p.cols
                v0 += p.sweep
                c0 += dt
                if c0 >= p.cols:
                    c0 -= p.cols
    return np.array(idx), np.array(col)


@pytest.mark.parametrize("cols", [1, 2, 3, 5, 7, 130, 4099])
@pytest.mark.parametrize("x_phase", [0, 3])
def test_qdq_per_channel_columns_advance_like_the_modulo(cols, x_phase):
    p = qd.qdq_launch_plan(2 * 4096 + 4 * 300 + 3, cols, True, x_phase, x_phase, 1)
    idx, col = _kernel_columns(p)
    assert len(idx) == 4 * p.nvec
    assert (col == idx % cols).all()


def test_qdq_plan_main_path_rows_and_limits():
    for rows, cols in ((8, 3 * 224 * 224), (8, 401408), (8, 802816), (256, 784),
                       (256, 64)):
        p = qd.qdq_launch_plan(rows * cols, cols, False)
        assert p.head == 0 and p.tail == 0 and p.ovec and not p.wide
        assert p.blocks <= qd.QDQ_MAX_BLOCKS and p.unroll in (1, 2, 4)
        assert p.blocks * qd.QDQ_THREADS * p.unroll >= p.nvec   # one sweep
    # the largest MobileNet rows keep 4 loads in flight a thread and fill
    # several waves; TFC's rows spread over more blocks instead
    assert qd.qdq_launch_plan(8 * 802816, 802816, False).unroll == 4
    assert qd.qdq_launch_plan(256 * 784, 784, False).blocks >= qd.SMS
    # past 2^31 elements the plan takes 64-bit indices and loops
    big = qd.qdq_launch_plan(2 ** 31 + 5, 7, True, 1, 1)
    assert big.wide == 1 and big.blocks == qd.QDQ_MAX_BLOCKS
    assert big.head + 4 * big.nvec + big.tail == 2 ** 31 + 5
    assert -(-big.nvec // big.sweep) > 1


@pytest.mark.parametrize("x_phase,o_phase", [(0, 0), (1, 1), (1, 0), (2, 3), (3, 1)])
def test_qdq_plan_stores_vectors_only_when_aligned(x_phase, o_phase):
    p = qd.qdq_launch_plan(1001, 13, False, x_phase, o_phase)
    assert p.ovec == int((o_phase + p.head) % 4 == 0)
    assert (x_phase + p.head) % 4 == 0            # the body's loads are aligned


def test_qdq_plan_rejects_bad_geometry():
    for args in ((-1, 1, False), (4, 0, False), (4, 1, False, 4)):
        with pytest.raises(ValueError):
            qd.qdq_launch_plan(*args)


# values a quantizer must keep its bits on: signed zeros, infinities, NaN,
# subnormals, .5 ties, and values near the clip bounds (in units of s)
def _edge_x(scale: float) -> np.ndarray:
    tiny = np.float32(2.0 ** -149)
    base = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, tiny, -tiny,
                     2.0 ** -130, -(2.0 ** -127), 1.17549435e-38], np.float32)
    units = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 6.5, 7.5, -7.5, -8.5,
                      7.49, 7.51, -8.49, -8.51, 14.5, 15.5, 126.5, 127.5,
                      -128.5, 300.0, -300.0, 0.25, 3.0], np.float32)
    with np.errstate(all="ignore"):
        near = (units * np.float32(scale)).astype(np.float32)
    rng = np.random.RandomState(7)
    with np.errstate(all="ignore"):
        spread = (rng.randn(40) * 9 * scale).astype(np.float32)
    return np.concatenate([base, near, spread])


# scales whose reciprocal is subnormal (2^127), overflows (2^-149 subnormal
# scale) or is negative (-0.125), the normal extremes, a power of two of the
# zoo and a scale that is no power of two
SCALES = [2.0 ** -149, 2.0 ** -126, 2.0 ** 126, 2.0 ** 127, -0.125, 0.125, 0.37]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scale", SCALES)
def test_host_half_equals_twin_per_tensor(mode, scale):
    x = torch.from_numpy(_edge_x(scale if abs(scale) > 2.0 ** -120 else 1.0)
                         .reshape(1, -1))
    for bits, signed, narrow, zp in ((8, True, False, 0.0), (4, False, True, 3.0),
                                     (2, True, True, -1.0), (7.5, True, False, 0.0)):
        for codes in (False, True):
            kw = dict(bit_width=bits, signed=signed, narrow=narrow, rounding_mode=mode,
                      emit_codes=codes)
            if codes and qd.static_bounds(signed, narrow, bits)[1] > 127:
                continue
            xc = x[torch.isfinite(x)].reshape(1, -1) if codes else x
            got = qd.quant_dequant_host_half(xc, scale, zp, **kw)
            want = qd.quant_dequant_plain(xc, scale, zp, **kw)
            assert same_bits(got, want), kw


@pytest.mark.parametrize("mode", MODES)
def test_host_half_equals_twin_per_channel_mixed_scales(mode):
    """One row whose columns mix powers of two (multiplied) with other
    scales (divided), zero points varying."""
    s = torch.tensor([0.125, 0.37, 2.0 ** -126, 2.0 ** 127, -0.125, 1.0, 2.0 ** -149,
                      3.0, 0.5, 2.0 ** 126, 1e-3], dtype=torch.float32)
    z = torch.tensor([0, 1, -2, 0, 3, 0, 0, -1, 2, 0, 1], dtype=torch.float32)
    rows = [_edge_x(1.0)[:40], _edge_x(0.125)[:40], _edge_x(0.37)[:40]]
    x = torch.from_numpy(np.stack(rows).reshape(-1)[:11 * 10].reshape(10, 11))
    x[3] = x[3] * s                                  # near the grid, per column
    for bits, signed, codes in ((4, True, False), (8, False, False), (3, True, True)):
        kw = dict(bit_width=bits, signed=signed, rounding_mode=mode, emit_codes=codes)
        xc = torch.where(torch.isfinite(x), x, 0.0) if codes else x
        got = qd.quant_dequant_host_half(xc, s, z, **kw)
        assert same_bits(got, qd.quant_dequant_plain(xc, s, z, **kw)), kw
    assert (qd.exact_inverses(s) != 0).tolist() == [
        True, False, True, False, True, True, False, False, True, True, False]


def test_exact_inverses_are_exact_reciprocals():
    """Where the kernel's inverse exists it is the host's exact
    reciprocal; a subnormal scale (whose reciprocal the host would take)
    and every other scale fall back to the division on the card."""
    e = np.arange(-149, 128)
    s = torch.from_numpy(np.concatenate([2.0 ** e, -(2.0 ** e), [0.37, 3.0, 0.0,
                                                                  np.inf, np.nan]])
                         .astype(np.float32))
    inv = qd.exact_inverses(s)
    for sv, iv in zip(s.tolist(), inv.tolist()):
        r = qm.exact_reciprocal(sv)
        if iv != 0:
            assert r == iv and 2.0 ** -126 <= abs(sv) <= 2.0 ** 126
        else:
            assert r is None or abs(sv) < 2.0 ** -126


# ------------------------------------------------------------------ B1

TFC = [(m, k, n) for m in (1, 8, 16, 64, 256)
       for k, n in ((784, 64), (64, 64), (64, 10))]
PLAN_SHAPES = TFC + [(7200, 27, 64), (100352, 27, 32), (8, 1024, 1000),
                     (13, 98, 10), (33, 130, 70), (5, 1, 7), (9, 785, 33),
                     (392, 1024, 1024), (25088, 64, 128), (72, 1152, 256),
                     (8, 2304, 256)]


@pytest.mark.parametrize("epi", [0, 2])
@pytest.mark.parametrize("m,k,n,packed", [(m, k, n, packed) for m, k, n in PLAN_SHAPES
                                          for packed in (False, True)
                                          if k % 2 == 0 or not packed])
def test_qmm_plan_covers_tiles_and_k_once(m, k, n, packed, epi):
    p = qm.qmm_launch_plan(m, k, n, packed, epi)
    bm, bn = p.block
    assert 1 <= p.split <= qm.QMM_CLUSTER_MAX and p.grid[0] % p.split == 0
    assert p.tiles_m * bm >= m > (p.tiles_m - 1) * bm
    assert p.tiles_n * bn >= n > (p.tiles_n - 1) * bn
    assert p.smem == qm.qmm_smem_bytes(p.tile, packed, epi, p.stages, p.bufs)
    assert p.smem <= qm.qmm_smem_bytes(p.tile, packed, epi) <= qm.SMEM_MAX
    assert p.kc % qm.QMM_BK == 0
    # the ring holds every K step of a CTA unless it is whole
    most = -(-min(p.kc, max(k, 1)) // qm.QMM_BK)
    assert p.stages == min(qm.QMM_STAGES, most) and p.bufs == min(2, p.stages)
    if p.split > 1:                  # the partial tiles fit the ring's slots
        bm_, bn_ = p.block
        assert 4 * bm_ * bn_ <= qm.qmm_smem_bytes(p.tile, packed, 0, p.stages, 0)
    seen = {}
    for bx in range(p.grid[0]):
        for by in range(p.grid[1]):
            key = p.block_tile(bx, by)
            seen[key] = seen.get(key, 0) + 1
    assert len(seen) == p.tiles_m * p.tiles_n * p.split
    assert set(seen.values()) == {1}
    ks = np.zeros(k, np.int64)
    for r in range(p.split):
        lo, hi = p.k_range(r)
        assert hi > lo                              # no rank sums nothing
        ks[lo:hi] += 1
    assert (ks == 1).all()
    if p.split > 1:
        elems = np.zeros(bm * bn, np.int64)
        for r in range(p.split):
            e0, e1 = p.reduce_slice(r)
            elems[e0:e1] += 1
        assert (elems == 1).all()


def test_qmm_plan_fills_the_card_at_tfc():
    """The 784-wide layer: about one wave of CTAs in clusters of 7 (16
    blocks before); the serving slot 7 CTAs (2 before); the narrow layers
    keep their 16 blocks unsplit (two K steps)."""
    p = qm.qmm_launch_plan(256, 784, 64, False, 0)
    assert p.split == 7 and p.grid == (112, 1) and qm.QMM_TILE_NAMES[p.tile] == "small"
    assert qm.qmm_launch_plan(16, 784, 64, True, 1).grid == (7, 1)
    assert qm.qmm_launch_plan(256, 64, 64, True, 2).split == 1
    assert qm.QMM_TILE_NAMES[qm.qmm_launch_plan(100352, 27, 32, False, 2).tile] == "tall"
    assert qm.QMM_TILE_NAMES[qm.qmm_launch_plan(7200, 27, 64, False, 0).tile] == "wide"
    assert qm.qmm_launch_plan(8, 1024, 1000, True, 0).grid == (8, 16)


@pytest.mark.parametrize("x_vec,w_vec,o_vec", [(True, True, True), (False, True, True),
                                               (True, False, False), (False, False, True)])
@pytest.mark.parametrize("m,k,n", PLAN_SHAPES[::2] + [(4, 16, 48), (6, 31, 17)])
def test_qmm_plan_staging_only_where_alignment_holds(m, k, n, x_vec, w_vec, o_vec):
    p = qm.qmm_launch_plan(m, k, n, False, 1, x_vec, w_vec, o_vec)
    mode = qm.QMM_XMODES[p.xmode]
    if mode == "flat":
        assert x_vec and 0 < k < qm.QMM_BK and p.split == 1
    elif mode == "vec":
        assert x_vec and k % 4 == 0
    else:
        assert not x_vec or (k % 4 and k >= qm.QMM_BK) or k == 0
    assert p.wvec == int(w_vec and n % 16 == 0)
    assert p.ovec == int(o_vec and n % 4 == 0)


# the convs the gather serves: (rows an image, K, N) of CNV's six and of
# MobileNet-224's first (stride 2, pad 1)
CONVS = [(900, 27, 64), (784, 576, 64), (144, 576, 128), (100, 1152, 128),
         (9, 1152, 256), (1, 2304, 256), (12544, 27, 32)]


@pytest.mark.parametrize("epi", [0, 1, 2])
@pytest.mark.parametrize("m,k,n,packed", [
    (rows * b, k, n, packed) for rows, k, n in CONVS for b in (1, 8, 256)
    for packed in (False, True) if k % 2 == 0 or not packed])
def test_qmm_plan_gather_keeps_the_patch_paths_plan(m, k, n, packed, epi):
    """A gathered conv runs the materialised path's tile, K split, ring and
    shared memory (so the float32 body sums in the same order), with x
    staged by the gather, and its NCHW tile fits the shared memory."""
    a = qm.qmm_launch_plan(m, k, n, packed, epi)
    p = qm.qmm_launch_plan(m, k, n, packed, epi, gather=True)
    same = ("M", "K", "N", "tile", "tiles_m", "tiles_n", "split", "kc",
            "stages", "bufs", "wvec", "smem")
    assert [getattr(p, f) for f in same] == [getattr(a, f) for f in same]
    assert qm.QMM_XMODES[p.xmode] == "gather" and p.ovec == 0
    bm, bn = p.block
    assert 4 * (bm + 1) * bn <= p.smem
    for tile in qm.QMM_TILES:
        ov = (tile, 1, qm.qmm_min_stages(tile, packed, epi, k, 1))
        assert qm.qmm_launch_plan(m, k, n, packed, epi, override=ov,
                                  gather=True).smem == \
            qm.qmm_launch_plan(m, k, n, packed, epi, override=ov).smem


def test_qmm_plan_rejects_bad_problems():
    for args in ((4, 7, 3, True, 0), (4, 8, 3, False, 3), (-1, 8, 3, False, 0)):
        with pytest.raises(ValueError):
            qm.qmm_launch_plan(*args)


def _emulate_split(x, w, s, plan):
    """The float32 body's sums as the kernel takes them: each rank's K
    range in K order, one rounding per step (the FMA, emulated by a
    float64 product and sum rounded to float32: the product of two float32
    is exact in float64, so the sum rounds twice at most), the partials
    added in rank order, then the scale."""
    parts = []
    for r in range(plan.split):
        lo, hi = plan.k_range(r)
        acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32)
        for k in range(lo, hi):
            acc = (acc.double() + x[:, k:k + 1].double() * w[k:k + 1].double()).float()
        parts.append(acc)
    tot = parts[0]
    for p in parts[1:]:
        tot = tot + p
    return tot * s


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m,k,n", [(16, 784, 64), (3, 130, 70), (5, 512, 9),
                                   (2, 320, 40), (1, 1024, 33)])
def test_split_order_within_bound_and_exact_on_dyadic(m, k, n, packed):
    plan = qm.qmm_launch_plan(m, k, n, packed, 0)
    assert plan.split > 1
    rng = np.random.RandomState(m * k + n)
    lo, hi = (-8, 7) if packed else (-127, 127)
    w = torch.from_numpy(rng.randint(lo, hi + 1, (k, n)).astype(np.int8))
    wk = qm.pack_int4(w) if packed else w
    s = torch.from_numpy((2.0 ** -rng.randint(2, 6, n)).astype(np.float32))
    plain = qm.quant_matmul_int4_plain if packed else qm.quant_matmul_plain
    xd = torch.from_numpy((rng.randint(-128, 129, (m, k)) / 128.0).astype(np.float32))
    assert torch.equal(_emulate_split(xd, w.float(), s, plan), plain(xd, wk, s))
    xr = torch.from_numpy(rng.randn(m, k).astype(np.float32))
    got, want = _emulate_split(xr, w.float(), s, plan), plain(xr, wk, s)
    bound = 2 * k * 2.0 ** -24 * (xr.abs() @ w.float().abs()) * s.abs() \
        + 2.0 ** -23 * want.abs()
    assert bool(((got - want).abs() <= bound).all())
