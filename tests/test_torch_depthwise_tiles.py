"""What the CPU can hold of B5's and B6's Hopper designs.

The kernels run only on a GPU (``test_torch_kernels_cuda.py``,
``chip_smoke.py``).  Their geometry is planned on the host and their
integer staging has a host half, so here:

* ``dw_launch_plan`` (B6) for every MobileNet-224 depthwise layer at 8
  rows and a ragged sweep (planes of 1x1, 7x7 and 13x13, channel counts
  off the planes per block, N = 1, odd H at stride 2, dilation 2,
  asymmetric pads, 5x5 and 1x3 kernels, unaligned x): every output is
  computed by exactly one thread slot, every tap a thread reads lies in
  its block's window and in its shared memory, a tile's staged elements
  are input elements or the zero padding (16-byte pieces wholly one or
  the other), a flat block's reads that are not padding lie in the span
  it copied, and the shared bytes, threads and grid stay inside the
  card's limits;
* a torch emulation of the tiled computation (each block's window with
  its zero padding, then the taps summed in (kh, kw) order from the window
  through the plan's thread slots), equal to
  ``quant_depthwise_conv2d_plain`` on randn for the float32 body and on
  integer codes, staged by the host half, for the integer body;
* ``gqmm_launch_plan`` (B5): the column tile follows Ng, the K slices cover
  Kg, the row pitch keeps 16-byte reads on distinct banks;
* B5's / B6's integer staging through the host half of
  ``csrc/int_staging.cuh`` (``staging``, ``staged_values``): the same codes
  as the IEEE division at power-of-two scales (the reciprocal), at
  IN_SCALE = 3·2^-5 (the exact-quotient check), off the scale's grid and
  at scales whose reciprocal is no normal float32 (the division), on the
  float32 sample of ``test_torch_tensor_cores.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quant_grouped_conv as tgc  # noqa: E402
from repro_torch.kernels.quant_conv import conv_out_hw  # noqa: E402
from repro_torch.kernels.quant_matmul import (STAGING_MODES,  # noqa: E402
                                              int_values)
from repro_torch.models import zoo as tzoo  # noqa: E402
from test_torch_tensor_cores import POW2_SCALES, _float32_sample  # noqa: E402

IN_SCALE = 3 * 2.0 ** -5
SLOT = 8


def _mobilenet_224():
    """(N, C, H, W, kernel, strides, dilations, pads) of MobileNet-224's 13
    depthwise layers at 8 rows."""
    out, h = [], 224
    for kind, cin, _, stride in tzoo.MOBILENET_V1:
        if kind == "dw":
            out.append((SLOT, cin, h, h, (3, 3), (stride, stride), (1, 1),
                        (1, 1, 1, 1)))
        h = (h - 1) // stride + 1
    return out


RAGGED = [
    (2, 5, 1, 1, (3, 3), (1, 1), (1, 1), (1, 1, 1, 1)),      # 1x1 planes
    (3, 37, 7, 7, (3, 3), (1, 1), (1, 1), (1, 1, 1, 1)),     # 7x7, C off P
    (1, 19, 13, 13, (3, 3), (1, 1), (1, 1), (1, 1, 1, 1)),   # 13x13, N = 1
    (2, 6, 15, 14, (3, 3), (2, 2), (1, 1), (1, 1, 1, 1)),    # odd H, stride 2
    (2, 5, 33, 31, (3, 3), (2, 1), (1, 1), (2, 0, 1, 1)),    # asymmetric pads
    (2, 4, 20, 24, (3, 3), (1, 1), (2, 2), (2, 2, 2, 2)),    # dilation 2
    (1, 3, 40, 44, (5, 5), (1, 1), (1, 1), (2, 2, 2, 2)),    # 5x5, tiles
    (2, 7, 17, 9, (1, 3), (1, 1), (1, 1), (0, 1, 0, 1)),     # 1x3
    (1, 2, 70, 66, (3, 3), (1, 2), (1, 1), (1, 1, 1, 1)),    # W % 4 != 0 tiles
    (1, 3, 57, 100, (3, 3), (2, 2), (1, 1), (1, 1, 1, 1)),   # stride 2 tiles
    (1, 2, 256, 256, (3, 3), (8, 8), (1, 1), (1, 1, 1, 1)),  # plane > smem
]


def _plan(geo, aligned=True):
    n, c, h, w, ks, st, dil, pads = geo
    oh, ow = conv_out_hw(h, w, ks, st, pads, dil)
    return tgc.dw_launch_plan(n, c, h, w, oh, ow, ks[0], ks[1], st, dil,
                              pads, aligned)


def _slots(p):
    """Per thread slot and output row of a block: (plane, row in the tile,
    column in the tile), as the kernel maps threads."""
    t = np.arange(p.planes * p.row_groups * p.tile_w)
    per = p.row_groups * p.tile_w
    pl, q = t // per, t % per
    rg, col = q // p.tile_w, q % p.tile_w
    o = np.arange(p.rows_per_thread)
    i = (rg * p.rows_per_thread)[:, None] + o[None, :]
    return (np.broadcast_to(pl[:, None], i.shape), i,
            np.broadcast_to(col[:, None], i.shape))


GEOS = _mobilenet_224() + RAGGED
IDS = [f"mobilenet{i}" for i in range(13)] + [f"ragged{i}"
                                              for i in range(len(RAGGED))]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("geo", GEOS, ids=IDS)
def test_dw_plan_covers_every_output_once_within_limits(geo, aligned):
    p = _plan(geo, aligned)
    nc = p.N * p.C
    assert p.threads % 32 == 0 and p.threads <= tgc.DW_MAX_THREADS
    assert p.threads >= p.planes * p.row_groups * p.tile_w
    assert p.smem_bytes <= tgc.SMEM_MAX
    assert p.grid[0] < 2 ** 31 and p.grid[1] <= 65535 and p.grid[2] <= 65535
    assert p.rows_per_thread in tgc.DW_ROWS_PER_THREAD
    assert p.fast == (p.sh if (p.kh, p.kw, p.dh) == (3, 3, 1) and
                      p.sh in (1, 2) else 0)
    pl, i, col = _slots(p)
    origins = np.array([p.block_origin(b) for b in range(p.blocks)])
    plane = origins[:, 0, None, None] + pl[None]
    oh = origins[:, 2, None, None] + i[None]
    ow = origins[:, 3, None, None] + col[None]
    ok = (pl[None] < origins[:, 1, None, None]) & (i[None] < p.tile_h) & \
        (oh < p.OH) & (ow < p.OW)
    idx = (plane[ok] * p.OH + oh[ok]) * p.OW + ow[ok]
    counts = np.bincount(idx, minlength=nc * p.OH * p.OW)
    assert counts.size == nc * p.OH * p.OW and (counts == 1).all()


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("geo", GEOS, ids=IDS)
def test_dw_plan_reads_stay_in_the_staged_window(geo, aligned):
    """Every tap of every thread slot (masked rows too: the register
    window reads them) lies in the block's window and in its shared
    memory: a tile at its pitch, or (flat) the copied span where the read
    is no padding; a tile's 16-byte pieces are wholly input or padding."""
    p = _plan(geo, aligned)
    pl, i, col = _slots(p)
    assert p.smem_bytes == 4 * p.buffer and p.buffer % 4 == 0
    if p.flat:
        assert (p.pitch, p.plane_pitch) == (p.W, p.H * p.W)
        assert p.buffer >= p.planes * p.H * p.W
    else:
        assert p.planes == 1 and p.pitch >= p.cols
        assert p.plane_pitch == p.rows * p.pitch <= p.buffer
    for b in range(p.blocks) if p.blocks <= 64 else (0, p.blocks - 1):
        plane0, np_, oh0, ow0 = p.block_origin(b)
        assert 0 <= plane0 and plane0 + np_ <= p.N * p.C   # span inside x
        r0, c0, off = p.window_origin(oh0, ow0)
        for a in range(p.kh):
            for bb in range(p.kw):
                row = i * p.sh + a * p.dh
                c = col * p.sw + bb * p.dw + off
                assert row.max() < p.rows and c.max() < p.cols
                if p.flat:
                    ih, iw = row - p.pt, c - p.pl
                    read = (ih >= 0) & (ih < p.H) & (iw >= 0) & (iw < p.W) & \
                        (pl < np_)
                    addr = pl * p.plane_pitch + ih * p.pitch + iw
                    assert (addr[read] >= 0).all() and \
                        (addr[read] < np_ * p.H * p.W).all()
                else:
                    assert (row * p.pitch + c).max() < p.buffer
                # the window element is the tap's input element
                valid = i < p.tile_h
                np.testing.assert_array_equal(
                    (r0 + row)[valid], ((oh0 + i) * p.sh - p.pt + a * p.dh)[valid])
                np.testing.assert_array_equal(
                    (c0 + c)[valid], ((ow0 + col) * p.sw - p.pl + bb * p.dw)[valid])
        if p.vec and not p.flat:
            # 16-byte pieces: on 16 bytes in x and in shared memory, each
            # wholly inside a row or wholly in the padding
            assert c0 % 4 == 0 and p.W % 4 == 0 and p.pitch % 4 == 0
            assert p.cols % 4 == 0 and (p.H * p.W) % 4 == 0
            starts = c0 + 4 * np.arange(p.cols // 4)
            inside = (starts >= 0) & (starts < p.W)
            assert ((starts + 3 < p.W) | ~inside).all()
        if p.vec and p.flat:
            assert (p.planes * p.H * p.W) % 4 == 0
    if p.vec:
        assert aligned


# ------------------------------------------- B6's tiled computation, emulated

def _emulate(p, xv, taps, blocks, integer):
    """B6's accumulators over ``blocks``, computed as the kernel computes
    them: each block's window (planes, rows, cols) holds the staged values
    and zeros for the padding (stored in a tile, or read as zeros by
    predicate in flat mode), and every thread slot sums its taps in (kh,
    kw) order from it (float32 products and sums rounded apart, or exact
    integers).  ``xv`` (N·C, H, W) holds the staged values.  Returns
    {(plane, oh, ow): acc}."""
    pl, i, col = (torch.from_numpy(np.ascontiguousarray(a)) for a in _slots(p))
    dtype = torch.float64 if integer else torch.float32
    wt = taps.to(dtype)
    out = {}
    for b in blocks:
        plane0, np_, oh0, ow0 = p.block_origin(b)
        r0, c0, off = p.window_origin(oh0, ow0)
        tile = torch.zeros(p.planes, p.rows, p.cols, dtype=dtype)
        rr = torch.arange(p.rows) + r0
        cc = torch.arange(p.cols) + c0
        rin = (rr >= 0) & (rr < p.H)
        cin = (cc >= 0) & (cc < p.W)
        ri, ci = rin.nonzero()[:, 0], cin.nonzero()[:, 0]
        tile[:np_, ri[:, None], ci[None, :]] = \
            xv[plane0:plane0 + np_][:, rr[rin]][:, :, cc[cin]].to(dtype)
        valid = (pl < np_) & (i < p.tile_h) & (oh0 + i < p.OH) & \
            (ow0 + col < p.OW)
        ch = (plane0 + pl[valid]) % p.C
        acc = torch.zeros(int(valid.sum()), dtype=dtype)
        for a in range(p.kh):
            for bb in range(p.kw):
                v = tile[pl[valid], (i[valid] * p.sh + a * p.dh),
                         col[valid] * p.sw + bb * p.dw + off]
                acc = acc + v * wt[a * p.kw + bb, ch]
        keys = zip((plane0 + pl[valid]).tolist(), (oh0 + i[valid]).tolist(),
                   (ow0 + col[valid]).tolist())
        out.update(zip(keys, acc.tolist()))
    return out


def _blocks(p):
    return range(p.blocks) if p.blocks <= 48 else \
        sorted({0, 1, p.blocks // 2, p.blocks - 2, p.blocks - 1})


def _twin_at(x, taps, geo, keys, **body):
    """The twin's outputs at ``keys``, computed on the planes they touch."""
    n, c, h, w, ks, st, dil, pads = geo
    planes = sorted({k[0] for k in keys})
    xs = x.reshape(1, n * c, h, w)[:, planes]
    ts = taps[:, [pl % c for pl in planes]]
    y = tops.quant_depthwise_conv2d_plain(xs, ts, 1.0, kernel_shape=ks,
                                          strides=st, pads=pads,
                                          dilations=dil, **body)[0]
    pos = {pl: j for j, pl in enumerate(planes)}
    return torch.tensor([float(y[pos[pl], oh, ow]) for pl, oh, ow in keys],
                        dtype=torch.float32)


@pytest.mark.parametrize("geo", GEOS, ids=IDS)
def test_tiled_emulation_equals_twin_float32(geo):
    n, c, h, w = geo[:4]
    x = torch.from_numpy(np.random.RandomState(c + h).randn(n, c, h, w)
                         .astype(np.float32))
    taps = torch.from_numpy(np.random.RandomState(w).randint(
        -7, 8, (geo[4][0] * geo[4][1], c)).astype(np.int8))
    p = _plan(geo)
    got = _emulate(p, x.reshape(n * c, h, w), taps, _blocks(p), False)
    want = _twin_at(x, taps, geo, list(got))
    assert torch.equal(torch.tensor(list(got.values()), dtype=torch.float32),
                       want)


@pytest.mark.parametrize("in_scale", [2.0 ** -3, IN_SCALE])
@pytest.mark.parametrize("geo", GEOS[::2] + RAGGED[1::2],
                         ids=IDS[::2] + [f"ragged{i}" for i in
                                         range(1, len(RAGGED), 2)])
def test_tiled_emulation_equals_twin_integer(geo, in_scale):
    n, c, h, w = geo[:4]
    rng = np.random.RandomState(c * h)
    q = rng.randint(-8, 9, (n, c, h, w)).astype(np.float32)
    x = torch.from_numpy(q * np.float32(in_scale))
    x.view(-1)[::7] += np.float32(in_scale) / 3      # some off the grid
    taps = torch.from_numpy(rng.randint(-7, 8, (geo[4][0] * geo[4][1], c))
                            .astype(np.int8))
    p = _plan(geo)
    xv = tops.staged_values(x, in_scale).reshape(n * c, h, w)
    got = _emulate(p, xv, taps, _blocks(p), True)
    want = _twin_at(x, taps, geo, list(got), acc_dtype=torch.int32,
                    in_scale=in_scale)
    assert torch.equal(torch.tensor(list(got.values()), dtype=torch.float32),
                       want)


# ----------------------------------------------------------- B5's plan

GQ_SHAPES = [(8, 25088, 72, 8), (3, 65, 18, 33), (2, 13, 10, 5),
             (64, 40, 2, 1), (4, 100, 300, 12), (1, 33, 130, 70),
             (5, 7, 9, 40), (2, 300, 1, 16), (3, 129, 257, 17)]


@pytest.mark.parametrize("g,m,kg,ng", GQ_SHAPES)
def test_gqmm_plan_follows_ng_and_covers_k(g, m, kg, ng):
    p = tgc.gqmm_launch_plan(g, m, kg, ng)
    assert p.BN == min(b for b in (8, 16, 32) if b >= min(ng, 32))
    assert (p.col_tiles - 1) * p.BN < ng <= p.col_tiles * p.BN
    assert p.grid == (-(-m // tgc.GQ_BM), p.col_tiles, g)
    assert p.KS % 4 == 0 and p.KS <= tgc.GQ_KS_MAX
    starts = list(range(0, kg, p.KS))
    assert starts[-1] + p.KS >= kg and (kg <= p.KS) == (len(starts) == 1)
    assert p.pitch % 4 == 0 and (p.pitch // 4) % 2 == 1 and p.pitch >= p.KS
    # eight lanes' 16-byte row reads (one per row) fall on distinct banks
    assert len({(r * p.pitch * 4 // 16) % 8 for r in range(8)}) == 8
    assert p.smem_bytes == 4 * (tgc.GQ_BM * p.pitch + p.KS * p.BN) \
        <= tgc.SMEM_MAX
    assert p.vec == int(kg % 4 == 0)
    assert tgc.gqmm_launch_plan(g, m, kg, ng, x_vec=False).vec == 0


# ------------------------------------------------- the integer staging

def test_staging_modes():
    assert tops.staging(None) == (0, 1.0, 1.0)
    assert tops.staging(2.0 ** -3) == (0, 0.125, 8.0)
    assert tops.staging(IN_SCALE)[0] == STAGING_MODES.index("quotient")
    # reciprocals that are no normal float32: the division
    for s in (3 * 2.0 ** -140, 2.0 ** 127):
        assert tops.staging(s)[0] == STAGING_MODES.index("division")
    tops.reset_launch_counts()
    assert tops.staging_counts() == {
        k: dict.fromkeys(STAGING_MODES, 0)
        for k in ("quant_grouped_matmul", "quant_depthwise_conv2d")}


@pytest.mark.parametrize("scale", POW2_SCALES + [
    IN_SCALE, 0.1, 1.0 / 3, 5.0, 3 * 2.0 ** -140, 2.0 ** 127])
def test_staged_values_are_the_division(scale):
    """What B5 / B6 stage equals round(x / scale) by the IEEE division,
    on the float32 sample, the scale's grid and values off it."""
    s = np.float32(scale)
    with np.errstate(over="ignore"):
        grid = (np.arange(-300, 301) * s).astype(np.float32)
        off = (np.random.RandomState(4).uniform(-120, 120, 2000) * s) \
            .astype(np.float32)
    x = torch.from_numpy(np.concatenate([_float32_sample(), grid, off]))
    want = int_values(x, scale)
    got = tops.staged_values(x, scale)
    fin = torch.isfinite(want) & (want.abs() < 2 ** 31)
    assert torch.equal(got[fin], want[fin])
    assert torch.equal(got[~fin].isnan(), want[~fin].isnan())
