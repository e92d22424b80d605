"""Launch plans of the port's kernels, computed in Python before any launch
(``models/dw_cuda.py::plan``, ``models/shuffle_cuda.py::plan``,
``ops/cifhr_cuda.py::plan``), and the CifHr kernel's cull as a plain
function (``ops/cifhr_cuda.py::keeps``).

The kernels refuse a plan that does not cover the tensor or fit a CTA; these
tests hold the plans on the CPU at the shapes the serving path gives them:
k16's three stages for a 513x641 input, the channel widths of every
``shufflenetv2k*`` net option, and the decode's CifHr maps. The cull test
shows that the kernel's bounding-box test never drops a cell that touches
a band or a warp's columns: the plain version summing only the kept cells
gives the same map there, bit for bit.
"""

import numpy as np
import pytest
import torch

from openpifpaf_tpu_torch.models import dw_cuda, shuffle_cuda
from openpifpaf_tpu_torch.models.factory import BASE_FACTORIES
from openpifpaf_tpu_torch.ops import cifhr, cifhr_cuda

#: (Cb, H, W) of shufflenetv2k16's stages 2-4 for a 513x641 input
K16_STAGES = ((174, 129, 161), (348, 65, 81), (696, 33, 41))
DTYPES = (torch.float32, torch.bfloat16)
#: (H, W, C) outputs of the Mosaic lab's stages (``lab/mosaic_lab.py``)
LAB_STAGES = ((121, 161, 174), (61, 81, 348), (31, 41, 696))


def _net_stages(name):
    """(Cb, H, W) of a ShuffleNetV2K net option's stages 2-4 at 513x641."""
    channels = BASE_FACTORIES[name]().stages_out_channels
    return [(channels[i] // 2, h, w)
            for i, (h, w) in zip((1, 2, 3), ((129, 161), (65, 81), (33, 41)))]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('cb,h,w', K16_STAGES)
def test_block_plan_fills_the_card_at_k16_stages(cb, h, w, dtype):
    p = shuffle_cuda.plan(1, h, w, cb, k=5, dilation=1, dtype=dtype)
    assert p.smem <= shuffle_cuda.SMEM_LIMIT
    assert p.ctas >= shuffle_cuda.SMS
    assert p.ctas == -(-h // p.th) * -(-w // p.tw) * p.cluster
    assert p.slice % 16 == 0 and p.slice <= shuffle_cuda.MAX_SLICE
    assert p.cb_pad - p.slice < cb <= p.cb_pad
    assert p.smem == shuffle_cuda.shared_bytes(
        p.th, p.tw, p.cluster, p.slice, k=5, halo=2,
        size=torch.finfo(dtype).bits // 8)


def test_block_plan_splits_stage4_over_a_cluster():
    """At stage 4 (Cb = 696) one CTA cannot hold the channels' first-1x1
    accumulators: they are split over a cluster, 16-padded to 704."""
    for dtype in DTYPES:
        p = shuffle_cuda.plan(1, 33, 41, 696, k=5, dilation=1, dtype=dtype)
        assert 2 <= p.cluster <= 4 and p.cb_pad == 704


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('net', sorted(n for n in BASE_FACTORIES
                                       if n.startswith('shufflenetv2k')))
def test_block_plan_fits_every_net_width(net, dtype):
    for cb, h, w in _net_stages(net):
        p = shuffle_cuda.plan(1, h, w, cb, k=5, dilation=1, dtype=dtype)
        assert p.smem <= shuffle_cuda.SMEM_LIMIT, (net, cb, p)
        assert p.cb_pad >= cb and p.cluster <= shuffle_cuda.MAX_CLUSTER


@pytest.mark.parametrize('cb,dtype,align,vb', [
    (174, torch.bfloat16, 16, 4),  # rows of 348 bytes: 4-byte vectors
    (174, torch.float32, 16, 8),
    (348, torch.bfloat16, 16, 8),
    (696, torch.bfloat16, 16, 16),
    (15, torch.bfloat16, 16, 2),   # odd Cb: 2-byte copies
    (696, torch.float32, 4, 4),    # a tensor aligned to 4 bytes only
])
def test_block_plan_vector_width(cb, dtype, align, vb):
    assert shuffle_cuda.plan(1, 9, 11, cb, k=5, dilation=1, dtype=dtype,
                             align=align).vb == vb


@pytest.mark.parametrize('k,dilation', [(3, 1), (5, 1), (5, 2), (3, 4)])
def test_block_plan_keeps_the_register_tiles(k, dilation):
    """The haloed tile stays within the first 1x1's 9 m-tiles, the output
    tile within the second's 4, a strip within 8 rows."""
    halo = (k - 1) // 2 * dilation
    for dtype in DTYPES:
        p = shuffle_cuda.plan(2, 40, 50, 100, k=k, dilation=dilation,
                              dtype=dtype)
        assert (p.th + 2 * halo) * (p.tw + 2 * halo) <= 16 * shuffle_cuda.MT1
        assert p.th * p.tw <= 16 * shuffle_cuda.MT2
        assert -(-p.th // dilation) <= shuffle_cuda.STRIP_ROWS


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('c,h,w', [(cb, h, w) for cb, h, w in K16_STAGES])
def test_depthwise_plan_at_k16_stages(c, h, w, dtype):
    p = dw_cuda.plan(1, h, w, c, k=5, dilation=1, dtype=dtype)
    # 2 channels divide every stage's pixel stride; wider vectors would
    # leave fewer strips than the card needs
    assert p.vec == 2
    assert -(-h // dw_cuda.strip_rows(2)) * w * c // 2 >= dw_cuda.MIN_STRIPS
    assert p.nv * p.groups * p.vec >= c > (p.groups - 1) * p.nv * p.vec
    assert p.threads == p.nv * p.tw * p.strips <= dw_cuda.MAX_THREADS
    assert p.smem <= dw_cuda.SMEM_LIMIT
    assert p.ctas >= 2 * dw_cuda.SMS


@pytest.mark.parametrize('c,dtype,align,vec', [
    (174, torch.bfloat16, 16, 2),
    (174, torch.float32, 16, 2),
    (348, torch.bfloat16, 16, 4),
    (348, torch.float32, 16, 4),
    (696, torch.bfloat16, 16, 8),
    (696, torch.float32, 16, 4),
    (175, torch.float32, 16, 1),   # odd C
    (696, torch.bfloat16, 4, 2),   # a tensor aligned to 4 bytes only
])
def test_depthwise_plan_vector_width(c, dtype, align, vec):
    """The widest vector the pixel stride and the alignment allow, where
    the batch gives enough strips; the narrowest legal one where not."""
    assert dw_cuda.plan(16, 64, 80, c, k=5, dilation=1, dtype=dtype,
                        align=align).vec == vec
    assert dw_cuda.plan(1, 13, 17, c, k=5, dilation=1, dtype=dtype,
                        align=align).vec == 1


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('h,w,c', LAB_STAGES)
def test_depthwise_valid_plan_at_lab_stages(h, w, c, dtype):
    """The lab's VALID depthwise conv (``lab.kernels.dw_valid``) is planned
    for its (H, W) output: the widest vector of at most 4 channels that
    the pixel stride allows (2 at C = 174, 4 at 348 and 696), 4 vectors
    per CTA, 16-row tiles of 16 columns, and at least two CTAs per SM."""
    p = dw_cuda.plan(1, h, w, c, k=5, dilation=1, dtype=dtype, valid=True)
    assert p.vec == (2 if c == 174 else 4)
    assert (p.nv, p.tw, p.strips) == (dw_cuda.VALID_VECTORS, 16, 2)
    assert p.nv * p.groups * p.vec >= c > (p.groups - 1) * p.nv * p.vec
    assert p.threads == p.nv * p.tw * p.strips <= dw_cuda.MAX_THREADS
    th = p.strips * dw_cuda.strip_rows(p.vec)
    assert th == 16
    assert p.smem == (th + 4) * (p.tw + 4) * p.nv * p.vec * \
        torch.finfo(dtype).bits // 8 <= dw_cuda.SMEM_LIMIT
    assert p.ctas == -(-h // th) * -(-w // p.tw) * p.groups >= 2 * dw_cuda.SMS


@pytest.mark.parametrize('dilation', [1, 2, 3])
@pytest.mark.parametrize('valid', [False, True])
def test_depthwise_plan_strips_cover_dilation_phases(dilation, valid):
    p = dw_cuda.plan(1, 40, 50, 64, k=5, dilation=dilation,
                     dtype=torch.float32, valid=valid)
    assert p.strips % dilation == 0


def test_alignment():
    t = torch.zeros(16, dtype=torch.bfloat16)
    assert dw_cuda.alignment(t) == 16
    assert dw_cuda.alignment(t[1:]) == 2
    assert dw_cuda.alignment(t, t[4:]) == 8


#: (n_fields, n_cells, hr_h, hr_w) of CifHr maps: the chip's three shapes
#: (513x641 at 17 and 133 fields, K = 256 and 1024), the CPU tests' maps,
#: hr_w = 1, 2 and 3 mod 4, maps shorter than a band, of one row and of
#: one column, and one wider than a CTA (two column chunks)
CIFHR_SHAPES = [(17, 256, 513, 641), (17, 1024, 513, 641),
                (133, 256, 513, 641), (5, 37, 65, 81), (17, 96, 97, 129),
                (4, 64, 37, 33), (4, 64, 37, 34), (4, 64, 37, 35),
                (3, 96, 5, 81), (3, 96, 1, 200), (3, 96, 200, 1),
                (2, 200, 40, 1500), (2, 3000, 97, 161)]


@pytest.mark.parametrize('shape', CIFHR_SHAPES)
@pytest.mark.parametrize('groups,bands_per_cta,max_threads', [
    (1, 1, None), (2, 4, None), (4, 3, 1024), (1, 8, 128), (16, 2, 512)])
def test_cifhr_plan_covers_every_pixel_once(shape, groups, bands_per_cta,
                                            max_threads):
    """The bands and warps of a plan cover every map pixel exactly once,
    the CTA fits (threads, shared bytes) and the plan passes the kernel's
    own checks, for several row groups, bands per CTA and thread limits."""
    n_fields, n_cells, hr_h, hr_w = shape
    p = cifhr_cuda.plan(n_fields, n_cells, hr_h, hr_w, groups=groups,
                        bands_per_cta=bands_per_cta, max_threads=max_threads)
    seen = np.zeros((hr_h, hr_w), np.int64)
    for (y0, y1), (x0, x1) in cifhr_cuda.segments(p, hr_h, hr_w):
        seen[y0:y1, x0:x1] += 1
    assert (seen == 1).all()
    assert (p.groups, p.bands_per_cta) == (groups, bands_per_cta)
    assert p.threads % (cifhr_cuda.WARP * groups) == 0
    assert p.threads <= min(max_threads or cifhr_cuda.DEFAULT['max_threads'],
                            cifhr_cuda.MAX_THREADS)
    width = p.threads // groups
    assert p.chunks * width >= hr_w > (p.chunks - 1) * width
    per_round = p.threads * cifhr_cuda.CELLS_PER_THREAD
    assert p.cap >= per_round and p.cap % per_round == 0
    assert p.cap >= min(n_cells, cifhr_cuda.MAX_CAP - per_round + 1)
    assert p.smem == cifhr_cuda.shared_bytes(p.cap) <= 227 * 1024
    band = cifhr_cuda.ROWS * groups
    assert p.bands * band >= hr_h > (p.bands - 1) * band
    assert p.ctas == n_fields * p.chunks * -(-p.bands // bands_per_cta)


def test_cifhr_plan_refuses_what_the_kernel_is_not_built_for():
    for kw in ({'groups': 32, 'max_threads': 512}, {'groups': 0},
               {'bands_per_cta': 0}):
        with pytest.raises(ValueError, match='no plan'):
            cifhr_cuda.plan(17, 256, 513, 641, **kw)


def test_cifhr_plan_at_the_decode_map():
    """At 513x641 the default plan's list holds every cell of a field, so
    a CTA reads each cell from global memory once."""
    for n_fields, n_cells, hr_h, hr_w in CIFHR_SHAPES[:3]:
        p = cifhr_cuda.plan(n_fields, n_cells, hr_h, hr_w)
        assert p.cap >= n_cells


def _cifhr_cells(n_fields, n_cells, hr_h, hr_w, seed, dead, margin):
    """Cells in the map and up to ``margin`` pixels outside it, sigma 1-18,
    a share ``dead`` of them with weight 0."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-margin, hr_w + margin, (n_fields, n_cells))
    y = rng.uniform(-margin, hr_h + margin, (n_fields, n_cells))
    sigma = rng.uniform(1.0, 18.0, (n_fields, n_cells))
    w = rng.uniform(0.3, 1.0, (n_fields, n_cells))
    w[rng.rand(n_fields, n_cells) < dead] = 0.0
    return [torch.from_numpy(a.astype(np.float32)) for a in (x, y, sigma, w)]


@pytest.mark.parametrize('case', [
    # (n_fields, n_cells, hr_h, hr_w, seed, dead share, margin, kwargs)
    (2, 700, 45, 81, 0, 0.4, 40.0, {}),
    (1, 3000, 24, 70, 1, 0.0, 5.0, {'neighbors': 8, 'factor': 0.5}),
])
def test_cifhr_cull_keeps_every_cell_that_touches_its_pixels(case):
    """The kernel's cull (``cifhr_cuda.keeps``): for each warp's rows, and
    for each warp's columns, the cells it keeps, summed in ascending order
    by the plain version, give the plain version's map there bit for bit,
    while it drops cells. A warp keeps a cell when both tests keep it, and
    a band or a chunk of columns holds its warps' spans, so the CTA's cull
    keeps it too. At K = 3000 a warp's rows keep more cells than one cull
    round of the kernel reads (the GPU tests drive lists that overflow)."""
    n_fields, n_cells, hr_h, hr_w, seed, dead, margin, kw = case
    x, y, sigma, w = _cifhr_cells(n_fields, n_cells, hr_h, hr_w, seed, dead,
                                  margin)
    full = cifhr.accumulate_dense(x, y, sigma, w, hr_h=hr_h, hr_w=hr_w,
                                  **kw)
    assert float(full.max()) > 0.01
    p = cifhr_cuda.plan(n_fields, n_cells, hr_h, hr_w)
    live = int((w != 0).sum())
    most = 0
    rows = {rows for rows, _ in cifhr_cuda.segments(p, hr_h, hr_w)}
    columns = {cols for _, cols in cifhr_cuda.segments(p, hr_h, hr_w)}
    regions = [(r, (0, hr_w)) for r in sorted(rows)] + \
        [((0, hr_h), cols) for cols in sorted(columns)]
    for (y0, y1), (x0, x1) in regions:
        kept = cifhr_cuda.keeps(x, y, sigma, w, rows=(y0, y1), cols=(x0, x1),
                                **kw)
        assert int(kept.sum()) < live
        most = max(most, int(kept.sum(dim=1).max()))
        part = cifhr.accumulate_dense(x, y, sigma, torch.where(kept, w, 0.0),
                                      hr_h=hr_h, hr_w=hr_w, **kw)
        np.testing.assert_array_equal(part[:, y0:y1, x0:x1].numpy(),
                                      full[:, y0:y1, x0:x1].numpy())
    per_round = p.threads * cifhr_cuda.CELLS_PER_THREAD
    assert (most > per_round) == (n_cells == 3000)


def _shard_tiles(h, shards, halo=2):
    """Tile heights of the spatial mesh's kernel calls on ``h`` rows over
    ``shards``: each shard's rows and a halo from real neighbours
    (``parallel.spatial.halo_op``), or 2 halo + 1 rows on an empty shard."""
    from openpifpaf_tpu_torch.parallel.spatial import split_rows
    return sorted({min(e + halo, h) - max(s - halo, 0) if s < e
                   else 2 * halo + 1 for s, e in split_rows(h, shards)})


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shards', [2, 4])
@pytest.mark.parametrize('cb,h,w', K16_STAGES)
def test_plans_fit_k16_shard_tiles(cb, h, w, shards, dtype):
    """At spatial 2 and 4 the stages' 129, 65 and 33 rows become tiles of
    8-67 rows with their halo: both kernels plan them."""
    for th in _shard_tiles(h, shards):
        p = shuffle_cuda.plan(1, th, w, cb, k=5, dilation=1, dtype=dtype)
        assert p.smem <= shuffle_cuda.SMEM_LIMIT
        assert p.ctas == -(-th // p.th) * -(-w // p.tw) * p.cluster
        d = dw_cuda.plan(1, th, w, cb, k=5, dilation=1, dtype=dtype)
        assert d.smem <= dw_cuda.SMEM_LIMIT
        assert d.threads == d.nv * d.tw * d.strips <= dw_cuda.MAX_THREADS
        assert d.nv * d.groups * d.vec >= cb
