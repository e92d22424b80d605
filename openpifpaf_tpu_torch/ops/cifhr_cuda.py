"""CifHr accumulation: wrapper of the hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``openpifpaf_tpu/ops/cifhr_pallas.py::
_kernel`` (driven by ``accumulate_pallas``). The kernel, ``csrc/cifhr.cu``,
runs one CTA per (field, chunk of columns, run of bands of map rows), one
thread per column of each band in turn. A CTA reads its field's cells once,
scales their weights and culls them against its pixels into a list in
shared memory, in ascending cell order; then each warp, with no barrier,
culls that list against its own 32 columns of each band, accumulates its
survivors and stores the rows. What bounds it on the H100 is the map's
write (22.4 MB at F = 17 and 513x641): a cell is read from global memory
once per CTA, and the stores of one band leave while a warp accumulates the
next. A CTA whose cells overflow the list culls each band's cells from
global memory in rounds instead, so there is no cell budget: unlike the
Pallas kernel, it is exact for any K and never raises a tile overflow.

The kernel is built at first use by :mod:`openpifpaf_tpu_torch._nvcc`.
:func:`plan` chooses its launch in Python; :func:`keeps` is the kernel's
cull as a plain function, for the tests.

:func:`accumulate` calls the PyTorch operator
``torch.ops.openpifpaf_tpu_torch.cifhr_accumulate`` (registered by the
package's ``__init__``): on a CPU tensor its implementation is the plain
PyTorch version (:func:`.cifhr.accumulate_dense`); on a CUDA tensor it is
:func:`launch_counted`, which launches the kernel, one device op per
call, or raises. ``torch.export`` records the operator as one opaque op
(its fake implementation gives the map's shape), so an exported decode
launches this kernel on the card.
"""

import ctypes
import dataclasses
import functools

import torch

from .. import _nvcc
from .cifhr import scaled_weights

#: kernel launches made by :func:`accumulate` in this process
LAUNCHES = 0

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])

#: map rows per thread (``kRows`` in csrc/cifhr.cu)
ROWS = 8
#: threads per CTA at most (the kernel's register budget of 128 per thread)
MAX_THREADS = 512
WARP = 32
#: consecutive cells a thread culls per round
CELLS_PER_THREAD = 4
#: cells the survivor list holds at most (4 floats each), unless one cull
#: round needs more: a CTA with more cells that touch its pixels culls
#: each band's cells from global memory and accumulates them in rounds
MAX_CAP = 4096
#: the plan's defaults, from a sweep of plans on the H100
#: (``lab/kernel_ab.py cifhr_plans``; PERF.md)
DEFAULT = dict(groups=2, bands_per_cta=4, max_threads=128)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Launch plan of the CifHr kernel."""
    groups: int      # row groups of warps per band (band rows: ROWS * groups)
    bands_per_cta: int  # bands a CTA accumulates in turn
    threads: int     # threads per CTA, one column of one row group each
    chunks: int      # column chunks (grid x)
    bands: int       # bands per field
    cap: int         # survivor list capacity, in cells
    smem: int        # dynamic shared bytes
    ctas: int


def shared_bytes(cap):
    """Dynamic shared bytes of a CTA (``cifhr.cu``): the survivor list, 4
    floats per cell."""
    return 4 * 4 * cap


@functools.lru_cache(maxsize=None)
def plan(n_fields, n_cells, hr_h, hr_w, *, groups=None, bands_per_cta=None,
         max_threads=None) -> Plan:
    """The launch plan for ``n_fields`` fields of ``n_cells`` cells on an
    (hr_h, hr_w) map, by default :data:`DEFAULT`'s: bands of ``ROWS *
    groups`` rows, ``bands_per_cta`` of them per CTA, each CTA ``groups``
    row groups of warps; as few column chunks of at most ``max_threads /
    groups`` columns as cover a row, the 32-column segments shared evenly
    among them; a survivor list of whole cull rounds (4 cells per thread)
    that holds all the cells where :data:`MAX_CAP` allows."""
    groups = DEFAULT['groups'] if groups is None else groups
    bands_per_cta = DEFAULT['bands_per_cta'] if bands_per_cta is None \
        else bands_per_cta
    max_threads = min(DEFAULT['max_threads'] if max_threads is None
                      else max_threads, MAX_THREADS)
    if not 1 <= groups <= max_threads // WARP or bands_per_cta < 1:
        raise ValueError(f'CifHr kernel: no plan for groups={groups}, '
                         f'bands_per_cta={bands_per_cta}, '
                         f'max_threads={max_threads}')
    segments = -(-hr_w // WARP)
    chunks = -(-segments // (max_threads // WARP // groups))
    threads = WARP * groups * -(-segments // chunks)
    per_round = threads * CELLS_PER_THREAD
    cap = per_round * max(1, min(-(-n_cells // per_round),
                                 MAX_CAP // per_round))
    bands = -(-hr_h // (ROWS * groups))
    return Plan(groups=groups, bands_per_cta=bands_per_cta,
                threads=threads, chunks=chunks, bands=bands, cap=cap,
                smem=shared_bytes(cap),
                ctas=n_fields * chunks * -(-bands // bands_per_cta))


def describe(p):
    """Plan ``p`` as text."""
    return (f'{ROWS} rows x {p.groups} row groups per band, '
            f'{p.bands_per_cta} bands per CTA, {p.threads} threads x '
            f'{p.chunks} column chunks, {p.ctas} CTAs, {p.cap}-cell list, '
            f'{p.smem} shared bytes')


def segments(p, hr_h, hr_w):
    """The pixel ranges ``((y0, y1), (x0, x1))``, ends exclusive, that the
    warps of plan ``p`` accumulate and store, band by band: the kernel's
    indexing as a plain function."""
    width = p.threads // p.groups
    out = []
    for band in range(p.bands):
        for group in range(p.groups):
            y0 = (band * p.groups + group) * ROWS
            for chunk in range(p.chunks):
                for x0 in range(chunk * width, (chunk + 1) * width, WARP):
                    if x0 < hr_w and y0 < hr_h:
                        out.append(((y0, min(y0 + ROWS, hr_h)),
                                    (x0, min(x0 + WARP, hr_w))))
    return out


def keeps(x, y, sigma, w, *, rows, cols, neighbors=16, factor=1.0):
    """The kernel's cull as a plain function: which of the (F, K) cells the
    kernel keeps for the pixels ``rows`` x ``cols`` (``(first, end)``, end
    exclusive; the CTA's bands and columns, a band's, then a warp's rows
    and columns). A cell is kept when its scaled weight is not 0 and its
    bounding box, ``x +- |sigma|`` by ``y +- |sigma|`` in float32, meets
    the pixel span widened by one pixel on each side. Returns an (F, K)
    bool tensor. No kernel path calls it; the tests do."""
    a = sigma.abs()
    cw = scaled_weights(w, neighbors, factor)

    def overlaps(c, span):
        return (c + a >= span[0] - 1.0) & (c - a <= float(span[1]))

    return (cw != 0.0) & overlaps(x, cols) & overlaps(y, rows)


def launch(x, y, sigma, w, p, *, hr_h, hr_w, neighbors=16, factor=1.0):
    """Launch the kernel with plan ``p`` on the checked contiguous float32
    CUDA cells and return the (F, hr_h, hr_w) map. Counts nothing:
    :func:`accumulate` does."""
    n_fields, n_cells = x.shape
    out = torch.empty((n_fields, hr_h, hr_w), dtype=torch.float32,
                      device=x.device)
    _nvcc.launch(_nvcc.function('cifhr.cu', 'cifhr_accumulate', _ARGTYPES),
                 x.device, x.data_ptr(), y.data_ptr(), sigma.data_ptr(),
                 w.data_ptr(), out.data_ptr(), n_fields, n_cells, hr_h, hr_w,
                 float(neighbors), float(factor), p.groups, p.bands_per_cta,
                 p.threads, p.chunks, p.cap, p.smem)
    return out


def launch_counted(x, y, sigma, w, *, hr_h, hr_w, neighbors=16,
                   factor=1.0):
    """The operator's CUDA implementation: :func:`launch` with the plan
    of these shapes on contiguous cells, counted in :data:`LAUNCHES`."""
    global LAUNCHES
    n_fields, n_cells = x.shape
    out = launch(x.contiguous(), y.contiguous(), sigma.contiguous(),
                 w.contiguous(), plan(n_fields, n_cells, hr_h, hr_w),
                 hr_h=hr_h, hr_w=hr_w, neighbors=neighbors, factor=factor)
    LAUNCHES += 1
    return out


def accumulate(x, y, sigma, w, *, hr_h, hr_w, neighbors=16, factor=1.0):
    """CifHr map (F, hr_h, hr_w) from (F, K) cells; the contract of
    :func:`.cifhr.accumulate_dense`."""
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'CifHr kernel needs a CUDA tensor, got {x.device}')
    if x.device.type == 'cuda':
        if x.dim() != 2:
            raise ValueError(f'cells must be (F, K), got {tuple(x.shape)}')
        for name, t in (('y', y), ('sigma', sigma), ('w', w)):
            if t.shape != x.shape or t.device != x.device:
                raise ValueError(f'{name} {tuple(t.shape)} on {t.device} '
                                 f'does not match x {tuple(x.shape)} on '
                                 f'{x.device}')
        for name, t in (('x', x), ('y', y), ('sigma', sigma), ('w', w)):
            if t.dtype != torch.float32:
                raise ValueError(f'{name} must be float32, got {t.dtype}')
        n_fields, n_cells = x.shape
        if n_fields * hr_h * hr_w >= 2 ** 31 or n_cells >= 2 ** 31:
            raise ValueError('CifHr map too large for 32-bit sizes')
    return torch.ops.openpifpaf_tpu_torch.cifhr_accumulate(
        x, y, sigma, w, hr_h, hr_w, float(neighbors), float(factor))
