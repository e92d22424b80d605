"""The row plan and the halo exchange of the ``('data', 'space')`` mesh.

JAX shards the image height over the mesh's ``'space'`` axis and lets
GSPMD insert the convolutions' halo exchanges. PyTorch has no GSPMD, so
the port writes the halo arithmetic itself:

- :func:`split_rows` splits a layer's global height over the shards of a
  space axis, as GSPMD splits a dimension: ``ceil(H / S)`` rows each, the
  last shards fewer or none;
- :class:`RowOp` is the row arithmetic of a conv or pool with kernel k,
  stride s, padding p and dilation d: each shard owns a contiguous range
  of output rows, split from that layer's own height, and fetches the
  input rows they read, clipped to the input; rows outside it are the
  layer's padding (zeros for a conv, -inf for a max pool), never rows of
  a neighbour;
- :class:`Rows` is an activation split along H: the owned rows of the
  shards that this process holds (:class:`SpaceAxis`), every shard's
  range known to every process;
- :func:`exchange` gives each local shard a range of global rows, taken
  from the shards that own them. Shards of this process exchange by
  slicing, which autograd differentiates as it is; shards of other ranks
  through point-to-point messages (gloo on the CPU, NCCL on the card) in
  :class:`_Exchange`, whose backward sends each fetched row's gradient
  back to the shard that owns the row and adds it there;
- :func:`row_op` runs a layer on each shard's fetched and padded tile,
  :func:`halo_op` runs a stride-1 'SAME' kernel on a tile extended by
  its halo from real neighbours only and crops the halo rows of its
  output, and :func:`gather` assembles the whole tensor.
"""

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def split_rows(height, n):
    """The ``[start, stop)`` rows of each of ``n`` shards of ``height``
    rows: ``ceil(height / n)`` each, the last ones fewer or none."""
    per = -(-height // n)
    return [(min(i * per, height), min((i + 1) * per, height))
            for i in range(n)]


@dataclasses.dataclass(frozen=True)
class RowOp:
    """The rows of a conv or pool along H: kernel, stride, padding,
    dilation."""
    kernel: int
    stride: int = 1
    padding: int = 0
    dilation: int = 1

    def out_height(self, height):
        return (height + 2 * self.padding
                - self.dilation * (self.kernel - 1) - 1) // self.stride + 1

    def fetch(self, start, stop, height):
        """For output rows ``[start, stop)`` (not empty) of an input of
        ``height`` rows: ``(a, b, top, bottom)``, the input rows ``[a, b)``
        to fetch and the padding rows above and below them."""
        lo = start * self.stride - self.padding
        hi = (stop - 1) * self.stride - self.padding \
            + (self.kernel - 1) * self.dilation + 1
        a, b = max(lo, 0), min(hi, height)
        return a, b, a - lo, hi - b


@dataclasses.dataclass
class SpaceAxis:
    """The shards of one space axis (one data index of the mesh): ``n``
    shards, of which this process holds ``local`` (shard indices, in
    order) on ``devices``; ``owners[i]`` is the global rank that holds
    shard ``i`` (None when this process holds them all) and ``group`` the
    process group of the point-to-point messages (None: the default
    group)."""
    n: int
    local: Tuple[int, ...]
    devices: Tuple[torch.device, ...]
    owners: Optional[Tuple[int, ...]] = None
    group: Optional[object] = None

    @classmethod
    def in_process(cls, n, device):
        """``n`` shards, all on ``device`` in this process."""
        device = torch.device(device)
        return cls(n, tuple(range(n)), (device,) * n)

    @property
    def n_ranks(self):
        """The ranks that hold this axis' shards (1 in one process)."""
        return 1 if self.owners is None else len(set(self.owners))


class Rows:
    """A tensor split along dim ``dim`` over the shards of ``axis``:
    ``parts[k]`` holds the rows ``ranges[axis.local[k]]`` of a tensor of
    ``height`` rows; ``ranges`` lists every shard's range, in order, and
    tiles ``[0, height)``."""

    def __init__(self, parts, ranges, height, axis, dim=2):
        self.parts = list(parts)
        self.ranges = list(ranges)
        self.height = height
        self.axis = axis
        self.dim = dim

    @classmethod
    def split(cls, x, axis, dim=2):
        """This process's shards of the whole tensor ``x``, each on its
        device."""
        ranges = split_rows(x.shape[dim], axis.n)
        parts = [x.narrow(dim, ranges[i][0], ranges[i][1] - ranges[i][0])
                 .to(device) for i, device in zip(axis.local, axis.devices)]
        return cls(parts, ranges, x.shape[dim], axis, dim)

    @property
    def local_ranges(self):
        return [self.ranges[i] for i in self.axis.local]

    def like(self, parts, ranges=None, height=None, dim=None):
        """Rows of this axis with other parts (and ranges, height, dim)."""
        return Rows(parts, self.ranges if ranges is None else ranges,
                    self.height if height is None else height, self.axis,
                    self.dim if dim is None else dim)

    def map(self, fn):
        """A row-local op on every shard: ``fn(k, part)`` for local shard
        ``k``; the ranges stay."""
        return self.like([_on_rows(functools.partial(fn, k), p, self.dim)
                          for k, p in enumerate(self.parts)])

    def map2(self, other, fn):
        """A row-local op of two row-aligned tensors: ``fn(k, a, b)``."""
        if other.ranges != self.ranges:
            raise ValueError('rows of two tilings do not align')
        return self.like([fn(k, a, b) if a.shape[self.dim] else
                          _no_rows(fn(k, *[_pad_rows(t, 0, 1, 0.0, self.dim)
                                           for t in (a, b)]), self.dim)
                          for k, (a, b) in enumerate(zip(self.parts,
                                                         other.parts))])


def _pieces(ranges, want, local):
    """``(i, j, lo, hi)``: rows ``[lo, hi)`` that shard ``j`` wants from
    shard ``i``, for every pair with rows in common where ``i`` or ``j``
    is in ``local``; sorted by (i, j), the order both ends of a message
    issue it in."""
    out = []
    local = set(local)
    for i, (s, e) in enumerate(ranges):
        for j, wanted in enumerate(want):
            if wanted is None or (i not in local and j not in local):
                continue
            lo, hi = max(wanted[0], s), min(wanted[1], e)
            if lo < hi:
                out.append((i, j, lo, hi))
    return out


def _run_p2p(ops):
    if ops:
        for request in dist.batch_isend_irecv(ops):
            request.wait()


class _Exchange(torch.autograd.Function):
    """The remote side of :func:`exchange`: sends this process's rows that
    other ranks want and receives the rows it wants from them; the last
    output is an empty token that :func:`exchange` puts into every local
    tile, so that every rank that took part runs the backward. The
    backward sends each received piece's gradient back to its owner and
    adds the gradient of each sent piece into its shard's."""

    @staticmethod
    def forward(ctx, meta, *parts):
        axis, ranges, dim, sends, recvs = meta
        pos = {s: k for k, s in enumerate(axis.local)}
        ops = []
        for i, j, lo, hi in sends:
            piece = parts[pos[i]].narrow(dim, lo - ranges[i][0],
                                         hi - lo).contiguous()
            ops.append(dist.P2POp(dist.isend, piece, axis.owners[j],
                                  axis.group, i * axis.n + j))
        out = []
        for i, j, lo, hi in recvs:
            shape = list(parts[pos[j]].shape)
            shape[dim] = hi - lo
            buf = parts[pos[j]].new_empty(shape)
            out.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, axis.owners[i],
                                  axis.group, i * axis.n + j))
        _run_p2p(ops)
        ctx.meta = meta
        ctx.shapes = [(p.shape, p.dtype, p.device) for p in parts]
        return (*out, parts[0].new_zeros(0))

    @staticmethod
    def backward(ctx, *grads):
        axis, ranges, dim, sends, recvs = ctx.meta
        pos = {s: k for k, s in enumerate(axis.local)}

        def rows_of(k, n_rows):
            shape, dtype, device = ctx.shapes[k]
            shape = list(shape)
            shape[dim] = n_rows
            return shape, dtype, device

        ops = []
        for (i, j, lo, hi), g in zip(recvs, grads):
            if g is None:
                shape, dtype, device = rows_of(pos[j], hi - lo)
                g = torch.zeros(shape, dtype=dtype, device=device)
            ops.append(dist.P2POp(dist.isend, g.contiguous(),
                                  axis.owners[i], axis.group,
                                  i * axis.n + j))
        received = []
        for i, j, lo, hi in sends:
            shape, dtype, device = rows_of(pos[i], hi - lo)
            buf = torch.empty(shape, dtype=dtype, device=device)
            received.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, axis.owners[j],
                                  axis.group, i * axis.n + j))
        _run_p2p(ops)
        out = [torch.zeros(shape, dtype=dtype, device=device)
               for shape, dtype, device in ctx.shapes]
        for (i, j, lo, hi), g in zip(sends, received):
            out[pos[i]].narrow(dim, lo - ranges[i][0], hi - lo).add_(g)
        return (None, *out)


def _no_rows(x, dim):
    return x.narrow(dim, 0, 0)


def exchange(rows, want):
    """For each shard ``j``, the rows ``want[j] = (a, b)`` of the whole
    tensor (None: nothing); returns the tensor of those rows for each
    local shard, on its device (no rows where it wants nothing). ``want``
    lists every shard's wish, so that each process knows what to send."""
    axis, ranges, dim = rows.axis, rows.ranges, rows.dim
    local = axis.local
    pos = {s: k for k, s in enumerate(local)}
    pieces = _pieces(ranges, want, local)
    sends = [p for p in pieces if p[0] in pos and p[1] not in pos]
    recvs = [p for p in pieces if p[1] in pos and p[0] not in pos]
    received, token = {}, None
    if sends or recvs:
        *out, token = _Exchange.apply((axis, ranges, dim, sends, recvs),
                                      *rows.parts)
        received = {(i, j): t for (i, j, _, _), t in zip(recvs, out)}
    tiles = []
    for k, j in enumerate(local):
        part = rows.parts[k]
        parts = [] if token is None else \
            [token.reshape(_no_rows(part, dim).shape)]
        for i, jj, lo, hi in pieces:
            if jj != j:
                continue
            if i in pos:
                parts.append(rows.parts[pos[i]].narrow(
                    dim, lo - ranges[i][0], hi - lo).to(axis.devices[k]))
            else:
                parts.append(received[i, j])
        if not parts:
            tiles.append(_no_rows(part, dim))
        elif len(parts) == 1:
            tiles.append(parts[0])
        else:
            tiles.append(torch.cat(parts, dim=dim))
    return tiles


def _on_rows(fn, x, dim, extent=1, pad_value=0.0):
    """``fn(x)`` of a part ``x`` that may hold no rows: an empty part runs
    ``fn`` on ``extent`` padding rows and keeps none of its output (a
    conv rejects an input of no rows), which gives the output's other
    dimensions and keeps the part in the autograd graph."""
    if x.shape[dim]:
        return fn(x)
    return _no_rows(fn(_pad_rows(x, 0, extent, pad_value, dim)), dim)


def _pad_rows(x, top, bottom, value, dim):
    if not (top or bottom):
        return x
    shape = list(x.shape)
    pads = []
    if top:
        shape[dim] = top
        pads.append(x.new_full(shape, value))
    pads.append(x)
    if bottom:
        shape[dim] = bottom
        pads.append(x.new_full(shape, value))
    return torch.cat(pads, dim=dim)


def row_op(rows, op, fn, *, pad_value=0.0):
    """A layer with row arithmetic ``op`` on ``rows``: each shard owns its
    split of the output's rows, fetches the input rows they read, pads the
    rows beyond the input with ``pad_value`` and runs ``fn(k, tile)``,
    which must apply no padding along H."""
    out_h = op.out_height(rows.height)
    out_ranges = split_rows(out_h, rows.axis.n)
    want = [op.fetch(s, e, rows.height)[:2] if s < e else None
            for s, e in out_ranges]
    tiles = exchange(rows, want)
    parts = []
    for k, j in enumerate(rows.axis.local):
        s, e = out_ranges[j]
        f = functools.partial(fn, k)
        if s >= e:
            parts.append(_on_rows(f, tiles[k], rows.dim,
                                 (op.kernel - 1) * op.dilation + 1,
                                 pad_value))
            continue
        _, _, top, bottom = op.fetch(s, e, rows.height)
        parts.append(f(_pad_rows(tiles[k], top, bottom, pad_value,
                                 rows.dim)))
    return rows.like(parts, out_ranges, out_h)


def halo_op(rows, halo, fn):
    """A stride-1 'SAME' op of ``halo`` rows each side (a kernel that pads
    its own input): each shard's tile gets ``halo`` rows from its real
    neighbours, clipped at the global edges, ``fn(k, tile)`` runs on the
    tile and the halo rows of its output are cropped. Exact at the global
    edges too, where the op's own zero padding is the layer's."""
    want = [(max(s - halo, 0), min(e + halo, rows.height)) if s < e
            else None for s, e in rows.ranges]
    tiles = exchange(rows, want)
    parts = []
    for k, j in enumerate(rows.axis.local):
        s, e = rows.ranges[j]
        f = functools.partial(fn, k)
        if s >= e:
            parts.append(_on_rows(f, tiles[k], rows.dim, 2 * halo + 1))
            continue
        parts.append(f(tiles[k]).narrow(rows.dim, s - want[j][0], e - s))
    return rows.like(parts)


def _first_shards(axis):
    """The first shard of each rank of ``axis`` (of this process alone
    when it holds them all)."""
    if axis.owners is None:
        return {axis.local[0]}
    first = {}
    for i, rank in enumerate(axis.owners):
        first.setdefault(rank, i)
    return set(first.values())


class _Gather(torch.autograd.Function):
    """The whole tensor of :func:`gather`; the backward gives each local
    shard the gradient of its own rows, times ``scale``."""

    @staticmethod
    def forward(ctx, meta, *parts):
        rows, device, scale = meta
        rows = rows.like(list(parts))
        # one copy of every row for each rank: its first shard's
        firsts = _first_shards(rows.axis)
        want = [(0, rows.height) if j in firsts else None
                for j in range(rows.axis.n)]
        k = next(k for k, j in enumerate(rows.axis.local) if j in firsts)
        with torch.no_grad():
            out = exchange(rows, want)[k].to(device)
        ctx.meta = (rows.local_ranges, rows.dim, scale)
        ctx.devices = [p.device for p in parts]
        return out

    @staticmethod
    def backward(ctx, grad):
        ranges, dim, scale = ctx.meta
        out = []
        for (s, e), device in zip(ranges, ctx.devices):
            g = grad.narrow(dim, s, e - s).to(device)
            out.append(g * scale if scale != 1 else g)
        return (None, *out)


def gather(rows, device, *, scale=1):
    """The whole tensor on ``device``, every rank of the axis getting all
    rows. Its backward hands each local shard the gradient of its own rows
    (the rank's copy of the whole tensor's gradient, not a sum over the
    ranks), times ``scale``."""
    if rows.axis.owners is None and scale == 1:
        return torch.cat([p.to(device) for p in rows.parts], dim=rows.dim)
    return _Gather.apply((rows, torch.device(device), scale), *rows.parts)
