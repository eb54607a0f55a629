"""The ranks' blocks of the lat-lon grid: the ``(lat, space)`` axes of the
JAX package's mesh (``paradis_tpu/distributed.py:43-191``) as a grid of
ranks, and the context the model's layers read.

A :class:`RankGrid` is one rank's place ``(d, l, s)`` in the ``data × lat ×
space`` grid (``distributed.rank_grid`` makes it, with its process groups),
its block of a field (``H/lat`` rows and ``W/space`` columns) and the
collectives between blocks, each a ``torch.autograd.Function`` with its
adjoint and each an ``all_reduce`` (a gather sums a zero-filled buffer),
which gloo carries on CUDA tensors too.  Inside :func:`spatial_rules` (the
counterpart of the JAX context of that name) the geocyclic pad exchanges
halos, the pole rows average over the space row, the advection gathers its
field and the losses sum over the spatial group; outside it every function
is the one-process function.  The layers import this module and no more of
the ranks (the serving export imports the layers without the process
groups).

A grid whose axes do not divide a field (the coarse grid of a
``model.coarsening_factor`` above 1) runs it on :meth:`RankGrid.fit`'s grid,
where each such axis is collapsed: its ranks hold the whole extent along it
and compute it alike, as ``constrain_spatial`` leaves an axis that does not
divide a dimension unconstrained (``paradis_tpu/distributed.py:160-190``).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass, field, replace

import torch
import torch.distributed as dist


class _Gather(torch.autograd.Function):
    """``[n, *x.shape]``: every rank's ``x`` of a group of ``n``, this rank's at
    ``index`` (an ``all_reduce`` of a zero-filled buffer: exact, since every
    other addend is zero).  The adjoint sums each slot's cotangent over the
    ranks and keeps this rank's: the reduce-scatter of a gather."""

    @staticmethod
    def forward(ctx, x, group, index: int, n: int):
        ctx.group, ctx.index = group, index
        buf = x.new_zeros((n, *x.shape))
        buf[index] = x
        dist.all_reduce(buf, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.index], None, None, None


class _Sum(torch.autograd.Function):
    """The sum over a group of ranks, each rank consuming it in its own way:
    the adjoint sums the cotangents over the group too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumReplicated(torch.autograd.Function):
    """The sum over a group of ranks, the result consumed alike on every rank
    (a loss that each rank backpropagates): the adjoint is the identity, so
    the group's copies of the loss count once."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclass(frozen=True)
class RankGrid:
    """This rank's place ``(d, l, s)`` in the ``data × lat × space`` grid of
    ranks (``rank = (d·lat + l)·space + s``, the order of the JAX
    ``create_mesh``), and the process groups of its spatial group (the
    ``lat × space`` ranks of its ``d``), of its space row (the ``space``
    ranks of its ``(d, l)``), of its lat column (the ``lat`` ranks of its
    ``(d, s)``) and of its data group (the ``data`` ranks of its ``(l, s)``,
    over which ``compute.fsdp`` shards); None where a group has one rank,
    and the data group also where it is the whole world (no spatial axis:
    the default group)."""

    data: int = 1
    lat: int = 1
    space: int = 1
    d: int = 0
    l: int = 0
    s: int = 0
    spatial_group: object = field(default=None, compare=False, repr=False)
    row_group: object = field(default=None, compare=False, repr=False)
    col_group: object = field(default=None, compare=False, repr=False)
    data_group: object = field(default=None, compare=False, repr=False)

    @property
    def spatial(self) -> int:
        return self.lat * self.space

    @property
    def spatial_index(self) -> int:
        return self.l * self.space + self.s

    @property
    def lead(self) -> bool:
        """The first rank of its spatial group (the one that writes)."""
        return self.l == 0 and self.s == 0

    def rank_of(self, d: int) -> int:
        """The global rank at data index ``d`` and this rank's ``(l, s)``: the
        member ``d`` of its data group."""
        return (d * self.lat + self.l) * self.space + self.s

    def fit(self, H: int, W: int) -> "RankGrid":
        """The grid that runs on a whole field of ``H × W`` points: this one
        where its axes divide them, else this one with each axis that does
        not divide its dimension collapsed (the coarse processor's grid).
        The ranks along a collapsed axis each hold the whole extent along it
        and compute it alike, and the collectives run over the other axis
        alone: the space row where ``lat`` is collapsed, the lat column
        where ``space`` is, none where both are.  A rank's share of a
        cotangent stays its own along a collapsed axis, and the gather back
        to the fine grid (``gather``'s adjoint) sums the shares."""
        lat_fits, space_fits = H % self.lat == 0, W % self.space == 0
        if lat_fits and space_fits:
            return self
        lat, l = (self.lat, self.l) if lat_fits else (1, 0)
        space, s = (self.space, self.s) if space_fits else (1, 0)
        return replace(self, lat=lat, space=space, l=l, s=s,
                       spatial_group=(self.col_group if lat > 1 else
                                      self.row_group if space > 1 else None),
                       row_group=self.row_group if space > 1 else None,
                       col_group=self.col_group if lat > 1 else None)

    def rows(self, H: int) -> slice:
        """This rank's rows of a grid of ``H`` latitudes."""
        if H % self.lat:
            raise ValueError(f"the grid's {H} latitudes do not split into "
                             f"compute.lat_devices={self.lat} equal blocks")
        h = H // self.lat
        return slice(self.l * h, (self.l + 1) * h)

    def cols(self, W: int) -> slice:
        """This rank's columns of a grid of ``W`` longitudes."""
        if W % self.space:
            raise ValueError(f"the grid's {W} longitudes do not split into "
                             f"compute.spatial_devices={self.space} equal blocks")
        w = W // self.space
        return slice(self.s * w, (self.s + 1) * w)

    def block_shape(self, H: int, W: int) -> tuple[int, int]:
        r, c = self.rows(H), self.cols(W)
        return r.stop - r.start, c.stop - c.start

    def block(self, x, H: int | None = None, W: int | None = None):
        """This rank's block of a whole ``[..., H, W, C]`` field (a view; a
        tensor or a numpy array)."""
        return x[..., self.rows(x.shape[-3] if H is None else H),
                 self.cols(x.shape[-2] if W is None else W), :]

    # -- collectives (each an all_reduce; issued alike on every rank of the group) --

    def gather_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """``[lat, space, *x.shape]``: every block of the spatial group."""
        if self.spatial == 1:
            return x[None, None]
        return _Gather.apply(x, self.spatial_group, self.spatial_index,
                             self.spatial).view(self.lat, self.space, *x.shape)

    def gather_row(self, x: torch.Tensor) -> torch.Tensor:
        """``[space, *x.shape]``: every rank's ``x`` of the space row."""
        if self.space == 1:
            return x[None]
        return _Gather.apply(x, self.row_group, self.s, self.space)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole ``[..., H, W, C]`` field from every rank's block
        ``[..., h, w, C]``; its adjoint keeps this rank's block of the
        cotangent summed over the ranks."""
        blocks = self.gather_blocks(x)                   # [lat, space, ..., h, w, C]
        lead = x.dim() - 3
        perm = [*range(2, 2 + lead), 0, 2 + lead, 1, 3 + lead, 4 + lead]
        h, w, c = x.shape[-3:]
        return blocks.permute(*perm).reshape(*x.shape[:-3], self.lat * h, self.space * w, c)

    def sum_row(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the space row (each rank consumes it its own way)."""
        return x if self.space == 1 else _Sum.apply(x, self.row_group)

    def sum_replicated(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the spatial group, for a result every rank of it
        uses alike (a loss): its gradient counts once."""
        return x if self.spatial == 1 else _SumReplicated.apply(x, self.spatial_group)

    def mean(self, x: torch.Tensor, dim=None) -> torch.Tensor:
        """The mean over the whole field of a block's ``x`` (over ``dim``,
        which must hold the spatial dims, or all of them): the block's sum
        over the global count, summed over the spatial group."""
        count = (x.numel() if dim is None else math.prod(x.shape[i] for i in dim)) * self.spatial
        local = x.sum() if dim is None else x.sum(dim=dim)
        return self.sum_replicated(local / count)

    def spectral_share(self, channels: int) -> tuple[int, int]:
        """``(ways, index)``: the AMSE transform's channels split ``ways``
        ways over the spatial axes, taken in turn, whose sizes multiply to a
        divisor of ``channels``; this rank transforms share ``index``
        (``paradis_tpu/distributed.py:116-157``; 1 way where none divides:
        the whole field on every rank)."""
        ways, index = 1, 0
        for size, coord in ((self.lat, self.l), (self.space, self.s)):
            if size > 1 and channels % (ways * size) == 0:
                ways, index = ways * size, index * size + coord
        return ways, index

    # -- distributed NorMuon ---------------------------------------------------

    def ns_share(self, n: int) -> tuple[int, int, bool, list[str]]:
        """``(ways, index, lead, axes)``: a stack of ``n`` Newton–Schulz
        matrices splits ``ways`` ways over the axes of ``(data, lat, space)``,
        taken in turn, whose sizes multiply to a divisor of ``n``
        (``paradis_tpu/distributed.py:96-111``); this rank computes share
        ``index`` and is its ``lead`` copy where the other axes hold it
        again."""
        ways, index, lead, axes = 1, 0, True, []
        for name, size, coord in (("data", self.data, self.d), ("lat", self.lat, self.l),
                                  ("space", self.space, self.s)):
            if size > 1 and n % (ways * size) == 0:
                ways, index = ways * size, index * size + coord
                axes.append(name)
            elif coord:
                lead = False
        return ways, index, lead, axes


_GRID: contextvars.ContextVar[RankGrid | None] = contextvars.ContextVar(
    "paradis_torch_rank_grid", default=None)


@contextlib.contextmanager
def spatial_rules(grid: RankGrid | None):
    """Inside the ``with``, the model runs on ``grid``'s blocks (the
    counterpart of ``paradis_tpu.distributed.spatial_rules``).  A grid
    without spatial axes, or None, leaves every function its one-process
    self."""
    token = _GRID.set(grid if grid is not None and grid.spatial > 1 else None)
    try:
        yield
    finally:
        _GRID.reset(token)


def spatial_grid() -> RankGrid | None:
    """The grid of the enclosing :func:`spatial_rules`, or None."""
    return _GRID.get()


def spatial_mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``x.mean(dim)`` over the whole field: the one-process mean outside
    :func:`spatial_rules`, :meth:`RankGrid.mean` inside it."""
    grid = spatial_grid()
    if grid is None:
        return x.mean() if dim is None else x.mean(dim=dim)
    return grid.mean(x, dim)
