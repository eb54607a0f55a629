"""Ranks, process groups, and the data-parallel and sharded layouts.

The port's counterpart of ``paradis_tpu/distributed.py``.  The JAX package
runs one process per host and a ``(data, lat, space)`` mesh of the devices
in it, and GSPMD inserts the collectives.  In PyTorch one process drives one
device, so this module is about ranks: the launcher
(``python -m torch.distributed.run --nproc-per-node N``) starts one process a
device, :func:`initialize_distributed` joins them in a process group, and
the collectives are explicit:

* data parallelism (the ``data`` axis, the reference's Lightning DDP): every
  rank walks the same seeded global order and loads its own rows of each
  global batch (:func:`local_batch_slice`), and :class:`DataParallel`
  averages each parameter's gradient over the ranks once an applied step,
  in buckets, where JAX's psum falls out of jit;
* ``compute.fsdp``: :class:`DataParallel` with ``fsdp=True`` shards the
  parameters and the optimizer state by whole parameter over the data
  group (every parameter has one owning data index, :func:`assign_owners`,
  the same at every spatial position), the counterpart of
  ``fsdp_shardings`` / ``shard_state`` over the ``data`` axis;
  ``train/sharded_ckpt.py`` saves and restores that layout;
* the ``(lat, space)`` spatial axes (``compute.lat_devices``,
  ``compute.spatial_devices``): the ranks form a ``data × lat × space``
  grid in ``create_mesh``'s order, ``rank = (d·lat + l)·space + s``
  (:func:`rank_grid`, after :func:`fit_check`, makes each rank's
  ``sphere.partition.RankGrid`` and the process groups, once).  A rank holds
  the ``H/lat`` rows and ``W/space`` columns of its block of every field;
  the layers learn of the grid through ``sphere.partition.spatial_rules``,
  and its collectives are all ``all_reduce`` calls, which gloo carries on CUDA
  tensors too, so ranks sharing one card run the code of ranks on their own
  cards.  The gradients of a rank's block are summed over the spatial group
  and averaged over the data group by :class:`DataParallel`, in one
  ``all_reduce`` over the world.  The coarse processor runs on the grid
  that fits its field (``RankGrid.fit``: an axis that does not divide it is
  collapsed);
* distributed NorMuon: each rank orthogonalizes its share of a
  Newton–Schulz stack (``RankGrid.ns_share``, the counterpart of
  ``constrain_ns_batch``).
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from paradis_torch.sphere.partition import RankGrid

log = logging.getLogger("paradis_torch")

DIST_BACKENDS = ("auto", "nccl", "gloo")
_BUCKET_BYTES = 25 * 2**20  # gradient bucket, as DDP's default


@dataclass(frozen=True)
class Ranks:
    """This process's place in the run: its rank, the world size, its rank
    on this host, the device it drives and the process group's backend
    (None when no process group was made: one process, no launcher)."""

    rank: int
    world: int
    local_rank: int
    device: torch.device
    backend: str | None = None


def pick_backend(requested: str, device: torch.device, local_world: int,
                 device_count: int) -> str:
    """The process group's backend for ``compute.dist_backend``.

    ``auto`` is ``nccl`` on a card and ``gloo`` on the CPU.  NCCL refuses two
    ranks on one card, so where this host starts more ranks than it has cards
    ``auto`` and ``nccl`` raise and say to pass ``gloo``: nothing falls back
    silently.
    """
    if requested not in DIST_BACKENDS:
        raise ValueError(f"compute.dist_backend={requested!r}: one of {DIST_BACKENDS}")
    if device.type != "cuda":
        if requested == "nccl":
            raise ValueError("compute.dist_backend=nccl needs ranks on cards; "
                             "the CPU takes gloo (or auto)")
        return "gloo"
    if requested == "gloo":
        return "gloo"
    if local_world > device_count:
        raise ValueError(
            f"{local_world} ranks on this host and {device_count} card(s): NCCL refuses "
            f"two ranks on one card, so compute.dist_backend={requested} cannot run here; "
            f"pass compute.dist_backend=gloo to share a card between ranks")
    return "nccl"


def initialize_distributed(cfg, device=None) -> Ranks:
    """Join the launched processes in a process group, and pick this rank's
    device.

    Reads the launcher's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)
    and also the JAX package's keys (``paradis_tpu/cli/train.py:33-45``):
    ``compute.coordinator_address`` or ``PARADIS_COORDINATOR`` for the
    address, ``PARADIS_PROCESS_ID`` for the rank, and
    ``compute.num_devices × compute.num_nodes`` for the world size where the
    launcher sets none.  A no-op with one process and no coordinator: no
    launcher environment and no address.

    The rank's device is ``cuda:LOCAL_RANK`` (modulo the cards there are, so
    ranks may share a card under gloo), or the CPU when ``device`` says so.
    ``compute.dist_backend`` picks the backend (:func:`pick_backend`).
    """
    from paradis_torch import resolve_device

    device = resolve_device(device)
    compute = cfg.compute
    coord = compute.get("coordinator_address", None) or os.environ.get("PARADIS_COORDINATOR")
    launched = "WORLD_SIZE" in os.environ
    if not launched and not coord:
        return Ranks(0, 1, 0, device)
    if launched:
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ.get("RANK", 0))
    else:
        world = int(compute.get("num_devices", 1) or 1) * int(compute.get("num_nodes", 1) or 1)
        rank = int(os.environ.get("PARADIS_PROCESS_ID", "0"))
    per_host = int(compute.get("num_devices", 1) or 1)
    local_rank = int(os.environ.get("LOCAL_RANK", rank % per_host))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", min(world, per_host)))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a rank on a CUDA device and none is available; pass "
                               "--device cpu to run the ranks on the CPU")
        count = torch.cuda.device_count()
        device = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(device)
    else:
        count = 0
    backend = pick_backend(str(compute.get("dist_backend", "auto") or "auto"), device,
                           local_world, count)
    if not dist.is_initialized():
        init = f"tcp://{coord}" if coord and not launched else "env://"
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(minutes=10))
    return Ranks(rank, world, local_rank, device, backend)


def shutdown_distributed() -> None:
    """Destroy the process group, where there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main_process() -> bool:
    """True on the rank that owns the store, checkpoint and log writes."""
    return get_rank() == 0


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def _sizes(cfg) -> tuple[int, int, int]:
    """``(num_devices × num_nodes, lat_devices, spatial_devices)`` as asked."""
    compute = cfg.compute
    n = {k: int(compute.get(k, 1) or 1)
         for k in ("num_devices", "num_nodes", "lat_devices", "spatial_devices")}
    return n["num_devices"] * n["num_nodes"], n["lat_devices"], n["spatial_devices"]


def fit_check(cfg) -> tuple[int, int, int]:
    """``(data, lat, space)`` of the launched world: ``compute.num_devices ×
    compute.num_nodes × compute.lat_devices × compute.spatial_devices`` must
    equal the launched world size, where ``num_devices × num_nodes`` of 1
    (the defaults) is taken as "the world over the spatial axes".  Anything
    else raises ``ValueError`` before any batch is loaded; so does
    ``compute.coordinator_address`` without a process group.  (The JAX
    ``mesh_from_config`` silently takes whatever devices there are instead.)"""
    asked, lat, space = _sizes(cfg)
    if min(asked, lat, space) < 1:
        raise ValueError(f"compute.num_devices × num_nodes, lat_devices, spatial_devices = "
                         f"{asked}, {lat}, {space}: each must be at least 1")
    if cfg.compute.get("coordinator_address", None) and not is_initialized():
        raise ValueError("compute.coordinator_address is set and no process group is "
                         "initialised: a multi-GPU run calls initialize_distributed first "
                         "(python -m paradis_torch.cli.train does)")
    world = world_size()
    data = world // (lat * space) if asked == 1 and world % (lat * space) == 0 else asked
    if data * lat * space != world:
        raise ValueError(
            f"compute.num_devices × compute.num_nodes × compute.lat_devices × "
            f"compute.spatial_devices = {asked} × {lat} × {space} = {asked * lat * space}, "
            f"but {world} process(es) were launched: a multi-GPU run launches one process "
            f"per device (python -m torch.distributed.run --nproc-per-node N)")
    return data, lat, space


def local_batch_slice(global_batch: int, rank: int, world: int) -> slice:
    """The rows of each global batch that ``rank`` loads: one contiguous
    block of ``global_batch / world`` (``paradis_tpu/distributed.py:261-275``)."""
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by the {world} ranks")
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)


def contiguous_share(n: int, rank: int, world: int) -> tuple[int, int]:
    """``[lo, hi)``: rank's contiguous share of ``n`` items, the first
    ``n % world`` ranks taking one more (a ragged tail needs no padding)."""
    per, extra = divmod(n, world)
    lo = rank * per + min(rank, extra)
    return lo, lo + per + (rank < extra)


_GROUPS: dict[tuple[int, int, int], dict[str, list]] = {}


def grid_group_ranks(data: int, lat: int, space: int) -> dict[str, list[list[int]]]:
    """The global ranks of each process group of the grid, in
    ``create_mesh``'s order: the spatial groups (by ``d``), the space rows
    (by ``(d, l)``), the lat columns (by ``(d, s)``) and the data groups (by
    ``(l, s)``)."""
    def rank(d, l, s):
        return (d * lat + l) * space + s

    return {
        "spatial": [[rank(d, l, s) for l in range(lat) for s in range(space)]
                    for d in range(data)],
        "rows": [[rank(d, l, s) for s in range(space)] for d in range(data) for l in range(lat)],
        "cols": [[rank(d, l, s) for l in range(lat)] for d in range(data) for s in range(space)],
        "data": [[rank(d, l, s) for d in range(data)] for l in range(lat) for s in range(space)],
    }


def _grid_groups(data: int, lat: int, space: int) -> dict[str, list]:
    """The process groups of :func:`grid_group_ranks`, made once a layout
    with ``dist.new_group``, which every rank calls for every group, in the
    same order; a list of ranks made before (a lat column that is the
    spatial group, say) takes the group made for it, and a group of one
    rank is None."""
    key = (data, lat, space)
    if key not in _GROUPS:
        made = {}

        def make(ranks):
            if len(ranks) < 2:
                return None
            if tuple(ranks) not in made:
                made[tuple(ranks)] = dist.new_group(ranks)
            return made[tuple(ranks)]

        _GROUPS[key] = {name: [make(r) for r in lists]
                        for name, lists in grid_group_ranks(data, lat, space).items()}
    return _GROUPS[key]


def rank_grid(cfg) -> RankGrid:
    """This rank's :class:`RankGrid` for the config, after :func:`fit_check`;
    the process groups are made on the first call for a layout."""
    data, lat, space = fit_check(cfg)
    rank = get_rank()
    d, rest = divmod(rank, lat * space)
    l, s = divmod(rest, space)
    if lat * space == 1:
        return RankGrid(data, lat, space, d, l, s)
    g = _grid_groups(data, lat, space)
    return RankGrid(data, lat, space, d, l, s, g["spatial"][d], g["rows"][d * lat + l],
                    g["cols"][d * space + s], g["data"][l * space + s])


def all_reduce_mean(x, divisor: int | None = None):
    """The mean over the ranks of a tensor, or of each tensor of a dict (on
    the device; one collective for a dict, no host sync under NCCL): the sum
    over the world divided by the world size, or by ``divisor`` (the data
    size, for gradients of blocks that the spatial group sums).  Returns
    ``x`` itself without a process group."""
    if not is_initialized():
        return x
    if isinstance(x, dict):
        keys = list(x)
        return dict(zip(keys, _mean_tensors([x[k] for k in keys], divisor)))
    return _mean_tensors([x], divisor)[0]


def _mean_tensors(tensors: list[torch.Tensor], divisor: int | None = None
                  ) -> list[torch.Tensor]:
    """Each tensor's sum over the ranks over ``divisor`` (the world size
    unless given), in its own dtype, through one flat float32 buffer (the
    inputs are left as they were)."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat.div_(divisor or dist.get_world_size())
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out


def assign_owners(sizes: list[int], world: int) -> list[int]:
    """The owning rank of each parameter (by its element count): largest
    first, each to the least loaded rank, ties to the earlier parameter and
    the lower rank.  Deterministic, so every rank computes the same map."""
    load = [0] * world
    owner = [0] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: (-sizes[i], i)):
        r = min(range(world), key=lambda r: (load[r], r))
        owner[i] = r
        load[r] += sizes[i]
    return owner


class DataParallel:
    """A model's parameters over the process group's ranks.

    Replicated (the default): rank 0's parameters are broadcast at the
    start, and :meth:`average_gradients` averages every ``.grad`` over the
    ranks in buckets, so every rank applies the same update and stays
    bitwise the same.  The optimizer runs redundantly on every rank, as
    under the reference's Lightning DDP.

    ``fsdp=True`` with more than one data rank shards by whole parameter
    over the data group (the ranks that share this rank's ``(l, s)``; all
    ranks without spatial axes), as ``shard_state(fsdp=True)`` shards over
    the ``data`` axis alone: each parameter has one owning data index
    (:func:`assign_owners`), the same at every spatial position, whose rank
    alone in its data group keeps the parameter's optimizer state and
    applies its update (NorMuon's Newton–Schulz then runs on whole matrices,
    on their owner).  The owners of one parameter at the ``lat × space``
    spatial positions compute its update redundantly, on the same averaged
    gradient, so they stay bitwise equal.  Between steps a rank holds only
    its own parameters (:meth:`release`); :meth:`gather` broadcasts each
    owner's parameters inside its data group, once a step, before the
    forward.  After the average a rank keeps only its own parameters'
    gradients.  This layout needs only ``broadcast`` and ``all_reduce``,
    which gloo carries on CUDA tensors, and keeps the parameters plain
    tensors, so the custom ops, gradient checkpointing and the stacked
    Newton–Schulz run as on one device.

    ``grid`` (:func:`rank_grid`; all ranks data parallel when None): over
    spatial axes a rank's gradients are its block's share, so the average
    is the sum over the world divided by the data size (the sum over the
    spatial group, averaged over the data group); the replicated optimizer
    then splits its Newton–Schulz stacks over the grid.
    """

    def __init__(self, model: torch.nn.Module, fsdp: bool = False,
                 grid: RankGrid | None = None):
        self.model = model
        self.world, self.rank = world_size(), get_rank()
        self.grid = grid if grid is not None else RankGrid(self.world, d=self.rank)
        self.active = is_initialized()
        self.named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.fsdp = bool(fsdp) and self.grid.data > 1
        owners = (assign_owners([p.numel() for _, p in self.named], self.grid.data)
                  if self.fsdp else [self.grid.d] * len(self.named))
        self.owner = {n: d for (n, _), d in zip(self.named, owners)}  # data indices
        self.shapes = {n: p.shape for n, p in self.named}  # whole, also while released
        self._gathered = True
        if self.active:
            with torch.no_grad():
                self._broadcast_from(0, list(self.shapes), None)
        self.release()

    def owns(self, name: str) -> bool:
        return self.owner[name] == self.grid.d

    def owned_names(self) -> set[str]:
        return {n for n, _ in self.named if self.owns(n)}

    # -- parameters ----------------------------------------------------------------

    def _broadcast_from(self, src: int, names: list[str], group) -> None:
        """Broadcast the parameters ``names`` (each rank's same list) from
        global rank ``src`` over ``group`` (None: the world) in one flat
        buffer of each dtype; the receivers' parameters become views of
        it."""
        params = dict(self.named)
        by_dtype: dict[torch.dtype, list] = {}
        for n in names:
            by_dtype.setdefault(params[n].dtype, []).append(n)
        for dtype, group_names in by_dtype.items():
            sizes = [self.shapes[n].numel() for n in group_names]
            if self.rank == src:
                flat = torch.cat([params[n].data.reshape(-1) for n in group_names])
            else:
                flat = torch.empty(sum(sizes), dtype=dtype, device=self.model.device)
            dist.broadcast(flat, src=src, group=group)
            if self.rank != src:
                for n, part in zip(group_names, flat.split(sizes)):
                    params[n].data = part.view(self.shapes[n])

    def gather(self) -> None:
        """Give every rank every parameter (sharded only; once a step): each
        owner broadcasts inside this rank's data group, from the global rank
        of the owning data index at this rank's ``(l, s)``."""
        if not self.fsdp or self._gathered:
            return
        with torch.no_grad():
            for d in range(self.grid.data):
                self._broadcast_from(self.grid.rank_of(d),
                                     [n for n, _ in self.named if self.owner[n] == d],
                                     self.grid.data_group)
        self._gathered = True

    def release(self) -> None:
        """Drop the parameters other ranks own (sharded only)."""
        if not self.fsdp or not self._gathered:
            return
        for n, p in self.named:
            if not self.owns(n):
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)
                p.grad = None
        self._gathered = False

    @contextlib.contextmanager
    def gathered(self):
        """Every parameter whole inside the block; sharded again after it
        where it was before."""
        was = self._gathered
        self.gather()
        try:
            yield
        finally:
            if not was:
                self.release()

    # -- gradients -----------------------------------------------------------------

    def average_gradients(self, owned_only: bool = True) -> None:
        """Average every parameter's ``.grad`` over the ranks (sum, then
        divide by the data size: the world size without spatial axes), in
        buckets of ``_BUCKET_BYTES`` a dtype.
        A parameter with no gradient on this rank takes part as zeros.
        Sharded, a rank then keeps only its own parameters' gradients, unless
        ``owned_only`` is false (a checkpoint inside an accumulation window,
        which goes on accumulating into every gradient)."""
        if not self.active:
            return
        with torch.no_grad():
            bucket, nbytes = [], 0
            for n, p in self.named:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                if bucket and (p.grad.dtype != bucket[0].dtype
                               or nbytes + p.grad.nbytes > _BUCKET_BYTES):
                    self._reduce_bucket(bucket)
                    bucket, nbytes = [], 0
                bucket.append(p.grad)
                nbytes += p.grad.nbytes
            if bucket:
                self._reduce_bucket(bucket)
            if self.fsdp and owned_only:
                for n, p in self.named:
                    if not self.owns(n):
                        p.grad = None

    def _reduce_bucket(self, grads: list[torch.Tensor]) -> None:
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat.div_(self.grid.data)
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in
                                     zip(flat.split([g.numel() for g in grads]), grads)])

    def spread_gradients(self) -> None:
        """Undo :meth:`average_gradients` for a window that goes on: each
        rank's whole (averaged) gradients become its ``1/spatial`` share, so
        the window's next average sums them back to the whole."""
        if self.grid.spatial > 1:
            with torch.no_grad():
                torch._foreach_div_([p.grad for _, p in self.named if p.grad is not None],
                                    self.grid.spatial)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data group, in place (sharded sums of
        squares: the data group holds each parameter once, where the world
        holds it ``lat × space`` times)."""
        if self.active and self.grid.data > 1:
            dist.all_reduce(t, group=self.grid.data_group)
        return t
