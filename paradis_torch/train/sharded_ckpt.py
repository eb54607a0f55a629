"""Per-rank sharded checkpoints of a sharded (``compute.fsdp``) train state.

The port's counterpart of ``paradis_tpu/train/sharded_ckpt.py``.  Sharded,
no rank holds the whole state (``distributed.DataParallel`` gives each
parameter one owning data index), so every data rank writes what it owns
into its own file, ``shard_p{d}.pt`` in the checkpoint's ``state_sharded/``
directory (the JAX package's name).  Over spatial axes the ranks of a data
group's ``lat × space`` positions hold the same shard, and only the lead
position (``l = s = 0``) writes it:

* ``params``: the parameters it owns, by name;
* ``optimizer``: their optimizer state by parameter name
  (``ParadisOptimizer.param_states``), the optimizer's name and ``lr``;
* ``step``, ``micro_step``, and, in the middle of an accumulation window,
  ``accum``: the window's gradients of its parameters;
* ``rank`` (the data index ``d``) and ``world`` (the data size), and
  ``grid``, the ``[data, lat, space]`` grid it was written on.

:func:`read_sharded` reads every shard, checks that the set is whole
(``0 .. world-1``, each parameter once, the counters and the grid
agreeing) and merges them into one state by name, so a run of any layout
(one process, data ranks with or without FSDP, a spatial grid with or
without it) restores it: each rank takes the entries of the parameters it
owns under its own layout.  The files are ``torch.save`` of plain dicts of
tensors, read back with ``weights_only=True``.  No collectives are used
here; ``CheckpointManager`` orders the ranks around the directory.
"""

from __future__ import annotations

import re
from pathlib import Path

import torch

SHARD_DIR = "state_sharded"
_SHARD_FILE = "shard_p{rank}.pt"
_SHARD_RE = re.compile(r"shard_p(\d+)\.pt$")
_SHARD_FORMAT = "paradis_torch.state_shard/1"


def save_sharded(directory: str | Path, state, with_accum: bool) -> Path | None:
    """Write this data rank's shard of ``state`` (a ``TrainState`` with a
    sharded ``parallel``) into ``directory``, which must exist, where this
    rank is its data group's lead spatial position; returns the file, or
    None on the other positions.  ``with_accum``: the step is inside an
    accumulation window, whose gradients (already averaged over the ranks)
    are saved too."""
    from paradis_torch.train.checkpoint import write_file

    parallel = state.parallel
    grid = parallel.grid
    if not grid.lead:
        return None
    owned = {n: p for n, p in state.model.named_parameters() if parallel.owns(n)}
    obj = {"format": _SHARD_FORMAT, "rank": grid.d, "world": grid.data,
           "grid": [grid.data, grid.lat, grid.space],
           "params": {n: p.detach() for n, p in owned.items()},
           "optimizer": state.optimizer.param_states(),
           "step": int(state.step), "micro_step": int(state.micro_step)}
    if with_accum:
        obj["accum"] = {n: p.grad.detach() for n, p in owned.items() if p.grad is not None}
    path = Path(directory) / _SHARD_FILE.format(rank=grid.d)
    write_file(path, obj)
    return path


def is_sharded(path: str | Path) -> bool:
    """Whether a checkpoint directory holds a sharded state."""
    return (Path(path) / SHARD_DIR).is_dir()


def read_sharded(directory: str | Path) -> dict:
    """Every shard of one checkpoint, merged by name: ``{"params",
    "optimizer": {"name", "lr", "params"}, "step", "micro_step", "grid"[,
    "accum"]}`` on the CPU (``grid``: the ``[data, lat, space]`` it was
    written on; ``[world, 1, 1]`` for a shard that does not record one).
    Raises ``ValueError`` on a missing, foreign or inconsistent shard."""
    directory = Path(directory)
    files = {int(m.group(1)): f for f in directory.iterdir()
             if (m := _SHARD_RE.fullmatch(f.name))}
    if not files:
        raise FileNotFoundError(f"no shard files under {directory}")
    merged = {"params": {}, "optimizer": {"params": {}}, "accum": {}}
    world = None
    for rank in sorted(files):
        obj = torch.load(files[rank], map_location="cpu", weights_only=True)
        if not isinstance(obj, dict) or obj.get("format") != _SHARD_FORMAT:
            raise ValueError(f"{files[rank]} is not a {_SHARD_FORMAT} file")
        if obj["rank"] != rank:
            raise ValueError(f"{files[rank]} holds rank {obj['rank']}'s shard")
        world = obj["world"] if world is None else world
        head = {"world": obj["world"], "grid": obj.get("grid", [obj["world"], 1, 1]),
                "step": obj["step"], "micro_step": obj["micro_step"],
                "name": obj["optimizer"]["name"], "lr": obj["optimizer"]["lr"]}
        if rank == min(files):
            first = head
        elif head != first:
            raise ValueError(f"shard {rank} disagrees with shard {min(files)}: {head} vs {first}")
        for key, src, dst in (("params", obj["params"], merged["params"]),
                              ("optimizer", obj["optimizer"]["params"],
                               merged["optimizer"]["params"]),
                              ("accum", obj.get("accum", {}), merged["accum"])):
            twice = sorted(set(src) & set(dst))
            if twice:
                raise ValueError(f"{key} {twice} in more than one shard")
            dst.update(src)
    if sorted(files) != list(range(world)):
        raise ValueError(f"incomplete sharded checkpoint under {directory}: shards "
                         f"{sorted(files)} of a world of {world}")
    merged["optimizer"].update(name=first["name"], lr=first["lr"])
    merged.update(step=first["step"], micro_step=first["micro_step"], grid=first["grid"])
    if not merged["accum"]:
        del merged["accum"]
    return merged
