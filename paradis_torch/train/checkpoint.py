"""Checkpoints with the reference's three retention policies.

Port of ``paradis_tpu/train/checkpoint.py``.  The layout is the JAX
package's: ``<root>/{steps,epochs,best}/<tag>/`` with the tags ``%08d``
(optimizer step), ``%04d`` (epoch) and ``best``, a ``<root>/last.json``
pointer to the newest checkpoint and ``<root>/best/metric.json``.  Each
checkpoint directory holds a ``state.pt`` file (full resume) and, for epoch
and best checkpoints, a bare ``params.pt`` (weights-only and transfer loads;
``load_params`` reads the parameters out of ``state.pt`` too).

The files are the port's own: ``torch.save`` of plain dicts of tensors,
lists, strings and numbers, read back with ``torch.load(...,
weights_only=True)``, which runs no pickled code.  ``state.pt`` holds

* ``params``: the model's parameters by name (``named_parameters``, as the
  JAX params tree; not the derived buffers);
* ``optimizer``: ``ParadisOptimizer.state_dict()`` (AdamW, the Muon stacks
  keyed by parameter name, the host-set learning rate);
* ``step`` and ``micro_step``;
* ``accum``: where ``micro_step % accumulate_grad_batches != 0``, the
  gradients accumulated so far in the window (JAX's ``accum``), so a resume
  in the middle of a window is the same run.

Over several ranks every rank calls the manager's methods, in the same
order (their decisions come from the host-mirrored step and the ranks'
averaged validation loss).  A replicated state is saved by rank 0 after a
barrier, as one ``state.pt``; a sharded state (``compute.fsdp`` on more
than one data rank) by every data rank, each its own file in
``state_sharded/``, written by the lead spatial position of its data group
(``train/sharded_ckpt.py``, the counterpart of ``_is_cross_process_sharded``
at ``paradis_tpu/train/checkpoint.py:30``).  In the middle of an
accumulation window the ranks' gradients are first averaged over the ranks
in place: the window's mean is what any world size resumes from (over
spatial axes each rank then goes on from its ``1/spatial`` share of it,
``DataParallel.spread_gradients``, so that the window's average sums the
shares back).  Either
kind restores into a run of any world size, sharded or not, and
``load_params`` reads a sharded checkpoint's parameters in one process.

A file is written to a temporary name and renamed into place.  A load reads
and checks the whole file before it changes anything: a truncated file fails
in ``torch.load`` (``RuntimeError``), a file of other pickled objects is
refused by ``weights_only`` (``pickle.UnpicklingError``), and a file of
another format, names or shapes raises ``ValueError``; in each case the
model and optimizer are left as they were.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from pathlib import Path

import numpy as np
import torch
from torch import nn

from paradis_torch import distributed
from paradis_torch.ops.resize import linear_interp_matrix
from paradis_torch.train.optim import param_states_of
from paradis_torch.train.sharded_ckpt import SHARD_DIR, is_sharded, read_sharded, save_sharded

STATE_FILE = "state.pt"
PARAMS_FILE = "params.pt"
_STATE_FORMAT = "paradis_torch.state/1"
_PARAMS_FORMAT = "paradis_torch.params/1"


def write_file(path: Path, obj: dict) -> None:
    """``torch.save`` to a temporary name beside ``path``, then rename."""
    tmp = path.with_name(f".{path.name}.tmp-{os.getpid()}")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _read(path: Path, *formats: str) -> dict:
    """A file of one of ``formats``, read onto the CPU: a load copies each
    tensor to its parameter's device (AdamW keeps its step counts on the
    CPU, as a fresh ``torch.optim.AdamW`` does)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    got = obj.get("format") if isinstance(obj, dict) else type(obj).__name__
    if got not in formats:
        raise ValueError(f"{path} is not a {' or '.join(formats)} file (format {got!r})")
    return obj


def _params(model: nn.Module) -> dict[str, torch.Tensor]:
    return {name: p.detach() for name, p in model.named_parameters()}


def state_dict(state, accumulate_grad_batches: int = 1) -> dict:
    """The contents of ``state.pt`` for a ``TrainState`` (references to the
    live tensors; ``torch.save`` copies them out)."""
    out = {"format": _STATE_FORMAT, "params": _params(state.model),
           "optimizer": state.optimizer.state_dict(),
           "step": int(state.step), "micro_step": int(state.micro_step)}
    if state.micro_step % accumulate_grad_batches:
        out["accum"] = {name: p.grad.detach() for name, p in state.model.named_parameters()
                        if p.grad is not None}
    return out


def _check_params(loaded: dict, model: nn.Module, shapes: dict | None = None) -> None:
    """Strict: the same names, and each shape the model's (JAX's errors).
    ``shapes``: the parameters' whole shapes where the model holds shards."""
    target = shapes or {n: p.shape for n, p in model.named_parameters()}
    missing, extra = sorted(set(target) - set(loaded)), sorted(set(loaded) - set(target))
    if missing or extra:
        raise ValueError("checkpoint parameter tree does not match the model "
                         f"(missing {missing}, unexpected {extra})")
    for name, shape in target.items():
        if tuple(loaded[name].shape) != tuple(shape):
            raise ValueError(f"shape mismatch at {name}: {tuple(loaded[name].shape)} "
                             f"vs expected {tuple(shape)}")


def load_state_dict(state, sd: dict) -> None:
    """Restore ``state_dict()``'s output, or a merged sharded checkpoint
    (``sharded_ckpt.read_sharded``), into ``state`` (model, optimizer,
    counters and any accumulated gradients), all checked before any copy.

    Sharded (``state.parallel.fsdp``), a rank copies only the parameters and
    optimizer state it owns; the accumulated gradients go to every parameter,
    so a restore in the middle of a window gathers the parameters first (a
    collective: every rank restores)."""
    model, optimizer, parallel = state.model, state.optimizer, state.parallel
    sharded = parallel is not None and parallel.fsdp
    _check_params(sd["params"], model, parallel.shapes if sharded else None)
    accum = sd.get("accum", {})
    bad = sorted(n for n in accum if n not in sd["params"]
                 or tuple(accum[n].shape) != tuple(sd["params"][n].shape))
    if bad:
        raise ValueError(f"accumulated gradients do not fit the parameters: {bad}")
    opt = sd["optimizer"]
    if "params" in opt or sharded:  # by name: any split of the parameters over ranks
        optimizer.load_param_states(opt if "params" in opt else param_states_of(opt))
    else:
        optimizer.load_state_dict(opt)  # checks all of it before it copies
    if sharded and accum:
        parallel.gather()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if sharded and not parallel.owns(name) and p.numel() == 0:
                continue  # released: its owner holds it
            p.copy_(sd["params"][name])
            p.grad = accum[name].to(p.device, p.dtype).clone() if name in accum else None
    if accum and parallel is not None:
        parallel.spread_gradients()
    state.step, state.micro_step = int(sd["step"]), int(sd["micro_step"])


class CheckpointManager:
    """Directory layout: ``<root>/{steps,epochs,best}/<tag>/``.

    ``accumulate_grad_batches`` is the train step's: a checkpoint taken in
    the middle of an accumulation window keeps the window's gradients.
    """

    def __init__(self, root: str, keep_steps: int = 10, step_every: int = 100,
                 accumulate_grad_batches: int = 1):
        self.root = Path(root)
        self.keep_steps = keep_steps
        self.step_every = step_every
        self.accumulate_grad_batches = int(accumulate_grad_batches)
        self.best_metric = math.inf
        self.main = distributed.is_main_process()  # rank 0 owns the directory
        if self.main:
            for sub in ("steps", "epochs", "best"):
                (self.root / sub).mkdir(parents=True, exist_ok=True)

    # -- save -------------------------------------------------------------------

    def _save(self, path: Path, state, with_params: bool = True) -> None:
        """The full train state, and for epoch and best checkpoints the bare
        parameters beside it (step checkpoints skip that duplicate).  Every
        rank calls; see the module docstring for who writes what."""
        parallel = state.parallel
        mid_window = bool(state.micro_step % self.accumulate_grad_batches)
        if parallel is not None and parallel.active and mid_window:
            parallel.average_gradients(owned_only=False)
        if parallel is not None and parallel.fsdp:
            if self.main:
                if path.exists():
                    shutil.rmtree(path)
                (path / SHARD_DIR).mkdir(parents=True)
            distributed.barrier()
            save_sharded(path / SHARD_DIR, state, with_accum=mid_window)
            distributed.barrier()
        else:
            distributed.barrier()
            if self.main:
                if path.exists():
                    shutil.rmtree(path)
                path.mkdir(parents=True)
                write_file(path / STATE_FILE, state_dict(state, self.accumulate_grad_batches))
                if with_params:
                    save_params(path / PARAMS_FILE, state.model)
        if parallel is not None and parallel.active and mid_window:
            parallel.spread_gradients()  # the window goes on

    def maybe_save_step(self, step: int, state) -> bool:
        if step % self.step_every != 0 or step == 0:
            return False
        self._save(self.root / "steps" / f"{step:08d}", state, with_params=False)
        if self.main:
            self._write_pointer("last", self.root / "steps" / f"{step:08d}")
            kept = sorted((self.root / "steps").iterdir())
            for old in kept[: max(0, len(kept) - self.keep_steps)]:
                shutil.rmtree(old)
        return True

    def save_epoch(self, epoch: int, state) -> None:
        self._save(self.root / "epochs" / f"{epoch:04d}", state)
        if self.main:
            self._write_pointer("last", self.root / "epochs" / f"{epoch:04d}")

    def maybe_save_best(self, metric: float, state) -> bool:
        if metric >= self.best_metric:
            return False
        self.best_metric = metric
        self._save(self.root / "best" / "best", state)
        if self.main:
            (self.root / "best" / "metric.json").write_text(
                json.dumps({"val_loss": float(metric)}))
        return True

    def _write_pointer(self, name: str, target: Path) -> None:
        (self.root / f"{name}.json").write_text(json.dumps({"path": str(target.resolve())}))

    # -- restore ----------------------------------------------------------------

    def latest_path(self) -> Path | None:
        return _follow_pointer(self.root)

    def restore(self, state, path: str | Path | None = None):
        """Full restore into ``state`` (in place; returned).

        Accepts a checkpoint directory, its ``state.pt``, or a checkpoints
        root (resolved through its ``last.json`` pointer).  Loads onto the
        model's device.
        """
        path = Path(path) if path else self.latest_path()
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        path = _follow_pointer(path) or path
        if path.is_dir() and is_sharded(path):
            load_state_dict(state, read_sharded(path / SHARD_DIR))
            return state
        if path.is_dir():
            path = path / STATE_FILE
        load_state_dict(state, _read(path, _STATE_FORMAT))
        return state


def _follow_pointer(path: Path) -> Path | None:
    """The checkpoint a root's ``last.json`` points at (None without one, or
    when it points at nothing)."""
    ptr = Path(path) / "last.json"
    if not ptr.is_file():
        return None
    target = Path(json.loads(ptr.read_text())["path"])
    return target if target.exists() else None


def save_params(path: str | Path, model: nn.Module) -> None:
    """The model's parameters alone, as a ``params.pt`` file at ``path``."""
    write_file(Path(path), {"format": _PARAMS_FORMAT, "params": _params(model)})


def load_params(path: str | Path, model: nn.Module) -> nn.Module:
    """Weights-only load into ``model`` (in place; returned), with the
    resolution-transfer surgery.

    ``path``: a params file, a state file, a checkpoint directory (its
    ``params.pt``, else the parameters of its ``state.pt``, or of every
    rank's shard of a sharded checkpoint) or a checkpoints root (through
    ``last.json``).  A GlobalBias ``U``/``V`` factor whose last
    dimension differs from the model's is linearly re-interpolated
    (align-corners), by the same float32 numpy product as the JAX package, so
    both give the same bits.  Names and the other shapes are checked
    strictly before any parameter changes.
    """
    path = Path(path)
    path = _follow_pointer(path) or path
    if path.is_dir() and is_sharded(path):
        obj = read_sharded(path / SHARD_DIR)
    else:
        if path.is_dir():
            path = path / PARAMS_FILE if (path / PARAMS_FILE).exists() else path / STATE_FILE
        obj = _read(path, _PARAMS_FORMAT, _STATE_FORMAT)
    target = dict(model.named_parameters())
    loaded = {}
    for name, value in obj["params"].items():
        t = target.get(name)
        if (t is not None and name.rsplit(".", 1)[-1] in ("U", "V")
                and value.shape != t.shape and value.shape[:-1] == t.shape[:-1]):
            mat = linear_interp_matrix(value.shape[-1], t.shape[-1])
            arr = value.numpy()
            value = torch.from_numpy(np.einsum("on,...n->...o", mat, arr).astype(arr.dtype))
        loaded[name] = value
    _check_params(loaded, model)
    with torch.no_grad():
        for name, p in target.items():
            p.copy_(loaded[name])
    return model
