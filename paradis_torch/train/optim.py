"""Optimizers and learning-rate schedules: NorMuon / Muon + AdamW, WSD,
OneCycle and ReduceLROnPlateau.

Port of ``paradis_tpu/train/optim.py``.  ``build_optimizer`` assembles what
the config names:

* ``adamw``: ``torch.optim.AdamW`` on every parameter, which computes what
  optax's ``scale_by_adam`` + ``add_decayed_weights`` + ``scale(-lr)`` does
  (eps outside the square root, bias-corrected moments, decoupled decay).
* ``muon`` / ``normuon``: parameters whose flax leaf is ``kernel`` or
  ``projection`` with rank ≥ 2 (``muon_labels``, read off the weight
  bridge's names) take Nesterov momentum → quintic Newton–Schulz on the
  ``[out, fan_in]`` flattening → the aspect rescale ``sqrt(max(1,
  out/fan_in))`` → (NorMuon) a per-output-neuron second-moment EMA with a
  norm-preserving rescale per matrix → decoupled weight decay.  The rest
  takes AdamW.  Matrices of one shape (the 8 physics layers' copies of each
  weight) are stacked into one batched Newton–Schulz call; each stays its
  own matrix, as the JAX package's stacked per-layer leaves do.  Over
  several replicated ranks each rank orthogonalizes its share of a stack
  and one ``all_reduce`` rebuilds it (distributed NorMuon,
  ``sphere.partition.RankGrid.ns_share``, the counterpart of
  ``constrain_ns_batch``).
* ``training.gradient_clip_val``: a global-norm clip before either.

The learning rate is a plain attribute that the host sets each step
(``set_learning_rate``), the one mechanism behind the WSD and OneCycle
schedules and the plateau controller.

``state_dict()`` / ``load_state_dict()`` carry what optax's state carries:
AdamW's state dict, each Muon group's momentum and ν stacks keyed by its
parameters' names (so an optimizer built afresh over a model built afresh
restores each row into its own parameter's slot), and the host-set ``lr``.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from paradis_torch.model.weights import flax_leaf
from paradis_torch.utils.tracing import span

log = logging.getLogger("paradis_torch")

# Quintic Newton–Schulz coefficients (Jordan et al., Muon)
_NS_COEFFS = (3.4445, -4.7750, 2.0315)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_EPS = 1e-8  # AdamW's and NorMuon's epsilon, fixed as in the JAX package


def newton_schulz_batched(x: torch.Tensor, steps: int = 5, eps: float = 1e-7,
                          side: str = "left", dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Quintic Newton–Schulz iteration over a stack of matrices ``[n, r, c]``.

    ``side="left"`` forms the gram on the rows (for r ≤ c), ``"right"`` on the
    columns (r > c), which is ``NS(Xᵀ)ᵀ`` without a transpose.  Iterates in
    ``dtype`` (bfloat16 by default, float32 for exact orthogonalization) after
    dividing each matrix by its float32 Frobenius norm.
    """
    a, b, c = _NS_COEFFS
    norm = torch.linalg.vector_norm(x.float().reshape(x.shape[0], -1), dim=1)
    y = x.to(dtype) / (norm + eps).to(dtype)[:, None, None]
    for _ in range(steps):
        if side == "left":
            gram = y @ y.transpose(1, 2)
            y = a * y + (b * gram + c * (gram @ gram)) @ y
        else:
            gram = y.transpose(1, 2) @ y
            y = a * y + y @ (b * gram + c * (gram @ gram))
    return y.to(x.dtype)


def muon_labels(model: nn.Module) -> dict[str, str]:
    """``{parameter name: "muon" | "adamw"}``: muon exactly where the flax leaf
    is ``kernel`` or ``projection`` with rank ≥ 2, as ``muon_label_fn``."""
    return {name: ("muon" if flax_leaf(name, p.ndim) in ("kernel", "projection")
                   and p.ndim >= 2 else "adamw")
            for name, p in model.named_parameters()}


def grad_norm(params, sum_across: Callable[[torch.Tensor], torch.Tensor] | None = None
              ) -> torch.Tensor:
    """Global L2 norm of the parameters' gradients (a 0-d tensor, no host sync).

    With ``sum_across`` the parameters are one rank's shard: the squared
    norm is summed over the ranks (in place) before the square root."""
    grads = [p.grad for p in params if p.grad is not None]
    if sum_across is None:
        if not grads:
            return torch.zeros(())
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    sq = (torch.stack(torch._foreach_norm(grads)).square().sum() if grads
          else torch.zeros((), device=params[0].device if params else None))
    return sum_across(sq.float()).sqrt()


class _MuonGroup:
    """Parameters of one ``[out, fan_in]`` shape and their stacked state."""

    def __init__(self, names: list[str], params: list[nn.Parameter], normuon: bool):
        self.names = names
        self.params = params
        self.out = params[0].shape[0]
        self.fan = params[0].numel() // self.out
        n, dev = len(params), params[0].device
        self.momentum = torch.zeros((n, self.out, self.fan), device=dev)
        self.nu = torch.zeros((n, self.out), device=dev) if normuon else None
        self.share = (1, 0, True, [])  # sphere.partition.RankGrid.ns_share of the stack


class ParadisOptimizer:
    """The configured optimizer over a model's parameters (see module docstring).

    ``step()`` applies one update from the parameters' ``.grad`` (clipping
    them in place first when ``clip`` is set); ``zero_grad()`` clears them.
    """

    def __init__(self, model: nn.Module, *, name: str, lr: float, weight_decay: float,
                 betas: tuple[float, float], ns_steps: int = 5,
                 ns_dtype: torch.dtype = torch.bfloat16, clip: float | None = None,
                 names: set[str] | None = None,
                 sum_across: Callable[[torch.Tensor], torch.Tensor] | None = None,
                 grid=None):
        if name not in ("adamw", "muon", "normuon"):
            raise ValueError(f"Optimizer {name} not supported: adamw|muon|normuon")
        self.name, self.lr, self.weight_decay, self.betas = name, float(lr), weight_decay, betas
        self.ns_steps, self.ns_dtype, self.clip = ns_steps, ns_dtype, clip
        # a shard of the model (``names``: the parameters this rank owns) and
        # how its squared gradient sum adds up over the ranks' shards
        self.sum_across = sum_across
        selected = [(n, p) for n, p in model.named_parameters()
                    if p.requires_grad and (names is None or n in names)]
        self.params = [p for _, p in selected]
        labels = muon_labels(model) if name != "adamw" else {}
        by_shape: dict[tuple, list] = {}
        adam, self.adamw_names = [], []
        for pname, p in selected:
            if labels.get(pname) == "muon":
                by_shape.setdefault((p.shape[0], p.numel() // p.shape[0]), []).append((pname, p))
            else:
                adam.append(p)
                self.adamw_names.append(pname)
        self.muon_groups = [_MuonGroup([n for n, _ in group], [p for _, p in group],
                                       name == "normuon") for group in by_shape.values()]
        # distributed NorMuon: each group's stack over the ranks of ``grid``
        # (a sphere.partition.RankGrid, every rank holding every parameter)
        self.grid = grid
        if grid is not None:
            world = grid.data * grid.spatial
            for group in self.muon_groups:
                n = len(group.params)
                group.share = grid.ns_share(n)
                ways, _, _, axes = group.share
                if ways < world and n > 1:
                    log.info("NS stack of %d matrices shards %d-way over %s (%d ranks; the "
                             "other axes do not divide the stack)", n, ways, axes, world)
        self.adamw = (torch.optim.AdamW(adam, lr=self.lr, betas=betas, eps=_EPS,
                                        weight_decay=weight_decay) if adam else None)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        """The optimizer's state as plain dicts, lists, tensors and numbers
        (references to the live tensors, as ``torch.optim`` returns them)."""
        return {"name": self.name, "lr": self.lr,
                "adamw": None if self.adamw is None else self.adamw.state_dict(),
                "adamw_names": list(self.adamw_names),
                "muon": [{"names": list(g.names), "momentum": g.momentum, "nu": g.nu}
                         for g in self.muon_groups]}

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()``'s output.  Every name, group and shape is
        checked before anything is copied: a mismatch raises ``ValueError``
        and leaves the optimizer as it was."""
        plan = self._check_state(state)
        if self.adamw is not None:  # torch checks the groups before it sets any state
            self.adamw.load_state_dict(state["adamw"])
        with torch.no_grad():
            for group, (momentum, nu) in zip(self.muon_groups, plan):
                group.momentum.copy_(momentum)
                if group.nu is not None:
                    group.nu.copy_(nu)
        self.lr = float(state["lr"])

    def _check_state(self, state: dict) -> list:
        """Each Muon group's saved stacks, rows in this group's order."""
        if not isinstance(state, dict) or state.get("name") != self.name:
            got = state.get("name") if isinstance(state, dict) else type(state).__name__
            raise ValueError(f"optimizer state of {got!r} does not fit the {self.name!r} optimizer")
        if list(state["adamw_names"]) != self.adamw_names:
            raise ValueError(f"AdamW parameters differ: saved {list(state['adamw_names'])}, "
                             f"optimizer {self.adamw_names}")
        if self.adamw is not None:
            adam = self.adamw.param_groups[0]["params"]
            for i, entry in state["adamw"]["state"].items():
                for key in ("exp_avg", "exp_avg_sq"):
                    if tuple(entry[key].shape) != tuple(adam[i].shape):
                        raise ValueError(f"shape mismatch at AdamW {key} of "
                                         f"{self.adamw_names[i]}: {tuple(entry[key].shape)} "
                                         f"vs expected {tuple(adam[i].shape)}")
        saved = {frozenset(g["names"]): g for g in state["muon"]}
        if set(saved) != {frozenset(g.names) for g in self.muon_groups}:
            raise ValueError("Muon groups differ: saved "
                             f"{sorted(sorted(k) for k in saved)}, optimizer "
                             f"{sorted(sorted(g.names) for g in self.muon_groups)}")
        plan = []
        for group in self.muon_groups:
            entry = saved[frozenset(group.names)]
            rows = [list(entry["names"]).index(n) for n in group.names]
            momentum, nu = entry["momentum"], entry["nu"]
            if tuple(momentum.shape) != tuple(group.momentum.shape):
                raise ValueError(f"shape mismatch at the Muon momentum of {group.names}: "
                                 f"{tuple(momentum.shape)} vs expected "
                                 f"{tuple(group.momentum.shape)}")
            if (nu is None) != (group.nu is None) or (
                    nu is not None and tuple(nu.shape) != tuple(group.nu.shape)):
                raise ValueError(f"the NorMuon second moment of {group.names} does not fit")
            plan.append((momentum[rows], None if nu is None else nu[rows]))
        return plan

    def grad_norm(self) -> torch.Tensor:
        """The global norm of the gradients of every rank's parameters."""
        with span("grad_norm"):
            return grad_norm(self.params, self.sum_across)

    def param_states(self) -> dict:
        """The optimizer's state by parameter name, whatever the grouping:
        ``{"name", "lr", "params": {name: {"exp_avg", "exp_avg_sq", "step"}
        (AdamW) or {"momentum" [out, fan_in], "nu" [out] or None} (Muon)}}``.
        The layout of sharded checkpoints, which any split of the
        parameters over ranks restores (``load_param_states``)."""
        out = {}
        if self.adamw is not None:
            for pname, p in zip(self.adamw_names, self.adamw.param_groups[0]["params"]):
                if p in self.adamw.state:
                    out[pname] = dict(self.adamw.state[p])
        for g in self.muon_groups:
            for i, pname in enumerate(g.names):
                out[pname] = {"momentum": g.momentum[i],
                              "nu": None if g.nu is None else g.nu[i]}
        return {"name": self.name, "lr": self.lr, "params": out}

    def load_param_states(self, state: dict) -> None:
        """Restore ``param_states()`` output (of any rank's shard, merged):
        each of this optimizer's parameters takes its own entry.  Checked
        before anything is copied."""
        if state.get("name") != self.name:
            raise ValueError(f"optimizer state of {state.get('name')!r} does not fit the "
                             f"{self.name!r} optimizer")
        entries = state["params"]
        muon = {n: g for g in self.muon_groups for n in g.names}
        missing = sorted(n for n in muon if n not in entries)
        if missing:
            raise ValueError(f"the optimizer state has no entry for {missing}")
        for g in self.muon_groups:
            for i, n in enumerate(g.names):
                e = entries[n]
                if (tuple(e["momentum"].shape) != tuple(g.momentum[i].shape)
                        or (e["nu"] is None) != (g.nu is None)):
                    raise ValueError(f"the Muon state of {n} does not fit")
        sd = None
        if self.adamw is not None:
            sd = self.adamw.state_dict()
            params = self.adamw.param_groups[0]["params"]
            sd["state"] = {}
            for i, (n, p) in enumerate(zip(self.adamw_names, params)):
                if n in entries:
                    e = entries[n]
                    if tuple(e["exp_avg"].shape) != tuple(p.shape):
                        raise ValueError(f"shape mismatch at AdamW exp_avg of {n}")
                    sd["state"][i] = dict(e)
        if sd is not None:
            self.adamw.load_state_dict(sd)
        with torch.no_grad():
            for g in self.muon_groups:
                for i, n in enumerate(g.names):
                    g.momentum[i].copy_(entries[n]["momentum"])
                    if g.nu is not None:
                        g.nu[i].copy_(entries[n]["nu"])
        self.lr = float(state["lr"])

    @torch.no_grad()
    def step(self) -> None:
        if self.clip is not None:
            with span("clip"):
                grads = [p.grad for p in self.params if p.grad is not None]
                norm = self.grad_norm()
                # optax.clip_by_global_norm: g / ‖g‖ · clip where ‖g‖ ≥ clip
                scale = torch.where(norm < self.clip, 1.0, self.clip / norm)
                torch._foreach_mul_(grads, scale)
        if self.adamw is not None:
            with span("adamw"):
                for group in self.adamw.param_groups:
                    group["lr"] = self.lr
                self.adamw.step()
        if self.muon_groups:
            with span("normuon"):
                for group in self.muon_groups:
                    self._muon_step(group)

    def _muon_step(self, group: _MuonGroup) -> None:
        b1, b2 = self.betas
        grads = torch.stack([p.grad.reshape(group.out, group.fan) for p in group.params])
        group.momentum.mul_(b1).add_(grads)
        eff = grads + b1 * group.momentum                        # Nesterov
        # gram on the short side, as the JAX package orients [fan_in, out]
        side = "left" if group.out < group.fan else "right"
        o = self._orthogonalize(group, eff, side)
        o = o * math.sqrt(max(1.0, group.out / group.fan))
        if group.nu is not None:                                 # NorMuon
            ms = o.float().square().mean(dim=2)
            group.nu.mul_(b2).add_((1.0 - b2) * ms)
            o_hat = o / (group.nu.sqrt()[:, :, None] + _EPS)
            # preserve the norm of the orthogonalized update per matrix
            on = o.square().sum(dim=(1, 2), keepdim=True).sqrt()
            ohn = o_hat.square().sum(dim=(1, 2), keepdim=True).sqrt()
            o = o_hat * (on / (ohn + _EPS))
        upd = [u.view_as(p) for u, p in zip(o.unbind(0), group.params)]
        upd = torch._foreach_add(upd, group.params, alpha=self.weight_decay)
        torch._foreach_add_(group.params, upd, alpha=-self.lr)


    def _orthogonalize(self, group: _MuonGroup, eff: torch.Tensor, side: str) -> torch.Tensor:
        """Newton–Schulz over the stack ``eff``; with a grid, this rank's
        share of it, the shares rebuilt on every rank by one ``all_reduce``
        of the stack (each share added by its lead copy, zeros elsewhere:
        the sum is exact)."""
        if self.grid is None or group.share[0] == 1:
            return newton_schulz_batched(eff, self.ns_steps, side=side, dtype=self.ns_dtype)
        ways, index, lead, _ = group.share
        n = eff.shape[0]
        lo, hi = index * n // ways, (index + 1) * n // ways
        mine = newton_schulz_batched(eff[lo:hi], self.ns_steps, side=side, dtype=self.ns_dtype)
        whole = torch.zeros_like(eff, dtype=mine.dtype)
        if lead:
            whole[lo:hi] = mine
        torch.distributed.all_reduce(whole)
        return whole


def param_states_of(state: dict) -> dict:
    """``ParadisOptimizer.state_dict()`` output in ``param_states()``'s
    layout (by parameter name), so another split of the parameters over
    ranks can restore it."""
    out = {}
    if state["adamw"] is not None:
        for i, pname in enumerate(state["adamw_names"]):
            if i in state["adamw"]["state"]:
                out[pname] = dict(state["adamw"]["state"][i])
    for g in state["muon"]:
        for i, pname in enumerate(g["names"]):
            out[pname] = {"momentum": g["momentum"][i],
                          "nu": None if g["nu"] is None else g["nu"][i]}
    return {"name": state["name"], "lr": state["lr"], "params": out}


def build_optimizer(cfg, model: nn.Module, parallel=None) -> ParadisOptimizer:
    """The optimizer ``training.optimizer`` names, at the configured learning
    rate (driven per step by the host through ``set_learning_rate``).

    ``parallel`` (a sharded ``distributed.DataParallel``) restricts it to the
    parameters this rank owns, their gradient norm summed over its data
    group (over spatial axes the owners at each position update their
    parameters alike, on whole Newton–Schulz stacks); a replicated one over
    several ranks splits each Newton–Schulz stack over its grid
    (distributed NorMuon)."""
    ocfg = cfg.training.optimizer
    clip = cfg.training.get("gradient_clip_val", None)
    ns_dtype = str(ocfg.get("ns_dtype", "bfloat16"))
    if ns_dtype not in _DTYPES:
        raise ValueError(f"training.optimizer.ns_dtype must be one of {list(_DTYPES)}, "
                         f"got {ns_dtype!r}")
    return ParadisOptimizer(model, name=ocfg.name, lr=float(ocfg.lr),
                            weight_decay=float(ocfg.weight_decay),
                            betas=(float(ocfg.beta1), float(ocfg.beta2)),
                            ns_steps=int(ocfg.get("ns_steps", 5)), ns_dtype=_DTYPES[ns_dtype],
                            clip=None if clip is None else float(clip),
                            **({"names": parallel.owned_names(), "sum_across": parallel.sum_}
                               if parallel is not None and parallel.fsdp else
                               {"grid": parallel.grid}
                               if parallel is not None and parallel.active else {}))


def set_learning_rate(optimizer: ParadisOptimizer, lr: float) -> None:
    optimizer.lr = float(lr)


def get_learning_rate(optimizer: ParadisOptimizer) -> float:
    return optimizer.lr


# -- learning-rate schedules (host side) -------------------------------------

def wsd_schedule(base_lr: float, total_steps: int, warmup, decay) -> Callable[[int], float]:
    """Warmup-stable-decay; ``warmup``/``decay`` < 1 are fractions of the run."""
    warmup_steps = warmup if warmup >= 1 else warmup * total_steps
    decay_steps = decay if decay >= 1 else decay * total_steps
    if warmup_steps < 0 or decay_steps < 0:
        raise ValueError("WSD warmup/decay must be non-negative")
    if warmup_steps + decay_steps > total_steps:
        raise ValueError(
            f"WSD schedule needs warmup ({warmup_steps}) + decay ({decay_steps}) <= total "
            f"steps ({total_steps}); shorten them (training.scheduler.wsd.warmup/decay) "
            f"or raise training.max_steps")
    steady = total_steps - (warmup_steps + decay_steps)

    def fn(step: int) -> float:
        if step < warmup_steps:
            return base_lr * (step + 1) / warmup_steps
        if step <= warmup_steps + steady:
            return base_lr
        return base_lr * (total_steps - step) / decay_steps

    return fn


def one_cycle_schedule(base_lr: float, total_steps: int, pct_start: float,
                       div_factor: float, final_div: float) -> Callable[[int], float]:
    """Cosine OneCycle (torch ``OneCycleLR`` semantics)."""
    initial = base_lr / div_factor
    final = initial / final_div
    up_steps = max(1, int(pct_start * total_steps))

    def fn(step: int) -> float:
        if step < up_steps and pct_start > 0:
            t = step / up_steps
            return initial + (base_lr - initial) * 0.5 * (1 - math.cos(math.pi * t))
        denom = max(1, total_steps - up_steps)
        t = min(1.0, (step - up_steps) / denom)
        return final + (base_lr - final) * 0.5 * (1 + math.cos(math.pi * t))

    return fn


@dataclass
class PlateauController:
    """ReduceLROnPlateau, host-side state."""

    base_lr: float
    factor: float = 0.75
    patience: int = 3
    threshold: float = 1e-4
    threshold_mode: str = "rel"
    min_lr: float = 1e-7
    best: float = math.inf
    bad_epochs: int = 0
    lr: float = 0.0

    def __post_init__(self):
        self.lr = self.base_lr

    def update(self, metric: float) -> float:
        if self.threshold_mode == "rel":
            improved = metric < self.best * (1.0 - self.threshold)
        else:
            improved = metric < self.best - self.threshold
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.min_lr, self.lr * self.factor)
                self.bad_epochs = 0
        return self.lr


def build_schedule(cfg, total_steps: int) -> tuple[Callable[[int], float], PlateauController | None]:
    """The one enabled scheduler: ``(lr_at(step), plateau controller or None)``."""
    s = cfg.training.scheduler
    enabled = sum([bool(s.one_cycle.enabled), bool(s.reduce_lr.enabled), bool(s.wsd.enabled)])
    if enabled != 1:
        raise ValueError(f"Invalid config: exactly one scheduler must be enabled, found {enabled}.")
    base_lr = float(cfg.training.optimizer.lr)
    if s.wsd.enabled:
        return wsd_schedule(base_lr, total_steps, s.wsd.warmup, s.wsd.decay), None
    if s.one_cycle.enabled:
        return (one_cycle_schedule(base_lr, total_steps, s.one_cycle.warmup_pct_start,
                                   s.one_cycle.lr_div_factor, s.one_cycle.lr_final_div), None)
    ctrl = PlateauController(base_lr=base_lr, factor=float(s.reduce_lr.factor),
                             patience=int(s.reduce_lr.patience),
                             threshold=float(s.reduce_lr.threshold),
                             threshold_mode=str(s.reduce_lr.threshold_mode),
                             min_lr=float(s.reduce_lr.min_lr))
    return (lambda step: ctrl.lr), ctrl
