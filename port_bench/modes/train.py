"""Training: ``paradis_torch.train.step.make_train_step``'s step, back to
back on a seeded pool of batches at a constant learning rate.

Set-up builds the one train state, takes the first three steps on the
pool's first three batches (they warm every kernel and shape, and are the
steps the reference follows), reads the first gradient from the
optimizer's state after step 1 and keeps a copy of the parameters after
step 3.  The window runs steps with no per-step synchronisation until
``--seconds`` have passed and ends at a synchronize.
"""

from __future__ import annotations

import time

import torch

from port_bench import draw
from port_bench.modes.common import Context, fp8, model_flops, sync
from port_bench.reference.loss import reversed_huber_loss, weights
from port_bench.reference.optim import Optimizer

FOLLOWED = 3   # steps the reference follows
TRACED = 3     # steps in the traced window


class Mode:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.losses: list = []
        self.snapshot = None
        self.first_grad = None

    # -- the program ---------------------------------------------------------

    def pool(self) -> list:
        """The seeded batches: ``input``, ``target``, ``forcings`` of one
        rollout step each, and the grid's ``constants``."""
        c, d = self.ctx, self.ctx.dims
        H, W = c.grid
        B, S, n = c.batch, int(c.config["model"]["forecast_steps"]), int(c.traffic["pool"])
        shapes = {"constants": (1, H, W, d["n_const"])}
        for i in range(n):
            shapes.update({f"input{i}": (B, H, W, d["n_dyn"]),
                           f"target{i}": (B, S, H, W, d["output_dim"]),
                           f"forcings{i}": (B, S, H, W, d["n_forcings"] * d["n_time"])})
        t = draw.normal(shapes, c.seed, c.device)
        return [{"input": t[f"input{i}"], "target": t[f"target{i}"],
                 "forcings": t[f"forcings{i}"], "constants": t["constants"]} for i in range(n)]

    def setup(self) -> None:
        from paradis_torch.data.features import dyn_output_features
        from paradis_torch.train import (WeightedLoss, build_optimizer, create_train_state,
                                         make_train_step)

        c = self.ctx
        model = c.build_program()
        lat, _ = c.lat_lon_deg()
        self.loss_fn = WeightedLoss.from_config(c.cfg, lat, dyn_output_features(c.cfg.features),
                                                device=c.device)
        self.optimizer = build_optimizer(c.cfg, model)
        self.state = create_train_state(model, self.optimizer)
        self.step_fn = make_train_step(model, self.loss_fn, c.cfg, self.optimizer)
        self.batches = self.pool()
        c.phase("inputs_drawn")
        self.shapes = c.parameter_shapes()
        self.n = 0
        for _ in range(FOLLOWED):
            self.step()
            if self.n == 1:
                self.first_grad = self.program_first_grad()
        c.phase("followed_steps")
        self.snapshot = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
        self.followed_losses = torch.stack(self.losses).float().cpu()
        self.losses = []

    def step(self) -> None:
        batch = self.batches[self.n % len(self.batches)]
        metrics = self.step_fn(self.state, batch, self.ctx.dims["n_common"])
        self.losses.append(metrics["loss"].detach())
        self.n += 1

    def program_first_grad(self) -> dict:
        """Each parameter's first gradient norm from the optimizer's state
        after one step: a NorMuon momentum is the gradient; an AdamW first
        moment is (1 - beta1) times it."""
        b1 = self.optimizer.betas[0]
        states = self.optimizer.param_states()["params"]
        out = {}
        for name in self.shapes:    # a parameter the optimizer holds no state of got none
            st = states.get(name, {})
            out[name] = (float(st["momentum"].norm()) if "momentum" in st
                         else float(st["exp_avg"].norm()) / (1 - b1) if "exp_avg" in st
                         else 0.0)
        return out

    def window(self, seconds: float) -> dict:
        sync(self.ctx.device)
        t0 = time.perf_counter()
        steps = 0
        while time.perf_counter() - t0 < seconds:
            self.step()
            steps += 1
        sync(self.ctx.device)
        elapsed = time.perf_counter() - t0
        losses = torch.stack(self.losses)
        failed = int((~torch.isfinite(losses)).sum())
        self.losses = []
        return {"attempted": steps, "failed": failed, "window_s": elapsed, "steps": steps,
                "member_steps_per_s": steps * self.ctx.batch / elapsed,
                "metrics": {"train_samples_per_s": steps * self.ctx.batch / elapsed}}

    def traced(self):
        from port_bench import trace

        def run():
            for _ in range(TRACED):
                self.step()

        tr = trace.traced(run, TRACED, self.ctx.model, self.optimizer, self.loss_fn)
        self.losses = []
        return tr

    def flops(self) -> float:
        """Model FLOPs of a sample's step: forward, and the backward's two
        products a forward product, with no replay and no Newton–Schulz."""
        return 3.0 * model_flops(self.ctx, 1)

    def release(self) -> None:
        for name in ("state", "step_fn", "optimizer", "loss_fn", "batches"):
            setattr(self, name, None)
        self.ctx.model = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ---------------------------------------------------------

    def reference_steps(self, rnd=None) -> dict:
        """The reference's first ``FOLLOWED`` steps from the seed's weights on
        the pool's first batches: each step's loss, the first gradient's
        norm by parameter and the parameters' change after the last step,
        in micro-batches of ``reference_micro`` rows."""
        c = self.ctx
        shapes = self.shapes
        P0 = draw.parameters(shapes, c.seed, c.device)
        P = {n: t.clone().requires_grad_(True) for n, t in P0.items()}
        batches = self.pool()[:FOLLOWED]
        cw, rw = weights(c.config["training"], c.config["features"], c.grid[0])
        cw = torch.tensor(cw, dtype=torch.float32, device=c.device)
        rw = torch.tensor(rw, dtype=torch.float32, device=c.device)
        ref = c.reference(rnd=rnd, checkpoint_layers=True)
        opt = Optimizer(c.config["training"]["optimizer"])
        micro = int(c.traffic.get("reference_micro", c.batch))
        losses, first = [], None
        for batch in batches:
            x = torch.cat([batch["input"], batch["forcings"][:, 0],
                           batch["constants"].expand(c.batch, *batch["constants"].shape[1:])],
                          dim=-1)
            total = 0.0
            for lo in range(0, c.batch, micro):
                out = ref(P, x[lo:lo + micro])
                loss = reversed_huber_loss(out, batch["target"][lo:lo + micro, 0], cw, rw,
                                           float(c.config["training"]["loss_function"]
                                                 ["delta_loss"]))
                (loss * (out.shape[0] / c.batch)).backward()
                total += float(loss.detach()) * out.shape[0] / c.batch
            losses.append(total)
            grads = {n: p.grad for n, p in P.items()}
            if first is None:
                first = {n: float(g.norm()) for n, g in grads.items()}
            opt.step(P, grads)
            for p in P.values():
                p.grad = None
        change = {n: float((P[n].detach() - P0[n]).norm()) for n in P}
        return {"losses": losses, "first_grad": first, "change": change, "P0": P0}

    def program_readings(self, P0: dict) -> dict:
        return {"losses": [float(v) for v in self.followed_losses],
                "first_grad": self.first_grad,
                "change": {n: float((t.to(P0[n].device) - P0[n]).norm())
                           for n, t in self.snapshot.items()}}

    def check(self, variant: str = "program") -> dict:
        """The compared numbers: the program's (or, for ``control``, the
        reference's in float8) first steps against the reference's."""
        ref = self.reference_steps()
        if variant == "control":
            got = self.reference_steps(rnd=fp8)
        else:
            got = self.program_readings(ref["P0"])
        return compare(got, ref)


def _gaps(a: dict, b: dict, keep) -> list:
    """Each leaf's gap of norms, against the larger of its reference norm
    and the median leaf's."""
    vals = sorted(b[n] for n in keep)
    median = vals[len(vals) // 2]
    return sorted(abs(a[n] - b[n]) / max(b[n], median) for n in keep)


def compare(got: dict, ref: dict) -> dict:
    """``loss_gap`` (the worst followed step's relative loss gap),
    ``grad_gap`` and ``grad_median_gap`` (the worst and the median leaf's
    first gradient), ``change_gap`` (the worst leaf's change after the
    followed steps, leaving out leaves whose reference gradient is under a
    thousandth of the median leaf's)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    names = sorted(ref["first_grad"])
    g = sorted(ref["first_grad"][n] for n in names)
    floor = 1e-3 * g[len(g) // 2]
    moved = [n for n in names if ref["first_grad"][n] >= floor]
    grad = _gaps(got["first_grad"], ref["first_grad"], names)
    return {"loss_gap": loss_gap, "grad_gap": grad[-1], "grad_median_gap": grad[len(grad) // 2],
            "change_gap": _gaps(got["change"], ref["change"], moved)[-1],
            "left_out": len(names) - len(moved)}
