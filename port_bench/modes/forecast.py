"""Forecasting: ``paradis_torch.forecast.rollout.make_forecast_rollout``'s
rollout of ``steps`` six-hour steps, back to back over a seeded pool of
initial conditions, ``batch`` at a time.

Set-up builds the model and the rollout and warms them on a two-step
rollout of the first batch.  In the window a forward hook on the model
records a CUDA event after each model step; rollouts begin while less
than ``--seconds`` less half a rollout have passed, and the window ends at
a synchronize after the last.  The output
of one rollout drawn from the seed (the first or the second) is kept for
the check, and of it one batch member drawn from the seed in each of
``checked_members`` equal strata of the batch.
"""

from __future__ import annotations

import random
import statistics
import time

import torch

from port_bench import draw
from port_bench.modes.common import Context, model_flops


class Mode:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        rng = random.Random(ctx.seed)
        self.kept_rollout = rng.randrange(2)
        # one member from each of n equal strata of the batch, so that every
        # part of the batch is checked in every run
        n = int(ctx.traffic.get("checked_members", ctx.batch))
        width = ctx.batch // n
        self.members = [i * width + rng.randrange(width) for i in range(n)]
        self.kept = None
        self.finite: list = []

    def pool(self) -> dict:
        c, d = self.ctx, self.ctx.dims
        H, W = c.grid
        n, T = int(c.traffic["pool"]), int(c.traffic["steps"])
        if n % c.batch:
            raise SystemExit("port_bench: the pool must hold whole batches")
        return draw.normal({"input": (n, H, W, d["n_dyn"]),
                            "forcings": (n, T, H, W, d["n_forcings"] * d["n_time"]),
                            "constants": (1, H, W, d["n_const"])}, c.seed, c.device)

    def batch(self, k: int) -> dict:
        B = self.ctx.batch
        lo = (k * B) % self.data["input"].shape[0]
        return {"input": self.data["input"][lo:lo + B],
                "forcings": self.data["forcings"][lo:lo + B],
                "constants": self.data["constants"]}

    def setup(self) -> None:
        from paradis_torch.forecast.rollout import make_forecast_rollout

        c = self.ctx
        model = c.build_program()
        self.shapes = c.parameter_shapes()
        self.rollout = make_forecast_rollout(model, c.cfg)
        self.data = self.pool()
        c.phase("inputs_drawn")
        warm = self.batch(0)
        warm = dict(warm, forcings=warm["forcings"][:, :2])
        self.rollout(warm, c.dims["n_common"])
        c.phase("warmed")
        self.k = 0

    def run_rollout(self) -> None:
        out = self.rollout(self.batch(self.k), self.ctx.dims["n_common"])
        self.finite.append(torch.isfinite(out).all())
        if self.k == self.kept_rollout:
            self.kept = out
        self.k += 1

    def window(self, seconds: float) -> dict:
        cuda = self.ctx.device.type == "cuda"
        events = []
        hook = None
        if cuda:
            def record(module, args, output):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)

            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            hook = self.ctx.model.register_forward_hook(record)
        t0 = time.perf_counter()
        rollouts, last, began = 0, 0.0, t0
        try:
            # a rollout begins while the window, less half the last rollout's
            # span, has time left: the window ends within half a rollout of
            # ``seconds``
            while time.perf_counter() - t0 < seconds - last / 2 or self.kept is None:
                now = time.perf_counter()
                if rollouts:
                    last = now - began
                began = now
                self.run_rollout()
                rollouts += 1
        finally:
            if hook is not None:
                hook.remove()
        if cuda:
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        T = int(self.ctx.traffic["steps"])
        steps = rollouts * T * self.ctx.batch
        metrics = {"forecast_steps_per_s": steps / elapsed}
        if cuda:
            marks = [start] + events
            gaps = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
            metrics["forecast_step_p90_ms"] = statistics.quantiles(gaps, n=10)[-1]
        failed = sum(not bool(f) for f in self.finite)
        self.finite = []
        return {"attempted": rollouts, "failed": failed, "window_s": elapsed,
                "steps": rollouts * T, "member_steps_per_s": steps / elapsed, "metrics": metrics}

    def traced(self):
        """One rollout traced."""
        from port_bench import trace

        T = int(self.ctx.traffic["steps"])
        tr = trace.traced(self.run_rollout, T, self.ctx.model)
        self.finite = []
        return tr

    def flops(self) -> float:
        """Model FLOPs of one member's step."""
        return model_flops(self.ctx, 1)

    def release(self) -> None:
        self.rollout = None
        self.ctx.model = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ---------------------------------------------------------

    def reference_rollout(self, compare_to: torch.Tensor) -> dict:
        """The reference's rollout of the kept rollout's sampled members,
        step by step against ``compare_to`` [m, T, H, W, C]: the largest
        absolute gap over the reference's root mean square, overall and by
        step."""
        c, d = self.ctx, self.ctx.dims
        B = c.batch
        lo = (self.kept_rollout * B) % int(c.traffic["pool"])
        data = self.pool()
        idx = torch.tensor([lo + m for m in self.members], device=c.device)
        dyn = data["input"][idx]
        forcings = data["forcings"][idx]
        const = data["constants"].expand(len(self.members), *data["constants"].shape[1:])
        P = draw.parameters(self.shapes, c.seed, c.device)
        ref = c.reference()
        n_c, lag = d["n_common"], d["n_common"] * d["n_time"]
        gaps, ss, count = [], 0.0, 0
        with torch.no_grad():
            for t in range(forcings.shape[1]):
                out = ref(P, torch.cat([dyn, forcings[:, t], const], dim=-1))
                gaps.append(float((compare_to[:, t].float() - out).abs().max()))
                ss += float(out.double().square().sum())
                count += out.numel()
                dyn = torch.cat([dyn[..., n_c:lag], out[..., :n_c]], dim=-1)
        rms = (ss / count) ** 0.5
        return {"rollout_gap": max(gaps) / rms, "by_step": [g / rms for g in gaps]}

    def check(self, variant: str = "program") -> dict:
        return self.reference_rollout(self.kept[self.members])
