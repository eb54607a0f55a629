"""The frozen reference against ``paradis_torch``'s plain path on the CPU,
at tiny sizes, with the same seeded weights: the forward, one train step's
loss and updated parameters, and a 3-step rollout."""

from __future__ import annotations

import pytest
import torch

from port_bench import draw
from port_bench.modes.common import Context
from port_bench.reference.loss import reversed_huber_loss, weights
from port_bench.reference.optim import Optimizer
from port_bench.tests.small import small

SEED = 2 ** 31 + 77


def _program(cell: str, **traffic):
    wl = small(cell, precision="float32", **traffic)
    wl["config"]["overrides"].append("training.optimizer.ns_dtype=float32")
    wl["config"]["training"]["optimizer"]["ns_dtype"] = "float32"
    ctx = Context(wl, SEED, "cpu")
    model = ctx.build_program()
    P = draw.parameters(ctx.parameter_shapes(), SEED, "cpu")
    return ctx, model, P


def _fields(ctx, batch):
    H, W = ctx.grid
    return draw.normal({"x": (batch, H, W, ctx.dims["input_dim"])}, SEED, "cpu")["x"]


def test_forward():
    ctx, model, P = _program("forecast-1.40625deg-b1")
    x = _fields(ctx, 2)
    with torch.no_grad():
        got = model(x)
        want = ctx.reference()(P, x)
    assert got.shape == want.shape == (2, *ctx.grid, ctx.dims["output_dim"])
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_train_step():
    from paradis_torch.data.features import dyn_output_features
    from paradis_torch.train import (WeightedLoss, build_optimizer, create_train_state,
                                     make_train_step)

    ctx, model, P = _program("train-1.40625deg-b1", batch=2)
    lat, _ = ctx.lat_lon_deg()
    loss_fn = WeightedLoss.from_config(ctx.cfg, lat, dyn_output_features(ctx.cfg.features),
                                       device="cpu")
    opt = build_optimizer(ctx.cfg, model)
    step = make_train_step(model, loss_fn, ctx.cfg, opt)
    H, W = ctx.grid
    d = ctx.dims
    b = draw.normal({"input": (2, H, W, d["n_dyn"]), "target": (2, 1, H, W, d["output_dim"]),
                     "forcings": (2, 1, H, W, d["n_forcings"] * d["n_time"]),
                     "constants": (1, H, W, d["n_const"])}, SEED, "cpu")
    metrics = step(create_train_state(model, opt), b, d["n_common"])

    cw, rw = weights(ctx.config["training"], ctx.config["features"], H)
    Pr = {n: t.clone().requires_grad_(True) for n, t in P.items()}
    x = torch.cat([b["input"], b["forcings"][:, 0], b["constants"].expand(2, -1, -1, -1)], -1)
    loss = reversed_huber_loss(ctx.reference()(Pr, x), b["target"][:, 0],
                               torch.tensor(cw, dtype=torch.float32),
                               torch.tensor(rw, dtype=torch.float32))
    loss.backward()
    Optimizer(ctx.config["training"]["optimizer"]).step(Pr, {n: p.grad for n, p in Pr.items()})
    assert float(metrics["loss"]) == pytest.approx(float(loss.detach()), rel=1e-5)
    for name, p in model.named_parameters():
        moved = (Pr[name] - P[name]).norm()
        assert (p.detach() - Pr[name]).norm() <= 1e-3 * moved + 1e-7, name


def test_rollout():
    from paradis_torch.forecast.rollout import make_forecast_rollout

    ctx, model, P = _program("forecast-1.40625deg-b1")
    H, W = ctx.grid
    d = ctx.dims
    b = draw.normal({"input": (2, H, W, d["n_dyn"]),
                     "forcings": (2, 3, H, W, d["n_forcings"] * d["n_time"]),
                     "constants": (1, H, W, d["n_const"])}, SEED, "cpu")
    got = make_forecast_rollout(model, ctx.cfg)(b, d["n_common"])
    ref, dyn = ctx.reference(), b["input"]
    lag = d["n_common"] * d["n_time"]
    with torch.no_grad():
        for t in range(3):
            out = ref(P, torch.cat([dyn, b["forcings"][:, t],
                                    b["constants"].expand(2, -1, -1, -1)], -1))
            assert (got[:, t] - out).abs().max() <= 1e-5 * out.abs().max(), t
            dyn = torch.cat([dyn[..., d["n_common"]:lag], out[..., :d["n_common"]]], -1)
