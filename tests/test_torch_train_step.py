"""The training slice end to end: the port's train step against the JAX one.

The TINY pair of ``torch_parity.py`` (the same weights in both packages; the
JAX model on its CPU dense interpolation path, whose VJP has the Pallas
kernel's derivative convention) runs ``make_train_step`` with the weighted
reversed Huber loss and NorMuon (float32 Newton–Schulz, so the comparison is
not swamped by bf16 iterates) over the same seeded numpy batches, in three
configurations: the default, TBPTT with ``detach_gradient_every=1`` over two
forecast steps, ``accumulate_grad_batches=2`` with ``log_additional_stats``
on and a ``gradient_clip_val`` that binds on the toy (the logged gradients
are the raw ones, taken before the clip scales them), and the AMSE spectral
loss in place of the reversed Huber.  Each configuration costs the JAX side
a trace and compile of ~25-40 CPU-seconds, most of this file's time.

Limits: per-step losses and gradient norms within rtol 1e-5 (float32 sums
in another order; measured ≤ 1e-6), but the AMSE case's gradient norm
(``AMSE_GRAD_NORM_RTOL`` below says why).  The parameters after the last step,
as total updates: the Frobenius norm of the difference within 2e-4 of that
of the update (measured ≤ 3.3e-5), and each element within 5e-3 of the
largest update (measured ≤ 9.4e-4: a parameter near 1 carries a float32 ulp
of 1.2e-7 against updates of ~1e-3, and AdamW's sign-like step on a
near-zero gradient can amplify the gradients' float32 differences).  The
logged microstep gradients within 1e-5 of the largest (float32 sums in
another order).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from paradis_tpu.train.loss import WeightedLoss as JaxWeightedLoss  # noqa: E402
from paradis_tpu.train.optim import build_optimizer as jax_build_optimizer  # noqa: E402
from paradis_tpu.train.step import create_train_state as jax_create_train_state  # noqa: E402
from paradis_tpu.train.step import make_eval_step as jax_make_eval_step  # noqa: E402
from paradis_tpu.train.step import make_train_step as jax_make_train_step  # noqa: E402
from paradis_torch.data import dyn_output_features  # noqa: E402
from paradis_torch.model.weights import flax_to_state  # noqa: E402
from paradis_torch.sphere.geometry import equiangular_lat_lon, latitude_weights  # noqa: E402
from paradis_torch.train import (WeightedLoss, build_optimizer, create_train_state,  # noqa: E402
                                 make_eval_step, make_train_step)
from torch_parity import NLAT, NLON, build_pair  # noqa: E402

STEPS = 4
RTOL = 1e-5
# The AMSE amplitude term's gradient in a coefficient p is ~2·sqrt(PSD_t)·
# p/sqrt(|p|² + 1e-7): where a channel's power at some l is near 1e-7 (step
# 2 of this case: channel 79, l = 0, |p| = 2.5e-4, a global mean near zero)
# it dominates the gradient (norm 12.8 against ~2.6 at the other steps), and
# its direction carries the float32 error of p relative to |p| (~1e-4, the
# two packages' FFT and sum order).  Measured 9.7e-5 there and ≤ 6.3e-7 at
# the other steps; the loss itself keeps RTOL.
AMSE_GRAD_NORM_RTOL = 2e-4


def _batches(pair, S, n, seed=1):
    rng = np.random.default_rng(seed)
    shapes = {"input": (1, NLAT, NLON, pair.n_common * pair.n_time),
              "target": (1, S, NLAT, NLON, pair.output_dim),
              "forcings": (1, S, NLAT, NLON, pair.n_forcings * pair.n_time),
              "constants": (1, NLAT, NLON, pair.n_const)}
    return [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
            for _ in range(n)]


def _losses(pair):
    lat, _ = equiangular_lat_lon(NLAT, NLON, include_poles=False)
    names = dyn_output_features(pair.cfg.features)
    return (JaxWeightedLoss.from_config(pair.jax_cfg, lat, names, nlon=NLON),
            WeightedLoss.from_config(pair.cfg, lat, names, nlon=NLON, device="cpu"))


@pytest.mark.parametrize("overrides", [
    [],
    ["model.forecast_steps=2", "training.optimizer.detach_gradient_every=1"],
    ["training.accumulate_grad_batches=2", "training.log_additional_stats=true",
     "training.gradient_clip_val=0.05"],
    ["training.loss_function.type=amse"],
], ids=["default", "tbptt-S2", "accumulate-2-stats", "amse"])
def test_train_steps_match_jax(overrides):
    pair = build_pair("training.optimizer.ns_dtype=float32", *overrides)
    jloss, tloss = _losses(pair)
    jopt = jax_build_optimizer(pair.jax_cfg, pair.params)
    jstep, _ = jax_make_train_step(pair.jax_model, jloss, pair.jax_cfg, jopt, donate=False)
    jstate = jax_create_train_state(pair.params, jopt)
    topt = build_optimizer(pair.cfg, pair.model)
    tstep = make_train_step(pair.model, tloss, pair.cfg, topt)
    tstate = create_train_state(pair.model, topt)
    start = flax_to_state(jax.tree.map(np.asarray, pair.params), len(pair.model.layers))
    stats = bool(pair.cfg.training.log_additional_stats)
    clip = pair.cfg.training.get("gradient_clip_val", None)
    amse = pair.cfg.training.loss_function.type == "amse"

    S = int(pair.cfg.model.forecast_steps)
    for batch in _batches(pair, S, STEPS):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, pair.n_common)
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, pair.n_common)
        assert tm["applied"] == bool(jm["applied"])
        assert tm["loss_per_step"].shape == (S,)
        np.testing.assert_allclose(tm["loss_per_step"].numpy(), np.asarray(jm["loss_per_step"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=AMSE_GRAD_NORM_RTOL if amse else RTOL)
        if clip is not None and tm["applied"]:
            assert float(tm["grad_norm"]) > float(clip)  # the clip binds
        assert stats == ("grads" in tm)
        if stats:
            for key in ("channel_loss_weighted", "channel_loss_unweighted"):
                np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]), rtol=RTOL,
                                           atol=1e-7)
            ref = flax_to_state(jax.tree.map(np.asarray, jm["grads"]), len(pair.model.layers))
            assert set(tm["grads"]) == set(ref)
            scale = max(float(np.abs(r).max()) for r in ref.values())
            assert max(float(np.abs(tm["grads"][n].numpy() - ref[n]).max()) for n in ref) \
                <= 1e-5 * scale
    assert (tstate.step, tstate.micro_step) == (int(jstate.step), int(jstate.micro_step))

    ref = flax_to_state(jax.tree.map(np.asarray, jstate.params), len(pair.model.layers))
    got = {n: p.detach().numpy() for n, p in pair.model.named_parameters()}
    d_ref = np.concatenate([(ref[n] - start[n]).ravel() for n in ref])
    d_got = np.concatenate([(got[n] - start[n]).ravel() for n in ref])
    assert np.linalg.norm(d_got - d_ref) <= 2e-4 * np.linalg.norm(d_ref)
    assert np.abs(d_got - d_ref).max() <= 5e-3 * np.abs(d_ref).max()


def test_eval_step_matches_jax():
    pair = build_pair()
    jloss, tloss = _losses(pair)
    lat, _ = equiangular_lat_lon(NLAT, NLON, include_poles=False)
    report = {"indices": [0, 20, pair.output_dim - 1], "std": [2.0, 0.5, 3.0],
              "lat_weights": latitude_weights(lat).astype(np.float32),
              "kinds": ["zscore", "humidity", "precip"], "q_min": 1e-6, "q_max": 0.03}
    jeval = jax_make_eval_step(pair.jax_model, jloss, pair.jax_cfg, report=report)
    teval = make_eval_step(pair.model, tloss, pair.cfg, report=report)
    for rep in (report, None):
        if rep is None:
            jeval = jax_make_eval_step(pair.jax_model, jloss, pair.jax_cfg)
            teval = make_eval_step(pair.model, tloss, pair.cfg)
        batch = _batches(pair, 2, 1, seed=3)[0]
        jm = jeval(pair.params, {k: jnp.asarray(v) for k, v in batch.items()}, pair.n_common)
        tm = teval({k: torch.from_numpy(v) for k, v in batch.items()}, pair.n_common)
        assert set(tm) == set(jm)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL)
        if rep is not None:
            np.testing.assert_allclose(tm["report_rmse"].numpy(), np.asarray(jm["report_rmse"]),
                                       rtol=RTOL)


def test_train_step_refuses_another_state():
    pair = build_pair()
    _, tloss = _losses(pair)
    topt = build_optimizer(pair.cfg, pair.model)
    tstep = make_train_step(pair.model, tloss, pair.cfg, topt)
    other = create_train_state(pair.model, build_optimizer(pair.cfg, pair.model))
    batch = {k: torch.from_numpy(v) for k, v in _batches(pair, 1, 1)[0].items()}
    with pytest.raises(ValueError, match="another model or optimizer"):
        tstep(other, batch, pair.n_common)
