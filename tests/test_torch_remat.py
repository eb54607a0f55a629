"""Row-banded interpolation and gradient checkpointing in the whole model.

The TINY pair of ``torch_parity.py`` on the 32 × 64 (5.625°) grid with
``compute.interp_band_rad=0.15``: the bound is 1.53 px, so the band gate is
on (bands of 8 arrival rows over 16 padded rows).  The JAX model runs its
CPU dense interpolation (``advection_impl=xla``), which clamps the departure
rows to the same bound; the port clamps and runs the banded plain versions,
which equal the unbanded function of the clamped positions.  Each case runs
once without and once with ``compute.gradient_checkpointing=true`` (the JAX
package's ``nn.remat`` with ``remat_policy: none``, the port's
``torch.utils.checkpoint`` around each physics layer); the train step also
under ``remat_policy: advect`` and ``advect_pos`` on both sides (the JAX
package's saveable names ``advect_interp`` / ``advect_pos``, the port's
selective-checkpoint policy over its custom ops), where the replay must not
run the interpolation forward again.
"""

import logging

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from paradis_tpu.train.loss import WeightedLoss as JaxWeightedLoss  # noqa: E402
from paradis_tpu.train.optim import build_optimizer as jax_build_optimizer  # noqa: E402
from paradis_tpu.train.step import create_train_state as jax_create_train_state  # noqa: E402
from paradis_tpu.train.step import make_train_step as jax_make_train_step  # noqa: E402
from paradis_torch.data import dyn_output_features  # noqa: E402
from paradis_torch.model.weights import flax_to_state  # noqa: E402
from paradis_torch.ops import advection, interp_cuda  # noqa: E402
from paradis_torch.sphere.geometry import equiangular_lat_lon  # noqa: E402
from paradis_torch.train import (WeightedLoss, build_optimizer, create_train_state,  # noqa: E402
                                 make_train_step)
from torch_parity import as_f32, build_pair  # noqa: E402

NLAT, NLON = 32, 64
BAND = ["compute.interp_band_rad=0.15", "training.optimizer.ns_dtype=float32"]
REMAT = {"no-remat": [], "remat": ["compute.gradient_checkpointing=true"]}
# the train step also under each saving policy
POLICIES = {**REMAT,
            "advect": REMAT["remat"] + ["compute.remat_policy=advect"],
            "advect_pos": REMAT["remat"] + ["compute.remat_policy=advect_pos"]}


@pytest.fixture
def counted(monkeypatch):
    """Counts of the banded plain forward and backward that the autograd
    pairing runs on CPU tensors (the kernels' plain stand-ins)."""
    calls = {"fwd": 0, "bwd": 0}

    def wrap(key, fn):
        def counting(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return counting

    monkeypatch.setattr(interp_cuda, "interp_band_plain",
                        wrap("fwd", interp_cuda.interp_band_plain))
    monkeypatch.setattr(interp_cuda, "interp_band_bwd_plain",
                        wrap("bwd", interp_cuda.interp_band_bwd_plain))
    return calls


def _pair(remat, *more):
    pair = build_pair(*BAND, *POLICIES[remat], *more, nlat=NLAT, nlon=NLON)
    assert pair.model.band_max_dy_pix == pytest.approx(pair.jax_model._band_max_dy_pix(),
                                                       rel=1e-12)
    assert pair.model.gradient_checkpointing == (remat != "no-remat")
    assert pair.jax_model.remat_policy == pair.model.remat_policy
    return pair


@pytest.mark.parametrize("remat", list(REMAT))
def test_banded_forward_matches_jax(remat, counted):
    """fp32 limit 5e-6, as tests/test_torch_model.py states (float32 sums in
    another order through 2 layers); inputs large enough that the clamp
    binds for some departure rows."""
    pair = _pair(remat)
    x = np.random.default_rng(1).normal(scale=2.0, size=(1, NLAT, NLON, pair.input_dim))
    x = x.astype(np.float32)
    ref = as_f32(jax.jit(pair.jax_model.apply)(pair.params, jnp.asarray(x)))
    with torch.no_grad():
        out = as_f32(pair.model(torch.from_numpy(x)))
    assert counted == {"fwd": len(pair.model.layers), "bwd": 0}
    assert ref.std() > 1e-2
    np.testing.assert_allclose(out, ref, atol=5e-6, rtol=0)


def _batch(pair, seed=1):
    rng = np.random.default_rng(seed)
    shapes = {"input": (1, NLAT, NLON, pair.n_common * pair.n_time),
              "target": (1, 1, NLAT, NLON, pair.output_dim),
              "forcings": (1, 1, NLAT, NLON, pair.n_forcings * pair.n_time),
              "constants": (1, NLAT, NLON, pair.n_const)}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("remat", list(POLICIES))
def test_banded_train_step_matches_jax(remat, counted):
    """One NorMuon train step (float32 Newton–Schulz) through the banded
    interpolation, against the JAX step: loss and gradient norm within rtol
    1e-5 and the step's gradients (``log_additional_stats``) within 1e-5 of
    the largest, the limits of tests/test_torch_train_step.py (float32 sums
    in another order; measured ≤ 4.6e-6).  The parameters after one step are
    not compared elementwise: AdamW's first step is lr·sign(g) where |g| is
    far above eps, and ~lr·g/eps on near-zero gradients, so gradients that
    agree to 4.6e-6 give updates 6e-3 of the largest apart.  Under
    ``advect`` and ``advect_pos`` the replay keeps the interpolation's
    output: L forwards a step, as without checkpointing."""
    pair = _pair(remat, "training.log_additional_stats=true")
    lat, _ = equiangular_lat_lon(NLAT, NLON, include_poles=False)
    names = dyn_output_features(pair.cfg.features)
    jloss = JaxWeightedLoss.from_config(pair.jax_cfg, lat, names)
    tloss = WeightedLoss.from_config(pair.cfg, lat, names, device="cpu")
    jopt = jax_build_optimizer(pair.jax_cfg, pair.params)
    jstep, _ = jax_make_train_step(pair.jax_model, jloss, pair.jax_cfg, jopt, donate=False)
    jstate = jax_create_train_state(pair.params, jopt)
    topt = build_optimizer(pair.cfg, pair.model)
    tstep = make_train_step(pair.model, tloss, pair.cfg, topt)
    tstate = create_train_state(pair.model, topt)

    batch = _batch(pair)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, pair.n_common)
    tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, pair.n_common)
    L = len(pair.model.layers)
    # with checkpointing under remat_policy none the backward replays each
    # layer's forward, interpolation included
    assert counted == {"fwd": 2 * L if remat == "remat" else L, "bwd": L}
    assert tm["applied"] and bool(jm["applied"])
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    ref = flax_to_state(jax.tree.map(np.asarray, jm["grads"]), L)
    assert set(tm["grads"]) == set(ref)
    scale = max(float(np.abs(r).max()) for r in ref.values())
    assert max(float(np.abs(tm["grads"][n].numpy() - ref[n]).max()) for n in ref) \
        <= 1e-5 * scale


def _grads(model, x):
    model.zero_grad()
    model(x).square().mean().backward()
    return torch.cat([p.grad.flatten() for p in model.parameters()])


@pytest.mark.parametrize("policy", ["none", "advect", "advect_pos"])
def test_checkpointing_leaves_gradients_and_outputs_unchanged(policy, counted, monkeypatch):
    """The port with checkpointing against itself without, same weights and
    batch: the replay recomputes the same float32 operations, so gradients
    agree to 1e-6 of the largest (measured equal) and the forward under
    ``inference_mode`` (the forecast's mode, no replay) is bitwise equal.
    A saving policy against ``none`` the same way; it runs the
    interpolation forward once a layer (``none`` twice), and ``advect_pos``
    also keeps the departure positions (no row clamp in the replay)."""
    names = ["no-remat", "remat"] + ([policy] if policy != "none" else [])
    pairs = [_pair(r) for r in names]
    models = [p.model for p in pairs]
    for model in models[1:]:
        model.load_state_dict(models[0].state_dict())
    x = np.random.default_rng(2).normal(scale=2.0, size=(1, NLAT, NLON, pairs[0].input_dim))
    x = torch.from_numpy(x.astype(np.float32))
    clamps = {"n": 0}
    clamp = advection._clamp_rows

    def counting_clamp(*args, **kw):
        clamps["n"] += 1
        return clamp(*args, **kw)

    monkeypatch.setattr(advection, "_clamp_rows", counting_clamp)
    grads, fwds, n_clamps = [], [], []
    for model in models:
        counted.update(fwd=0, bwd=0)
        clamps["n"] = 0
        grads.append(_grads(model, x))
        fwds.append(counted["fwd"])
        n_clamps.append(clamps["n"])
    L = len(models[0].layers)
    assert fwds == [L, 2 * L] + ([L] if policy != "none" else [])
    assert n_clamps[:2] == [L, 2 * L]
    if policy != "none":
        assert n_clamps[2] == (L if policy == "advect_pos" else 2 * L)
    scale = grads[0].abs().max()
    assert scale > 0
    for g in grads[1:]:
        assert (g - grads[1]).abs().max() <= 1e-6 * scale
        assert (g - grads[0]).abs().max() <= 1e-6 * scale
    with torch.inference_mode():
        ref = models[0](x)
        for model in models[1:]:
            torch.testing.assert_close(model(x), ref, rtol=0, atol=0)


def test_paradis_remat_policy_overrides_the_config(counted, monkeypatch, caplog):
    """``PARADIS_REMAT_POLICY`` replaces ``compute.remat_policy`` at each
    checkpointed forward, with a logged warning, as the JAX package reads it
    at each trace: ``advect`` over a ``none`` config runs the interpolation
    forward once a layer; an unknown name raises as the config would."""
    pair = _pair("remat")
    model = pair.model
    x = np.random.default_rng(3).normal(size=(1, NLAT, NLON, pair.input_dim))
    x = torch.from_numpy(x.astype(np.float32))
    L = len(model.layers)
    monkeypatch.setenv("PARADIS_REMAT_POLICY", "advect")
    with caplog.at_level(logging.WARNING):
        _grads(model, x)
    assert counted == {"fwd": L, "bwd": L}
    assert "PARADIS_REMAT_POLICY=advect overrides compute.remat_policy=none" in caplog.text
    monkeypatch.setenv("PARADIS_REMAT_POLICY", "none")
    counted.update(fwd=0, bwd=0)
    _grads(model, x)
    assert counted == {"fwd": 2 * L, "bwd": L}
    monkeypatch.setenv("PARADIS_REMAT_POLICY", "offload")
    with pytest.raises(ValueError, match="remat_policy must be none|advect|advect_pos"):
        _grads(model, x)
