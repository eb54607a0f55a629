"""The port's optimizers and schedules against the JAX package's optax ones.

The TINY pair of ``torch_parity.py`` gives both packages the same weights;
seeded numpy gradient trees go through ``paradis_tpu.train.optim
.build_optimizer`` (optax) and ``paradis_torch.train.optim.build_optimizer``
for a few updates, with the learning rate set through each package's
``set_learning_rate`` before each one.  The total updates (parameters after
the last update minus before the first) are compared:

* float32 (AdamW, and Muon / NorMuon with float32 Newton–Schulz): max
  |difference| over max |update|.  The parameters (up to ~2) carry a float32
  ulp of up to 2.4e-7 against total updates of a few 1e-3, and the two
  packages apply decay and update in another order, so they agree to a few
  parameter ulps: measured ≤ 7e-5 of the update; limit 3e-4.
* bfloat16 Newton–Schulz rounds every iterate to bf16 in both packages, at
  other places (XLA fuses, PyTorch does not).  Each package's bf16 result
  lies 3–7% (Frobenius) from the exact float32 iteration and 6–8% from the
  other's; the limits on the Frobenius norm of the difference over that of
  the update are 15% against the JAX bf16 result and 10% against float32.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from paradis_tpu.config import load_config as jax_load_config  # noqa: E402
from paradis_tpu.train import optim as jax_optim  # noqa: E402
from paradis_torch.config import load_config  # noqa: E402
from paradis_torch.model.weights import flax_to_state  # noqa: E402
from paradis_torch.train import optim  # noqa: E402
from torch_parity import build_pair  # noqa: E402

LRS = (1e-3, 2e-3, 5e-4)


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def test_partition_matches_muon_label_fn(pair):
    labels = jax_optim.muon_label_fn(pair.params)
    codes = jax.tree.map(lambda lab, p: np.full(p.shape, lab == "muon"), labels, pair.params)
    ref = {name: bool(a.flat[0]) for name, a in
           flax_to_state(codes, len(pair.model.layers)).items()}
    ours = optim.muon_labels(pair.model)
    assert set(ours) == set(ref)
    assert {n for n, lab in ours.items() if lab == "muon"} == {n for n, m in ref.items() if m}
    assert 0 < sum(ref.values()) < len(ref)


def _grad_trees(params, n, seed=0):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda p: rng.normal(scale=1e-2, size=p.shape).astype(np.float32),
                         params) for _ in range(n)]


def _run_both(pair, overrides):
    jcfg = jax_load_config(overrides=list(overrides))
    tcfg = load_config(overrides=list(overrides))
    model = pair.model
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    try:
        jopt = jax_optim.build_optimizer(jcfg, pair.params)
        state, params = jopt.init(pair.params), pair.params
        update = jax.jit(jopt.update)
        topt = optim.build_optimizer(tcfg, model)
        for lr, g in zip(LRS, _grad_trees(pair.params, len(LRS))):
            state = jax_optim.set_learning_rate(state, lr)
            upd, state = update(jax.tree.map(jnp.asarray, g), state, params)
            params = optax.apply_updates(params, upd)
            optim.set_learning_rate(topt, lr)
            assert optim.get_learning_rate(topt) == lr
            assert jax_optim.get_learning_rate(state) == pytest.approx(lr, rel=1e-7)  # float32
            bridged = flax_to_state(g, len(model.layers))
            for n, p in model.named_parameters():
                p.grad = torch.tensor(bridged[n])
            topt.step()
        ref = flax_to_state(jax.tree.map(np.asarray, params), len(model.layers))
        got = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    finally:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
                p.grad = None
    d_ref = np.concatenate([(ref[n] - start[n].numpy()).ravel() for n in ref])
    d_got = np.concatenate([(got[n] - start[n].numpy()).ravel() for n in ref])
    return d_got, d_ref


@pytest.mark.parametrize("overrides", [
    ["training.optimizer.name=adamw"],
    ["training.optimizer.name=muon", "training.optimizer.ns_dtype=float32"],
    ["training.optimizer.name=normuon", "training.optimizer.ns_dtype=float32"],
    ["training.optimizer.name=normuon", "training.optimizer.ns_dtype=float32",
     "training.gradient_clip_val=0.05"],
], ids=["adamw", "muon-fp32", "normuon-fp32", "normuon-fp32-clip"])
def test_updates_match_optax(pair, overrides):
    got, ref = _run_both(pair, overrides)
    assert np.abs(got - ref).max() <= 3e-4 * np.abs(ref).max()


def test_bf16_newton_schulz_updates_match_optax(pair):
    got, ref = _run_both(pair, ["training.optimizer.name=normuon"])
    _, exact = _run_both(pair, ["training.optimizer.name=normuon",
                                "training.optimizer.ns_dtype=float32"])
    assert np.linalg.norm(got - ref) <= 0.15 * np.linalg.norm(ref)
    assert np.linalg.norm(got - exact) <= 0.10 * np.linalg.norm(exact)


def test_adamw_matches_optax_adam_with_decoupled_decay():
    """``torch.optim.AdamW`` against the optax chain the JAX package builds:
    eps outside the square root and bias correction, over five steps."""
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(4, 6)).astype(np.float32)
    grads = rng.normal(scale=1e-3, size=(5, 4, 6)).astype(np.float32)
    tx = optax.chain(optax.scale_by_adam(b1=0.9, b2=0.95), optax.add_decayed_weights(0.01),
                     optax.scale(-1e-3))
    jp, st = jnp.asarray(p0), None
    st = tx.init(jp)
    tp = torch.nn.Parameter(torch.tensor(p0))
    opt = torch.optim.AdamW([tp], lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.01)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.tensor(g)
        opt.step()
    # a few float32 ulps of the parameters (|p| < 4), as above
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_newton_schulz_matches_jax(side, dtype):
    rng = np.random.default_rng(4)
    shape = (4, 32, 96) if side == "left" else (4, 96, 32)
    x = rng.normal(size=shape).astype(np.float32)
    ref = np.asarray(jax_optim.newton_schulz_batched(jnp.asarray(x), side=side,
                                                     dtype=getattr(jnp, dtype)), np.float32)
    got = optim.newton_schulz_batched(torch.tensor(x), side=side,
                                      dtype=getattr(torch, dtype)).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    else:
        exact = np.asarray(jax_optim.newton_schulz_batched(jnp.asarray(x), side=side,
                                                           dtype=jnp.float32))
        assert np.linalg.norm(got - ref) <= 0.15 * np.linalg.norm(ref)
        assert np.linalg.norm(got - exact) <= 0.10 * np.linalg.norm(exact)


def test_unknown_optimizer_and_ns_dtype_raise(pair):
    with pytest.raises(ValueError, match="not supported"):
        optim.build_optimizer(load_config(overrides=["training.optimizer.name=sgd"]), pair.model)
    with pytest.raises(ValueError, match="ns_dtype"):
        optim.build_optimizer(load_config(overrides=["training.optimizer.ns_dtype=int8"]),
                              pair.model)


SCHEDULES = [
    ["training.scheduler.wsd.warmup=10", "training.scheduler.wsd.decay=0.2"],
    ["training.scheduler.wsd.warmup=0.1", "training.scheduler.wsd.decay=30"],
    ["training.scheduler.wsd.enabled=false", "training.scheduler.one_cycle.enabled=true",
     "training.scheduler.one_cycle.warmup_pct_start=0.3",
     "training.scheduler.one_cycle.lr_div_factor=25"],
    ["training.scheduler.wsd.enabled=false", "training.scheduler.one_cycle.enabled=true"],
]


@pytest.mark.parametrize("overrides", SCHEDULES, ids=["wsd", "wsd-fractions", "one-cycle",
                                                       "one-cycle-no-warmup"])
def test_schedules_match_jax(overrides):
    ref, ref_ctrl = jax_optim.build_schedule(jax_load_config(overrides=overrides), 100)
    got, ctrl = optim.build_schedule(load_config(overrides=overrides), 100)
    assert ctrl is None and ref_ctrl is None
    for step in (0, 1, 5, 9, 10, 11, 37, 50, 79, 80, 81, 99, 100):
        assert got(step) == pytest.approx(ref(step), rel=1e-12), step


@pytest.mark.parametrize("mode", ["rel", "abs"])
def test_plateau_controller_matches_jax(mode):
    overrides = ["training.scheduler.wsd.enabled=false", "training.scheduler.reduce_lr.enabled=true",
                 f"training.scheduler.reduce_lr.threshold_mode={mode}",
                 "training.scheduler.reduce_lr.patience=1"]
    ref_fn, ref = jax_optim.build_schedule(jax_load_config(overrides=overrides), 100)
    got_fn, got = optim.build_schedule(load_config(overrides=overrides), 100)
    for metric in (1.0, 0.9, 0.95, 0.91, 0.92, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0):
        assert got.update(metric) == ref.update(metric)
        assert got_fn(0) == ref_fn(0)


def test_schedule_errors_match_jax():
    none = ["training.scheduler.wsd.enabled=false"]
    for build, load in ((optim.build_schedule, load_config),
                        (jax_optim.build_schedule, jax_load_config)):
        with pytest.raises(ValueError, match="exactly one scheduler"):
            build(load(overrides=none), 100)
        with pytest.raises(ValueError, match="WSD schedule needs"):
            build(load(overrides=["training.scheduler.wsd.warmup=90"]), 100)

