"""The port's checkpoints: save and restore, resume, retention, weights-only
transfer across grids, and the errors of a file that does not fit.

A toy port model (the TINY configuration of ``torch_parity.py``, 8 × 16, on
the CPU) trains with NorMuon + AdamW on seeded numpy batches.  Everything on
the CPU is deterministic, so a restored state and a resumed run are held
bitwise.  The retention policies and the resolution transfer are held
against the JAX package's orbax manager and ``load_params``.
"""

import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import pickle  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from paradis_tpu.train import checkpoint as jax_ckpt  # noqa: E402
from paradis_tpu.train.step import create_train_state as jax_create_train_state  # noqa: E402
from paradis_torch.config import load_config  # noqa: E402
from paradis_torch.data import dyn_output_features  # noqa: E402
from paradis_torch.model import Paradis, load_flax_params  # noqa: E402
from paradis_torch.sphere.geometry import equiangular_lat_lon  # noqa: E402
from paradis_torch.train import (WeightedLoss, build_optimizer, create_train_state,  # noqa: E402
                                 make_train_step)
from paradis_torch.train.checkpoint import (PARAMS_FILE, STATE_FILE,  # noqa: E402
                                            CheckpointManager, load_params, save_params)
from torch_parity import NLAT, NLON, TINY, build_pair  # noqa: E402


class Run:
    """A toy model, its optimizer, train state and step, on the CPU."""

    def __init__(self, *overrides, seed=0, nlat=NLAT, nlon=NLON):
        self.cfg = load_config(overrides=TINY + list(overrides))
        f = self.cfg.features
        n_levels = len(f.pressure_levels)
        self.n_common = len(f.input.atmospheric) * n_levels + len(f.input.surface)
        self.n_out = len(f.output.atmospheric) * n_levels + len(f.output.surface)
        self.n_time = int(self.cfg.dataset.n_time_inputs)
        self.n_forcings, self.n_const = len(f.input.forcings), len(f.input.constants)
        self.grid = (nlat, nlon)
        lat, lon = equiangular_lat_lon(nlat, nlon, include_poles=False)
        self.model = Paradis.from_config(
            self.cfg, input_dim=(self.n_common + self.n_forcings) * self.n_time + self.n_const,
            output_dim=self.n_out, lat_deg=lat, lon_deg=lon, seed=seed, device="cpu")
        self.optimizer = build_optimizer(self.cfg, self.model)
        self.state = create_train_state(self.model, self.optimizer)
        loss_fn = WeightedLoss.from_config(self.cfg, lat, dyn_output_features(f), device="cpu")
        self.step_fn = make_train_step(self.model, loss_fn, self.cfg, self.optimizer)

    def batch(self, i):
        rng = np.random.default_rng(100 + i)
        H, W = self.grid
        shapes = {"input": (1, H, W, self.n_common * self.n_time),
                  "target": (1, 1, H, W, self.n_out),
                  "forcings": (1, 1, H, W, self.n_forcings * self.n_time),
                  "constants": (1, H, W, self.n_const)}
        return {k: torch.tensor(rng.normal(size=s), dtype=torch.float32)
                for k, s in shapes.items()}

    def train(self, microsteps):
        """Microsteps ``microsteps`` (their batch is their index); the losses."""
        losses = []
        for i in microsteps:
            self.optimizer.lr = 1e-3 * (1 + self.state.step)  # a host-set schedule
            losses.append(self.step_fn(self.state, self.batch(i), self.n_common)["loss"])
        return torch.stack(losses)

    def snapshot(self):
        """Every tensor and number of the state, by path, copied."""
        out = {f"param/{n}": p.detach().clone() for n, p in self.model.named_parameters()}
        out.update({f"grad/{n}": p.grad.clone() for n, p in self.model.named_parameters()
                    if p.grad is not None})
        out.update(_flat(self.optimizer.state_dict(), "opt"))
        out["step"], out["micro_step"] = self.state.step, self.state.micro_step
        return out


def _flat(obj, prefix):
    if isinstance(obj, dict):
        return {k: v for key, val in obj.items() for k, v in _flat(val, f"{prefix}/{key}").items()}
    if isinstance(obj, (list, tuple)):
        return {k: v for i, val in enumerate(obj) for k, v in _flat(val, f"{prefix}/{i}").items()}
    return {prefix: obj.clone() if isinstance(obj, torch.Tensor) else obj}


def _assert_same(a, b):
    assert set(a) == set(b), sorted(set(a) ^ set(b))
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == b[k].dtype and torch.equal(v, b[k]), k
        else:
            assert v == b[k], k


def test_state_round_trip_is_bitwise(tmp_path):
    """Parameters, optimizer state (AdamW, the Muon stacks, lr), counters and
    the gradients of an open accumulation window come back bitwise."""
    run = Run("training.accumulate_grad_batches=2")
    run.train(range(3))                       # two windows' worth, one open
    assert run.state.micro_step % 2 == 1 and run.state.step == 1
    saved = run.snapshot()
    mgr = CheckpointManager(tmp_path, accumulate_grad_batches=2)
    mgr.save_epoch(0, run.state)
    assert sorted(p.name for p in (tmp_path / "epochs" / "0000").iterdir()) == [PARAMS_FILE,
                                                                                 STATE_FILE]
    fresh = Run("training.accumulate_grad_batches=2", seed=7)
    assert not torch.equal(fresh.model.layers[0].alpha_adv, run.model.layers[0].alpha_adv) \
        or not torch.equal(fresh.model.input_proj.layer0_CLinear.conv.weight,
                           run.model.input_proj.layer0_CLinear.conv.weight)
    assert mgr.restore(fresh.state) is fresh.state   # through last.json
    _assert_same(fresh.snapshot(), saved)
    sd = torch.load(tmp_path / "epochs" / "0000" / STATE_FILE, weights_only=True)
    assert set(sd) == {"format", "params", "optimizer", "step", "micro_step", "accum"}
    assert set(sd["params"]) == {n for n, _ in run.model.named_parameters()}


@pytest.mark.parametrize("accum", [1, 2])
def test_resume_equals_the_uninterrupted_run(tmp_path, accum):
    """Three microsteps, a save, a fresh model and optimizer from another seed
    restored from the checkpoints root, three more: bitwise the six-microstep
    run, in the middle of an accumulation window too."""
    ov = f"training.accumulate_grad_batches={accum}"
    whole = Run(ov)
    losses = whole.train(range(6))
    first = Run(ov)
    np.testing.assert_array_equal(first.train(range(3)).numpy(), losses[:3].numpy())
    mgr = CheckpointManager(tmp_path / "ckpt", step_every=1, accumulate_grad_batches=accum)
    mgr.save_epoch(0, first.state)
    second = Run(ov, seed=5)
    CheckpointManager(tmp_path / "ckpt").restore(second.state, tmp_path / "ckpt")
    np.testing.assert_array_equal(second.train(range(3, 6)).numpy(), losses[3:].numpy())
    _assert_same(second.snapshot(), whole.snapshot())


def _retention_sequence(mgr, state):
    """Step, epoch and best saves in one order; the tags each call saved."""
    saved = []
    for step in range(0, 8):
        if mgr.maybe_save_step(step, state):
            saved.append(f"steps/{step:08d}")
        if step == 3:
            mgr.save_epoch(0, state)
        if step in (2, 5, 6):
            if mgr.maybe_save_best({2: 3.0, 5: 2.5, 6: 2.75}[step], state):
                saved.append(f"best@{step}")
    mgr.save_epoch(1, state)
    return saved


def _layout(root):
    kept = {sub: sorted(p.name for p in (root / sub).iterdir())
            for sub in ("steps", "epochs", "best")}
    last = json.loads((root / "last.json").read_text())["path"]
    metric = json.loads((root / "best" / "metric.json").read_text())
    return kept, str(type(root)(last).relative_to(root.resolve())), metric


def test_retention_matches_the_orbax_manager(tmp_path):
    """The port's manager and the JAX package's keep the same tags, point
    ``last.json`` at the same one and write the same best metric; a step
    checkpoint holds the state alone, epoch and best ones the params too."""
    run = Run()
    port = CheckpointManager(tmp_path / "port", keep_steps=2, step_every=2)
    params = {"w": jnp.arange(3.0)}
    jstate = jax_create_train_state(params, optax.sgd(0.1))
    ref = jax_ckpt.CheckpointManager(str(tmp_path / "jax"), keep_steps=2, step_every=2)
    assert _retention_sequence(port, run.state) == _retention_sequence(ref, jstate)
    ref._ckptr.wait_until_finished()
    got, want = _layout(tmp_path / "port"), _layout(tmp_path / "jax")
    assert got == want
    assert got[0]["steps"] == ["00000004", "00000006"] and got[1] == "epochs/0001"
    assert sorted(p.name for p in (tmp_path / "port" / "steps" / "00000006").iterdir()) \
        == [STATE_FILE]
    for d in ("epochs/0001", "best/best"):
        assert sorted(p.name for p in (tmp_path / "port" / d).iterdir()) == [PARAMS_FILE,
                                                                               STATE_FILE]
    assert port.latest_path() == (tmp_path / "port" / "epochs" / "0001").resolve()


def test_load_params_across_resolutions_matches_jax(tmp_path):
    """GlobalBias U/V factors re-interpolated onto a 2× grid: the JAX
    package's save → load into a 2× template, bridged into the port, is
    bitwise the port's save → load of the same weights."""
    small = build_pair(nlat=NLAT, nlon=NLON)
    big = build_pair(nlat=2 * NLAT, nlon=2 * NLON, seed=3)
    jax_ckpt.save_params(str(tmp_path / "jax_params"), small.params)
    loaded = jax_ckpt.load_params(str(tmp_path / "jax_params"), big.params)
    ref = Run(nlat=2 * NLAT, nlon=2 * NLON, seed=9).model
    load_flax_params(ref, jax.tree.map(np.asarray, loaded))

    save_params(tmp_path / "params.pt", small.model)
    got = load_params(tmp_path / "params.pt", big.model)
    assert got is big.model
    factors = 0
    for (name, a), b in zip(got.named_parameters(), ref.parameters()):
        assert torch.equal(a, b), name
        if name.rsplit(".", 1)[-1] in ("U", "V"):
            factors += 1
            src = dict(small.model.named_parameters())[name]
            assert a.shape[-1] == 2 * src.shape[-1]
            # align-corners: the end points are kept
            assert torch.equal(a[..., [0, -1]], src[..., [0, -1]])
    assert factors >= 4


def test_load_params_reads_a_state_only_checkpoint_and_a_root(tmp_path):
    run = Run()
    run.train(range(2))
    mgr = CheckpointManager(tmp_path, step_every=2)
    assert not mgr.maybe_save_step(0, run.state) and not mgr.maybe_save_step(1, run.state)
    assert mgr.maybe_save_step(2, run.state)
    for path in (tmp_path, tmp_path / "steps" / "00000002",
                 tmp_path / "steps" / "00000002" / STATE_FILE):
        fresh = Run(seed=4).model
        load_params(path, fresh)
        for (name, a), b in zip(fresh.named_parameters(), run.model.parameters()):
            assert torch.equal(a, b), name


def _unchanged(run, before):
    _assert_same(run.snapshot(), before)


def test_load_params_is_strict_and_changes_nothing_on_error(tmp_path):
    run = Run()
    save_params(tmp_path / "p.pt", run.model)
    sd = torch.load(tmp_path / "p.pt", weights_only=True)
    target = Run(seed=2)
    before = target.snapshot()

    missing = dict(sd, params={k: v for k, v in sd["params"].items()
                               if k != "output_proj.pre_norm.bias"})
    extra = dict(sd, params=dict(sd["params"], **{"static_sepconv2.extra": torch.zeros(3)}))
    name = "input_proj.layer0_CLinear.conv.bias"
    shape = dict(sd, params=dict(sd["params"], **{name: torch.zeros(5)}))
    uv = next(n for n in sd["params"] if n.endswith(".U"))
    rank = dict(sd, params=dict(sd["params"], **{uv: torch.zeros(3, NLAT)}))
    for bad, match in ((missing, r"does not match the model .*output_proj\.pre_norm\.bias"),
                       (extra, r"does not match the model .*static_sepconv2\.extra"),
                       (shape, f"shape mismatch at {name}"),
                       (rank, f"shape mismatch at {uv}")):
        torch.save(bad, tmp_path / "bad.pt")
        with pytest.raises(ValueError, match=match):
            load_params(tmp_path / "bad.pt", target.model)
        _unchanged(target, before)
    wide = Run("model.latent_size=48")
    with pytest.raises(ValueError, match="shape mismatch"):
        load_params(tmp_path / "p.pt", wide.model)


def test_a_truncated_or_foreign_file_raises_and_loads_nothing(tmp_path):
    run = Run("training.accumulate_grad_batches=2")
    run.train(range(3))
    mgr = CheckpointManager(tmp_path / "ckpt", accumulate_grad_batches=2)
    mgr.save_epoch(0, run.state)
    state_file = tmp_path / "ckpt" / "epochs" / "0000" / STATE_FILE
    data = state_file.read_bytes()
    target = Run("training.accumulate_grad_batches=2", seed=3)
    target.train(range(1))
    before = target.snapshot()

    (tmp_path / "cut.pt").write_bytes(data[: len(data) // 2])
    with pytest.raises(RuntimeError):
        mgr.restore(target.state, tmp_path / "cut.pt")
    _unchanged(target, before)
    with pytest.raises(RuntimeError):
        load_params(tmp_path / "cut.pt", target.model)
    _unchanged(target, before)

    with open(tmp_path / "foreign.pt", "wb") as f:
        pickle.dump({"format": "paradis_torch.state/1", "obj": Run}, f, protocol=2)
    with pytest.raises(pickle.UnpicklingError):
        mgr.restore(target.state, tmp_path / "foreign.pt")
    torch.save({"weights": torch.zeros(3)}, tmp_path / "other.pt")
    with pytest.raises(ValueError, match="not a paradis_torch.state/1 file"):
        mgr.restore(target.state, tmp_path / "other.pt")
    with pytest.raises(ValueError, match="not a paradis_torch.params/1 or"):
        load_params(tmp_path / "other.pt", target.model)
    _unchanged(target, before)

    # a state of the right format whose optimizer does not fit
    sd = torch.load(state_file, weights_only=True)
    bad_opt = dict(sd, optimizer=dict(sd["optimizer"], name="adamw"))
    bad_accum = dict(sd, accum={"layers.0.alpha_adv": torch.zeros(2)})
    for bad, match in ((bad_opt, "does not fit the 'normuon' optimizer"),
                       (bad_accum, "accumulated gradients")):
        torch.save(bad, tmp_path / "bad.pt")
        with pytest.raises(ValueError, match=match):
            mgr.restore(target.state, tmp_path / "bad.pt")
        _unchanged(target, before)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(target.state)


def test_optimizer_state_is_keyed_by_parameter_name():
    """A Muon group saved with its rows in another order restores each row
    into its own parameter's slot."""
    run = Run()
    run.train(range(2))
    sd = run.optimizer.state_dict()
    group = max(sd["muon"], key=lambda g: len(g["names"]))
    assert len(group["names"]) > 1 and group["nu"] is not None
    shuffled = dict(sd, muon=[dict(g, names=g["names"][::-1], momentum=g["momentum"].flip(0),
                                   nu=g["nu"].flip(0)) if g is group else g
                              for g in sd["muon"]])
    fresh = Run(seed=6)
    fresh.optimizer.load_state_dict(shuffled)
    _assert_same(_flat(fresh.optimizer.state_dict(), "opt"), _flat(sd, "opt"))
    assert fresh.optimizer.lr == run.optimizer.lr
    with pytest.raises(ValueError, match="Muon groups differ"):
        fresh.optimizer.load_state_dict(dict(sd, muon=sd["muon"][1:]))
