"""The weight bridge, the port's initialisation, and the port's isolation
from JAX and from the JAX package."""

import pytest

torch = pytest.importorskip("torch")

import copy  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from paradis_torch import resolve_device  # noqa: E402
from paradis_torch.config import load_config  # noqa: E402
from paradis_torch.model import Paradis, load_flax_params  # noqa: E402
from paradis_torch.model.weights import flax_to_state  # noqa: E402
from paradis_torch.sphere.geometry import equiangular_lat_lon  # noqa: E402
from torch_parity import build_pair  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _small(*overrides, **kw):
    """A one-layer model of width 16 on the CPU (or ``kw['device']``)."""
    cfg = load_config(overrides=["model.latent_size=16", "model.velocity_vectors=4",
                                 "model.num_layers=1", *overrides])
    lat, lon = equiangular_lat_lon(8, 16, include_poles=False)
    kw.setdefault("device", "cpu")
    return Paradis.from_config(cfg, input_dim=20, output_dim=7, lat_deg=lat, lon_deg=lon, **kw)


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture
def tree(pair):
    return jax.tree.map(np.asarray, pair.params)


def test_bridge_layout(pair, tree):
    """Stacked leaves are unstacked; Dense kernels and depthwise kernels are
    transposed to the torch layouts."""
    p, m = tree["params"], pair.model
    np.testing.assert_array_equal(m.layers[1].alpha_adv.detach().numpy(),
                                  p["layers"]["alpha_adv"][1])
    k = p["layers"]["advection"]["down_projection"]["layer0_SepConv"]["depthwise"]["kernel"][1]
    np.testing.assert_array_equal(
        m.layers[1].advection.down_projection.layer0_SepConv.depthwise.weight.detach().numpy(),
        np.transpose(k, (3, 2, 0, 1)))
    np.testing.assert_array_equal(m.input_proj.layer0_CLinear.conv.weight.detach().numpy(),
                                  p["input_proj"]["layer0_CLinear"]["conv"]["kernel"].T)
    np.testing.assert_array_equal(m.output_proj.bias0_GlobalBias.projection.detach().numpy(),
                                  p["output_proj"]["bias0_GlobalBias"]["projection"].T)
    np.testing.assert_array_equal(m.static_depthwise.bias.detach().numpy(),
                                  p["static_depthwise"]["bias"])


def test_bridge_raises_on_a_missing_leaf(pair, tree):
    del tree["params"]["output_proj"]["pre_norm"]["bias"]
    with pytest.raises(ValueError, match="output_proj.pre_norm.bias"):
        load_flax_params(pair.model, tree)


def test_bridge_raises_on_an_extra_leaf(pair, tree):
    tree["params"]["static_sepconv2"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="static_sepconv2.extra"):
        load_flax_params(pair.model, tree)


def test_bridge_raises_on_a_shape_or_depth_mismatch(pair, tree):
    bad = copy.deepcopy(tree)
    bad["params"]["input_proj"]["layer0_CLinear"]["conv"]["bias"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(pair.model, bad)
    bad = copy.deepcopy(tree)
    bad["params"]["layers"]["alpha_adv"] = bad["params"]["layers"]["alpha_adv"][:1]
    with pytest.raises(ValueError, match="stacked"):
        load_flax_params(pair.model, bad)


def test_init_matches_the_jax_distributions(pair, tree):
    """A fresh port model draws each parameter from the JAX package's init
    distribution: constants equal, random leaves with matching spread."""
    lat, lon = equiangular_lat_lon(8, 16, include_poles=False)
    fresh = Paradis.from_config(pair.cfg, input_dim=pair.input_dim, output_dim=pair.output_dim,
                                lat_deg=lat, lon_deg=lon, device="cpu")
    ref = flax_to_state(tree, num_layers=len(fresh.layers))
    for name, p in fresh.named_parameters():
        a, r = p.detach().numpy(), ref[name]
        if r.std() == 0:
            np.testing.assert_array_equal(a, r, err_msg=name)
        elif r.size >= 256:
            # the spread of a few hundred draws is within ~10% of the law's
            assert 0.75 < a.std() / r.std() < 1.33, (name, a.std(), r.std())


def test_same_seed_same_weights():
    a, b, c = _small(seed=3), _small(seed=3), _small(seed=4)
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), n
    assert not torch.equal(a.input_proj.layer0_CLinear.conv.weight,
                           c.input_proj.layer0_CLinear.conv.weight)


@pytest.mark.parametrize("override,match", [
    ("compute.advection_impl=dense", "advection_impl"),
    ("compute.advection_impl=triton", "advection_impl"),
    ("compute.advection_impl=plain", "advection_impl"),
    ("compute.gradient_checkpointing=true compute.remat_policy=offload", "remat_policy"),
])
def test_from_config_raises_on_settings_it_cannot_honour(override, match):
    with pytest.raises((ValueError, NotImplementedError), match=match):
        _small(*override.split())


@pytest.mark.parametrize("policy", ["none", "advect", "advect_pos"])
def test_from_config_builds_each_remat_policy(policy):
    """Each ``compute.remat_policy`` of the JAX package builds, and a
    checkpointed forward and backward runs under it on the CPU."""
    model = _small("compute.gradient_checkpointing=true", f"compute.remat_policy={policy}")
    assert model.gradient_checkpointing and model.remat_policy == policy
    model(torch.ones(1, 8, 16, 20)).square().mean().backward()
    assert all(p.grad is not None for p in model.parameters())


def test_entry_points_raise_without_a_card_and_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        _small(device=None)
    assert resolve_device("cpu") == torch.device("cpu")
    from paradis_torch.cli import export as export_cli

    with pytest.raises(RuntimeError, match="CUDA"):
        export_cli.main(["--checkpoint-path", "params.pt", "--output-dir", "never",
                         "--device", "cuda"])
    assert not (ROOT / "never").exists()
    from paradis_torch.tools import bench_model

    with pytest.raises(RuntimeError, match="CUDA"):
        bench_model.main(["--device", "cuda"])
    # the measuring and operating tools, each before it builds or writes anything
    from paradis_torch.tools import (bench_forecast, bench_highres, bench_pipeline,
                                     lq_convergence, ns_convergence, profile_live,
                                     profile_step, rehearsal, roofline, soak)

    for tool, argv in ((bench_forecast, []), (bench_highres, []), (bench_pipeline, []),
                       (profile_step, []), (roofline, []), (ns_convergence, []),
                       (lq_convergence, []), (profile_live, ["--store", "never"]),
                       (soak, ["--workdir", str(ROOT / "never")]),
                       (rehearsal, ["--workdir", str(ROOT / "never")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            tool.main([*argv, "--device", "cuda"])
    # a rank of a multi-rank cli.train, as the launcher starts it
    from paradis_torch import distributed
    from paradis_torch.cli import train as train_cli
    from paradis_torch.config import load_config

    for key, value in (("WORLD_SIZE", "2"), ("RANK", "1"), ("LOCAL_RANK", "1"),
                       ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(key, value)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["compute.num_devices=2", "training.log_dir=never"])
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.initialize_distributed(load_config(), "cuda")
    assert not distributed.is_initialized() and not (ROOT / "never").exists()


_ISOLATION = r"""
import sys
sys.path.insert(0, {root!r})
import torch
from paradis_torch.config import load_config
from paradis_torch.forecast import make_forecast_rollout
from paradis_torch.model import Paradis
from paradis_torch.sphere.geometry import equiangular_lat_lon

cfg = load_config(overrides=["model.latent_size=16", "model.velocity_vectors=4",
                             "model.num_layers=1", "compute.use_amp=false"])
lat, lon = equiangular_lat_lon(8, 16, include_poles=False)
model = Paradis.from_config(cfg, input_dim=20, output_dim=12, lat_deg=lat, lon_deg=lon,
                            device="cpu")
g = torch.Generator().manual_seed(0)
batch = {{"input": torch.randn(1, 8, 16, 8, generator=g),
          "forcings": torch.randn(1, 2, 8, 16, 2, generator=g),
          "constants": torch.randn(1, 8, 16, 10, generator=g)}}
out = make_forecast_rollout(model, cfg)(batch, 4)
assert out.shape == (1, 2, 8, 16, 12) and torch.isfinite(out).all()

from paradis_torch.train import (WeightedLoss, build_optimizer, create_train_state,
                                 make_train_step)
names = ["temperature_h500"] * 11 + ["2m_temperature"]
loss_fn = WeightedLoss.from_config(cfg, lat, names, device="cpu")
optimizer = build_optimizer(cfg, model)
state = create_train_state(model, optimizer)
before = model.input_proj.layer0_CLinear.conv.weight.detach().clone()
batch["target"] = torch.randn(1, 1, 8, 16, 12, generator=g)
metrics = make_train_step(model, loss_fn, cfg, optimizer)(state, batch, 4)
assert torch.isfinite(metrics["loss"]) and metrics["applied"] and state.step == 1
assert not torch.equal(before, model.input_proj.layer0_CLinear.conv.weight)

import tempfile
from pathlib import Path
from paradis_torch.cli import convert
from paradis_torch.train.checkpoint import CheckpointManager, load_params
from paradis_torch.train.convert import torch_state_dict_to_params
amse = WeightedLoss.from_config(cfg, lat, names, kind="amse", nlon=16, device="cpu")
assert torch.isfinite(amse(out[:, 0], batch["target"][:, 0]))
with tempfile.TemporaryDirectory() as d:
    assert CheckpointManager(d, step_every=1).maybe_save_step(1, state)
    CheckpointManager(d).restore(state)
    load_params(d, model)
assert len(torch_state_dict_to_params({{}}, model)) == len(list(model.parameters()))

sys.path.insert(0, {tests!r})
from torch_toy import build_torch_toy_store, torch_toy_config
from paradis_torch.cli import train as train_cli
from paradis_torch.data import native
from paradis_torch.train.loop import Trainer
with tempfile.TemporaryDirectory() as d:
    native.require()
    store = build_torch_toy_store(Path(d))
    trainer = Trainer(torch_toy_config(store, **{{"training.max_steps": 2,
                                                 "training.progress_bar": False}}),
                      log_dir=str(Path(d) / "logs"), device="cpu")
    assert trainer.fit()["steps"] == 2
    assert (Path(d) / "logs" / "metrics.csv").is_file()
    from paradis_torch.cli import forecast as forecast_cli
    from paradis_torch.forecast.evaluate import evaluate_store
    from paradis_torch.train.checkpoint import save_params
    save_params(Path(d) / "params.pt", trainer.model)
    toy = ["features.pressure_levels=[500,850,1000]", "model.latent_size=16",
           "model.velocity_vectors=4", "model.num_layers=2", "model.bias_channels=2",
           "model.bias_rank=4", "model.physblock.velocity_net.hidden_dim=8",
           "model.physblock.reaction.hidden_dim=8", "model.physblock.output_proj.hidden_dim=8"]
    stats = forecast_cli.main(["--checkpoint-path", str(Path(d) / "params.pt"),
                               "--output-file", str(Path(d) / "fc.zarr"), "--root-dir",
                               str(store), "--forecast-steps", "2", "--start-date",
                               "2000-01-03", "--end-date", "2000-01-03", "--device", "cpu",
                               *toy])
    assert stats["steps"] == 2
    scores = evaluate_store(str(Path(d) / "fc.zarr"), str(store), [("geopotential", 500)],
                            [6], climatology=str(store / "climatology"), device="cpu")
    assert len(scores) == 2

import os
os.environ["PARADIS_INTERP_CHUNK"] = "8"
from paradis_torch.ops import interp_chunk, interp_cuda, interp_gen
from paradis_torch.tools import bench_interp
out = make_forecast_rollout(model, cfg)(batch, 4)
assert torch.isfinite(out).all() and interp_cuda.chunk_launches == 0
assert interp_chunk.chunk_rows(10, None) == 8
y = torch.rand(1, 8, 16, 4) * 12
assert torch.isfinite(interp_gen.bwd_gen(y, y, 12, 20)).all()
assert "ns_update" in bench_interp.VARIANTS
from paradis_torch.forecast.export import load_artifact, save_artifact
from paradis_torch.tools import bench_artifact
cfg.model.forecast_steps = 2
cfg.features.input.forcings = cfg.features.input.forcings[:1]  # the batch's 2 channels
with tempfile.TemporaryDirectory() as d:
    art = save_artifact(Path(d) / "art", model, cfg, batch_size=1, nlat=8, nlon=16,
                        input_dim=20, output_dim=12, n_common=4)
    serving = load_artifact(art)
    x = torch.cat([batch["input"], batch["forcings"][:, 0], batch["constants"]], dim=-1)
    with torch.no_grad():
        assert torch.equal(serving(x), model(x))
    assert serving.rollout(batch["input"], batch["forcings"], batch["constants"]).shape == (
        1, 2, 8, 16, 12)
assert "rollout" in bench_artifact.WAYS
from paradis_torch import distributed
from paradis_torch.tools import bench_model
from paradis_torch.train import sharded_ckpt
assert distributed.assign_owners([3, 2, 1], 2) == [0, 1, 1]
assert bench_model.KERNELS == ("interp_fwd", "interp_bwd")
assert sharded_ckpt.SHARD_DIR == "state_sharded"
from paradis_torch.tools import (bench_forecast, bench_highres, bench_pipeline, flagship,
                                 lq_convergence, ns_convergence, profile_live, profile_step,
                                 rehearsal, roofline, soak)
assert bench_forecast.CHAIN_SHORT == 2 and bench_highres.CHAIN_LONG == 8
assert roofline.bound(torch.empty(1, 12, 20, 4), torch.empty(1, 8, 16, 4), "bicubic")[0] > 0
assert flagship.HR_GRID == (128, 256) and soak.POLL_S > 0 and rehearsal.LEVELS_13[0] == 50
assert profile_step.BUCKETS and profile_live.main and bench_pipeline.build_store
assert ns_convergence.TOY_LEVELS == (500, 850, 1000) and lq_convergence.toy_train
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "paradis_tpu"))
assert not bad, bad
print("isolated")
"""


def test_port_runs_without_jax_or_the_jax_package():
    """A fresh interpreter imports the port, builds a toy model on the CPU,
    runs a rollout and takes one NorMuon train step, evaluates the AMSE loss,
    saves, restores and loads a checkpoint, imports the converter and its
    CLI, builds the native host library and a toy store with the port's own
    synthetic store and preprocessor, trains 2 steps through ``Trainer`` and
    imports the training CLI, forecasts from its weights through the forecast
    CLI and scores the store, runs a rollout through the row-chunked path and
    the weight generation, imports the microbenchmark, exports a serving
    artifact, loads it and runs its forward and rollout, imports the artifact
    benchmark, imports the ranks' module, the sharded checkpoints and the
    model benchmark, imports the measuring and operating tools (and bounds an
    interpolation with the roofline's formula), and has loaded nothing of
    JAX, flax or paradis_tpu."""
    res = subprocess.run([sys.executable, "-c",
                          _ISOLATION.format(root=str(ROOT), tests=str(ROOT / "tests"))],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "isolated" in res.stdout


_IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|paradis_tpu)\b"
                        r"|import_module\(\s*['\"](jax|flax|paradis_tpu)", re.M)


def test_no_jax_import_in_the_port_or_the_smoke_script():
    files = sorted((ROOT / "paradis_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10 and files[-1].is_file()
    for new in ("ops/interp_chunk.py", "ops/interp_gen.py", "tools/bench_interp.py",
                "ops/sht.py", "train/amse.py", "train/checkpoint.py", "train/convert.py",
                "cli/convert.py", "data/zarrlite.py", "data/blosc.py", "data/native.py",
                "data/forcings.py", "data/synthetic.py", "data/preprocess.py",
                "data/dataset.py", "data/pipeline.py", "data/datamodule.py",
                "utils/logging.py", "utils/system.py", "train/loop.py",
                "cli/preprocess.py", "cli/train.py", "forecast/export.py", "cli/export.py",
                "tools/bench_artifact.py", "distributed.py", "train/sharded_ckpt.py",
                "tools/bench_model.py", "tools/flagship.py", "tools/bench_forecast.py",
                "tools/bench_highres.py", "tools/bench_pipeline.py", "tools/profile_step.py",
                "tools/roofline.py", "tools/profile_live.py", "tools/soak.py",
                "tools/rehearsal.py", "tools/ns_convergence.py", "tools/lq_convergence.py",
                "tools/bench_bilinear.py"):
        assert ROOT / "paradis_torch" / new in files, new
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in _IMPORT_RE.finditer(f.read_text())]
    assert not offenders, offenders
