"""``python -m paradis_torch.cli.export --device cpu`` on the port's toy store
from a ``save_params`` checkpoint, and a fresh interpreter that loads the
artifact and serves it (forward and rollout) importing only the modules
that register the ``paradis::`` ops (not the model, the data pipeline, the
rollout, the writer, JAX or the JAX package); its forward bitwise the
model's with those weights.
No JAX here: the file also runs where the suite's ``conftest.py`` is skipped.
"""

import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from paradis_torch.data.dataset import ERA5Dataset  # noqa: E402
from paradis_torch.model import Paradis  # noqa: E402
from paradis_torch.train.checkpoint import load_params, save_params  # noqa: E402
from torch_toy import TOY_LEVELS, build_torch_toy_store, torch_toy_config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOY = [f"features.pressure_levels=[{','.join(map(str, TOY_LEVELS))}]", "model.latent_size=16",
       "model.velocity_vectors=4", "model.num_layers=1", "model.bias_channels=2",
       "model.bias_rank=4", "model.physblock.velocity_net.hidden_dim=8",
       "model.physblock.reaction.hidden_dim=8", "model.physblock.output_proj.hidden_dim=8",
       "model.forecast_steps=3"]

_SERVE = r"""
import sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
from paradis_torch.forecast.export import load_artifact
serving = load_artifact({art!r})
x = np.load({x!r})
out = serving(torch.from_numpy(x))
m = serving.manifest["rollout"]["input_shapes"]
rng = np.random.default_rng(0)
b = [torch.from_numpy(rng.normal(size=m[k]).astype(np.float32))
     for k in ("input", "forcings", "constants")]
roll = serving.rollout(*b)
np.save({out!r}, out.numpy())
np.save({roll!r}, roll.numpy())
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "flax", "paradis_tpu"))
assert not bad, bad
# the op registrations and what they import (the spans of utils/tracing.py),
# nothing of the model, the data pipeline, the rollout or the writer
serving_modules = {{"paradis_torch", "paradis_torch._build", "paradis_torch.forecast",
                   "paradis_torch.forecast.export", "paradis_torch.utils",
                   "paradis_torch.utils.tracing"}}
extra = sorted(k for k in sys.modules if k.startswith("paradis_torch")
               and k not in serving_modules
               and not k.startswith(("paradis_torch.ops", "paradis_torch.sphere")))
assert not extra, extra
print("served", serving.device)
"""


@pytest.fixture(scope="module")
def cli_artifact(tmp_path_factory):
    base = tmp_path_factory.mktemp("export_cli")
    store = build_torch_toy_store(base)
    cfg = torch_toy_config(store, **{"model.num_layers": 1})
    ds = ERA5Dataset(str(store), "2000-01-01", "2000-01-05", forecast_steps=1, cfg=cfg)
    model = Paradis.from_config(cfg, input_dim=ds.num_in_features,
                                output_dim=ds.num_out_features, lat_deg=ds.lat, lon_deg=ds.lon,
                                seed=11, device="cpu")
    save_params(base / "params.pt", model)
    out = base / "art"
    res = subprocess.run([sys.executable, "-m", "paradis_torch.cli.export", "--checkpoint-path",
                          str(base / "params.pt"), "--output-dir", str(out), "--root-dir",
                          str(store), "--device", "cpu", *TOY],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert f"serving artifact written: {out}" in res.stdout
    return base, out, cfg, ds


def test_cli_export_on_the_cpu_writes_the_artifact(cli_artifact):
    _, out, cfg, ds = cli_artifact
    assert sorted(p.name for p in out.iterdir()) == ["forward.pt2", "manifest.json",
                                                     "params.npz", "rollout.pt2"]
    m = json.loads((out / "manifest.json").read_text())
    assert m["input_shape"] == [1, ds.lat_size, ds.lon_size, ds.num_in_features]
    assert m["feature_names"] == list(ds.dyn_output_features)
    assert m["n_common"] == ds.num_common_features and m["rollout"]["forecast_steps"] == 3
    assert m["device"] == "cpu"


def test_a_fresh_interpreter_serves_the_artifact_without_the_model(cli_artifact):
    base, out, cfg, ds = cli_artifact
    x = np.random.default_rng(5).normal(
        size=(1, ds.lat_size, ds.lon_size, ds.num_in_features)).astype(np.float32)
    np.save(base / "x.npy", x)
    script = _SERVE.format(root=str(ROOT), art=str(out), x=str(base / "x.npy"),
                           out=str(base / "y.npy"), roll=str(base / "roll.npy"))
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "served cpu" in res.stdout
    model = Paradis.from_config(cfg, input_dim=ds.num_in_features,
                                output_dim=ds.num_out_features, lat_deg=ds.lat, lon_deg=ds.lon,
                                device="cpu")
    load_params(base / "params.pt", model)
    with torch.no_grad():
        np.testing.assert_array_equal(np.load(base / "y.npy"), model(torch.from_numpy(x)).numpy())
    roll = np.load(base / "roll.npy")
    assert roll.shape == (1, 3, ds.lat_size, ds.lon_size, ds.num_out_features)
    assert np.isfinite(roll).all()
