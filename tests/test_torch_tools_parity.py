"""The port's tools against the scripts of ``scripts/`` they port.

The scripts are loaded with ``importlib`` from their files, unedited.

- ``soak.report`` against ``scripts/soak.py:report`` on the same
  ``metrics.csv`` (non-numeric rows, a resume step or none): equal, dict for
  dict;
- ``ns_convergence._train`` and ``lq_convergence._train`` against the JAX
  ``_train`` of ``scripts/ns_convergence.py`` (NorMuon, 5 Newton–Schulz
  steps, on the Blosc-LZ4 store) and ``scripts/lq_convergence.py`` (AdamW, on
  the lq16 store): the same 8 × 16 store (built by the port, the same bytes
  as the JAX package's), seed 0, the port's model given the JAX model's
  initial weights; 3 steps' losses within rtol 1e-5 (the loop test's limit:
  float32 sums in another order).  Both packages' ``default_config`` give
  ``ns_dtype: float32`` here, as the train-step and loop parity tests run
  NorMuon: in bfloat16 the two packages' matmuls round the iterates
  differently (1.1e-5 at the third step).  The JAX model's ``init`` runs
  under ``jax.jit`` (the script calls it eagerly: ~350 small compiles, ~40
  CPU-seconds, the same parameters); with the two train steps, three JAX
  compiles;
- ``roofline``'s shape constants equal ``scripts/roofline.py``'s.
"""

import csv
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from paradis_torch.model import load_flax_params  # noqa: E402
from paradis_torch.tools import lq_convergence, ns_convergence, roofline, soak  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3
RTOL = 1e-5


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _write_metrics(wd: Path) -> None:
    rng = np.random.default_rng(3)
    (wd / "logs").mkdir(parents=True)
    with open(wd / "logs" / "metrics.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["step", "name", "value"])
        for step in range(1, 61):
            w.writerow([step, "train_loss", rng.uniform(0.2, 1.0)])
            if step % 4 == 0:
                w.writerow([step, "samples_per_sec", rng.uniform(1.0, 3.0)])
                w.writerow([step, "host_rss_mb", 900 + step * rng.uniform(0.1, 0.3)])
                w.writerow([step, "jit_cache_entries", -1.0])
            if step % 20 == 0:
                w.writerow([step, "val_loss", rng.uniform(0.2, 1.0)])
        w.writerow([61, "model/num_parameters", "n/a"])  # not a number: skipped
        for step in range(25, 31):  # a resumed segment repeats its steps
            w.writerow([step, "train_loss", rng.uniform(0.2, 1.0)])


@pytest.mark.parametrize("resume_step", [None, 24])
def test_soak_report_matches_the_script(tmp_path, resume_step):
    _write_metrics(tmp_path)
    ours = soak.report(tmp_path, resume_step)
    theirs = _script("soak").report(tmp_path, resume_step)
    assert ours == theirs
    assert ours["jit_cache_entries"] == {"warmup": -1, "final": -1}
    assert ("resume_continuity" in ours) == (resume_step is not None)


def test_roofline_shapes_match_the_script():
    ref = _script("roofline")
    for name in ("B", "H", "W", "P", "V", "PAD", "R", "C", "L", "LATENT"):
        assert getattr(roofline, name) == getattr(ref, name), name
    assert roofline.NORMUON_FLOP == 1.46e12


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    return ns_convergence.build_store(tmp_path_factory.mktemp("ab"), codecs=("lz4", "lq16"))


def _jax_initial_weights(store: Path) -> dict:
    """The JAX ``_train``'s initial parameters (its config, ``PRNGKey(0)``)."""
    from paradis_tpu.config import default_config
    from paradis_tpu.data.dataset import ERA5Dataset
    from paradis_tpu.model.paradis import Paradis

    cfg = default_config().resolved()
    cfg.features.pressure_levels = [500, 850, 1000]
    cfg.model.latent_size = 32
    cfg.model.velocity_vectors = 8
    cfg.model.num_layers = 2
    cfg.model.physblock.velocity_net.hidden_dim = 16
    cfg.model.physblock.reaction.hidden_dim = 16
    cfg.model.physblock.output_proj.hidden_dim = 16
    cfg.model.bias_channels = 2
    cfg.model.bias_rank = 4
    ds = ERA5Dataset(str(store), "2000-01-01", None, forecast_steps=1, cfg=cfg)
    model = Paradis.from_config(cfg, input_dim=ds.num_in_features,
                                output_dim=ds.num_out_features, lat_deg=ds.lat,
                                lon_deg=ds.lon, dtype=jnp.float32, training=True)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, ds.lat_size, ds.lon_size, ds.num_in_features)))
    return jax.tree.map(np.asarray, params)


def _jitted_init(monkeypatch):
    from paradis_tpu.model.paradis import Paradis

    init = Paradis.init

    def jitted(self, rng, *args):
        return jax.jit(lambda r, *a: init(self, r, *a))(rng, *args)

    monkeypatch.setattr(Paradis, "init", jitted)


def _float32_newton_schulz(monkeypatch):
    import paradis_tpu.config
    import paradis_torch.config

    for module in (paradis_tpu.config, paradis_torch.config):
        made = module.default_config

        def default_config(made=made):
            cfg = made()
            cfg.training.optimizer.ns_dtype = "float32"
            return cfg

        monkeypatch.setattr(module, "default_config", default_config)


@pytest.mark.parametrize("tool,codec", [("ns_convergence", "lz4"), ("lq_convergence", "lq16")])
def test_convergence_training_matches_the_script(stores, tool, codec, monkeypatch):
    _float32_newton_schulz(monkeypatch)
    _jitted_init(monkeypatch)
    store = stores[codec]
    weights = _jax_initial_weights(store)
    ref = _script(tool)
    port = {"ns_convergence": ns_convergence, "lq_convergence": lq_convergence}[tool]
    kw = {"ns_steps": 5} if tool == "ns_convergence" else {}
    theirs = ref._train(store, STEPS, seed=0, **kw)
    ours = port._train(store, STEPS, seed=0, device="cpu",
                       init=lambda m: load_flax_params(m, weights), **kw)
    assert ours.shape == (STEPS,) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, theirs, rtol=RTOL)
