"""Spatial training on a card: two ranks sharing it over gloo, each on its
block of the 5.625° grid.

Marked ``gpu``: the test skips without a CUDA device.  The file imports
nothing of JAX, so it runs where the suite's ``conftest.py`` is skipped:

    python -m pytest --noconftest tests/test_torch_spatial_gpu.py -m gpu

``compute.lat_devices=2`` (each rank 16 of the 32 latitudes) and
``compute.spatial_devices=2`` (32 of the 64 longitudes), float32, 2 steps
of the toy model on the batch of 2 (``tests/torch_rank_worker.py``),
against one process on the card: losses and gradient norms within ``RTOL``
(1e-4, ``tests/test_torch_multirank_gpu.py``'s: float32 sums in another
order, and the backward's d_field summed with float atomics in any order),
the parameters' total update within ``tests/test_torch_train_step.py``'s
limits, and the interpolation kernels #1 and #2 launched on each rank (the
model's 2 layers: 2 and 2 a step), so the spatial path runs through them.
"""

import json
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_rank_worker import ROOT, launch  # noqa: E402

RTOL = 1e-4
GRID = (32, 64)
TINY = ["model.latent_size=16", "model.velocity_vectors=4", "model.num_layers=2",
        "model.physblock.velocity_net.hidden_dim=8", "model.physblock.reaction.hidden_dim=8",
        "model.physblock.output_proj.hidden_dim=8", "model.bias_channels=2",
        "model.bias_rank=4", "training.optimizer.ns_dtype=float32", "compute.use_amp=false",
        "compute.dist_backend=gloo"]


@pytest.mark.gpu
@pytest.mark.parametrize("axis", ["compute.lat_devices=2", "compute.spatial_devices=2"])
def test_two_spatial_ranks_on_the_card_train_as_one_process(tmp_path, axis):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paradis_torch.config import load_config
    from paradis_torch.tools.bench_artifact import flagship

    cfg = load_config(overrides=TINY)
    model, d = flagship(cfg, GRID, "cpu")
    H, W = GRID
    rng = np.random.default_rng(2)
    shapes = {"input": (2, H, W, d["n_common"] * d["n_time"]),
              "target": (2, 1, H, W, d["output_dim"]),
              "forcings": (2, 1, H, W, d["n_forcings"] * d["n_time"]),
              "constants": (2, H, W, d["n_const"])}
    arrays = {f"param:{n}": p.detach().numpy() for n, p in model.named_parameters()}
    for k in range(2):
        arrays.update({f"batch{k}:{key}": rng.normal(size=s).astype(np.float32)
                       for key, s in shapes.items()})
    np.savez(tmp_path / "in.npz", **arrays)
    outs = {}
    for world, name, overrides in ((2, "two", TINY + [axis]), (0, "one", TINY)):
        settings = json.dumps({"overrides": overrides, "device": "cuda", "grid": list(GRID)})
        res = launch([sys.executable, str(ROOT / "tests" / "torch_rank_worker.py"),
                      str(tmp_path / "in.npz"), str(tmp_path / f"{name}.npz"), settings],
                     world=world, timeout=300)()
        assert all(rc == 0 for rc, _ in res), [out[-3000:] for _, out in res]
        outs[name] = np.load(tmp_path / f"{name}.npz")
    two, one = outs["two"], outs["one"]
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=RTOL)
    np.testing.assert_allclose(two["grad_norm"], one["grad_norm"], rtol=RTOL)
    assert two["launches"].tolist() == [[4, 4], [4, 4]] and one["launches"].tolist() == [[4, 4]]
    start = {k[6:]: v for k, v in arrays.items() if k.startswith("param:")}
    d_two = np.concatenate([(two[f"param:{n}"] - v).ravel() for n, v in start.items()])
    d_one = np.concatenate([(one[f"param:{n}"] - v).ravel() for n, v in start.items()])
    assert np.linalg.norm(d_two - d_one) <= 2e-4 * np.linalg.norm(d_one)
    assert np.abs(d_two - d_one).max() <= 5e-3 * np.abs(d_one).max()
