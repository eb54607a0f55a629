"""Data-parallel training and the model benchmark on a card.

Marked ``gpu``: each test skips without a CUDA device.  The file imports
nothing of JAX, so it runs where the suite's ``conftest.py`` is skipped:

    python -m pytest --noconftest tests/test_torch_multirank_gpu.py -m gpu

* Two ranks sharing the one card over gloo (``compute.dist_backend=gloo``;
  NCCL refuses two ranks on one card), one sample a rank, against one
  process with the batch of 2, float32, 2 steps of the toy model
  (``tests/torch_rank_worker.py``): losses and gradient norms within
  ``RTOL`` (1e-4: float32 sums in another order, and the backward's d_field
  summed with float atomics in any order), the parameters' total update
  within ``tests/test_torch_train_step.py``'s limits, #1 and #2 launched on
  each rank (the model's 2 layers: 2 and 2 a step).
* ``tools.bench_model`` at a tiny size: the ``pallas`` rows launch #1
  (``fwd``) and #1 and #2 (``bwd``), the ``xla`` rows neither.
"""

import json
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_rank_worker import ROOT, launch  # noqa: E402

RTOL = 1e-4
TINY = ["model.latent_size=16", "model.velocity_vectors=4", "model.num_layers=2",
        "model.physblock.velocity_net.hidden_dim=8", "model.physblock.reaction.hidden_dim=8",
        "model.physblock.output_proj.hidden_dim=8", "model.bias_channels=2",
        "model.bias_rank=4", "training.optimizer.ns_dtype=float32", "compute.use_amp=false",
        "compute.dist_backend=gloo"]


@pytest.mark.gpu
def test_two_gloo_ranks_on_the_card_train_as_one_process(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paradis_torch.config import load_config
    from paradis_torch.tools.bench_artifact import dims, flagship

    cfg = load_config(overrides=TINY)
    model, d = flagship(cfg, (8, 16), "cpu")
    rng = np.random.default_rng(1)
    shapes = {"input": (2, 8, 16, d["n_common"] * d["n_time"]),
              "target": (2, 1, 8, 16, d["output_dim"]),
              "forcings": (2, 1, 8, 16, d["n_forcings"] * d["n_time"]),
              "constants": (2, 8, 16, d["n_const"])}
    arrays = {f"param:{n}": p.detach().numpy() for n, p in model.named_parameters()}
    for k in range(2):
        arrays.update({f"batch{k}:{key}": rng.normal(size=s).astype(np.float32)
                       for key, s in shapes.items()})
    np.savez(tmp_path / "in.npz", **arrays)
    settings = json.dumps({"overrides": TINY, "device": "cuda", "grid": [8, 16]})
    outs = {}
    for world, name in ((2, "two"), (0, "one")):
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


@pytest.mark.gpu
def test_bench_model_launches_the_kernels_only_in_the_pallas_rows():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paradis_torch.tools import bench_model

    argv = ["--grid", "8,16", "--repeats", "1"]
    for override in TINY[:8]:
        argv += ["--override", override]
    res = bench_model.main(argv)
    layers = 2
    assert res["rows"]["pallas_fwd"]["launches_per_call"] == {"interp_fwd": layers,
                                                               "interp_bwd": 0}
    assert res["rows"]["pallas_bwd"]["launches_per_call"] == {"interp_fwd": layers,
                                                               "interp_bwd": layers}
    for key in ("xla_fwd", "xla_bwd"):
        assert res["rows"][key]["launches_per_call"] == {"interp_fwd": 0, "interp_bwd": 0}
    assert all(res[k] > 0 for k in ("xla_fwd", "xla_bwd", "pallas_fwd", "pallas_bwd"))
    assert res["device"]["platform"] == "gpu" and res["kernels_built"] is not None
