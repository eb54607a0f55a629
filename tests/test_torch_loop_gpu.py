"""The data pipeline and the host loop on a card.

Marked ``gpu``: each test skips without a CUDA device.  The file imports
nothing of JAX (the toy store is the port's own, ``tests/torch_toy.py``), so
it runs where the suite's ``conftest.py`` is skipped:

    python -m pytest --noconftest tests/test_torch_loop_gpu.py -m gpu
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from paradis_torch.data.dataset import ERA5Dataset  # noqa: E402
from paradis_torch.data.pipeline import BatchLoader  # noqa: E402
from paradis_torch.ops import interp_cuda  # noqa: E402
from paradis_torch.train.loop import Trainer  # noqa: E402
from torch_toy import build_torch_toy_store, torch_toy_config  # noqa: E402


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return build_torch_toy_store(tmp_path_factory.mktemp("gpu_toy"))


@pytest.mark.gpu
def test_loader_cuda_batches_equal_its_cpu_batches(store):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = torch_toy_config(store)
    ds = ERA5Dataset(str(store), "2000-01-01", "2000-01-05", forecast_steps=2, cfg=cfg)
    for epoch in range(2):
        cpu = list(BatchLoader(ds, 2, shuffle=True, seed=epoch, device="cpu"))
        gpu = list(BatchLoader(ds, 2, shuffle=True, seed=epoch, device="cuda"))
        assert len(cpu) == len(gpu) == len(ds) // 2
        for a, b in zip(cpu, gpu):
            for k in a:
                assert b[k].device.type == "cuda" and b[k].dtype == a[k].dtype
                # the step reads the batch on the compute stream, as here
                assert torch.equal(b[k].cpu(), a[k]), k


@pytest.mark.gpu
def test_trainer_takes_two_steps_on_the_card(store, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = torch_toy_config(store, **{"training.max_steps": 2, "training.progress_bar": False,
                                     "compute.use_amp": True})
    before = interp_cuda.launches
    trainer = Trainer(cfg, log_dir=str(tmp_path))
    assert trainer.device.type == "cuda" and trainer.model.device.type == "cuda"
    res = trainer.fit()
    assert res["steps"] == 2 and np.isfinite(res["val_loss"])
    assert interp_cuda.launches > before
    rows = (tmp_path / "metrics.csv").read_text().splitlines()
    losses = [float(r.split(",")[2]) for r in rows if ",train_loss," in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
