"""The port's ranks and data-parallel layouts (``paradis_torch/distributed.py``)
on the CPU.

The unit counterparts of ``tests/test_multihost.py:34-60`` (each rank's
contiguous rows of the global batch), the settings that raise (a world-size
mismatch, a spatial axis wider than the launch, a coordinator without a
process group, ``auto`` with two ranks on one card), the owner map of the sharded layout, the
loader's rows against the one-process batches, the sharded checkpoint's
checks and the optimizer state by name.  And the data-parallel train step
against the JAX package's: two ranks over gloo on ``127.0.0.1``
(``tests/torch_rank_worker.py``, one sample a rank, the bridged weights of
``torch_parity.py``'s TINY pair, NorMuon with float32 Newton–Schulz) against
the JAX ``make_train_step`` on a ``data=2`` mesh of the conftest's virtual
CPU devices over the same global batch of 2, for 2 steps, held to
``tests/test_torch_train_step.py``'s limits: losses and gradient norms
within rtol 1e-5, the parameters' total update within 2e-4 (Frobenius) and
5e-3 (each element, of the largest update).  The mesh step is this file's
one JAX compile (~30 s; the ranks run beside it).
"""

import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from paradis_torch import distributed  # noqa: E402
from paradis_torch.config import load_config  # noqa: E402
from paradis_torch.data.dataset import ERA5Dataset  # noqa: E402
from paradis_torch.data.pipeline import BatchLoader  # noqa: E402
from paradis_torch.forecast.rollout import DatasetShare  # noqa: E402
from paradis_torch.model.weights import flax_to_state  # noqa: E402
from paradis_torch.train.sharded_ckpt import read_sharded  # noqa: E402
from torch_parity import TINY, build_pair, build_torch_toy_store, torch_toy_config  # noqa: E402
from torch_rank_worker import ROOT, launch  # noqa: E402

RTOL = 1e-5
STEPS = 2


# -- rows, shares, owners ---------------------------------------------------------

def test_local_batch_slice_is_one_contiguous_block_a_rank():
    assert [distributed.local_batch_slice(8, r, 4) for r in range(4)] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    assert distributed.local_batch_slice(8, 0, 1) == slice(0, 8)
    with pytest.raises(ValueError, match="not divisible"):
        distributed.local_batch_slice(6, 0, 4)


@pytest.mark.parametrize("n,world", [(6, 2), (5, 2), (3, 4), (10, 3)])
def test_contiguous_shares_cover_every_item_once(n, world):
    shares = [distributed.contiguous_share(n, r, world) for r in range(world)]
    assert shares[0][0] == 0 and shares[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    sizes = [hi - lo for lo, hi in shares]
    assert max(sizes) - min(sizes) <= 1


def test_owners_balance_the_elements_and_agree_on_every_rank():
    sizes = [100, 100, 50, 50, 7, 3, 1000]
    owners = distributed.assign_owners(sizes, 2)
    assert owners == distributed.assign_owners(sizes, 2)
    load = [sum(s for s, o in zip(sizes, owners) if o == r) for r in range(2)]
    assert load == [1000, 310]
    assert distributed.assign_owners(sizes, 1) == [0] * len(sizes)
    assert sorted(set(distributed.assign_owners([5] * 8, 4))) == [0, 1, 2, 3]


def test_dataset_share_keeps_the_whole_datasets_indices():
    class Items:
        prediction_stage = True

        def __len__(self):
            return 5

        def __getitem__(self, i):
            return i, f"x{i}"

    share = DatasetShare(Items(), *distributed.contiguous_share(5, 1, 2))
    assert len(share) == 2 and share.prediction_stage
    assert [share[i][0] for i in range(len(share))] == [3, 4]
    with pytest.raises(IndexError):
        share[2]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return build_torch_toy_store(tmp_path_factory.mktemp("dist"))


def test_each_ranks_rows_are_the_one_process_batches_rows(store):
    """Every rank walks the same seeded order: rank r's samples at step k are
    rows [r·bs, (r+1)·bs) of the one-process run's global batch, over two
    shuffled epochs."""
    cfg = torch_toy_config(store)
    ds = ERA5Dataset(str(store), cfg.training.dataset.start_date,
                     cfg.training.dataset.end_date, forecast_steps=1, cfg=cfg)

    def batches(rows):
        loader = BatchLoader(ds, 4, shuffle=True, seed=3, device="cpu", rows=rows)
        return [b for _ in range(2) for b in loader]

    whole = batches(None)
    assert len(whole) >= 4
    for rank in range(2):
        mine = batches(distributed.local_batch_slice(4, rank, 2))
        assert len(mine) == len(whole)
        for a, b in zip(mine, whole):
            for key in a:
                assert torch.equal(a[key], b[key][2 * rank:2 * rank + 2]), key


# -- settings --------------------------------------------------------------------

@pytest.mark.parametrize("requested,device,local,count,want", [
    ("auto", "cpu", 2, 0, "gloo"), ("gloo", "cpu", 2, 0, "gloo"),
    ("auto", "cuda", 1, 1, "nccl"), ("nccl", "cuda", 4, 4, "nccl"),
    ("gloo", "cuda", 2, 1, "gloo"),
    ("auto", "cuda", 2, 1, "pass compute.dist_backend=gloo"),
    ("nccl", "cuda", 2, 1, "pass compute.dist_backend=gloo"),
    ("nccl", "cpu", 1, 0, "needs ranks on cards"), ("mpi", "cpu", 1, 0, "one of"),
])
def test_the_backend_for_each_setting(requested, device, local, count, want):
    if want in ("gloo", "nccl"):
        assert distributed.pick_backend(requested, torch.device(device), local, count) == want
    else:
        with pytest.raises(ValueError, match=want):
            distributed.pick_backend(requested, torch.device(device), local, count)


@pytest.mark.parametrize("override,error", [
    ("compute.num_devices=2", ValueError), ("compute.num_nodes=3", ValueError),
    ("compute.coordinator_address=localhost:1234", ValueError),
    ("compute.spatial_devices=2", ValueError),
    ("compute.lat_devices=2", ValueError),
])
def test_settings_that_do_not_fit_the_launch_raise(override, error):
    """In one process: more data ranks, or a spatial axis of 2 ranks, than
    the one launched (the fit check; spatial runs:
    ``tests/test_torch_spatial_multirank.py``)."""
    cfg = load_config(overrides=[override])
    with pytest.raises(error, match="multi-GPU"):
        distributed.fit_check(cfg)


def test_one_process_without_a_launcher_makes_no_process_group(monkeypatch):
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "PARADIS_COORDINATOR"):
        monkeypatch.delenv(key, raising=False)
    ranks = distributed.initialize_distributed(load_config(), "cpu")
    assert ranks == distributed.Ranks(0, 1, 0, torch.device("cpu"))
    assert not distributed.is_initialized() and distributed.world_size() == 1
    assert distributed.fit_check(load_config()) == (1, 1, 1)
    assert distributed.is_main_process()
    assert load_config().compute.dist_backend == "auto"


# -- checkpoints and optimizer state by name ----------------------------------------

def test_param_states_restore_into_a_fresh_optimizer():
    from paradis_torch.tools.bench_artifact import flagship
    from paradis_torch.train import build_optimizer
    from paradis_torch.train.optim import param_states_of

    cfg = load_config(overrides=TINY)
    model, _ = flagship(cfg, (8, 16), "cpu")
    opt = build_optimizer(cfg, model)
    for p in model.parameters():
        p.grad = torch.ones_like(p) * 1e-3
    opt.step()
    fresh = build_optimizer(cfg, model)
    fresh.load_param_states(param_states_of(opt.state_dict()))
    a, b = opt.state_dict(), fresh.state_dict()
    for ga, gb in zip(a["muon"], b["muon"]):
        assert ga["names"] == gb["names"] and torch.equal(ga["momentum"], gb["momentum"])
    for i in a["adamw"]["state"]:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a["adamw"]["state"][i][k], b["adamw"]["state"][i][k])
    with pytest.raises(ValueError, match="does not fit"):
        fresh.load_param_states(dict(opt.param_states(), name="adamw"))


def _shard(path, rank, world, params, step=2):
    torch.save({"format": "paradis_torch.state_shard/1", "rank": rank, "world": world,
                "params": params, "optimizer": {"name": "adamw", "lr": 1e-3, "params": {}},
                "step": step, "micro_step": step}, path / f"shard_p{rank}.pt")


def test_a_sharded_checkpoint_must_be_whole_and_consistent(tmp_path):
    one = {"a": torch.ones(2)}
    _shard(tmp_path, 0, 2, one)
    with pytest.raises(ValueError, match="incomplete"):
        read_sharded(tmp_path)
    _shard(tmp_path, 1, 2, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="more than one shard"):
        read_sharded(tmp_path)
    _shard(tmp_path, 1, 2, {"b": torch.zeros(3)}, step=3)
    with pytest.raises(ValueError, match="disagrees"):
        read_sharded(tmp_path)
    _shard(tmp_path, 1, 2, {"b": torch.zeros(3)})
    merged = read_sharded(tmp_path)
    assert sorted(merged["params"]) == ["a", "b"] and merged["step"] == 2
    assert "accum" not in merged


# -- the data-parallel step against the JAX mesh step --------------------------------

def _batches(pair, n, seed=1):
    rng = np.random.default_rng(seed)
    H, W = 8, 16
    shapes = {"input": (2, H, W, pair.n_common * pair.n_time),
              "target": (2, 1, H, W, pair.output_dim),
              "forcings": (2, 1, H, W, pair.n_forcings * pair.n_time),
              "constants": (2, H, W, pair.n_const)}
    return [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
            for _ in range(n)]


def test_two_rank_train_steps_match_the_jax_data_mesh(tmp_path):
    from paradis_tpu.distributed import create_mesh, replicate, shard_batch
    from paradis_tpu.train.loss import WeightedLoss as JaxWeightedLoss
    from paradis_tpu.train.optim import build_optimizer as jax_build_optimizer
    from paradis_tpu.train.step import create_train_state as jax_create_train_state
    from paradis_tpu.train.step import make_train_step as jax_make_train_step
    from paradis_torch.data import dyn_output_features
    from paradis_torch.sphere.geometry import equiangular_lat_lon

    pair = build_pair("training.optimizer.ns_dtype=float32")
    batches = _batches(pair, STEPS)
    start = flax_to_state(jax.tree.map(np.asarray, pair.params), len(pair.model.layers))
    arrays = {f"param:{n}": v for n, v in start.items()}
    arrays.update({f"batch{k}:{key}": v for k, b in enumerate(batches) for key, v in b.items()})
    np.savez(tmp_path / "in.npz", **arrays)
    settings = {"overrides": TINY + ["training.optimizer.ns_dtype=float32",
                                      "compute.use_amp=false"],
                "device": "cpu", "grid": [8, 16]}
    wait = launch([sys.executable, str(ROOT / "tests" / "torch_rank_worker.py"),
                   str(tmp_path / "in.npz"), str(tmp_path / "out.npz"), json.dumps(settings)],
                  world=2, timeout=180)

    # the JAX step on a data=2 mesh while the ranks run
    mesh = create_mesh(data=2, devices=jax.devices()[:2])
    lat, _ = equiangular_lat_lon(8, 16, include_poles=False)
    jloss = JaxWeightedLoss.from_config(pair.jax_cfg, lat, dyn_output_features(pair.cfg.features),
                                        nlon=16)
    jopt = jax_build_optimizer(pair.jax_cfg, pair.params)
    jstep, _ = jax_make_train_step(pair.jax_model, jloss, pair.jax_cfg, jopt, donate=False,
                                   mesh=mesh)
    jstate = replicate(jax_create_train_state(pair.params, jopt), mesh)
    want = {"loss": [], "grad_norm": []}
    for b in batches:
        jstate, jm = jstep(jstate, shard_batch({k: jnp.asarray(v) for k, v in b.items()}, mesh),
                           pair.n_common)
        for key in want:
            want[key].append(float(jm[key]))

    outs = wait()
    assert all(rc == 0 for rc, _ in outs), [out[-3000:] for _, out in outs]
    got = np.load(tmp_path / "out.npz")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=RTOL)
    ref = flax_to_state(jax.tree.map(np.asarray, jstate.params), len(pair.model.layers))
    d_ref = np.concatenate([(ref[n] - start[n]).ravel() for n in ref])
    d_got = np.concatenate([(got[f"param:{n}"] - start[n]).ravel() for n in ref])
    assert np.linalg.norm(d_got - d_ref) <= 2e-4 * np.linalg.norm(d_ref)
    assert np.abs(d_got - d_ref).max() <= 5e-3 * np.abs(d_ref).max()
