"""The port's spatial ``(lat, space)`` grid of ranks (``paradis_torch/distributed.py``)
on the CPU: its units in one process, and one spatial train step against the
JAX package's mesh step.

* the rank order of ``create_mesh``'s ``reshape(data, lat, space)``, the
  blocks of a grid, its process groups' ranks (the spatial groups, space
  rows, lat columns and data groups) and the settings that do not fit (a
  world-size mismatch, a grid the factors do not divide, a pad a block
  cannot hold);
* FSDP over a spatial grid (``DataParallel(fsdp=True, grid=...)``): the
  owners, data indices, are the same at every spatial position; a
  downsample stride that does not start every block runs, and
  ``RankGrid.fit`` collapses the axes that do not divide a coarse grid;
* the shares of distributed NorMuon (``RankGrid.ns_share``, the rule of
  ``paradis_tpu/distributed.py:96-111``) and of the AMSE transform's
  channels (``RankGrid.spectral_share``, ``:116-157``), and the log of a
  Newton–Schulz stack that no axis divides;
* four ranks over gloo on ``127.0.0.1`` (``tests/torch_rank_worker.py``,
  ``compute.lat_devices=2 compute.spatial_devices=2``, each rank its block of
  the global batch of 2, the bridged weights of ``torch_parity.py``'s TINY
  pair, NorMuon with float32 Newton–Schulz) against the JAX
  ``make_train_step`` on ``create_mesh(data=1, lat=2, space=2)`` over four
  of the conftest's virtual CPU devices, for 2 steps, held to
  ``test_two_rank_train_steps_match_the_jax_data_mesh``'s limits: losses and
  gradient norms within rtol 1e-5, the parameters' total update within 2e-4
  (Frobenius) and 5e-3 (each element, of the largest update).  The mesh step
  is this file's one JAX compile (~40 s; the ranks run beside it).
"""

import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import logging  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from paradis_torch import distributed  # noqa: E402
from paradis_torch.config import load_config  # noqa: E402
from paradis_torch.sphere.partition import RankGrid, spatial_rules  # noqa: E402
from paradis_torch.model.weights import flax_to_state  # noqa: E402
from torch_parity import TINY, build_pair  # noqa: E402
from torch_rank_worker import ROOT, launch  # noqa: E402

RTOL = 1e-5
STEPS = 2


# -- the grid ------------------------------------------------------------------------

def test_ranks_take_the_places_of_create_mesh():
    """``rank = (d·lat + l)·space + s``: the order of
    ``np.asarray(devices).reshape(data, lat, space)``."""
    places = np.arange(2 * 2 * 3).reshape(2, 2, 3)
    for d, l, s in np.ndindex(2, 2, 3):
        grid = RankGrid(2, 2, 3, d, l, s)
        assert places[d, l, s] == (d * 2 + l) * 3 + s
        assert grid.spatial_index == l * 3 + s and grid.lead == (l == 0 and s == 0)


def test_a_block_is_the_ranks_rows_and_columns():
    x = np.arange(2 * 8 * 12 * 3).reshape(2, 8, 12, 3)
    blocks = [[RankGrid(1, 2, 3, 0, l, s).block(x) for s in range(3)] for l in range(2)]
    assert blocks[1][2].shape == (2, 4, 4, 3)
    np.testing.assert_array_equal(np.concatenate([np.concatenate(r, axis=2) for r in blocks],
                                                 axis=1), x)
    assert RankGrid(1, 2, 3, 0, 1, 2).block_shape(8, 12) == (4, 4)
    with pytest.raises(ValueError, match="latitudes do not split"):
        RankGrid(1, 3, 1).rows(8)
    with pytest.raises(ValueError, match="longitudes do not split"):
        RankGrid(1, 1, 5).cols(12)


@pytest.mark.parametrize("override", ["compute.lat_devices=2", "compute.spatial_devices=3",
                                      "compute.num_devices=2"])
def test_a_grid_that_does_not_fit_the_launch_raises(override):
    with pytest.raises(ValueError, match="multi-GPU"):
        distributed.fit_check(load_config(overrides=[override]))


def test_the_process_groups_take_the_ranks_of_create_mesh():
    """Each group's ranks are a line of ``reshape(data, lat, space)``: the
    spatial group a ``d``'s plane, the space row an ``(d, l)``'s, the lat
    column a ``(d, s)``'s, the data group an ``(l, s)``'s, in that order,
    and ``RankGrid.rank_of`` is a data group's member at the rank's place."""
    places = np.arange(2 * 2 * 3).reshape(2, 2, 3)
    groups = distributed.grid_group_ranks(2, 2, 3)
    assert groups["spatial"] == [places[d].ravel().tolist() for d in range(2)]
    assert groups["rows"] == [places[d, l].tolist() for d in range(2) for l in range(2)]
    assert groups["cols"] == [places[d, :, s].tolist() for d in range(2) for s in range(3)]
    assert groups["data"] == [places[:, l, s].tolist() for l in range(2) for s in range(3)]
    for d, l, s in np.ndindex(2, 2, 3):
        grid = RankGrid(2, 2, 3, d, l, s)
        assert [grid.rank_of(k) for k in range(2)] == places[:, l, s].tolist()


def test_fsdp_over_a_spatial_grid_raises():
    """No longer raises: ``DataParallel(fsdp=True)`` on a ``data 2 × lat 2 ×
    space 2`` grid shards over the data group, the owning data index of
    each parameter the same at every ``(l, s)``, each parameter owned once
    a data group; with one data rank the layout is replicated."""
    from paradis_torch.tools.bench_artifact import flagship

    net, _ = flagship(load_config(overrides=TINY), (8, 16), "cpu")
    names = {n for n, p in net.named_parameters() if p.requires_grad}
    owners, owned = set(), {}
    for d, l, s in np.ndindex(2, 2, 2):
        model, _ = flagship(load_config(overrides=TINY), (8, 16), "cpu")
        par = distributed.DataParallel(model, fsdp=True, grid=RankGrid(2, 2, 2, d, l, s))
        assert par.fsdp and par.grid.spatial == 4
        owners.add(tuple(sorted(par.owner.items())))
        owned.setdefault(d, set()).add(frozenset(par.owned_names()))
        # released: a rank holds only the parameters it owns
        held = {n for n, p in model.named_parameters() if p.numel()}
        assert held == par.owned_names()
    assert len(owners) == 1
    assert all(len(v) == 1 for v in owned.values())
    a, b = (next(iter(owned[d])) for d in (0, 1))
    assert a and b and not a & b and a | b == names
    one = distributed.DataParallel(flagship(load_config(overrides=TINY), (8, 16), "cpu")[0],
                                   fsdp=True, grid=RankGrid(1, 2, 2, 0, 1, 0))
    assert not one.fsdp and one.owned_names() == names


@pytest.mark.parametrize("grid,coarse,want,group", [
    # (data, lat, space), the coarse grid, the processor's (lat, space), its group
    ((1, 2, 2), (8, 8), (2, 2), "spatial"),     # 22 x 24, s = 3: coarse rows 4 + 4
    ((2, 2, 1), (3, 4), (1, 1), None),          # 8 x 12, s = 3 on lat 2: rows undivided
    ((1, 1, 4), (4, 6), (1, 1), None),          # 8 x 12, s = 2 on space 4
    ((1, 2, 2), (3, 4), (1, 2), "row"),         # 8 x 12, s = 3: lat collapsed
    ((1, 2, 3), (6, 4), (2, 1), "col"),         # 16 x 12, s = 3: space collapsed
])
def test_the_processor_grid_collapses_the_axes_that_do_not_divide_the_coarse_grid(
        grid, coarse, want, group):
    groups = {"spatial": object(), "row": object(), "col": object(), "data": object()}
    data, lat, space = grid
    for d, l, s in np.ndindex(*grid):
        g = RankGrid(data, lat, space, d, l, s, groups["spatial"], groups["row"],
                     groups["col"], groups["data"])
        proc = g.fit(*coarse)
        assert (proc.lat, proc.space) == want
        assert proc.spatial_group is (groups[group] if group else None)
        assert proc.data_group is groups["data"] and proc.d == d
        assert (proc.l, proc.s) == (l if want[0] > 1 else 0, s if want[1] > 1 else 0)
        h, w = coarse[0] // proc.lat, coarse[1] // proc.space
        assert proc.block_shape(*coarse) == (h, w)


def test_a_pad_a_block_cannot_hold_and_an_unaligned_stride_raise(monkeypatch):
    """The pads a block cannot hold raise.  A downsample stride that does not
    start every block runs: the block's field gathered whole (here, with no
    other rank, the ``all_reduce`` leaves the other blocks zero),
    downsampled whole and cut to the block of ``RankGrid.fit``'s grid of
    the coarse field (3 × 4: ``lat`` collapsed, ``space`` kept)."""
    from paradis_torch.ops.blocks import PhysicalDownsample
    from paradis_torch.sphere.padding import geocyclic_pad

    with spatial_rules(RankGrid(1, 2, 2)):
        with pytest.raises(ValueError, match="pad \\+ 1 <= H/lat_devices"):
            geocyclic_pad(torch.zeros(1, 3, 8, 1), 3)
        with pytest.raises(ValueError, match="pad <= W/spatial_devices"):
            geocyclic_pad(torch.zeros(1, 8, 2, 1), 3)
    monkeypatch.setattr(torch.distributed, "all_reduce", lambda t, group=None: None)
    x = torch.randn(1, 6, 8, 1, generator=torch.Generator().manual_seed(0))
    with spatial_rules(RankGrid(1, 2, 2, 0, 1, 1)):
        got = PhysicalDownsample(stride=4)(x)
    whole = torch.zeros(1, 12, 16, 1)
    whole[:, 6:, 8:] = x
    want = PhysicalDownsample(stride=4)(whole)
    assert want.shape == (1, 3, 4, 1) and got.shape == (1, 3, 2, 1)
    assert torch.equal(got, want[:, :, 2:])


@pytest.mark.parametrize("sizes,n,want", [
    # (data, lat, space), stack, (ways, axes)
    ((2, 2, 2), 8, (8, ["data", "lat", "space"])),
    ((2, 2, 2), 4, (4, ["data", "lat"])),
    ((3, 2, 2), 4, (4, ["lat", "space"])),
    ((2, 1, 1), 3, (1, [])),
    ((1, 2, 3), 6, (6, ["lat", "space"])),
])
def test_the_ns_share_takes_the_axes_that_divide_the_stack(sizes, n, want):
    data, lat, space = sizes
    seen = {}
    for d, l, s in np.ndindex(*sizes):
        ways, index, lead, axes = RankGrid(data, lat, space, d, l, s).ns_share(n)
        assert (ways, axes) == want and 0 <= index < ways
        seen.setdefault(index, []).append(lead)
    # every share is computed, each by one lead copy
    assert sorted(seen) == list(range(want[0]))
    assert all(v.count(True) == 1 for v in seen.values())


@pytest.mark.parametrize("sizes,channels,want", [
    ((2, 2), 6, 2),   # lat divides, lat × space does not
    ((2, 2), 8, 4),
    ((8, 1), 6, 1),   # nothing divides: the whole field on every rank
    ((1, 3), 6, 3),
])
def test_the_spectral_share_splits_the_channels_over_the_axes_that_divide_them(
        sizes, channels, want):
    lat, space = sizes
    shares = {RankGrid(1, lat, space, 0, l, s).spectral_share(channels)
              for l, s in np.ndindex(lat, space)}
    assert {w for w, _ in shares} == {want} and {i for _, i in shares} == set(range(want))


def test_a_stack_that_no_axis_divides_stays_whole_and_logs(caplog):
    """Three physics layers on two data ranks: each layer-stacked group of 3
    matrices stays whole on every rank, and the optimizer says so once."""
    from paradis_torch.tools.bench_artifact import flagship
    from paradis_torch.train.optim import ParadisOptimizer

    net, _ = flagship(load_config(overrides=TINY + ["model.num_layers=3"]), (8, 16), "cpu")
    with caplog.at_level(logging.INFO, logger="paradis_torch"):
        opt = ParadisOptimizer(net, name="normuon", lr=1e-3, weight_decay=0.0,
                               betas=(0.9, 0.95), grid=RankGrid(2, 1, 1, 1))
    shares = {len(g.params): g.share[0] for g in opt.muon_groups}
    assert shares[3] == 1
    assert "NS stack of 3 matrices shards 1-way over [] (2 ranks" in caplog.text


# -- the spatial step against the JAX (1, 2, 2) mesh step -----------------------------

def _batches(pair, n, seed=1):
    rng = np.random.default_rng(seed)
    H, W = 8, 16
    shapes = {"input": (2, H, W, pair.n_common * pair.n_time),
              "target": (2, 1, H, W, pair.output_dim),
              "forcings": (2, 1, H, W, pair.n_forcings * pair.n_time),
              "constants": (2, H, W, pair.n_const)}
    return [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
            for _ in range(n)]


def test_a_lat_space_step_matches_the_jax_lat_space_mesh(tmp_path):
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
                                      "compute.use_amp=false", "compute.lat_devices=2",
                                      "compute.spatial_devices=2"],
                "device": "cpu", "grid": [8, 16]}
    wait = launch([sys.executable, str(ROOT / "tests" / "torch_rank_worker.py"),
                   str(tmp_path / "in.npz"), str(tmp_path / "out.npz"), json.dumps(settings)],
                  world=4, timeout=240)

    # the JAX step on a (data 1, lat 2, space 2) mesh while the ranks run
    mesh = create_mesh(data=1, lat=2, space=2, devices=jax.devices()[:4])
    lat, _ = equiangular_lat_lon(8, 16, include_poles=False)
    jloss = JaxWeightedLoss.from_config(pair.jax_cfg, lat, dyn_output_features(pair.cfg.features),
                                        nlon=16)
    jopt = jax_build_optimizer(pair.jax_cfg, pair.params)
    jstep, _ = jax_make_train_step(pair.jax_model, jloss, pair.jax_cfg, jopt, donate=False,
                                   mesh=mesh)
    jstate = replicate(jax_create_train_state(pair.params, jopt), mesh)
    want = {"loss": [], "grad_norm": []}
    with mesh:
        for b in batches:
            jstate, jm = jstep(jstate, shard_batch({k: jnp.asarray(v) for k, v in b.items()},
                                                   mesh), pair.n_common)
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
