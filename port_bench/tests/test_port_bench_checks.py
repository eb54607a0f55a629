"""``correct`` comes out false where the timed path is broken or computed a
step lower in precision: a run of a small cell on the CPU (the harness's
look for a card skipped) with a fault planted in the program, and the
control of each cell."""

from __future__ import annotations

import contextlib
import json
import sys
import types

import pytest
import torch

from port_bench.calibrate import half_batch
from port_bench.modes import forecast as forecast_mode
from port_bench.modes import train as train_mode
from port_bench.modes.common import Context
from port_bench.run import FORBIDDEN, print_result, run_cell
from port_bench.tests.small import small

SEED = 2 ** 31 + 4242
# the small cells: each cell's traffic at its own batch, cut in size
SMALL = {"train-1.40625deg-b1": dict(pool=3),
         "forecast-1.40625deg-b1": dict(pool=2, steps=3)}
# a cell's files under batched traffic, for the faults that only a batch can have
BATCHED = {"train-1.40625deg-b1": dict(batch=4, pool=3, reference_micro=2),
           "forecast-1.40625deg-b1": dict(batch=4, pool=8, steps=3, checked_members=4)}
TRAIN = [c for c in SMALL if c.startswith("train")]
FORECAST = [c for c in SMALL if c.startswith("forecast")]


@contextlib.contextmanager
def unchanged_state():
    """The optimizer step leaves the parameters as they were."""
    from paradis_torch.train.optim import ParadisOptimizer

    step = ParadisOptimizer.step
    ParadisOptimizer.step = lambda self: None
    try:
        yield
    finally:
        ParadisOptimizer.step = step


@contextlib.contextmanager
def frozen_rollout():
    """The rollout's lag shift returns its input: every step repeats the first."""
    from paradis_torch.forecast import rollout

    shift = rollout.autoregress_next_input
    rollout.autoregress_next_input = lambda dyn, out, n_common, n_time: dyn
    try:
        yield
    finally:
        rollout.autoregress_next_input = shift


@contextlib.contextmanager
def output_hook(change):
    """``change(out)`` replaces each forward's output of every Paradis model."""
    from paradis_torch.model import Paradis

    forward = Paradis.forward
    Paradis.forward = lambda self, x: change(forward(self, x))
    try:
        yield
    finally:
        Paradis.forward = forward


def _half(out):
    n = out.shape[0] // 2
    return torch.cat([out[:n], out[:n]]) if n else out


def _altered(out):
    out = out.clone()
    out[:, 1, 2, 3] += 10.0
    return out


def _run(cell, traffic=SMALL):
    wl = small(cell, **traffic[cell])
    return run_cell(cell, SEED, 0.3, False, device="cpu", workload_data=wl)


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", list(BATCHED))
def test_sound_batched_run_is_correct(cell):
    res = _run(cell, BATCHED)
    assert res["correct"], res["checks"]


FAULTS = [(c, "unchanged", unchanged_state, SMALL) for c in TRAIN]
FAULTS += [("train-1.40625deg-b1", "half_batch", half_batch, BATCHED)]
FAULTS += [(c, "unchanged", frozen_rollout, SMALL) for c in FORECAST]
FAULTS += [("forecast-1.40625deg-b1", "half_batch", lambda: output_hook(_half), BATCHED)]
FAULTS += [(c, "altered", lambda: output_hook(_altered), SMALL) for c in FORECAST]


@pytest.mark.parametrize("cell,name,fault,traffic", FAULTS,
                         ids=[f"{c}-{n}" for c, n, _, _ in FAULTS])
def test_faults_are_not_correct(cell, name, fault, traffic):
    with fault():
        res = _run(cell, traffic)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("planted", [False, True])
def test_a_module_loaded_by_the_check_leaves_no_result(planted, monkeypatch, capsys):
    """A forbidden module loaded after the window, here a stub ``jax`` that
    the check imports, makes the run exit 3 with no result line."""
    for name in list(sys.modules):
        if name.split(".", 1)[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    check = forecast_mode.Mode.check

    def loading(self, *args, **kwargs):
        if planted:
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return check(self, *args, **kwargs)

    monkeypatch.setattr(forecast_mode.Mode, "check", loading)
    res = _run("forecast-1.40625deg-b1")
    capsys.readouterr()
    code = print_result(res)
    out, err = capsys.readouterr()
    if planted:
        assert code == 3 and out == "" and "jax" in err
    else:
        assert code == 0 and json.loads(out.splitlines()[-1])["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_train_control_is_not_correct(cell):
    """The reference in float8, in the program's place, fails a limit."""
    wl = small(cell, **SMALL[cell])
    mode = train_mode.Mode(Context(wl, SEED, "cpu"))
    mode.setup()
    mode.release()
    got = mode.check("control")
    limits = wl["cell"]["limits"]
    assert any(got[k] > v for k, v in limits.items()), (got, limits)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", FORECAST)
def test_forecast_control_is_not_correct(cell):
    """The program with TF32 on fails the limit (a card only has TF32)."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists on a CUDA card only")
    from port_bench import cell as cells
    from port_bench.calibrate import readings

    wl = cells.load(cell)
    wl["traffic"]["steps"] = 4
    got, _ = readings(wl, SEED, "control")
    assert got["rollout_gap"] > wl["cell"]["limits"]["rollout_gap"], got
