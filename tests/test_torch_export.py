"""The serving export of the port (``paradis_torch.forecast.export``,
``cli.export``) against the model in process and the JAX package's artifact.

One toy artifact of each package (``torch_parity.build_pair``: the JAX
weights bridged into the port, one physics layer, 4 forecast steps, every
second one stored), traced with ``PARADIS_INTERP_CHUNK=4`` set: the port's
loaded programs bitwise against its model and ``make_forecast_rollout``, and
within ``ATOL`` of the JAX package's loaded artifact on the same seeded
numpy inputs; the manifest's shared keys equal to the JAX manifest's; what
the trace fixed; another checkpoint's ``params.npz`` served by the same
programs; the checks that run before any file is written
(``tests/test_torch_export_cli.py`` holds ``cli.export`` and a serving
process without the model).
"""

import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from paradis_torch.forecast import make_forecast_rollout  # noqa: E402
from paradis_torch.forecast.export import (  # noqa: E402
    FORMAT,
    _check_device,
    _flatten_params,
    _unflatten_params,
    export_forward,
    load_artifact,
    save_artifact,
)
from paradis_torch.tools.bench_artifact import step_loop  # noqa: E402
from paradis_tpu.forecast.export import load_artifact as jax_load_artifact  # noqa: E402
from paradis_tpu.forecast.export import save_artifact as jax_save_artifact  # noqa: E402
from torch_parity import NLAT, NLON, as_f32, build_pair  # noqa: E402

STEPS, OUT_FREQ = 4, 2
CHUNK = "4"   # PARADIS_INTERP_CHUNK while the artifact is traced
# the rollout's gap between the packages (tests/test_torch_rollout.py: 10× its
# measured 5e-7), which also bounds one forward step's
ATOL = 5e-6
SHARED_KEYS = ("input_shape", "output_shape", "dtype", "n_common", "n_time", "feature_names")


@pytest.fixture(scope="module")
def pair():
    return build_pair("model.num_layers=1", f"model.forecast_steps={STEPS}",
                      f"forecast.output_frequency={OUT_FREQ}")


def _kwargs(pair, **more):
    names = [f"out{i}" for i in range(pair.output_dim)]
    return dict(dict(batch_size=1, nlat=NLAT, nlon=NLON, input_dim=pair.input_dim,
                     output_dim=pair.output_dim, n_common=pair.n_common,
                     feature_names=names), **more)


@pytest.fixture(scope="module")
def exported(pair, tmp_path_factory):
    """The port's artifact, traced with PARADIS_INTERP_CHUNK set and one
    parameter frozen by the caller; the flags after the export."""
    frozen = pair.model.layers[0].alpha_adv
    frozen.requires_grad_(False)
    old = os.environ.get("PARADIS_INTERP_CHUNK")
    os.environ["PARADIS_INTERP_CHUNK"] = CHUNK
    try:
        art = save_artifact(tmp_path_factory.mktemp("torch_art") / "art", pair.model,
                            pair.cfg, **_kwargs(pair))
    finally:
        if old is None:
            os.environ.pop("PARADIS_INTERP_CHUNK")
        else:
            os.environ["PARADIS_INTERP_CHUNK"] = old
    flags = {n: p.requires_grad for n, p in pair.model.named_parameters()}
    frozen.requires_grad_(True)
    return art, flags


@pytest.fixture(scope="module")
def serving(exported):
    return load_artifact(exported[0])


@pytest.fixture(scope="module")
def jax_serving(pair, tmp_path_factory):
    art = jax_save_artifact(tmp_path_factory.mktemp("jax_art") / "art", pair.jax_model,
                            pair.params, pair.jax_cfg, **_kwargs(pair))
    return jax_load_artifact(art)


def _batch(serving, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    shapes = serving.manifest["rollout"]["input_shapes"]
    return {k: rng.normal(size=shapes[k]).astype(np.float32)
            for k in ("input", "forcings", "constants")}


def _x(pair, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(1, NLAT, NLON, pair.input_dim)).astype(
        np.float32)


def test_flat_params_round_trip(pair, exported):
    flat = _flatten_params(pair.model)
    named = dict(pair.model.named_parameters())
    assert list(flat) == list(named)
    back = _unflatten_params(flat)
    for name, p in named.items():
        assert flat[name].dtype == np.float32
        assert back[name].dtype == torch.float32 and torch.equal(back[name], p.detach())
    with np.load(exported[0] / "params.npz") as npz:
        assert list(npz.files) == list(named)
        for name in named:
            np.testing.assert_array_equal(npz[name], flat[name])


def test_loaded_forward_is_bitwise_the_model_and_close_to_jax(pair, serving, jax_serving):
    x = _x(pair)
    got = serving(torch.from_numpy(x))
    with torch.no_grad():
        want = pair.model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(
        serving.manifest["output_shape"])
    assert torch.equal(got, want)
    np.testing.assert_allclose(as_f32(got), as_f32(jax_serving(jnp.asarray(x))), atol=ATOL,
                               rtol=0)


def test_loaded_rollout_is_bitwise_the_rollout_and_close_to_jax(pair, serving, jax_serving):
    assert serving.has_rollout
    b = _batch(serving)
    got = serving.rollout(*(torch.from_numpy(b[k]) for k in ("input", "forcings", "constants")))
    want = make_forecast_rollout(pair.model, pair.cfg)(
        {k: torch.from_numpy(v) for k, v in b.items()}, pair.n_common)
    assert tuple(got.shape) == tuple(serving.manifest["rollout"]["output_shape"])
    assert got.shape[1] == len(range(0, STEPS, OUT_FREQ))
    assert torch.equal(got, want)
    ref = jax_serving.rollout(*(jnp.asarray(b[k]) for k in ("input", "forcings", "constants")))
    np.testing.assert_allclose(as_f32(got), as_f32(ref), atol=ATOL, rtol=0)


class _CountInterp(TorchDispatchMode):
    """Counts the calls of ``paradis::interp`` under it."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls += func is torch.ops.paradis.interp.default
        return func(*args, **(kwargs or {}))


def test_loaded_programs_interpolate_once_a_layer_and_step(pair, serving):
    """The loaded rollout runs its scan body once a step (``_scan_loop``:
    torch 2.11's own eager scan runs it once more), the forward once."""
    b = {k: torch.from_numpy(v) for k, v in _batch(serving).items()}
    layers = len(pair.model.layers)
    with _CountInterp() as count:
        serving.rollout(b["input"], b["forcings"], b["constants"])
    assert count.calls == layers * STEPS
    with _CountInterp() as count:
        serving(torch.from_numpy(_x(pair)))
    assert count.calls == layers


def test_model_free_step_loop_autoregresses_like_the_rollout(pair, serving):
    """``forward.pt2`` a step at a time with the manifest's n_common / n_time
    (``bench_artifact.step_loop``) gives the in-process rollout's steps."""
    b = _batch(serving, seed=2)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    got = step_loop(serving, batch)
    want = make_forecast_rollout(pair.model, pair.cfg)(batch, pair.n_common)
    assert got.shape[1] == STEPS
    assert torch.equal(got[:, ::OUT_FREQ], want)


def test_manifest_shares_the_jax_keys(pair, serving, jax_serving):
    m, jm = serving.manifest, jax_serving.manifest
    for key in SHARED_KEYS:
        assert m[key] == jm[key], key
    # the rollout block, but for its file's name (rollout.shlo there)
    assert dict(m["rollout"], file=None) == dict(jm["rollout"], file=None)
    assert m["format"] == FORMAT and m["device"] == "cpu" and m["torch_version"]
    assert m["rollout"]["file"] == "rollout.pt2" and "rollout.pt2" in m["serving_note"]
    assert "latent_size" in m["config_yaml"]
    assert m["traced"]["advection_impl"] == "auto" and m["traced"]["interpolation"] == "bicubic"
    assert set(m["export_seconds"]) == {"forward", "rollout"}
    assert m["parameter_names"] == [n for n, _ in pair.model.named_parameters()]


def test_programs_take_the_parameters_and_own_no_copy(pair, exported):
    """``params.npz`` is the one copy of the weights: each program has no
    state of its own and keeps no example inputs, its constants are the
    grids ``lat_grid`` / ``lon_grid`` and its last input is the parameters."""
    grids = pair.model.lat_grid.numel() + pair.model.lon_grid.numel()
    for name in ("forward.pt2", "rollout.pt2"):
        ep = torch.export.load(exported[0] / name)
        assert ep.state_dict == {} and ep.example_inputs is None, name
        assert sum(t.numel() for t in ep.constants.values()) == grids, name
        n_params = len(list(pair.model.parameters()))
        user = [s for s in ep.graph_signature.input_specs
                if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
        assert len(user) == (1 if name == "forward.pt2" else 3) + n_params, name


def test_recording_the_programs_spans_leaves_the_exported_graph_as_it_is(pair):
    """The spans (``paradis_torch.utils.tracing``) are off while the export
    traces: a forward exported with recording on, annotations and all, is
    the graph exported with it off."""
    from paradis_torch.utils.tracing import recording

    def graph():
        ep = export_forward(pair.model, batch_size=1, nlat=NLAT, nlon=NLON,
                            input_dim=pair.input_dim)
        return str(ep.graph)

    off = graph()
    with recording(annotate=True) as spans:
        on = graph()
    assert on == off and not spans and "profiler" not in on


def test_export_takes_cuda_without_an_index_as_the_models_card(monkeypatch):
    """``cli.export``'s default ``--device cuda`` names the current card, the
    one the model was built on; another card or kind of device raises."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    model = SimpleNamespace(device=torch.device("cuda", 0))
    for device in ("cuda", "cuda:0", torch.device("cuda"), None):
        assert _check_device(model, device) == torch.device("cuda", 0)
    for device in ("cuda:1", "cpu"):
        with pytest.raises(ValueError, match="export on its device"):
            _check_device(model, device)


def test_export_restores_each_parameters_requires_grad(pair, exported):
    flags = exported[1]
    assert flags.pop("layers.0.alpha_adv") is False
    assert flags and all(flags.values())


def _interp_chunks(program: torch.nn.Module) -> set:
    """The chunk rows of every ``paradis::interp`` node of a loaded program,
    its scan body's included."""
    return {node.args[7] for gm in program.modules() if isinstance(gm, torch.fx.GraphModule)
            for node in gm.graph.nodes if node.target is torch.ops.paradis.interp.default}


def test_chunk_rows_are_fixed_at_export(pair, serving, monkeypatch):
    """``PARADIS_INTERP_CHUNK`` as it was at export is in the manifest and in
    the graphs; changing it after leaves the loaded programs alone."""
    traced = serving.manifest["traced"]
    assert traced["PARADIS_INTERP_CHUNK"] == CHUNK
    assert [op["chunk_rows"] for op in traced["interp_ops"]] == [int(CHUNK)]
    assert traced["interp_ops"][0]["count"] == len(pair.model.layers)
    assert _interp_chunks(serving._forward) == _interp_chunks(serving._rollout) == {int(CHUNK)}
    x = torch.from_numpy(_x(pair, seed=3))
    before = serving(x)
    monkeypatch.setenv("PARADIS_INTERP_CHUNK", "0")
    assert torch.equal(serving(x), before)


def test_one_export_serves_another_checkpoint(pair, exported, tmp_path):
    """``params.npz`` is what the loaded programs compute with."""
    art = tmp_path / "art"
    shutil.copytree(exported[0], art)
    other = build_pair("model.num_layers=1", f"model.forecast_steps={STEPS}",
                       f"forecast.output_frequency={OUT_FREQ}", seed=5).model
    np.savez(art / "params.npz", **_flatten_params(other))
    x = torch.from_numpy(_x(pair, seed=4))
    got = load_artifact(art)(x)
    with torch.no_grad():
        assert torch.equal(got, other(x)) and not torch.equal(got, pair.model(x))


def test_an_artifact_without_its_rollout_serves_the_forward(pair, exported, tmp_path):
    """``include_rollout=False``'s layout: no ``rollout.pt2``, no ``rollout``
    block in the manifest."""
    art = tmp_path / "art"
    shutil.copytree(exported[0], art, ignore=shutil.ignore_patterns("rollout.pt2"))
    manifest = json.loads((art / "manifest.json").read_text())
    del manifest["rollout"], manifest["serving_note"]
    (art / "manifest.json").write_text(json.dumps(manifest))
    serving = load_artifact(art)
    assert not serving.has_rollout
    x = torch.from_numpy(_x(pair, seed=6))
    with torch.no_grad():
        assert torch.equal(serving(x), pair.model(x))
    with pytest.raises(ValueError, match="no rollout.pt2"):
        serving.rollout(x, x, x)


@pytest.mark.parametrize("bad", [
    {"nlat": NLAT * 2}, {"output_dim": 7}, {"input_dim": 5}, {"n_common": 0},
    {"feature_names": ["a", "b"]}, {"batch_size": 0},
])
def test_a_check_fails_before_the_directory_exists(pair, tmp_path, bad):
    out = tmp_path / "never" / "art"
    with pytest.raises(ValueError):
        save_artifact(out, pair.model, pair.cfg, **_kwargs(pair, **bad))
    assert not (tmp_path / "never").exists()


def test_loading_refuses_another_kind_of_device_and_batches_elsewhere(pair, exported,
                                                                     serving):
    with pytest.raises(ValueError, match="traced on cpu"):
        load_artifact(exported[0], device="meta")
    x = torch.zeros(serving.manifest["input_shape"], device="meta")
    with pytest.raises(ValueError, match="is on meta"):
        serving(x)
    b = {k: torch.from_numpy(v) for k, v in _batch(serving).items()}
    with pytest.raises(ValueError, match="forcings is on meta"):
        serving.rollout(b["input"], b["forcings"].to("meta"), b["constants"])
