"""Serving artifacts of the trained model (``torch.export``).

Port of ``paradis_tpu/forecast/export.py``.  The JAX package serializes the
jitted forward step as StableHLO; here ``torch.export`` traces the forward
(and the scanned rollout) to an ``ExportedProgram`` of ATen ops and the
port's custom ops (``paradis::interp``, ``paradis::interp_dense``,
``paradis::departure_positions``), so a serving process runs forecasts on
the hand-written kernels **without the model code**: it imports only the
modules that register those ops.

Artifact layout (a directory):

    forward.pt2    ``torch.export.save`` of one forward step
                   ``x[B,H,W,Cin] -> y[B,H,W,Cout]`` (float32, the forecast
                   configuration)
    rollout.pt2    the K-step rollout ``(input[B,H,W,dyn], forcings[B,K,H,W,F],
                   constants[B,H,W,K']) -> stored [B,T,H,W,Cout]``: one
                   ``scan`` (``torch._higher_order_ops``) over the forcings'
                   time axis around ``forecast.rollout.forecast_step``, the
                   body traced once
    params.npz     the parameters under their ``named_parameters`` names
                   (the names of ``train/checkpoint.py``'s files)
    manifest.json  shapes, dtype, feature bookkeeping (n_common, n_time),
                   torch/CUDA versions, the device, what the trace fixed
                   (advection impl, band plan, chunk rows, interpolation
                   mode) and the full config YAML

Shapes are static, as in the JAX package: one artifact per serving batch
size.  The programs are traced on the device they serve on and hold its
device in their graphs (``manifest["device"]``): an artifact for several
devices is not made.  Both programs take the parameters as their last
input (a tuple in ``manifest["parameter_names"]`` order) and own no copy of
them: ``params.npz`` is the only one, what the loaded programs compute
with, so one export serves any checkpoint of the same architecture.  The
derived buffers ``lat_grid`` / ``lon_grid`` are constants of the graphs.
A loaded rollout runs its ``scan`` node as a loop of the body, once a step
(``_scan_loop``).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn
from torch._higher_order_ops.scan import scan_op
from torch.func import functional_call

FORMAT = "paradis_torch.export.v1"
_FORWARD_FILE = "forward.pt2"
_ROLLOUT_FILE = "rollout.pt2"
_PARAMS_FILE = "params.npz"
_MANIFEST_FILE = "manifest.json"


def _flatten_params(model: nn.Module) -> dict[str, np.ndarray]:
    """The parameters as float32 numpy arrays under their
    ``named_parameters`` names (the layout of ``params.npz``)."""
    return {name: p.detach().cpu().numpy() for name, p in model.named_parameters()}


def _unflatten_params(flat, device=None) -> dict[str, torch.Tensor]:
    """``params.npz``'s arrays (a mapping or an open ``NpzFile``) as tensors on
    ``device``, under the same names."""
    return {name: torch.from_numpy(np.ascontiguousarray(flat[name])).to(device)
            for name in flat}


def _params_npz(model: nn.Module) -> bytes:
    """The bytes of ``params.npz``, after checking that every parameter comes
    back from them under its name with its shape, dtype and values."""
    flat = _flatten_params(model)
    bad = sorted(name for name, a in flat.items() if a.dtype != np.float32)
    if bad:
        raise ValueError(f"parameters must be float32 to serve; not so: {bad}")
    buf = io.BytesIO()
    np.savez(buf, **flat)
    buf.seek(0)
    with np.load(buf) as npz:
        back = _unflatten_params(npz)
    if list(back) != list(flat) or any(
            tuple(back[n].shape) != flat[n].shape or back[n].dtype != torch.float32
            or not np.array_equal(back[n].numpy(), flat[n]) for n in flat):
        raise ValueError("parameters do not round-trip through the flat npz layout; "
                         "refusing to write a broken artifact")
    return buf.getvalue()


@contextlib.contextmanager
def _frozen(model: nn.Module):
    """Parameters without ``requires_grad`` and grad mode off for a trace: the
    programs are the inference path (``Paradis.forward`` takes its
    gradient-checkpointing branch only with grad enabled) and record no
    autograd state.  Each parameter's flag is restored after."""
    flags = [(p, p.requires_grad) for p in model.parameters()]
    try:
        for p, _ in flags:
            p.requires_grad_(False)
        with torch.no_grad():
            yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def _graph_modules(ep):
    return [m for m in ep.graph_module.modules() if isinstance(m, torch.fx.GraphModule)]


def _export(module: nn.Module, model: nn.Module, args: tuple):
    """``torch.export`` of ``module(*args)`` with ``model``'s parameters
    frozen, without its example inputs (the parameters among them: the
    weights again) and the nodes' stack traces (the exporting process's
    Python stacks, which serving does not read: a third of a toy rollout's
    file)."""
    with _frozen(model):
        ep = torch.export.export(module, args, strict=False)
    ep.example_inputs = None
    for gm in _graph_modules(ep):
        for node in gm.graph.nodes:
            node.meta.pop("stack_trace", None)
    return ep


def _indexed(device) -> torch.device:
    """``device`` with its index: ``cuda`` alone names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _check_device(model, device) -> torch.device:
    if device is not None and _indexed(device) != model.device:
        raise ValueError(f"the model is on {model.device}; export on its device, not {device}")
    return model.device


def _param_inputs(model: nn.Module) -> tuple:
    """The programs' last input: the parameters in ``named_parameters`` order."""
    return tuple(p.detach() for p in model.parameters())


class _Lifted(nn.Module):
    """Holds ``model`` without registering it, so that an exported program
    owns none of its parameters: they come in as an input and
    ``functional_call`` computes with them.  The model's buffers are the
    wrapper's, non-persistent: constants of the graph."""

    def __init__(self, model):
        super().__init__()
        object.__setattr__(self, "model", model)
        self.names = [name for name, _ in model.named_parameters()]
        self.buffer_names = []
        for i, (name, buf) in enumerate(model.named_buffers()):
            self.register_buffer(f"buffer{i}", buf, persistent=False)
            self.buffer_names.append(name)

    def state(self, params) -> dict:
        """The model's parameters and buffers by name, the parameters
        ``params``."""
        return {**dict(zip(self.names, params)), **dict(zip(self.buffer_names, self.buffers()))}


class _Forward(_Lifted):
    """``(x, params) -> model(x)`` computed with ``params``."""

    def forward(self, x, params):
        return functional_call(self.model, self.state(params), (x,))


def export_forward(model, batch_size: int, nlat: int, nlon: int, input_dim: int,
                   device=None):
    """``torch.export.ExportedProgram`` of ``model(x)``, ``x`` [B, H, W, C_in]
    float32 on ``device`` (the model's), the parameters its second input
    (``_Forward``).  Shapes are static: export one artifact per serving
    batch size."""
    device = _check_device(model, device)
    x = torch.zeros((batch_size, nlat, nlon, input_dim), dtype=torch.float32, device=device)
    return _export(_Forward(model), model, (x, _param_inputs(model)))


class ScannedRollout(_Lifted):
    """``(input, forcings, constants, params) -> stored [B, T, H, W, C_out]``
    float32: ``make_forecast_rollout``'s function as one ``scan`` over the
    forcings' time axis around ``forecast_step``, then every
    ``output_frequency``-th output (``paradis_tpu/forecast/rollout.py``'s
    ``lax.scan``).

    The body takes the constants and the model's parameters and buffers as
    explicit inputs (``functional_call``) and calls the ``scan`` operator
    itself: torch's ``scan`` wrapper lifts a body's closures with a dynamo
    pass over it, which made the flagship's trace 1.7× as long (42.2 s
    against 24.9 s on a CPU)."""

    def __init__(self, model, num_common: int, n_time_inputs: int, output_frequency: int):
        super().__init__(model)
        self.num_common = num_common
        self.n_time = n_time_inputs
        self.out_freq = output_frequency

    def forward(self, dyn, forcings, constants, params):
        from paradis_torch.forecast.rollout import forecast_step

        constants = constants.expand(dyn.shape[0], *constants.shape[1:])
        names, tensors = zip(*self.state(params).items())

        def body(dyn, forcing_t, constants, *state):
            def model(x):
                return functional_call(self.model, dict(zip(names, state)), (x,))

            nxt, out = forecast_step(model, dyn, forcing_t, constants, self.num_common,
                                     self.n_time)
            # the carry may view the output (n_time 1); scan takes no aliasing
            return [nxt, out.clone()]

        _, outs = scan_op(body, [dyn], [forcings.movedim(1, 0)],
                          (constants, *tensors))
        return outs[::self.out_freq].movedim(0, 1).float()


def export_rollout(model, cfg, *, batch_size: int, nlat: int, nlon: int, n_common: int,
                   dyn_dim: int, forcing_dim: int, const_dim: int, device=None):
    """``torch.export.ExportedProgram`` of the ``cfg.model.forecast_steps``-step
    scanned rollout (``ScannedRollout``), its inputs float32 on ``device``, the
    parameters its last: one call forecasts K steps, the body traced once
    whatever K."""
    device = _check_device(model, device)
    S = int(cfg.model.forecast_steps)
    module = ScannedRollout(model, n_common, int(cfg.dataset.n_time_inputs),
                            int(cfg.forecast.output_frequency))
    args = tuple(torch.zeros(shape, dtype=torch.float32, device=device) for shape in (
        (batch_size, nlat, nlon, dyn_dim), (batch_size, S, nlat, nlon, forcing_dim),
        (batch_size, nlat, nlon, const_dim)))
    return _export(module, model, (*args, _param_inputs(model)))


def _rollout_block(model, cfg, *, batch_size, nlat, nlon, input_dim, output_dim,
                   n_common) -> dict:
    """The manifest's ``rollout`` block (the JAX keys), its dims checked."""
    n_time = int(cfg.dataset.n_time_inputs)
    dyn_dim = int(n_common) * n_time
    forcing_dim = len(cfg.features.input.forcings) * n_time
    const_dim = input_dim - dyn_dim - forcing_dim
    S = int(cfg.model.forecast_steps)
    out_freq = int(cfg.forecast.output_frequency)
    if not 0 < n_common <= output_dim:
        raise ValueError(f"n_common {n_common} must be in 1..output_dim ({output_dim})")
    if const_dim != model.n_static:
        raise ValueError(f"input_dim {input_dim} - dyn {dyn_dim} - forcings {forcing_dim} "
                         f"leaves {const_dim} constants; the model takes {model.n_static}")
    if S < 1 or out_freq < 1:
        raise ValueError(f"forecast_steps ({S}) and output_frequency ({out_freq}) must be >= 1")
    return {
        "file": _ROLLOUT_FILE,
        "forecast_steps": S,
        "output_frequency": out_freq,
        "input_shapes": {
            "input": [batch_size, nlat, nlon, dyn_dim],
            "forcings": [batch_size, S, nlat, nlon, forcing_dim],
            "constants": [batch_size, nlat, nlon, const_dim],
        },
        "output_shape": [batch_size, len(range(0, S, out_freq)), nlat, nlon, output_dim],
    }


def traced_settings(ep, model) -> dict:
    """What the trace read and fixed in the graph: the advection impl, the
    interpolation ops' arguments (mode, plain, band plan, its row bound, chunk
    rows) with their count, and ``PARADIS_INTERP_CHUNK`` as it was."""
    calls: dict = {}
    dense = 0
    for gm in _graph_modules(ep):
        for node in gm.graph.nodes:
            if node.target is torch.ops.paradis.interp.default:
                mode, plain, band, max_dy, chunk = node.args[3:8]
                key = json.dumps({"mode": mode, "plain": plain, "band_plan": list(band) or None,
                                  "band_max_dy": max_dy if band else None,
                                  "chunk_rows": chunk})
                calls[key] = calls.get(key, 0) + 1
            elif node.target is torch.ops.paradis.interp_dense.default:
                dense += 1
    return {
        "advection_impl": model.layers[0].advection.impl,
        "interpolation": model.layers[0].advection.interpolation,
        "interp_ops": [dict(json.loads(k), count=n) for k, n in calls.items()],
        "interp_dense_ops": dense,
        "PARADIS_INTERP_CHUNK": os.environ.get("PARADIS_INTERP_CHUNK"),
    }


def save_artifact(out_dir, model, cfg, *, batch_size: int, nlat: int, nlon: int,
                  input_dim: int, output_dim: int, n_common: int,
                  feature_names: list[str] | None = None, device=None,
                  include_rollout: bool = True) -> Path:
    """Export and write the serving artifact directory; returns its path.

    Everything is checked, and both programs traced, before any file or
    directory is created: the parameters' round trip through ``params.npz``,
    ``nlat``/``nlon`` against the model's grid, ``input_dim``/``output_dim``
    against the model, ``feature_names`` against ``output_dim`` and the
    rollout block's dims.  ``include_rollout`` adds ``rollout.pt2`` (K =
    ``cfg.model.forecast_steps``), the file a forecast server should prefer
    (the manifest's ``serving_note``).  ``device`` defaults to the model's.
    """
    device = _check_device(model, device)
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if (nlat, nlon) != tuple(model.mesh_size):
        raise ValueError(f"nlat, nlon = {(nlat, nlon)}; the model's grid is {model.mesh_size}")
    if (input_dim, output_dim) != (model.input_dim, model.output_dim):
        raise ValueError(f"input_dim, output_dim = {(input_dim, output_dim)}; the model takes "
                         f"{(model.input_dim, model.output_dim)}")
    if model.dtype != torch.float32:
        raise ValueError(f"serve in float32 (compute.use_amp=false); the model computes in "
                         f"{model.dtype}")
    if feature_names is not None and len(feature_names) != output_dim:
        raise ValueError(f"{len(feature_names)} feature names for {output_dim} outputs")
    rollout = (_rollout_block(model, cfg, batch_size=batch_size, nlat=nlat, nlon=nlon,
                              input_dim=input_dim, output_dim=output_dim, n_common=n_common)
               if include_rollout else None)
    params = _params_npz(model)

    seconds = {}
    t0 = time.perf_counter()
    forward = export_forward(model, batch_size, nlat, nlon, input_dim, device)
    seconds["forward"] = time.perf_counter() - t0
    if rollout is not None:
        t0 = time.perf_counter()
        dims = {k: v[-1] for k, v in rollout["input_shapes"].items()}
        scanned = export_rollout(model, cfg, batch_size=batch_size, nlat=nlat, nlon=nlon,
                                 n_common=n_common, dyn_dim=dims["input"],
                                 forcing_dim=dims["forcings"], const_dim=dims["constants"],
                                 device=device)
        seconds["rollout"] = time.perf_counter() - t0

    manifest = {
        "format": FORMAT,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else None,
        "input_shape": [batch_size, nlat, nlon, input_dim],
        "output_shape": [batch_size, nlat, nlon, output_dim],
        "dtype": "float32",
        "n_common": int(n_common),
        "n_time": int(cfg.dataset.n_time_inputs),
        "feature_names": feature_names,
        "parameter_names": [name for name, _ in model.named_parameters()],
        "config_yaml": cfg.to_yaml(),
        "traced": traced_settings(forward, model),
        "export_seconds": seconds,
    }
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    torch.export.save(forward, out / _FORWARD_FILE)
    if rollout is not None:
        torch.export.save(scanned, out / _ROLLOUT_FILE)
        manifest["rollout"] = rollout
        manifest["serving_note"] = (
            "prefer rollout.pt2 for multi-step forecasts (one call, the step traced once); "
            "forward.pt2 is the step-at-a-time fallback")
    (out / _PARAMS_FILE).write_bytes(params)
    (out / _MANIFEST_FILE).write_text(json.dumps(manifest, indent=1))
    return out


class ServingModel:
    """A loaded artifact: ``serving(x)`` runs the exported forward step and
    ``serving.rollout(...)`` the scanned rollout, on ``device``, with the
    parameters of ``params.npz`` (on the device once, passed to both).

    ``serving(x)`` plus the manifest's ``n_common``/``n_time`` is everything a
    serving loop needs to autoregress (``forecast.rollout.autoregress_next_input``).
    """

    def __init__(self, forward, params: dict, manifest: dict, device: torch.device,
                 rollout=None):
        self._forward = forward
        self._rollout = rollout
        self.params = params
        self.manifest = manifest
        self.device = device
        self._params = tuple(params[name] for name in manifest["parameter_names"])

    def _check(self, **tensors) -> None:
        for name, t in tensors.items():
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}, the artifact on {self.device}")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x=x)
        with torch.inference_mode():
            return self._forward(x, self._params)

    @property
    def has_rollout(self) -> bool:
        return self._rollout is not None

    def rollout(self, dyn_input, forcings, constants) -> torch.Tensor:
        """One call, K steps, through the exported scanned rollout: shapes
        per ``manifest["rollout"]["input_shapes"]``; returns the stored
        trajectory ``[B, T, H, W, C_out]``."""
        if self._rollout is None:
            raise ValueError("artifact has no rollout.pt2 (exported with include_rollout=False)")
        self._check(input=dyn_input, forcings=forcings, constants=constants)
        with torch.inference_mode():
            return self._rollout(dyn_input, forcings, constants, self._params)


def _scan_loop(combine_fn, init, xs, additional_inputs):
    """A loaded program's ``scan`` node: the body once a step, its outputs
    stacked.  torch 2.11's own eager ``scan`` calls the body once more, on
    the first step, to size its outputs (a 41st forward in a 40-step
    rollout, 8 more interpolation launches); this loop gives the same
    values."""
    carry, outs = list(init), []
    for i in range(xs[0].shape[0]):
        res = combine_fn(*carry, *(x[i] for x in xs), *additional_inputs)
        carry = list(res[:len(init)])
        outs.append(res[len(init):])
    return (*carry, *(torch.stack(steps) for steps in zip(*outs)))


def _load_program(path: Path, device: torch.device):
    """``path``'s program as a module on ``device``, its ``scan`` nodes run by
    ``_scan_loop``."""
    module = torch.export.load(path).module()
    for gm in (m for m in module.modules() if isinstance(m, torch.fx.GraphModule)):
        scans = [n for n in gm.graph.nodes if n.target is torch.ops.higher_order.scan]
        for node in scans:
            if len(node.args) != 4 or node.kwargs:
                raise ValueError(f"{path}: a scan node of another form: {node.format_node()}")
            node.target = _scan_loop
        if scans:
            gm.recompile()
    return module.to(device)


def load_artifact(artifact_dir, device=None) -> ServingModel:
    """Load an artifact on ``device`` (the manifest's by default; another
    kind of device raises: the graphs hold the one they were traced on).
    Imports only the modules that register the ``paradis::`` ops, never the
    model; the kernels build at their first launch."""
    # registers paradis::departure_positions and, through its imports,
    # paradis::interp / interp_bwd and paradis::interp_dense / interp_dense_bwd
    import paradis_torch.ops.advection  # noqa: F401

    art = Path(artifact_dir)
    manifest = json.loads((art / _MANIFEST_FILE).read_text())
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{art} is not a {FORMAT} artifact (format {manifest.get('format')!r})")
    traced_on = torch.device(manifest["device"])
    device = traced_on if device is None else torch.device(device)
    if device.type != traced_on.type:
        raise ValueError(f"the artifact was traced on {traced_on} and runs there only; "
                         f"export it again on {device}")
    device = _indexed(device)
    with np.load(art / _PARAMS_FILE) as npz:
        if sorted(npz.files) != sorted(manifest["parameter_names"]):
            raise ValueError(f"{art / _PARAMS_FILE} does not hold the parameters the programs "
                             "take (manifest parameter_names)")
        params = _unflatten_params(npz, device)
    forward = _load_program(art / _FORWARD_FILE, device)
    rollout = None
    if "rollout" in manifest:
        rollout = _load_program(art / manifest["rollout"]["file"], device)
    return ServingModel(forward, params, manifest, device, rollout)
