"""Reference-checkpoint migration: a reference PyTorch ``.ckpt`` / state dict
to the port's parameters.

Port of ``paradis_tpu/train/convert.py``.  Handles the reference's Lightning
key layout (``model.`` prefix, ``._orig_mod.`` compile prefixes), and maps
every module onto the port's parameter names by the JAX package's name map.
The port keeps the reference's own layouts but one: a 1×1 ``Conv2d`` weight
``[out, in, 1, 1]`` is the port's Dense weight ``[out, in]``.  Depthwise
weights ``[C, 1, k, k]`` and the GlobalBias ``projection`` ``[out, C_b]``
(a torch ``Linear`` weight, which the JAX package transposes into flax's
``[C_b, out]``) are taken as they are, and the per-layer modules are the
port's ``layers.{i}`` (no restacking).  Buffers and unknown entries are
skipped; a shape that does not fit the model raises, as in JAX.

Usage:
    state = convert_torch_checkpoint("ref.ckpt", model)
    model.load_state_dict(state)
"""

from __future__ import annotations

import torch
from torch import nn


def _strip_prefixes(key: str) -> str:
    key = key.replace("._orig_mod.", ".")
    if key.startswith("_orig_mod."):
        key = key[len("_orig_mod."):]
    if key.startswith("model."):
        key = key[len("model."):]
    return key


def _t(value) -> torch.Tensor:
    return torch.as_tensor(value).detach().to("cpu", torch.float32)


def _conv1x1(value) -> torch.Tensor:
    """torch Conv2d 1×1 ``[out, in, 1, 1]`` → the port's Dense ``[out, in]``."""
    return _t(value)[:, :, 0, 0].clone()


def _gmblock_entry(mod: str, rest: list[str], value) -> tuple[str, torch.Tensor] | None:
    """One reference GMBlock entry as (the port's name under the block, value)."""
    leaf = rest[-1]
    if mod.endswith("-ChannelNorm"):
        # the pre-norm is the only ChannelNorm entry in every reference config
        return f"pre_norm.{leaf}", _t(value)
    idx = mod.split("-")[0]
    if mod.endswith("-CLinear"):
        if leaf == "weight":
            return f"layer{idx}_CLinear.conv.weight", _conv1x1(value)
        return f"layer{idx}_CLinear.conv.bias", _t(value)
    if mod.endswith("-SepConv"):
        name, sub = f"layer{idx}_SepConv", rest[0]
        if sub == "depthwise":
            return f"{name}.depthwise.weight", _t(value)
        if sub == "pointwise":
            if leaf == "weight":
                return f"{name}.pointwise.weight", _conv1x1(value)
            return f"{name}.pointwise.bias", _t(value)
    if mod.endswith("-GlobalBias"):
        if leaf in ("A", "U", "V"):
            return f"bias0_GlobalBias.{leaf}", _t(value)
        if rest[0] == "projection":
            return "bias0_GlobalBias.projection", _t(value)
    return None


_STATIC_ENCODER = {
    ("0", "depthwise", "weight"): ("static_sepconv1.depthwise.weight", _t),
    ("0", "pointwise", "weight"): ("static_sepconv1.pointwise.weight", _conv1x1),
    ("0", "pointwise", "bias"): ("static_sepconv1.pointwise.bias", _t),
    ("3", "weight"): ("static_depthwise.weight", _t),
    ("3", "bias"): ("static_depthwise.bias", _t),
    ("5", "depthwise", "weight"): ("static_sepconv2.depthwise.weight", _t),
    ("5", "pointwise", "weight"): ("static_sepconv2.pointwise.weight", _conv1x1),
    ("5", "pointwise", "bias"): ("static_sepconv2.pointwise.bias", _t),
}

_LAYER_MODULES = {"velocity_nets": "velocity_net", "diffusion": "diffusion",
                  "reaction": "reaction"}


def torch_state_dict_to_params(state_dict: dict, model: nn.Module) -> dict[str, torch.Tensor]:
    """The model's parameters (float32, on the CPU) with every entry of the
    reference ``state_dict`` the name map knows put in its place."""
    out = {name: p.detach().to("cpu", torch.float32).clone()
           for name, p in model.named_parameters()}
    n_layers = len(model.layers)
    per_layer: dict[str, dict[int, torch.Tensor]] = {}

    def put(name: str, value: torch.Tensor) -> None:
        expected = tuple(out[name].shape) if name in out else None
        if expected != tuple(value.shape):
            raise ValueError(f"shape mismatch at {name}: checkpoint {tuple(value.shape)} "
                             f"vs model {expected}")
        out[name] = value

    for raw_key, value in state_dict.items():
        key = _strip_prefixes(raw_key)
        parts = key.split(".")
        head = parts[0]

        if head == "alpha_adv":
            value = _t(value)
            if value.shape[0] != n_layers:
                raise ValueError(f"shape mismatch at layers.*.alpha_adv: checkpoint "
                                 f"{tuple(value.shape)} vs model {n_layers} layers")
            for i in range(n_layers):
                put(f"layers.{i}.alpha_adv", value[i].clone())
        elif head in ("input_proj", "output_proj"):
            mapped = _gmblock_entry(parts[1], parts[2:], value)
            if mapped:
                put(f"{head}.{mapped[0]}", mapped[1])
        elif head == "static_encoder":
            spec = _STATIC_ENCODER.get(tuple(parts[1:]))
            if spec:
                put(spec[0], spec[1](value))
        elif head in _LAYER_MODULES:
            mapped = _gmblock_entry(parts[2], parts[3:], value)
            if mapped:
                per_layer.setdefault(f"{_LAYER_MODULES[head]}.{mapped[0]}",
                                     {})[int(parts[1])] = mapped[1]
        elif head == "advection":
            proj = parts[2]  # down_projection | up_projection
            mapped = _gmblock_entry(parts[3], parts[4:], value)
            if mapped:
                per_layer.setdefault(f"advection.{proj}.{mapped[0]}",
                                     {})[int(parts[1])] = mapped[1]
        # buffers (lat_grid etc.) and anything else are intentionally skipped

    for name, by_layer in per_layer.items():
        if sorted(by_layer) != list(range(n_layers)):
            raise ValueError(f"shape mismatch at layers.*.{name}: checkpoint layers "
                             f"{sorted(by_layer)} vs model {n_layers} layers")
        for i, value in by_layer.items():
            put(f"layers.{i}.{name}", value)
    return out


def convert_torch_checkpoint(path: str, model: nn.Module) -> dict[str, torch.Tensor]:
    """Load a reference ``.ckpt`` (Lightning, under ``state_dict``) or a raw
    state-dict file and convert it (see ``torch_state_dict_to_params``).  A
    Lightning checkpoint holds pickled Python objects, so the file is read
    with ``weights_only=False``: convert only files that you trust."""
    loaded = torch.load(path, map_location="cpu", weights_only=False)
    sd = loaded.get("state_dict", loaded) if isinstance(loaded, dict) else loaded
    return torch_state_dict_to_params(sd, model)
