"""Weights and inputs from ``--seed``, drawn on the device in a few large
calls, the same tensors handed to the program and to the reference.

Each parameter is a standard normal draw, cut from one flat draw in the
order of its name, scaled and shifted by a rule on its name and shape that
follows the model's own initialisation: He-normal matrices (a tenth on the
last layer of a block, as the model scales it), He-normal stencils,
ChannelNorm weights near 1, small biases, the low-rank spatial bias's
factors at 1e-3, the advection gates near sigmoid(-1).
"""

from __future__ import annotations

import math
import re

import torch

_LAYER = re.compile(r"^(.*)\.layer(\d+)_(CLinear|SepConv)\.")


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator for stream ``stream`` of ``seed`` (0: weights, 1: inputs)."""
    return torch.Generator(device=device).manual_seed((int(seed) * 4 + stream) % (2 ** 63))


def _last_conv(names) -> dict:
    """``{block prefix: index of its last CLinear or SepConv}``."""
    last: dict = {}
    for n in names:
        m = _LAYER.match(n)
        if m:
            last[m.group(1)] = max(last.get(m.group(1), -1), int(m.group(2)))
    return last


def _scale(name: str, shape: tuple, last: dict) -> tuple[float, float]:
    """``(mean, std)`` of a parameter."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" and len(shape) == 2:
        m = _LAYER.match(name)
        tenth = m is not None and int(m.group(2)) == last[m.group(1)]
        return 0.0, math.sqrt(2.0 / shape[1]) * (0.1 if tenth else 1.0)
    if leaf == "weight" and len(shape) == 4:
        return 0.0, math.sqrt(2.0) / shape[-1]
    if leaf == "weight" and len(shape) == 1:
        return 1.0, 0.01
    if leaf in ("A", "U", "V"):
        return 0.0, 1e-3
    if leaf == "projection":
        return 0.0, 1.0 / math.sqrt(3.0 * shape[1])
    if leaf == "alpha_adv":
        return -1.0, 0.1
    return 0.0, 0.01


def parameters(shapes: dict, seed: int, device) -> dict:
    """``{name: float32 tensor}`` for ``{name: shape}``, from ``seed``."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    flat = torch.randn(sum(sizes), generator=generator(seed, 0, device), device=device)
    last = _last_conv(names)
    out, at = {}, 0
    for n, size in zip(names, sizes):
        mean, std = _scale(n, tuple(shapes[n]), last)
        out[n] = flat[at:at + size].view(shapes[n]).mul(std).add_(mean)
        at += size
    return out


def normal(shapes: dict, seed: int, device) -> dict:
    """Standard normal tensors ``{key: tensor}`` for ``{key: shape}`` (in the
    order given), from stream 1 of ``seed``."""
    g = generator(seed, 1, device)
    return {k: torch.randn(s, generator=g, device=device) for k, s in shapes.items()}
