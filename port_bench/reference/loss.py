"""The weighted reversed Huber loss, written from the mathematics.

Per output channel the variable's weight times, on a channel of pressure
level p hPa, max(p / 1000, 0.2); per row the unit-mean cos(latitude) of a
grid without the poles; the mean over batch, rows, columns and channels.
"""

from __future__ import annotations

import numpy as np
import torch


def channel_names(features: dict) -> list[str]:
    """Output channels in the model's order: those also read as inputs
    first, then the output-only ones."""
    levels = features["pressure_levels"]

    def names(group):
        return [f"{v}_h{p}" for v in group["atmospheric"] for p in levels] + list(group["surface"])

    ins, outs = names(features["input"]), names(features["output"])
    return [f for f in outs if f in ins] + [f for f in outs if f not in ins]


def weights(training: dict, features: dict, nlat: int):
    """``(channel weights [C], row weights [nlat])`` as float64 numpy."""
    table = {**training["variable_loss_weights"]["atmospheric"],
             **training["variable_loss_weights"]["surface"]}
    cw = []
    for name in channel_names(features):
        var, _, level = name.rpartition("_h")
        if var and level.isdigit():
            cw.append(table[var] * max(float(level) / 1000.0, 0.2))
        else:
            cw.append(table[name])
    delta = 180.0 / nlat
    lat = -90.0 + delta / 2.0 + delta * np.arange(nlat)
    rw = np.cos(np.deg2rad(lat))
    return np.asarray(cw, np.float64), rw / rw.mean()


def reversed_huber_loss(pred, target, cw: torch.Tensor, rw: torch.Tensor, delta: float = 1.0):
    e = pred.float() - target.float()
    a = e.abs()
    blend = torch.sigmoid(2.0 * (a - delta))
    point = (1 - blend) * delta * a + blend * (e * e + delta * delta) / (2 * delta)
    return (point * cw * rw[:, None, None]).mean()
