"""Inverse maps of the physical-variable normalizations, for tensors.

The port's own copy of ``denormalize_humidity`` and
``denormalize_precipitation`` (``paradis_tpu/utils/normalization.py:40-54``):
specific humidity was log-mapped onto [0, 1] with dataset-wide ``q_min`` /
``q_max``, precipitation as ``log(x + 1e-6) + 10``; the inverses clip back to
the physical range.
"""

from __future__ import annotations

import math

import torch


def denormalize_humidity(data: torch.Tensor, q_min: float, q_max: float,
                         eps: float = 1e-12) -> torch.Tensor:
    log_min = math.log(q_min)
    q = torch.exp(data * (math.log(q_max) - log_min) + log_min) - eps
    return torch.clamp(q, 0.0, q_max)


def denormalize_precipitation(data: torch.Tensor, shift: float = 10.0,
                              eps: float = 1e-6) -> torch.Tensor:
    return torch.clamp(torch.exp(data - shift) - eps, min=0.0)
