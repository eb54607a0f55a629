"""Physical-variable normalizations: numpy maps for the data pipeline, their
inverses for tensors.

The port's own copy of ``paradis_tpu/utils/normalization.py``: z-score for
most variables, specific humidity log-mapped onto [0, 1] with dataset-wide
``q_min`` / ``q_max``, precipitation as ``log(x + 1e-6) + 10``.  The forward
maps run on numpy in the dataset (the same float32 bits as the JAX package's
on numpy input); the inverses run on tensors in the eval step's reports and
clip back to the physical range.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def normalize_standard(data: np.ndarray, mean, std) -> np.ndarray:
    return (data - mean) / std


def normalize_humidity(data: np.ndarray, q_min, q_max, eps=1e-12) -> np.ndarray:
    log_min = np.log(q_min)
    return (np.log(np.clip(data, 0, q_max) + eps) - log_min) / (np.log(q_max) - log_min)


def normalize_precipitation(data: np.ndarray, shift=10.0, eps=1e-6) -> np.ndarray:
    return np.log(data + eps) + shift


def denormalize_humidity(data: torch.Tensor, q_min: float, q_max: float,
                         eps: float = 1e-12) -> torch.Tensor:
    log_min = math.log(q_min)
    q = torch.exp(data * (math.log(q_max) - log_min) + log_min) - eps
    return torch.clamp(q, 0.0, q_max)


def denormalize_precipitation(data: torch.Tensor, shift: float = 10.0,
                              eps: float = 1e-6) -> torch.Tensor:
    return torch.clamp(torch.exp(data - shift) - eps, min=0.0)
