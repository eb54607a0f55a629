"""Physical-variable normalizations: numpy maps for the data pipeline, their
inverses for tensors.

The port's own copy of ``paradis_tpu/utils/normalization.py``: z-score for
most variables, specific humidity log-mapped onto [0, 1] with dataset-wide
``q_min`` / ``q_max``, precipitation as ``log(x + 1e-6) + 10``.  The forward
maps run on numpy in the dataset (the same float32 bits as the JAX package's
on numpy input).  The inverses clip back to the physical range: on tensors in
the eval step's reports, and on numpy in the forecast writer
(``denormalize_*_np``), where they take ``log(q_min)`` in the dtype of
``q_min`` (float32 from the dataset) as the JAX package's numpy branch does,
so that both packages' stores hold the same bits.
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


def denormalize_standard(data: np.ndarray, mean, std) -> np.ndarray:
    return data * std + mean


def denormalize_humidity_np(data: np.ndarray, q_min, q_max, eps=1e-12) -> np.ndarray:
    log_min = np.log(q_min)
    q = np.exp(data * (np.log(q_max) - log_min) + log_min) - eps
    return np.clip(q, 0, q_max)


def denormalize_precipitation_np(data: np.ndarray, shift=10.0, eps=1e-6) -> np.ndarray:
    return np.clip(np.exp(data - shift) - eps, 0, None)


def denormalize_humidity(data: torch.Tensor, q_min: float, q_max: float,
                         eps: float = 1e-12) -> torch.Tensor:
    log_min = math.log(q_min)
    q = torch.exp(data * (math.log(q_max) - log_min) + log_min) - eps
    return torch.clamp(q, 0.0, q_max)


def denormalize_precipitation(data: torch.Tensor, shift: float = 10.0,
                              eps: float = 1e-6) -> torch.Tensor:
    return torch.clamp(torch.exp(data - shift) - eps, min=0.0)
