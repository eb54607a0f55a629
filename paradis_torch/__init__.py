"""paradis_torch: the PARADIS weather model in PyTorch for NVIDIA Hopper.

A port of ``paradis_tpu`` (JAX on a TPU) that sits beside it.  Layout mirrors
the JAX package (``sphere/``, ``ops/``, ``model/``, ``forecast/``, ``train/``,
``data/``, ``utils/``); tensors are channels-last ``[B, H, W, C]`` as there.
The hand-written kernels are the gather-interpolation (``csrc/interp_fwd.cu``,
on the forecast and train paths), its backward (``csrc/interp_bwd.cu``, on
the train path), their row-banded pair (``csrc/interp_band_fwd.cu``,
``csrc/interp_band_bwd.cu``), which ``compute.interp_band_rad`` selects where
the band is small against the padded rows (the 1.40625° grid), their
row-chunked pair (``csrc/interp_chunk_fwd.cu``, ``csrc/interp_chunk_bwd.cu``),
which ``PARADIS_INTERP_CHUNK`` selects where no band is in force, and the
tap-weight generation of the interpolation microbenchmark
(``csrc/interp_gen.cu``, ``tools/bench_interp.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit device they raise rather than fall back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, never a quiet CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paradis_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)
