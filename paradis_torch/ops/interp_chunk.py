"""Row-chunked gather-interpolation: the chunk-size rule and the plain versions.

Port of the row chunking of ``paradis_tpu/ops/interp_pallas.py``
(``_chunk_rows``, ``_fwd_kernel_chunked``, ``_bwd_kernel_chunked``).  The
Pallas kernels zero-pad the field's rows to a multiple of ``rw``
(``_pad_rows``) and contract each ``rw``-row chunk that holds a tap of the
position block; padded rows give zero taps, so chunking changes which rows
are visited, not the function.  The CUDA kernels (``csrc/interp_chunk_fwd.cu``,
``csrc/interp_chunk_bwd.cu``) turn the chunk into a row window the data
chooses: a block of positions stages, one after another, the chunks that
meet the rows its taps touch, and keeps each position's sums across them.

Chunking is opt-in, as in the JAX package: ``chunk_rows`` takes an explicit
size, then ``PARADIS_INTERP_CHUNK``, and defaults to 0 (unchunked).  A band
plan (``interp_band.band_spec``) takes precedence where one is in force.
"""

from __future__ import annotations

import os

import torch

from paradis_torch.ops.interp import interp_bwd_plain, interp_plain


def chunk_rows(R: int, override) -> int:
    """Row-chunk size (0 = unchunked): ``override`` when given, else the
    ``PARADIS_INTERP_CHUNK`` environment variable, else 0.  Read on every
    call, so a caller can switch it between calls.  ``R`` is unused, as in
    ``_chunk_rows``."""
    if override is not None:
        return int(override)
    env = os.environ.get("PARADIS_INTERP_CHUNK")
    if env is not None:
        return int(env)
    return 0


def check_rw(rw: int) -> None:
    if rw < 1:
        raise ValueError(f"chunk rows must be a positive row count, got {rw}")


def interp_chunk_plain(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                       rw: int, mode: str = "bicubic") -> torch.Tensor:
    """The row-chunked forward, field [B, R, C, V], positions [B, H, W, V]
    → [B, H, W, V]: ``interp_plain`` outright.  The chunked kernel carries
    each position's float32 sum across its chunks in increasing row order, so
    the float order is ``interp_plain``'s (a tap row's columns first, then the
    rows in increasing order) for every ``rw``."""
    check_rw(rw)
    return interp_plain(field, pix_y, pix_x, mode)


def interp_chunk_bwd_plain(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                           g: torch.Tensor, rw: int, mode: str = "bicubic"):
    """The row-chunked backward: ``interp_bwd_plain`` outright, in its float
    order, for the same reason; ``(d_field, d_py, d_px)`` as there."""
    check_rw(rw)
    return interp_bwd_plain(field, pix_y, pix_x, g, mode)
