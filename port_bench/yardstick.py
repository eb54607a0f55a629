"""Peaks of the card and the work of the interpolation kernels.

The peaks are NVIDIA's published data-sheet rates of one H100 SXM (dense,
no sparsity) at its full 700 W; every share the benchmark reports carries
the card's ``power.limit`` beside it.  The interpolation formulas are those
of ``paradis_torch/tools/roofline.py`` (its ``interp_flops``,
``interp_bwd_flops``, ``interp_bound``, ``interp_bwd_bound``), frozen here:
each input byte read once, each output byte written once.
"""

from __future__ import annotations

HBM_BW = 3.35e12            # bytes/s
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # fp32 on CUDA cores (TF32 off)


def interp_flops(n_out: int, mode: str) -> int:
    """Per output: the tap weights (4 cubic polynomials per axis, ~6 flops
    each, or 2 linear), one FMA per tap, one FMA per tap row."""
    return n_out * ((2 * 4 * 6 + 16 * 2 + 4 * 2) if mode == "bicubic"
                    else (2 * 2 + 4 * 2 + 2 * 2))


def interp_bwd_flops(n_out: int, mode: str) -> int:
    """Per output: weights and derivatives per axis; per tap two FMAs, one
    product and its add into d_field; per tap row two FMAs and a product."""
    if mode == "bicubic":
        return n_out * (2 * 4 * (6 + 8) + 16 * 6 + 4 * 5 + 2)
    return n_out * (2 * 2 * (2 + 2) + 4 * 6 + 2 * 5 + 2)


def bound_s(nbytes: float, flops: float, peak_flops: float = PEAK_FLOPS["float32"]) -> float:
    """The least time: the larger of bytes over the memory rate and
    operations over the peak."""
    return max(nbytes / HBM_BW, flops / peak_flops)


def interp_fwd_bound_s(n_out: int, field_bytes: int, out_size: int, mode: str) -> float:
    """Field and both fp32 positions read once, the output written once."""
    return bound_s(field_bytes + 2 * n_out * 4 + n_out * out_size, interp_flops(n_out, mode))


def interp_bwd_bound_s(n_out: int, field_bytes: int, g_size: int, mode: str) -> float:
    """Field, both positions and the cotangent read once; d_field (the
    field's dtype), d_py and d_px (fp32) written once."""
    return bound_s(2 * field_bytes + 2 * n_out * 4 + n_out * g_size + 2 * n_out * 4,
                   interp_bwd_flops(n_out, mode))


def call_bound_s(call: dict) -> float:
    """The bound of one recorded interpolation call (``trace.interp_call``)."""
    fn = interp_fwd_bound_s if call["kind"] == "fwd" else interp_bwd_bound_s
    return fn(call["n_out"], call["field_bytes"], call["elem_bytes"], call["mode"])
