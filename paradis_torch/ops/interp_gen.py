"""Tap-weight generation alone: the weight phase of the interpolation,
isolated for the microbenchmark (``paradis_torch/tools/bench_interp.py``).

Port of the function of ``genonly_kernel`` and ``bwd_gen_kernel`` in
``scripts/bench_interp.py``, which sum the dense weight matrices of
``paradis_tpu/ops/interp_pallas.py:_weights_T``.  Per element of the
channels-last positions ``[B, H, W, V]`` fp32:

- ``gen``: ``Σ_{c∈[0,C)} K(px−c) + Σ_{r∈[0,R)} K(py−r)``;
- ``bwd_gen``: ``((Σ_c K(px−c) + Σ_c K′(px−c)) + Σ_r K(py−r)) + Σ_r K′(py−r)``,

K′ as ``interp.kernel_derivative``.  Only the 4 (2) taps of each axis are
non-zero; a tap outside the support and a non-finite position contribute
nothing.  Sums are float32, in tap order along each axis.

``gen_cuda`` and ``bwd_gen_cuda`` launch the kernels of ``csrc/interp_gen.cu``
on CUDA tensors or raise; ``gen`` and ``bwd_gen`` send CPU tensors to the
plain versions and any other tensor to the kernels.  ``gen_launches`` and
``bwd_gen_launches`` count the launches of the two wrappers.
"""

from __future__ import annotations

import torch

from paradis_torch.ops.interp import check_mode, kernel_derivative, tap_weights
from paradis_torch.ops.interp_cuda import _MODES, _kernel, _stream

gen_launches = 0
bwd_gen_launches = 0


def _axis_sums(pos: torch.Tensor, size: int, mode: str, derivative: bool):
    """``(Σ K, Σ K′)`` over the taps of one axis that lie in ``[0, size)``
    (``Σ K′`` None without ``derivative``)."""
    i0, offsets, weights = tap_weights(pos, mode)
    s = torch.zeros_like(pos)
    ds = torch.zeros_like(pos) if derivative else None
    for k, w in zip(offsets, weights):
        ok = (i0 + k >= 0) & (i0 + k <= size - 1)  # False for NaN positions too
        s = s + torch.where(ok, w, 0.0)
        if derivative:
            ds = ds + torch.where(ok, kernel_derivative(pos - i0 - k, mode), 0.0)
    return s, ds


def gen_plain(pix_y: torch.Tensor, pix_x: torch.Tensor, R: int, C: int,
              mode: str = "bicubic") -> torch.Tensor:
    """``Σ_c K(px−c) + Σ_r K(py−r)`` per element, float32, shaped like the
    positions."""
    check_mode(mode)
    sx, _ = _axis_sums(pix_x.float(), C, mode, False)
    sy, _ = _axis_sums(pix_y.float(), R, mode, False)
    return sx + sy


def bwd_gen_plain(pix_y: torch.Tensor, pix_x: torch.Tensor, R: int, C: int,
                  mode: str = "bicubic") -> torch.Tensor:
    """``((Σ_c K + Σ_c K′) + Σ_r K) + Σ_r K′`` per element, float32."""
    check_mode(mode)
    sx, dsx = _axis_sums(pix_x.float(), C, mode, True)
    sy, dsy = _axis_sums(pix_y.float(), R, mode, True)
    return ((sx + dsx) + sy) + dsy


def _launch(name: str, pix_y: torch.Tensor, pix_x: torch.Tensor, R: int, C: int,
            mode: str) -> torch.Tensor:
    check_mode(mode)
    if pix_y.shape != pix_x.shape:
        raise ValueError(f"positions differ in shape: {tuple(pix_y.shape)}, {tuple(pix_x.shape)}")
    if R < 1 or C < 1:
        raise ValueError(f"support sizes must be positive, got R={R}, C={C}")
    for arg, t in (("pix_y", pix_y), ("pix_x", pix_x)):
        if t.device.type != "cuda" or t.device != pix_y.device:
            raise ValueError(f"{arg} is on {t.device}; both positions must be on one CUDA device")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous float32, got {t.dtype}")
    out = torch.empty_like(pix_y)
    if out.numel() == 0:
        return out
    with torch.cuda.device(pix_y.device):
        err = _kernel(name)(pix_y.data_ptr(), pix_x.data_ptr(), out.data_ptr(), out.numel(),
                            R, C, _MODES[mode], _stream(pix_y.device))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    return out


def gen_cuda(pix_y: torch.Tensor, pix_x: torch.Tensor, R: int, C: int,
             mode: str = "bicubic") -> torch.Tensor:
    """Launch the weight-generation kernel on contiguous float32 CUDA
    positions: ``gen_plain``'s function."""
    global gen_launches
    out = _launch("interp_gen", pix_y, pix_x, R, C, mode)
    gen_launches += 1
    return out


def bwd_gen_cuda(pix_y: torch.Tensor, pix_x: torch.Tensor, R: int, C: int,
                 mode: str = "bicubic") -> torch.Tensor:
    """Launch the weight-and-derivative generation kernel: ``bwd_gen_plain``'s
    function."""
    global bwd_gen_launches
    out = _launch("interp_bwd_gen", pix_y, pix_x, R, C, mode)
    bwd_gen_launches += 1
    return out


def gen(pix_y, pix_x, R: int, C: int, mode: str = "bicubic") -> torch.Tensor:
    """``gen_plain`` on CPU tensors, the kernel on any other."""
    fn = gen_plain if pix_y.device.type == "cpu" else gen_cuda
    return fn(pix_y, pix_x, R, C, mode)


def bwd_gen(pix_y, pix_x, R: int, C: int, mode: str = "bicubic") -> torch.Tensor:
    """``bwd_gen_plain`` on CPU tensors, the kernel on any other."""
    fn = bwd_gen_plain if pix_y.device.type == "cpu" else bwd_gen_cuda
    return fn(pix_y, pix_x, R, C, mode)
