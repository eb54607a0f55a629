"""Wrappers of the hand-written Hopper interpolation kernels, and their
autograd pairing.

``interp_fwd_cuda`` (``csrc/interp_fwd.cu``) replaces the TPU kernel
``paradis_tpu/ops/interp_pallas.py:_fwd_kernel``; ``interp_bwd_cuda``
(``csrc/interp_bwd.cu``) replaces ``_bwd_kernel``.  Each launches its kernel
on CUDA tensors or raises: there is no fallback.  ``Interp`` is the
``torch.autograd.Function`` around the pair: on CUDA tensors it runs the two
kernels, on CPU tensors (or when asked for ``plain``) the two plain versions
of ``ops/interp.py``.

``launches`` and ``bwd_launches`` count the launches made by the two
wrappers, and nothing else, so a run can show that its path went through
the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from paradis_torch import _build
from paradis_torch.ops.interp import check_mode, interp_bwd_plain, interp_plain

launches = 0
bwd_launches = 0

_MODES = {"bilinear": 0, "bicubic": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns: dict = {}


def _kernel(name: str):
    """The C entry point of ``csrc/<name>.cu``, built and loaded at first use."""
    if name not in _fns:
        fn = getattr(_build.load(name), f"paradis_{name}")
        if name == "interp_fwd":
            # field, pos_y, pos_x, out, B, P, R, C, V, mode, dtype, stream
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                           + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        else:
            # field, pos_y, pos_x, g, d_field, d_py, d_px, B, P, R, C, V, mode,
            # dtype, g dtype, stream
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2
                           + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor, mode: str,
           **more: torch.Tensor) -> None:
    """The arguments both kernels take: field [B,R,C,V] fp32/bf16, positions
    [B,H,W,V] fp32 (and ``more`` shaped like them), all contiguous on one CUDA
    device."""
    check_mode(mode)
    if field.dim() != 4 or pix_y.dim() != 4 or pix_y.shape != pix_x.shape:
        raise ValueError(f"expected field [B,R,C,V] and positions [B,H,W,V]; got "
                         f"{tuple(field.shape)}, {tuple(pix_y.shape)}, {tuple(pix_x.shape)}")
    B, R, C, V = field.shape
    if pix_y.shape[0] != B or pix_y.shape[3] != V:
        raise ValueError(f"positions {tuple(pix_y.shape)} do not match field {tuple(field.shape)}")
    if field.dtype not in _DTYPES:
        raise TypeError(f"field dtype must be float32 or bfloat16, got {field.dtype}")
    if pix_y.dtype != torch.float32 or pix_x.dtype != torch.float32:
        raise TypeError(f"positions must be float32, got {pix_y.dtype}, {pix_x.dtype}")
    for name, t in more.items():
        if t.shape != pix_y.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match the positions "
                             f"{tuple(pix_y.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} dtype must be float32 or bfloat16, got {t.dtype}")
    for name, t in (("field", field), ("pix_y", pix_y), ("pix_x", pix_x), *more.items()):
        if t.device != field.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; all inputs must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def interp_fwd_cuda(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                    mode: str = "bicubic") -> torch.Tensor:
    """Launch the forward kernel: field [B, R, C, V] (fp32 or bf16), positions
    [B, H, W, V] fp32, all contiguous on one CUDA device → [B, H, W, V]."""
    global launches
    _check(field, pix_y, pix_x, mode)
    B, R, C, V = field.shape
    H, W = pix_y.shape[1], pix_y.shape[2]
    out = torch.empty((B, H, W, V), dtype=field.dtype, device=field.device)
    if out.numel() == 0:
        return out
    fn = _kernel("interp_fwd")
    with torch.cuda.device(field.device):
        err = fn(field.data_ptr(), pix_y.data_ptr(), pix_x.data_ptr(), out.data_ptr(),
                 B, H * W, R, C, V, _MODES[mode], _DTYPES[field.dtype], _stream(field.device))
    if err != 0:
        raise RuntimeError(f"interp_fwd kernel launch failed with CUDA error {err}")
    launches += 1
    return out


def interp_bwd_cuda(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                    g: torch.Tensor, mode: str = "bicubic"):
    """Launch the backward kernel for the output cotangent ``g`` [B, H, W, V]
    (fp32 or bf16): ``(d_field, d_py, d_px)``, d_field in the field's dtype,
    the position gradients in float32.  Arguments as ``interp_fwd_cuda``."""
    global bwd_launches
    _check(field, pix_y, pix_x, mode, g=g)
    B, R, C, V = field.shape
    H, W = pix_y.shape[1], pix_y.shape[2]
    d_field = torch.zeros((B, R, C, V), dtype=torch.float32, device=field.device)
    d_py = torch.empty((B, H, W, V), dtype=torch.float32, device=field.device)
    d_px = torch.empty_like(d_py)
    if d_py.numel() == 0:
        return d_field.to(field.dtype), d_py, d_px
    fn = _kernel("interp_bwd")
    with torch.cuda.device(field.device):
        err = fn(field.data_ptr(), pix_y.data_ptr(), pix_x.data_ptr(), g.data_ptr(),
                 d_field.data_ptr(), d_py.data_ptr(), d_px.data_ptr(), B, H * W, R, C, V,
                 _MODES[mode], _DTYPES[field.dtype], _DTYPES[g.dtype], _stream(field.device))
    if err != 0:
        raise RuntimeError(f"interp_bwd kernel launch failed with CUDA error {err}")
    bwd_launches += 1
    return d_field.to(field.dtype), d_py, d_px


class Interp(torch.autograd.Function):
    """Gather-interpolation with the backward of the JAX package's VJP.

    ``Interp.apply(field, pix_y, pix_x, mode, plain)``: with ``plain`` false a
    CUDA tensor goes to the kernels and a CPU tensor to the plain versions;
    with ``plain`` true the plain versions run on any device.  The backward
    is not differentiable again (the kernel has no backward of its own).
    """

    @staticmethod
    def forward(ctx, field, pix_y, pix_x, mode: str, plain: bool):
        use_plain = plain or field.device.type == "cpu"
        ctx.mode, ctx.plain = mode, use_plain
        ctx.save_for_backward(field, pix_y, pix_x)
        if use_plain:
            return interp_plain(field, pix_y, pix_x, mode)
        return interp_fwd_cuda(field, pix_y, pix_x, mode)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        field, pix_y, pix_x = ctx.saved_tensors
        g = g.contiguous()
        bwd = interp_bwd_plain if ctx.plain else interp_bwd_cuda
        d_field, d_py, d_px = bwd(field, pix_y, pix_x, g, ctx.mode)
        return d_field, d_py, d_px, None, None
