"""Wrappers of the hand-written Hopper interpolation kernels, and their
autograd pairing.

``interp_fwd_cuda`` (``csrc/interp_fwd.cu``) replaces the TPU kernel
``paradis_tpu/ops/interp_pallas.py:_fwd_kernel``; ``interp_bwd_cuda``
(``csrc/interp_bwd.cu``) replaces ``_bwd_kernel``; ``interp_band_fwd_cuda``
(``csrc/interp_band_fwd.cu``) and ``interp_band_bwd_cuda``
(``csrc/interp_band_bwd.cu``) replace ``_fwd_kernel_banded`` and
``_bwd_kernel_banded``; ``interp_chunk_fwd_cuda`` (``csrc/interp_chunk_fwd.cu``)
and ``interp_chunk_bwd_cuda`` (``csrc/interp_chunk_bwd.cu``) replace
``_fwd_kernel_chunked`` and ``_bwd_kernel_chunked``.  Each launches its
kernel on CUDA tensors or raises: there is no fallback.  ``Interp`` is the
``torch.autograd.Function`` around a pair: with a band plan the banded
kernels, else with a chunk size the row-chunked kernels, else the unbanded
ones; on CPU tensors (or when asked for ``plain``) the plain versions of
``ops/interp.py``, ``ops/interp_band.py`` and ``ops/interp_chunk.py``.

``launches``, ``bwd_launches``, ``band_launches``, ``band_bwd_launches``,
``chunk_launches`` and ``chunk_bwd_launches`` count the launches made by the
six wrappers, and nothing else, so a run can show that its path went through
the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from paradis_torch import _build
from paradis_torch.ops.interp import check_mode, interp_bwd_plain, interp_plain
from paradis_torch.ops.interp_band import interp_band_bwd_plain, interp_band_plain
from paradis_torch.ops.interp_chunk import check_rw, interp_chunk_bwd_plain, interp_chunk_plain

launches = 0
bwd_launches = 0
band_launches = 0
band_bwd_launches = 0
chunk_launches = 0
chunk_bwd_launches = 0

_MODES = {"bilinear": 0, "bicubic": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The C entry point ``paradis_<name>`` of each kernel: its source in
# ``csrc/``, then its count of pointers, of 64-bit integers and of ints before
# the stream.  A forward takes field, pos_y, pos_x, out; a backward field,
# pos_y, pos_x, g, d_field, d_py, d_px; then B, P; then R, C, V, for a banded
# kernel W, rpb, band_rows, halo_lo, pad, for a chunked one rw; then mode,
# dtype, and for a backward g's dtype.  The weight-generation kernels take
# pos_y, pos_x, out; the element count; R, C, mode.  The contraction kernels
# (``ops/interp_mm.py``) take w, f, out, or field, py, px, g, d_field, d_py,
# d_px; then B·V, P; then R, C, and vb, pb or the field's dtype; then cdt.
_SIGNATURES = {
    "interp_fwd": ("interp_fwd", 4, 2, 5),
    "interp_bwd": ("interp_bwd", 7, 2, 6),
    "interp_band_fwd": ("interp_band_fwd", 4, 2, 10),
    "interp_band_bwd": ("interp_band_bwd", 7, 2, 11),
    "interp_chunk_fwd": ("interp_chunk_fwd", 4, 2, 6),
    "interp_chunk_bwd": ("interp_chunk_bwd", 7, 2, 7),
    "interp_gen": ("interp_gen", 3, 1, 3),
    "interp_bwd_gen": ("interp_gen", 3, 1, 3),
    "interp_mm": ("interp_mm", 3, 2, 5),
    "interp_mmT": ("interp_mm", 3, 2, 5),
    "interp_bwd_mm": ("interp_mm", 7, 2, 4),
}
_fns: dict = {}


def _kernel(name: str):
    """The C entry point ``paradis_<name>``, built and loaded at first use."""
    if name not in _fns:
        source, n_ptr, n_long, n_int = _SIGNATURES[name]
        fn = getattr(_build.load(source), f"paradis_{name}")
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_longlong] * n_long
                       + [ctypes.c_int] * n_int + [ctypes.c_void_p])
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


def _check_spec(field: torch.Tensor, pix_y: torch.Tensor, spec) -> tuple[int, ...]:
    """The band plan's integers ``(W, rpb, band_rows, halo_lo, pad)`` for the
    banded kernels' C entry points, after checking it fits the shapes."""
    rpb, band_rows, halo_lo, pad, _ = spec
    R, H, W = field.shape[1], pix_y.shape[1], pix_y.shape[2]
    if rpb < 1 or H % rpb or not 0 < band_rows <= R or pad != (R - H) // 2:
        raise ValueError(f"band plan {spec} does not fit field rows {R} and position rows {H}")
    return W, rpb, band_rows, halo_lo, pad


def interp_band_fwd_cuda(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                         spec, mode: str = "bicubic") -> torch.Tensor:
    """Launch the row-banded forward kernel: arguments as ``interp_fwd_cuda``
    plus the band plan of ``interp_band.band_spec``; positions clamped to it."""
    global band_launches
    _check(field, pix_y, pix_x, mode)
    plan = _check_spec(field, pix_y, spec)
    B, R, C, V = field.shape
    H, W = pix_y.shape[1], pix_y.shape[2]
    out = torch.empty((B, H, W, V), dtype=field.dtype, device=field.device)
    if out.numel() == 0:
        return out
    fn = _kernel("interp_band_fwd")
    with torch.cuda.device(field.device):
        err = fn(field.data_ptr(), pix_y.data_ptr(), pix_x.data_ptr(), out.data_ptr(),
                 B, H * W, R, C, V, *plan, _MODES[mode], _DTYPES[field.dtype],
                 _stream(field.device))
    if err != 0:
        raise RuntimeError(f"interp_band_fwd kernel launch failed with CUDA error {err}")
    band_launches += 1
    return out


def interp_band_bwd_cuda(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                         g: torch.Tensor, spec, mode: str = "bicubic"):
    """Launch the row-banded backward kernel: ``(d_field, d_py, d_px)`` as
    ``interp_bwd_cuda``, for the band plan ``spec``."""
    global band_bwd_launches
    _check(field, pix_y, pix_x, mode, g=g)
    plan = _check_spec(field, pix_y, spec)
    B, R, C, V = field.shape
    H, W = pix_y.shape[1], pix_y.shape[2]
    d_field = torch.zeros((B, R, C, V), dtype=torch.float32, device=field.device)
    d_py = torch.empty((B, H, W, V), dtype=torch.float32, device=field.device)
    d_px = torch.empty_like(d_py)
    if d_py.numel() == 0:
        return d_field.to(field.dtype), d_py, d_px
    fn = _kernel("interp_band_bwd")
    with torch.cuda.device(field.device):
        err = fn(field.data_ptr(), pix_y.data_ptr(), pix_x.data_ptr(), g.data_ptr(),
                 d_field.data_ptr(), d_py.data_ptr(), d_px.data_ptr(), B, H * W, R, C, V,
                 *plan, _MODES[mode], _DTYPES[field.dtype], _DTYPES[g.dtype],
                 _stream(field.device))
    if err != 0:
        raise RuntimeError(f"interp_band_bwd kernel launch failed with CUDA error {err}")
    band_bwd_launches += 1
    return d_field.to(field.dtype), d_py, d_px


def interp_chunk_fwd_cuda(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                          rw: int, mode: str = "bicubic") -> torch.Tensor:
    """Launch the row-chunked forward kernel: arguments as ``interp_fwd_cuda``
    plus ``rw`` rows a chunk.  Raises where one channel's chunk does not fit
    the card's shared memory."""
    global chunk_launches
    _check(field, pix_y, pix_x, mode)
    check_rw(rw)
    B, R, C, V = field.shape
    H, W = pix_y.shape[1], pix_y.shape[2]
    out = torch.empty((B, H, W, V), dtype=field.dtype, device=field.device)
    if out.numel() == 0:
        return out
    fn = _kernel("interp_chunk_fwd")
    with torch.cuda.device(field.device):
        err = fn(field.data_ptr(), pix_y.data_ptr(), pix_x.data_ptr(), out.data_ptr(),
                 B, H * W, R, C, V, rw, _MODES[mode], _DTYPES[field.dtype],
                 _stream(field.device))
    if err != 0:
        raise RuntimeError(f"interp_chunk_fwd kernel launch failed with CUDA error {err} "
                           f"(a chunk of {rw} rows x {C} columns may not fit in shared memory)")
    chunk_launches += 1
    return out


def interp_chunk_bwd_cuda(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                          g: torch.Tensor, rw: int, mode: str = "bicubic"):
    """Launch the row-chunked backward kernel: ``(d_field, d_py, d_px)`` as
    ``interp_bwd_cuda``, over chunks of ``rw`` rows."""
    global chunk_bwd_launches
    _check(field, pix_y, pix_x, mode, g=g)
    check_rw(rw)
    B, R, C, V = field.shape
    H, W = pix_y.shape[1], pix_y.shape[2]
    d_field = torch.zeros((B, R, C, V), dtype=torch.float32, device=field.device)
    d_py = torch.empty((B, H, W, V), dtype=torch.float32, device=field.device)
    d_px = torch.empty_like(d_py)
    if d_py.numel() == 0:
        return d_field.to(field.dtype), d_py, d_px
    fn = _kernel("interp_chunk_bwd")
    with torch.cuda.device(field.device):
        err = fn(field.data_ptr(), pix_y.data_ptr(), pix_x.data_ptr(), g.data_ptr(),
                 d_field.data_ptr(), d_py.data_ptr(), d_px.data_ptr(), B, H * W, R, C, V,
                 rw, _MODES[mode], _DTYPES[field.dtype], _DTYPES[g.dtype],
                 _stream(field.device))
    if err != 0:
        raise RuntimeError(f"interp_chunk_bwd kernel launch failed with CUDA error {err} "
                           f"(a chunk of {rw} rows x {C} columns may not fit in shared memory)")
    chunk_bwd_launches += 1
    return d_field.to(field.dtype), d_py, d_px


class Interp(torch.autograd.Function):
    """Gather-interpolation with the backward of the JAX package's VJP.

    ``Interp.apply(field, pix_y, pix_x, mode, plain, spec, chunk)``: with
    ``plain`` false a CUDA tensor goes to the kernels and a CPU tensor to the
    plain versions; with ``plain`` true the plain versions run on any device.
    The pair, in the priority of ``_fwd_tv`` / ``_bwd_tv``: a band plan
    ``spec`` (``interp_band.band_spec``, positions clamped to it) selects the
    row-banded pair; else ``chunk`` > 0 rows the row-chunked pair; else the
    unbanded one.  The backward is not differentiable again (the kernels have
    no backward of their own).
    """

    @staticmethod
    def forward(ctx, field, pix_y, pix_x, mode: str, plain: bool, spec=None, chunk: int = 0):
        use_plain = plain or field.device.type == "cpu"
        ctx.mode, ctx.plain, ctx.spec, ctx.chunk = mode, use_plain, spec, chunk
        ctx.save_for_backward(field, pix_y, pix_x)
        if spec is not None:
            fwd = interp_band_plain if use_plain else interp_band_fwd_cuda
            return fwd(field, pix_y, pix_x, spec, mode)
        if chunk:
            fwd = interp_chunk_plain if use_plain else interp_chunk_fwd_cuda
            return fwd(field, pix_y, pix_x, chunk, mode)
        if use_plain:
            return interp_plain(field, pix_y, pix_x, mode)
        return interp_fwd_cuda(field, pix_y, pix_x, mode)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        field, pix_y, pix_x = ctx.saved_tensors
        g = g.contiguous()
        if ctx.spec is not None:
            bwd = interp_band_bwd_plain if ctx.plain else interp_band_bwd_cuda
            d_field, d_py, d_px = bwd(field, pix_y, pix_x, g, ctx.spec, ctx.mode)
        elif ctx.chunk:
            bwd = interp_chunk_bwd_plain if ctx.plain else interp_chunk_bwd_cuda
            d_field, d_py, d_px = bwd(field, pix_y, pix_x, g, ctx.chunk, ctx.mode)
        else:
            bwd = interp_bwd_plain if ctx.plain else interp_bwd_cuda
            d_field, d_py, d_px = bwd(field, pix_y, pix_x, g, ctx.mode)
        return d_field, d_py, d_px, None, None, None, None
