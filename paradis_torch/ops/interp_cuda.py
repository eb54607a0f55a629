"""Wrappers of the hand-written Hopper interpolation kernels, and their
pairing as custom ops.

``interp_fwd_cuda`` (``csrc/interp_fwd.cu``) replaces the TPU kernel
``paradis_tpu/ops/interp_pallas.py:_fwd_kernel`` (``interp_fwd_route`` says
which of its two routes a field takes); ``interp_bwd_cuda``
(``csrc/interp_bwd.cu``) replaces ``_bwd_kernel``; ``interp_band_fwd_cuda``
(``csrc/interp_band_fwd.cu``) and ``interp_band_bwd_cuda``
(``csrc/interp_band_bwd.cu``) replace ``_fwd_kernel_banded`` and
``_bwd_kernel_banded``; ``interp_chunk_fwd_cuda`` (``csrc/interp_chunk_fwd.cu``)
and ``interp_chunk_bwd_cuda`` (``csrc/interp_chunk_bwd.cu``) replace
``_fwd_kernel_chunked`` and ``_bwd_kernel_chunked``.  Bicubic: the banded
and row-chunked forwards, and the unbanded one on a field too large to keep
resident, launch one window kernel (``csrc/interp_stage.cuh``); the three
backwards launch one row-slab kernel (``csrc/interp_stage_bwd.cuh``).
Bilinear: the three forwards launch one forward (resident where a channel
group's whole field fits in shared memory, else tiled) and the three
backwards one tiled backward (``csrc/interp_bilinear.cuh``).  The banded
entry points run with a per-position band filter.  Each wrapper launches
its kernel on CUDA tensors or raises: there is no fallback.  The pairing is
two ``torch.library`` custom ops, ``paradis::interp`` (``interp_op``) and
``paradis::interp_bwd`` (``interp_bwd_op``), tied by
``register_autograd`` and each with a fake implementation (shapes and
dtypes, no launch), so that a selective-checkpoint policy can name the
forward and ``torch.export`` can trace both; ``interp`` calls the forward.
With a band plan they run the banded kernels, else with a chunk size the
row-chunked kernels, else the unbanded ones; on CPU tensors (or when asked
for ``plain``) the plain versions of ``ops/interp.py``,
``ops/interp_band.py`` and ``ops/interp_chunk.py``.

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
from paradis_torch.utils.tracing import span

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
# pos_y, pos_x, g, d_field, d_py, d_px and their scratch (``_bwd_outputs``);
# then B, P; then R, C, V, W (positions an arrival row), for a banded kernel
# rpb, band_rows, halo_lo, pad, for a chunked one rw; then mode, dtype, and
# for a backward g's dtype.  The weight-generation kernels take
# pos_y, pos_x, out; the element count; R, C, mode.  The contraction kernels
# (``ops/interp_mm.py``) take w, f, out, or field, py, px, g, d_field, d_py,
# d_px; then B·V, P; then R, C, and vb, pb or the field's dtype; then cdt.
# The route query of the forward takes R, C, mode, dtype and launches nothing.
_SIGNATURES = {
    "interp_fwd": ("interp_fwd", 4, 2, 6),
    "interp_fwd_route": ("interp_fwd", 0, 0, 4),
    "interp_bwd": ("interp_bwd", 8, 2, 7),
    "interp_band_fwd": ("interp_band_fwd", 4, 2, 10),
    "interp_band_bwd": ("interp_band_bwd", 8, 2, 11),
    "interp_chunk_fwd": ("interp_chunk_fwd", 4, 2, 7),
    "interp_chunk_bwd": ("interp_chunk_bwd", 8, 2, 8),
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


def interp_fwd_route(field: torch.Tensor, mode: str = "bicubic") -> str:
    """The route ``interp_fwd_cuda`` takes for ``field`` [B, R, C, V] on its
    CUDA device: bilinear, ``"bilinear"`` (the route of
    ``csrc/interp_bilinear.cuh``, which every bilinear forward takes);
    bicubic, ``"resident"`` where two slabs of a channel group's whole R × C
    field fit in shared memory, else ``"window"`` (each tile's own row
    window, the row-chunked forward's staging)."""
    check_mode(mode)
    if field.dim() != 4 or field.dtype not in _DTYPES or field.device.type != "cuda":
        raise ValueError(f"expected a float32 or bfloat16 field [B,R,C,V] on a CUDA device; "
                         f"got {field.dtype} {tuple(field.shape)} on {field.device}")
    fn = _kernel("interp_fwd_route")
    with torch.cuda.device(field.device):
        route = fn(field.shape[1], field.shape[2], _MODES[mode], _DTYPES[field.dtype], None)
    if route not in (0, 1, 2):
        raise RuntimeError(f"interp_fwd route query failed with CUDA error {-route}")
    return ("resident", "window", "bilinear")[route]


def interp_fwd_cuda(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                    mode: str = "bicubic") -> torch.Tensor:
    """Launch the forward kernel: field [B, R, C, V] (fp32 or bf16), positions
    [B, H, W, V] fp32, all contiguous on one CUDA device → [B, H, W, V].
    Raises where the field takes the window route and one of its rows of one
    channel does not fit the card's shared memory."""
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
                 B, H * W, R, C, V, W, _MODES[mode], _DTYPES[field.dtype],
                 _stream(field.device))
    if err != 0:
        raise RuntimeError(f"interp_fwd kernel launch failed with CUDA error {err} "
                           f"(a row of {C} columns may not fit in shared memory)")
    launches += 1
    return out


# positions a span of the backward's pre-pass summarises: ``kSpanPos`` of
# ``csrc/interp_stage_bwd.cuh``, whose ``span_ints`` sizes the scratch the
# same way (change both together)
_SPAN_POSITIONS = 32


def _bwd_outputs(field: torch.Tensor, H: int, W: int, mode: str):
    """``(d_field, d_py, d_px, scratch)`` of the backward kernels,
    uninitialised: the kernels write every element, d_field in the field's
    dtype.  ``scratch`` is theirs: bicubic, the span, int32 [B,
    ceil(V / 2), ceil(H·W / 32), 2], the first and last head row of each
    chunk of 32 positions of each channel pair; bilinear, the float32
    accumulator [B, R, C, V] of a bf16 d_field (empty for a float32 one)."""
    B, R, C, V = field.shape
    d_field = torch.empty((B, R, C, V), dtype=field.dtype, device=field.device)
    d_py = torch.empty((B, H, W, V), dtype=torch.float32, device=field.device)
    if mode == "bicubic":
        scratch = torch.empty((B, (V + 1) // 2, -(-H * W // _SPAN_POSITIONS), 2),
                              dtype=torch.int32, device=field.device)
    else:
        shape = (B, R, C, V) if field.dtype == torch.bfloat16 else (0,)
        scratch = torch.empty(shape, dtype=torch.float32, device=field.device)
    return d_field, d_py, torch.empty_like(d_py), scratch


def interp_bwd_cuda(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                    g: torch.Tensor, mode: str = "bicubic"):
    """Launch the backward kernel for the output cotangent ``g`` [B, H, W, V]
    (fp32 or bf16): ``(d_field, d_py, d_px)``, d_field in the field's dtype,
    the position gradients in float32.  Arguments as ``interp_fwd_cuda``.
    Raises where a slab of one field row of one channel (its accumulator and
    the taps' halo) does not fit the card's shared memory."""
    global bwd_launches
    _check(field, pix_y, pix_x, mode, g=g)
    B, R, C, V = field.shape
    H, W = pix_y.shape[1], pix_y.shape[2]
    d_field, d_py, d_px, scratch = _bwd_outputs(field, H, W, mode)
    if d_py.numel() == 0:
        return d_field.zero_(), d_py, d_px
    fn = _kernel("interp_bwd")
    with torch.cuda.device(field.device):
        err = fn(field.data_ptr(), pix_y.data_ptr(), pix_x.data_ptr(), g.data_ptr(),
                 d_field.data_ptr(), d_py.data_ptr(), d_px.data_ptr(), scratch.data_ptr(), B,
                 H * W, R, C, V, W, _MODES[mode], _DTYPES[field.dtype], _DTYPES[g.dtype],
                 _stream(field.device))
    if err != 0:
        raise RuntimeError(f"interp_bwd kernel launch failed with CUDA error {err} "
                           f"(a row of {C} columns may not fit in shared memory)")
    bwd_launches += 1
    return d_field, d_py, d_px


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
    plus the band plan of ``interp_band.band_spec``.  Each position's taps are
    limited to its band (``interp_band_plain``'s function on any positions);
    on positions clamped to the plan the result equals ``interp_fwd_cuda``'s
    bitwise.  Raises where one field row of one channel does not fit the
    card's shared memory."""
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
        raise RuntimeError(f"interp_band_fwd kernel launch failed with CUDA error {err} "
                           f"(a row of {C} columns may not fit in shared memory)")
    band_launches += 1
    return out


def interp_band_bwd_cuda(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                         g: torch.Tensor, spec, mode: str = "bicubic"):
    """Launch the row-banded backward kernel: ``(d_field, d_py, d_px)`` as
    ``interp_bwd_cuda``, each position's taps limited to its band in the plan
    ``spec`` (``interp_band_bwd_plain``'s function on any positions); on
    positions clamped to the plan, d_py and d_px equal ``interp_bwd_cuda``'s
    bitwise.  Raises as ``interp_bwd_cuda``."""
    global band_bwd_launches
    _check(field, pix_y, pix_x, mode, g=g)
    plan = _check_spec(field, pix_y, spec)
    B, R, C, V = field.shape
    H, W = pix_y.shape[1], pix_y.shape[2]
    d_field, d_py, d_px, scratch = _bwd_outputs(field, H, W, mode)
    if d_py.numel() == 0:
        return d_field.zero_(), d_py, d_px
    fn = _kernel("interp_band_bwd")
    with torch.cuda.device(field.device):
        err = fn(field.data_ptr(), pix_y.data_ptr(), pix_x.data_ptr(), g.data_ptr(),
                 d_field.data_ptr(), d_py.data_ptr(), d_px.data_ptr(), scratch.data_ptr(), B,
                 H * W, R, C, V, *plan, _MODES[mode], _DTYPES[field.dtype], _DTYPES[g.dtype],
                 _stream(field.device))
    if err != 0:
        raise RuntimeError(f"interp_band_bwd kernel launch failed with CUDA error {err} "
                           f"(a row of {C} columns may not fit in shared memory)")
    band_bwd_launches += 1
    return d_field, d_py, d_px


def interp_chunk_fwd_cuda(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                          rw: int, mode: str = "bicubic") -> torch.Tensor:
    """Launch the row-chunked forward kernel: arguments as ``interp_fwd_cuda``
    plus ``rw`` rows a chunk (checked; the kernel stages its tiles' own row
    windows, whatever ``rw``).  Raises where one field row of one channel
    does not fit the card's shared memory."""
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
                 B, H * W, R, C, V, W, rw, _MODES[mode], _DTYPES[field.dtype],
                 _stream(field.device))
    if err != 0:
        raise RuntimeError(f"interp_chunk_fwd kernel launch failed with CUDA error {err} "
                           f"(a row of {C} columns may not fit in shared memory)")
    chunk_launches += 1
    return out


def interp_chunk_bwd_cuda(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                          g: torch.Tensor, rw: int, mode: str = "bicubic"):
    """Launch the row-chunked backward kernel: ``(d_field, d_py, d_px)`` as
    ``interp_bwd_cuda``, plus ``rw`` rows a chunk (checked; the kernel is
    ``interp_bwd_cuda``'s, whatever ``rw``).  Raises as ``interp_bwd_cuda``."""
    global chunk_bwd_launches
    _check(field, pix_y, pix_x, mode, g=g)
    check_rw(rw)
    B, R, C, V = field.shape
    H, W = pix_y.shape[1], pix_y.shape[2]
    d_field, d_py, d_px, scratch = _bwd_outputs(field, H, W, mode)
    if d_py.numel() == 0:
        return d_field.zero_(), d_py, d_px
    fn = _kernel("interp_chunk_bwd")
    with torch.cuda.device(field.device):
        err = fn(field.data_ptr(), pix_y.data_ptr(), pix_x.data_ptr(), g.data_ptr(),
                 d_field.data_ptr(), d_py.data_ptr(), d_px.data_ptr(), scratch.data_ptr(), B,
                 H * W, R, C, V, W, rw, _MODES[mode], _DTYPES[field.dtype], _DTYPES[g.dtype],
                 _stream(field.device))
    if err != 0:
        raise RuntimeError(f"interp_chunk_bwd kernel launch failed with CUDA error {err} "
                           f"(a row of {C} columns may not fit in shared memory)")
    chunk_bwd_launches += 1
    return d_field, d_py, d_px


def _spec(band: list[int], max_dy: float):
    """The band plan of ``interp_band.band_spec`` from the ops' arguments
    (None for an empty ``band``)."""
    return (*band, max_dy) if band else None


@torch.library.custom_op("paradis::interp", mutates_args=())
def interp_op(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor, mode: str,
              plain: bool, band: list[int], max_dy: float, chunk: int) -> torch.Tensor:
    """The forward op: with a band plan (``band``, the four integers of
    ``band_spec``, and ``max_dy``; ``band`` empty for none) the row-banded
    kernel, else with ``chunk`` > 0 rows the row-chunked kernel, else the
    unbanded one (the priority of ``_fwd_tv``); the plain versions on CPU
    tensors or with ``plain``."""
    spec = _spec(band, max_dy)
    use_plain = plain or field.device.type == "cpu"
    if spec is not None:
        fwd = interp_band_plain if use_plain else interp_band_fwd_cuda
        return fwd(field, pix_y, pix_x, spec, mode)
    if chunk:
        fwd = interp_chunk_plain if use_plain else interp_chunk_fwd_cuda
        return fwd(field, pix_y, pix_x, chunk, mode)
    if use_plain:
        return interp_plain(field, pix_y, pix_x, mode)
    return interp_fwd_cuda(field, pix_y, pix_x, mode)


@torch.library.custom_op("paradis::interp_bwd", mutates_args=())
def interp_bwd_op(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                  g: torch.Tensor, mode: str, plain: bool, band: list[int], max_dy: float,
                  chunk: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward op for the cotangent ``g``: ``(d_field, d_py, d_px)`` of
    the pair ``interp_op``'s arguments select."""
    spec = _spec(band, max_dy)
    use_plain = plain or field.device.type == "cpu"
    g = g.contiguous()
    if spec is not None:
        bwd = interp_band_bwd_plain if use_plain else interp_band_bwd_cuda
        return bwd(field, pix_y, pix_x, g, spec, mode)
    if chunk:
        bwd = interp_chunk_bwd_plain if use_plain else interp_chunk_bwd_cuda
        return bwd(field, pix_y, pix_x, g, chunk, mode)
    bwd = interp_bwd_plain if use_plain else interp_bwd_cuda
    return bwd(field, pix_y, pix_x, g, mode)


@interp_op.register_fake
def _interp_fake(field, pix_y, pix_x, mode, plain, band, max_dy, chunk):
    return field.new_empty(pix_y.shape)


@interp_bwd_op.register_fake
def _interp_bwd_fake(field, pix_y, pix_x, g, mode, plain, band, max_dy, chunk):
    return (field.new_empty(field.shape), pix_y.new_empty(pix_y.shape, dtype=torch.float32),
            pix_y.new_empty(pix_y.shape, dtype=torch.float32))


def _interp_setup(ctx, inputs, output):
    field, pix_y, pix_x, *args = inputs
    ctx.save_for_backward(field, pix_y, pix_x)
    ctx.args = args


def _interp_backward(ctx, g):
    with span("interpolation_bwd"):
        d_field, d_py, d_px = interp_bwd_op(*ctx.saved_tensors, g, *ctx.args)
    return d_field, d_py, d_px, None, None, None, None, None


interp_op.register_autograd(_interp_backward, setup_context=_interp_setup)


def interp(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor, mode: str,
           plain: bool = False, spec=None, chunk: int = 0) -> torch.Tensor:
    """Gather-interpolation with the backward of the JAX package's VJP,
    through the ops ``paradis::interp`` / ``paradis::interp_bwd``: with
    ``plain`` false a CUDA tensor goes to the kernels and a CPU tensor to the
    plain versions; with ``plain`` true the plain versions run on any device.
    The pair: a band plan ``spec`` (``interp_band.band_spec``) selects the
    row-banded pair; else ``chunk`` > 0 rows the row-chunked pair; else the
    unbanded one.  The backward is not differentiable again (the kernels
    have no backward of their own)."""
    band, max_dy = ([], 0.0) if spec is None else (list(spec[:4]), float(spec[4]))
    return interp_op(field, pix_y, pix_x, mode, plain, band, max_dy, chunk)
