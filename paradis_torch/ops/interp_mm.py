"""The contractions of the dense interpolation alone: the matrix-unit phase,
isolated for the microbenchmark (``paradis_torch/tools/bench_interp.py``).

Port of the function of ``mm_kernel``, ``mmT_kernel`` and ``bwd_mm_kernel``
in ``scripts/bench_interp.py``, on the bench's synthetic channel-major
operands (the layout is what tells ``mm`` and ``mmT`` apart), per (b, v)
plane:

- ``mm``: wx [B,V,P,C], f [B,V,R,C] → ``out[p] = Σ_r Σ_c cdt(wx[p,c])·cdt(f[r,c])``;
- ``mmT``: the same function with wx stored transposed, wxT [B,V,C,P];
- ``bwd_mm``: field [B,V,R,C], py, px, g [B,V,P] → ``(d_field, d_py, d_px)``
  of the dense backward body with the bench's stand-in weights
  ``wy[r,p] = py[p]·r`` and ``wx[c,p] = px[p]·c``:
  ``wx2 = cdt(concat_p(wx, 0.5·wx))``, ``tt = f @ wx2`` [R, 2P],
  ``d_py = g·Σ_r 0.5·wy·tt[:, :P]``, ``d_px = g·Σ_r wy·tt[:, P:]``,
  ``d_field = Σ_p cdt(wy·g)[r,p]·wx2[c,p]`` (p < P).

``cdt`` is ``torch.float32`` or ``torch.bfloat16``: operands are rounded to
it, products and sums are float32 (bf16 × bf16 → f32), outputs float32.

``mm_cuda``, ``mmT_cuda`` and ``bwd_mm_cuda`` launch the kernels of
``csrc/interp_mm.cu`` on contiguous CUDA tensors or raise; ``mm``, ``mmT``
and ``bwd_mm`` send CPU tensors to the plain versions and any other tensor
to the kernels.  ``mm_launches``, ``mmT_launches`` and ``bwd_mm_launches``
count the launches of the three wrappers.
"""

from __future__ import annotations

import torch

from paradis_torch.ops.interp_cuda import _DTYPES, _kernel, _stream

mm_launches = 0
mmT_launches = 0
bwd_mm_launches = 0


def _rounded(x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``cdt`` and held in float32 (products of bf16 values
    are exact in float32, so a float32 product of these is bf16 × bf16 → f32)."""
    if cdt not in _DTYPES:
        raise TypeError(f"compute dtype must be float32 or bfloat16, got {cdt}")
    return x.to(cdt).float()


def mm_plain(wx: torch.Tensor, f: torch.Tensor, cdt: torch.dtype = torch.float32) -> torch.Tensor:
    """``Σ_r Σ_c cdt(wx)·cdt(f)``: wx [B,V,P,C], f [B,V,R,C] → [B,V,P] float32
    (the [P, R] products of each plane, then the sum over r)."""
    return torch.matmul(_rounded(wx, cdt), _rounded(f, cdt).transpose(-1, -2)).sum(-1)


def mmT_plain(wxT: torch.Tensor, f: torch.Tensor, cdt: torch.dtype = torch.float32) -> torch.Tensor:
    """``mm_plain`` with wx stored transposed: wxT [B,V,C,P] → [B,V,P]."""
    return torch.matmul(_rounded(f, cdt), _rounded(wxT, cdt)).sum(-2)


def bwd_mm_plain(field_t: torch.Tensor, py: torch.Tensor, px: torch.Tensor, g: torch.Tensor,
                 cdt: torch.dtype = torch.bfloat16):
    """The dense backward body with stand-in weights: field_t [B,V,R,C],
    py, px, g [B,V,P] → ``(d_field [B,V,R,C], d_py, d_px [B,V,P])``, float32."""
    R, C = field_t.shape[-2:]
    py, px, g = py.float(), px.float(), g.float()
    rows = torch.arange(R, dtype=torch.float32, device=py.device)
    cols = torch.arange(C, dtype=torch.float32, device=px.device)
    wy = py[..., None, :] * rows[:, None]                               # [B,V,R,P]
    wxa = px[..., None, :] * cols[:, None]                              # [B,V,C,P]
    wx2 = _rounded(torch.cat([wxa, wxa * 0.5], dim=-1), cdt)            # [B,V,C,2P]
    tt = torch.matmul(_rounded(field_t, cdt), wx2)                      # [B,V,R,2P]
    P = py.shape[-1]
    d_py = g * (wy * 0.5 * tt[..., :P]).sum(-2)
    d_px = g * (wy * tt[..., P:]).sum(-2)
    wyg = _rounded(wy * g[..., None, :], cdt)
    d_field = torch.matmul(wyg, wx2[..., :P].transpose(-1, -2))         # [B,V,R,C]
    return d_field, d_py, d_px


def _check(tensors: dict, float32: tuple = ()) -> None:
    """All on one CUDA device, contiguous, 16-byte aligned; those named in
    ``float32`` of that dtype."""
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name} is on {t.device}; all inputs must be on one CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        if name in float32 and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def _launch_mm(name: str, w: torch.Tensor, f: torch.Tensor, P: int, cdt, vb: int,
               pb: int) -> torch.Tensor:
    _check({"w": w, "f": f}, float32=("w", "f"))
    if cdt not in _DTYPES:
        raise TypeError(f"compute dtype must be float32 or bfloat16, got {cdt}")
    if vb < 1 or pb < 1:
        raise ValueError(f"channel and position blocks must be positive, got vb={vb}, pb={pb}")
    B, V, R, C = f.shape
    out = torch.empty((B, V, P), dtype=torch.float32, device=f.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(f.device):
        err = _kernel(name)(w.data_ptr(), f.data_ptr(), out.data_ptr(), B * V, P, R, C, vb, pb,
                            _DTYPES[cdt], _stream(f.device))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    return out


def mm_cuda(wx: torch.Tensor, f: torch.Tensor, cdt: torch.dtype = torch.float32, vb: int = 8,
            pb: int = 1024) -> torch.Tensor:
    """Launch the contraction kernel on float32 wx [B,V,P,C] and f [B,V,R,C]:
    ``mm_plain``'s function, a block taking ``vb`` planes and ``pb`` positions."""
    global mm_launches
    if wx.dim() != 4 or f.dim() != 4 or wx.shape[:2] != f.shape[:2] or wx.shape[3] != f.shape[3]:
        raise ValueError(f"expected wx [B,V,P,C] and f [B,V,R,C]; got {tuple(wx.shape)}, "
                         f"{tuple(f.shape)}")
    out = _launch_mm("interp_mm", wx, f, wx.shape[2], cdt, vb, pb)
    mm_launches += 1
    return out


def mmT_cuda(wxT: torch.Tensor, f: torch.Tensor, cdt: torch.dtype = torch.bfloat16, vb: int = 8,
             pb: int = 1024) -> torch.Tensor:
    """Launch the transposed contraction kernel on float32 wxT [B,V,C,P] and f
    [B,V,R,C]: ``mmT_plain``'s function."""
    global mmT_launches
    if wxT.dim() != 4 or f.dim() != 4 or wxT.shape[:3] != (*f.shape[:2], f.shape[3]):
        raise ValueError(f"expected wxT [B,V,C,P] and f [B,V,R,C]; got {tuple(wxT.shape)}, "
                         f"{tuple(f.shape)}")
    out = _launch_mm("interp_mmT", wxT, f, wxT.shape[3], cdt, vb, pb)
    mmT_launches += 1
    return out


def bwd_mm_cuda(field_t: torch.Tensor, py: torch.Tensor, px: torch.Tensor, g: torch.Tensor,
                cdt: torch.dtype = torch.bfloat16):
    """Launch the dense-backward contraction kernel: field_t [B,V,R,C] float32
    or bfloat16, py, px, g [B,V,P] float32 → ``bwd_mm_plain``'s
    ``(d_field, d_py, d_px)``, float32.  One block a plane; no atomics."""
    global bwd_mm_launches
    if field_t.dim() != 4 or py.dim() != 3 or py.shape[:2] != field_t.shape[:2]:
        raise ValueError(f"expected field [B,V,R,C] and positions [B,V,P]; got "
                         f"{tuple(field_t.shape)}, {tuple(py.shape)}")
    for name, t in (("px", px), ("g", g)):
        if t.shape != py.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match py {tuple(py.shape)}")
    _check({"field": field_t, "py": py, "px": px, "g": g}, float32=("py", "px", "g"))
    if field_t.dtype not in _DTYPES or cdt not in _DTYPES:
        raise TypeError(f"field and compute dtypes must be float32 or bfloat16, got "
                        f"{field_t.dtype}, {cdt}")
    B, V, R, C = field_t.shape
    P = py.shape[2]
    d_field = torch.empty((B, V, R, C), dtype=torch.float32, device=py.device)
    d_py = torch.empty_like(py)
    d_px = torch.empty_like(py)
    if d_field.numel() == 0 or P == 0:
        return d_field.zero_(), d_py, d_px
    with torch.cuda.device(py.device):
        err = _kernel("interp_bwd_mm")(
            field_t.data_ptr(), py.data_ptr(), px.data_ptr(), g.data_ptr(), d_field.data_ptr(),
            d_py.data_ptr(), d_px.data_ptr(), B * V, P, R, C, _DTYPES[field_t.dtype],
            _DTYPES[cdt], _stream(py.device))
    if err != 0:
        raise RuntimeError(f"interp_bwd_mm kernel launch failed with CUDA error {err} "
                           f"(one plane of {R} x {C} may not fit in shared memory)")
    bwd_mm_launches += 1
    return d_field, d_py, d_px


def mm(wx, f, cdt: torch.dtype = torch.float32, vb: int = 8, pb: int = 1024) -> torch.Tensor:
    """``mm_plain`` on CPU tensors, the kernel on any other."""
    if wx.device.type == "cpu":
        return mm_plain(wx, f, cdt)
    return mm_cuda(wx, f, cdt, vb, pb)


def mmT(wxT, f, cdt: torch.dtype = torch.bfloat16, vb: int = 8, pb: int = 1024) -> torch.Tensor:
    """``mmT_plain`` on CPU tensors, the kernel on any other."""
    if wxT.device.type == "cpu":
        return mmT_plain(wxT, f, cdt)
    return mmT_cuda(wxT, f, cdt, vb, pb)


def bwd_mm(field_t, py, px, g, cdt: torch.dtype = torch.bfloat16):
    """``bwd_mm_plain`` on CPU tensors, the kernel on any other."""
    fn = bwd_mm_plain if py.device.type == "cpu" else bwd_mm_cuda
    return fn(field_t, py, px, g, cdt)
