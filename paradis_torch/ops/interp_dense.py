"""Gather-free interpolation by dense separable kernel contraction.

Port of ``paradis_tpu/ops/interp.py:grid_sample_interp_dense``, the path
``compute.advection_impl: xla`` selects.  The interpolation kernel has
compact support, so instead of gathering taps it evaluates the kernel densely
over every row and column of the field, ``Wy[p,r] = K(py[p] − r)`` and
``Wx[p,c] = K(px[p] − c)``, and contracts, per (b, v) plane:

    T[p,c]  = Σ_r Wy[p,r] · field[r,c]        (batched matmul)
    out[p]  = Σ_c Wx[p,c] · T[p,c]            (multiply-reduce)

The dense rows only span the field, so a tap outside it contributes nothing,
and a non-finite position has no taps: the semantics of ``ops/interp.py``'s
plain version and of the kernels.  ``interp_dense`` runs it through the
custom op ``paradis::interp_dense``, whose backward op
(``paradis::interp_dense_bwd``) regenerates the dense rows and their
derivatives and runs the three contractions of the JAX package's custom VJP
(``_dense_vjp_bwd``); both ops have fake implementations, so that a
selective-checkpoint policy can name the forward.

This is plain PyTorch (``torch.matmul``) on every device: in the JAX package
it is XLA, not a Pallas kernel.  Compute dtype: the JAX package contracts
bfloat16 operands (accumulated in float32) only on the TPU, because "CPU dot
kernels lack BF16xBF16=F32" (``interp.py:234-239``, ``:197-198``); the port
takes the TPU branch on a CUDA device (a bfloat16 field gives bfloat16
operands; the forward's ``T`` is emitted in bfloat16 as there, the
backward's products in float32) and the float32 branch on the CPU.
"""

from __future__ import annotations

import torch

from paradis_torch.ops.interp import check_mode, kernel_derivative, tap_weights


def _dense_weights_via_taps(pos: torch.Tensor, size: int, mode: str,
                            derivative: bool = False):
    """Dense ``[..., size]`` weight rows (and their derivatives) from the tap
    scalars: the 4 (2 for bilinear) per-position tap values are routed to
    their rows through a select tree on ``rel = r − floor(pos)``, zero outside
    the taps' window and where ``pos`` is not finite."""
    i0, offsets, ws = tap_weights(pos, mode)
    if derivative:
        t = pos - i0
        dws = tuple(kernel_derivative(t - k, mode) for k in offsets)
    rel = torch.arange(size, dtype=torch.float32, device=pos.device) - i0[..., None]
    if mode == "bilinear":
        # taps (0, 1): one compare picks the value, one window zeroes the rest
        is0 = rel == 0.0
        inb = is0 | (rel == 1.0)

        def expand(vals):
            v = torch.where(is0, vals[0][..., None], vals[1][..., None])
            return torch.where(inb, v, 0.0)
    else:
        # taps (-1, 0, 1, 2): a two-level select tree and the support window
        ism1 = rel == -1.0
        lo_half = rel <= 0.0
        is1 = rel == 1.0
        inb = (rel >= -1.0) & (rel <= 2.0)

        def expand(vals):
            lo = torch.where(ism1, vals[0][..., None], vals[1][..., None])
            hi = torch.where(is1, vals[2][..., None], vals[3][..., None])
            return torch.where(inb, torch.where(lo_half, lo, hi), 0.0)

    w = expand(ws)
    return (w, expand(dws)) if derivative else w


def _channel_major(pos: torch.Tensor) -> torch.Tensor:
    """[B, H, W, V] → float32 [B, V, H·W]."""
    B, H, W, V = pos.shape
    return pos.float().reshape(B, H * W, V).transpose(1, 2)


def _from_channel_major(x: torch.Tensor, shape) -> torch.Tensor:
    """[B, V, H·W] → [B, H, W, V]."""
    return x.transpose(1, 2).reshape(shape)


def _compute_dtype(field: torch.Tensor) -> torch.dtype:
    """bfloat16 operands for a non-float32 field on a card, else float32."""
    if field.dtype == torch.float32 or field.device.type == "cpu":
        return torch.float32
    return torch.bfloat16


def _dense_impl(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                mode: str) -> torch.Tensor:
    """The forward: field [B, R, C, V], positions [B, H, W, V] → [B, H, W, V]
    in the field's dtype."""
    R, C = field.shape[1:3]
    cdt = _compute_dtype(field)
    wy = _dense_weights_via_taps(_channel_major(pix_y), R, mode).to(cdt)   # [B,V,P,R]
    wx = _dense_weights_via_taps(_channel_major(pix_x), C, mode).to(cdt)   # [B,V,P,C]
    field_t = field.permute(0, 3, 1, 2).to(cdt)                            # [B,V,R,C]
    t = torch.matmul(wy, field_t)                                          # [B,V,P,C] in cdt
    out = (wx.float() * t.float()).sum(-1)
    return _from_channel_major(out, pix_y.shape).to(field.dtype)


def _dot32(a: torch.Tensor, b: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``a @ b`` on operands rounded to ``cdt``, products and sums in float32
    (the JAX package's ``preferred_element_type=float32``)."""
    return torch.matmul(a.to(cdt).float(), b.to(cdt).float())


def _dense_vjp_bwd(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                   g: torch.Tensor, mode: str):
    """``(d_field, d_py, d_px)`` for the output cotangent ``g`` [B, H, W, V]:
    ``d_field = Σ_p Wy·g·Wx``, ``d_py = g·Σ_r K′y·(Σ_c Wx·f)`` and
    ``d_px = g·Σ_c K′x·(Σ_r Wy·f)``, in the dtypes of field and positions."""
    R, C = field.shape[1:3]
    cdt = _compute_dtype(field)
    gf = _channel_major(g)                                                  # [B,V,P]
    wy, dky = _dense_weights_via_taps(_channel_major(pix_y), R, mode, derivative=True)
    wx, dkx = _dense_weights_via_taps(_channel_major(pix_x), C, mode, derivative=True)
    field_t = field.permute(0, 3, 1, 2)                                     # [B,V,R,C]

    wyg = wy * gf[..., None]
    d_field = _dot32(wyg.transpose(-1, -2), wx, cdt)                        # [B,V,R,C]
    t = _dot32(wx, field_t.transpose(-1, -2), cdt)                          # [B,V,P,R]
    d_py = gf * (dky * t).sum(-1)
    u = _dot32(wy, field_t, cdt)                                            # [B,V,P,C]
    d_px = gf * (dkx * u).sum(-1)
    return (d_field.permute(0, 2, 3, 1).to(field.dtype),
            _from_channel_major(d_py, pix_y.shape).to(pix_y.dtype),
            _from_channel_major(d_px, pix_x.shape).to(pix_x.dtype))


@torch.library.custom_op("paradis::interp_dense", mutates_args=())
def interp_dense_op(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                    mode: str) -> torch.Tensor:
    """The forward op: field [B, R, C, V], positions [B, H, W, V] → [B, H, W, V]
    in the field's dtype."""
    check_mode(mode)
    return _dense_impl(field, pix_y, pix_x, mode)


@torch.library.custom_op("paradis::interp_dense_bwd", mutates_args=())
def interp_dense_bwd_op(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                        g: torch.Tensor, mode: str
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward op: ``(d_field, d_py, d_px)`` for the cotangent ``g``."""
    return _dense_vjp_bwd(field, pix_y, pix_x, g, mode)


# the fakes lay their outputs out as the ops do: channel-major results
# viewed channels-last
@interp_dense_op.register_fake
def _dense_fake(field, pix_y, pix_x, mode):
    B, H, W, V = pix_y.shape
    return _from_channel_major(field.new_empty((B, V, H * W)), pix_y.shape)


@interp_dense_bwd_op.register_fake
def _dense_bwd_fake(field, pix_y, pix_x, g, mode):
    B, R, C, V = field.shape
    _, H, W, _ = pix_y.shape
    return (field.new_empty((B, V, R, C)).permute(0, 2, 3, 1),
            _from_channel_major(pix_y.new_empty((B, V, H * W)), pix_y.shape),
            _from_channel_major(pix_x.new_empty((B, V, H * W)), pix_x.shape))


def _dense_setup(ctx, inputs, output):
    field, pix_y, pix_x, mode = inputs
    ctx.save_for_backward(field, pix_y, pix_x)
    ctx.mode = mode


def _dense_backward(ctx, g):
    d_field, d_py, d_px = interp_dense_bwd_op(*ctx.saved_tensors, g, ctx.mode)
    return d_field, d_py, d_px, None


interp_dense_op.register_autograd(_dense_backward, setup_context=_dense_setup)


def interp_dense(field: torch.Tensor, pix_y: torch.Tensor, pix_x: torch.Tensor,
                 mode: str = "bicubic") -> torch.Tensor:
    """Sample ``field`` [B, R, C, V] at ``(pix_y, pix_x)`` [B, H, W, V] by the
    dense contraction, through the op ``paradis::interp_dense`` with the JAX
    package's custom VJP (``paradis::interp_dense_bwd``).  The backward
    regenerates the dense rows from the positions rather than keeping them
    (they are O(P·V·(R+C)) a call); it is not differentiable again."""
    check_mode(mode)
    return interp_dense_op(field, pix_y, pix_x, mode)
