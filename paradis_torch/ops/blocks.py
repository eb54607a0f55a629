"""Building-block layers of the PARADIS physics network (channels-last).

Port of ``paradis_tpu/ops/blocks.py``.  Module and parameter names mirror the
flax tree (``layer0_CLinear.conv.weight`` for ``layer0_CLinear/conv/kernel``)
so the weight bridge (``model/weights.py``) is a renaming plus transposes.

Mixed precision follows the JAX package: parameters are float32, each module
casts them to its compute ``dtype`` at use, except ``ChannelNorm`` and
``GlobalBias``, which compute in float32.  Every module draws its initial
values from the ``torch.Generator`` it is built with.

Inside ``sphere.partition.spatial_rules`` the layers run on a rank's block: the
pads of ``SepConv`` and ``PhysicalDownsample`` exchange halos
(``sphere/padding.py``) and ``GlobalBias`` takes the block's rows of ``U``
and columns of ``V`` (all of them along an axis that the grid of the
enclosing rules has collapsed, ``RankGrid.fit``); the rest is pointwise.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from paradis_torch.sphere.padding import geocyclic_pad
from paradis_torch.sphere.partition import spatial_grid, spatial_rules


def _normal(shape, std: float, gen: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=gen) * std)


def _uniform(shape, bound: float, gen: torch.Generator) -> nn.Parameter:
    return nn.Parameter((torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound)


def _kaiming(shape, fan_in: int, scale: float, gen: torch.Generator) -> nn.Parameter:
    """He fan-in normal (relu gain) times ``scale``: std = scale·sqrt(2/fan_in)."""
    return _normal(shape, scale * math.sqrt(2.0 / fan_in), gen)


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation registry (SiLU, exact-erf GELU)."""
    table = {"SiLU": F.silu, "GELU": F.gelu}
    if name not in table:
        raise ValueError(f"Unknown activation_fn {name!r}. Allowed: {list(table)}")
    return table[name]


class _Dense(nn.Module):
    """``y = x Wᵀ + b`` in the compute dtype; ``weight`` is [out, in]."""

    def __init__(self, in_dim: int, out_dim: int, *, init: str, scale: float,
                 use_bias: bool, dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        if init == "kaiming":
            self.weight = _kaiming((out_dim, in_dim), in_dim, scale, generator)
            self.bias = nn.Parameter(torch.zeros(out_dim)) if use_bias else None
        else:  # torch-default U(±1/sqrt(fan_in)) for weight and bias
            bound = 1.0 / math.sqrt(in_dim)
            self.weight = _uniform((out_dim, in_dim), bound, generator)
            self.bias = _uniform((out_dim,), bound, generator) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class CLinear(nn.Module):
    """Channel-wise linear map (the reference's 1×1 conv), kaiming init."""

    def __init__(self, in_dim: int, out_dim: int, *, kernel_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator):
        super().__init__()
        self.conv = _Dense(in_dim, out_dim, init="kaiming", scale=kernel_scale,
                           use_bias=True, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class _Depthwise(nn.Module):
    """Depthwise k×k conv on a pre-padded field as a shift-and-FMA stencil.

    Products in the compute dtype, sums in float32 (the conv accumulator
    semantics under mixed precision), as ``paradis_tpu.ops.blocks._Depthwise``.
    ``weight`` is [C, 1, k, k] (torch's depthwise ``Conv2d`` layout).
    """

    def __init__(self, kernel_size: int, features: int, *, bound: float | None = None,
                 std: float | None = None, use_bias: bool = False,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator):
        super().__init__()
        k = kernel_size
        self.kernel_size = k
        self.dtype = dtype
        shape = (features, 1, k, k)
        self.weight = (_normal(shape, std, generator) if std is not None
                       else _uniform(shape, bound, generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, xpad: torch.Tensor) -> torch.Tensor:
        k, dt = self.kernel_size, self.dtype
        kd = self.weight.to(dt)
        xpad = xpad.to(dt)
        out_h = xpad.shape[-3] - (k - 1)
        out_w = xpad.shape[-2] - (k - 1)
        acc = torch.zeros(xpad.shape[:-3] + (out_h, out_w, xpad.shape[-1]),
                          dtype=torch.float32, device=xpad.device)
        for i in range(k):
            for j in range(k):
                tap = xpad[..., i : i + out_h, j : j + out_w, :]
                if dt == torch.float32:  # same sums, one kernel per tap instead of two
                    acc.addcmul_(tap, kd[:, 0, i, j])
                else:
                    acc.add_(tap * kd[:, 0, i, j])
        out = acc.to(dt)
        if self.bias is not None:
            out = out + self.bias.to(dt)
        return out


class SepConv(nn.Module):
    """Separable conv: geocyclic pad → depthwise k×k → pointwise 1×1."""

    def __init__(self, in_dim: int, out_dim: int, *, kernel_size: int = 3,
                 kernel_scale: float = 1.0, init_mode: str = "kaiming",
                 dtype: torch.dtype = torch.float32, generator: torch.Generator):
        super().__init__()
        k = kernel_size
        self.pad = (k - 1) // 2
        if init_mode == "kaiming":
            self.depthwise = _Depthwise(k, in_dim, std=math.sqrt(2.0 / (k * k)),
                                        dtype=dtype, generator=generator)
            self.pointwise = _Dense(in_dim, out_dim, init="kaiming", scale=kernel_scale,
                                    use_bias=True, dtype=dtype, generator=generator)
        elif init_mode == "torch_default":
            self.depthwise = _Depthwise(k, in_dim, bound=1.0 / k, dtype=dtype,
                                        generator=generator)
            self.pointwise = _Dense(in_dim, out_dim, init="torch_default", scale=1.0,
                                    use_bias=True, dtype=dtype, generator=generator)
        else:
            raise ValueError(f"init_mode must be kaiming|torch_default, got {init_mode!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(geocyclic_pad(x, self.pad)))


class ChannelNorm(nn.Module):
    """LayerNorm over channels with unbiased variance and float32 statistics."""

    def __init__(self, channels: int, *, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.square(xf - mean).sum(dim=-1, keepdim=True) / max(c - 1, 1)
        y = (xf - mean) * torch.rsqrt(self.eps + var) * self.weight + self.bias
        return y.to(self.dtype)


class GlobalBias(nn.Module):
    """Low-rank spatial bias ``y = x + proj(Σ_k A_ck u_k v_kᵀ)`` in float32.

    A, U, V ~ N(0, 1e-3²); the optional ``projection`` ([out, C_b]) has the
    torch-Linear default init and is present when C_b ≠ C_out.
    """

    def __init__(self, bias_channels: int, output_dim: int, mesh_size: tuple[int, int],
                 *, rank: int = 128, generator: torch.Generator):
        super().__init__()
        H, W = mesh_size
        self.A = _normal((bias_channels, rank), 1e-3, generator)
        self.U = _normal((rank, H), 1e-3, generator)
        self.V = _normal((rank, W), 1e-3, generator)
        self.projection = (
            _uniform((output_dim, bias_channels), 1.0 / math.sqrt(bias_channels), generator)
            if bias_channels != output_dim else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        U, V = self.U, self.V
        grid = spatial_grid()
        if grid is not None:  # this rank's block of the maps
            U, V = U[:, grid.rows(U.shape[1])], V[:, grid.cols(V.shape[1])]
        maps = torch.einsum("ck,kh,kw->hwc", self.A, U, V)
        if self.projection is not None:
            maps = maps @ self.projection.t()
        return x + maps.to(x.dtype)


class PhysicalDownsample(nn.Module):
    """Anti-aliased downsample: geocyclic pad(2) + 5×5 mean, stride ``s``.

    Runs even at stride 1, where it is a 5×5 smoothing pass.  Sums in float32.
    On a rank's block (``sphere.partition.spatial_rules``) the output is the
    rank's block of the whole output on ``RankGrid.fit``'s grid of it.  Where
    the strided rows and columns start every block (a block's extent along
    each split axis a multiple of the stride) the block is downsampled in
    place, its pad's halos exchanged; else the whole field is gathered over
    the spatial group, downsampled whole and cut to the block (the gather's
    adjoint sums each rank's share of the cotangent).
    """

    def __init__(self, stride: int = 4):
        super().__init__()
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = x.dtype
        H, W = x.shape[-3], x.shape[-2]
        s = self.stride
        grid = spatial_grid()
        if grid is not None and ((grid.lat > 1 and H % s) or (grid.space > 1 and W % s)):
            with spatial_rules(None):
                whole = self(grid.gather(x))
            return grid.fit(whole.shape[-3], whole.shape[-2]).block(whole)
        h_out, w_out = (H - 1) // s + 1, (W - 1) // s + 1
        xf = geocyclic_pad(x, 2).float()
        rows = None
        for i in range(5):
            sl = xf[..., i : i + (h_out - 1) * s + 1 : s, :, :]
            rows = sl if rows is None else rows + sl
        acc = None
        for j in range(5):
            sl = rows[..., :, j : j + (w_out - 1) * s + 1 : s, :]
            acc = sl if acc is None else acc + sl
        return (acc * (1.0 / 25.0)).to(out_dtype)


def _normalize_seq(value, n, default):
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(f"expected {n} entries, got {len(value)}")
        return tuple(value)
    if value is None:
        value = default
    return (value,) * n


class GMBlock(nn.Module):
    """Generic Multilayer Block: a config-programmable layer stack.

    Optional pre-norm, a list of layer names (CLinear, SepConv, ChannelNorm,
    GlobalBias), hidden widths (``<= 0`` → max(in, out)), a GlobalBias after
    the first layer when ``bias_channels > 0``, activations between layers
    (and after the last when ``activation`` is true), kaiming init with the
    final conv scaled by 0.1.
    """

    def __init__(self, layers, input_dim: int, output_dim: int,
                 mesh_size: tuple[int, int], *, kernel_size=5, hidden_dim=0,
                 activation=False, activation_fn: str = "SiLU", bias_channels: int = 0,
                 bias_rank: int = 128, pre_normalize: bool = False,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator):
        super().__init__()
        names = tuple(layers)
        n = len(names)
        if n == 0:
            raise ValueError("GMBlock: must specify at least one layer")
        acts = _normalize_seq(activation, n, False)
        if not isinstance(activation, (list, tuple)):
            acts = (True,) * (n - 1) + (bool(activation),)
        ksizes = _normalize_seq(kernel_size, n, 5)
        if isinstance(hidden_dim, (list, tuple)):
            if len(hidden_dim) != n - 1:
                raise ValueError(f"expected {n - 1} hidden widths, got {len(hidden_dim)}")
            hidden = tuple(hidden_dim)
        else:
            h = hidden_dim
            if h is None or h <= 0:
                h = max(input_dim, output_dim)
            hidden = (h,) * (n - 1)
        self.act_fn = get_activation(activation_fn)
        self.acts = acts

        self.pre_norm = ChannelNorm(input_dim, dtype=dtype) if pre_normalize else None
        conv_layers = [i for i, l in enumerate(names) if l in ("CLinear", "SepConv")]
        last_conv_idx = conv_layers[-1] if conv_layers else -1

        self.layer_names: list[str] = []
        self.bias0_GlobalBias = None
        cur = input_dim
        for idx, lname in enumerate(names):
            out_dim = output_dim if idx == n - 1 else hidden[idx]
            scale = 0.1 if idx == last_conv_idx else 1.0
            name = f"layer{idx}_{lname}"
            if lname == "CLinear":
                mod = CLinear(cur, out_dim, kernel_scale=scale, dtype=dtype,
                              generator=generator)
            elif lname == "SepConv":
                mod = SepConv(cur, out_dim, kernel_size=ksizes[idx], kernel_scale=scale,
                              dtype=dtype, generator=generator)
            elif lname == "ChannelNorm":
                mod, out_dim = ChannelNorm(cur, dtype=dtype), cur
            elif lname == "GlobalBias":
                mod = GlobalBias(cur, out_dim, mesh_size, rank=bias_rank,
                                 generator=generator)
            else:
                raise ValueError(
                    f"Unknown layer type: {lname}. Available: "
                    f"['SepConv', 'CLinear', 'ChannelNorm', 'GlobalBias']")
            self.add_module(name, mod)
            self.layer_names.append(name)
            if idx == 0 and bias_channels > 0:
                self.bias0_GlobalBias = GlobalBias(bias_channels, out_dim, mesh_size,
                                                   rank=bias_rank, generator=generator)
            cur = out_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pre_norm is not None:
            x = self.pre_norm(x)
        for idx, name in enumerate(self.layer_names):
            x = getattr(self, name)(x)
            if idx == 0 and self.bias0_GlobalBias is not None:
                x = self.bias0_GlobalBias(x)
            if self.acts[idx]:
                x = self.act_fn(x)
        return x
