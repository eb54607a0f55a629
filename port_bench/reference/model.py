"""The PARADIS forward as plain PyTorch, written from the mathematics.

Parameters are a ``{name: tensor}`` dict under the names the benchmark
draws them by (the program's ``state_dict`` names); the architecture comes
from the configuration file's ``model`` block.  Fields are channels-last
``[B, H, W, C]``.  Every product runs in float32 unless ``rnd`` is given:
``rnd(x)`` rounds a tensor where the configuration computes in a lower
precision (the inputs and weights of each dense layer and stencil, and
their outputs), which is how the control computes the same model a step
lower (``port_bench/modes/common.py``'s ``fp8``).  The bicubic
interpolation is a gather of the 16 taps with zero outside the padded
field, ATen's cubic convolution with a = -0.75.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EARTH_ROTATION_RATE = 7.29212e-5   # rad/s
FAST_TRIG_MAX_RAD = 0.6            # displacement clamp of the fast departure trig
CUBIC_A = -0.75


def _same(x):
    return x


def grid_radians(nlat: int, nlon: int):
    """Equiangular latitudes without the poles and longitudes from 0, in
    radians (float64), as WeatherBench-2 lays out its grids."""
    delta = 180.0 / nlat
    lat = np.deg2rad(-90.0 + delta / 2.0 + delta * np.arange(nlat))
    lon = np.deg2rad(np.arange(nlon) * (360.0 / nlon))
    return lat, lon


def geocyclic_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Rows beyond each pole are the rows across it rolled half way round;
    longitudes wrap."""
    if pad == 0:
        return x
    W = x.shape[-2]
    top = torch.roll(x[..., 1:pad + 1, :, :], W // 2, dims=-2).flip(-3)
    bottom = torch.roll(x[..., -(pad + 1):-1, :, :], W // 2, dims=-2).flip(-3)
    x = torch.cat([top, x, bottom], dim=-3)
    return torch.cat([x[..., :, -pad:, :], x, x[..., :, :pad, :]], dim=-2)


class Reference:
    """The model of one configuration over a parameter dict."""

    def __init__(self, spec: dict, nlat: int, nlon: int, device, rnd=None,
                 checkpoint_layers: bool = False):
        self.spec = spec
        self.rnd = rnd or _same
        self.checkpoint_layers = checkpoint_layers
        self.num_layers = int(spec["num_layers"])
        self.num_vels = int(spec["velocity_vectors"])
        self.dt = float(spec["base_dt"]) * EARTH_ROTATION_RATE / self.num_layers
        lat, lon = grid_radians(nlat, nlon)
        lat_g, lon_g = np.meshgrid(lat, lon, indexing="ij")
        self.lat = torch.tensor(lat_g, dtype=torch.float32, device=device)
        self.lon = torch.tensor(lon_g, dtype=torch.float32, device=device)
        self.P: dict = {}

    # -- layers --------------------------------------------------------------

    def dense(self, x, name):
        r = self.rnd
        return r(F.linear(r(x), r(self.P[name + ".weight"]), r(self.P[name + ".bias"])))

    def depthwise(self, xpad, name):
        """A k×k stencil per channel on a padded field (valid positions)."""
        r = self.rnd
        w = r(self.P[name + ".weight"])                       # [C, 1, k, k]
        y = F.conv2d(r(xpad).permute(0, 3, 1, 2), w, groups=w.shape[0])
        y = r(y.permute(0, 2, 3, 1))
        b = self.P.get(name + ".bias")
        return y if b is None else r(y + r(b))

    def sepconv(self, x, name):
        k = self.P[name + ".depthwise.weight"].shape[-1]
        return self.dense(self.depthwise(geocyclic_pad(x, (k - 1) // 2), name + ".depthwise"),
                          name + ".pointwise")

    def channel_norm(self, x, name):
        x = x.float()
        c = x.shape[-1]
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().sum(-1, keepdim=True) / max(c - 1, 1)
        y = (x - mean) / torch.sqrt(var + 1e-5) * self.P[name + ".weight"] + self.P[name + ".bias"]
        return self.rnd(y)

    def global_bias(self, x, name):
        P = self.P
        maps = torch.einsum("ck,kh,kw->hwc", P[name + ".A"], P[name + ".U"], P[name + ".V"])
        if name + ".projection" in P:
            maps = maps @ P[name + ".projection"].t()
        return self.rnd(x + maps)

    def block(self, x, name, layers, *, activation=False, pre_norm=False, bias=False):
        """A configurable stack: optional pre-norm, the layers, a low-rank
        spatial bias after the first, SiLU between layers (and after the
        last with ``activation``)."""
        if pre_norm:
            x = self.channel_norm(x, name + ".pre_norm")
        n = len(layers)
        for i, kind in enumerate(layers):
            sub = f"{name}.layer{i}_{kind}"
            if kind == "CLinear":
                x = self.dense(x, sub + ".conv")
            elif kind == "SepConv":
                x = self.sepconv(x, sub)
            elif kind == "ChannelNorm":
                x = self.channel_norm(x, sub)
            elif kind == "GlobalBias":
                x = self.global_bias(x, sub)
            else:
                raise ValueError(f"unknown layer {kind!r}")
            if i == 0 and bias:
                x = self.global_bias(x, name + ".bias0_GlobalBias")
            if i < n - 1 or activation:
                x = self.rnd(F.silu(x))
        return x

    # -- advection -----------------------------------------------------------

    @staticmethod
    def pole_mean(x):
        W = x.shape[-2]
        south = x[..., :1, :, :].mean(-2, keepdim=True).expand(*x.shape[:-3], 1, W, x.shape[-1])
        north = x[..., -1:, :, :].mean(-2, keepdim=True).expand(*x.shape[:-3], 1, W, x.shape[-1])
        return torch.cat([south, x[..., 1:-1, :, :], north], dim=-3)

    def departure(self, u, v):
        """Departure points in pixels of the grid: the displacement ``-dt·(u, v)``
        in each point's rotated frame (sin and cos of the clamped
        displacement by their Taylor series when ``fast_departure_trig``),
        rotated back to latitude and longitude."""
        lat0 = self.lat[None, :, :, None]
        lon0 = self.lon[None, :, :, None]
        lon_p = -u.float() * self.dt
        lat_p = -v.float() * self.dt
        if self.spec["fast_departure_trig"]:
            m = FAST_TRIG_MAX_RAD
            lat_p, lon_p = lat_p.clamp(-m, m), lon_p.clamp(-m, m)

            def sin(x):
                x2 = x * x
                return x * (1 - x2 / 6 + x2 * x2 / 120 - x2 * x2 * x2 / 5040)

            def cos(x):
                x2 = x * x
                return 1 - x2 / 2 + x2 * x2 / 24 - x2 * x2 * x2 / 720 + x2 * x2 * x2 * x2 / 40320
        else:
            sin, cos = torch.sin, torch.cos
        s_lat, c_lat, s_lon, c_lon = sin(lat_p), cos(lat_p), sin(lon_p), cos(lon_p)
        s0, c0 = torch.sin(lat0), torch.cos(lat0)
        lat = torch.asin((s_lat * c0 + c_lat * c_lon * s0).clamp(-1 + 1e-7, 1 - 1e-7))
        lon = lon0 + torch.atan2(c_lat * s_lon, c_lat * c_lon * c0 - s_lat * s0)
        lon = torch.remainder(lon + 2 * math.pi, 2 * math.pi)
        H, W = self.lat.shape
        py = (lat - self.lat.min()) / (self.lat.max() - self.lat.min()) * (H - 1)
        px = (lon - self.lon.min()) / (self.lon.max() - self.lon.min()) * (W - 1)
        return py, px

    @staticmethod
    def bicubic(field, py, px):
        """Sample ``field`` [B, R, C, V] at pixel positions [B, H, W, V]; taps
        outside the field add nothing."""
        B, R, C, V = field.shape
        shape = py.shape
        flat = field.float().reshape(B, R * C, V)
        py = py.reshape(B, -1, V)
        px = px.reshape(B, -1, V)

        def weights(t):
            a = CUBIC_A
            near = lambda d: ((a + 2) * d - (a + 3)) * d * d + 1
            far = lambda d: ((a * d - 5 * a) * d + 8 * a) * d - 4 * a
            return far(t + 1), near(t), near(1 - t), far(2 - t)

        y0, x0 = torch.floor(py), torch.floor(px)
        wy, wx = weights(py - y0), weights(px - x0)
        out = torch.zeros_like(py)
        for i, w_r in enumerate(wy):
            r = y0 + (i - 1)
            r_ok = (r >= 0) & (r <= R - 1)
            for j, w_c in enumerate(wx):
                c = x0 + (j - 1)
                ok = r_ok & (c >= 0) & (c <= C - 1)
                idx = torch.where(ok, r * C + c, 0.0).long()
                out = out + torch.where(ok, w_r * w_c * torch.gather(flat, 1, idx), 0.0)
        return out.reshape(shape)

    def advection(self, h, u, v, name):
        layers = self.spec["physblock"]
        proj = self.pole_mean(self.block(h, name + ".down_projection",
                                         layers["advection"]["down_projection"]["layers"]))
        py, px = self.departure(u, v)
        pad = 2
        field = geocyclic_pad(proj, pad)
        out = self.rnd(self.bicubic(field, py + pad, px + pad))
        return self.block(self.pole_mean(out), name + ".up_projection",
                          layers["advection"]["up_projection"]["layers"])

    # -- the model -----------------------------------------------------------

    def physics_layer(self, h, hs, i):
        pb = self.spec["physblock"]
        name = f"layers.{i}"
        common = dict(pre_norm=True, bias=int(self.spec["bias_channels"]) > 0)
        vel = self.block(h, name + ".velocity_net", pb["velocity_net"]["layers"], **common)
        u, v = vel[..., :self.num_vels], vel[..., self.num_vels:]
        g = torch.sigmoid(self.P[name + ".alpha_adv"])
        adv = self.advection(h, u, v, name + ".advection")
        h = self.rnd(h + self.rnd(g) * (adv - h))
        h = self.rnd(h + self.block(h, name + ".diffusion", pb["diffusion"]["layers"], **common))
        return self.rnd(h + self.block(torch.cat([h, hs], dim=-1), name + ".reaction",
                                       pb["reaction"]["layers"], **common))

    def downsample(self, x):
        """5 × 5 mean over the geocyclic pad (stride 1)."""
        xp = geocyclic_pad(x, 2).float()
        H, W = x.shape[-3], x.shape[-2]
        acc = sum(xp[..., i:i + H, j:j + W, :] for i in range(5) for j in range(5))
        return self.rnd(acc / 25.0)

    def forward(self, P: dict, fields: torch.Tensor) -> torch.Tensor:
        self.P = P
        pb = self.spec["physblock"]
        n_static = int(self.spec["n_static"])
        x = self.rnd(fields.float())
        h = self.block(x, "input_proj", pb["input_proj"]["layers"], activation=True)
        s = self.rnd(F.silu(self.sepconv(x[..., -n_static:], "static_sepconv1")))
        s = self.rnd(F.silu(self.depthwise(geocyclic_pad(s, 3), "static_depthwise")))
        s = self.sepconv(s, "static_sepconv2")
        skip = h
        h, s = self.downsample(h), self.downsample(s)
        for i in range(self.num_layers):
            if self.checkpoint_layers and torch.is_grad_enabled():
                h = checkpoint(self.physics_layer, h, s, i, use_reentrant=False)
            else:
                h = self.physics_layer(h, s, i)
        h = self.rnd(h + skip)
        return self.block(h, "output_proj", pb["output_proj"]["layers"], pre_norm=True,
                          bias=int(self.spec["bias_channels"]) > 0).float()

    __call__ = forward
