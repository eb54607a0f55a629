"""NorMuon + AdamW at a constant learning rate, written from the mathematics.

Matrices (a ``weight`` of rank 2 or more, or a ``projection``) take NorMuon:
Nesterov momentum, five quintic Newton–Schulz iterations on the
``[out, fan_in]`` matrix (on its short side) after dividing by its norm, the
aspect rescale sqrt(max(1, out / fan_in)), a per-row second moment that
rescales the rows and then restores the matrix's norm, and decoupled weight
decay.  Every other parameter takes AdamW with bias-corrected moments.
"""

from __future__ import annotations

import math

import torch

NS = (3.4445, -4.7750, 2.0315)
EPS = 1e-8


def is_matrix(name: str, ndim: int) -> bool:
    leaf = name.rsplit(".", 1)[-1]
    return ndim >= 2 and leaf in ("weight", "projection")


def newton_schulz(x: torch.Tensor, steps: int) -> torch.Tensor:
    a, b, c = NS
    y = x / (x.norm() + 1e-7)
    wide = y.shape[0] <= y.shape[1]
    if not wide:
        y = y.t()
    for _ in range(steps):
        g = y @ y.t()
        y = a * y + (b * g + c * (g @ g)) @ y
    return y if wide else y.t()


class Optimizer:
    def __init__(self, opt: dict):
        self.lr, self.wd = float(opt["lr"]), float(opt["weight_decay"])
        self.b1, self.b2 = float(opt["beta1"]), float(opt["beta2"])
        self.ns_steps = int(opt["ns_steps"])
        self.state: dict = {}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        """Update ``params`` in place from ``grads`` (both by name)."""
        self.t += 1
        b1, b2, lr = self.b1, self.b2, self.lr
        for name, p in params.items():
            g = grads[name].float()
            st = self.state.setdefault(name, {})
            if is_matrix(name, p.ndim):
                out = p.shape[0]
                g2 = g.reshape(out, -1)
                m = st.setdefault("m", torch.zeros_like(g2))
                m.mul_(b1).add_(g2)
                o = newton_schulz(g2 + b1 * m, self.ns_steps)
                o = o * math.sqrt(max(1.0, out / g2.shape[1]))
                nu = st.setdefault("nu", torch.zeros(out, device=g.device))
                nu.mul_(b2).add_((1 - b2) * o.square().mean(1))
                o_hat = o / (nu.sqrt()[:, None] + EPS)
                o = o_hat * (o.norm() / (o_hat.norm() + EPS))
                p.sub_(lr * (o.reshape(p.shape) + self.wd * p))
            else:
                m = st.setdefault("m", torch.zeros_like(g))
                v = st.setdefault("v", torch.zeros_like(g))
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                p.mul_(1 - lr * self.wd)
                denom = (v / (1 - b2 ** self.t)).sqrt() + EPS
                p.sub_(lr / (1 - b1 ** self.t) * m / denom)
