"""What the modes share: the program built from a cell and seeded weights,
the reference's model, and the lower precision of the control."""

from __future__ import annotations

import time

import torch

from port_bench import cell as cells
from port_bench import draw

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Context:
    """One run's cell, seed and device, and what its modes build on them.
    ``model`` may be passed in to reuse a program model across seeds (the
    calibration does); its weights are always the seed's."""

    def __init__(self, workload: dict, seed: int, device, model=None):
        self.config, self.traffic = workload["config"], workload["traffic"]
        self.seed, self.device = int(seed), torch.device(device)
        self.grid = tuple(self.config["grid"])
        self.dims = cells.dims(self.config)
        self.spec = cells.spec(self.config)
        self.batch = int(self.traffic["batch"])
        self.dtype = DTYPES[self.traffic["precision"]]
        self.model = model
        self.cfg = None
        self.phases: dict = {}   # set-up's phases: name -> time.time() at their end

    def phase(self, name: str) -> None:
        sync(self.device)
        self.phases[name] = time.time()

    def program_config(self):
        from paradis_torch.config import load_config

        cfg = load_config(overrides=list(self.config["overrides"]))
        cells.check_program_config(cfg, self.config)
        return cfg

    def lat_lon_deg(self):
        import numpy as np

        H, W = self.grid
        delta = 180.0 / H
        return -90.0 + delta / 2.0 + delta * np.arange(H), np.arange(W) * (360.0 / W)

    def build_program(self):
        """The program's model with the seed's weights loaded."""
        from paradis_torch.model import Paradis

        self.cfg = self.program_config()
        if self.model is None:
            lat, lon = self.lat_lon_deg()
            self.model = Paradis.from_config(
                self.cfg, input_dim=self.dims["input_dim"], output_dim=self.dims["output_dim"],
                lat_deg=lat, lon_deg=lon, dtype=self.dtype, device=self.device)
        self.phase("model_built")
        shapes = {n: tuple(p.shape) for n, p in self.model.named_parameters()}
        self.model.load_state_dict(draw.parameters(shapes, self.seed, self.device), strict=True)
        self.phase("weights_drawn")
        return self.model

    def parameter_shapes(self) -> dict:
        return {n: tuple(p.shape) for n, p in self.model.named_parameters()}

    def reference(self, rnd=None, checkpoint_layers=False):
        from port_bench.reference.model import Reference

        return Reference(self.spec, *self.grid, self.device, rnd=rnd,
                         checkpoint_layers=checkpoint_layers)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.abs().max()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x.float())

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g.float())


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a per-tensor scale (its largest
    magnitude to 448), in float32, and its gradient rounded so in the
    backward: the control's precision, the one below bfloat16."""
    return _Fp8.apply(x)


def model_flops(ctx: Context, members: int) -> float:
    """Multiply-add FLOPs of one forward of ``members`` fields, counted by
    ``FlopCounterMode`` over the reference on meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    H, W = ctx.grid
    meta = torch.device("meta")
    ref = ctx.reference()
    ref.lat, ref.lon = ref.lat.to(meta), ref.lon.to(meta)
    P = {n: torch.empty(s, device=meta) for n, s in ctx.parameter_shapes().items()}
    x = torch.empty(members, H, W, ctx.dims["input_dim"], device=meta)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref(P, x)
    return float(counter.get_total_flops())
