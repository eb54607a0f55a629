"""Shared set-up of the parity tests between paradis_tpu and paradis_torch.

Builds one toy configuration in both packages (the tiny flagship dims of
``__graft_entry__._flagship``: 8×16 grid, latent 32, 2 layers, 8 velocity
vectors) and bridges the JAX parameters into the port.  The JAX model runs
the XLA dense interpolation path, which shares the Pallas kernel's
zero-outside-the-field tap semantics and runs on the CPU without edits.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import torch

from paradis_tpu.config import load_config as jax_load_config
from paradis_tpu.model.paradis import Paradis as JaxParadis
from paradis_torch.config import load_config as torch_load_config
from paradis_torch.model import Paradis, load_flax_params
from paradis_torch.sphere.geometry import equiangular_lat_lon

NLAT, NLON = 8, 16
TINY = [
    "model.latent_size=32",
    "model.velocity_vectors=8",
    "model.num_layers=2",
    "model.physblock.velocity_net.hidden_dim=16",
    "model.physblock.reaction.hidden_dim=16",
    "model.physblock.output_proj.hidden_dim=16",
    "model.bias_channels=2",
    "model.bias_rank=4",
]


@dataclass
class Pair:
    jax_model: object
    params: dict
    model: Paradis
    jax_cfg: object
    cfg: object
    n_common: int
    n_forcings: int
    n_const: int
    n_time: int
    input_dim: int
    output_dim: int


def build_pair(*overrides: str, dtype=jnp.float32, seed: int = 0, nlat: int = NLAT,
               nlon: int = NLON) -> Pair:
    """The JAX model, its parameters, and the port with those weights bridged,
    on the ``nlat`` × ``nlon`` grid without poles."""
    jcfg = jax_load_config(overrides=TINY + ["compute.advection_impl=xla", *overrides])
    tcfg = torch_load_config(overrides=TINY + list(overrides))
    feats = tcfg.features
    n_levels = len(feats.pressure_levels)
    n_common = len(feats.input.atmospheric) * n_levels + len(feats.input.surface)
    n_out = len(feats.output.atmospheric) * n_levels + len(feats.output.surface)
    n_forcings, n_const = len(feats.input.forcings), len(feats.input.constants)
    n_time = int(tcfg.dataset.n_time_inputs)
    input_dim = (n_common + n_forcings) * n_time + n_const
    lat, lon = equiangular_lat_lon(nlat, nlon, include_poles=False)

    jm = JaxParadis.from_config(jcfg, input_dim=input_dim, output_dim=n_out,
                                lat_deg=lat, lon_deg=lon, dtype=dtype)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, nlat, nlon, input_dim), jnp.float32))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    model = Paradis.from_config(tcfg, input_dim=input_dim, output_dim=n_out,
                                lat_deg=lat, lon_deg=lon, dtype=tdtype, device="cpu")
    load_flax_params(model, jax.tree.map(np.asarray, params))
    return Pair(jm, params, model, jcfg, tcfg, n_common, n_forcings, n_const, n_time,
                input_dim, n_out)


def as_f32(x) -> np.ndarray:
    """A JAX array or torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))
