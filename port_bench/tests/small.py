"""Small cells for the CPU tests: a cell's files with the model cut to the
tiny sizes of ``paradis_torch/tools/flagship.py``'s ``TINY`` on an 8 × 16
grid (widths cut here only; the benchmark's cells run the published ones)."""

from __future__ import annotations

import copy

from port_bench import cell as cells

TINY_MODEL = {"latent_size": 32, "velocity_vectors": 8, "num_layers": 2, "bias_channels": 2,
              "bias_rank": 4}
TINY_HIDDEN = {"velocity_net": 16, "reaction": 16, "output_proj": 16}
TINY_GRID = [8, 16]


def small(workload: str, **traffic) -> dict:
    """The cell ``workload`` at the tiny sizes, ``traffic`` replacing keys of
    its traffic."""
    wl = copy.deepcopy(cells.load(workload))
    cfg = wl["config"]
    cfg["grid"] = TINY_GRID
    cfg["model"].update(TINY_MODEL)
    over = list(cfg["overrides"]) + [f"model.{k}={v}" for k, v in TINY_MODEL.items()]
    for block, width in TINY_HIDDEN.items():
        cfg["model"]["physblock"][block]["hidden_dim"] = width
        over.append(f"model.physblock.{block}.hidden_dim={width}")
    cfg["overrides"] = over
    wl["traffic"].update(traffic)
    return wl
