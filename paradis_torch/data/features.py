"""Feature-name bookkeeping: which channels the model reads and writes.

The port's own copy of the name logic of
``paradis_tpu/data/dataset.py:ERA5Dataset._build_features``: atmospheric
variables expand to ``{var}_h{level}`` per pressure level, then come the
surface variables.  The dynamic output order is the features common to input
and output (in output order) followed by the output-only ones; the
autoregressive rollout feeds the first ``num_common_features`` output
channels back as the next input.  Only the names are ported here, not the
dataset.
"""

from __future__ import annotations


def _split(features_cfg) -> tuple[list[str], list[str]]:
    """(common, output-only) feature names."""
    levels = list(features_cfg.pressure_levels)

    def names(group):
        return [f"{v}_h{lev}" for v in group.atmospheric for lev in levels] + list(group.surface)

    inputs, outputs = names(features_cfg.input), names(features_cfg.output)
    return [f for f in outputs if f in inputs], [f for f in outputs if f not in inputs]


def dyn_output_features(features_cfg) -> list[str]:
    """Names of the model's output channels, in order: common, then output-only."""
    common, output_only = _split(features_cfg)
    return common + output_only


def num_common_features(features_cfg) -> int:
    """How many output channels are also inputs (fed back by the rollout)."""
    return len(_split(features_cfg)[0])
