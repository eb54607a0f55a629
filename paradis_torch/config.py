"""Configuration system: YAML tree + dotted-path overrides + interpolation.

The port's own copy of ``paradis_tpu/config.py`` (the port imports nothing of
the JAX package).  It reads the same ``configs/default.yaml`` data file, takes
the same ``a.b.c=value`` overrides and expands ``${a.b.c}`` interpolations, so
one config file drives both packages.
"""

from __future__ import annotations

import copy
import datetime
import json
import re
from pathlib import Path
from typing import Any, Iterable

import yaml

_INTERP_RE = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")


class Config(dict):
    """A nested dict with attribute access (``cfg.model.num_layers``)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover - mirrors dict semantics
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __setitem__(self, key, value) -> None:
        super().__setitem__(key, _wrap(value))

    # -- helpers ------------------------------------------------------------

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node: Config = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value

    def merged_with(self, other: dict) -> "Config":
        out = copy.deepcopy(self)
        _deep_merge(out, other)
        return out

    def resolved(self) -> "Config":
        """Return a copy with all ``${a.b}`` string interpolations expanded."""
        out = copy.deepcopy(self)
        for _ in range(8):  # bounded fixpoint for chained interpolation
            if not _resolve_interp(out, out):
                break
        return out

    def to_yaml(self) -> str:
        return yaml.safe_dump(json.loads(json.dumps(self)), sort_keys=False)


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, dict):
        return Config({k: _wrap(v) for k, v in value.items()})
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    if isinstance(value, (datetime.date, datetime.datetime)):
        return value.isoformat()  # YAML parses bare dates; keep strings
    return value


def _deep_merge(dst: Config, src: dict) -> None:
    for key, val in src.items():
        if key in dst and isinstance(dst[key], dict) and isinstance(val, dict):
            _deep_merge(dst[key], val)
        else:
            dst[key] = val


def _resolve_interp(node: Any, root: Config) -> bool:
    changed = False
    if isinstance(node, dict):
        for key, val in list(node.items()):
            if isinstance(val, str):
                m = _INTERP_RE.match(val)
                if m:
                    node[key] = root.get_path(m.group(1))
                    changed = True
            else:
                changed |= _resolve_interp(val, root)
    elif isinstance(node, list):
        for i, val in enumerate(node):
            if isinstance(val, str):
                m = _INTERP_RE.match(val)
                if m:
                    node[i] = root.get_path(m.group(1))
                    changed = True
            else:
                changed |= _resolve_interp(val, root)
    return changed


def _parse_value(text: str) -> Any:
    """Parse an override value with YAML semantics (``true``, ``1e-3``, lists)."""
    try:
        value = yaml.safe_load(text)
    except yaml.YAMLError:
        return text
    # YAML 1.1 treats "1e-3" (no dot) as a string; accept scientific notation.
    if isinstance(value, str):
        try:
            return float(value)
        except ValueError:
            return value
    return value


def apply_overrides(cfg: Config, overrides: Iterable[str]) -> Config:
    """Apply ``a.b.c=value`` style overrides in place and return the config."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"Override must look like key.path=value, got: {item!r}")
        key, _, raw = item.partition("=")
        cfg.set_path(key.strip(), _parse_value(raw.strip()))
    return cfg


def load_config(path: str | Path | None = None, overrides: Iterable[str] = ()) -> Config:
    """Load defaults, optionally merge a user YAML, apply overrides, resolve."""
    cfg = default_config()
    if path is not None:
        with open(path) as f:
            user = yaml.safe_load(f) or {}
        cfg = cfg.merged_with(user)
    apply_overrides(cfg, overrides)
    return cfg.resolved()


# Settings of the port that the JAX package has not, merged under the data
# file's.  compute.dist_backend is the one such setting: the process group's
# backend for multi-GPU runs (auto | nccl | gloo; auto is nccl on cards and
# gloo on the CPU, paradis_torch/distributed.py).  The JAX package has no
# counterpart: its collectives are XLA's.
PORT_DEFAULTS = {"compute": {"dist_backend": "auto"}}


def default_config() -> Config:
    """Built-in defaults mirroring reference ``config/paradis_settings.yaml:1-247``,
    with the port's own settings (``PORT_DEFAULTS``)."""
    here = Path(__file__).resolve().parent.parent / "configs" / "default.yaml"
    with open(here) as f:
        return _wrap(PORT_DEFAULTS).merged_with(yaml.safe_load(f))
