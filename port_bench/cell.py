"""A cell, its configuration and its traffic, read from the files of
``port_bench/`` by name: ``workloads/<cell>.json`` names its configuration
(``configs/<config>.json``) and its traffic (``traffic/<traffic>.json``)."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def load_json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"port_bench: no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load(workload: str) -> dict:
    """``{"name", "cell", "config", "traffic"}`` of a workload."""
    cell = load_json("workloads", workload)
    return {"name": workload, "cell": cell, "config": load_json("configs", cell["config"]),
            "traffic": load_json("traffic", cell["traffic"])}


def spec(config: dict) -> dict:
    """The reference's model spec: the configuration's ``model`` block with
    the compute settings the mathematics depends on."""
    return {**config["model"], "n_static": len(config["features"]["input"]["constants"]),
            "fast_departure_trig": config["compute"]["fast_departure_trig"]}


def dims(config: dict) -> dict:
    """Channel counts of the configuration's features."""
    f = config["features"]
    levels = len(f["pressure_levels"])
    n_time = int(config["n_time_inputs"])
    out_atmo = f["output"]["atmospheric"]
    common = (sum(v in f["input"]["atmospheric"] for v in out_atmo) * levels
              + sum(v in f["input"]["surface"] for v in f["output"]["surface"]))
    d = dict(n_common=common, output_dim=len(out_atmo) * levels + len(f["output"]["surface"]),
             n_time=n_time, n_forcings=len(f["input"]["forcings"]),
             n_const=len(f["input"]["constants"]))
    d["n_dyn"] = d["n_common"] * n_time
    d["input_dim"] = (d["n_common"] + d["n_forcings"]) * n_time + d["n_const"]
    return d


def check_program_config(cfg, config: dict) -> None:
    """Raise where the program's configuration, as loaded with the
    configuration file's overrides, is not the one the file states."""
    want = {"model": config["model"], "features": config["features"],
            "compute": config["compute"],
            "training.optimizer": config["training"]["optimizer"],
            "training.loss_function": config["training"]["loss_function"],
            "training.variable_loss_weights": config["training"]["variable_loss_weights"],
            "dataset.n_time_inputs": config["n_time_inputs"]}
    bad = []

    def walk(path, expected):
        if isinstance(expected, dict):
            for k, v in expected.items():
                walk(f"{path}.{k}", v)
            return
        got = cfg.get_path(path)
        if isinstance(expected, list):
            got = list(got) if got is not None else None
        if got != expected and not (isinstance(expected, float) and got is not None
                                    and float(got) == expected):
            bad.append(f"{path}: program {got!r}, configuration {expected!r}")

    for path, value in want.items():
        walk(path, value)
    if bad:
        raise SystemExit("port_bench: the program's configuration differs from the "
                         "configuration file:\n  " + "\n  ".join(bad))
