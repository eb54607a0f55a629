"""The port's reference-checkpoint conversion against the JAX package's.

There is no reference checkpoint in the repository, so the reference state
dict is synthetic: ``_reference_state_dict`` writes every leaf of a flax
parameter tree under the key and in the layout that ``paradis_tpu``'s
``train/convert.py`` reads (the inverse of its name map), with ``model.`` /
``._orig_mod.`` prefixes on some keys and a buffer that must be skipped.
The JAX converter bridged into the port (``load_flax_params``) and the
port's converter must give bitwise the same parameters, and the port's
forward on them must match the JAX forward (float32, within 1e-5 of the
largest output; measured ~5e-7 in ``test_torch_model.py``).
"""

import pytest

torch = pytest.importorskip("torch")

import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from paradis_tpu.train.convert import torch_state_dict_to_params as jax_convert  # noqa: E402
from paradis_torch.cli import convert as cli  # noqa: E402
from paradis_torch.model import load_flax_params  # noqa: E402
from paradis_torch.model.weights import flax_to_state  # noqa: E402
from paradis_torch.train.checkpoint import load_params  # noqa: E402
from paradis_torch.train.convert import (convert_torch_checkpoint,  # noqa: E402
                                         torch_state_dict_to_params)
from torch_parity import NLAT, NLON, TINY, as_f32, build_pair  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_STATIC = {"static_sepconv1": "0", "static_depthwise": "3", "static_sepconv2": "5"}
_PER_LAYER = {"velocity_net": "velocity_nets", "diffusion": "diffusion",
              "reaction": "reaction"}


def _ref_layout(path, arr):
    """A flax leaf in the reference's layout (the inverse of JAX's)."""
    leaf = path[-1]
    if leaf == "kernel" and arr.ndim == 4:            # depthwise [k,k,1,C] -> [C,1,k,k]
        return np.transpose(arr, (3, 2, 0, 1)).copy()
    if leaf == "kernel":                              # Dense [in,out] -> Conv1x1 [out,in,1,1]
        return arr.T.copy()[:, :, None, None]
    if leaf == "projection":                          # flax [C_b,out] -> Linear [out,C_b]
        return arr.T.copy()
    return arr


def _gmblock_key(path):
    """The reference key under a GMBlock of a flax path within it."""
    mod, rest = path[0], path[1:]
    if mod == "pre_norm":
        return f"0-ChannelNorm.{rest[-1]}"
    if mod == "bias0_GlobalBias":
        return "0-GlobalBias.projection.weight" if rest[0] == "projection" else \
            f"0-GlobalBias.{rest[0]}"
    idx, kind = mod[len("layer"):].split("_")
    if kind == "CLinear":
        return f"{idx}-CLinear.conv.{'weight' if rest[-1] == 'kernel' else 'bias'}"
    sub = rest[0]
    return f"{idx}-SepConv.{sub}.{'weight' if rest[-1] == 'kernel' else 'bias'}"


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _reference_state_dict(tree, seed=0):
    """(reference state dict, the flax tree of its values): every leaf
    redrawn near the template's own values, so the model stays well scaled
    and each entry is its own."""
    rng = np.random.default_rng(seed)
    values, sd = {}, {}
    for path, arr in _flat(tree["params"]):
        new = (arr * (1 + 0.1 * rng.normal(size=arr.shape))
               + 1e-3 * rng.normal(size=arr.shape)).astype(np.float32)
        values[path] = new
        head = path[0]
        if head in ("input_proj", "output_proj"):
            key = f"{head}.{_gmblock_key(path[1:])}"
            sd[key] = _ref_layout(path, new)
        elif head in _STATIC:
            sub = f"{path[1]}." if path[1] in ("depthwise", "pointwise") else ""
            leaf = "weight" if path[-1] == "kernel" else "bias"
            sd[f"static_encoder.{_STATIC[head]}.{sub}{leaf}"] = _ref_layout(path, new)
        elif path[1] == "alpha_adv":
            sd["alpha_adv"] = new
        else:
            for i in range(new.shape[0]):
                if path[1] == "advection":
                    key = f"advection.{i}.{path[2]}.{_gmblock_key(path[3:])}"
                else:
                    key = f"{_PER_LAYER[path[1]]}.{i}.{_gmblock_key(path[2:])}"
                sd[key] = _ref_layout(path, new[i])
    # Lightning and torch.compile prefixes on some keys, and a buffer
    sd = {(f"model.{k}" if i % 3 == 0 else k).replace("input_proj.", "input_proj._orig_mod."): v
          for i, (k, v) in enumerate(sd.items())}
    sd["model.lat_grid"] = np.zeros((NLAT, NLON), np.float32)
    tree_vals = {}
    for path, v in values.items():
        node = tree_vals
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, {"params": tree_vals}


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _jax_side(pair, sd):
    """JAX's converter, bridged into a copy of the port model."""
    params = jax_convert(sd, jax.tree.map(np.asarray, pair.params))
    model = build_pair(seed=1).model
    load_flax_params(model, params)
    return params, model


def test_conversion_matches_jax_bitwise_and_the_forward(pair):
    sd, values = _reference_state_dict(pair.params)
    assert any(k.startswith("model.") for k in sd) and any("._orig_mod." in k for k in sd)
    params, ref_model = _jax_side(pair, sd)
    got = torch_state_dict_to_params(sd, pair.model)
    names = [n for n, _ in pair.model.named_parameters()]
    assert list(got) == names
    for name, p in ref_model.named_parameters():
        assert got[name].dtype == torch.float32 and torch.equal(got[name], p.detach()), name
    # every parameter came from the reference dict, not the template
    for name, v in flax_to_state(values, len(pair.model.layers)).items():
        assert np.array_equal(got[name].numpy(), v), name

    pair.model.load_state_dict(got)
    x = np.random.default_rng(1).normal(scale=2.0, size=(1, NLAT, NLON, pair.input_dim))
    x = x.astype(np.float32)
    ref = as_f32(jax.jit(pair.jax_model.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        out = as_f32(pair.model(torch.from_numpy(x)))
    assert ref.std() > 1e-2
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_conversion_raises_on_a_shape_mismatch(pair):
    sd, _ = _reference_state_dict(pair.params)
    wide = build_pair("model.latent_size=24")
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_convert(sd, jax.tree.map(np.asarray, wide.params))
    with pytest.raises(ValueError, match="shape mismatch"):
        torch_state_dict_to_params(sd, wide.model)
    three = build_pair("model.num_layers=3")
    with pytest.raises(ValueError, match="shape mismatch"):
        torch_state_dict_to_params(sd, three.model)


def test_lightning_checkpoint_and_the_cli(pair, tmp_path):
    """A Lightning ``.ckpt`` converts as its state dict does, and
    ``python -m paradis_torch.cli.convert --device cpu`` writes a params file
    that ``load_params`` reads back to the same parameters."""
    sd, _ = _reference_state_dict(pair.params, seed=2)
    want = torch_state_dict_to_params(sd, pair.model)
    torch.save({"state_dict": sd, "epoch": 3}, tmp_path / "ref.ckpt")
    torch.save(sd, tmp_path / "raw.pt")
    for path in ("ref.ckpt", "raw.pt"):
        got = convert_torch_checkpoint(str(tmp_path / path), pair.model)
        assert all(torch.equal(got[k], want[k]) for k in want)

    args = ["--ckpt", str(tmp_path / "ref.ckpt"), "--out", str(tmp_path / "params.pt"),
            "--nlat", str(NLAT), "--nlon", str(NLON), "--device", "cpu", *TINY]
    res = subprocess.run([sys.executable, "-m", "paradis_torch.cli.convert", *args],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "parameters" in res.stdout
    model = build_pair(seed=4).model
    load_params(tmp_path / "params.pt", model)
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), want[name]), name


def test_cli_runs_on_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--ckpt", str(tmp_path / "none.ckpt"), "--out", str(tmp_path / "p.pt"),
                  "--nlat", str(NLAT), "--nlon", str(NLON)])
