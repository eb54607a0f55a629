"""The port's model-level benchmark (``paradis_torch.tools.bench_model``) on
the CPU: ``--device cpu`` at a tiny size (one physics layer on the 8 × 16 grid)
times the forward and forward + backward of both impls through the plain
versions, with no kernel launched; an unknown impl raises; without a card
and without ``--device cpu`` the tool raises.  On the card it runs in
``chip_smoke.py``'s ``[bench-model]`` phase."""

import json

import pytest

torch = pytest.importorskip("torch")

from paradis_torch.tools import bench_model  # noqa: E402

TINY = ["model.latent_size=16", "model.velocity_vectors=4", "model.num_layers=1",
        "model.physblock.velocity_net.hidden_dim=8", "model.physblock.reaction.hidden_dim=8",
        "model.physblock.output_proj.hidden_dim=8", "model.bias_channels=2",
        "model.bias_rank=4"]


def _argv(*more):
    argv = ["--device", "cpu", "--grid", "8,16", "--repeats", "2", *more]
    for override in TINY:
        argv += ["--override", override]
    return argv


def test_bench_times_both_impls_forward_and_backward_on_the_cpu(capsys):
    res = bench_model.main(_argv())
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == res
    keys = ["xla_fwd", "xla_bwd", "pallas_fwd", "pallas_bwd"]
    assert [line.split()[0] for line in lines[:-1]] == keys
    assert all(res[k] > 0 for k in keys)  # the JAX keys, in ms
    assert list(res["rows"]) == keys
    for k in keys:
        row = res["rows"][k]
        assert len(row["slopes_ms"]) == 2 and res[k] == min(row["slopes_ms"])
        assert row["first_call_s"] > 0
        # the plain versions launch no kernel
        assert row["launches_per_call"] == {"interp_fwd": 0, "interp_bwd": 0}
    assert res["kernels_built"] is None and res["card"] is None
    assert res["device"] == {"platform": "cpu", "kind": "cpu"}
    assert res["grid"] == [8, 16] and res["dtype"] == "bfloat16" and res["batch"] == 1
    assert (res["n_short"], res["n_long"]) == (4, 20)


def test_bench_takes_every_impl_the_port_takes_and_refuses_others():
    res = bench_model.main(_argv("--impls", "gather,auto", "--what", "fwd", "--repeats", "1"))
    assert [k for k in res if k.endswith("_fwd")] == ["gather_fwd", "auto_fwd"]
    with pytest.raises(ValueError, match="--impls"):
        bench_model.main(_argv("--impls", "triton"))
    with pytest.raises(ValueError, match="--what"):
        bench_model.main(_argv("--what", "step"))


def test_bench_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_model.main(["--what", "fwd"])
