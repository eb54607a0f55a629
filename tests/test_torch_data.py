"""The port's data pipeline against the JAX package's, bit for bit.

The synthetic raw store (both codecs, ``wb2_layout``) and the preprocessed
store (the options ``tests/test_preprocess_options.py`` exercises) are the
same bytes on disk from both packages; each package reads the other's
store; the port's native host library agrees with its numpy paths; the
dataset's samples (train, prediction, interval sampling, ``preload``) and the
loader's batches over two shuffled epochs are bitwise the JAX package's;
``Era5DataModule`` stages as in ``tests/test_datamodule.py``.  No tolerance:
every comparison here is exact.
"""

import pytest

torch = pytest.importorskip("torch")

import threading  # noqa: E402
import zlib  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from fixtures import build_toy_store, toy_config  # noqa: E402
from paradis_torch.data import blosc, native, zarrlite  # noqa: E402
from paradis_torch.data import preprocess as t_pre  # noqa: E402
from paradis_torch.data import synthetic as t_syn  # noqa: E402
from paradis_torch.data.datamodule import Era5DataModule  # noqa: E402
from paradis_torch.data.dataset import ERA5Dataset  # noqa: E402
from paradis_torch.data.features import dyn_output_features, num_common_features  # noqa: E402
from paradis_torch.data.pipeline import BatchLoader  # noqa: E402
from paradis_tpu.data import preprocess as j_pre  # noqa: E402
from paradis_tpu.data import synthetic as j_syn  # noqa: E402
from paradis_tpu.data import zarrlite as j_zarrlite  # noqa: E402
from paradis_tpu.data.dataset import ERA5Dataset as JaxERA5Dataset  # noqa: E402
from paradis_tpu.data.pipeline import BatchLoader as JaxBatchLoader  # noqa: E402
from torch_parity import build_torch_toy_store, torch_toy_config  # noqa: E402

BLOSC_LZ4 = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}


def _files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


def _assert_same_tree(a: Path, b: Path) -> None:
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    assert len(fa) > 5
    differ = [name for name in fa if fa[name] != fb[name]]
    assert not differ, differ[:10]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The toy store built by each package (the same seed and layout)."""
    return {"jax": build_toy_store(tmp_path_factory.mktemp("jax_toy")),
            "torch": build_torch_toy_store(tmp_path_factory.mktemp("torch_toy"))}


@pytest.fixture(scope="module")
def cfgs(stores):
    return {"jax": toy_config(stores["jax"]), "torch": torch_toy_config(stores["torch"])}


# -- stores --------------------------------------------------------------------

@pytest.mark.parametrize("case", ["zlib", "blosc-lz4", "blosc-lz4-wb2"])
def test_raw_store_is_the_same_bytes(case, tmp_path):
    kw = dict(nlat=8, nlon=16, n_times=6, levels=(500, 1000), seed=3,
              compressor=None if case == "zlib" else BLOSC_LZ4,
              wb2_layout=case.endswith("wb2"))
    j_syn.build_raw_store(str(tmp_path / "jax"), **kw)
    t_syn.build_raw_store(str(tmp_path / "torch"), **kw)
    _assert_same_tree(tmp_path / "jax", tmp_path / "torch")


PREPROCESS_CASES = {
    "default": ({}, {"toa_time_stride": 2}),
    "poles": ({"poles": True}, {"toa_time_stride": 2, "remove_poles": True}),
    "interp_deg": ({"poles": True}, {"toa_time_stride": 2, "interp_deg": 45.0}),
    "levels13": ({"levels": "superset13"}, {"toa_time_stride": 2, "levels": 13}),
    "lq16": ({}, {"toa_time_stride": 2, "codec": "lq16"}),
    "wb2-blosc": ({"wb2": True}, {"toa_time_stride": 2}),
}


def _raw(path: Path, spec: dict, pkg) -> None:
    levels = (500, 1000)
    if spec.get("levels") == "superset13":
        levels = tuple(sorted(set(t_pre.LEVELS_13) | {775, 875}))
    nlat = 9 if spec.get("poles") else 8
    pkg.build_raw_store(str(path), nlat=nlat, nlon=16, n_times=4, levels=levels,
                        compressor=BLOSC_LZ4 if spec.get("wb2") else None,
                        wb2_layout=bool(spec.get("wb2")))
    if spec.get("poles"):  # a pole-inclusive latitude ladder
        zarrlite.create_array(path / "latitude", shape=(9,), dtype=np.float64,
                              data=np.linspace(-90.0, 90.0, 9), dims=("latitude",),
                              overwrite=True)


@pytest.mark.parametrize("case", list(PREPROCESS_CASES))
def test_preprocessed_store_is_the_same_bytes(case, tmp_path):
    """``data``, ``stats``, ``constants`` and the tendency statistics: the
    same files from the same raw store and options."""
    spec, options = PREPROCESS_CASES[case]
    _raw(tmp_path / "raw", spec, t_syn)
    j_pre.preprocess(str(tmp_path / "raw"), str(tmp_path / "jax"), **options)
    t_pre.preprocess(str(tmp_path / "raw"), str(tmp_path / "torch"), **options)
    _assert_same_tree(tmp_path / "jax", tmp_path / "torch")
    assert (tmp_path / "torch" / "stats").is_dir() and (tmp_path / "torch" / "constants").is_dir()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_reads_the_others_store(writer, stores):
    reader = zarrlite if writer == "jax" else j_zarrlite
    other = j_zarrlite if writer == "jax" else zarrlite
    root = stores[writer]
    for sub in ("2000", "stats", "constants"):
        a, b = reader.open_store(root / sub), other.open_store(root / sub)
        assert sorted(a.arrays()) == sorted(b.arrays())
        for name in a.arrays():
            np.testing.assert_array_equal(np.asarray(a[name][...]), np.asarray(b[name][...]))
    data = reader.open_store(root / "2000")["data"]
    np.testing.assert_array_equal(data.read_first_axis_batch(1, 4),
                                  np.asarray(other.open_store(root / "2000")["data"][1:4]))


# -- the native host library ---------------------------------------------------

@pytest.fixture(scope="module")
def lib():
    return native.require()


def test_native_library_builds_into_the_port_build_dir(lib):
    path = native._lib_path()
    assert path.is_file() and path.parent.name == "_build"
    assert path.parent.parent.name == "paradis_torch"
    assert path.name.startswith("libparadis_host-") and len(path.stem) > len("libparadis_host-")


def test_require_raises_with_the_reason(monkeypatch):
    def failing_build(force=False):
        raise RuntimeError("g++: fatal error: no input files")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "build", failing_build)
    assert native.get_lib() is None
    with pytest.raises(RuntimeError, match="no input files"):
        native.require()


def test_zlib_decode_many_parity(lib):
    rng = np.random.default_rng(0)
    chunks = [rng.normal(size=(4, 6)).astype(np.float32) for _ in range(5)]
    blobs = [zlib.compress(c.tobytes(), 1) for c in chunks]
    blobs[2] = None  # a missing chunk keeps its pre-filled zeros
    got = native.zlib_decode_many(blobs, chunks[0].nbytes).view(np.float32).reshape(5, 4, 6)
    for i, c in enumerate(chunks):
        np.testing.assert_array_equal(got[i], 0.0 if i == 2 else c)


@pytest.mark.parametrize("decode", ["zlib", "blosc"])
def test_corrupt_input_raises(lib, decode):
    fn = native.zlib_decode_many if decode == "zlib" else native.blosc_decode_many
    with pytest.raises(ValueError):
        fn([b"not a compressed chunk at all"], 16)
    if decode == "blosc":
        with pytest.raises(blosc.BloscError):
            blosc.decode(b"\x02\x01\x21\x04" + b"\x00" * 12 + b"garbage", 64)


def test_zscore_parity(lib):
    rng = np.random.default_rng(1)
    data = rng.normal(size=(7, 9, 12)).astype(np.float32)
    ref = data.copy()
    idx = np.asarray([0, 3, 11], np.int64)
    mean = np.asarray([1.0, -2.0, 0.5], np.float32)
    std = np.asarray([2.0, 0.5, 3.0], np.float32)
    assert native.zscore_normalize_inplace(data, idx, mean, std)
    ref[..., idx] = (ref[..., idx] - mean) / std
    np.testing.assert_allclose(data, ref, atol=1e-6)


def test_bitround_parity(lib):
    data = np.random.default_rng(2).normal(size=(64,)).astype(np.float32)
    nat = data.copy()
    assert native.bitround_inplace(nat, 8)
    np.testing.assert_array_equal(nat, zarrlite._bitround(data.copy(), 8))


@pytest.mark.parametrize("cname", ["lz4", "zlib", "zstd"])
def test_blosc_native_and_python_paths_agree(lib, cname):
    """A frame the native library encodes decodes to the same bytes through
    the native and the pure-Python decoders (zstd: libzstd opened at run
    time by the library, through ctypes by the Python path)."""
    raw = np.random.default_rng(4).normal(size=(3000,)).astype(np.float32).tobytes()
    frame = blosc.encode(raw, 4, cname=cname, clevel=5, shuffle=blosc.SHUFFLE)
    assert blosc.decode(frame, len(raw)) == raw
    assert blosc._decode_frame_py(frame, len(raw)) == raw


@pytest.mark.parametrize("compressor", [None, {"id": "zlib", "level": 1}, BLOSC_LZ4])
def test_batched_store_read(lib, tmp_path, compressor):
    data = np.random.default_rng(3).normal(size=(6, 3, 4, 5)).astype(np.float32)
    arr = zarrlite.create_array(tmp_path / "a", shape=data.shape, chunks=(1, 3, 4, 5),
                                dtype=np.float32, compressor=compressor, data=data)
    np.testing.assert_array_equal(arr.read_first_axis_batch(1, 5), data[1:5])


# -- helpers the dataset needs ---------------------------------------------------

def test_host_normalizations_match_the_jax_package_bits():
    from paradis_torch.sphere.geometry import normalized_inverse_lon_spacing
    from paradis_torch.utils import normalization as tn
    from paradis_tpu.sphere.geometry import normalized_inverse_lon_spacing as j_spacing
    from paradis_tpu.utils import normalization as jn

    rng = np.random.default_rng(5)
    x = rng.gamma(2.0, 1e-3, size=(6, 7, 5)).astype(np.float32)
    mean, std = np.float32(1e-3), np.float32(2e-3)
    q_min, q_max = np.float32(1e-7), np.float32(0.02)
    pairs = [(tn.normalize_standard(x, mean, std), jn.normalize_standard(x, mean, std)),
             (tn.normalize_humidity(x, q_min, q_max, 1e-12),
              jn.normalize_humidity(x, q_min, q_max, 1e-12)),
             (tn.normalize_precipitation(x), jn.normalize_precipitation(x))]
    for a, b in pairs:
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    lat, lon = np.deg2rad(np.linspace(-84.375, 84.375, 16)), np.deg2rad(np.arange(32) * 11.25)
    np.testing.assert_array_equal(normalized_inverse_lon_spacing(lat, lon), j_spacing(lat, lon))


# -- the dataset ---------------------------------------------------------------------

DATASET_CASES = {
    "train": (("2000-01-01", "2000-01-05"), {"forecast_steps": 2}),
    "prediction": (("2000-01-05", None), {"forecast_steps": 4, "prediction_stage": True}),
    "interval": (("2000-01-01", "2000-01-05"), {"forecast_steps": 1, "time_interval": "12h"}),
    "preload": (("2000-01-01", "2000-01-05"), {"forecast_steps": 2, "preload": True}),
}


@pytest.mark.parametrize("case", list(DATASET_CASES))
def test_dataset_samples_are_the_jax_packages(case, stores, cfgs):
    (start, end), kw = DATASET_CASES[case]
    jds = JaxERA5Dataset(str(stores["jax"]), start, end, cfg=cfgs["jax"], **kw)
    tds = ERA5Dataset(str(stores["torch"]), start, end, cfg=cfgs["torch"], **kw)
    assert len(tds) == len(jds) > 1
    assert (tds.num_in_features, tds.num_out_features) == (jds.num_in_features,
                                                           jds.num_out_features)
    for i in (0, len(tds) - 1):
        assert tds.sample_time(i) == jds.sample_time(i)
        for a, b in zip(tds[i], jds[i]):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b  # the prediction index


def test_dataset_features_agree_with_the_feature_bookkeeping(stores, cfgs):
    cfg = cfgs["torch"]
    ds = ERA5Dataset(str(stores["torch"]), "2000-01-01", "2000-01-05", forecast_steps=1,
                     cfg=cfg)
    assert ds.dyn_output_features == dyn_output_features(cfg.features)
    assert ds.num_common_features == num_common_features(cfg.features)
    x, y, forcings, consts = ds[0]
    assert x.shape[-1] == ds.num_common_features * int(cfg.dataset.n_time_inputs)
    assert y.shape[-1] == len(ds.dyn_output_features)


# -- the loader ---------------------------------------------------------------------

def test_loader_batches_are_the_jax_loaders_over_two_epochs(stores, cfgs):
    """The same seeded shuffle: both loaders visit the same samples in the
    same order, and each CPU tensor is bitwise the JAX loader's numpy batch."""
    jds = JaxERA5Dataset(str(stores["jax"]), "2000-01-01", "2000-01-05", forecast_steps=1,
                         cfg=cfgs["jax"])
    tds = ERA5Dataset(str(stores["torch"]), "2000-01-01", "2000-01-05", forecast_steps=1,
                      cfg=cfgs["torch"])
    jl = JaxBatchLoader(jds, batch_size=2, shuffle=True, seed=5, device_put=False)
    tl = BatchLoader(tds, batch_size=2, shuffle=True, seed=5, device="cpu")
    assert len(tl) == len(jl) == len(tds) // 2
    for _ in range(2):
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == len(tl)
        for a, b in zip(tb, jb):
            assert sorted(a) == sorted(b)
            for k in a:
                assert isinstance(a[k], torch.Tensor) and a[k].device.type == "cpu"
                np.testing.assert_array_equal(a[k].numpy(), b[k])
    # a prediction batch keeps its index on the host
    pds = ERA5Dataset(str(stores["torch"]), "2000-01-05", None, forecast_steps=2,
                      cfg=cfgs["torch"], prediction_stage=True)
    batch = next(iter(BatchLoader(pds, batch_size=2, device="cpu")))
    assert isinstance(batch["index"], np.ndarray) and list(batch["index"]) == [0, 1]
    assert isinstance(batch["input"], torch.Tensor)


class _Samples:
    """Zero samples; sample ``fail_at`` raises."""

    prediction_stage = False

    def __init__(self, n=4, fail_at=2):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise KeyError(f"sample {i} is missing")
        return (np.zeros((2, 2, 1), np.float32), np.zeros((1, 2, 2, 1), np.float32),
                np.zeros((1, 2, 2, 1), np.float32), np.zeros((2, 2, 1), np.float32))


def test_a_worker_exception_reaches_the_consumer():
    loader = BatchLoader(_Samples(), batch_size=1, device="cpu")
    got = []
    with pytest.raises(KeyError, match="sample 2"):
        for batch in loader:
            got.append(batch)
    assert len(got) == 2


def test_an_early_stop_ends_the_workers():
    """A consumer that leaves after one batch (a validation limit) leaves no
    worker blocked on a full queue."""
    before = set(threading.enumerate())
    loader = BatchLoader(_Samples(n=50, fail_at=None), batch_size=1, prefetch=1, device="cpu")
    it = iter(loader)
    next(it)
    workers = set(threading.enumerate()) - before
    assert len(workers) == 2
    it.close()
    for w in workers:
        w.join(timeout=5.0)
        assert not w.is_alive()


def test_loader_defaults_to_the_card(monkeypatch, stores, cfgs):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = ERA5Dataset(str(stores["torch"]), "2000-01-01", "2000-01-05", forecast_steps=1,
                     cfg=cfgs["torch"])
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchLoader(ds, batch_size=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchLoader(ds, batch_size=1, device="cuda")


# -- the datamodule ------------------------------------------------------------------

def test_datamodule_fit_stage(stores):
    dm = Era5DataModule(torch_toy_config(stores["torch"]), device="cpu")
    dm.setup("fit")
    assert dm.num_out_features == 27
    assert dm.num_common_features == 23
    assert dm.output_name_order[0].startswith("geopotential")
    batch = next(iter(dm.train_dataloader()))
    assert batch["input"].shape[0] == 1
    val = next(iter(dm.val_dataloader()))
    assert val["target"].shape[1] == 1  # val_forecast_steps defaults to train
    dm.setup("fit")  # idempotent


def test_datamodule_predict_stage(stores):
    dm = Era5DataModule(torch_toy_config(stores["torch"], **{
        "forecast.start_date": "2000-01-05", "forecast.end_date": "2000-01-06",
        "model.forecast_steps": 2}), device="cpu")
    dm.setup("predict")
    b = next(iter(dm.predict_dataloader()))
    assert "index" in b
    assert b["forcings"].shape[1] == 2


def test_datamodule_unknown_stage(stores):
    with pytest.raises(ValueError):
        Era5DataModule(torch_toy_config(stores["torch"]), device="cpu").setup("test")
