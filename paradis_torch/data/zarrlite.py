"""zarrlite: a minimal, dependency-free zarr-v2 store (numpy + stdlib only).

The port's own copy of ``paradis_tpu/data/zarrlite.py``: the same bytes on
disk, so a store written by either package reads in the other.

The reference framework's entire data interface is zarr v2 directories
(per-year stacked stores, ``stats``/``constants`` groups, WB2-layout forecast
output — reference ``data/era5_dataset.py:69-95``, ``utils/file_output.py``).
This environment ships no zarr/xarray, so paradis_torch carries its own
implementation of the subset it needs:

  * arrays: C-order chunks, any numpy dtype, arbitrary-region read/write,
    fill-value-backed missing chunks;
  * codecs: raw, zlib (stdlib), Blosc (in-repo), the BitRound mantissa
    filter the reference uses for forecast stores
    (``utils/file_output.py:14-28``), and ``lq`` — the lossy per-layer
    quantizer equivalent to the reference's external LayerQuantizer
    training-store codec (``scripts/preprocess_dataset.py:11-15``);
  * groups, JSON attrs, consolidated ``.zmetadata``;
  * xarray-compatible ``_ARRAY_DIMENSIONS`` attributes.

Stores written with ``compressor={"id": "zlib"}`` are readable by the real
zarr-python, and vice versa for zlib/raw stores.  If the real ``zarr``
package is available it can be used interchangeably — this module exists so
the framework is self-contained.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from pathlib import Path
from typing import Any, Iterator

import numpy as np

__all__ = ["Array", "Group", "open_store", "create_array", "create_group"]


# -- codecs --------------------------------------------------------------------


def _bitround(buf: np.ndarray, keepbits: int) -> np.ndarray:
    """Zero out low mantissa bits of float32 (numcodecs BitRound semantics)."""
    if buf.dtype != np.float32:
        raise ValueError("bitround filter only supports float32")
    bits = buf.view(np.uint32).copy()
    drop = 23 - keepbits
    if drop <= 0:
        return buf
    # round-to-nearest on the kept mantissa
    half = np.uint32(1 << (drop - 1))
    mask = np.uint32(~((1 << drop) - 1) & 0xFFFFFFFF)
    bits += half
    bits &= mask
    return bits.view(np.float32)


_LQ_MAGIC = b"LQ01"


def _lq_encode(data: np.ndarray, comp: dict) -> bytes:
    """Per-layer lossy quantization (the LayerQuantizer-equivalent codec).

    The reference writes training stores through the external LayerQuantizer
    numcodecs codec with the spatial dims moved last
    (``scripts/preprocess_dataset.py:11-15,304-305``); the package is not
    retrievable here, so this is an independent design with the same contract:
    each trailing-2D spatial plane ("layer") of the chunk is linearly
    quantized to ``bits`` (8..16) unsigned ints against its own min/max, and
    the int payload is Blosc-compressed (zstd + byte shuffle by default).
    Worst-case absolute error per layer is ``(max-min)/(2^bits-1)/2`` —
    at 16 bits, 7.6e-6 of the layer's dynamic range, comparable to the
    BitRound(16) the forecast stores use, at roughly half the pre-entropy
    bytes.  Finite data only (quantization has no NaN/Inf encoding — loudly
    rejected rather than silently corrupted).
    """
    from paradis_torch.data import blosc

    bits = int(comp.get("bits", 16))
    if not 2 <= bits <= 16:
        raise ValueError(f"lq codec supports 2..16 bits, got {bits}")
    data = np.ascontiguousarray(data, np.float32)
    plane = data.shape[-1] if data.ndim == 1 else data.shape[-2] * data.shape[-1]
    if not np.isfinite(data).all():
        raise ValueError("lq codec requires finite data")
    # float64 quantization math: encode runs once offline, and fp32
    # (flat-lo)*inv would leak rounding past the half-step bound at
    # geopotential-scale offsets; decode stays fp32 (the hot loader path —
    # its residual is the output dtype's own ulp, unavoidable)
    flat = data.reshape(-1, plane).astype(np.float64)
    lo = flat.min(axis=1)
    scale = (flat.max(axis=1) - lo) / float((1 << bits) - 1)
    inv = np.where(scale > 0, 1.0 / np.where(scale > 0, scale, 1.0), 0.0)
    qdtype = np.dtype(np.uint8 if bits <= 8 else np.uint16)
    q = np.rint((flat - lo[:, None]) * inv[:, None]).astype(qdtype)
    header = (_LQ_MAGIC + np.uint32(flat.shape[0]).tobytes()
              + lo.astype(np.float32).tobytes()
              + scale.astype(np.float32).tobytes())
    payload = blosc.encode(
        q.tobytes(), typesize=qdtype.itemsize,
        cname=comp.get("cname", "zstd"), clevel=int(comp.get("clevel", 5)),
        shuffle=int(comp.get("shuffle", blosc.SHUFFLE)),
        blocksize=int(comp.get("blocksize", 0)))
    return header + payload


def _lq_decode(blob: bytes, shape: tuple, dtype: np.dtype, comp: dict) -> np.ndarray:
    from paradis_torch.data import blosc

    if blob[:4] != _LQ_MAGIC:
        raise ValueError("lq chunk: bad magic")
    n = int(np.frombuffer(blob, np.uint32, count=1, offset=4)[0])
    lo = np.frombuffer(blob, np.float32, count=n, offset=8)
    scale = np.frombuffer(blob, np.float32, count=n, offset=8 + 4 * n)
    bits = int(comp.get("bits", 16))
    qdtype = np.dtype(np.uint8 if bits <= 8 else np.uint16)
    nelem = int(np.prod(shape))
    raw = blosc.decode(blob[8 + 8 * n:], nelem * qdtype.itemsize)
    q = np.frombuffer(raw, qdtype).astype(np.float32).reshape(n, -1)
    out = q * scale[:, None] + lo[:, None]
    return out.reshape(shape).astype(dtype, copy=False)


def _encode(chunk: np.ndarray, compressor: dict | None, filters: list | None) -> bytes:
    data = np.ascontiguousarray(chunk)
    if filters:
        for f in filters:
            if f["id"] == "bitround":
                data = _bitround(data.astype(np.float32), int(f["keepbits"]))
            else:
                raise ValueError(f"unsupported filter {f['id']!r}")
    if compressor is not None and compressor["id"] == "lq":
        return _lq_encode(data, compressor)
    raw = data.tobytes()
    if compressor is None:
        return raw
    if compressor["id"] == "zlib":
        return zlib.compress(raw, compressor.get("level", 1))
    if compressor["id"] == "blosc":
        from paradis_torch.data import blosc

        return blosc.encode(
            raw,
            typesize=data.dtype.itemsize,
            cname=compressor.get("cname", "lz4"),
            clevel=int(compressor.get("clevel", 5)),
            shuffle=int(compressor.get("shuffle", blosc.SHUFFLE)),
            blocksize=int(compressor.get("blocksize", 0)),
        )
    raise ValueError(f"unsupported compressor {compressor['id']!r} (zarrlite)")


def _decode(blob: bytes, shape: tuple, dtype: np.dtype,
            compressor: dict | None, filters: list | None) -> np.ndarray:
    if compressor is not None:
        if compressor["id"] == "lq":
            return _lq_decode(blob, shape, dtype, compressor)
        if compressor["id"] == "zlib":
            blob = zlib.decompress(blob)
        elif compressor["id"] == "blosc":
            from paradis_torch.data import blosc

            nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
            blob = blosc.decode(blob, nbytes)
        else:
            raise ValueError(f"unsupported compressor {compressor['id']!r} (zarrlite)")
    # bitround is lossy-in-place; decode is identity
    return np.frombuffer(blob, dtype=dtype).reshape(shape).copy()


# -- attrs ---------------------------------------------------------------------


class _Attrs(dict):
    def __init__(self, path: Path):
        self._path = path / ".zattrs"
        if self._path.exists():
            super().__init__(json.loads(self._path.read_text()))
        else:
            super().__init__()

    def save(self) -> None:
        self._path.write_text(json.dumps(self, indent=1, default=_json_default))


def _json_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


# -- array ---------------------------------------------------------------------


class Array:
    """A zarr-v2 array backed by a directory of chunk files."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        meta = json.loads((self.path / ".zarray").read_text())
        if meta.get("zarr_format") != 2:
            raise ValueError(f"{path}: not a zarr v2 array")
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.compressor = meta.get("compressor")
        self.filters = meta.get("filters")
        self.fill_value = meta.get("fill_value", 0)
        if meta.get("order", "C") != "C":
            raise ValueError("zarrlite supports C-order arrays only")
        self.attrs = _Attrs(self.path)
        self._sep = "." if not meta.get("dimension_separator") else meta["dimension_separator"]

    # -- helpers --

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def _grid(self) -> tuple:
        return tuple(
            -(-s // c) for s, c in zip(self.shape, self.chunks)
        )

    def _chunk_path(self, idx: tuple) -> Path:
        return self.path / self._sep.join(str(i) for i in idx)

    def _read_chunk(self, idx: tuple) -> np.ndarray:
        p = self._chunk_path(idx)
        cshape = self.chunks
        if not p.exists():
            out = np.full(cshape, self.fill_value, self.dtype)
            return out
        return _decode(p.read_bytes(), cshape, self.dtype, self.compressor, self.filters)

    def _write_chunk(self, idx: tuple, chunk: np.ndarray) -> None:
        self._chunk_path(idx).write_bytes(_encode(chunk, self.compressor, self.filters))

    @staticmethod
    def _normalize_index(index, shape) -> tuple[list[slice], list[bool]]:
        if not isinstance(index, tuple):
            index = (index,)
        if Ellipsis in index:
            pos = index.index(Ellipsis)
            fill = (slice(None),) * (len(shape) - (len(index) - 1))
            index = index[:pos] + fill + index[pos + 1 :]
        index = index + (slice(None),) * (len(shape) - len(index))
        slices, keep = [], []
        for i, s in zip(index, shape):
            if isinstance(i, (int, np.integer)):
                i = int(i)
                if i < 0:
                    i += s
                slices.append(slice(i, i + 1))
                keep.append(False)
            elif isinstance(i, slice):
                slices.append(slice(*i.indices(s)))
                keep.append(True)
            else:
                raise TypeError(f"zarrlite supports int/slice indexing, got {type(i)}")
        return slices, keep

    # -- public IO --

    def __getitem__(self, index) -> np.ndarray:
        slices, keep = self._normalize_index(index, self.shape)
        out_shape = tuple(sl.stop - sl.start for sl in slices)
        out = np.empty(out_shape, self.dtype)

        for cidx in self._overlapping_chunks(slices):
            chunk = self._read_chunk(cidx)
            src, dst = self._chunk_slices(cidx, slices)
            out[tuple(dst)] = chunk[tuple(src)]

        squeeze = tuple(ax for ax, k in enumerate(keep) if not k)
        return out.squeeze(axis=squeeze) if squeeze else out

    def __setitem__(self, index, values) -> None:
        slices, _ = self._normalize_index(index, self.shape)
        region_shape = tuple(sl.stop - sl.start for sl in slices)
        values = np.broadcast_to(np.asarray(values, self.dtype), region_shape)

        for cidx in self._overlapping_chunks(slices):
            src, dst = self._chunk_slices(cidx, slices)
            full_cover = all(
                s.start == 0 and s.stop == c
                for s, c in zip(src, self.chunks)
            ) and self._chunk_in_bounds(cidx)
            if full_cover:
                chunk = np.ascontiguousarray(values[tuple(dst)])
            else:
                chunk = self._read_chunk(cidx)
                chunk[tuple(src)] = values[tuple(dst)]
            self._write_chunk(cidx, chunk)

    def _chunk_in_bounds(self, cidx: tuple) -> bool:
        return all(
            (i + 1) * c <= s for i, c, s in zip(cidx, self.chunks, self.shape)
        )

    def _overlapping_chunks(self, slices) -> Iterator[tuple]:
        ranges = []
        for sl, c in zip(slices, self.chunks):
            first = sl.start // c
            last = max(first, (max(sl.stop, sl.start + 1) - 1) // c)
            ranges.append(range(first, last + 1))

        def rec(i, prefix):
            if i == len(ranges):
                yield tuple(prefix)
                return
            for v in ranges[i]:
                yield from rec(i + 1, prefix + [v])

        yield from rec(0, [])

    def _chunk_slices(self, cidx, slices):
        src, dst = [], []
        for i, (ci, sl, c) in enumerate(zip(cidx, slices, self.chunks)):
            c0 = ci * c
            lo = max(sl.start, c0)
            hi = min(sl.stop, c0 + c)
            src.append(slice(lo - c0, hi - c0))
            dst.append(slice(lo - sl.start, hi - sl.start))
        return src, dst

    def __array__(self, dtype=None):
        out = self[...]
        return out.astype(dtype) if dtype is not None else out

    def read_first_axis_batch(self, lo: int, hi: int) -> np.ndarray:
        """Fast batched read of rows [lo, hi) for arrays chunked 1 on axis 0.

        Uses the native multithreaded zlib decoder (paradis_torch/csrc/host_ops.cpp) when
        available; falls back to per-row ``__getitem__``.
        """
        comp_id = self.compressor.get("id") if self.compressor else None
        fastable = (
            self.chunks[0] == 1
            and self.chunks[1:] == self.shape[1:]
            and not self.filters
            and comp_id in (None, "zlib", "blosc")
        )
        if fastable:
            from paradis_torch.data import native

            blobs = []
            for i in range(lo, hi):
                p = self._chunk_path((i,) + (0,) * (self.ndim - 1))
                blobs.append(p.read_bytes() if p.exists() else None)
            chunk_bytes = int(np.prod(self.chunks)) * self.dtype.itemsize
            if self.compressor is None:
                out = np.empty((hi - lo,) + self.shape[1:], self.dtype)
                flat = out.reshape(hi - lo, -1)
                for i, b in enumerate(blobs):
                    if b is None:
                        flat[i] = self.fill_value
                    else:
                        flat[i] = np.frombuffer(b, self.dtype)
                return out
            buf = np.full((hi - lo) * chunk_bytes, 0, np.uint8)
            if any(b is None for b in blobs):
                fill = np.full(self.chunks, self.fill_value, self.dtype)
                view = buf.view(self.dtype).reshape((hi - lo,) + self.chunks)
                for i, b in enumerate(blobs):
                    if b is None:
                        view[i] = fill
            decode_many = (native.blosc_decode_many if comp_id == "blosc"
                           else native.zlib_decode_many)
            decoded = decode_many(blobs, chunk_bytes, out=buf)
            if decoded is not None:
                return decoded.view(self.dtype).reshape((hi - lo,) + self.shape[1:])
        return np.stack([self[i] for i in range(lo, hi)])


def create_array(path: str | Path, shape, chunks=None, dtype=np.float32,
                 compressor: dict | None = None, filters: list | None = None,
                 fill_value: Any = 0, attrs: dict | None = None,
                 data: np.ndarray | None = None,
                 dims: tuple | None = None,
                 overwrite: bool = False) -> Array:
    """Create a zarr-v2 array; optionally write ``data`` and dimension names."""
    path = Path(path)
    if path.exists():
        if not overwrite and (path / ".zarray").exists():
            raise FileExistsError(path)
        if overwrite:
            shutil.rmtree(path)
    path.mkdir(parents=True, exist_ok=True)

    shape = tuple(int(s) for s in shape)
    if chunks is None:
        chunks = shape if shape else (1,)
    chunks = tuple(int(c) for c in chunks)
    dtype = np.dtype(dtype)
    meta = {
        "zarr_format": 2,
        "shape": list(shape),
        "chunks": list(chunks),
        "dtype": dtype.str,
        "compressor": compressor,
        "fill_value": fill_value,
        "filters": filters,
        "order": "C",
    }
    (path / ".zarray").write_text(json.dumps(meta, indent=1))
    arr = Array(path)
    if attrs:
        arr.attrs.update(attrs)
    if dims is not None:
        arr.attrs["_ARRAY_DIMENSIONS"] = list(dims)
    if attrs or dims is not None:
        arr.attrs.save()
    if data is not None:
        arr[...] = np.asarray(data, dtype)
    return arr


# -- group ---------------------------------------------------------------------


class Group:
    """A zarr-v2 group: a directory with a ``.zgroup`` and child nodes."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        if not (self.path / ".zgroup").exists():
            raise ValueError(f"{path}: not a zarr v2 group")
        self.attrs = _Attrs(self.path)

    def keys(self) -> list[str]:
        out = []
        for child in sorted(self.path.iterdir()):
            if (child / ".zarray").exists() or (child / ".zgroup").exists():
                out.append(child.name)
        return out

    def arrays(self) -> list[str]:
        return [k for k in self.keys() if (self.path / k / ".zarray").exists()]

    def __contains__(self, name: str) -> bool:
        return name in self.keys()

    def __getitem__(self, name: str):
        child = self.path / name
        if (child / ".zarray").exists():
            return Array(child)
        if (child / ".zgroup").exists():
            return Group(child)
        raise KeyError(name)

    def create_array(self, name: str, **kwargs) -> Array:
        return create_array(self.path / name, **kwargs)

    def create_group(self, name: str) -> "Group":
        return create_group(self.path / name)

    def consolidate(self) -> None:
        """Write a ``.zmetadata`` index (zarr consolidated-metadata layout)."""
        meta = {}
        for root, _, files in os.walk(self.path):
            rel = os.path.relpath(root, self.path)
            prefix = "" if rel == "." else rel.replace(os.sep, "/") + "/"
            for f in files:
                if f in (".zarray", ".zgroup", ".zattrs"):
                    meta[prefix + f] = json.loads((Path(root) / f).read_text())
        (self.path / ".zmetadata").write_text(
            json.dumps({"zarr_consolidated_format": 1, "metadata": meta}, indent=1)
        )


def create_group(path: str | Path, overwrite: bool = False) -> Group:
    path = Path(path)
    if overwrite and path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True, exist_ok=True)
    zg = path / ".zgroup"
    if not zg.exists():
        zg.write_text(json.dumps({"zarr_format": 2}))
    return Group(path)


def open_store(path: str | Path):
    """Open a path as Array or Group."""
    path = Path(path)
    if (path / ".zarray").exists():
        return Array(path)
    if (path / ".zgroup").exists():
        return Group(path)
    raise ValueError(f"{path}: neither a zarr array nor group")
