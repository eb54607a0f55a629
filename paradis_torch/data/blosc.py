"""Blosc-1 frame codec (numcodecs-compatible byte format).

The port's own copy of ``paradis_tpu/data/blosc.py`` (the same frames, byte
for byte), over the port's native library (``paradis_torch/data/native.py``).

Genuine WeatherBench-2 zarr stores are Blosc(lz4, byte-shuffle)-compressed
(the reference ingests them via zarr-python/numcodecs,
``scripts/preprocess_dataset.py:13-15``); the reference forecast writer also
emits Blosc frames (``utils/file_output.py:14-28``).  This module makes such
stores readable/writable without numcodecs: the native implementation lives
in ``paradis_torch/csrc/host_ops.cpp`` (LZ4 + zlib + zstd block codecs — zstd via the
system libzstd — byte shuffle, split streams), with a pure-Python mirror as
fallback (zstd through a direct ctypes binding).

Container facts (c-blosc 1.x ``blosc.c``): 16-byte header ``version,
versionlz, flags, typesize, nbytes:i32, blocksize:i32, cbytes:i32``; flags
0x1 byte-shuffle / 0x2 memcpyed / 0x4 bit-shuffle / 0x10 dont-split / bits
5-7 codec id (0 blosclz, 1 lz4, 2 snappy, 3 zlib, 4 zstd); int32 block
offsets; per block ``nsplits`` sub-streams of ``int32 csize + payload``
(``typesize`` streams unless dont-split or the leftover block), raw when
``csize == substream_size``, zero-run when ``csize == 0``; byte-shuffle is
per block, before splitting.

Unsupported (clear errors): bit-shuffle, snappy, blosclz decode.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
import zlib

import numpy as np


def _load_zstd():
    """Direct ctypes binding to the system libzstd (python fallback path)."""
    name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_char_p, ctypes.c_size_t]
    lib.ZSTD_compress.restype = ctypes.c_size_t
    lib.ZSTD_compress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    return lib


_zstd = _load_zstd()


def _zstd_decode_py(payload: bytes, dst_len: int) -> bytes:
    if _zstd is None:
        raise BloscError("zstd decode needs libzstd (not found)")
    out = ctypes.create_string_buffer(dst_len)
    r = _zstd.ZSTD_decompress(out, dst_len, payload, len(payload))
    if _zstd.ZSTD_isError(r) or r != dst_len:
        raise BloscError("corrupt zstd substream")
    return out.raw

_CODEC_IDS = {"blosclz": 0, "lz4": 1, "lz4hc": 1, "snappy": 2, "zlib": 3, "zstd": 4}
_CODEC_NAMES = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}

NOSHUFFLE, SHUFFLE, BITSHUFFLE = 0, 1, 2


class BloscError(ValueError):
    pass


# -- pure-Python LZ4 block codec (correct, slow; the native path is primary) --


def _lz4_decode_py(src: bytes, dst_len: int) -> bytes:
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out += src[i : i + lit]
        i += lit
        if i >= n:
            break
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(out):
            raise BloscError("corrupt LZ4 stream")
        mlen = token & 15
        if mlen == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        pos = len(out) - offset
        for _ in range(mlen):  # overlap-safe byte copy
            out.append(out[pos])
            pos += 1
    if len(out) != dst_len:
        raise BloscError(f"LZ4 stream decoded {len(out)} != {dst_len} bytes")
    return bytes(out)


# -- pure-Python frame codec ---------------------------------------------------


def _unshuffle(ts: int, buf: bytes) -> bytes:
    arr = np.frombuffer(buf, np.uint8).reshape(ts, -1)
    return arr.T.tobytes()


def _shuffle(ts: int, buf: bytes) -> bytes:
    arr = np.frombuffer(buf, np.uint8).reshape(-1, ts)
    return arr.T.tobytes()


def _decode_frame_py(src: bytes, dst_len: int) -> bytes:
    if len(src) < 16:
        raise BloscError("truncated blosc frame")
    flags, typesize = src[2], src[3] or 256
    nbytes, blocksize, _cbytes = struct.unpack_from("<iii", src, 4)
    if nbytes != dst_len:
        raise BloscError(f"frame nbytes {nbytes} != expected {dst_len}")
    if nbytes == 0:
        return b""
    if flags & 0x2:  # memcpyed
        return bytes(src[16 : 16 + nbytes])
    codec = (flags >> 5) & 0x7
    if flags & 0x4:
        raise BloscError("blosc bit-shuffle is not supported")
    if codec not in (1, 3, 4):
        raise BloscError(
            f"blosc codec {_CODEC_NAMES.get(codec, codec)!r} is not supported "
            "(supported: lz4, zlib, zstd)"
        )
    shuffle = bool(flags & 0x1)
    dont_split = bool(flags & 0x10)
    nblocks = -(-nbytes // blocksize)
    offsets = struct.unpack_from(f"<{nblocks}i", src, 16)
    out = bytearray(nbytes)
    for b, off in enumerate(offsets):
        bsize = min(blocksize, nbytes - b * blocksize)
        leftover = bsize < blocksize
        nsplits = typesize if (not dont_split and not leftover) else 1
        if bsize % nsplits:
            raise BloscError("corrupt blosc frame (split size)")
        neblock = bsize // nsplits
        block = bytearray()
        ip = off
        for _ in range(nsplits):
            (cb,) = struct.unpack_from("<i", src, ip)
            ip += 4
            if cb == 0:
                block += b"\x00" * neblock
                continue
            payload = src[ip : ip + cb]
            ip += cb
            if cb == neblock:
                block += payload
            elif codec == 1:
                block += _lz4_decode_py(payload, neblock)
            elif codec == 4:
                block += _zstd_decode_py(payload, neblock)
            else:
                raw = zlib.decompress(payload)
                if len(raw) != neblock:
                    raise BloscError("zlib substream length mismatch")
                block += raw
        if shuffle:
            if bsize % typesize:
                raise BloscError("corrupt blosc frame (shuffle size)")
            block = _unshuffle(typesize, bytes(block))
        out[b * blocksize : b * blocksize + bsize] = block
    return bytes(out)


def _encode_frame_py(src: bytes, typesize: int, clevel: int,
                     shuffle: int, blocksize: int) -> bytes:
    """Python fallback encoder: zlib codec only (never split, like c-blosc)."""
    nbytes = len(src)
    if typesize < 1 or typesize > 255:
        typesize = 1
    if nbytes % typesize:
        shuffle = NOSHUFFLE
    if blocksize <= 0:
        blocksize = min(nbytes, 256 * 1024) or typesize
    blocksize = max(typesize, blocksize - blocksize % typesize)
    blocksize = min(blocksize, nbytes) if nbytes else blocksize
    nblocks = -(-nbytes // blocksize) if nbytes else 0
    flags = (3 << 5) | (0x1 if shuffle == SHUFFLE else 0) | 0x10
    header = bytearray(16)
    header[0], header[1], header[2], header[3] = 2, 1, flags, typesize % 256
    struct.pack_into("<ii", header, 4, nbytes, blocksize)
    bstarts = bytearray(4 * nblocks)
    body = bytearray()
    base = 16 + 4 * nblocks
    for b in range(nblocks):
        bsize = min(blocksize, nbytes - b * blocksize)
        block = src[b * blocksize : b * blocksize + bsize]
        if shuffle == SHUFFLE and bsize % typesize == 0:
            block = _shuffle(typesize, block)
        struct.pack_into("<i", bstarts, 4 * b, base + len(body))
        comp = zlib.compress(block, max(1, min(9, clevel)))
        if len(comp) >= bsize:
            body += struct.pack("<i", bsize) + block
        else:
            body += struct.pack("<i", len(comp)) + comp
    total = base + len(body)
    if total >= nbytes + 16:  # incompressible: memcpyed
        header[2] = (3 << 5) | 0x2
        struct.pack_into("<i", header, 12, nbytes + 16)
        return bytes(header) + src
    struct.pack_into("<i", header, 12, total)
    return bytes(header) + bytes(bstarts) + bytes(body)


# -- public API (native fast path, python fallback) ----------------------------


def decode(blob: bytes, dst_nbytes: int) -> bytes:
    """Decode one Blosc-1 frame to exactly ``dst_nbytes`` bytes."""
    from paradis_torch.data import native

    lib = native.get_lib()
    if lib is not None:
        out = np.empty(dst_nbytes, np.uint8)
        rc = lib.blosc_decode_frame(blob, len(blob),
                                    out.ctypes.data_as(native.U8P), dst_nbytes)
        if rc == 0:
            return out.tobytes()
        if rc in (-10, -11, -12):
            codec = (blob[2] >> 5) & 0x7 if len(blob) > 2 else -1
            raise BloscError(
                "blosc feature unsupported: "
                + ("bit-shuffle" if rc == -10
                   else f"codec {_CODEC_NAMES.get(codec, codec)!r}")
            )
        raise BloscError(f"corrupt blosc frame (native rc={rc})")
    return _decode_frame_py(blob, dst_nbytes)


def encode(raw: bytes, typesize: int, cname: str = "lz4", clevel: int = 5,
           shuffle: int = SHUFFLE, blocksize: int = 0) -> bytes:
    """Encode bytes as a Blosc-1 frame (native lz4/zlib; python zlib fallback)."""
    if shuffle == BITSHUFFLE:
        raise BloscError("blosc bit-shuffle is not supported")
    codec = _CODEC_IDS.get(cname)
    if codec is None:
        raise BloscError(f"unknown blosc cname {cname!r}")
    from paradis_torch.data import native

    lib = native.get_lib()
    if lib is not None and codec in (1, 3, 4):
        cap = len(raw) + 16 + 4096 + len(raw) // 8
        out = np.empty(cap, np.uint8)
        n = lib.blosc_encode_frame(raw, len(raw), int(typesize), int(codec),
                                   int(clevel), int(shuffle), int(blocksize),
                                   out.ctypes.data_as(native.U8P), cap)
        if n > 0:
            return out[:n].tobytes()
    if codec == 3 or lib is None:
        return _encode_frame_py(raw, typesize, clevel, shuffle, blocksize)
    raise BloscError(f"blosc encode with {cname!r} needs the native library")
