// host_ops: native host-side kernels for the paradis_torch data pipeline.
//
// The port's own copy of the JAX package's csrc/host_ops.cpp.  The
// training-input pipeline (zarr chunk decode + normalization) runs on the
// host while the card computes; these kernels keep it off the Python
// interpreter: batched zlib and Blosc inflation and fused z-score
// normalization, multithreaded and GIL-free (callers hold no Python state).
// Bound via ctypes from paradis_torch/data/native.py; the Python
// implementations remain as the fallback.
//
// Unlike the JAX package's copy, libzstd is opened at run time
// (libzstd.so.1), not linked: the library builds on a host that has the zstd
// runtime but not its headers, and where the runtime is missing the zstd
// codec alone reports an error.
//
// Build (native.py does this): g++ -O3 -shared -fPIC -std=c++17 host_ops.cpp
//   -o libparadis_host.so -lz -ldl -pthread

#include <dlfcn.h>
#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// The four libzstd entry points the Blosc codec uses, resolved once.
struct Zstd {
  size_t (*decompress)(void*, size_t, const void*, size_t) = nullptr;
  size_t (*compress)(void*, size_t, const void*, size_t, int) = nullptr;
  size_t (*compress_bound)(size_t) = nullptr;
  unsigned (*is_error)(size_t) = nullptr;

  Zstd() {
    void* h = dlopen("libzstd.so.1", RTLD_NOW | RTLD_LOCAL);
    if (h == nullptr) return;
    decompress = reinterpret_cast<decltype(decompress)>(dlsym(h, "ZSTD_decompress"));
    compress = reinterpret_cast<decltype(compress)>(dlsym(h, "ZSTD_compress"));
    compress_bound = reinterpret_cast<decltype(compress_bound)>(dlsym(h, "ZSTD_compressBound"));
    is_error = reinterpret_cast<decltype(is_error)>(dlsym(h, "ZSTD_isError"));
  }
  bool ok() const { return decompress && compress && compress_bound && is_error; }
};

const Zstd& zstd() {
  static const Zstd z;  // thread-safe initialisation (C++11)
  return z;
}

}  // namespace

extern "C" {

// Inflate n zlib streams into a contiguous destination of n fixed-size chunks.
// srcs[i] may be null => chunk filled with fill_byte-initialized zeros pattern
// is left untouched (caller pre-fills).  Returns 0 on success, else the index
// of the first failing chunk + 1.
int zlib_decode_many(const uint8_t* const* srcs, const int64_t* src_lens,
                     uint8_t* dst, int64_t chunk_bytes, int n, int n_threads) {
  std::atomic<int> next(0);
  std::atomic<int> failed(0);

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load()) return;
      if (srcs[i] == nullptr) continue;  // missing chunk: caller pre-filled
      uLongf out_len = static_cast<uLongf>(chunk_bytes);
      int rc = uncompress(dst + static_cast<int64_t>(i) * chunk_bytes, &out_len,
                          srcs[i], static_cast<uLong>(src_lens[i]));
      if (rc != Z_OK || out_len != static_cast<uLongf>(chunk_bytes)) {
        failed.store(i + 1);
        return;
      }
    }
  };

  int threads = n_threads > 0 ? n_threads : 1;
  if (threads == 1 || n == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failed.load();
}

// Fused z-score normalization over a channels-last array:
//   data[p, c] = (data[p, c] - mean[idx[c]]) / std[idx[c]]  for c in idx set.
// `channels` is the trailing dimension; `idx` selects which channels to
// normalize with which statistic row (idx_len entries of (channel, stat_row)).
void zscore_normalize_inplace(float* data, int64_t n_px, int64_t channels,
                              const int64_t* chan_idx, const float* mean,
                              const float* stddev, int64_t idx_len,
                              int n_threads) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t p = lo; p < hi; ++p) {
      float* row = data + p * channels;
      for (int64_t k = 0; k < idx_len; ++k) {
        const int64_t c = chan_idx[k];
        row[c] = (row[c] - mean[k]) / stddev[k];
      }
    }
  };
  int threads = n_threads > 0 ? n_threads : 1;
  if (threads == 1) {
    work(0, n_px);
    return;
  }
  std::vector<std::thread> pool;
  int64_t per = (n_px + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * per;
    int64_t hi = lo + per < n_px ? lo + per : n_px;
    if (lo >= hi) break;
    pool.emplace_back(work, lo, hi);
  }
  for (auto& th : pool) th.join();
}

// BitRound: drop low mantissa bits of float32 with round-to-nearest
// (numcodecs-compatible; used by the forecast writer's encoding).
void bitround_inplace(uint32_t* bits, int64_t n, int keepbits) {
  const int drop = 23 - keepbits;
  if (drop <= 0) return;
  const uint32_t half = 1u << (drop - 1);
  const uint32_t mask = ~((1u << drop) - 1u);
  for (int64_t i = 0; i < n; ++i) {
    bits[i] = (bits[i] + half) & mask;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Blosc-1 container (c-blosc 1.x / numcodecs byte format) with LZ4, zlib
// and zstd block codecs (zstd via the system libzstd, opened at run time).  Needed to ingest genuine WeatherBench-2 zarr stores, which
// are Blosc(lz4, shuffle)-compressed (reference scripts/preprocess_dataset.py
// reads them via zarr-python/numcodecs).  Format facts (c-blosc blosc.c):
//   16-byte header: version, versionlz, flags, typesize, nbytes int32,
//     blocksize int32, cbytes int32 (all little-endian);
//   flags: 0x1 byte-shuffle, 0x2 memcpyed, 0x4 bit-shuffle, 0x10 dont-split,
//     bits 5-7 codec (0 blosclz, 1 lz4/lz4hc, 2 snappy, 3 zlib, 4 zstd);
//   then int32 block offsets (from frame start), one per
//     ceil(nbytes/blocksize) block;
//   each block: nsplits sub-streams (typesize streams unless dont-split or
//     the leftover block), each "int32 csize + payload", stored raw when
//     csize == substream size, all-zeros when csize == 0;
//   byte-shuffle is applied per block before splitting.
// ---------------------------------------------------------------------------

namespace {

// ---- LZ4 block format ----

int64_t lz4_block_decode(const uint8_t* src, int64_t slen, uint8_t* dst,
                         int64_t dcap) {
  const uint8_t* ip = src;
  const uint8_t* iend = src + slen;
  uint8_t* op = dst;
  uint8_t* oend = dst + dcap;
  while (ip < iend) {
    const uint8_t token = *ip++;
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > iend || op + lit > oend) return -1;
    memcpy(op, ip, static_cast<size_t>(lit));
    ip += lit;
    op += lit;
    if (ip >= iend) break;  // final sequence carries literals only
    if (ip + 2 > iend) return -1;
    const int64_t offset = ip[0] | (static_cast<int64_t>(ip[1]) << 8);
    ip += 2;
    if (offset == 0 || op - dst < offset) return -1;
    int64_t mlen = token & 15;
    if (mlen == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        mlen += b;
      } while (b == 255);
    }
    mlen += 4;
    if (op + mlen > oend) return -1;
    const uint8_t* ref = op - offset;
    for (int64_t k = 0; k < mlen; ++k) op[k] = ref[k];  // overlap-safe
    op += mlen;
  }
  return op - dst;
}

// Greedy hash-chain-free LZ4 block encoder (format-correct; favors speed).
// Returns compressed size, or -1 when the output would not fit in `cap`.
int64_t lz4_block_encode(const uint8_t* src, int64_t n, uint8_t* dst,
                         int64_t cap) {
  constexpr int64_t MFLIMIT = 12;      // last match must start 12B before end
  constexpr int64_t LASTLITERALS = 5;  // final 5 bytes are always literals
  constexpr int HASH_BITS = 13;
  int32_t htab[1 << HASH_BITS];
  for (auto& h : htab) h = -1;

  auto hash4 = [](const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return (v * 2654435761u) >> (32 - HASH_BITS);
  };

  uint8_t* op = dst;
  uint8_t* oend = dst + cap;
  int64_t anchor = 0, pos = 0;

  auto emit = [&](int64_t lit_start, int64_t lit_len, int64_t offset,
                  int64_t mlen) -> bool {  // mlen==0 => literals-only tail
    int64_t need = 1 + lit_len / 255 + 1 + lit_len + (mlen ? 2 + mlen / 255 + 1 : 0);
    if (op + need > oend) return false;
    uint8_t* token = op++;
    int64_t l = lit_len;
    *token = 0;
    if (l >= 15) {
      *token = 15 << 4;
      l -= 15;
      while (l >= 255) {
        *op++ = 255;
        l -= 255;
      }
      *op++ = static_cast<uint8_t>(l);
    } else {
      *token = static_cast<uint8_t>(l << 4);
    }
    memcpy(op, src + lit_start, static_cast<size_t>(lit_len));
    op += lit_len;
    if (mlen == 0) return true;
    *op++ = static_cast<uint8_t>(offset & 0xff);
    *op++ = static_cast<uint8_t>(offset >> 8);
    int64_t m = mlen - 4;
    if (m >= 15) {
      *token |= 15;
      m -= 15;
      while (m >= 255) {
        *op++ = 255;
        m -= 255;
      }
      *op++ = static_cast<uint8_t>(m);
    } else {
      *token |= static_cast<uint8_t>(m);
    }
    return true;
  };

  if (n >= MFLIMIT) {
    const int64_t match_limit = n - MFLIMIT;
    while (pos <= match_limit) {
      const uint32_t h = hash4(src + pos);
      const int32_t cand = htab[h];
      htab[h] = static_cast<int32_t>(pos);
      if (cand >= 0 && pos - cand <= 65535 &&
          memcmp(src + cand, src + pos, 4) == 0) {
        int64_t mlen = 4;
        const int64_t mend = n - LASTLITERALS;
        while (pos + mlen < mend && src[cand + mlen] == src[pos + mlen]) ++mlen;
        if (!emit(anchor, pos - anchor, pos - cand, mlen)) return -1;
        pos += mlen;
        anchor = pos;
      } else {
        ++pos;
      }
    }
  }
  if (!emit(anchor, n - anchor, 0, 0)) return -1;
  return op - dst;
}

// ---- byte (un)shuffle over one block ----

void shuffle_bytes(int ts, int64_t nbytes, const uint8_t* src, uint8_t* dst) {
  const int64_t ne = nbytes / ts;
  for (int j = 0; j < ts; ++j)
    for (int64_t i = 0; i < ne; ++i) dst[j * ne + i] = src[i * ts + j];
}

void unshuffle_bytes(int ts, int64_t nbytes, const uint8_t* src, uint8_t* dst) {
  const int64_t ne = nbytes / ts;
  for (int j = 0; j < ts; ++j)
    for (int64_t i = 0; i < ne; ++i) dst[i * ts + j] = src[j * ne + i];
}

int32_t read_i32(const uint8_t* p) {
  int32_t v;
  memcpy(&v, p, 4);
  return v;
}

void write_i32(uint8_t* p, int32_t v) { memcpy(p, &v, 4); }

}  // namespace

extern "C" {

// Decode one Blosc-1 frame into dst (dst_len must equal the frame's nbytes).
// Returns 0 on success; negative error codes:
//  -1 truncated/corrupt, -2 size mismatch, -5 codec stream error,
//  -10 bit-shuffle unsupported, -11 codec unsupported (snappy, or zstd
//  where libzstd.so.1 is missing),
//  -12 blosclz unsupported.
int blosc_decode_frame(const uint8_t* src, int64_t slen, uint8_t* dst,
                       int64_t dlen) {
  if (slen < 16) return -1;
  const int flags = src[2];
  int typesize = src[3];
  if (typesize == 0) typesize = 256;
  const int64_t nbytes = static_cast<uint32_t>(read_i32(src + 4));
  const int64_t blocksize = static_cast<uint32_t>(read_i32(src + 8));
  if (nbytes != dlen) return -2;
  if (nbytes == 0) return 0;
  if (flags & 0x2) {  // memcpyed: raw payload, shuffle never applied
    if (slen < 16 + nbytes) return -1;
    memcpy(dst, src + 16, static_cast<size_t>(nbytes));
    return 0;
  }
  if (blocksize <= 0) return -1;
  const int codec = (flags >> 5) & 0x7;
  const bool shuffle = flags & 0x1;
  if (flags & 0x4) return -10;
  if (codec == 0) return -12;
  if (codec != 1 && codec != 3 && codec != 4) return -11;
  const bool dont_split = flags & 0x10;

  const int64_t nblocks = (nbytes + blocksize - 1) / blocksize;
  if (16 + nblocks * 4 > slen) return -1;
  const uint8_t* bstarts = src + 16;
  std::vector<uint8_t> tmp(shuffle ? blocksize : 0);

  for (int64_t b = 0; b < nblocks; ++b) {
    const int64_t off = static_cast<uint32_t>(read_i32(bstarts + 4 * b));
    if (off < 16 || off > slen) return -1;
    const uint8_t* ip = src + off;
    const int64_t bsize = std::min<int64_t>(blocksize, nbytes - b * blocksize);
    const bool leftover = bsize < blocksize;
    const int nsplits = (!dont_split && !leftover) ? typesize : 1;
    if (bsize % nsplits != 0) return -1;
    const int64_t neblock = bsize / nsplits;
    uint8_t* bout = shuffle ? tmp.data() : dst + b * blocksize;
    for (int j = 0; j < nsplits; ++j) {
      if (ip + 4 > src + slen) return -1;
      const int32_t cb = read_i32(ip);
      ip += 4;
      if (cb == 0) {  // run of zeros
        memset(bout + j * neblock, 0, static_cast<size_t>(neblock));
        continue;
      }
      if (cb < 0 || ip + cb > src + slen) return -1;
      if (cb == neblock) {
        memcpy(bout + j * neblock, ip, static_cast<size_t>(neblock));
      } else if (codec == 1) {
        if (lz4_block_decode(ip, cb, bout + j * neblock, neblock) != neblock)
          return -5;
      } else if (codec == 4) {
        if (!zstd().ok()) return -11;  // no libzstd: codec unsupported here
        const size_t r = zstd().decompress(bout + j * neblock,
                                           static_cast<size_t>(neblock), ip,
                                           static_cast<size_t>(cb));
        if (zstd().is_error(r) || static_cast<int64_t>(r) != neblock) return -5;
      } else {
        uLongf outl = static_cast<uLongf>(neblock);
        if (uncompress(bout + j * neblock, &outl, ip,
                       static_cast<uLong>(cb)) != Z_OK ||
            static_cast<int64_t>(outl) != neblock)
          return -5;
      }
      ip += cb;
    }
    if (shuffle) {
      if (bsize % typesize != 0) return -1;
      unshuffle_bytes(typesize, bsize, tmp.data(), dst + b * blocksize);
    }
  }
  return 0;
}

// Encode src into a Blosc-1 frame.  codec: 1 = lz4, 3 = zlib, 4 = zstd.
// shuffle:
// 0 = none, 1 = byte shuffle.  blocksize 0 = auto.  Returns the frame size,
// or a negative error (dst_cap should be >= nbytes + 16 + 4*nblocks + slack).
int64_t blosc_encode_frame(const uint8_t* src, int64_t nbytes, int typesize,
                           int codec, int clevel, int shuffle,
                           int64_t blocksize, uint8_t* dst, int64_t dst_cap) {
  if (typesize < 1 || typesize > 255) typesize = 1;
  if (nbytes % typesize != 0) shuffle = 0;
  if (codec != 1 && codec != 3 && codec != 4) return -11;
  if (blocksize <= 0) {
    blocksize = 256 * 1024;
    if (blocksize > nbytes) blocksize = nbytes;
  }
  blocksize = std::max<int64_t>(typesize, blocksize - blocksize % typesize);
  if (blocksize > nbytes && nbytes > 0) blocksize = nbytes;

  // c-blosc FORWARD_COMPAT split rule: split for blosclz/lz4(hc) only, when
  // typesize fits and blocks are big enough (blosc.c split_block()).
  const bool split = codec == 1 && typesize <= 16 && typesize > 1 &&
                     blocksize / typesize >= 128;
  const int64_t nblocks = nbytes > 0 ? (nbytes + blocksize - 1) / blocksize : 0;
  int flags = (codec << 5) | (shuffle ? 0x1 : 0) | (split ? 0 : 0x10);

  if (dst_cap < 16 + 4 * nblocks) return -1;
  dst[0] = 2;  // BLOSC_VERSION_FORMAT
  dst[1] = 1;
  dst[3] = static_cast<uint8_t>(typesize == 256 ? 0 : typesize);
  write_i32(dst + 4, static_cast<int32_t>(nbytes));
  write_i32(dst + 8, static_cast<int32_t>(blocksize));

  uint8_t* bstarts = dst + 16;
  uint8_t* op = dst + 16 + 4 * nblocks;
  uint8_t* oend = dst + dst_cap;
  std::vector<uint8_t> tmp(blocksize), ztmp;

  for (int64_t b = 0; b < nblocks; ++b) {
    const int64_t bsize = std::min<int64_t>(blocksize, nbytes - b * blocksize);
    const bool leftover = bsize < blocksize;
    const uint8_t* bin = src + b * blocksize;
    if (shuffle && bsize % typesize == 0) {
      shuffle_bytes(typesize, bsize, bin, tmp.data());
      bin = tmp.data();
    }
    const int nsplits = (split && !leftover) ? typesize : 1;
    if (bsize % nsplits != 0) return -1;
    const int64_t neblock = bsize / nsplits;
    write_i32(bstarts + 4 * b, static_cast<int32_t>(op - dst));
    for (int j = 0; j < nsplits; ++j) {
      if (op + 4 + neblock > oend) return -1;
      uint8_t* csize_at = op;
      op += 4;
      int64_t cb;
      if (codec == 1) {
        cb = lz4_block_encode(bin + j * neblock, neblock, op, neblock - 1);
      } else if (codec == 4) {
        if (!zstd().ok()) return -1;  // no libzstd: encode fails
        ztmp.resize(zstd().compress_bound(static_cast<size_t>(neblock)));
        const int lvl = clevel < 1 ? 1 : (clevel > 9 ? 9 : clevel);
        const size_t r = zstd().compress(ztmp.data(), ztmp.size(),
                                         bin + j * neblock,
                                         static_cast<size_t>(neblock), lvl);
        cb = zstd().is_error(r) ? -1 : static_cast<int64_t>(r);
        if (cb >= neblock) cb = -1;
        if (cb > 0) memcpy(op, ztmp.data(), static_cast<size_t>(cb));
      } else {
        ztmp.resize(compressBound(static_cast<uLong>(neblock)));
        uLongf zl = static_cast<uLongf>(ztmp.size());
        const int lvl = clevel < 1 ? 1 : (clevel > 9 ? 9 : clevel);
        cb = compress2(ztmp.data(), &zl, bin + j * neblock,
                       static_cast<uLong>(neblock), lvl) == Z_OK
                 ? static_cast<int64_t>(zl)
                 : -1;
        if (cb >= neblock) cb = -1;
        if (cb > 0) memcpy(op, ztmp.data(), static_cast<size_t>(cb));
      }
      if (cb < 0) {  // no gain: store this split raw
        memcpy(op, bin + j * neblock, static_cast<size_t>(neblock));
        cb = neblock;
      }
      write_i32(csize_at, static_cast<int32_t>(cb));
      op += cb;
    }
  }

  int64_t total = op - dst;
  if (total >= nbytes + 16) {  // incompressible: memcpyed frame (like c-blosc)
    if (dst_cap < nbytes + 16) return -1;
    flags = (codec << 5) | 0x2;
    write_i32(dst + 8, static_cast<int32_t>(std::min<int64_t>(
        nbytes, blocksize)));
    memcpy(dst + 16, src, static_cast<size_t>(nbytes));
    total = nbytes + 16;
  }
  dst[2] = static_cast<uint8_t>(flags);
  write_i32(dst + 12, static_cast<int32_t>(total));
  return total;
}

// Batched frame decode (one fixed-size destination chunk per frame; null srcs
// are skipped — caller pre-fills).  Returns 0 or (index of first failure + 1).
int blosc_decode_many(const uint8_t* const* srcs, const int64_t* src_lens,
                      uint8_t* dst, int64_t chunk_bytes, int n, int n_threads) {
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load()) return;
      if (srcs[i] == nullptr) continue;
      if (blosc_decode_frame(srcs[i], src_lens[i],
                             dst + static_cast<int64_t>(i) * chunk_bytes,
                             chunk_bytes) != 0) {
        failed.store(i + 1);
        return;
      }
    }
  };
  int threads = n_threads > 0 ? n_threads : 1;
  if (threads == 1 || n == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failed.load();
}

}  // extern "C"
