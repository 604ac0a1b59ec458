// count_chunk.cu: count one chunk of reads into the dense transition table:
// int8 residue codes and per-row meta go in, counts come out.
//
// Replaces the TPU work of bear_tpu's counting device entry,
// bear_tpu/counting/engine.py:277 (_count_chunk_kernel, method="sorted"):
// its index math, which XLA ran as ~40 elementwise passes over [B, L+1]
// int32 arrays, and the Pallas histogram kernel it calls,
// bear_tpu/counting/pallas_hist.py:81 (_hist_kernel). On the TPU the flat
// keys went through HBM, were sorted and were histogrammed as int8 one-hot
// matmuls, because scatter-add there is a serial apply. Here the keys never
// leave registers: each valid key is one fire-and-forget atomicAdd in L2
// (hist_add.cuh, the update window_hist.cu also uses).
//
// The row-range form is the same launch with a shard index: it replaces the
// TPU kernel where bear_tpu drives it with engine._count_chunk_kernel(
// shard=(pass_idx, per_lag)) from counting/multipass.py:45-51 (one pass of
// a lag-14/15 table too large for one card) and parallel/counting.py:240-247.
// Each lag then has a row stride and a local row count: the table holds only
// the context rows [shard * stride, shard * stride + local_rows) of every
// group, and keys of other rows are dropped. The dense table is the case
// shard = 0, stride = local_rows = rows(l).
//
// Contract (equal, bit for bit, to window_update_plain(table, chunk_keys(...))
// on codes in [0, A) at every position < length and groups in [0, n_groups)):
//   position j of row b, 0 <= j <= L, is counted iff j >= skip and either
//   j < length, or j == length and the row is stopped; for a row that is not
//   fresh, lag l also drops j < l. The next symbol is codes[b, j] for
//   j < length and '$' (value A) at j == length. Context digits before the
//   read start read 0; the context row is grow = pad_offset(l, max(0, l - j))
//   + code (below rows(15) < 2^31) and its local row rloc = grow - shard *
//   stride(l). A key with 0 <= rloc < local_rows(l) is
//   offset(l) + (group * local_rows(l) + rloc) * (A + 1) + next, in 64-bit
//   arithmetic (group multiplies local_rows, never rows: rows(15) times 2
//   groups times 5 overflows 32 bits); keys outside [0, n_table) are dropped.
//
// What bounds it: bytes. The codes (1 byte per position) and meta (16 bytes
// per row) are read once; every 32-byte table sector a valid key touches is
// read and written once in L2 / HBM. The arithmetic is a few integer
// operations per key. On an H100 the atomics' time follows the number of
// distinct 128-byte table lines a launch touches (random read-modify-writes
// over a table far larger than L2), not their count or order (the ablation
// in chip_smoke.py, PERF.md). The design:
//   - a persistent grid walks the flattened [B, L+1] position grid in tiles
//     of up to 2,048 positions. A tile's codes are one contiguous byte range
//     of `codes` plus a max_lag-byte halo in front; that range (16-byte
//     aligned, zero-filled outside the array) and the tile's meta rows are
//     staged in shared memory with cp.async, double-buffered, so the next
//     tile's copy overlaps this tile's atomics. No TMA: its 2-D maps need
//     16-byte row strides, which L = 150 lacks, and one range is 1-D anyway.
//   - each thread takes a run of 8 consecutive positions. It builds the
//     base-A code of the max_lag context of its first position from shared
//     memory, then rolls it: code(j+1) = s[j] + A*(code(j) - s[j-M]*A^(M-1)),
//     resetting it to 0 at a row start. The lag-l code is its low l digits,
//     code mod A^l. No key is written to memory.
//   - masked positions are simply skipped: no sentinel exists in here.

#include <cstdint>
#include <cuda_runtime.h>

#include "hist_add.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 8;                    // consecutive positions a thread takes
constexpr int kTile = kThreads * kRun;     // most positions of a tile
constexpr int kMaxRows = 32;               // most rows a tile spans
constexpr int kMaxLags = 16;
constexpr int kMaxLag = 15;                // 4^16 exceeds int32 context codes
constexpr int kCodeBytes = 2112;           // >= kTile + kMaxLag + 2 * 15, 16-aligned
constexpr int kBlocksPerSm = 4;
constexpr int kStopped = 1;                // meta flag bits
constexpr int kFresh = 2;

static_assert(kCodeBytes % 16 == 0 && kCodeBytes >= kTile + kMaxLag + 30,
              "the staged code range of a tile must fit");

}  // namespace

// One counted lag. Mirrored by ctypes in bear_tpu_torch/counting/count_chunk.py.
struct CountLag {
  int32_t lag;
  int32_t offset;             // the lag's (local) table offset in the flat buffer
  int32_t rows;               // table_rows(lag)
  uint32_t modulus;           // A^lag
  int32_t stride;             // context rows per shard (rows for the dense table)
  int32_t local_rows;         // context rows the table holds per group
  int32_t pad[kMaxLag + 1];   // pad_offset(lag, n_pad), n_pad = 0..lag
};

struct CountLags {
  int32_t n_lags;             // 1..kMaxLags, ascending lags
  int32_t max_lag;            // M, the largest lag
  int32_t A;                  // residues; '$' is A
  uint32_t top_power;         // A^(M-1)
  CountLag lag[kMaxLags];
};

namespace {

struct __align__(16) Stage {
  signed char codes[kCodeBytes];
  int4 meta[kMaxRows];        // length, skip, group, flags
};

// Positions [f0, f1) of the flattened grid, the first row b0, and the first
// staged code byte lo (16-aligned, may be negative: zero-filled).
struct Tile {
  int64_t f0, f1, b0, lo;
};

struct Shape {
  int64_t n_pos, P, n_bytes, tile;
  int L;
};

__device__ __forceinline__ Tile tile_at(int64_t t, const Shape& sh, int max_lag) {
  Tile g;
  g.f0 = t * sh.tile;
  g.f1 = g.f0 + sh.tile < sh.n_pos ? g.f0 + sh.tile : sh.n_pos;
  g.b0 = g.f0 / sh.P;
  const int64_t j0 = g.f0 - g.b0 * sh.P;
  g.lo = (g.b0 * sh.L + j0 - max_lag) & ~int64_t{15};
  return g;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issue the copies of tile g into stage s: the code bytes [lo, hi) in
// 16-byte pieces (zero-filled before the array, cut at its end) and the meta
// rows b0..b1. Every thread of the block takes part.
__device__ void stage_tile(Stage& s, const Tile& g, const Shape& sh,
                           const signed char* __restrict__ codes,
                           const int4* __restrict__ meta) {
  const int64_t b1 = (g.f1 - 1) / sh.P;
  const int64_t j_last = g.f1 - 1 - b1 * sh.P;
  const int64_t end = b1 * sh.L + j_last + 1;
  const int64_t hi = end < sh.n_bytes ? end : sh.n_bytes;
  const int n16 = static_cast<int>((hi - g.lo + 15) >> 4);
  for (int i = threadIdx.x; i < n16; i += blockDim.x) {
    const int64_t c = g.lo + 16 * static_cast<int64_t>(i);
    signed char* dst = s.codes + 16 * i;
    if (c < 0 || c >= sh.n_bytes) {
      *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
    } else {
      const int64_t left = sh.n_bytes - c;
      cp_async16(dst, codes + c, left < 16 ? static_cast<int>(left) : 16);
    }
  }
  const int rows = static_cast<int>(b1 - g.b0 + 1);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    cp_async16(&s.meta[r], meta + g.b0 + r, 16);
  }
}

// Count this thread's run of positions of the staged tile g.
__device__ void count_run(const Stage& s, const Tile& g, const Shape& sh,
                          const CountLags& lags, int64_t shard,
                          int* __restrict__ table, int64_t n_table) {
  const int64_t fs = g.f0 + static_cast<int64_t>(threadIdx.x) * kRun;
  if (fs >= g.f1) {
    return;
  }
  const uint32_t A = static_cast<uint32_t>(lags.A);
  const uint32_t A1 = A + 1;
  const int M = lags.max_lag;
  const int L = sh.L;
  int64_t b = fs / sh.P;
  int j = static_cast<int>(fs - b * sh.P);
  // s.codes[base + x] is codes[b, x]; read only for 0 <= x < L.
  int base = static_cast<int>(b * L - g.lo);
  auto digit = [&](int x) -> uint32_t {
    return x >= 0 ? static_cast<uint32_t>(static_cast<int>(s.codes[base + x]))
                  : 0u;
  };
  uint32_t code = 0;  // base-A code of the M previous symbols, digit 1 lowest
  for (int i = M; i >= 1; --i) {
    code = code * A + digit(j - i);
  }
  int4 m = s.meta[b - g.b0];
  for (int r = 0; r < kRun; ++r) {
    if (fs + r >= g.f1) {
      break;
    }
    if (j == L + 1) {  // next row: nothing precedes its start
      ++b;
      j = 0;
      code = 0;
      base += L;
      m = s.meta[b - g.b0];
    }
    const int length = m.x;
    const bool live = j >= m.y && (j < length || (j == length && (m.w & kStopped)));
    if (live) {
      const uint32_t next = j < length ? (j < L ? digit(j) : 0u) : A;
      const int64_t group = m.z;
      const bool fresh = (m.w & kFresh) != 0;
      for (int k = 0; k < lags.n_lags; ++k) {
        const CountLag& lg = lags.lag[k];
        if (!fresh && j < lg.lag) {
          continue;
        }
        const uint32_t c = lg.lag == M ? code : code % lg.modulus;
        const int n_pad = lg.lag > j ? lg.lag - j : 0;
        const int64_t rloc = static_cast<int64_t>(lg.pad[n_pad]) + c - shard * lg.stride;
        if (rloc < 0 || rloc >= lg.local_rows) {
          continue;  // another shard's row
        }
        const int64_t key = lg.offset + (group * lg.local_rows + rloc) * A1 + next;
        if (key >= 0 && key < n_table) {  // int32 once in range
          hist_add(table, static_cast<int>(key), n_table);
        }
      }
    }
    if (j < L) {
      code = digit(j) + A * (code - (j >= M ? digit(j - M) : 0u) * lags.top_power);
    }
    ++j;
  }
}

__global__ void __launch_bounds__(kThreads)
count_chunk_kernel(int* __restrict__ table, int64_t n_table,
                   const signed char* __restrict__ codes,
                   const int4* __restrict__ meta, Shape sh, int64_t n_tiles,
                   int64_t shard, const __grid_constant__ CountLags lags) {
  __shared__ Stage stage[2];
  // The lag table is indexed per thread (lag k, n_pad); in shared memory
  // those reads neither serialise as divergent constant reads nor force a
  // per-thread copy of the parameter.
  __shared__ CountLags s_lags;
  int64_t t = blockIdx.x;
  if (t < n_tiles) {
    stage_tile(stage[0], tile_at(t, sh, lags.max_lag), sh, codes, meta);
  }
  cp_async_commit();
  const int* src = reinterpret_cast<const int*>(&lags);
  int* dst = reinterpret_cast<int*>(&s_lags);
  for (int i = threadIdx.x; i < static_cast<int>(sizeof(CountLags) / 4); i += blockDim.x) {
    dst[i] = src[i];
  }
  for (int it = 0; t < n_tiles; ++it, t += gridDim.x) {
    const int cur = it & 1;
    const int64_t t_next = t + gridDim.x;
    if (t_next < n_tiles) {
      stage_tile(stage[cur ^ 1], tile_at(t_next, sh, lags.max_lag), sh, codes,
                 meta);
    }
    cp_async_commit();  // possibly empty: keeps one group per tile
    cp_async_wait_all_but_last();
    __syncthreads();
    count_run(stage[cur], tile_at(t, sh, lags.max_lag), sh, s_lags, shard, table,
              n_table);
    __syncthreads();  // stage[cur] is refilled in the next iteration
  }
}

bool lags_ok(const CountLags& lags) {
  if (lags.n_lags < 1 || lags.n_lags > kMaxLags || lags.max_lag < 1 ||
      lags.max_lag > kMaxLag || lags.A < 2 ||
      lags.lag[lags.n_lags - 1].lag != lags.max_lag) {
    return false;
  }
  for (int k = 0; k < lags.n_lags; ++k) {
    const int l = lags.lag[k].lag;
    if (l < 1 || (k > 0 && l <= lags.lag[k - 1].lag) || lags.lag[k].modulus == 0 ||
        lags.lag[k].stride < 1 || lags.lag[k].local_rows < 1 || lags.lag[k].offset < 0) {
      return false;
    }
  }
  return true;
}

}  // namespace

// table: int32 [n_table]; codes: int8 [n_rows, row_len], contiguous, 16-byte
// aligned; meta: int32 [n_rows, 4] (length, skip, group, flags: bit 0
// stopped, bit 1 fresh), contiguous, 16-byte aligned; all on the current
// device. tile: positions per tile, 1..2048 and at most 31 * (row_len + 1),
// so a tile spans at most 32 rows. shard: the row range's index, 0 for the
// dense table (0 <= shard * stride < 2^31 for every lag). stream: a
// cudaStream_t. Returns
// cudaErrorInvalidValue for arguments the kernel does not take, else
// cudaGetLastError() after the launch (0 on success). Does not synchronise.
extern "C" int count_chunk_launch(void* table, int64_t n_table,
                                  const void* codes, const void* meta,
                                  int64_t n_rows, int64_t row_len,
                                  int64_t tile, int64_t shard,
                                  const CountLags* lags, void* stream) {
  const int64_t P = row_len + 1;
  if (n_rows < 0 || row_len < 0 || row_len > (1 << 30) || lags == nullptr ||
      !lags_ok(*lags) || tile < 1 || tile > kTile || shard < 0 ||
      shard > 0x7fffffff || n_table > 0x7fffffff ||
      tile > (kMaxRows - 1) * P ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(meta) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_pos = n_rows * P;
  if (n_pos == 0) {
    return static_cast<int>(cudaSuccess);
  }
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const Shape sh{n_pos, P, n_rows * row_len, tile, static_cast<int>(row_len)};
  const int64_t n_tiles = (n_pos + tile - 1) / tile;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(n_tiles < cap ? n_tiles : cap);
  count_chunk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(table), n_table, static_cast<const signed char*>(codes),
      static_cast<const int4*>(meta), sh, n_tiles, shard, *lags);
  return static_cast<int>(cudaGetLastError());
}
