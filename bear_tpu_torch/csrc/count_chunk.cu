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
//   + code (below rows(l) < 2^31) and its local row rloc = grow - shard *
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
//   - a persistent grid of `blocks` blocks walks the flattened [B, L+1]
//     position grid in tiles of up to 2,048 positions. A tile's codes are one
//     contiguous byte range of `codes` plus a max_lag-byte halo in front;
//     that range (16-byte aligned, zero-filled outside the array) and the
//     tile's meta rows are staged in shared memory with cp.async,
//     double-buffered, so the next tile's copy overlaps this tile's atomics.
//     No TMA: its 2-D maps need 16-byte row strides, which L = 150 lacks, and
//     one range is 1-D anyway.
//   - a thread takes a run of `run` consecutive positions (1..8) and one of
//     `groups` lag groups (1, 2, 4 or 8; group g counts lags g, g + groups,
//     ...). The 256 threads of a block are `groups` slices of 256 / groups
//     threads, one slice per lag group, so a warp's threads share their lags;
//     a tile holds (256 / groups) * run positions. The launch shape comes from
//     the chunk (count_chunk.py's launch_shape): the main path's large
//     one-lag chunk takes runs of 8 and one group (tiles of 2,048, ~1,200 of
//     them); summarize's and the row-range passes' 1,024 x 192 chunk over 13
//     to 15 lags takes runs of 4 and 4 groups (tiles of 256), so that 772
//     tiles fill 4 blocks on each of 132 SMs (97 tiles of 2,048 would leave
//     35 SMs idle and each thread keying 120 (position, lag) pairs in
//     series). There the launch is bound by neither bytes nor atomics: one
//     that keys nothing takes 0.015 of the row-range form's 0.023 ms (NVIDIA
//     H100 80GB HBM3, 700 W; count_chunk_timing.py --ablation, PERF.md).
//   - a thread first walks its run: it builds the base-A code of the max_lag
//     context of its first position from shared memory, then rolls it:
//     code(j+1) = s[j] + A*(code(j) - s[j-M]*A^(M-1)), resetting it to 0 at a
//     row start, and keeps each position's code, next symbol, group and
//     flags in registers. Then, for each of its lags, it reads the lag's
//     constants once and keys the run. The lag-l code is its low l digits:
//     a mask where A is a power of two (DNA, RNA), code mod A^l otherwise.
//     The pad offset is a register but for the first l positions of a row.
//     In the row-range form the local row is compared first: a key of
//     another pass costs the mask, an add and that compare. No key is
//     written to memory; masked positions are simply skipped.

#include <cstdint>
#include <cuda_runtime.h>

#include "hist_add.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRun = 8;                 // most consecutive positions a thread takes
constexpr int kMaxGroups = 8;              // most lag groups (256 / 8 = one warp each)
constexpr int kTile = kThreads * kMaxRun;  // most positions of a tile
constexpr int kMaxRows = 32;               // most rows a tile spans
constexpr int kMaxLags = 16;
constexpr int kMaxLag = 15;                // 4^16 exceeds int32 context codes
constexpr int kCodeBytes = 2112;           // >= kTile + kMaxLag + 2 * 15, 16-aligned
constexpr int kMinBlocksPerSm = 4;         // register cap: 4 blocks of 256 fit an SM
constexpr int kStopped = 1;                // meta flag bits
constexpr int kFresh = 2;
constexpr uint32_t kLive = 1;              // per-position info bits: live, then
constexpr int kLimShift = 1;               // the largest lag it counts (5 bits),
constexpr int kJShift = 6;                 // then min(j, 31)

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
  int32_t a_shift;            // log2(A) where A is a power of two, else 0 (use %)
  CountLag lag[kMaxLags];
};

namespace {

struct __align__(16) Stage {
  signed char codes[kCodeBytes];
  int4 meta[kMaxRows];        // length, skip, group, flags
};

// Positions [f0, f1) of the flattened grid (n = f1 - f0 of them), the first
// row b0 and position j0 in it, and the first staged code byte lo
// (16-aligned, may be negative: zero-filled). A tile is computed once per
// tile and thread: within it rows and positions follow in 32 bits.
struct Tile {
  int64_t f0, b0, lo;
  int n, j0;
};

struct Shape {
  int64_t n_pos, P, n_bytes, tile;
  int L;
  int run;                    // positions per thread
  int groups;                 // lag groups per tile
};

__device__ __forceinline__ Tile tile_at(int64_t t, const Shape& sh, int max_lag) {
  Tile g;
  g.f0 = t * sh.tile;
  g.n = static_cast<int>(g.f0 + sh.tile < sh.n_pos ? sh.tile : sh.n_pos - g.f0);
  g.b0 = g.f0 / sh.P;
  g.j0 = static_cast<int>(g.f0 - g.b0 * sh.P);
  g.lo = (g.b0 * sh.L + g.j0 - max_lag) & ~int64_t{15};
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
  const int P = static_cast<int>(sh.P);
  const int db1 = (g.j0 + g.n - 1) / P;  // the last row, after b0
  const int64_t end = (g.b0 + db1) * sh.L + (g.j0 + g.n - 1 - db1 * P) + 1;
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
  const int rows = db1 + 1;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    cp_async16(&s.meta[r], meta + g.b0 + r, 16);
  }
}

// Count this thread's run of positions of the staged tile g, at the lags of
// its lag group.
__device__ void count_run(const Stage& s, const Tile& g, const Shape& sh,
                          const CountLags& lags, int64_t shard,
                          int* __restrict__ table, int64_t n_table) {
  const int slice = kThreads / sh.groups;  // threads of one lag group
  const int lag_group = threadIdx.x / slice;
  const int first = (threadIdx.x - lag_group * slice) * sh.run;  // in the tile
  if (first >= g.n) {
    return;
  }
  const int n_run = g.n - first < sh.run ? g.n - first : sh.run;
  const uint32_t A = static_cast<uint32_t>(lags.A);
  const int M = lags.max_lag;
  const int L = sh.L;
  const int P = static_cast<int>(sh.P);
  int row = (g.j0 + first) / P;  // rows after b0; s.meta[row] is its meta
  int j = g.j0 + first - row * P;
  // s.codes[base + x] is codes[b0 + row, x]; read only for 0 <= x < L.
  int base = static_cast<int>(g.b0 * L - g.lo) + row * L;
  auto digit = [&](int x) -> uint32_t {
    return x >= 0 ? static_cast<uint32_t>(static_cast<int>(s.codes[base + x]))
                  : 0u;
  };

  // 1. The run: each position's context code, next symbol, group and info.
  uint32_t code = 0;  // base-A code of the M previous symbols, digit 1 lowest
  for (int i = M; i >= 1; --i) {
    code = code * A + digit(j - i);
  }
  int4 m = s.meta[row];
  uint32_t cd[kMaxRun], nx[kMaxRun], info[kMaxRun];
  int32_t grp[kMaxRun];
#pragma unroll
  for (int r = 0; r < kMaxRun; ++r) {
    info[r] = 0;
    cd[r] = 0;
    nx[r] = 0;
    grp[r] = 0;
    if (r < n_run) {
      if (j == L + 1) {  // next row: nothing precedes its start
        ++row;
        j = 0;
        code = 0;
        base += L;
        m = s.meta[row];
      }
      const int length = m.x;
      if (j >= m.y && (j < length || (j == length && (m.w & kStopped)))) {
        const uint32_t jc = j < 31 ? static_cast<uint32_t>(j) : 31u;
        // A row that is not fresh drops lag l at j < l: it counts lags <= j.
        const uint32_t lim = (m.w & kFresh) ? 31u : jc;
        info[r] = kLive | (lim << kLimShift) | (jc << kJShift);
        nx[r] = j < length ? (j < L ? digit(j) : 0u) : A;
        grp[r] = m.z;
        cd[r] = code;
      }
      if (j < L) {
        code = digit(j) + A * (code - (j >= M ? digit(j - M) : 0u) * lags.top_power);
      }
      ++j;
    }
  }

  // 2. Each lag of the group over the run, its constants read once.
  const uint32_t A1 = A + 1;
  for (int k = lag_group; k < lags.n_lags; k += sh.groups) {
    const CountLag& lg = lags.lag[k];
    const uint32_t lag = static_cast<uint32_t>(lg.lag);
    // The low `lag` digits of the code: all of it at the largest lag, a
    // mask for a power-of-two A, else the remainder.
    const bool use_mod = lags.a_shift == 0 && lg.lag != M;
    const uint32_t keep = lg.lag == M ? ~0u : lg.modulus - 1u;
    const uint32_t modulus = lg.modulus;
    // rloc = pad + code - shard * stride, exact in 32 bits (all three lie in
    // [0, 2^31)), compared as unsigned so a negative one is dropped too.
    const uint32_t first_row = static_cast<uint32_t>(shard) * static_cast<uint32_t>(lg.stride);
    const uint32_t lo0 = static_cast<uint32_t>(lg.pad[0]) - first_row;
    const uint32_t local_rows = static_cast<uint32_t>(lg.local_rows);
    const int64_t offset = lg.offset;
    const int64_t lrows = lg.local_rows;
#pragma unroll
    for (int r = 0; r < kMaxRun; ++r) {
      const uint32_t inf = info[r];
      if (!(inf & kLive) || lag > ((inf >> kLimShift) & 31u)) {
        continue;  // not counted, or a non-fresh row's j < lag
      }
      const uint32_t c = use_mod ? cd[r] % modulus : cd[r] & keep;
      const uint32_t jc = inf >> kJShift;
      const uint32_t rloc =
          c + (jc >= lag ? lo0 : static_cast<uint32_t>(lg.pad[lag - jc]) - first_row);
      if (rloc >= local_rows) {
        continue;  // another row range's row
      }
      const int64_t key = offset + (static_cast<int64_t>(grp[r]) * lrows + rloc) * A1 + nx[r];
      if (key >= 0 && key < n_table) {  // int32 once in range
        hist_add(table, static_cast<int>(key), n_table);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
count_chunk_kernel(int* __restrict__ table, int64_t n_table,
                   const signed char* __restrict__ codes,
                   const int4* __restrict__ meta, Shape sh, int64_t n_tiles,
                   int64_t shard, const __grid_constant__ CountLags lags) {
  __shared__ Stage stage[2];
  // The lag table: its pad entries are indexed per thread (lag k, n_pad); in
  // shared memory those reads neither serialise as divergent constant reads
  // nor force a per-thread copy of the parameter.
  __shared__ CountLags s_lags;
  int64_t t = blockIdx.x;
  Tile here = tile_at(t, sh, lags.max_lag);
  if (t < n_tiles) {
    stage_tile(stage[0], here, sh, codes, meta);
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
    const Tile next = tile_at(t_next, sh, lags.max_lag);
    if (t_next < n_tiles) {
      stage_tile(stage[cur ^ 1], next, sh, codes, meta);
    }
    cp_async_commit();  // possibly empty: keeps one group per tile
    cp_async_wait_all_but_last();
    __syncthreads();
    count_run(stage[cur], here, sh, s_lags, shard, table, n_table);
    __syncthreads();  // stage[cur] is refilled in the next iteration
    here = next;
  }
}

bool lags_ok(const CountLags& lags) {
  if (lags.n_lags < 1 || lags.n_lags > kMaxLags || lags.max_lag < 1 ||
      lags.max_lag > kMaxLag || lags.A < 2 ||
      lags.lag[lags.n_lags - 1].lag != lags.max_lag ||
      (lags.a_shift != 0 && (lags.a_shift > 30 || (1 << lags.a_shift) != lags.A))) {
    return false;
  }
  for (int k = 0; k < lags.n_lags; ++k) {
    const CountLag& lg = lags.lag[k];
    if (lg.lag < 1 || (k > 0 && lg.lag <= lags.lag[k - 1].lag) || lg.modulus == 0 ||
        lg.rows < 1 || lg.stride < 1 || lg.local_rows < 1 || lg.offset < 0) {
      return false;
    }
  }
  return true;
}

bool shape_ok(int64_t tile, int64_t run, int64_t groups, int64_t blocks, int64_t P,
              int n_lags) {
  return run >= 1 && run <= kMaxRun &&
         (groups == 1 || groups == 2 || groups == 4 || groups == kMaxGroups) &&
         groups <= n_lags && tile >= 1 && tile <= (kThreads / groups) * run &&
         tile <= (kMaxRows - 1) * P && blocks >= 1 && blocks <= 0x7fffffff;
}

}  // namespace

// table: int32 [n_table]; codes: int8 [n_rows, row_len], contiguous, 16-byte
// aligned; meta: int32 [n_rows, 4] (length, skip, group, flags: bit 0
// stopped, bit 1 fresh), contiguous, 16-byte aligned; all on the current
// device. The launch shape (count_chunk.py's launch_shape): tile positions
// per tile, at most (256 / groups) * run and 31 * (row_len + 1), so a tile
// spans at most 32 rows; run, 1..8 positions per thread; groups, 1, 2, 4 or
// 8 lag groups, at most n_lags; blocks, the persistent grid. shard: the row
// range's index, 0 for the dense table (0 <= shard * stride < 2^31 for
// every lag). stream: a cudaStream_t. Returns cudaErrorInvalidValue for
// arguments the kernel does not take, else cudaGetLastError() after the
// launch (0 on success). Does not synchronise.
extern "C" int count_chunk_launch(void* table, int64_t n_table,
                                  const void* codes, const void* meta,
                                  int64_t n_rows, int64_t row_len,
                                  int64_t tile, int64_t run, int64_t groups,
                                  int64_t blocks, int64_t shard,
                                  const CountLags* lags, void* stream) {
  const int64_t P = row_len + 1;
  if (n_rows < 0 || row_len < 0 || row_len > (1 << 30) || lags == nullptr ||
      !lags_ok(*lags) || !shape_ok(tile, run, groups, blocks, P, lags->n_lags) ||
      shard < 0 || shard > 0x7fffffff || n_table > 0x7fffffff ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(meta) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < lags->n_lags; ++k) {
    if (shard * lags->lag[k].stride > 0x7fffffff) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int64_t n_pos = n_rows * P;
  if (n_pos == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const Shape sh{n_pos, P, n_rows * row_len, tile, static_cast<int>(row_len),
                 static_cast<int>(run), static_cast<int>(groups)};
  const int64_t n_tiles = (n_pos + tile - 1) / tile;
  count_chunk_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(table), n_table, static_cast<const signed char*>(codes),
      static_cast<const int4*>(meta), sh, n_tiles, shard, *lags);
  return static_cast<int>(cudaGetLastError());
}
