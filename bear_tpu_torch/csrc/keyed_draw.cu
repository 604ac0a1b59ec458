// Keyed Dirichlet draws for posterior-sampled serving and assembly: for
// every (sample s, element e), the row key, its Philox words, the
// log-Gamma draws of the element's A1 concentrations and either the
// log-prob of one chosen category or the whole unnormalised row.
//
// Replaces, as one kernel, what bear_tpu runs as jitted XLA (no Pallas
// kernel is involved): bear_tpu/ops/loggamma.py:144-209
// (log_dirichlet_draw_keyed(_t)) and bear_tpu/inference/serving.py:41-60
// (_sampled_logp_picked). Its plain PyTorch version is keyed_draw_plain in
// bear_tpu_torch/ops/keyed_draw.py (fold_in, stream_words, Box-Muller,
// Marsaglia-Tsang and the pick as separate tensor passes); this kernel
// computes the same function, op for op, with every word and every float
// in registers or shared memory.
//
// The draw of (s, e):
//   1. k = fold_in(base_keys[s, group[e]], rows[e]): the first two words of
//      the Philox4x32-10 block with counter (row low, row high, FOLD, 0);
//   2. under k, the words of the NORMAL, EXPONENTIAL and BOOST streams: word
//      j of a stream is lane j % 4 of the block with counter
//      (0, 0, stream, j / 4); normal n comes from the Box-Muller pair of
//      words (n & ~1, n | 1), cosine for even n, sine for odd;
//   3. per category a, the Marsaglia-Tsang proposals f = 0, 1, ... with
//      normal f*A1 + a and exponential f*A1 + a, up to the first accepted
//      one (the plain version computes all F and selects the first, the
//      same value), else the clamped last cube; minus boost / safe; -inf
//      where the concentration is 0;
//   4. picked: lg[nxt[e]] - logsumexp(lg) into out[s, e], or full: the row
//      lg into out[s, e, :].
//
// What bounds it: the SM's instruction issue, not bytes. A draw of A1 = 5
// categories reads ~20 bytes of its element (shared by the S samples) and
// writes 4; it runs 7 Philox blocks (20 32-bit multiplies each, on the
// half-rate IMAD pipe) and ~35 accurate library routines (log, sqrt,
// sincos, exp, IEEE division: tens of instructions each; the build has no
// fast math). chip_smoke.sampler_work_per_draw counts it by unit, from the
// routines' SASS. What the design does about it:
//   - samples inside the thread: a thread owns one element and a tile of
//     samples (ops/keyed_draw.py launch_shape: elements along x in blocks of
//     128, sample tiles along y). The element's concentrations are read and
//     its safe, cc = 1/sqrt(9d) and log(d) computed once per tile, not once
//     per draw (d = safe + 2/3 is one add, redone where it is used);
//   - eager Philox: the key's 10 round keys are computed once per draw and
//     shared by its stream blocks; the first proposals' NORMAL, EXPONENTIAL
//     and BOOST blocks are drawn a category quad at a time, three
//     independent blocks in flight; every word of a block is used, and the
//     last quad's normal and exponential blocks stay in registers, since
//     they are the only drawn blocks a retry (n >= A1) can fall in;
//   - one sincos per Box-Muller pair (the same range reduction as sin and
//     cos apart, the same bits), cos alone for a pair whose sine is unused;
//     log(vs) of the accept test is log(v_fin) when it accepts;
//   - deferred, compacted rejections: every category's first proposal is
//     evaluated without a branch, leaving a reject mask (~4% of categories
//     reject, so ~18% of draws and nearly every warp hold one). A retry is
//     a serial chain of library calls; run in place, each warp paid for
//     its worst lane once per sample (up to 47% of the kernel's time at
//     (C)'s draw input on an H100: keyed_draw_timing.py --ablation, every
//     first proposal taken). Instead the
//     rows of a sub-tile of samples wait in shared memory and each rejected
//     (sample, category) joins its warp's queue with its key, kept blocks
//     and constants; a full queue, and the rest after the sub-tile, is
//     retried one item a lane and one proposal a round (proposals 1..F-1,
//     then the clamped last cube), a decided item's value written into its
//     owner's row, an undecided one kept for the next round. A zero
//     concentration is never retried (its value is -inf whatever the draw);
//   - A1 = 5 (DNA, the main path) is a compile-time instantiation: its
//     hoisted constants and its row during the first proposals and the
//     logsumexp stay in registers. Other A1 (up to 32; protein is 21) keep
//     the constants in shared memory, one column per thread. Full mode
//     stores the sub-tile's rows coalesced from shared memory;
//   - float64 caps registers at 128 (4 resident blocks an SM), float32
//     leaves them to the compiler: a lower cap spills and runs slower at
//     (C)'s input (keyed_draw_timing.py --ablation sweeps the cap).
//
// Rounding: each float operation is one IEEE rounding in the plain
// version's order; this source is compiled with -fmad=false (see
// bear_tpu_torch/_build.py) so that no multiply-add is contracted. The
// logsumexp sums in category order.
//
// Timing-only builds (never loaded by the wrapper; keyed_draw_timing.py
// --ablation): -DKEYED_DRAW_FORCE_ACCEPT takes every first proposal,
// -DKEYED_DRAW_NO_RETRY runs the accept test but no retry (a rejected
// category keeps its placeholder), -DKEYED_DRAW_WORDS_ONLY draws the Philox
// words alone, -DKEYED_DRAW_FAST_MATH uses __logf, __sincosf/__cosf and
// __expf in float32, and KEYED_DRAW_MIN_BLOCKS_F32/_F64 set the register
// caps. -DKEYED_DRAW_PROBES
// adds one small kernel per library routine, whose SASS gives the
// instruction counts of chip_smoke.sampler_work_per_draw.

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_A1 = 32;  // categories of a row (protein: 21)
constexpr int MAX_F = 64;   // Marsaglia-Tsang proposals
constexpr int DNA_A1 = 5;   // the compile-time row width
constexpr unsigned MAX_GRID_Y = 65535;
// Blocks of THREADS an SM keeps resident, which caps a thread's registers
// at 65,536 / (THREADS x blocks), for float and double (timing-only builds
// override them).
#ifndef KEYED_DRAW_MIN_BLOCKS_F32
#define KEYED_DRAW_MIN_BLOCKS_F32 1
#endif
#ifndef KEYED_DRAW_MIN_BLOCKS_F64
#define KEYED_DRAW_MIN_BLOCKS_F64 4
#endif
template <typename T>
constexpr int MIN_BLOCKS = sizeof(T) == 8 ? KEYED_DRAW_MIN_BLOCKS_F64 : KEYED_DRAW_MIN_BLOCKS_F32;

constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;  // Philox4x32 multipliers
constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;  // Weyl key increments
constexpr uint32_t FOLD = 0, NORMAL = 1, EXPONENTIAL = 2, BOOST = 3;
constexpr double TWO_PI = 6.283185307179586;  // Python's 2.0 * math.pi

struct Keys {  // a key's round keys
  uint32_t k0[10], k1[10];
};

__device__ __forceinline__ Keys schedule(uint32_t k0, uint32_t k1) {
  Keys k;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    k.k0[r] = k0;
    k.k1[r] = k1;
    k0 += W0;
    k1 += W1;
  }
  return k;
}

__device__ __forceinline__ uint4 philox(uint4 c, const Keys& k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.k0[r], lo1, hi0 ^ c.w ^ k.k1[r], lo0);
  }
  return c;
}

__device__ __forceinline__ uint4 block(uint32_t sid, uint32_t b, const Keys& k) {
  return philox(make_uint4(0, 0, sid, b), k);
}

__device__ __forceinline__ uint32_t word_of(const uint4& b, uint32_t i) {
  return i == 0 ? b.x : i == 1 ? b.y : i == 2 ? b.z : b.w;
}

// Uniforms in (0, 1): float keeps the top 23 bits, (w' + 1/2) 2^-23;
// double all 32, (w + 1/2) 2^-32 (keyed_random.uniform).
__device__ __forceinline__ float uniform(uint32_t w, float) {
  return (static_cast<float>(w >> 9) + 0.5f) * 0x1p-23f;
}
__device__ __forceinline__ double uniform(uint32_t w, double) {
  return (static_cast<double>(w) + 0.5) * 0x1p-32;
}

// The library routines: accurate, or the fast intrinsics in a timing-only
// build (float32 only; float64 has none).
#ifdef KEYED_DRAW_FAST_MATH
__device__ __forceinline__ float klog(float x) { return __logf(x); }
__device__ __forceinline__ float kexp(float x) { return __expf(x); }
__device__ __forceinline__ float kcos(float x) { return __cosf(x); }
__device__ __forceinline__ void ksincos(float x, float* s, float* c) { __sincosf(x, s, c); }
#else
__device__ __forceinline__ float klog(float x) { return logf(x); }
__device__ __forceinline__ float kexp(float x) { return expf(x); }
__device__ __forceinline__ float kcos(float x) { return cosf(x); }
__device__ __forceinline__ void ksincos(float x, float* s, float* c) { sincosf(x, s, c); }
#endif
__device__ __forceinline__ double klog(double x) { return log(x); }
__device__ __forceinline__ double kexp(double x) { return exp(x); }
__device__ __forceinline__ double kcos(double x) { return cos(x); }
__device__ __forceinline__ void ksincos(double x, double* s, double* c) { sincos(x, s, c); }

// Normals of one Box-Muller pair of words (w1, w2): c = r cos(theta) and,
// when `both`, s = r sin(theta) (keyed_random.normal).
template <typename T>
__device__ __forceinline__ void box_muller(uint32_t w1, uint32_t w2, bool both, T& c, T& s) {
  const T r = sqrt(T(-2.0) * klog(uniform(w1, T())));
  const T theta = T(TWO_PI) * uniform(w2, T());
  if (both) {
    T sn, cs;
    ksincos(theta, &sn, &cs);
    c = r * cs;
    s = r * sn;
  } else {
    c = r * kcos(theta);
  }
}

// A row of A1 values of one thread: registers when A1 is the compile-time
// NA (an index that is not constant after unrolling selects among them),
// else this thread's column of a [A1][THREADS] array in shared memory.
template <typename T, int NA>
struct Row {
  T v[NA];
  __device__ __forceinline__ T get(int a) const {
    T r = v[0];
#pragma unroll
    for (int i = 1; i < NA; ++i) r = a == i ? v[i] : r;
    return r;
  }
  __device__ __forceinline__ void set(int a, T x) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      if (a == i) v[i] = x;
    }
  }
};

template <typename T>
struct Row<T, 0> {
  T* p;
  __device__ __forceinline__ T get(int a) const { return p[a * THREADS]; }
  __device__ __forceinline__ void set(int a, T x) { p[a * THREADS] = x; }
};

// An element's constants, computed once per sample tile.
template <typename T, int NA>
struct Element {
  Row<T, NA> safe, cc, logd;
  uint32_t cpos;  // bit a: concentration a > 0
};

// One Marsaglia-Tsang proposal of a category: (accepted, v, log vs).
template <typename T>
__device__ __forceinline__ bool propose(T x, T log_u, T d, T cc, T& v, T& lv) {
  const T t = T(1) + cc * x;
  v = t * t * t;
  const bool pos = v > T(0);
  const T vs = pos ? v : T(1);
  lv = klog(vs);
  return pos && log_u < T(0.5) * x * x + d - d * vs + d * lv;
}

// The first proposals of the draw under key (k0, k1), a category quad at
// a time, into lg: the draw where the first proposal accepts, else the
// category's boost / safe until its retry. Returns the mask of rejected
// categories (never one of zero concentration: its value is -inf whatever
// the draw); nkept, ekept: the last quad's NORMAL and EXPONENTIAL blocks.
template <typename T, int NA>
__device__ __forceinline__ uint32_t first_proposals(uint32_t k0, uint32_t k1, int A1,
                                                    const Element<T, NA>& el, Row<T, NA>& lg,
                                                    uint4& nkept, uint4& ekept) {
  const Keys keys = schedule(k0, k1);
  uint32_t rej = 0;
#pragma unroll
  for (int q = 0; q < (NA > 0 ? (NA + 3) / 4 : (A1 + 3) / 4); ++q) {
    const uint4 nb = block(NORMAL, q, keys), eb = block(EXPONENTIAL, q, keys),
                bb = block(BOOST, q, keys);
    nkept = nb;
    ekept = eb;
    const int a0 = 4 * q;
#ifdef KEYED_DRAW_WORDS_ONLY
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t w = word_of(nb, j) ^ word_of(eb, j) ^ word_of(bb, j);
      if (a0 + j < A1) lg.set(a0 + j, T(w >> 9));
    }
    continue;
#endif
    T x[4];
    box_muller(nb.x, nb.y, a0 + 1 < A1, x[0], x[1]);
    if (a0 + 2 < A1) box_muller(nb.z, nb.w, a0 + 3 < A1, x[2], x[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = a0 + j;
      if (a < A1) {
        const T safe = el.safe.get(a);
        const T d = safe + T(1.0 - 1.0 / 3.0);
        T v, lv;
        bool acc = propose(x[j], klog(uniform(word_of(eb, j), T())), d, el.cc.get(a), v, lv);
#ifdef KEYED_DRAW_FORCE_ACCEPT
        acc = true;
#endif
        const T bq = -klog(uniform(word_of(bb, j), T())) / safe;
        lg.set(a, acc ? (el.logd.get(a) + lv) - bq : bq);
        if (!acc && ((el.cpos >> a) & 1u)) rej |= 1u << a;
      }
    }
  }
#ifdef KEYED_DRAW_NO_RETRY
  rej = 0;
#endif
  return rej;
}

// Proposal f of rejected category a of the draw under (k0, k1), with
// F = 1 proposal 0 again: log v_fin into lv and true if it accepts or is
// the last (then the clamped cube); false: proposal f + 1 is next. Words
// come from the kept last-quad blocks or from a newly drawn block.
template <typename T>
__device__ __forceinline__ bool retry(uint32_t k0, uint32_t k1, int a, int f, int A1, int F,
                                      T safe, T cc, uint4 nwords, uint4 ewords, T& lv) {
  const uint32_t kept = (A1 + 3) / 4 - 1;
  const uint32_t n = static_cast<uint32_t>(f * A1 + a);
  if ((n >> 2) != kept) {
    const Keys keys = schedule(k0, k1);
    nwords = block(NORMAL, n >> 2, keys);
    ewords = block(EXPONENTIAL, n >> 2, keys);
  }
  T xc, xs, v;
  box_muller(word_of(nwords, n & 2u), word_of(nwords, (n & 2u) | 1u), true, xc, xs);
  if (propose((n & 1u) ? xs : xc, klog(uniform(word_of(ewords, n & 3u), T())),
              safe + T(1.0 - 1.0 / 3.0), cc, v, lv)) {
    return true;
  }
  if (f + 1 < F) return false;
  lv = klog(v < T(1e-3) ? T(1e-3) : v);
  return true;
}

// lg[k] - logsumexp(lg), as torch.logsumexp: max (0 if infinite), sum of
// exp in category order, log, + max.
template <typename T, int NA>
__device__ __forceinline__ T picked(const Row<T, NA>& lg, int A1, int k) {
#ifdef KEYED_DRAW_WORDS_ONLY
  return lg.get(k);
#endif
  T m = lg.get(0);
#pragma unroll
  for (int a = 1; a < (NA > 0 ? NA : A1); ++a) m = fmax(m, lg.get(a));
  if (isinf(m)) m = T(0);
  T sum = T(0);
#pragma unroll
  for (int a = 0; a < (NA > 0 ? NA : A1); ++a) sum = sum + kexp(lg.get(a) - m);
  return lg.get(k) - (klog(sum) + m);
}

// One warp's rejected proposals, waiting for a retry: QUEUE items, each
// the owner's key, kept blocks and category constants, and where it stands
// (owner lane | sample in the sub-tile << 8 | category << 16 | proposal
// << 24).
constexpr int WARP = 32;
constexpr int QUEUE = 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

template <typename T>
struct Queue {
  uint32_t k0[QUEUE], k1[QUEUE], at[QUEUE], nw[4][QUEUE], ew[4][QUEUE];
  T safe[QUEUE], cc[QUEUE], logd[QUEUE];
};

// Samples whose rows wait in shared memory for their retries: as many as
// ROWS_BYTES hold, 1..MAX_SUB (16 for A1 = 5 in float32, 8 in float64).
constexpr int ROWS_BYTES = 40960;
constexpr int MAX_SUB = 16;

template <typename T>
__host__ __device__ constexpr int sub_tile(int A1) {
  return ROWS_BYTES / (A1 * THREADS * static_cast<int>(sizeof(T))) < 1 ? 1
         : ROWS_BYTES / (A1 * THREADS * static_cast<int>(sizeof(T))) > MAX_SUB
             ? MAX_SUB
             : ROWS_BYTES / (A1 * THREADS * static_cast<int>(sizeof(T)));
}

// Shared memory: for NA = 0 the element's safe, cc and log d as
// [A1][THREADS] each; the sub-tile's rows [sub][A1][THREADS]; a Queue a warp.
template <typename T, int NA>
__host__ __device__ constexpr size_t smem_bytes(int A1) {
  return sizeof(T) * THREADS * A1 * ((NA > 0 ? 0 : 3) + sub_tile<T>(A1)) +
         sizeof(Queue<T>) * (THREADS / WARP);
}

// One proposal of each waiting item, one item a lane: a decided item's
// result goes into its owner's row slot, which held boost / safe; the
// undecided ones move to the front of the queue with their next proposal.
// Returns how many wait.
template <typename T>
__device__ __forceinline__ int retry_round(Queue<T>& q, int n, T* rows, int A1, int F,
                                           int lane, int warp) {
  __syncwarp();
  bool waits = false;
  uint32_t k0 = 0, k1 = 0, at = 0;
  uint4 nw = make_uint4(0, 0, 0, 0), ew = nw;
  T safe = T(0), cc = T(0), logd = T(0);
  if (lane < n) {
    k0 = q.k0[lane], k1 = q.k1[lane], at = q.at[lane];
    nw = make_uint4(q.nw[0][lane], q.nw[1][lane], q.nw[2][lane], q.nw[3][lane]);
    ew = make_uint4(q.ew[0][lane], q.ew[1][lane], q.ew[2][lane], q.ew[3][lane]);
    safe = q.safe[lane], cc = q.cc[lane], logd = q.logd[lane];
    const int a = (at >> 16) & 0xFF;
    T lv;
    if (retry(k0, k1, a, static_cast<int>(at >> 24), A1, F, safe, cc, nw, ew, lv)) {
      T* slot = rows + (((at >> 8) & 0xFF) * A1 + a) * THREADS + warp * WARP + (at & 0xFF);
      *slot = (logd + lv) - *slot;
    } else {
      waits = true;
      at += 1u << 24;
    }
  }
  const unsigned wait = __ballot_sync(FULL, waits);
  __syncwarp();  // every item read before the waiting ones move
  if (waits) {
    const int to = __popc(wait & ((1u << lane) - 1));
    q.k0[to] = k0, q.k1[to] = k1, q.at[to] = at;
    q.nw[0][to] = nw.x, q.nw[1][to] = nw.y, q.nw[2][to] = nw.z, q.nw[3][to] = nw.w;
    q.ew[0][to] = ew.x, q.ew[1][to] = ew.y, q.ew[2][to] = ew.z, q.ew[3][to] = ew.w;
    q.safe[to] = safe, q.cc[to] = cc, q.logd[to] = logd;
  }
  __syncwarp();
  return __popc(wait);
}

// Add this lane's rejected categories `rej` of sample i to its warp's
// queue (n items so far; warp-uniform), retrying a full queue.
template <typename T, int NA>
__device__ __forceinline__ void enqueue(Queue<T>& q, int& n, uint32_t rej, int i, uint32_t k0,
                                        uint32_t k1, const uint4& nkept, const uint4& ekept,
                                        const Element<T, NA>& el, T* rows, int A1, int F,
                                        int lane, int warp) {
  for (;;) {
    const int cnt = __popc(rej);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < WARP; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    const int total = __shfl_sync(FULL, incl, WARP - 1);
    if (total == 0) return;
    for (int at = n + incl - cnt; rej && at < QUEUE; ++at) {
      const int a = __ffs(rej) - 1;
      rej &= rej - 1;
      q.k0[at] = k0;
      q.k1[at] = k1;
      q.at[at] = static_cast<uint32_t>(lane | (i << 8) | (a << 16) | ((F > 1 ? 1 : 0) << 24));
      q.nw[0][at] = nkept.x, q.nw[1][at] = nkept.y, q.nw[2][at] = nkept.z, q.nw[3][at] = nkept.w;
      q.ew[0][at] = ekept.x, q.ew[1][at] = ekept.y, q.ew[2][at] = ekept.z, q.ew[3][at] = ekept.w;
      q.safe[at] = el.safe.get(a);
      q.cc[at] = el.cc.get(a);
      q.logd[at] = el.logd.get(a);
    }
    n = n + total < QUEUE ? n + total : QUEUE;
    if (n < QUEUE) return;
    n = retry_round(q, n, rows, A1, F, lane, warp);
  }
}

template <typename T, int NA, bool PICKED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<T>)
keyed_draw_kernel(const int64_t* __restrict__ base_keys, int64_t n_groups,
                  const int64_t* __restrict__ group, const int64_t* __restrict__ rows,
                  const T* __restrict__ conc, const int32_t* __restrict__ nxt,
                  T* __restrict__ out, int64_t S, int64_t E, int A1_rt, int F, int64_t tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const shared = reinterpret_cast<T*>(smem);
  const int A1 = NA > 0 ? NA : A1_rt;
  const int sub = sub_tile<T>(A1);
  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * THREADS;
  const int64_t e = e0 + threadIdx.x;
  T* const rows_s = shared + (NA > 0 ? 0 : 3 * A1 * THREADS);  // [sub][A1][THREADS]
  Queue<T>& queue = reinterpret_cast<Queue<T>*>(rows_s + sub * A1 * THREADS)[warp];

  // The element: its indices, then its constants, once for the sample tile.
  int64_t g = 0;
  uint64_t row = 0;
  int k = 0;
  bool valid = false;
  if (e < E) {
    g = group[e];
    row = static_cast<uint64_t>(rows[e]);
    k = PICKED ? nxt[e] : 0;
    valid = g >= 0 && g < n_groups && k >= 0 && k < A1;
  }
  Element<T, NA> el;
  Row<T, NA> lg;
  if constexpr (NA == 0) {
    T* col = shared + threadIdx.x;
    el.safe.p = col;
    el.cc.p = col + A1 * THREADS;
    el.logd.p = col + 2 * A1 * THREADS;
  }
  el.cpos = 0;
  if (valid) {  // an invalid index draws nothing: NaN, never a stray read
    const T* c_row = conc + e * A1;
#pragma unroll
    for (int a = 0; a < (NA > 0 ? NA : A1); ++a) {
      const T c = c_row[a];
      const T safe = c < T(1e-30) ? T(1e-30) : c;
      const T d = safe + T(1.0 - 1.0 / 3.0);
      el.safe.set(a, safe);
      el.cc.set(a, T(1) / sqrt(T(9) * d));
      el.logd.set(a, klog(d));
      if (c > T(0)) el.cpos |= 1u << a;
    }
  }

  for (int64_t t = blockIdx.y; t * tile < S; t += gridDim.y) {
    const int64_t t_end = (t + 1) * tile < S ? (t + 1) * tile : S;
    for (int64_t s0 = t * tile; s0 < t_end; s0 += sub) {
      const int ns = t_end - s0 < sub ? static_cast<int>(t_end - s0) : sub;
      // First proposals of the sub-tile's samples, rows into shared memory;
      // the rejected ones queue up across the warp and its samples.
      int n = 0;
      for (int i = 0; i < ns; ++i) {
        T* row_i = rows_s + i * A1 * THREADS + threadIdx.x;
        if constexpr (NA == 0) lg.p = row_i;
        uint32_t rej = 0, k0 = 0, k1 = 0;
        uint4 nkept = make_uint4(0, 0, 0, 0), ekept = nkept;
        if (valid) {
          const uint64_t base = static_cast<uint64_t>(base_keys[(s0 + i) * n_groups + g]);
          const uint4 key = philox(make_uint4(static_cast<uint32_t>(row),
                                              static_cast<uint32_t>(row >> 32), FOLD, 0),
                                   schedule(static_cast<uint32_t>(base),
                                            static_cast<uint32_t>(base >> 32)));
          k0 = key.x;
          k1 = key.y;
          rej = first_proposals(k0, k1, A1, el, lg, nkept, ekept);
          if constexpr (NA > 0) {
#pragma unroll
            for (int a = 0; a < NA; ++a) row_i[a * THREADS] = lg.v[a];
          }
        }
        enqueue(queue, n, rej, i, k0, k1, nkept, ekept, el, rows_s, A1, F, lane, warp);
      }
      while (n) n = retry_round(queue, n, rows_s, A1, F, lane, warp);

      // The sub-tile's rows, final: -inf for a zero concentration, then
      // the pick, or NaN for an invalid index.
      for (int i = 0; i < ns; ++i) {
        T* row_i = rows_s + i * A1 * THREADS + threadIdx.x;
        if constexpr (NA > 0) {
#pragma unroll
          for (int a = 0; a < NA; ++a) lg.v[a] = row_i[a * THREADS];
        } else {
          lg.p = row_i;
        }
#pragma unroll
        for (int a = 0; a < (NA > 0 ? NA : A1); ++a) {
          if (!((el.cpos >> a) & 1u)) lg.set(a, T(-INFINITY));
          if (!valid) lg.set(a, T(NAN));
        }
        if constexpr (PICKED) {
          if (e < E) out[(s0 + i) * E + e] = valid ? picked(lg, A1, k) : T(NAN);
        } else if constexpr (NA > 0) {
#pragma unroll
          for (int a = 0; a < NA; ++a) row_i[a * THREADS] = lg.v[a];
        }
      }
      if constexpr (!PICKED) {  // coalesced store of the block's rows [e0, e0 + m) x A1
        __syncthreads();
        const int m = E - e0 < THREADS ? static_cast<int>(E - e0) : THREADS;
        for (int i = 0; i < ns; ++i) {
          T* dst = out + ((s0 + i) * E + e0) * A1;
          const T* src = rows_s + i * A1 * THREADS;
          for (int x = threadIdx.x; x < m * A1; x += THREADS) {
            dst[x] = src[(x % A1) * THREADS + x / A1];
          }
        }
      }
      __syncthreads();  // the rows and queues are rewritten by the next sub-tile
    }
  }
}

template <typename T, int NA, bool PICKED>
cudaError_t launch(const int64_t* base_keys, int64_t n_groups, const int64_t* group,
                   const int64_t* rows, const void* conc, const int32_t* nxt, void* out,
                   int64_t S, int64_t E, int A1, int F, int64_t tile, unsigned grid_x,
                   unsigned grid_y, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, NA>(A1);
  auto kernel = keyed_draw_kernel<T, NA, PICKED>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(grid_x, grid_y), THREADS, smem, stream>>>(
      base_keys, n_groups, group, rows, static_cast<const T*>(conc), nxt,
      static_cast<T*>(out), S, E, A1, F, tile);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const int64_t* k, int64_t n_groups, const int64_t* g,
                         const int64_t* r, const void* conc, const int32_t* p, void* out,
                         int64_t S, int64_t E, int A1, int F, int64_t tile, unsigned gx,
                         unsigned gy, cudaStream_t st) {
  if (A1 == DNA_A1) {
    return p ? launch<T, DNA_A1, true>(k, n_groups, g, r, conc, p, out, S, E, A1, F, tile, gx,
                                       gy, st)
             : launch<T, DNA_A1, false>(k, n_groups, g, r, conc, p, out, S, E, A1, F, tile, gx,
                                        gy, st);
  }
  return p ? launch<T, 0, true>(k, n_groups, g, r, conc, p, out, S, E, A1, F, tile, gx, gy, st)
           : launch<T, 0, false>(k, n_groups, g, r, conc, p, out, S, E, A1, F, tile, gx, gy, st);
}

}  // namespace

// base_keys int64 [S, n_groups]; group, rows int64 [E]; conc [E, A1] of
// float (itemsize 4) or double (8); nxt int32 [E] for the picked mode
// (out [S, E]), or null for the full mode (out [S, E, A1]). All contiguous
// on one card; launched on `stream` as grid (grid_x, grid_y) of 128-thread
// blocks, grid_x covering E and each y taking tiles of `tile` samples
// (ops/keyed_draw.py launch_shape). Returns a cudaError_t (0: launched).
extern "C" int keyed_draw_launch(const void* base_keys, int64_t n_groups, const void* group,
                                 const void* rows, const void* conc, const void* nxt,
                                 void* out, int64_t S, int64_t E, int32_t A1, int32_t F,
                                 int32_t itemsize, int64_t tile, int32_t grid_x,
                                 int32_t grid_y, void* stream) {
  if (S < 1 || E < 1 || n_groups < 1 || A1 < 1 || A1 > MAX_A1 || F < 1 || F > MAX_F ||
      (itemsize != 4 && itemsize != 8) || tile < 1 || grid_x < 1 || grid_y < 1 ||
      static_cast<unsigned>(grid_y) > MAX_GRID_Y ||
      static_cast<int64_t>(grid_x) * THREADS < E) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* k = static_cast<const int64_t*>(base_keys);
  const auto* g = static_cast<const int64_t*>(group);
  const auto* r = static_cast<const int64_t*>(rows);
  const auto* p = static_cast<const int32_t*>(nxt);
  auto st = static_cast<cudaStream_t>(stream);
  const auto gx = static_cast<unsigned>(grid_x), gy = static_cast<unsigned>(grid_y);
  const cudaError_t err =
      itemsize == 4 ? launch_typed<float>(k, n_groups, g, r, conc, p, out, S, E, A1, F, tile, gx,
                                          gy, st)
                    : launch_typed<double>(k, n_groups, g, r, conc, p, out, S, E, A1, F, tile, gx,
                                           gy, st);
  return static_cast<int>(err);
}

#ifdef KEYED_DRAW_PROBES
// One library routine per kernel, on one value a thread (x[i] in, y[i]
// out), for its SASS instruction count (keyed_draw_timing.py --sass); each
// probe_copy kernel is the baseline of its probes' loads and stores.
#define PROBE1(name, T, expr)                                             \
  extern "C" __global__ void name(const T* x, T* y) {                     \
    const T a = x[threadIdx.x];                                           \
    y[threadIdx.x] = (expr);                                              \
  }
#define PROBE2(name, T, expr)                                             \
  extern "C" __global__ void name(const T* x, const T* y, T* z) {         \
    const T a = x[threadIdx.x], b = y[threadIdx.x];                       \
    z[threadIdx.x] = (expr);                                              \
  }
#define PROBE_SINCOS(name, T, call)                                       \
  extern "C" __global__ void name(const T* x, T* s, T* c) {               \
    T sn, cs;                                                             \
    call(x[threadIdx.x], &sn, &cs);                                       \
    s[threadIdx.x] = sn;                                                  \
    c[threadIdx.x] = cs;                                                  \
  }
#define PROBE_COPY2(name, T)                                              \
  extern "C" __global__ void name(const T* x, T* s, T* c) {               \
    const T a = x[threadIdx.x];                                           \
    s[threadIdx.x] = a;                                                   \
    c[threadIdx.x] = a;                                                   \
  }
PROBE1(probe_copy_f32, float, a)
PROBE1(probe_log_f32, float, logf(a))
PROBE1(probe_sqrt_f32, float, sqrtf(a))
PROBE1(probe_exp_f32, float, expf(a))
PROBE1(probe_cos_f32, float, cosf(a))
PROBE2(probe_add_f32, float, a + b)
PROBE2(probe_div_f32, float, a / b)
PROBE_SINCOS(probe_sincos_f32, float, sincosf)
PROBE_COPY2(probe_copy2_f32, float)
PROBE1(probe_copy_f64, double, a)
PROBE1(probe_log_f64, double, log(a))
PROBE1(probe_sqrt_f64, double, sqrt(a))
PROBE1(probe_exp_f64, double, exp(a))
PROBE1(probe_cos_f64, double, cos(a))
PROBE2(probe_add_f64, double, a + b)
PROBE2(probe_div_f64, double, a / b)
PROBE_SINCOS(probe_sincos_f64, double, sincos)
PROBE_COPY2(probe_copy2_f64, double)
extern "C" __global__ void probe_bits_f32(const uint32_t* w, float* x) {
  x[threadIdx.x] = __uint_as_float(w[threadIdx.x]);
}
extern "C" __global__ void probe_uniform_f32(const uint32_t* w, float* x) {
  x[threadIdx.x] = uniform(w[threadIdx.x], float());
}
extern "C" __global__ void probe_bits_f64(const uint32_t* w, double* x) {
  x[threadIdx.x] = __longlong_as_double(static_cast<long long>(w[threadIdx.x]));
}
extern "C" __global__ void probe_uniform_f64(const uint32_t* w, double* x) {
  x[threadIdx.x] = uniform(w[threadIdx.x], double());
}
// Philox: one block, and two blocks under one key, from round keys
// scheduled from the kernel's arguments.
extern "C" __global__ void probe_philox1(const uint4* x, uint4* y, uint32_t k0, uint32_t k1) {
  y[threadIdx.x] = philox(x[threadIdx.x], schedule(k0, k1));
}
extern "C" __global__ void probe_philox2(const uint4* x, uint4* y, uint32_t k0, uint32_t k1) {
  const Keys k = schedule(k0, k1);
  y[threadIdx.x] = philox(x[threadIdx.x], k);
  y[blockDim.x + threadIdx.x] = philox(x[blockDim.x + threadIdx.x], k);
}
extern "C" __global__ void probe_copy_u4(const uint4* x, uint4* y, uint32_t, uint32_t) {
  y[threadIdx.x] = x[threadIdx.x];
}
extern "C" __global__ void probe_copy2_u4(const uint4* x, uint4* y, uint32_t, uint32_t) {
  y[threadIdx.x] = x[threadIdx.x];
  y[blockDim.x + threadIdx.x] = x[blockDim.x + threadIdx.x];
}
#endif
