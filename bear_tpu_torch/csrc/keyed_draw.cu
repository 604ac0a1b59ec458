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
// in registers.
//
// Per (s, e), one thread:
//   1. k = fold_in(base_keys[s, group[e]], rows[e]): the first two words of
//      the Philox4x32-10 block with counter (row low, row high, FOLD, 0);
//   2. under k, the words of the NORMAL, EXPONENTIAL and BOOST streams: word
//      j of a stream is lane j % 4 of the block with counter
//      (0, 0, stream, j / 4), drawn when first needed (one cached block per
//      stream, one cached Box-Muller pair);
//   3. per category a, the Marsaglia-Tsang proposals f = 0, 1, ... with
//      normal f*A1 + a and exponential f*A1 + a, up to the first accepted
//      one (the plain version computes all F and selects the first, the
//      same value), else the clamped last cube; minus boost / safe; -inf
//      where the concentration is 0;
//   4. picked: lg[nxt[e]] - logsumexp(lg) into out[s, e] (lg staged in
//      shared memory), or full: the row lg into out[s, e, :].
//
// What bounds it: operations, not bytes. A draw of A1 = 5 categories
// reads ~20 bytes of its element (shared by the S samples) and writes 4;
// it runs >= 7 Philox blocks of 10 rounds (mul.lo, mul.hi, XORs, the key
// schedule) and ~55 transcendentals (log, sqrt, sin or cos, exp; the
// accurate library versions, since the build has no fast math). The
// design keeps that work at what the draw needs: no word or intermediate
// goes to device memory, a proposal after the first accepted one is never
// computed, and a Philox block gives all four of its words.
//
// Rounding: each float operation is one IEEE rounding in the plain
// version's order; this source is compiled with -fmad=false (see
// bear_tpu_torch/_build.py) so that no multiply-add is contracted. The
// logsumexp sums in category order.
//
// Threads: elements fastest (coalesced element reads and picked stores),
// 128 a block along x; samples along y with a grid-stride loop.

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_A1 = 32;  // categories of a row (protein: 21)
constexpr int MAX_F = 64;   // Marsaglia-Tsang proposals
constexpr unsigned MAX_GRID_Y = 65535;

constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;  // Philox4x32 multipliers
constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;  // Weyl key increments
constexpr uint32_t FOLD = 0, NORMAL = 1, EXPONENTIAL = 2, BOOST = 3;
constexpr double TWO_PI = 6.283185307179586;  // Python's 2.0 * math.pi

__device__ __forceinline__ uint4 philox(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ uint32_t lane(const uint4& b, uint32_t i) {
  return i == 0 ? b.x : i == 1 ? b.y : i == 2 ? b.z : b.w;
}

// One stream's words under a key, a block at a time.
struct Stream {
  uint32_t sid, k0, k1, block;
  uint4 words;

  __device__ Stream(uint32_t sid_, uint32_t k0_, uint32_t k1_)
      : sid(sid_), k0(k0_), k1(k1_), block(0xFFFFFFFFu), words(make_uint4(0, 0, 0, 0)) {}

  __device__ __forceinline__ uint32_t word(uint32_t j) {
    const uint32_t b = j >> 2;
    if (b != block) {
      words = philox(make_uint4(0, 0, sid, b), k0, k1);
      block = b;
    }
    return lane(words, j & 3);
  }
};

// Uniforms in (0, 1): float keeps the top 23 bits, (w' + 1/2) 2^-23;
// double all 32, (w + 1/2) 2^-32 (keyed_random.uniform).
__device__ __forceinline__ float uniform(uint32_t w, float) {
  return (static_cast<float>(w >> 9) + 0.5f) * 0x1p-23f;
}
__device__ __forceinline__ double uniform(uint32_t w, double) {
  return (static_cast<double>(w) + 0.5) * 0x1p-32;
}

// Standard normal n of the NORMAL stream: Box-Muller on words 2m, 2m + 1
// (m = n / 2), cosine for even n, sine for odd (keyed_random.normal).
template <typename T>
struct Normals {
  Stream words;
  uint32_t pair;
  T r, theta;

  __device__ Normals(uint32_t k0, uint32_t k1)
      : words(NORMAL, k0, k1), pair(0xFFFFFFFFu), r(0), theta(0) {}

  __device__ __forceinline__ T operator()(uint32_t n) {
    const uint32_t m = n >> 1;
    if (m != pair) {
      const T u1 = uniform(words.word(2 * m), T());
      const T u2 = uniform(words.word(2 * m + 1), T());
      r = sqrt(T(-2.0) * log(u1));
      theta = T(TWO_PI) * u2;
      pair = m;
    }
    return (n & 1) ? r * sin(theta) : r * cos(theta);
  }
};

template <typename T, bool PICKED>
__global__ void __launch_bounds__(THREADS)
keyed_draw_kernel(const int64_t* __restrict__ base_keys, int64_t n_groups,
                  const int64_t* __restrict__ group, const int64_t* __restrict__ rows,
                  const T* __restrict__ conc, const int32_t* __restrict__ nxt,
                  T* __restrict__ out, int64_t S, int64_t E, int A1, int F) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* lgs = reinterpret_cast<T*>(smem) + threadIdx.x;  // [A1][THREADS], this thread's column

  const int64_t e = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= E) return;  // no barrier below
  const int64_t g = group[e];
  const uint64_t row = static_cast<uint64_t>(rows[e]);
  const int k = PICKED ? nxt[e] : 0;
  const bool valid = g >= 0 && g < n_groups && k >= 0 && k < A1;
  const T* c_row = conc + e * A1;

  for (int64_t s = blockIdx.y; s < S; s += gridDim.y) {
    if (!valid) {  // an index the plain version would refuse: NaN, never a stray read
      if (PICKED) {
        out[s * E + e] = T(NAN);
      } else {
        for (int a = 0; a < A1; ++a) out[(s * E + e) * A1 + a] = T(NAN);
      }
      continue;
    }
    const uint64_t base = static_cast<uint64_t>(base_keys[s * n_groups + g]);
    const uint4 key = philox(make_uint4(static_cast<uint32_t>(row),
                                        static_cast<uint32_t>(row >> 32), FOLD, 0),
                             static_cast<uint32_t>(base), static_cast<uint32_t>(base >> 32));
    Normals<T> normal(key.x, key.y);
    Stream expo(EXPONENTIAL, key.x, key.y), boost(BOOST, key.x, key.y);

    for (int a = 0; a < A1; ++a) {
      const T c = c_row[a];
      const T safe = c < T(1e-30) ? T(1e-30) : c;
      const T d = safe + T(1.0 - 1.0 / 3.0);
      const T cc = T(1) / sqrt(T(9) * d);
      T v = T(0), v_fin = T(0);
      bool accepted = false;
      for (int f = 0; f < F; ++f) {
        const uint32_t n = static_cast<uint32_t>(f * A1 + a);
        const T x = normal(n);
        const T log_u = log(uniform(expo.word(n), T()));
        const T t = T(1) + cc * x;
        v = t * t * t;
        const bool pos = v > T(0);
        const T vs = pos ? v : T(1);
        if (pos && log_u < T(0.5) * x * x + d - d * vs + d * log(vs)) {
          v_fin = vs;
          accepted = true;
          break;
        }
      }
      if (!accepted) v_fin = v < T(1e-3) ? T(1e-3) : v;
      const T boost_e = -log(uniform(boost.word(static_cast<uint32_t>(a)), T()));
      const T log_g1 = log(d) + log(v_fin);
      const T lg = c > T(0) ? log_g1 - boost_e / safe : T(-INFINITY);
      if (PICKED) {
        lgs[a * THREADS] = lg;
      } else {
        out[(s * E + e) * A1 + a] = lg;
      }
    }

    if (PICKED) {  // torch.logsumexp: max (0 if infinite), sum of exp in order, log, + max
      T m = lgs[0];
      for (int a = 1; a < A1; ++a) m = fmax(m, lgs[a * THREADS]);
      if (isinf(m)) m = T(0);
      T sum = T(0);
      for (int a = 0; a < A1; ++a) sum = sum + exp(lgs[a * THREADS] - m);
      const T lse = log(sum) + m;
      out[s * E + e] = lgs[k * THREADS] - lse;
    }
  }
}

template <typename T, bool PICKED>
cudaError_t launch(const int64_t* base_keys, int64_t n_groups, const int64_t* group,
                   const int64_t* rows, const void* conc, const int32_t* nxt, void* out,
                   int64_t S, int64_t E, int A1, int F, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((E + THREADS - 1) / THREADS),
                  static_cast<unsigned>(S < MAX_GRID_Y ? S : MAX_GRID_Y));
  const size_t smem = PICKED ? static_cast<size_t>(A1) * THREADS * sizeof(T) : 0;
  keyed_draw_kernel<T, PICKED><<<grid, THREADS, smem, stream>>>(
      base_keys, n_groups, group, rows, static_cast<const T*>(conc), nxt,
      static_cast<T*>(out), S, E, A1, F);
  return cudaGetLastError();
}

}  // namespace

// base_keys int64 [S, n_groups]; group, rows int64 [E]; conc [E, A1] of
// float (itemsize 4) or double (8); nxt int32 [E] for the picked mode
// (out [S, E]), or null for the full mode (out [S, E, A1]). All contiguous
// on one card; launched on `stream`. Returns a cudaError_t (0: launched).
extern "C" int keyed_draw_launch(const void* base_keys, int64_t n_groups, const void* group,
                                 const void* rows, const void* conc, const void* nxt,
                                 void* out, int64_t S, int64_t E, int32_t A1, int32_t F,
                                 int32_t itemsize, void* stream) {
  if (S < 1 || E < 1 || n_groups < 1 || A1 < 1 || A1 > MAX_A1 || F < 1 || F > MAX_F ||
      (itemsize != 4 && itemsize != 8) || (E + THREADS - 1) / THREADS > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* k = static_cast<const int64_t*>(base_keys);
  const auto* g = static_cast<const int64_t*>(group);
  const auto* r = static_cast<const int64_t*>(rows);
  const auto* p = static_cast<const int32_t*>(nxt);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (itemsize == 4) {
    err = p ? launch<float, true>(k, n_groups, g, r, conc, p, out, S, E, A1, F, st)
            : launch<float, false>(k, n_groups, g, r, conc, p, out, S, E, A1, F, st);
  } else {
    err = p ? launch<double, true>(k, n_groups, g, r, conc, p, out, S, E, A1, F, st)
            : launch<double, false>(k, n_groups, g, r, conc, p, out, S, E, A1, F, st);
  }
  return static_cast<int>(err);
}
