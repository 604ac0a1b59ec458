// The CNN AR function's forward under inference, as one kernel: k-mers
// [N, lag, A1] (one-hot, or any float) -> probabilities [N, A1]. No
// intermediate reaches device memory: a row's 280 bytes (at the lag-13 DNA
// CNN) are read and written once.
//
// Replaces no TPU kernel. bear_tpu's CNN (bear_tpu/models/ar_funcs.py,
// make_ar_func_cnn) is jitted XLA, with no pallas_call. Its plain PyTorch
// version is CNNAR._forward_plain in bear_tpu_torch/models/ar_funcs.py: some
// thirty ATen passes (the unfold copy, the conv as a batched product, layer
// normalisation's mean, var, subtract and divide, scale, intercept, elu's
// clamp, expm1 and where, a float32 GEMM, the head, the softmax) over a
// [N, conv_len, nf] activation that goes to device memory and back: 1.42
// GB a posterior-scoring call of 618,496 rows, most of that call's device
// time. This kernel was added for that call; autograd keeps the ATen path.
//
// The function, per row (flat input x[s], s = position * A1 + letter):
//   conv[j][f] = sum_{k < fw A1} x[j A1 + k] filters[k][f],  j < conv_len
//   a0[j][f]   = elu(scale0[j][f] norm(conv[j])[f] + intercept0[j][f])
//   hidden[h]  = sum_{j, f} a0[j][f] weights1[j][f][h]
//   a1[h]      = elu(scale1[h] norm(hidden)[h] + intercept1[h])
//   probs      = softmax(a1 weights2 + intercept2)
// norm(v) = (v - mean) / sqrt(var + 1e-5) over the row's nf (or w1)
// values, population variance, two passes (the mean, then the centred sum
// of squares); elu(v) = v > 0 ? v : expm1(v); the softmax subtracts the
// row's largest logit. Arithmetic is FMAs on the CUDA cores in the
// tensors' own type (float or double): no TF32, 3xTF32 or bf16 anywhere.
//
// What bounds it on an H100: the CUDA cores' FMA issue, not bytes. A row
// is 2 (conv_len fw A1 nf + conv_len nf w1 + w1 A1) FLOPs (120,448 at lag
// 13, A1 5, fw 8, nf 96, w1 64) against 4 (lag A1 + A1) bytes (280): 430
// FLOPs a byte, where float32 on the card turns at 20 (67 TFLOP/s over
// 3.35 TB/s). So 618,496 rows need at least 1.11 ms (0.47 ms a
// 2^18-row slice). What the design does about it:
//   - a block owns tiles of R rows (64 rows and 256 threads in float; 16
//     and 128 where N leaves fewer than two large tiles an SM or the large
//     tile does not fit shared memory, and always in double:
//     ops/cnn_forward.py launch_shape) and holds in shared memory the
//     filters, the scales and intercepts, a 96 x 64 block of weights1, the
//     head, the tile's inputs transposed (rows minor) and the next tile's as
//     they are in x. Blocks are persistent, as many as the SMs hold (two of
//     107 KB an SM in float at the lag-13 CNN): the parameters are read once
//     a block, and the next tile's inputs arrive by cp.async while the block
//     computes this one;
//   - for each conv position j the block (1) computes the [R, 96] conv of a
//     block of 96 filters register-tiled: a thread owns 2 rows x 12 filters
//     (1 x 12 at 16 rows), and each tap is one load of the rows' inputs,
//     three 16-byte loads of the filters and 24 FMAs; (2) takes each row's
//     statistics over the 8 threads that share it by warp shuffles, and
//     normalizes and activates in registers; (3) stages the activations in
//     shared memory; (4) accumulates hidden[R, 64] += act[R, 96]
//     weights1[j] as a register-tiled product: a thread owns 4 rows x 4
//     hidden units (2 x 4 at 16 rows), and each filter is a 16-byte load of
//     activations, one of weights and 16 FMAs. With one block of each width
//     the hidden sums stay in registers over all positions;
//   - any width: the filters run in blocks of 96 and the hidden units in
//     blocks of 64, zero-padded in shared memory and masked out of the
//     statistics. A filter block's raw conv is staged in the activations'
//     space, all but the last (which stays in registers), and read back by
//     the thread that wrote it, so the statistics span all blocks; a hidden
//     block's sum over one position's filters is added to the block's sums
//     in shared memory. A CNN of one block each (up to 96 filters and 64
//     hidden units, as at lag 13) has an instance of its own with the
//     block counts constant, and stages nothing more. Lag, A1 and fw
//     are runtime values; shared memory alone bounds the widths;
//   - narrow widths: a CNN whose filters fit one block of 32 and whose
//     hidden units fit one of 16 (bear_cnn_bear.cfg's 30 and 16, the protein
//     cell's) takes the same function, in the same order, over those blocks
//     (Narrow below; ops/cnn_forward.py picks it from the widths alone).
//     Padded to 96 x 64, 30 and 16 made 5.1x the multiply-adds, ran the
//     statistics, elu and stores over 96 filters, and the 64-row tile took
//     146,420 B at the protein CNN, one block an SM. The narrow tile is 64
//     rows and 256 threads (87,924 B there, two blocks an SM): a thread owns
//     2 rows x 4 filters of the conv (two loads of the rows' inputs, one
//     16-byte load of the filters and 8 FMAs a tap) and 2 rows x 2 hidden
//     units of the dense product. 16 warps an SM beat fewer loads: 4 rows x
//     4 filters at 128 threads (8 warps an SM) ran 25% slower on an H100;
//   - two 256-thread blocks an SM cap a thread at 128 registers: the
//     micro-tiles above are the largest that fit, and 16 warps an SM hide
//     the loads' latency better than 8 warps of tiles twice the size
//     (4 x 12 and 8 x 4 at 128 threads: 7% slower on an H100);
//   - weights1[j]'s first block (24.5 KB in float) is copied into shared
//     memory by cp.async while the block computes position j's conv;
//   - the activations are stored filter-permuted (position t * 8 + lane
//     holds lane * 12 + t, and weights1's rows follow), so a warp's stores
//     fall in distinct banks;
//   - the head (w1 x A1) and the softmax run in the same block, from
//     shared memory; only [R, A1] is stored;
//   - elu's expm1 (640 a row at the lag-13 CNN) is the largest cost beside
//     the FMAs: in float it is expm1_nonpositive below, a third of
//     expm1f's instructions for the same accuracy (4% faster on the whole);
//     double keeps CUDA's expm1.
// On an H100 at the lag-13 CNN this reaches ~36% of the FMA roofline: by
// ablation, the dense product runs at ~59% of its own bound, the conv at
// ~40% (a quarter of its instructions are loads), elu ~10% of the time.
// At the protein CNN the narrow instance reaches ~18% (the padded one
// 5.4%): by ablation no phase takes more than 13% of its time (the conv's
// FMAs 13%, elu 9%, the head 7%, the statistics 7%, the dense product
// 5%); shared memory's delivery (the dense product's four loads a
// thread for 4 FMAs, the conv's three for 8) and latency bound the rest.
// That roofline counts the conv densely (fw A1 taps a filter); the rows the
// main path serves are one-hot, fw of those taps non-zero.

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

// An instance's blocks: FL threads share a row's filters, FPL filters each
// (NF = FL FPL filters a block); HL threads share a row's hidden units, HPL
// each (W1 = HL HPL hidden units a block).
template <int FL_, int FPL_, int HL_, int HPL_>
struct Blocks {
  static constexpr int FL = FL_, FPL = FPL_, NF = FL_ * FPL_;
  static constexpr int HL = HL_, HPL = HPL_, W1 = HL_ * HPL_;
};
using Padded = Blocks<8, 12, 16, 4>;  // 96 filters, 64 hidden units a block
using Narrow = Blocks<8, 4, 8, 2>;    // 32 filters, 16 hidden units: one block of each
constexpr int SMEM_MAX = 232448;  // shared memory a block may have on Hopper
constexpr double NORM_EPS = 1e-5;
// Blocks of NT threads an SM must hold at once: two of 256 cap a thread at
// 128 registers, which the 64-row float tile fits without spilling.
template <int NT>
constexpr int MIN_BLOCKS = NT >= 256 ? 2 : 1;

__host__ __device__ constexpr int blocks_of(int width, int block) {
  return (width + block - 1) / block;
}

template <typename T>
struct Vec;  // 16 bytes of T
template <>
struct Vec<float> {
  using type = float4;
};
template <>
struct Vec<double> {
  using type = double2;
};

template <int N>
__device__ __forceinline__ void put(float (&v)[N], int o, float4 q) {
  v[o] = q.x;
  v[o + 1] = q.y;
  v[o + 2] = q.z;
  v[o + 3] = q.w;
}
template <int N>
__device__ __forceinline__ void put(double (&v)[N], int o, double2 q) {
  v[o] = q.x;
  v[o + 1] = q.y;
}
template <int N>
__device__ __forceinline__ float4 take(const float (&v)[N], int o) {
  return make_float4(v[o], v[o + 1], v[o + 2], v[o + 3]);
}
template <int N>
__device__ __forceinline__ double2 take(const double (&v)[N], int o) {
  return make_double2(v[o], v[o + 1]);
}

// v = p[0 .. N): 16-byte shared-memory loads where N fills them (p is then
// 16-byte aligned by the layout), else one load a value.
template <int N, typename T>
__device__ __forceinline__ void load(T (&v)[N], const T* p) {
  constexpr int V = 16 / sizeof(T);
  if constexpr (N % V == 0) {
#pragma unroll
    for (int i = 0; i < N / V; ++i) put(v, i * V, reinterpret_cast<const typename Vec<T>::type*>(p)[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

template <int N, typename T>
__device__ __forceinline__ void store(T* p, const T (&v)[N]) {
  constexpr int V = 16 / sizeof(T);
  if constexpr (N % V == 0) {
#pragma unroll
    for (int i = 0; i < N / V; ++i) reinterpret_cast<typename Vec<T>::type*>(p)[i] = take(v, i * V);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

// Sum over the G consecutive lanes of a group (G a power of two, <= 32).
template <int G, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int m = 1; m < G; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// expm1(v) for v <= 0 (and NaN) in float, within ~1 ulp, in a third of
// expm1f's instructions: v = k ln2 + r with |r| <= ln2 / 2 (k = 0 for |v|
// < ln2 / 2, so a small v keeps its relative precision), expm1(v) = 2^k
// expm1(r) + (2^k - 1), expm1(r) by its Taylor polynomial to r^7 (the next
// term is under 0.2 ulp at |r| = ln2 / 2). Below -30 it is -1 in float.
__device__ __forceinline__ float expm1_nonpositive(float v) {
  v = v < -30.f ? -30.f : v;
  const float k = rintf(v * 1.44269504f);
  float r = fmaf(k, -0.693145752f, v);  // ln2's high part: k * it is exact
  r = fmaf(k, -1.42860677e-6f, r);
  float q = fmaf(r, 1.f / 5040.f, 1.f / 720.f);
  q = fmaf(q, r, 1.f / 120.f);
  q = fmaf(q, r, 1.f / 24.f);
  q = fmaf(q, r, 1.f / 6.f);
  q = fmaf(q, r, 0.5f);
  const float p = fmaf(q * r, r, r);
  const float s = __int_as_float((static_cast<int>(k) + 127) << 23);  // 2^k, k in [-44, 0]
  return fmaf(s, p, s - 1.f);
}

__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : expm1_nonpositive(v); }
__device__ __forceinline__ double elu(double v) { return v > 0. ? v : expm1(v); }

// Asynchronous copy of BYTES (4, 8 or 16) from global to shared memory,
// of which the first `bytes` come from src and the rest are zeros (src is
// not read where bytes is 0).
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(BYTES), "r"(bytes));
  }
}

__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_all;\n" ::); }

// The filter that activation (and weights1) row p of a block holds: p =
// t * FL + lane holds lane * FPL + t.
template <class B>
__host__ __device__ constexpr int filter_of(int p) {
  return (p % B::FL) * B::FPL + p / B::FL;
}

// Shared-memory regions, offsets in elements of T (ops/cnn_forward.py
// smem_bytes mirrors the total). Tiles whose rows are minor (xT, act) have
// row stride S = R + 16 bytes, the hidden ones [R][W1P] stride S1 = W1P + 16
// bytes; every region a 16-byte load reads starts on 16 bytes.
struct Layout {
  int S, S1, xraw, xT, act, hacc, filt, w1, s0, i0, s1, i1, w2, b2, total;
};

template <class B>
__host__ __device__ inline Layout layout(int R, int itemsize, int LA, int K, int CL, int A1,
                                         int nf, int w1) {
  constexpr int NF_BLOCK = B::NF, W1_BLOCK = B::W1;
  const int per16 = 16 / itemsize;
  const int NFP = blocks_of(nf, NF_BLOCK) * NF_BLOCK, HB = blocks_of(w1, W1_BLOCK);
  const int W1P = HB * W1_BLOCK;
  Layout m{};
  m.S = R + per16;
  m.S1 = W1P + per16;
  int o = 0;
  m.xraw = o;
  o += (R * LA + per16 - 1) / per16 * per16;  // the next tile's inputs [R][LA]
  m.xT = o;
  o += LA * m.S;  // the tile's inputs [LA][S]; after the last position, the logits [R][A1]
  m.act = o;
  o += NFP * m.S;  // a position's activations [NFP][S]; with one block of each, then [R][S1]
  m.hacc = o;
  o += NFP > NF_BLOCK || HB > 1 ? R * m.S1 : 0;  // more than one block: the hidden sums [R][S1]
  m.filt = o;
  o += K * NFP;  // filters [K][NFP]
  m.w1 = o;
  o += NF_BLOCK * W1_BLOCK;  // a block of weights1 [NF][W1], rows filter-permuted
  m.s0 = o;
  o += CL * NFP;
  m.i0 = o;
  o += CL * NFP;
  m.s1 = o;
  o += W1P;
  m.i1 = o;
  o += W1P;
  m.w2 = o;
  o += w1 * A1;
  m.b2 = o;
  o += A1;
  m.total = o;
  return m;
}

// Block (hb, fb) of weights1[j] [nf][w1] -> dst [NF][W1]: row p from filter
// fb * NF + filter_of(p), columns hb * W1 on, zeros beyond nf and w1;
// 16-byte copies where w1's rows allow them.
template <int NT, class B, typename T>
__device__ __forceinline__ void copy_weights1(T* dst, const T* src, int nf, int w1, int hb,
                                              int fb, bool vec) {
  constexpr int NF_BLOCK = B::NF, W1_BLOCK = B::W1;
  const int f0 = fb * NF_BLOCK, h0 = hb * W1_BLOCK;
  if (vec) {
    constexpr int V = 16 / sizeof(T), CHUNKS = W1_BLOCK / V;
#pragma unroll
    for (int c = threadIdx.x; c < NF_BLOCK * CHUNKS; c += NT) {
      const int p = c / CHUNKS, h = (c - p * CHUNKS) * V, f = f0 + filter_of<B>(p);
      const bool ok = f < nf && h0 + h < w1;
      copy_async<16>(dst + p * W1_BLOCK + h, ok ? src + f * w1 + h0 + h : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < NF_BLOCK * W1_BLOCK; e += NT) {
      const int p = e / W1_BLOCK, h = e - p * W1_BLOCK, f = f0 + filter_of<B>(p);
      const bool ok = f < nf && h0 + h < w1;
      copy_async<sizeof(T)>(dst + e, ok ? src + f * w1 + h0 + h : src,
                            ok ? static_cast<int>(sizeof(T)) : 0);
    }
  }
}

// Tile `tile` of x [n][LA] (R rows, contiguous) -> dst [R * LA]: 16-byte
// copies where x allows them, the last partial one and rows past n zeros;
// nothing past the last tile.
template <int NT, typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* x, int64_t tile, int64_t n, int LA,
                                          int R, bool vec) {
  const int64_t row0 = tile * R;
  if (row0 >= n) return;
  const int64_t have = (n - row0 < R ? n - row0 : R) * LA;  // elements of the tile in x
  const T* src = x + row0 * LA;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    for (int c = threadIdx.x; c * V < R * LA; c += NT) {
      const int64_t left = have - static_cast<int64_t>(c) * V;
      const int bytes = left >= V ? 16 : left > 0 ? static_cast<int>(left * sizeof(T)) : 0;
      copy_async<16>(dst + c * V, bytes ? src + c * V : x, bytes);
    }
  } else {
    for (int e = threadIdx.x; e < R * LA; e += NT) {
      const int bytes = e < have ? static_cast<int>(sizeof(T)) : 0;
      copy_async<sizeof(T)>(dst + e, bytes ? src + e : x, bytes);
    }
  }
}

// B: the blocks (Padded or Narrow). WIDE: more than one block of filters or
// of hidden units; else one of each, the block counts constants.
template <typename T, int R, int NT, bool WIDE, class B>
__global__ void __launch_bounds__(NT, MIN_BLOCKS<NT>)
cnn_forward_kernel(const T* __restrict__ x, const T* __restrict__ filters,
                   const T* __restrict__ intercept0, const T* __restrict__ weights1,
                   const T* __restrict__ intercept1, const T* __restrict__ weights2,
                   const T* __restrict__ intercept2, const T* __restrict__ scale0,
                   const T* __restrict__ scale1, T* __restrict__ out, int64_t n, int lag,
                   int A1, int fw, int nf, int w1, bool vec_x, bool vec_w1) {
  constexpr int FILTER_LANES = B::FL, FILTERS_PER_LANE = B::FPL, NF_BLOCK = B::NF;
  constexpr int HIDDEN_LANES = B::HL, HIDDEN_PER_LANE = B::HPL, W1_BLOCK = B::W1;
  constexpr int RC = R / (NT / FILTER_LANES);  // rows a thread in the conv
  constexpr int RD = R / (NT / HIDDEN_LANES);  // rows a thread in the dense layer
  static_assert(RC >= 1 && RD >= 1 && R % (NT / FILTER_LANES) == 0 &&
                R % (NT / HIDDEN_LANES) == 0, "tile rows");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int LA = lag * A1, K = fw * A1, CL = lag - fw + 1;
  const int NFB = WIDE ? blocks_of(nf, NF_BLOCK) : 1, NFP = NFB * NF_BLOCK;
  const int HB = WIDE ? blocks_of(w1, W1_BLOCK) : 1, W1P = HB * W1_BLOCK;
  const Layout L = layout<B>(R, sizeof(T), LA, K, CL, A1, nf, w1);
  const int S = L.S, S1 = L.S1;
  T* xraw = sm + L.xraw;
  T* xT = sm + L.xT;
  T* act = sm + L.act;
  T* hacc = sm + L.hacc;
  T* filt = sm + L.filt;
  T* w1s = sm + L.w1;
  T* s0 = sm + L.s0;
  T* i0 = sm + L.i0;
  T* s1 = sm + L.s1;
  T* i1 = sm + L.i1;
  T* w2 = sm + L.w2;
  T* b2 = sm + L.b2;
  const int tid = threadIdx.x;
  const int64_t tiles = (n + R - 1) / R;

  // The first tile's inputs in flight, then the parameters, padded with
  // zeros, once for every tile the block takes.
  int64_t tile = blockIdx.x;
  copy_tile<NT>(xraw, x, tile, n, LA, R, vec_x);
  for (int e = tid; e < K * NFP; e += NT) {
    const int k = e / NFP, f = e - k * NFP;
    filt[e] = f < nf ? filters[k * nf + f] : T(0);
  }
  for (int e = tid; e < CL * NFP; e += NT) {
    const int j = e / NFP, f = e - j * NFP;
    s0[e] = f < nf ? scale0[j * nf + f] : T(0);
    i0[e] = f < nf ? intercept0[j * nf + f] : T(0);
  }
  for (int h = tid; h < W1P; h += NT) {
    s1[h] = h < w1 ? scale1[h] : T(0);
    i1[h] = h < w1 ? intercept1[h] : T(0);
  }
  for (int e = tid; e < w1 * A1; e += NT) w2[e] = weights2[e];
  for (int a = tid; a < A1; a += NT) b2[a] = intercept2[a];

  const int fl = tid % FILTER_LANES, rc = (tid / FILTER_LANES) * RC;
  const int hl = tid % HIDDEN_LANES, rd = (tid / HIDDEN_LANES) * RD;
  // This thread's staged values, each read back only by it: a filter
  // block's row t * 8 + fl of act at aown + (fb * 96 + t * 8) * S, the
  // hidden units' sums (and then activations) at hown + i * S1 + hb * 64, in
  // hacc where WIDE, else in act after the last position.
  T* aown = act + fl * S + rc;
  T* hown = (WIDE ? hacc : act) + rd * S1 + hl * HIDDEN_PER_LANE;
  for (; tile < tiles; tile += gridDim.x) {
    const int64_t row0 = tile * R;
    const int rows = n - row0 < R ? static_cast<int>(n - row0) : R;
    // The tile's inputs transposed, xT[s][r] = x[row0 + r][s] (rows past n
    // zeros, never stored); then the next tile's copy starts.
    copy_async_wait();
    __syncthreads();  // xraw landed; the last tile's head is done with xT and hacc
    for (int e = tid; e < R * LA; e += NT) {
      const int s = e / R, r = e % R;
      xT[s * S + r] = r < rows ? xraw[r * LA + s] : T(0);
    }
    __syncthreads();  // xraw read
    copy_tile<NT>(xraw, x, tile + gridDim.x, n, LA, R, vec_x);

    // The hidden sums in registers: over every position with one block,
    // else a position's sum of a block, added to the block's in hacc.
    T hid[RD][HIDDEN_PER_LANE];
#pragma unroll
    for (int i = 0; i < RD; ++i)
#pragma unroll
      for (int u = 0; u < HIDDEN_PER_LANE; ++u) hid[i][u] = T(0);

    for (int j = 0; j < CL; ++j) {
      if (j > 0) __syncthreads();  // the last dense product is done with act and w1s
      const T* w1j = weights1 + static_cast<int64_t>(j) * nf * w1;
      copy_weights1<NT, B>(w1s, w1j, nf, w1, 0, 0, vec_w1);

      // (1) conv, a block of 96 filters at a time: c[i][t] = conv[j][fb * 96
      // + lane * 12 + t] of row rc + i; each row's sum over its filters
      // accumulates over the blocks, every block but the last staged raw.
      T c[RC][FILTERS_PER_LANE], s[RC];
#pragma unroll
      for (int i = 0; i < RC; ++i) s[i] = T(0);
      for (int fb = 0; fb < NFB; ++fb) {
#pragma unroll
        for (int i = 0; i < RC; ++i)
#pragma unroll
          for (int t = 0; t < FILTERS_PER_LANE; ++t) c[i][t] = T(0);
        const T* xa = xT + j * A1 * S + rc;
        const T* fp = filt + fb * NF_BLOCK + fl * FILTERS_PER_LANE;
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
          T a[RC], b[FILTERS_PER_LANE];
          load(a, xa + k * S);
          load(b, fp + k * NFP);
#pragma unroll
          for (int i = 0; i < RC; ++i)
#pragma unroll
            for (int t = 0; t < FILTERS_PER_LANE; ++t) c[i][t] = fma(a[i], b[t], c[i][t]);
        }
        const int f0 = fb * NF_BLOCK + fl * FILTERS_PER_LANE;
#pragma unroll
        for (int i = 0; i < RC; ++i)
#pragma unroll
          for (int t = 0; t < FILTERS_PER_LANE; ++t) {
            if (f0 + t < nf) s[i] += c[i][t];
          }
        if (fb + 1 < NFB) {
#pragma unroll
          for (int t = 0; t < FILTERS_PER_LANE; ++t) {
            T v[RC];
#pragma unroll
            for (int i = 0; i < RC; ++i) v[i] = c[i][t];
            store(aown + (fb * NF_BLOCK + t * FILTER_LANES) * S, v);
          }
        }
      }

      // (2) each row's statistics over its nf filters, then scale,
      // intercept, elu; (3) staged, filter-permuted: act[fb * 96 + t * 8 +
      // lane][row]. The staged blocks first, then the last from registers.
      T mean[RC], q[RC];
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        mean[i] = group_sum<FILTER_LANES>(s[i]) / T(nf);
        q[i] = T(0);
      }
      for (int fb = 0; fb + 1 < NFB; ++fb) {
        const int f0 = fb * NF_BLOCK + fl * FILTERS_PER_LANE;
#pragma unroll
        for (int t = 0; t < FILTERS_PER_LANE; ++t) {
          T v[RC];
          load(v, aown + (fb * NF_BLOCK + t * FILTER_LANES) * S);
#pragma unroll
          for (int i = 0; i < RC; ++i) {
            const T d = v[i] - mean[i];
            if (f0 + t < nf) q[i] = fma(d, d, q[i]);
          }
        }
      }
      const int fl0 = (NFB - 1) * NF_BLOCK + fl * FILTERS_PER_LANE;
      T inv[RC];
#pragma unroll
      for (int i = 0; i < RC; ++i) {
#pragma unroll
        for (int t = 0; t < FILTERS_PER_LANE; ++t) {
          const T d = c[i][t] - mean[i];
          if (fl0 + t < nf) q[i] = fma(d, d, q[i]);
        }
        inv[i] = T(1) / sqrt(group_sum<FILTER_LANES>(q[i]) / T(nf) + T(NORM_EPS));
      }
      for (int fb = 0; fb + 1 < NFB; ++fb) {
        const int f0 = fb * NF_BLOCK + fl * FILTERS_PER_LANE;
        T sc[FILTERS_PER_LANE], ic[FILTERS_PER_LANE];
        load(sc, s0 + j * NFP + f0);
        load(ic, i0 + j * NFP + f0);
#pragma unroll
        for (int t = 0; t < FILTERS_PER_LANE; ++t) {
          T v[RC];
          load(v, aown + (fb * NF_BLOCK + t * FILTER_LANES) * S);
#pragma unroll
          for (int i = 0; i < RC; ++i) {
            const T e = elu(fma(sc[t], (v[i] - mean[i]) * inv[i], ic[t]));
            v[i] = f0 + t < nf ? e : T(0);
          }
          store(aown + (fb * NF_BLOCK + t * FILTER_LANES) * S, v);
        }
      }
      {
        T sc[FILTERS_PER_LANE], ic[FILTERS_PER_LANE];
        load(sc, s0 + j * NFP + fl0);
        load(ic, i0 + j * NFP + fl0);
#pragma unroll
        for (int t = 0; t < FILTERS_PER_LANE; ++t) {
          T v[RC];
#pragma unroll
          for (int i = 0; i < RC; ++i) {
            const T e = elu(fma(sc[t], (c[i][t] - mean[i]) * inv[i], ic[t]));
            v[i] = fl0 + t < nf ? e : T(0);
          }
          store(aown + ((NFB - 1) * NF_BLOCK + t * FILTER_LANES) * S, v);
        }
      }
      copy_async_wait();
      __syncthreads();  // act and w1s complete

      // (4) hidden[row][hb * 64 + lane * 4 + u] += act[fb * 96 + p][row]
      // w1s[p][lane * 4 + u], a block of weights1 at a time (the first
      // copied during the conv, the others here).
      for (int hb = 0; hb < HB; ++hb) {
        if (WIDE) {
#pragma unroll
          for (int i = 0; i < RD; ++i)
#pragma unroll
            for (int u = 0; u < HIDDEN_PER_LANE; ++u) hid[i][u] = T(0);
        }
        for (int fb = 0; fb < NFB; ++fb) {
          if (hb + fb > 0) {
            __syncthreads();  // the last block's product is done with w1s
            copy_weights1<NT, B>(w1s, w1j, nf, w1, hb, fb, vec_w1);
            copy_async_wait();
            __syncthreads();
          }
          const T* aa = act + fb * NF_BLOCK * S + rd;
          const T* wb = w1s + hl * HIDDEN_PER_LANE;
#pragma unroll
          for (int p = 0; p < NF_BLOCK; ++p) {
            T a[RD], b[HIDDEN_PER_LANE];
            load(a, aa + p * S);
            load(b, wb + p * W1_BLOCK);
#pragma unroll
            for (int i = 0; i < RD; ++i)
#pragma unroll
              for (int u = 0; u < HIDDEN_PER_LANE; ++u) hid[i][u] = fma(a[i], b[u], hid[i][u]);
          }
        }
        if (WIDE) {
#pragma unroll
          for (int i = 0; i < RD; ++i) {
            T* h = hown + i * S1 + hb * W1_BLOCK;
            if (j > 0) {
              T v[HIDDEN_PER_LANE];
              load(v, h);
#pragma unroll
              for (int u = 0; u < HIDDEN_PER_LANE; ++u) hid[i][u] += v[u];
            }
            store(h, hid[i]);
          }
        }
      }
    }

    // The hidden layer: each row's statistics over its w1 units (16 lanes
    // and every hidden block), scale, intercept, elu, in place at hown:
    // act's space with one block (every product has read act once the
    // barrier passes), else hacc's.
    __syncthreads();
    if (!WIDE) {
#pragma unroll
      for (int i = 0; i < RD; ++i) store(hown + i * S1, hid[i]);
    }
    T* a1s = WIDE ? hacc : act;
#pragma unroll
    for (int i = 0; i < RD; ++i) {
      T s = T(0), v[HIDDEN_PER_LANE];
      for (int hb = 0; hb < HB; ++hb) {
        const int h0 = hb * W1_BLOCK + hl * HIDDEN_PER_LANE;
        load(v, hown + i * S1 + hb * W1_BLOCK);
#pragma unroll
        for (int u = 0; u < HIDDEN_PER_LANE; ++u) {
          if (h0 + u < w1) s += v[u];
        }
      }
      const T mean = group_sum<HIDDEN_LANES>(s) / T(w1);
      T q = T(0);
      for (int hb = 0; hb < HB; ++hb) {
        const int h0 = hb * W1_BLOCK + hl * HIDDEN_PER_LANE;
        load(v, hown + i * S1 + hb * W1_BLOCK);
#pragma unroll
        for (int u = 0; u < HIDDEN_PER_LANE; ++u) {
          const T d = v[u] - mean;
          if (h0 + u < w1) q = fma(d, d, q);
        }
      }
      const T inv = T(1) / sqrt(group_sum<HIDDEN_LANES>(q) / T(w1) + T(NORM_EPS));
      for (int hb = 0; hb < HB; ++hb) {
        const int h0 = hb * W1_BLOCK + hl * HIDDEN_PER_LANE;
        T sh[HIDDEN_PER_LANE], ih[HIDDEN_PER_LANE];
        load(v, hown + i * S1 + hb * W1_BLOCK);
        load(sh, s1 + h0);
        load(ih, i1 + h0);
#pragma unroll
        for (int u = 0; u < HIDDEN_PER_LANE; ++u) {
          const T e = elu(fma(sh[u], (v[u] - mean) * inv, ih[u]));
          v[u] = h0 + u < w1 ? e : T(0);
        }
        store(hown + i * S1 + hb * W1_BLOCK, v);
      }
    }
    __syncthreads();

    // The head, logits[row][a] into xT's space, then each row's softmax.
    T* logit = xT;
    for (int o = tid; o < R * A1; o += NT) {
      const int r = o / A1, a = o - r * A1;
      T acc = T(0);
      for (int h = 0; h < w1; ++h) acc = fma(a1s[r * S1 + h], w2[h * A1 + a], acc);
      logit[o] = acc + b2[a];
    }
    __syncthreads();
    for (int r = tid; r < rows; r += NT) {
      T* l = logit + r * A1;
      T m = l[0];
      for (int a = 1; a < A1; ++a) m = l[a] > m ? l[a] : m;
      T sum = T(0);
      for (int a = 0; a < A1; ++a) {
        l[a] = exp(l[a] - m);
        sum += l[a];
      }
      T* o = out + (row0 + r) * A1;
      for (int a = 0; a < A1; ++a) o[a] = l[a] / sum;
    }
  }
  copy_async_wait();  // nothing left in flight at exit
}

template <typename T, int R, int NT, bool WIDE, class B>
cudaError_t launch(const void* const* p, void* out, int64_t n, int lag, int A1, int fw, int nf,
                   int w1, cudaStream_t stream) {
  const Layout L = layout<B>(R, sizeof(T), lag * A1, fw * A1, lag - fw + 1, A1, nf, w1);
  const size_t smem = static_cast<size_t>(L.total) * sizeof(T);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  auto kernel = cnn_forward_kernel<T, R, NT, WIDE, B>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // Persistent blocks: as many as the SMs hold at once, at most a tile each.
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem)) !=
          cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t tiles = (n + R - 1) / R;
  const int64_t grid = tiles < static_cast<int64_t>(sms) * per_sm ? tiles
                                                                  : static_cast<int64_t>(sms) * per_sm;
  const bool vec_x = reinterpret_cast<uintptr_t>(p[0]) % 16 == 0;
  const bool vec_w1 = (w1 * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(p[3]) % 16 == 0;
  kernel<<<static_cast<unsigned>(grid), NT, smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]), static_cast<const T*>(p[2]),
      static_cast<const T*>(p[3]), static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
      static_cast<const T*>(p[6]), static_cast<const T*>(p[7]), static_cast<const T*>(p[8]),
      static_cast<T*>(out), n, lag, A1, fw, nf, w1, vec_x, vec_w1);
  return cudaGetLastError();
}

}  // namespace

// x [n, lag, A1] and the CNN's parameters in checkpoint order (filters [fw,
// A1, nf], intercept0 [conv_len, nf], weights1 [conv_len, nf, w1],
// intercept1 [w1], weights2 [w1, A1], intercept2 [A1], scale0 [conv_len,
// nf], scale1 [w1]), all contiguous, of float (itemsize 4) or double (8),
// on one card; out [n, A1]. `rows` and `threads` are the tile a block owns
// (64 and 256 or 16 and 128 in float, 16 and 128 in double:
// ops/cnn_forward.py launch_shape), in either instance. Launched on
// `stream`; sets *narrow to 1 where the narrow instance ran, else 0;
// returns a cudaError_t (0: launched; cudaErrorInvalidValue where the tile
// is none of these or does not fit shared memory).
extern "C" int cnn_forward_launch(const void* x, const void* filters, const void* intercept0,
                                  const void* weights1, const void* intercept1,
                                  const void* weights2, const void* intercept2,
                                  const void* scale0, const void* scale1, void* out, int64_t n,
                                  int32_t lag, int32_t A1, int32_t fw, int32_t nf, int32_t w1,
                                  int32_t itemsize, int32_t rows, int32_t threads,
                                  void* stream, int32_t* narrow) {
  if (n < 1 || A1 < 1 || fw < 1 || fw > lag || nf < 1 || w1 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* p[9] = {x, filters, intercept0, weights1, intercept1,
                      weights2, intercept2, scale0, scale1};
  auto st = static_cast<cudaStream_t>(stream);
  // The instance, from the widths alone (ops/cnn_forward.py is_narrow
  // mirrors this rule for its shared-memory count).
  const bool nar = nf <= Narrow::NF && w1 <= Narrow::W1;
  const bool wide = nf > Padded::NF || w1 > Padded::W1;
  *narrow = nar ? 1 : 0;
#define CNN_TILE(TY, R, NT)                                                                 \
  if (itemsize == static_cast<int>(sizeof(TY)) && rows == R && threads == NT)               \
    return static_cast<int>(                                                                \
        nar    ? launch<TY, R, NT, false, Narrow>(p, out, n, lag, A1, fw, nf, w1, st)        \
        : wide ? launch<TY, R, NT, true, Padded>(p, out, n, lag, A1, fw, nf, w1, st)        \
               : launch<TY, R, NT, false, Padded>(p, out, n, lag, A1, fw, nf, w1, st));
  CNN_TILE(float, 64, 256)
  CNN_TILE(float, 16, 128)
  CNN_TILE(double, 16, 128)
#undef CNN_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
