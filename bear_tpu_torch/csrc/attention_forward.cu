// The attention AR function's forward under inference, as one kernel: one-hot
// contexts [N, lag, A1] -> probabilities [N, A1]. No activation, query, key,
// value, score or hidden value reaches device memory: a row's 280 bytes (at
// lag 13, A1 5) are read and written once.
//
// Replaces no TPU kernel. bear_tpu's attention AR (bear_tpu/models/
// ar_funcs.py, make_ar_func_attention) is jitted XLA, with no pallas_call. Its
// plain PyTorch version is AttentionAR._block_plain in bear_tpu_torch/models/
// ar_funcs.py: some twenty-five ATen passes (the embedding product, the layer
// norms' statistics, subtraction and division, the K and V GEMMs, cuBLAS
// gemv for each head's scores and context, the softmaxes, gelu, the adds)
// over [N, lag, D] float temporaries that go to device memory and back: most
// of a posterior-scoring call's device time. This kernel was added for that
// call; autograd keeps the ATen path.
//
// The function, per row (x0 [lag, A1] the one-hot context, D = d_model, H
// heads of dh = D / H, M the MLP's width; bear_tpu's order of operations):
//   x[j]   = x0[j] embed + pos[j]                       every position j
//   h[j]   = norm(x[j])
//   q      = h[lag-1] wq;  k[j] = h[j] wk;  v[j] = h[j] wv
//   s[j]   = (q_hd . k[j]_hd) * (1 / sqrt(dh)),  a = softmax_j(s)  per head hd
//   ctx_hd = sum_j a[j] v[j]_hd
//   x      = x[lag-1] + ctx wo
//   x      = (x + gelu_tanh(norm(x) w1 + b1) w2) + b2
//   probs  = softmax(x w_out + b_out)
// norm(v) = (v - mean) * (1 / sqrt(var + 1e-5)) over the D values, population
// variance, two passes; gelu_tanh as ATen's CUDA kernel writes it. K and V
// are computed at every position, as the model and its FLOP count define
// them (no product is reassociated). Arithmetic is FMAs on the CUDA cores in
// the tensors' own type (float or double): no TF32 or bf16, accurate exp and
// tanh.
//
// What bounds it on an H100: the CUDA cores' FMA rate, not bytes. A row is
// 2 (lag A1 D + 2 lag D^2 + 2 D^2 + 2 lag D + 2 D M + D A1) FLOPs (274,432 at
// lag 13, A1 5, D 64, M 128) against 4 (lag A1 + A1) bytes (280): 980 FLOPs
// a byte, where float32 on the card turns at 20. So 618,496 rows need at
// least 2.53 ms (1.07 ms a 2^18-row slice). 77.6% of those FLOPs are the K
// and V products, [lag, D] x [D, 2D] a row. Next to the FMAs, what limits it
// is shared memory's delivery to registers: a warp's 16-byte load takes 4 of
// the SM's cycles whether its 32 lanes read 512 distinct bytes or 16 lanes
// read the same 256 twice (measured on an H100), the time of 16 warp FMAs.
// What the design does about both:
//   - a row belongs to a team of 16 lanes, a warp to two rows at a time, and
//     each warp walks its own rows (persistent blocks, one an SM, of up to 8
//     warps): no barrier across the block once the resident parameters are
//     in shared memory; each warp's next two rows arrive by cp.async while
//     it computes these;
//   - a lane owns C columns of K and the same C of V (C = 4 in float, 2 in
//     double) at CHUNK = 13 positions: 104 values in registers. Each step of
//     the product is one 16-byte load of the lane's weights per k and one of
//     the row's normalised activations per position (stored k-chunk major,
//     positions minor, so the offsets are constants): 21 loads for 416 FMAs
//     a lane in float, the loads ~80% of the FMAs' time; the two rows of a
//     warp sit 4 banks apart;
//   - heads are padded in the resident weights to C x 2^i columns, so a head's
//     lanes are consecutive and its scores a shuffle reduction over them; the
//     softmax is taken over the positions in chunks of CHUNK, online
//     (running maximum and sum), so that any lag fits in the registers of one
//     chunk; the context stays in the lane;
//   - the query, wo, w1 and w2 are products of one row's vector: a lane owns C
//     output columns of both rows of its warp, and each team sums half of k,
//     so that every load of the weights feeds two rows (added across the
//     teams by one shuffle): 6 loads for 32 FMAs, against 5 for 16 with a row
//     a lane. The weights are resident in shared memory where 8 warps leave
//     room (float at these widths), else read through L1;
//   - the layer norms' reciprocal square roots and the context's division are
//     one a lane (a position each), not a serial chain of IEEE divisions;
//   - 256 threads an SM cap a thread at 255 registers, which the 104
//     accumulators, a k-step's 32 weights and one position's activations fit.
// On an H100 at these widths it reaches ~38% of the FMA roofline (float, no
// spill; double spills a little and runs with its weights in L1).
// Widths are runtime values: D in column blocks of 16 C (the heads of a block
// in its lanes), the MLP and the head in vectors of C a lane, lag in chunks.
// A head wider than a block's 16 C columns spans blocks of its own (the
// instance WIDE): its scores are summed over them, its K computed block by
// block before its V, and its context rescaled in shared memory. Shared
// memory alone bounds the widths (ops/attention_forward.py smem_bytes).

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TEAM = 16;   // lanes that share a row
constexpr int CHUNK = 13;  // positions whose K and V a lane holds at once
constexpr int HEAD_GROUP = 8;  // logits whose sums a team reduces together
static_assert(CHUNK <= TEAM, "a lane a position of a chunk");
constexpr int MAX_THREADS = 256;
constexpr int SMEM_MAX = 232448;  // shared memory a block may have on Hopper
constexpr int SMEM_SM = 233472;   // shared memory an SM has (228 KB)
constexpr double NORM_EPS = 1e-5;

template <typename T>
constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // values in 16 bytes; C
template <typename T>
constexpr int CB = TEAM * VEC<T>;  // columns of K (and of V) a column block

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

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

__device__ __forceinline__ void put(float (&v)[4], float4 q) {
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void put(double (&v)[2], double2 q) {
  v[0] = q.x;
  v[1] = q.y;
}
__device__ __forceinline__ float4 take(const float (&v)[4]) {
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ double2 take(const double (&v)[2]) { return make_double2(v[0], v[1]); }

// 16 bytes of shared memory (16-byte aligned by the layout) in and out.
template <typename T>
__device__ __forceinline__ void load(T (&v)[VEC<T>], const T* p) {
  put(v, *reinterpret_cast<const typename Vec<T>::type*>(p));
}
template <typename T>
__device__ __forceinline__ void store(T* p, const T (&v)[VEC<T>]) {
  *reinterpret_cast<typename Vec<T>::type*>(p) = take(v);
}

// Sums over the 16 lanes of a team (each value's own reduction; the
// shuffles of all N interleaved).
template <int N, typename T>
__device__ __forceinline__ void team_sums(T (&v)[N]) {
#pragma unroll
  for (int m = 1; m < TEAM; m <<= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], m);
  }
}

template <typename T>
__device__ __forceinline__ T team_sum(T v) {
  T a[1] = {v};
  team_sums(a);
  return a[0];
}

// Asynchronous copy of BYTES (4 or 8) from device to shared memory, zeros
// where `bytes` is 0 (src is then not read).
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(BYTES),
               "r"(bytes));
}

__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_all;\n" ::); }

// Rows 2 pair and 2 pair + 1 of x [n][LA] -> dst [2 LA], by the warp's lanes;
// a row past n zeros; nothing past the last pair.
template <typename T>
__device__ __forceinline__ void copy_pair(T* dst, const T* x, int64_t pair, int64_t n, int LA,
                                          int lane) {
  const int64_t row0 = pair * 2;
  if (row0 >= n) return;
  const int64_t have = (n - row0 < 2 ? n - row0 : 2) * LA;
  const T* src = x + row0 * LA;
  for (int e = lane; e < 2 * LA; e += 32) {
    const bool ok = e < have;
    copy_async<sizeof(T)>(dst + e, ok ? src + e : x, ok ? static_cast<int>(sizeof(T)) : 0);
  }
}

// The heads in the lanes: each padded to `lanes` x C columns (a power of two
// lanes, at most TEAM), `per_block` heads a column block of 16 C, `blocks`
// column blocks; a head wider than a block spans `span` blocks of its own.
struct Heads {
  int dh, lanes, span, per_block, blocks;
};

__host__ __device__ inline Heads heads_of(int D, int H, int C) {
  Heads hs{};
  hs.dh = D / H;
  hs.lanes = 1;
  while (hs.lanes < TEAM && hs.lanes * C < hs.dh) hs.lanes <<= 1;
  hs.span = (hs.dh + hs.lanes * C - 1) / (hs.lanes * C);
  hs.per_block = TEAM / hs.lanes;
  hs.blocks = hs.span > 1 ? H * hs.span : (H + hs.per_block - 1) / hs.per_block;
  return hs;
}

// Shared-memory regions, offsets in elements of T (ops/attention_forward.py
// smem_bytes mirrors the total). The block's: wk and wv, padded by head, [cb]
// [k][K or V][16 C]; embed [A1][D4]; pos [lag][D4]; b1 [M4], b2 [D4], w_out
// [D][A1] and b_out [A1]; where `resident`, wq [D][D4], wo [D][D4], w1 [D]
// [M4] and w2 [M][D4]. Each warp's: two buffers
// of its two rows' inputs [2][lag A1], then a region of RS a row: the
// normalised activations [D4 / C][LP][C] (after the attention, the MLP's
// normalised input [D4], hidden layer [M4] and logits there), then the last
// position's x [D4], the query [D4] and the context [D4]. RS puts the two
// rows of a warp 4 banks apart.
struct Layout {
  int D4, M4, A1p, LP, HR, RS, XR, emb, pos, b1, b2, wout, bout, wq, wo, w1, w2, warp0, per_warp,
      total;
};

template <typename T>
__host__ __device__ inline Layout layout(int warps, int lag, int A1, int D, int H, int M,
                                         bool resident) {
  constexpr int V = VEC<T>;
  Layout L{};
  const Heads hs = heads_of(D, H, V);
  L.D4 = round_up(D, V);
  L.M4 = round_up(M, V);
  L.A1p = round_up(A1, V);
  L.LP = round_up(lag, CHUNK);
  L.HR = L.LP * L.D4 > L.D4 + L.M4 + L.A1p ? L.LP * L.D4 : L.D4 + L.M4 + L.A1p;
  int rs = L.HR + 3 * L.D4;
  while ((rs * static_cast<int>(sizeof(T)) / 4) % 32 != 4) rs += V;
  L.RS = rs;
  L.XR = round_up(2 * lag * A1, V);
  L.emb = hs.blocks * L.D4 * 2 * CB<T>;
  L.pos = L.emb + A1 * L.D4;
  L.b1 = L.pos + lag * L.D4;
  L.b2 = L.b1 + L.M4;
  L.wout = L.b2 + L.D4;
  L.bout = L.wout + D * A1;
  L.wq = round_up(L.bout + A1, V);
  L.wo = L.wq + D * L.D4;
  L.w1 = L.wo + D * L.D4;
  L.w2 = L.w1 + D * L.M4;
  L.warp0 = resident ? L.w2 + M * L.D4 : L.wq;
  L.per_warp = 2 * L.XR + 2 * L.RS;
  L.total = L.warp0 + warps * L.per_warp;
  return L;
}

// The products of a warp's two rows, act_r [K] w [K][N] for r = 0, 1 (row r
// the team r's): out[c] for the lane's columns c0 .. c0 + C, c0 = l C, l C +
// 16 C, .... Team t sums its part of k (the first half of the 16-byte
// vectors, or the rest) for both rows, so that each load of w feeds both;
// the halves are then added across the teams, and epi(c0, acc) takes each
// vector of sums of the lane's own row. act_0 in shared memory, act_1
// `rstride` after it, C values a 16-byte vector, vectors `astride` apart
// (anything past K: unread); w's rows `ldw` apart, in shared memory
// (SHARED: padded with zeros to whole vectors) or device memory. Where
// `vec`, the rows are read 16 bytes at a time and the loads of several
// k-steps are in flight together; the last K % C rows, and every row
// otherwise, one value at a time.
template <bool SHARED, typename T, typename Epi>
__device__ __forceinline__ void team_product(const T* act0, int rstride, int astride,
                                             const T* __restrict__ w, int ldw, int K, int N,
                                             bool vec, int team, int l, Epi&& epi) {
  constexpr int V = VEC<T>;
  using VT = typename Vec<T>::type;
  const int N4 = round_up(N, V), half = round_up((K + 1) / 2, V);
  const int kb = team ? half : 0, ke = team ? K : (K < half ? K : half);
  const int KV = vec ? kb + (ke > kb ? (ke - kb) / V * V : 0) : kb;
  for (int cb = 0; cb < N4; cb += TEAM * V) {  // every lane, for the shuffles
    const int c0 = cb + l * V;
    T acc[2][V];
#pragma unroll
    for (int u = 0; u < V; ++u) acc[0][u] = acc[1][u] = T(0);
    const T* a = act0 + (kb / V) * astride;
    const T* wr = w + kb * ldw + c0;
    int k0 = c0 < N4 ? kb : ke;
#pragma unroll 2
    for (; k0 < KV; k0 += V, a += astride, wr += V * ldw) {
      T av[2][V], wv[V][V];
      load(av[0], a);
      load(av[1], a + rstride);
#pragma unroll
      for (int kk = 0; kk < V; ++kk) {
        const VT* q = reinterpret_cast<const VT*>(wr + kk * ldw);
        put(wv[kk], SHARED ? *q : __ldg(q));
      }
#pragma unroll
      for (int kk = 0; kk < V; ++kk)
#pragma unroll
        for (int u = 0; u < V; ++u) {
          acc[0][u] = fma(av[0][kk], wv[kk][u], acc[0][u]);
          acc[1][u] = fma(av[1][kk], wv[kk][u], acc[1][u]);
        }
    }
    for (; k0 < ke; k0 += V, a += astride, wr += V * ldw) {
      T av[2][V];
      load(av[0], a);
      load(av[1], a + rstride);
      for (int kk = 0; kk < V && k0 + kk < ke; ++kk) {
#pragma unroll
        for (int u = 0; u < V; ++u) {
          if (c0 + u < N) {
            const T wk = SHARED ? wr[kk * ldw + u] : __ldg(wr + kk * ldw + u);
            acc[0][u] = fma(av[0][kk], wk, acc[0][u]);
            acc[1][u] = fma(av[1][kk], wk, acc[1][u]);
          }
        }
      }
    }
    T own[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {  // this team's half of its row, plus the other team's
      const T mine = team ? acc[1][u] : acc[0][u], theirs = team ? acc[0][u] : acc[1][u];
      own[u] = mine + __shfl_xor_sync(0xffffffffu, theirs, TEAM);
    }
    if (c0 < N4) epi(c0, own);
  }
}

// w [K][N] in device memory -> dst [K][N4] in shared memory, zeros past N.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ w, int K, int N, int N4) {
  for (int e = threadIdx.x; e < K * N4; e += blockDim.x) {
    const int k = e / N4, c = e - k * N4;
    dst[e] = c < N ? w[k * N + c] : T(0);
  }
}

// The lane's share of norm(v) in place, v [D4] the raw values (zeros past D);
// inv_d = 1 / D.
template <typename T>
__device__ __forceinline__ void team_norm(T* v, int D, int D4, T inv_d, int l) {
  constexpr int V = VEC<T>;
  T s = T(0);
  for (int c0 = l * V; c0 < D4; c0 += TEAM * V) {
    T x[V];
    load(x, v + c0);
#pragma unroll
    for (int u = 0; u < V; ++u) s += x[u];
  }
  const T mean = team_sum(s) * inv_d;
  T q = T(0);
  for (int c0 = l * V; c0 < D4; c0 += TEAM * V) {
    T x[V];
    load(x, v + c0);
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const T d = x[u] - mean;
      if (c0 + u < D) q = fma(d, d, q);
    }
  }
  const T inv = T(1) / sqrt(team_sum(q) * inv_d + T(NORM_EPS));
  for (int c0 = l * V; c0 < D4; c0 += TEAM * V) {
    T x[V];
    load(x, v + c0);
#pragma unroll
    for (int u = 0; u < V; ++u) x[u] = c0 + u < D ? (x[u] - mean) * inv : T(0);
    store(v + c0, x);
  }
}

// K and V (NW 2), or one of them (NW 1: the half at wp), of CHUNK positions
// of a row at the lane's C columns of a column block: acc[j][w C + c]. hb: the
// row's normalised activations from the chunk's first position, k-chunks
// `hstep` apart; wp: the lane's columns of the block's first k, k rows WR
// apart, K's half then V's. Each k-step: one 16-byte load of each half's
// weights per k, one of the activations per position.
template <int NW, typename T>
__device__ __forceinline__ void kv_chunk(const T* hb, int hstep, const T* wp, int D4,
                                         T (&acc)[CHUNK][NW * VEC<T>]) {
  constexpr int V = VEC<T>, C = V, WR = 2 * CB<T>;
#pragma unroll
  for (int j = 0; j < CHUNK; ++j)
#pragma unroll
    for (int c = 0; c < NW * C; ++c) acc[j][c] = T(0);
  for (int k0 = 0; k0 < D4; k0 += V, hb += hstep, wp += V * WR) {
    T wr[NW][V][C];
#pragma unroll
    for (int kk = 0; kk < V; ++kk)
#pragma unroll
      for (int w = 0; w < NW; ++w) load(wr[w][kk], wp + kk * WR + w * CB<T>);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      T hv[V];
      load(hv, hb + j * V);
#pragma unroll
      for (int kk = 0; kk < V; ++kk)
#pragma unroll
        for (int w = 0; w < NW; ++w)
#pragma unroll
          for (int c = 0; c < C; ++c)
            acc[j][w * C + c] = fma(hv[kk], wr[w][kk][c], acc[j][w * C + c]);
    }
  }
}

// gelu's tanh approximation as ATen's CUDA kernel computes it.
template <typename T>
__device__ __forceinline__ T gelu_tanh(T x) {
  constexpr double kBeta = 1.41421356237309504880 * 1.12837916709551257390 * 0.5;  // ATen's
  const T beta = T(kBeta), kappa = T(0.044715);
  const T cube = x * x * x;
  const T inner = beta * (x + kappa * cube);
  return T(0.5) * x * (T(1) + tanh(inner));
}

template <typename T, bool WIDE>
__global__ void __launch_bounds__(MAX_THREADS, 1)
attention_forward_kernel(const T* __restrict__ x, const T* __restrict__ embed,
                         const T* __restrict__ pos, const T* __restrict__ wqkv,
                         const T* __restrict__ wo, const T* __restrict__ w1,
                         const T* __restrict__ b1, const T* __restrict__ w2,
                         const T* __restrict__ b2, const T* __restrict__ w_out,
                         const T* __restrict__ b_out, T* __restrict__ out, int64_t n, int lag,
                         int A1, int D, int H, int M, T scale, unsigned vec, bool resident) {
  constexpr int V = VEC<T>, C = V, WR = 2 * CB<T>;  // WR: a k's row of wk and wv
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int warps = blockDim.x / 32;
  const Layout L = layout<T>(warps, lag, A1, D, H, M, resident);
  const Heads hs = heads_of(D, H, C);
  const int D4 = L.D4, LP = L.LP, LA = lag * A1;
  const T inv_d = T(1) / T(D);  // the statistics' mean: a sum times 1 / D, as ATen's
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, team = lane / TEAM;
  const int l = lane % TEAM;
  T* xin = sm + L.warp0 + warp * L.per_warp;
  T* row = xin + 2 * L.XR + team * L.RS;
  T* h = row;                     // [D4 / C][LP][C]
  T* y = row;                     // after the attention: [D4]
  T* hid = row + D4;              // [M4]
  T* logit = row + D4 + L.M4;     // [A1]
  T* xl = row + L.HR;             // the last position's x, then the block's output
  T* q = xl + D4;
  T* ctx = q + D4;
  const T* emb = sm + L.emb;
  const T* ps = sm + L.pos;

  // This warp's first rows in flight, then the resident parameters, padded
  // with zeros, once for every row the block takes.
  int64_t pair = static_cast<int64_t>(blockIdx.x) * warps + warp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * warps;
  copy_pair(xin, x, pair, n, LA, lane);
  const T* wk = wqkv + D * D;
  const T* wv = wqkv + 2 * D * D;
  for (int e = tid; e < hs.blocks * D4 * WR; e += blockDim.x) {
    const int cb = e / (D4 * WR), r = e - cb * D4 * WR, k = r / WR, s = r - k * WR;
    const int half = s / CB<T>, ln = (s - half * CB<T>) / C, c = s % C;
    const int hd = cb / hs.span * hs.per_block + ln / hs.lanes;
    const int hc = cb % hs.span * CB<T> + (ln % hs.lanes) * C + c;
    const bool ok = k < D && ln < hs.per_block * hs.lanes && hd < H && hc < hs.dh;
    sm[e] = ok ? (half ? wv : wk)[k * D + hd * hs.dh + hc] : T(0);
  }
  stage(sm + L.emb, embed, A1, D, D4);
  stage(sm + L.pos, pos, lag, D, D4);
  stage(sm + L.b1, b1, 1, M, L.M4);
  stage(sm + L.b2, b2, 1, D, D4);
  stage(sm + L.wout, w_out, 1, D * A1, D * A1);
  stage(sm + L.bout, b_out, 1, A1, A1);
  if (resident) {
    stage(sm + L.wq, wqkv, D, D, D4);
    stage(sm + L.wo, wo, D, D, D4);
    stage(sm + L.w1, w1, D, M, L.M4);
    stage(sm + L.w2, w2, M, D, D4);
  }
  __syncthreads();
  // act [K] times wq, wo, w1 or w2 (N columns), from shared memory where
  // `resident`, else from device memory; `bit` says which of vec's is its.
  const auto product = [&](const T* act, int astride, int K, int N, const T* wg, int ws,
                           unsigned bit, auto&& epi) {
    const T* act0 = act - team * L.RS;  // team 0's row
    if (resident) {
      team_product<true>(act0, L.RS, astride, sm + ws, round_up(N, V), K, N, true, team, l,
                         epi);
    } else {
      team_product<false>(act0, L.RS, astride, wg, N, K, N, (vec & bit) != 0, team, l, epi);
    }
  };

  for (int buf = 0; pair * 2 < n; pair += stride, buf ^= 1) {
    copy_async_wait();
    __syncwarp();  // this pair's inputs landed; the last pair is done with the rows
    copy_pair(xin + (buf ^ 1) * L.XR, x, pair + stride, n, LA, lane);
    const T* x0 = xin + buf * L.XR + team * LA;
    const int64_t r = pair * 2 + team;

    // (1) x = x0 embed + pos at every position (the last one's kept in xl),
    // normalised into h; the padding positions zeros. A chunk of positions at
    // a time: each embedding row read once for all of them, their statistics
    // reduced together.
    for (int j0 = 0; j0 < LP; j0 += CHUNK) {
      T s[CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) s[j] = T(0);
      for (int c0 = l * V; c0 < D4; c0 += TEAM * V) {
        T v[CHUNK][V];
#pragma unroll
        for (int j = 0; j < CHUNK; ++j)
#pragma unroll
          for (int u = 0; u < V; ++u) v[j][u] = T(0);
        for (int a = 0; a < A1; ++a) {
          T em[V];
          load(em, emb + a * D4 + c0);
#pragma unroll
          for (int j = 0; j < CHUNK; ++j) {
            const T xa = j0 + j < lag ? x0[(j0 + j) * A1 + a] : T(0);
#pragma unroll
            for (int u = 0; u < V; ++u) v[j][u] = fma(xa, em[u], v[j][u]);
          }
        }
        T* hc = h + (c0 / V) * LP * V;
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
          const int p = j0 + j;
          if (p < lag) {
            T pv[V];
            load(pv, ps + p * D4 + c0);
#pragma unroll
            for (int u = 0; u < V; ++u) {
              v[j][u] = v[j][u] + pv[u];
              s[j] += v[j][u];
            }
            if (p == lag - 1) store(xl + c0, v[j]);
          }
          store(hc + p * V, v[j]);
        }
      }
      team_sums(s);
      T mean[CHUNK], qs[CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        mean[j] = s[j] * inv_d;
        qs[j] = T(0);
      }
      for (int c0 = l * V; c0 < D4; c0 += TEAM * V) {
        const T* hc = h + (c0 / V) * LP * V;
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
          T v[V];
          load(v, hc + (j0 + j) * V);
#pragma unroll
          for (int u = 0; u < V; ++u) {
            const T d = v[u] - mean[j];
            if (c0 + u < D) qs[j] = fma(d, d, qs[j]);
          }
        }
      }
      team_sums(qs);
      // 1 / sqrt(var + eps) of position j by lane j, then to every lane.
      T mine = T(0);
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) mine = j == l ? qs[j] : mine;
      mine = T(1) / sqrt(mine * inv_d + T(NORM_EPS));
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) qs[j] = __shfl_sync(0xffffffffu, mine, j, TEAM);
      for (int c0 = l * V; c0 < D4; c0 += TEAM * V) {
        T* hc = h + (c0 / V) * LP * V;
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
          if (j0 + j >= lag) continue;
          T v[V];
          load(v, hc + (j0 + j) * V);
#pragma unroll
          for (int u = 0; u < V; ++u) v[u] = c0 + u < D ? (v[u] - mean[j]) * qs[j] : T(0);
          store(hc + (j0 + j) * V, v);
        }
      }
    }
    __syncwarp();

    // (2) the last position's query.
    product(h + (lag - 1) * V, LP * V, D, D, wqkv, L.wq, 1u,
            [&](int c0, T(&acc)[V]) { store(q + c0, acc); });
    __syncwarp();

    // (3) K and V of a column block's heads at every position, a chunk of
    // positions at a time; each head's scores reduced over its lanes, its
    // softmax online over the chunks; the context into ctx.
    if constexpr (!WIDE) {
      for (int cb = 0; cb < hs.blocks; ++cb) {
        const int hd = cb * hs.per_block + l / hs.lanes, hc0 = (l % hs.lanes) * C;
        const bool mine = l < hs.per_block * hs.lanes && hd < H;
        T qv[C], cv[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          qv[c] = mine && hc0 + c < hs.dh ? q[hd * hs.dh + hc0 + c] : T(0);
          cv[c] = T(0);
        }
        T mx = -INFINITY, sum = T(0);
        for (int j0 = 0; j0 < lag; j0 += CHUNK) {
          T acc[CHUNK][2 * C];
          kv_chunk<2>(h + j0 * V, LP * V, sm + cb * D4 * WR + l * C, D4, acc);
          T s[CHUNK];
#pragma unroll
          for (int j = 0; j < CHUNK; ++j) {
            s[j] = T(0);
#pragma unroll
            for (int c = 0; c < C; ++c) s[j] = fma(qv[c], acc[j][c], s[j]);
          }
          for (int m = 1; m < hs.lanes; m <<= 1) {
#pragma unroll
            for (int j = 0; j < CHUNK; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], m);
          }
          T cm = mx;
#pragma unroll
          for (int j = 0; j < CHUNK; ++j) {
            s[j] = j0 + j < lag ? s[j] * scale : T(-INFINITY);
            cm = s[j] > cm ? s[j] : cm;
          }
          const T alpha = exp(mx - cm);
          sum *= alpha;
#pragma unroll
          for (int c = 0; c < C; ++c) cv[c] *= alpha;
#pragma unroll
          for (int j = 0; j < CHUNK; ++j) {
            const T e = exp(s[j] - cm);
            sum += e;
#pragma unroll
            for (int c = 0; c < C; ++c) cv[c] = fma(e, acc[j][C + c], cv[c]);
          }
          mx = cm;
        }
        if (mine) {
          const T inv = T(1) / sum;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            if (hc0 + c < hs.dh) ctx[hd * hs.dh + hc0 + c] = cv[c] * inv;
          }
        }
      }
    } else {
      // A head spans hs.span column blocks, a team's lanes each: per chunk,
      // its K block by block, the scores summed over the blocks and the
      // team; then its V block by block into the context, which each lane
      // keeps for its own columns in ctx and rescales there.
      for (int hd = 0; hd < H; ++hd) {
        T mx = -INFINITY, sum = T(0);
        for (int j0 = 0; j0 < lag; j0 += CHUNK) {
          T s[CHUNK];
#pragma unroll
          for (int j = 0; j < CHUNK; ++j) s[j] = T(0);
          for (int sb = 0; sb < hs.span; ++sb) {
            const int hc0 = sb * CB<T> + l * C;
            T acc[CHUNK][C], qv[C];
            kv_chunk<1>(h + j0 * V, LP * V, sm + (hd * hs.span + sb) * D4 * WR + l * C, D4,
                        acc);
#pragma unroll
            for (int c = 0; c < C; ++c) qv[c] = hc0 + c < hs.dh ? q[hd * hs.dh + hc0 + c] : T(0);
#pragma unroll
            for (int j = 0; j < CHUNK; ++j)
#pragma unroll
              for (int c = 0; c < C; ++c) s[j] = fma(qv[c], acc[j][c], s[j]);
          }
          team_sums(s);
          T cm = mx;
#pragma unroll
          for (int j = 0; j < CHUNK; ++j) {
            s[j] = j0 + j < lag ? s[j] * scale : T(-INFINITY);
            cm = s[j] > cm ? s[j] : cm;
          }
          const T alpha = exp(mx - cm);
          sum *= alpha;
#pragma unroll
          for (int j = 0; j < CHUNK; ++j) {
            s[j] = exp(s[j] - cm);
            sum += s[j];
          }
          for (int sb = 0; sb < hs.span; ++sb) {
            const int hc0 = sb * CB<T> + l * C;
            T acc[CHUNK][C];
            kv_chunk<1>(h + j0 * V, LP * V, sm + (hd * hs.span + sb) * D4 * WR + CB<T> + l * C,
                        D4, acc);
#pragma unroll
            for (int c = 0; c < C; ++c) {
              if (hc0 + c >= hs.dh) continue;
              T* o = ctx + hd * hs.dh + hc0 + c;
              T cv = j0 ? *o * alpha : T(0);
#pragma unroll
              for (int j = 0; j < CHUNK; ++j) cv = fma(s[j], acc[j][c], cv);
              *o = cv;
            }
          }
          mx = cm;
        }
        const T inv = T(1) / sum;
        for (int c0 = l * C; c0 < hs.span * CB<T>; c0 += CB<T>) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            if (c0 + c < hs.dh) ctx[hd * hs.dh + c0 + c] *= inv;
          }
        }
      }
    }
    __syncwarp();

    // (4) x = x[lag-1] + ctx wo; (5) its norm into y; (6) the MLP's hidden
    // layer; (7) x = (x + hidden w2) + b2.
    product(ctx, V, D, D, wo, L.wo, 2u, [&](int c0, T(&acc)[V]) {
      T v[V];
      load(v, xl + c0);
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] = v[u] + acc[u];
      store(xl + c0, v);
      store(y + c0, v);
    });
    __syncwarp();
    team_norm(y, D, D4, inv_d, l);
    __syncwarp();
    product(y, V, D, M, w1, L.w1, 4u, [&](int c0, T(&acc)[V]) {
      T v[V];
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] = c0 + u < M ? gelu_tanh(acc[u] + sm[L.b1 + c0 + u]) : T(0);
      store(hid + c0, v);
    });
    __syncwarp();
    product(hid, V, M, D, w2, L.w2, 8u, [&](int c0, T(&acc)[V]) {
      T v[V];
      load(v, xl + c0);
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] = c0 + u < D ? (v[u] + acc[u]) + sm[L.b2 + c0 + u] : T(0);
      store(xl + c0, v);
    });
    __syncwarp();

    // (8) the head: each logit's sum split over the lanes (HEAD_GROUP logits
    // at a time, their reductions together), then the softmax.
    for (int a0 = 0; a0 < A1; a0 += HEAD_GROUP) {
      T p[HEAD_GROUP];
#pragma unroll
      for (int g = 0; g < HEAD_GROUP; ++g) p[g] = T(0);
      for (int k = l; k < D; k += TEAM) {
        const T xk = xl[k];
#pragma unroll
        for (int g = 0; g < HEAD_GROUP; ++g) {
          if (a0 + g < A1) p[g] = fma(xk, sm[L.wout + k * A1 + a0 + g], p[g]);
        }
      }
      team_sums(p);
#pragma unroll
      for (int g = 0; g < HEAD_GROUP; ++g) {
        if (a0 + g < A1 && (a0 + g) % TEAM == l) logit[a0 + g] = p[g] + sm[L.bout + a0 + g];
      }
    }
    __syncwarp();
    T m = logit[0];
    for (int a = 1; a < A1; ++a) m = logit[a] > m ? logit[a] : m;
    T own = T(0);
    for (int a = l; a < A1; a += TEAM) own += exp(logit[a] - m);
    const T sum = team_sum(own);
    if (r < n) {
      for (int a = l; a < A1; a += TEAM) out[r * A1 + a] = exp(logit[a] - m) / sum;
    }
  }
  copy_async_wait();  // nothing left in flight at exit
}

template <typename T>
cudaError_t launch(const void* const* p, void* out, int64_t n, int lag, int A1, int D, int H,
                   int M, int warps, int blocks, bool resident, double scale,
                   cudaStream_t stream) {
  const Layout L = layout<T>(warps, lag, A1, D, H, M, resident);
  const size_t smem = static_cast<size_t>(L.total) * sizeof(T);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  // Heads wider than a column block take the instance that spans blocks.
  auto kernel = heads_of(D, H, VEC<T>).span > 1 ? attention_forward_kernel<T, true>
                                                : attention_forward_kernel<T, false>;
  // As little shared memory as the block needs: the rest of the SM's 256 KB
  // is L1, which holds the weights read from device memory where they are
  // not resident.
  const int carveout = static_cast<int>((smem + 1024) * 100 / SMEM_SM) + 1;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         carveout < 100 ? carveout : 100);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // 16-byte weight loads where a matrix's rows allow them: wq, wo, w1, w2.
  const auto aligned = [](const void* q, int cols) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0 && cols % VEC<T> == 0;
  };
  const unsigned vec = (aligned(p[3], D) ? 1u : 0u) | (aligned(p[4], D) ? 2u : 0u) |
                       (aligned(p[5], M) ? 4u : 0u) | (aligned(p[7], D) ? 8u : 0u);
  kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]), static_cast<const T*>(p[2]),
      static_cast<const T*>(p[3]), static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
      static_cast<const T*>(p[6]), static_cast<const T*>(p[7]), static_cast<const T*>(p[8]),
      static_cast<const T*>(p[9]), static_cast<const T*>(p[10]), static_cast<T*>(out), n, lag, A1,
      D, H, M, static_cast<T>(scale), vec, resident);
  return cudaGetLastError();
}

}  // namespace

// x [n, lag, A1] and the attention AR's parameters in checkpoint order
// (embed [A1, D], pos [lag, D], wqkv [3, D, D], wo [D, D], w1 [D, M], b1 [M],
// w2 [M, D], b2 [D], w_out [D, A1], b_out [A1]), all contiguous, of float
// (itemsize 4) or double (8), on one card; out [n, A1]. `warps` (1 to 8) a
// block, `blocks` blocks, and wq, wo, w1 and w2 in shared memory where
// `resident` (ops/attention_forward.py launch_shape); `scale`
// is 1 / sqrt(D / H). Launched on `stream`; returns a cudaError_t (0:
// launched; cudaErrorInvalidValue where the widths or the shape are none the
// kernel takes, or the block does not fit shared memory).
extern "C" int attention_forward_launch(const void* x, const void* embed, const void* pos,
                                        const void* wqkv, const void* wo, const void* w1,
                                        const void* b1, const void* w2, const void* b2,
                                        const void* w_out, const void* b_out, void* out,
                                        int64_t n, int32_t lag, int32_t A1, int32_t D,
                                        int32_t H, int32_t M, int32_t itemsize, int32_t warps,
                                        int32_t blocks, int32_t resident, double scale,
                                        void* stream) {
  if (n < 1 || lag < 1 || A1 < 1 || D < 1 || H < 1 || D % H != 0 || M < 1 || warps < 1 ||
      warps * 32 > MAX_THREADS || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* p[11] = {x, embed, pos, wqkv, wo, w1, b1, w2, b2, w_out, b_out};
  auto st = static_cast<cudaStream_t>(stream);
  if (itemsize == 4) {
    return static_cast<int>(launch<float>(p, out, n, lag, A1, D, H, M, warps, blocks,
                                          resident != 0, scale, st));
  }
  if (itemsize == 8) {
    return static_cast<int>(launch<double>(p, out, n, lag, A1, D, H, M, warps, blocks,
                                           resident != 0, scale, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
