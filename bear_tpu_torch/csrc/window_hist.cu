// window_hist.cu: add one count at each key of an int32 key vector into a
// dense int32 table, in place.
//
// Replaces the TPU kernel bear_tpu/counting/pallas_hist.py:81 (_hist_kernel,
// driven by sorted_window_update). That kernel sorted the keys and turned
// each 32768-entry table window's keys into one_hot(hi)^T @ one_hot(lo) int8
// matmuls, because scatter-add on the TPU is a serial apply at ~10 ns per
// element. Hopper has hardware atomics in L2, so the sort and the matmuls are
// not carried over: each key is one fire-and-forget atomicAdd (a RED op).
//
// Contract (that of sorted_window_update): keys in any order with any
// duplication; keys < 0 or >= n_table are dropped. The counting engine sends
// masked transitions to the sentinel n_table.
//
// What bounds it: bytes. The keys are read once (4 bytes each) and every
// 32-byte table sector a valid key touches is read and written once in L2 /
// HBM; there is no arithmetic to speak of. The design streams the keys with
// 16-byte vector loads (4 keys per thread per step, grid-stride) so the key
// read runs at full width, and lets L2 merge repeated atomics to one sector.
// The counting engine's main path no longer sends keys here: count_chunk.cu
// generates them in registers and applies the same update (hist_add.cuh).

#include <cstdint>
#include <cuda_runtime.h>

#include "hist_add.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void window_hist_kernel(int* __restrict__ table,
                                   const int* __restrict__ keys,
                                   int64_t n_keys, int64_t n_table,
                                   bool vec4) {
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t done = 0;
  if (vec4) {
    const int64_t n_vec = n_keys / 4;
    const int4* keys4 = reinterpret_cast<const int4*>(keys);
    for (int64_t i = tid; i < n_vec; i += stride) {
      const int4 k = keys4[i];
      hist_add(table, k.x, n_table);
      hist_add(table, k.y, n_table);
      hist_add(table, k.z, n_table);
      hist_add(table, k.w, n_table);
    }
    done = n_vec * 4;
  }
  for (int64_t i = done + tid; i < n_keys; i += stride) {
    hist_add(table, keys[i], n_table);
  }
}

}  // namespace

// table: int32 [n_table] on the device; keys: int32 [n_keys] on the same
// device; stream: a cudaStream_t. Returns cudaGetLastError() after the
// launch (0 on success). Does not synchronise.
extern "C" int window_hist_launch(void* table, const void* keys,
                                  int64_t n_keys, int64_t n_table,
                                  void* stream) {
  if (n_keys <= 0) {
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
  const bool vec4 = (reinterpret_cast<uintptr_t>(keys) % 16) == 0;
  const int64_t per_thread = vec4 ? 4 : 1;
  const int64_t want =
      (n_keys + per_thread * kThreads - 1) / (per_thread * kThreads);
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  window_hist_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(table), static_cast<const int*>(keys), n_keys,
      n_table, vec4);
  return static_cast<int>(cudaGetLastError());
}
