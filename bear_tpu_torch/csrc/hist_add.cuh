// hist_add.cuh: the histogram update that window_hist.cu and count_chunk.cu
// share.
//
// One count at table[key] for a key in [0, n_table); any other key is
// dropped (the contract of bear_tpu's sorted_window_update, including its
// drop of negative keys). The result of the atomicAdd is unused, so it
// compiles to a fire-and-forget RED op that L2 applies.

#pragma once

#include <cstdint>

__device__ __forceinline__ void hist_add(int* __restrict__ table, int key,
                                         int64_t n_table) {
  if (key >= 0 && static_cast<int64_t>(key) < n_table) {
    atomicAdd(table + key, 1);
  }
}
