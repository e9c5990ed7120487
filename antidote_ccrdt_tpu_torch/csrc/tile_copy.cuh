// Block-wide copy of a tile of int32 cells, shared by the tile kernels
// (K1c: device to device memory; K2: shared to device memory).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// n int32 cells from src to dst by the whole block. When both are 16-byte
// aligned, each thread loads up to kBatch 16-byte vectors before it stores
// them, so a block keeps kBatch * 16 bytes per thread in flight; 4-byte
// accesses otherwise. kStream marks the stores evict-first (st.global.cs),
// for an output tile that nothing else in the kernel reads: it then does
// not push the kernel's inputs out of L2. Only for a dst in device memory.
template <bool kStream = false, int kBatch = 8>
__device__ __forceinline__ void copy_cells(int32_t* __restrict__ dst,
                                           const int32_t* __restrict__ src,
                                           int64_t n) {
  int64_t i0 = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) &
       15) == 0) {
    const int64_t n4 = n >> 2;
    int4* d4 = reinterpret_cast<int4*>(dst);
    const int4* s4 = reinterpret_cast<const int4*>(src);
    for (int64_t base = threadIdx.x; base < n4;
         base += (int64_t)blockDim.x * kBatch) {
      int4 v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int64_t i = base + (int64_t)b * blockDim.x;
        if (i < n4) v[b] = s4[i];
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int64_t i = base + (int64_t)b * blockDim.x;
        if (i >= n4) continue;
        if (kStream)
          __stcs(d4 + i, v[b]);
        else
          d4[i] = v[b];
      }
    }
    i0 = n4 << 2;
  }
  for (int64_t i = i0 + threadIdx.x; i < n; i += blockDim.x) {
    if (kStream)
      __stcs(dst + i, src[i]);
    else
      dst[i] = src[i];
  }
}
