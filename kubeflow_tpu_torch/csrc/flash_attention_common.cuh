// Shared pieces of the three flash-attention kernels for Hopper (sm_90a):
// flash_attention_fwd.cu, flash_attention_dq.cu, flash_attention_dkv.cu.
//
// Layout. q, o, dO, dq are [B, Sq, H, D]; k, v, dk, dv are [B, Skv, KV_H, D]
// (the public layout, contiguous, read in place: no [B, H, S, D] transpose
// copy is made); lse and delta are [B, H, Sq] float32. Query head h reads
// KV head h / (H / KV_H): KV heads are never repeated.
//
// Tiles. Every kernel works on 64-row query blocks and 64-row KV blocks. A
// tile is staged in shared memory as float32 with a row stride of D + 1
// words, so that both access patterns the kernels use are free of bank
// conflicts: sixteen threads reading sixteen different rows at one column
// (row stride D + 1 is odd, so the rows fall in different banks), and
// sixteen threads reading one row at sixteen consecutive columns. Global
// reads are 16-byte vectors along a D-row. Rows at or past the sequence
// end are staged as zeros and never written back: the kernels mask the
// ragged edge themselves, with no padding copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

// Reduce over the 16 lanes that share bits 4.. of the lane id (one
// half-warp): the threads that own one row of a tile.
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage rows [row0, row0 + 64) of head `head` of a [B, S, NH, D] tensor
// into `dst` ([64][D + 1] float32), multiplied by `mul`; rows >= S are
// zeros. `nthreads` threads cooperate; consecutive threads load
// consecutive 16-byte pieces of one D-row.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int b,
                                           int row0, int S, int NH,
                                           int head, float mul, int tid,
                                           int nthreads) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  for (int i = tid; i < 64 * kVecPerRow; i += nthreads) {
    const int t = i / kVecPerRow;
    const int c = (i - t * kVecPerRow) * kVec;
    const int row = row0 + t;
    float* d = dst + t * (D + 1) + c;
    if (row < S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (((size_t)b * S + row) * NH + head) * D + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int x = 0; x < kVec; ++x) d[x] = to_float(e[x]) * mul;
    } else {
#pragma unroll
      for (int x = 0; x < kVec; ++x) d[x] = 0.f;
    }
  }
}

// Opt a kernel into `bytes` of dynamic shared memory (above 48 KB this is
// required); returns the CUDA error code.
template <typename Kernel>
inline int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The limits every entry point checks before launching.
inline bool geometry_ok(int B, int Sq, int Skv, int H, int KVH, int D) {
  return B > 0 && Sq > 0 && Skv > 0 && KVH > 0 && H % KVH == 0 &&
         (D == 64 || D == 128) && B <= 65535 && H <= 65535;
}

}  // namespace flash
