// Hopper (sm_90a) building blocks of the flash-attention kernels' bf16
// bodies: bf16 tiles in shared memory in the layout that wgmma's matrix
// descriptors read, cp.async copies into that layout, the descriptors,
// the wgmma products (m64nNk16, bf16 in, float32 accumulate) and their
// fences and waits, and the accumulator-to-operand conversion.
//
// Tile layout. A tile is 64 rows of D bf16 (D in {64, 128}), one row of a
// [B, S, NH, D] tensor each. It is stored as D / 64 column halves; a half
// is [64 rows][128 bytes] = 8 KB on a 1024-byte boundary, and row r's
// 16-byte chunk c (columns 8c .. 8c + 7 of the half) lies at byte
//   r * 128 + ((c ^ (r % 8)) * 16)
// of it: the 128-byte swizzle (layout type 1 of the descriptor, cute's
// Swizzle<3,4,3>), which spreads the eight rows of a core matrix over all
// 32 banks. wgmma reads one tile two ways:
//   K-major (desc_kmajor): rows are M or N, the D columns the reduction;
//     k-step kk (16 columns) starts 32 * (kk % 4) bytes into half kk / 4,
//     8-row groups 1024 bytes apart (SBO). S = q . k^T reads q and k so.
//   MN-major (desc_mnmajor, transpose bit set): rows are the reduction,
//     the D columns are N; k-step kk (16 rows) starts at row 16 kk, 8-row
//     groups 1024 bytes apart (SBO), the second 64-column half 8 KB on
//     (LBO). dQ += dS . k reads k so, and O += P . v reads v.
// So every tile is copied once, in one layout, and read by both products.
//
// Copies. cp.async.cg 16-byte copies, one chunk a thread at a time,
// consecutive threads on consecutive chunks of a row; a row at or past
// the sequence end is filled with zeros (src-size 0), so the ragged edge
// needs no padding copy. cp.async writes through the generic proxy and
// wgmma reads through the async proxy: a thread's copies are made
// visible to wgmma by cp.async.wait_group, fence.proxy.async and a
// barrier, in that order (ready_for_wgmma).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {
namespace sm90 {

constexpr int kRows = 64;                 // rows of a tile and of a wgmma
constexpr int kHalfBytes = kRows * 128;   // one 64-column half of a tile

template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return kRows * D * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- copies

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// After cp_async_wait: make every thread's copies visible to wgmma.
__device__ __forceinline__ void ready_for_wgmma() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// Copy rows [row0, row0 + 64) of head `head` of a [B, S, NH, D] bf16
// tensor into the tile at shared address `tile`; rows >= S are zeros.
template <int D, int kThreads>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const __nv_bfloat16* src, int b,
                                          int row0, int S, int NH, int head,
                                          int tid) {
  constexpr int kChunks = D / 8;   // 16-byte chunks a row
  static_assert(kRows * kChunks % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int j = 0; j < kRows * kChunks / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int row = row0 + r;
    const bool valid = row < S;
    const __nv_bfloat16* g =
        src + (((size_t)b * S + (valid ? row : 0)) * NH + head) * D + c * 8;
    cp_async16(tile + (c / 8) * kHalfBytes + r * 128 +
                   (((c % 8) ^ (r % 8)) * 16),
               g, valid);
  }
}

// ----------------------------------------------------------- descriptors

// wgmma shared-memory matrix descriptor with the 128-byte swizzle:
// start address, leading and stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// k-step kk (16 of the D columns) of a tile read K-major
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return make_desc(tile + (kk / 4) * kHalfBytes + (kk % 4) * 32, 16, 1024);
}

// k-step kk (16 of the 64 rows) of a tile read MN-major
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * 128, kHalfBytes, 1024);
}

// ------------------------------------------------------ fences and waits

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// a wgmma fence or wait (the asm statements do not name the registers
// the hardware writes asynchronously).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// --------------------------------------------------------------- products

#define FLASH_R8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FLASH_ACC32 FLASH_R8(0), FLASH_R8(8), FLASH_R8(16), FLASH_R8(24)
#define FLASH_ACC64 \
  FLASH_ACC32, FLASH_R8(32), FLASH_R8(40), FLASH_R8(48), FLASH_R8(56)

// d += A . B for a 64 x 64 tile, k16; A and B from shared memory, both
// K-major.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FLASH_ACC32
      : "l"(a), "l"(b), "r"(1));
}

// d += A . B for a 64 x 32 tile, k16; A and B from shared memory, both
// K-major.
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : FLASH_R8(0), FLASH_R8(8)
      : "l"(a), "l"(b), "r"(1));
}

// d += A . B, k16, A (64 x 16 bf16) from registers in the fragment
// layout of A, B from shared memory MN-major; N = 64.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FLASH_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// the same with N = 128
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FLASH_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef FLASH_ACC64
#undef FLASH_ACC32
#undef FLASH_R8

// ------------------------------------------------- accumulator fragments
//
// A 64 x N float32 accumulator is spread over the warpgroup's 128
// threads: thread (warp w, lane l) holds N / 2 values, element 4j + e at
//   row 16 w + l / 4 + 8 (e / 2),  column 8 j + 2 (l % 4) + (e % 2).
// The register A operand of a k16 step takes, per thread, the same rows
// and columns 16 kk .. 16 kk + 15 as four bf16 pairs, so the accumulator
// elements 8 kk .. 8 kk + 7 pack into k-step kk's operand in order, with
// no exchange between threads (FA3 does the same for P).

__device__ __forceinline__ int acc_row(int tid, int e) {
  return 16 * (tid / 32) + (tid % 32) / 4 + 8 * (e / 2);
}
__device__ __forceinline__ int acc_col(int tid, int j, int e) {
  return 8 * j + 2 * (tid % 4) + (e % 2);
}

// Round two float32 values to bf16 (round to nearest even) as one pair,
// `lo` in the low half: the one rounding of P and dS.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// k-step kk's A operand from elements 8 kk .. 8 kk + 7 of a 64 x 2N
// accumulator tile.
template <int N>
__device__ __forceinline__ void to_operand(const float (&x)[N], int kk,
                                           uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

}  // namespace sm90
}  // namespace flash
