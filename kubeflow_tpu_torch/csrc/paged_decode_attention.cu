// Paged grouped-query DECODE attention for Hopper (sm_90a).
//
// Replaces the TPU kernel kubeflow_tpu/ops/pallas_paged_attention.py
// (`_decode_kernel`, unquantized form, reached through
// `paged_decode_attention`): one query row per slot attends to the KV rows
// held in the pool blocks its block-table row names, walking only the
// ceil(kv_len / bs) live blocks. Online softmax in f32 with scale 1/sqrt(D)
// and mask value -1e30 at positions >= kv_len; P.V accumulates in f32; the
// output is acc / max(l, 1e-30) in q's dtype. A slot with no live block
// (kv_len == 0) writes zeros.
//
// Shapes: q [B, H, D]; k_pool, v_pool [NB, bs, KV_H, D] (bf16 or f32, the
// same dtype as q); tables [B, max_blocks] int32; kv_len [B] int32 counting
// this step's row; out [B, H, D]. D in {64, 128}, bs <= 64, H / KV_H <= 8.
//
// Design. One thread block of 128 threads per (KV head, slot): it holds
// that head's G = H / KV_H query rows (pre-scaled, f32, in shared memory)
// and walks the slot's live table entries itself (on the TPU, scalar
// prefetch brought them in). Per block it stages the [bs, D] K and V tiles
// in shared memory with 16-byte loads, computes the G x bs logits (one warp
// per token, lanes across D, shuffle reduction), runs the online-softmax
// update (one warp per query row) and accumulates P.V in registers (each
// thread owns G*D/128 output elements). K/V of a head are read once per
// slot, never repeated per query head.
//
// Bound. At decode shapes the work is a few FLOPs per KV byte, so the
// kernel is bound by the bytes of the KV rows below kv_len (plus q and
// out): the least time is those bytes over the card's 3.35 TB/s. The
// kernel reads exactly those rows, not the dead tail of a slot's last
// block. What this first design leaves on the table: its (KV head, slot)
// grid gives only B * KV_H blocks -- 64 at the serving smoke's shape
// (B=8, KV_H=8) on 132 SMs -- and each block loads a tile, then computes,
// with no overlap.
// Splitting each slot's blocks over several thread blocks with a second
// reduction pass (flash-decoding) and a cp.async/TMA pipeline are the next
// steps; both are later work.
//
// Quantized pools (second C entry, kft_paged_decode_attention_quant).
// Replaces the same TPU kernel's `quantized=True` form
// (pallas_paged_attention.py:68-74, 100-106, 127-128): the pools are int8
// or fp8 e4m3 (__nv_fp8_e4m3, the e4m3fn encoding) with per-block
// per-KV-head f32 scales k_scale/v_scale [NB, KV_H]. The body is the same
// template, instantiated on the pool's storage type: tiles are staged in
// shared memory at one byte per element (a D = 128 row is eight 16-byte
// loads), the CTA reads its two scale words per live block beside its
// table entry, and each K/V element is upcast to f32 and multiplied by its
// block's scale where the tile is read, before the FMA. The dequantized
// value is never rounded to q's dtype, and the summation order is the
// unquantized kernel's, so over an f32 q the quantized kernel equals the
// unquantized kernel over the f32 dequant view bit for bit. Bound: the
// same walk over half (bf16) or a quarter (f32) of the K/V bytes, plus
// 8 bytes of scales per live block and KV head; the design leaves the same
// things on the table as the unquantized form (64 CTAs at the serving
// shape, no load/compute overlap), so it is bound by the serial walk, not
// the bytes.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 8;
constexpr int kMaxBlockSize = 64;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxAcc = kMaxGroups * kMaxHeadDim / kThreads;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Bytes of shared memory before the K/V tiles (f32 q rows, logits/probs,
// running max, running sum, rescale factor), rounded up to 16.
__host__ __device__ inline size_t scalar_smem_bytes(int G, int D, int bs) {
  size_t n = (size_t)(G * D + G * bs + 3 * G) * sizeof(float);
  return (n + 15) & ~(size_t)15;
}

// T: q/out type (float or bf16). KV: the pool's storage type -- T itself
// (unquantized) or a one-byte type (int8_t, __nv_fp8_e4m3), which makes
// the kernel read k_scale/v_scale (else they are null and unread).
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k_pool,
                    const KV* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const int* __restrict__ kv_len, T* __restrict__ out,
                    int H, int KVH, int D, int bs, int max_blocks,
                    float scale) {
  constexpr bool kQuant = sizeof(KV) == 1;
  const int h = blockIdx.x;  // KV head
  const int b = blockIdx.y;  // slot
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_out = G * D;  // this block's output elements

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [G, D]
  float* p_s = q_s + G * D;                     // [G, bs]
  float* m_s = p_s + G * bs;                    // [G]
  float* l_s = m_s + G;                         // [G]
  float* a_s = l_s + G;                         // [G]
  KV* k_s = reinterpret_cast<KV*>(smem + scalar_smem_bytes(G, D, bs));
  KV* v_s = k_s + bs * D;  // [bs, D] each

  const int len = kv_len[b];
  int n_live = len > 0 ? (len + bs - 1) / bs : 0;
  if (n_live > max_blocks) n_live = max_blocks;
  T* out_rows = out + ((size_t)b * H + (size_t)h * G) * D;
  if (n_live == 0) {
    for (int e = tid; e < n_out; e += kThreads) store(out_rows + e, 0.f);
    return;
  }

  const T* q_rows = q + ((size_t)b * H + (size_t)h * G) * D;
  for (int e = tid; e < n_out; e += kThreads)
    q_s[e] = to_float(q_rows[e]) * scale;
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  const int* table_row = tables + (size_t)b * max_blocks;
  const size_t row_stride = (size_t)KVH * D;  // elements between token rows
  constexpr int kVec = 16 / sizeof(KV);       // elements per 16-byte load
  const int vecs_per_row = D / kVec;
  __syncthreads();

  for (int j = 0; j < n_live; ++j) {
    const int blk = table_row[j];
    const size_t base = ((size_t)blk * bs * KVH + h) * D;
    const int valid = min(bs, len - j * bs);  // >= 1 for a live block
    // this block's dequant scales for head h (1.0 and unread unquantized)
    float ks = 1.f, vs = 1.f;
    if constexpr (kQuant) {
      ks = k_scale[(size_t)blk * KVH + h];
      vs = v_scale[(size_t)blk * KVH + h];
    }
    // stage the head's K and V rows below kv_len (the dead tail of the
    // last block is never read): consecutive threads load consecutive
    // 16-byte pieces of one D-row
    const int n_vec = valid * vecs_per_row;
    for (int i = tid; i < n_vec; i += kThreads) {
      const int t = i / vecs_per_row;
      const int c = (i - t * vecs_per_row) * kVec;
      const size_t src = base + (size_t)t * row_stride + c;
      *reinterpret_cast<uint4*>(k_s + t * D + c) =
          *reinterpret_cast<const uint4*>(k_pool + src);
      *reinterpret_cast<uint4*>(v_s + t * D + c) =
          *reinterpret_cast<const uint4*>(v_pool + src);
    }
    __syncthreads();

    // logits: one warp per token, lanes across D; rows past kv_len get
    // the mask value without touching their (unstaged) tile rows
    for (int t = warp; t < bs; t += kWarps) {
      if (t >= valid) {
        if (lane < G) p_s[lane * bs + t] = kNegInf;
        continue;
      }
      float part[kMaxGroups];
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) part[g] = 0.f;
      for (int d = lane; d < D; d += 32) {
        float kd = to_float(k_s[t * D + d]);
        if constexpr (kQuant) kd *= ks;  // dequant before the FMA
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g)
          if (g < G) part[g] += q_s[g * D + d] * kd;
      }
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        if (g < G) {
          const float s = warp_sum(part[g]);
          if (lane == 0) p_s[g * bs + t] = s;
        }
      }
    }
    __syncthreads();

    // online-softmax update: one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, p_s[g * bs + t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const float p = expf(p_s[g * bs + t] - m_new);
        p_s[g * bs + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // P.V into the running accumulator (masked rows have p == 0 and are
    // skipped, so never-written pool rows cannot leak in)
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int e = tid + i * kThreads;
      if (e < n_out) {
        const int g = e / D;
        const int d = e - g * D;
        const float* p_row = p_s + g * bs;
        float s = 0.f;
        for (int t = 0; t < valid; ++t) {
          float vd = to_float(v_s[t * D + d]);
          if constexpr (kQuant) vd *= vs;  // dequant before the FMA
          s += p_row[t] * vd;
        }
        acc[i] = acc[i] * a_s[g] + s;
      }
    }
    __syncthreads();  // the next block overwrites the tiles and p_s
  }

#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < n_out) {
      const int g = e / D;
      store(out_rows + e, acc[i] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T, typename KV>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* tables,
           const void* kv_len, void* out, int B, int H, int KVH, int D,
           int bs, int max_blocks, float scale, cudaStream_t stream) {
  const int G = H / KVH;
  const size_t smem =
      scalar_smem_bytes(G, D, bs) + 2 * (size_t)bs * D * sizeof(KV);
  static size_t smem_opted_in = 48 * 1024;
  if (smem > smem_opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_opted_in = smem;
  }
  dim3 grid(KVH, B);
  paged_decode_kernel<T, KV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(kv_len), static_cast<T*>(out), H, KVH, D, bs,
      max_blocks, scale);
  return (int)cudaGetLastError();
}

bool geometry_ok(int B, int H, int KVH, int D, int bs, int max_blocks) {
  return B > 0 && KVH > 0 && H % KVH == 0 && H / KVH <= kMaxGroups &&
         (D == 64 || D == kMaxHeadDim) && bs > 0 && bs <= kMaxBlockSize &&
         max_blocks > 0;
}

template <typename KV>
int launch_quant(int dtype, const void* q, const void* k_pool,
                 const void* v_pool, const void* k_scale,
                 const void* v_scale, const void* tables, const void* kv_len,
                 void* out, int B, int H, int KVH, int D, int bs,
                 int max_blocks, float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch<float, KV>(q, k_pool, v_pool, k_scale, v_scale, tables,
                             kv_len, out, B, H, KVH, D, bs, max_blocks,
                             scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, KV>(q, k_pool, v_pool, k_scale, v_scale,
                                     tables, kv_len, out, B, H, KVH, D, bs,
                                     max_blocks, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); cudaErrorInvalidValue for shapes the kernel does
// not take. Launches on `stream`, does not synchronize, allocates nothing.
extern "C" int kft_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* kv_len, void* out, int B, int H,
    int KVH, int D, int bs, int max_blocks, float scale, int dtype,
    void* stream) {
  if (!geometry_ok(B, H, KVH, D, bs, max_blocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(q, k_pool, v_pool, nullptr, nullptr, tables,
                                kv_len, out, B, H, KVH, D, bs, max_blocks,
                                scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, v_pool, nullptr, nullptr, tables, kv_len, out, B, H, KVH,
        D, bs, max_blocks, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The quantized form: k_pool/v_pool [NB, bs, KV_H, D] int8 (kv_dtype 0) or
// fp8 e4m3 (kv_dtype 1); k_scale/v_scale [NB, KV_H] float32; q/out as
// above (dtype 0 = float32, 1 = bfloat16). Same return convention.
extern "C" int kft_paged_decode_attention_quant(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* kv_len, void* out, int B, int H, int KVH, int D, int bs,
    int max_blocks, float scale, int dtype, int kv_dtype, void* stream) {
  if (!geometry_ok(B, H, KVH, D, bs, max_blocks) || k_scale == nullptr ||
      v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 0)
    return launch_quant<int8_t>(dtype, q, k_pool, v_pool, k_scale, v_scale,
                                tables, kv_len, out, B, H, KVH, D, bs,
                                max_blocks, scale, s);
  if (kv_dtype == 1)
    return launch_quant<__nv_fp8_e4m3>(dtype, q, k_pool, v_pool, k_scale,
                                       v_scale, tables, kv_len, out, B, H,
                                       KVH, D, bs, max_blocks, scale, s);
  return (int)cudaErrorInvalidValue;
}
