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
// Design (flash-decoding: each slot's walk split over thread blocks, then
// a combine pass). Pass 1, paged_decode_kernel: one thread block of 128
// threads per (split s, KV head, slot). Split s walks the slot's live
// blocks [s P, min((s + 1) P, n_live)), P = blocks_per_split; it holds the
// head's G = H / KV_H query rows (pre-scaled, f32, in shared memory) and
// runs the online softmax over its blocks: per block the [bs, D] K and V
// tiles are in shared memory, the G x bs logits are computed (one warp
// per token, lanes across D, shuffle reduction), the online-softmax update
// runs (one warp per query row) and P.V accumulates in registers (each
// thread owns G*D/128 output elements). The next block's tiles are copied
// by cp.async into the other of two buffers while the current block is
// computed (a split walks 64 KV rows: one block at the serving block size
// of 64, so there each split's copies overlap only other splits' work).
// The split writes its unnormalised partial (acc [G, D], m, l,
// f32) to a workspace the caller allocates; splits past the slot's live
// count exit at once. Pass 2, paged_decode_combine: one thread block of D
// threads per (query head, slot) merges the slot's partials in split
// order, out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30)
// with M = max_s m_s, and writes the output in q's dtype (zeros for a
// slot with no live block). Both passes launch from one C entry on one
// stream. K/V of a head are read once per slot, never repeated per query
// head.
//
// The split length P is fixed by the caller from the block size alone,
// and the split count from the table width (ops/paged_attention.
// split_plan), never from B, KV_H or the other slots: a slot's output is
// the same whatever else shares its batch, one rank's heads under tensor
// parallelism give bitwise what the unsharded launch gives them, and a
// slot whose live blocks fit one split gives bitwise what the serial walk
// gave.
//
// Bound. At decode shapes the work is a few FLOPs per KV byte, so the
// kernel is bound by the bytes of the KV rows below kv_len (plus q and
// out): the least time is those bytes over the card's 3.35 TB/s. The
// kernel reads exactly those rows, not the dead tail of a slot's last
// block. At the serving shape the bound is a few microseconds, so the two
// launches' latency, not the bytes, sets the time.
//
// Quantized pools (second C entry, kft_paged_decode_attention_quant).
// Replaces the same TPU kernel's `quantized=True` form
// (pallas_paged_attention.py:68-74, 100-106, 127-128): the pools are int8
// or fp8 e4m3 (__nv_fp8_e4m3, the e4m3fn encoding) with per-block
// per-KV-head f32 scales k_scale/v_scale [NB, KV_H]. The body is the same
// template, instantiated on the pool's storage type: tiles are staged in
// shared memory at one byte per element (a D = 128 row is eight 16-byte
// copies), the CTA reads its two scale words per live block beside its
// table entry, and each K/V element is upcast to f32 and multiplied by its
// block's scale where the tile is read, before the FMA. The dequantized
// value is never rounded to q's dtype, and the summation order (split and
// combine included) is the unquantized kernel's, so over an f32 q the
// quantized kernel equals the unquantized kernel over the f32 dequant view
// bit for bit. Bound: the same walk over half (bf16) or a quarter (f32)
// of the K/V bytes, plus 8 bytes of scales per live block and KV head.

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

// Shared memory of pass 1: the scalars, then two buffers of K and V tiles.
template <typename KV>
size_t split_smem_bytes(int G, int D, int bs) {
  return scalar_smem_bytes(G, D, bs) + 4 * (size_t)bs * D * sizeof(KV);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The slot's live block count: ceil(kv_len / bs), clamped at the table
// width.
__device__ __forceinline__ int live_blocks(int len, int bs, int max_blocks) {
  const int n = len > 0 ? (len + bs - 1) / bs : 0;
  return n < max_blocks ? n : max_blocks;
}

// Copy the head's K and V rows below kv_len of pool block `blk` into
// k_s / v_s ([bs, D] each) by cp.async (the dead tail of the last block is
// never read): consecutive threads copy consecutive 16-byte pieces of one
// D-row. The caller commits.
template <typename KV>
__device__ __forceinline__ void stage_block(KV* k_s, KV* v_s,
                                            const KV* k_pool,
                                            const KV* v_pool, int blk,
                                            int valid, int h, int KVH,
                                            int D, int bs, int tid) {
  constexpr int kVec = 16 / sizeof(KV);   // elements per 16-byte copy
  const int vecs_per_row = D / kVec;
  const size_t base = ((size_t)blk * bs * KVH + h) * D;
  const size_t row_stride = (size_t)KVH * D;   // elements between rows
  const int n_vec = valid * vecs_per_row;
  for (int i = tid; i < n_vec; i += kThreads) {
    const int t = i / vecs_per_row;
    const int c = (i - t * vecs_per_row) * kVec;
    const size_t src = base + (size_t)t * row_stride + c;
    cp_async16(k_s + t * D + c, k_pool + src);
    cp_async16(v_s + t * D + c, v_pool + src);
  }
}

// Pass 1. T: q's type (float or bf16). KV: the pool's storage type -- T
// itself (unquantized) or a one-byte type (int8_t, __nv_fp8_e4m3), which
// makes the kernel read k_scale/v_scale (else they are null and unread).
// Writes split s's partial: acc to ws_acc[b, h G + g, s, :], m and l to
// ws_m / ws_l[b, h G + g, s].
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k_pool,
                    const KV* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const int* __restrict__ kv_len,
                    float* __restrict__ ws_acc, float* __restrict__ ws_m,
                    float* __restrict__ ws_l, int H, int KVH, int D, int bs,
                    int max_blocks, int blocks_per_split, int n_split,
                    float scale) {
  constexpr bool kQuant = sizeof(KV) == 1;
  const int split = blockIdx.x;
  const int h = blockIdx.y;  // KV head
  const int b = blockIdx.z;  // slot
  const int len = kv_len[b];
  const int n_live = live_blocks(len, bs, max_blocks);
  const int j0 = split * blocks_per_split;
  if (j0 >= n_live) return;   // past the slot's live blocks
  const int j1 = min(j0 + blocks_per_split, n_live);

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
  KV* tiles = reinterpret_cast<KV*>(smem + scalar_smem_bytes(G, D, bs));
  // buffer u: K at tiles + 2 u bs D, V bs D after it

  const int* table_row = tables + (size_t)b * max_blocks;
  stage_block(tiles, tiles + bs * D, k_pool, v_pool, table_row[j0],
              min(bs, len - j0 * bs), h, KVH, D, bs, tid);
  cp_async_commit();

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

  for (int j = j0; j < j1; ++j) {
    const int u = (j - j0) & 1;
    const KV* k_s = tiles + 2 * u * bs * D;
    const KV* v_s = k_s + bs * D;
    if (j + 1 < j1) {   // the next block's tiles into the other buffer
      KV* nk = tiles + 2 * (u ^ 1) * bs * D;
      stage_block(nk, nk + bs * D, k_pool, v_pool, table_row[j + 1],
                  min(bs, len - (j + 1) * bs), h, KVH, D, bs, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // every thread's copies of block j, and q_s / m_s

    const int blk = table_row[j];
    const int valid = min(bs, len - j * bs);  // >= 1 for a live block
    // this block's dequant scales for head h (1.0 and unread unquantized)
    float ks = 1.f, vs = 1.f;
    if constexpr (kQuant) {
      ks = k_scale[(size_t)blk * KVH + h];
      vs = v_scale[(size_t)blk * KVH + h];
    }

    // logits: one warp per token, lanes across D; rows past kv_len get
    // the mask value without touching their (uncopied) tile rows
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
    __syncthreads();  // the next copies reuse this buffer; p_s is rewritten
  }

  // the unnormalised partial of this split
  const size_t row0 = (size_t)b * H + (size_t)h * G;   // first query row
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < n_out) {
      const int g = e / D;
      const int d = e - g * D;
      ws_acc[((row0 + g) * n_split + split) * D + d] = acc[i];
    }
  }
  for (int g = tid; g < G; g += kThreads) {
    ws_m[(row0 + g) * n_split + split] = m_s[g];
    ws_l[(row0 + g) * n_split + split] = l_s[g];
  }
}

// Pass 2: thread d of block (query head h, slot b) merges output column d
// of the slot's ceil(n_live / P) partials in split order. A split whose
// rows were all masked (m = -1e30, l = 0) weighs exp(-1e30 - M) = 0 when
// another split is live, and yields 0 / 1e-30 = 0 when none is.
template <typename T>
__global__ void paged_decode_combine(const float* __restrict__ ws_acc,
                                     const float* __restrict__ ws_m,
                                     const float* __restrict__ ws_l,
                                     const int* __restrict__ kv_len,
                                     T* __restrict__ out, int H, int D,
                                     int bs, int max_blocks,
                                     int blocks_per_split, int n_split) {
  const int h = blockIdx.x;  // query head
  const int b = blockIdx.y;  // slot
  const int d = threadIdx.x;
  const int n_live = live_blocks(kv_len[b], bs, max_blocks);
  const int ns = (n_live + blocks_per_split - 1) / blocks_per_split;
  const size_t row = (size_t)b * H + h;
  T* dst = out + row * D + d;
  if (ns == 0) {   // kv_len 0: zeros
    store(dst, 0.f);
    return;
  }
  const float* m = ws_m + row * n_split;
  const float* l = ws_l + row * n_split;
  const float* acc = ws_acc + row * n_split * D + d;
  float mx = kNegInf;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, m[s]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float w = expf(m[s] - mx);
    den += w * l[s];
    num += w * acc[(size_t)s * D];
  }
  store(dst, num / fmaxf(den, 1e-30f));
}

template <typename T, typename KV>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* tables,
           const void* kv_len, void* out, void* workspace, int B, int H,
           int KVH, int D, int bs, int max_blocks, int blocks_per_split,
           int n_split, float scale, cudaStream_t stream) {
  const int G = H / KVH;
  const size_t smem = split_smem_bytes<KV>(G, D, bs);
  static size_t smem_opted_in = 48 * 1024;
  if (smem > smem_opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_opted_in = smem;
  }
  // workspace: acc [B, H, n_split, D], then m and l [B, H, n_split], f32
  float* ws_acc = static_cast<float*>(workspace);
  float* ws_m = ws_acc + (size_t)B * H * n_split * D;
  float* ws_l = ws_m + (size_t)B * H * n_split;
  paged_decode_kernel<T, KV><<<dim3(n_split, KVH, B), kThreads, smem,
                               stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(kv_len), ws_acc, ws_m, ws_l, H, KVH, D, bs,
      max_blocks, blocks_per_split, n_split, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_combine<T><<<dim3(H, B), D, 0, stream>>>(
      ws_acc, ws_m, ws_l, static_cast<const int*>(kv_len),
      static_cast<T*>(out), H, D, bs, max_blocks, blocks_per_split, n_split);
  return (int)cudaGetLastError();
}

// The split plan must be the one ops/paged_attention.split_plan gives:
// n_split = ceil(max_blocks / blocks_per_split).
bool geometry_ok(int B, int H, int KVH, int D, int bs, int max_blocks,
                 int blocks_per_split, int n_split) {
  return B > 0 && B <= 65535 && KVH > 0 && KVH <= 65535 && H <= 65535 &&
         H % KVH == 0 && H / KVH <= kMaxGroups &&
         (D == 64 || D == kMaxHeadDim) && bs > 0 && bs <= kMaxBlockSize &&
         max_blocks > 0 && blocks_per_split > 0 &&
         n_split == (max_blocks + blocks_per_split - 1) / blocks_per_split;
}

template <typename KV>
int launch_quant(int dtype, const void* q, const void* k_pool,
                 const void* v_pool, const void* k_scale,
                 const void* v_scale, const void* tables, const void* kv_len,
                 void* out, void* workspace, int B, int H, int KVH, int D,
                 int bs, int max_blocks, int blocks_per_split, int n_split,
                 float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch<float, KV>(q, k_pool, v_pool, k_scale, v_scale, tables,
                             kv_len, out, workspace, B, H, KVH, D, bs,
                             max_blocks, blocks_per_split, n_split, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, KV>(q, k_pool, v_pool, k_scale, v_scale,
                                     tables, kv_len, out, workspace, B, H,
                                     KVH, D, bs, max_blocks,
                                     blocks_per_split, n_split, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. workspace: B * H * n_split * (D + 2)
// float32 (the partials); blocks_per_split and n_split from split_plan.
// Returns cudaGetLastError() after the launches (0 on success);
// cudaErrorInvalidValue for shapes the kernel does not take. Launches both
// passes on `stream`, does not synchronize, allocates nothing.
extern "C" int kft_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* kv_len, void* out, void* workspace,
    int B, int H, int KVH, int D, int bs, int max_blocks,
    int blocks_per_split, int n_split, float scale, int dtype,
    void* stream) {
  if (!geometry_ok(B, H, KVH, D, bs, max_blocks, blocks_per_split, n_split))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(q, k_pool, v_pool, nullptr, nullptr, tables,
                                kv_len, out, workspace, B, H, KVH, D, bs,
                                max_blocks, blocks_per_split, n_split, scale,
                                s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, v_pool, nullptr, nullptr, tables, kv_len, out, workspace,
        B, H, KVH, D, bs, max_blocks, blocks_per_split, n_split, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The quantized form: k_pool/v_pool [NB, bs, KV_H, D] int8 (kv_dtype 0) or
// fp8 e4m3 (kv_dtype 1); k_scale/v_scale [NB, KV_H] float32; q/out and the
// workspace as above (dtype 0 = float32, 1 = bfloat16). Same return
// convention.
extern "C" int kft_paged_decode_attention_quant(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* kv_len, void* out, void* workspace, int B, int H, int KVH,
    int D, int bs, int max_blocks, int blocks_per_split, int n_split,
    float scale, int dtype, int kv_dtype, void* stream) {
  if (!geometry_ok(B, H, KVH, D, bs, max_blocks, blocks_per_split,
                   n_split) ||
      k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 0)
    return launch_quant<int8_t>(dtype, q, k_pool, v_pool, k_scale, v_scale,
                                tables, kv_len, out, workspace, B, H, KVH, D,
                                bs, max_blocks, blocks_per_split, n_split,
                                scale, s);
  if (kv_dtype == 1)
    return launch_quant<__nv_fp8_e4m3>(dtype, q, k_pool, v_pool, k_scale,
                                       v_scale, tables, kv_len, out,
                                       workspace, B, H, KVH, D, bs,
                                       max_blocks, blocks_per_split, n_split,
                                       scale, s);
  return (int)cudaErrorInvalidValue;
}
