// Flash-attention FORWARD for Hopper (sm_90a).
//
// Replaces the TPU kernel kubeflow_tpu/ops/pallas_attention.py `_fwd` ->
// `_fwd_kernel` (call :111, body :54): causal or full grouped-query
// attention with an online softmax in float32. KV rows at or past Skv,
// and under causal masking KV rows past the query row, get the logit
// -1e30; the KV loop stops at the diagonal. Writes O = acc / max(l, 1e-30)
// in the input dtype and the per-row lse = m + log(max(l, 1e-30)) in
// float32 ([B, H, Sq]), which the two backward kernels use to recompute P.
//
// Bound. Causal attention at the training shape (B=2, S=2048, H=16, D=128)
// does 4 * D FLOPs per (q, k) pair that meets the mask: 3.44e10 FLOPs
// against ~50 MB of q, k, v, o and lse, so it is bound by operations. The
// least time is those FLOPs over the bf16 tensor-core peak (989 TFLOP/s).
//
// Two bodies, chosen by dtype (the C entry below); neither gives way to
// the other.
//
// bf16: flash_fwd_kernel_sm90, on the tensor cores. One warpgroup (128
// threads) per (query block of 64 rows, query head, batch), two CTAs an
// SM (__launch_bounds__; 82,944 B of shared memory each at D = 128). The
// q tile stays in shared memory; k and v stream through a two-stage ring
// of tiles, the next KV block's cp.async copies in flight while the
// current one is in the tensor cores (flash_attention_sm90.cuh). Per KV
// block: S = q . k^T as wgmma m64n64k16, both operands K-major from
// shared memory; S *= scale in float32 and the mask; the online-softmax
// update in the accumulator layout (a row's 64 logits lie on a quad of
// threads, so its max and sum are two shuffles); O *= alpha in
// registers; O += P . v as wgmma m64nDk16 with P as the register A
// operand and v read MN-major from the same tile. Causal: the query
// blocks nearest the end walk the most KV blocks, so blockIdx.x runs
// over them first; KV blocks past the diagonal are not visited.
// Rounding points: P = exp(S - m), with m the running max at that KV
// block, is rounded to bf16 once, as it leaves the accumulator for the
// P . v product; l sums the float32 P before that rounding; S, m, l and
// the O sum stay float32 until the one final write of O in bf16 and of
// lse in float32. The scale multiplies S in float32 after the product
// (q is not pre-scaled: 1/sqrt(D) is no power of two, and a scaled bf16
// q would round twice), as the backward bodies recompute S. The plain
// version's `operand_dtype=torch.bfloat16` walks 64-wide KV blocks and
// rounds at the same points (ops/flash_attention.py).
//
// float32: flash_fwd_kernel, float32 FMAs on tiles staged in shared
// memory as float32 (see the common header), q pre-scaled by 1/sqrt(D),
// one CTA of 128 threads per (query block, query head, batch); thread
// (r, c) = (tid / 16, tid % 16) owns rows r + 8i, i < 8, logit columns
// c + 16j, j < 4, and output columns c + 16j, j < D / 16. The tensor cores
// would take float32 as TF32 (10-bit mantissa), which cannot meet the
// float32 parity limit of 1e-4; this body keeps every product in float32
// and P in float32.

#include "flash_attention_common.cuh"
#include "flash_attention_sm90.cuh"

namespace {

using namespace flash;

// ------------------------------------------------------------ float32 body

constexpr int kThreads = 128;

template <int D>
constexpr size_t fwd_smem_bytes() {
  // q, k, v tiles [64][D + 1] and the probabilities [64][65], float32
  return (size_t)(3 * 64 * (D + 1) + 64 * (kBlockKV + 1)) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int H, int KVH,
                 int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int PLD = kBlockKV + 1;
  constexpr int ND = D / 16;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int r = tid >> 4;
  const int c = tid & 15;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + 64 * LD;
  float* v_s = k_s + 64 * LD;
  float* p_s = v_s + 64 * LD;

  stage_rows<T, D>(q_s, q, b, q0, Sq, H, h, scale, tid, kThreads);

  float m[8], l[8], acc[8][ND];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  }

  int n_kv = (Skv + kBlockKV - 1) / kBlockKV;
  if (causal) n_kv = min(n_kv, (q0 + kBlockQ + kBlockKV - 1) / kBlockKV);

  for (int jb = 0; jb < n_kv; ++jb) {
    const int k0 = jb * kBlockKV;
    __syncthreads();  // the previous block's readers of k_s, v_s, p_s
    stage_rows<T, D>(k_s, k, b, k0, Skv, KVH, kvh, 1.f, tid, kThreads);
    stage_rows<T, D>(v_s, v, b, k0, Skv, KVH, kvh, 1.f, tid, kThreads);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = q_s[(r + 8 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(c + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qp = q0 + r + 8 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + c + 16 * j;
        if (kp >= Skv || (causal && qp < kp)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(r + 8 * i) * PLD + c + 16 * j] = p;
        sum += p;
      }
      sum = half_warp_sum(sum);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kBlockKV; ++t) {
      float pv[8], vv[ND];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = p_s[(r + 8 * i) * PLD + t];
#pragma unroll
      for (int j = 0; j < ND; ++j) vv[j] = v_s[t * LD + c + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + r + 8 * i;
    if (row < Sq) {
      const float lc = fmaxf(l[i], 1e-30f);
      T* out = o + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < ND; ++j) store(out + c + 16 * j, acc[i][j] / lc);
      if (c == 0) lse[((size_t)b * H + h) * Sq + row] = m[i] + logf(lc);
    }
  }
}

// ------------------------------------------------------------- bf16 body

constexpr int kWgThreads = 128;   // one warpgroup

template <int D>
constexpr size_t fwd_sm90_smem_bytes() {
  // q and two stages of k and v; 1 KB to align the base
  return (size_t)5 * sm90::tile_bytes<D>() + 1024;
}

// max and sum over the quad of lanes that hold one accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 2)
flash_fwd_kernel_sm90(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int B, int Sq, int Skv, int H, int KVH, int causal,
                      float scale) {
  using namespace sm90;
  constexpr int T = tile_bytes<D>();
  constexpr int KS = D / 16;    // k16 steps over D
  const int tid = threadIdx.x;
  const int n_q = (Sq + kBlockQ - 1) / kBlockQ;
  const int per = H * B;
  const int qb = n_q - 1 - (int)(blockIdx.x / per);   // heaviest first
  const int h = (int)(blockIdx.x % per) % H;
  const int b = (int)(blockIdx.x % per) / H;
  const int q0 = qb * kBlockQ;
  const int kvh = h / (H / KVH);

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + T;   // stage st: k at + 2 T st, v + T

  int n_kv = (Skv + kBlockKV - 1) / kBlockKV;
  if (causal) n_kv = min(n_kv, (q0 + kBlockQ + kBlockKV - 1) / kBlockKV);

  load_tile<D, kWgThreads>(q_s, q, b, q0, Sq, H, h, tid);
  load_tile<D, kWgThreads>(kv_s, k, b, 0, Skv, KVH, kvh, tid);   // n_kv >= 1
  load_tile<D, kWgThreads>(kv_s + T, v, b, 0, Skv, KVH, kvh, tid);
  cp_async_commit();

  // this thread's two accumulator rows, their running max and sum
  const int qp0 = q0 + acc_row(tid, 0);
  const int qp1 = q0 + acc_row(tid, 2);
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int jb = 0; jb < n_kv; ++jb) {
    const int k0 = jb * kBlockKV;
    const uint32_t k_s = kv_s + (jb & 1) * 2 * T;
    const uint32_t v_s = k_s + T;
    if (jb + 1 < n_kv) {   // the next KV block into the other stage
      const uint32_t nk = kv_s + ((jb + 1) & 1) * 2 * T;
      load_tile<D, kWgThreads>(nk, k, b, k0 + kBlockKV, Skv, KVH, kvh, tid);
      load_tile<D, kWgThreads>(nk + T, v, b, k0 + kBlockKV, Skv, KVH, kvh,
                               tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    ready_for_wgmma();

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      mma_ss_n64(s, desc_kmajor(q_s, kk), desc_kmajor(k_s, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // S * scale, masked; the row maxima over this block
    const bool edge = k0 + kBlockKV > Skv || (causal && k0 + kBlockKV - 1 > q0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const int qp = e < 2 ? qp0 : qp1;
        const int kp = k0 + acc_col(tid, j, e);
        const bool live = !edge || (kp < Skv && !(causal && qp < kp));
        s[i] = live ? s[i] * scale : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[i]);
      }

    // the online-softmax update: P in place of S, float32
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = expf(s[i] - m[(i % 4) / 2]);
      sum[(i % 4) / 2] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i % 4) / 2];

    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) to_operand(s, kk, a[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs(acc, a[kk], desc_mnmajor(v_s, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();   // the next iteration's copies reuse this stage
  }

  const int t = tid % 4;
  const size_t stat = ((size_t)b * H + h) * Sq;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? qp1 : qp0;
    if (row < Sq) {
      const float lc = fmaxf(l[half], 1e-30f);
      __nv_bfloat16* out = o + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * t) =
            __floats2bfloat162_rn(acc[4 * j + 2 * half] / lc,
                                  acc[4 * j + 2 * half + 1] / lc);
      if (t == 0) lse[stat + row] = m[half] + logf(lc);
    }
  }
}

// ------------------------------------------------------------- launches

template <int D>
int launch_fma(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int Sq, int Skv, int H, int KVH, int causal,
               float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  static bool opted_in = false;
  if (!opted_in) {
    const int err = set_smem(flash_fwd_kernel<float, D>, smem);
    if (err != 0) return err;
    opted_in = true;
  }
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), Sq, Skv, H, KVH, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_sm90(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int Sq, int Skv, int H, int KVH,
                int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_sm90_smem_bytes<D>();
  static bool opted_in = false;
  if (!opted_in) {
    const int err = set_smem(flash_fwd_kernel_sm90<D>, smem);
    if (err != 0) return err;
    opted_in = true;
  }
  const long long blocks =
      (long long)((Sq + kBlockQ - 1) / kBlockQ) * H * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  flash_fwd_kernel_sm90<D><<<(unsigned)blocks, kWgThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), B, Sq, Skv, H, KVH, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the FMA body), 1 = bfloat16 (the tensor-core body);
// q, k, v and o share it, lse is float32. Returns cudaGetLastError() after
// the launch (0 on success); cudaErrorInvalidValue for a geometry the
// kernels do not take. Launches on `stream`, does not synchronize,
// allocates nothing.
extern "C" int kft_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int Sq, int Skv, int H,
                                       int KVH, int D, int causal,
                                       float scale, int dtype,
                                       void* stream) {
  if (!flash::geometry_ok(B, Sq, Skv, H, KVH, D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_fma<64>(q, k, v, o, lse, B, Sq, Skv, H, KVH, causal, scale,
                          s);
  if (dtype == 0 && D == 128)
    return launch_fma<128>(q, k, v, o, lse, B, Sq, Skv, H, KVH, causal,
                           scale, s);
  if (dtype == 1 && D == 64)
    return launch_sm90<64>(q, k, v, o, lse, B, Sq, Skv, H, KVH, causal,
                           scale, s);
  if (dtype == 1 && D == 128)
    return launch_sm90<128>(q, k, v, o, lse, B, Sq, Skv, H, KVH, causal,
                            scale, s);
  return (int)cudaErrorInvalidValue;
}
