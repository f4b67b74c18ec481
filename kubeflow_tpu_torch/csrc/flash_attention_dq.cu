// Flash-attention BACKWARD, dQ, for Hopper (sm_90a).
//
// Replaces the TPU kernel kubeflow_tpu/ops/pallas_attention.py `_bwd` ->
// `_dq_kernel` (call :236, body :135): for each query block, with P
// recomputed from the forward's lse,
//   S  = (q . k^T) * scale, masked to -1e30 as in the forward,
//   P  = exp(S - lse),  dP = dO . v^T,
//   dS = P * (dP - delta) * scale,   dQ = sum over KV blocks of dS . k,
// accumulated in float32 and written once in q's dtype. delta =
// rowsum(dO * O) is computed outside the kernel in float32, as `_bwd`
// does (pallas_attention.py:230).
//
// Bound. 6 * D FLOPs per (q, k) pair that meets the mask (three products
// of the pair's row with a D-vector); at the training shape bound by
// operations over the bf16 tensor-core peak.
//
// Two bodies, chosen by dtype (the C entry below); neither gives way to
// the other.
//
// bf16: flash_dq_kernel_sm90, on the tensor cores. One warpgroup (128
// threads) per (query block of 64 rows, query head, batch), two CTAs an
// SM (__launch_bounds__; 99,328 B of shared memory each at D = 128). q and dO stay in shared
// memory; k and v stream through a two-stage ring of tiles, the next KV
// block's cp.async copies in flight while the current one is in the
// tensor cores. Per KV block: S = q . k^T and dP = dO . v^T as wgmma
// m64n64k16 with both operands from shared memory (K-major); P and dS in
// registers, in the accumulator layout; dQ += dS . k as wgmma m64nDk16
// with dS as the register A operand and k read MN-major from the same
// tile (flash_attention_sm90.cuh). Causal: the query blocks nearest the
// end walk the most KV blocks, so blockIdx.x runs over them first; KV
// blocks past the diagonal are not visited.
// Rounding points: dS is rounded to bf16 once, as it leaves the
// accumulator for the dS . k product; S, P, dP, dS before that rounding,
// and the dQ sum stay float32 until the one final write in bf16. Every
// tensor-core flash backward rounds there; the plain version's
// `operand_dtype=torch.bfloat16` rounds at the same point
// (ops/flash_attention.py).
//
// float32: flash_dq_kernel, float32 FMAs on tiles staged in shared memory
// as float32, one CTA of 128 threads per (query block, query head,
// batch); thread (r, c) owns rows r + 8i (i < 8), tile columns c + 16j
// (j < 4) and dQ columns c + 16j (j < D / 16). The tensor cores would
// take float32 as TF32 (10-bit mantissa), which cannot meet the float32
// parity limit of 1e-4; this body keeps every product in float32.

#include "flash_attention_common.cuh"
#include "flash_attention_sm90.cuh"

namespace {

using namespace flash;

// ------------------------------------------------------------ float32 body

constexpr int kThreads = 128;

template <int D>
constexpr size_t dq_smem_bytes() {
  // q, dO, k, v tiles [64][D + 1], dS [64][65], float32
  return (size_t)(4 * 64 * (D + 1) + 64 * (kBlockKV + 1)) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq,
                int Sq, int Skv, int H, int KVH, int causal, float scale) {
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
  float* do_s = q_s + 64 * LD;
  float* k_s = do_s + 64 * LD;
  float* v_s = k_s + 64 * LD;
  float* ds_s = v_s + 64 * LD;

  stage_rows<T, D>(q_s, q, b, q0, Sq, H, h, 1.f, tid, kThreads);
  stage_rows<T, D>(do_s, dout, b, q0, Sq, H, h, 1.f, tid, kThreads);

  float lse_r[8], delta_r[8], acc[8][ND];
  const size_t stat = ((size_t)b * H + h) * Sq;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + r + 8 * i;
    lse_r[i] = row < Sq ? lse[stat + row] : 0.f;
    delta_r[i] = row < Sq ? delta[stat + row] : 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  }

  int n_kv = (Skv + kBlockKV - 1) / kBlockKV;
  if (causal) n_kv = min(n_kv, (q0 + kBlockQ + kBlockKV - 1) / kBlockKV);

  for (int jb = 0; jb < n_kv; ++jb) {
    const int k0 = jb * kBlockKV;
    __syncthreads();
    stage_rows<T, D>(k_s, k, b, k0, Skv, KVH, kvh, 1.f, tid, kThreads);
    stage_rows<T, D>(v_s, v, b, k0, Skv, KVH, kvh, 1.f, tid, kThreads);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[8], dov[8], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        qv[i] = q_s[(r + 8 * i) * LD + d];
        dov[i] = do_s[(r + 8 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = k_s[(c + 16 * j) * LD + d];
        vv[j] = v_s[(c + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qp = q0 + r + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + c + 16 * j;
        const bool live = kp < Skv && !(causal && qp < kp);
        const float p = live ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        ds_s[(r + 8 * i) * PLD + c + 16 * j] =
            p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kBlockKV; ++t) {
      float dsv[8], kv[ND];
#pragma unroll
      for (int i = 0; i < 8; ++i) dsv[i] = ds_s[(r + 8 * i) * PLD + t];
#pragma unroll
      for (int j = 0; j < ND; ++j) kv[j] = k_s[t * LD + c + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + r + 8 * i;
    if (row < Sq) {
      T* out = dq + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < ND; ++j) store(out + c + 16 * j, acc[i][j]);
    }
  }
}

// ------------------------------------------------------------- bf16 body

constexpr int kWgThreads = 128;   // one warpgroup

template <int D>
constexpr size_t dq_sm90_smem_bytes() {
  // q, dO, and two stages of k and v; 1 KB to align the base
  return (size_t)6 * sm90::tile_bytes<D>() + 1024;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 2)
flash_dq_kernel_sm90(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, int B, int Sq, int Skv,
                     int H, int KVH, int causal, float scale) {
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
  const uint32_t do_s = base + T;
  const uint32_t kv_s = base + 2 * T;   // stage st: k at + 2 T st, v + T

  int n_kv = (Skv + kBlockKV - 1) / kBlockKV;
  if (causal) n_kv = min(n_kv, (q0 + kBlockQ + kBlockKV - 1) / kBlockKV);

  load_tile<D, kWgThreads>(q_s, q, b, q0, Sq, H, h, tid);
  load_tile<D, kWgThreads>(do_s, dout, b, q0, Sq, H, h, tid);
  load_tile<D, kWgThreads>(kv_s, k, b, 0, Skv, KVH, kvh, tid);   // n_kv >= 1
  load_tile<D, kWgThreads>(kv_s + T, v, b, 0, Skv, KVH, kvh, tid);
  cp_async_commit();

  // this thread's two accumulator rows
  const int qp0 = q0 + acc_row(tid, 0);
  const int qp1 = q0 + acc_row(tid, 2);
  const size_t stat = ((size_t)b * H + h) * Sq;
  const float lse_r[2] = {qp0 < Sq ? lse[stat + qp0] : 0.f,
                          qp1 < Sq ? lse[stat + qp1] : 0.f};
  const float delta_r[2] = {qp0 < Sq ? delta[stat + qp0] : 0.f,
                            qp1 < Sq ? delta[stat + qp1] : 0.f};

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

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      mma_ss_n64(s, desc_kmajor(q_s, kk), desc_kmajor(k_s, kk));
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      mma_ss_n64(dp, desc_kmajor(do_s, kk), desc_kmajor(v_s, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dS in place of S: P = exp(S * scale - lse), masked to 0
    const bool edge = k0 + kBlockKV > Skv || (causal && k0 + kBlockKV - 1 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const int qp = e < 2 ? qp0 : qp1;
        const int kp = k0 + acc_col(tid, j, e);
        const bool live = !edge || (kp < Skv && !(causal && qp < kp));
        const float p = live ? expf(s[i] * scale - lse_r[e / 2]) : 0.f;
        s[i] = p * (dp[i] - delta_r[e / 2]) * scale;
      }

    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) to_operand(s, kk, a[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs(acc, a[kk], desc_mnmajor(k_s, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();   // the next iteration's copies reuse this stage
  }

  const int t = tid % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? qp1 : qp0;
    if (row < Sq) {
      __nv_bfloat16* out = dq + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * t) =
            __floats2bfloat162_rn(acc[4 * j + 2 * half],
                                  acc[4 * j + 2 * half + 1]);
    }
  }
}

// ------------------------------------------------------------- launches

template <int D>
int launch_fma(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, int B, int Sq,
               int Skv, int H, int KVH, int causal, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static bool opted_in = false;
  if (!opted_in) {
    const int err = set_smem(flash_dq_kernel<float, D>, smem);
    if (err != 0) return err;
    opted_in = true;
  }
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_dq_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), Sq, Skv, H, KVH, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_sm90(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, int B, int Sq, int Skv, int H, int KVH, int causal,
                float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_sm90_smem_bytes<D>();
  static bool opted_in = false;
  if (!opted_in) {
    const int err = set_smem(flash_dq_kernel_sm90<D>, smem);
    if (err != 0) return err;
    opted_in = true;
  }
  const long long blocks =
      (long long)((Sq + kBlockQ - 1) / kBlockQ) * H * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  flash_dq_kernel_sm90<D><<<(unsigned)blocks, kWgThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), B, Sq, Skv, H, KVH, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the FMA body), 1 = bfloat16 (the tensor-core body);
// q, k, v, dO and dq share it, lse and delta are float32. Returns
// cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// geometry the kernels do not take.
extern "C" int kft_flash_attention_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int B, int Sq, int Skv,
                                      int H, int KVH, int D, int causal,
                                      float scale, int dtype, void* stream) {
  if (!flash::geometry_ok(B, Sq, Skv, H, KVH, D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_fma<64>(q, k, v, dout, lse, delta, dq, B, Sq, Skv, H, KVH,
                          causal, scale, s);
  if (dtype == 0 && D == 128)
    return launch_fma<128>(q, k, v, dout, lse, delta, dq, B, Sq, Skv, H, KVH,
                           causal, scale, s);
  if (dtype == 1 && D == 64)
    return launch_sm90<64>(q, k, v, dout, lse, delta, dq, B, Sq, Skv, H,
                           KVH, causal, scale, s);
  if (dtype == 1 && D == 128)
    return launch_sm90<128>(q, k, v, dout, lse, delta, dq, B, Sq, Skv, H,
                            KVH, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
