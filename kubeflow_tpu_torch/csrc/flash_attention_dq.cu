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
// Design. The same grid and loop as the forward: one CTA of 128 threads
// per (query block of 64 rows, query head, batch), looping over the KV
// blocks up to the diagonal; thread (r, c) owns rows r + 8i (i < 8), tile
// columns c + 16j (j < 4) and dQ columns c + 16j (j < D / 16). The q and
// dO tiles stay in shared memory for the whole loop; each KV block's k and
// v tiles are staged beside them; dS goes through shared memory to the
// dS . k product. float32 FMAs, no tensor cores.
//
// Bound. 6 * D FLOPs per (q, k) pair that meets the mask (three products
// of the pair's row with a D-vector, counted as in the forward); at the
// training shape bound by operations over the bf16 tensor-core peak, which
// this FMA kernel does not reach (see flash_attention_fwd.cu).

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int B, int Sq,
           int Skv, int H, int KVH, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static bool opted_in = false;
  if (!opted_in) {
    const int err = set_smem(flash_dq_kernel<T, D>, smem);
    if (err != 0) return err;
    opted_in = true;
  }
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), Sq, Skv, H, KVH, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and dq share it; lse and
// delta are float32). Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for a geometry the kernel does not take.
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
    return launch<float, 64>(q, k, v, dout, lse, delta, dq, B, Sq, Skv, H,
                             KVH, causal, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, dout, lse, delta, dq, B, Sq, Skv, H,
                              KVH, causal, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, B, Sq,
                                     Skv, H, KVH, causal, scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, B, Sq,
                                      Skv, H, KVH, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
