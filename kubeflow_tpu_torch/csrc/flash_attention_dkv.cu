// Flash-attention BACKWARD, dK and dV, for Hopper (sm_90a).
//
// Replaces the TPU kernel kubeflow_tpu/ops/pallas_attention.py `_bwd` ->
// `_dkv_kernel` (call :257, body :170): for each KV block of one KV head,
//   dV = sum over the G query heads of the group and all query blocks of
//        P^T . dO,
//   dK = the same sum of dS^T . q,
// with P = exp((q . k^T) * scale - lse) (masked to 0 where the forward
// masked to -1e30) and dS = P * (dO . v^T - delta) * scale; float32
// accumulation, cast to k's dtype once at the end. Query blocks that lie
// wholly above the diagonal (they never see this KV block under causal
// masking, pallas_attention.py:216-219) are skipped.
//
// Design. The TPU accumulates dK/dV in place across a revisited grid axis
// (:255-289), which needs the grid's sequential order. Hopper runs blocks
// in parallel and in no order, so here one CTA of 256 threads owns one
// (KV block of 64 rows, KV head, batch) and loops itself over the G query
// heads and, for each, over the query blocks from the diagonal on. dK and
// dV live in registers for the whole loop (thread (r, c) = (tid / 16,
// tid % 16) owns KV rows r + 16i, i < 4, and columns c + 16j, j < D / 16)
// and are written once: no atomics and no second pass. The k and v tiles
// stay in shared memory; each query block's q and dO tiles, its lse and
// delta, and the block's P^T and dS^T go through shared memory beside
// them. float32 FMAs, no tensor cores.
//
// Bound. 8 * D FLOPs per (q, k) pair that meets the mask (the two
// recomputed products and the two accumulated ones); bound by operations
// over the bf16 tensor-core peak at the training shape, which this FMA
// kernel does not reach (see flash_attention_fwd.cu). Under causal masking
// the CTAs of early KV blocks do the most work; the grid is not balanced
// for that.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

constexpr int kThreads = 256;

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k, v, q, dO tiles [64][D + 1], P^T and dS^T [64][65], lse and delta
  // [64], float32
  return (size_t)(4 * 64 * (D + 1) + 2 * 64 * (kBlockQ + 1) + 2 * 64) *
         sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int Sq, int Skv, int H, int KVH,
                 int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int PLD = kBlockQ + 1;
  constexpr int ND = D / 16;
  const int k0 = blockIdx.x * kBlockKV;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int r = tid >> 4;
  const int c = tid & 15;

  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + 64 * LD;
  float* q_s = v_s + 64 * LD;
  float* do_s = q_s + 64 * LD;
  float* p_s = do_s + 64 * LD;     // P^T  [kv row][q row]
  float* ds_s = p_s + 64 * PLD;    // dS^T [kv row][q row]
  float* lse_s = ds_s + 64 * PLD;  // [64]
  float* delta_s = lse_s + 64;     // [64]

  stage_rows<T, D>(k_s, k, b, k0, Skv, KVH, kvh, 1.f, tid, kThreads);
  stage_rows<T, D>(v_s, v, b, k0, Skv, KVH, kvh, 1.f, tid, kThreads);

  float dk_acc[4][ND], dv_acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }

  // query block qb reaches KV block k0 iff its last row is at or below
  // the diagonal: (qb + 1) * 64 - 1 >= k0
  const int qb_first = causal ? k0 / kBlockQ : 0;
  const int n_q = (Sq + kBlockQ - 1) / kBlockQ;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t stat = ((size_t)b * H + h) * Sq;
    for (int qb = qb_first; qb < n_q; ++qb) {
      const int q0 = qb * kBlockQ;
      __syncthreads();  // the previous block's readers of q_s ... ds_s
      stage_rows<T, D>(q_s, q, b, q0, Sq, H, h, 1.f, tid, kThreads);
      stage_rows<T, D>(do_s, dout, b, q0, Sq, H, h, 1.f, tid, kThreads);
      if (tid < 64) {
        const int row = q0 + tid;
        lse_s[tid] = row < Sq ? lse[stat + row] : 0.f;
        delta_s[tid] = row < Sq ? delta[stat + row] : 0.f;
      }
      __syncthreads();

      // transposed tiles: rows are this CTA's KV rows, columns query rows
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = 0.f;
          dp[i][j] = 0.f;
        }
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = k_s[(r + 16 * i) * LD + d];
          vv[i] = v_s[(r + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = q_s[(c + 16 * j) * LD + d];
          dov[j] = do_s[(c + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + r + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = c + 16 * j;
          const int qp = q0 + qi;
          const bool live = kp < Skv && qp < Sq && !(causal && qp < kp);
          const float p = live ? expf(s[i][j] * scale - lse_s[qi]) : 0.f;
          p_s[(r + 16 * i) * PLD + qi] = p;
          ds_s[(r + 16 * i) * PLD + qi] = p * (dp[i][j] - delta_s[qi]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int t = 0; t < kBlockQ; ++t) {
        float pv[4], dsv[4], dov[ND], qv[ND];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = p_s[(r + 16 * i) * PLD + t];
          dsv[i] = ds_s[(r + 16 * i) * PLD + t];
        }
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          dov[j] = do_s[t * LD + c + 16 * j];
          qv[j] = q_s[t * LD + c + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < ND; ++j) {
            dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + r + 16 * i;
    if (row < Skv) {
      const size_t base = (((size_t)b * Skv + row) * KVH + kvh) * D;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        store(dk + base + c + 16 * j, dk_acc[i][j]);
        store(dv + base + c + 16 * j, dv_acc[i][j]);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int B,
           int Sq, int Skv, int H, int KVH, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static bool opted_in = false;
  if (!opted_in) {
    const int err = set_smem(flash_dkv_kernel<T, D>, smem);
    if (err != 0) return err;
    opted_in = true;
  }
  dim3 grid((Skv + kBlockKV - 1) / kBlockKV, KVH, B);
  flash_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H, KVH, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO, dk and dv share it; lse
// and delta are float32). Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for a geometry the kernel does not take.
extern "C" int kft_flash_attention_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int Sq,
                                       int Skv, int H, int KVH, int D,
                                       int causal, float scale, int dtype,
                                       void* stream) {
  if (!flash::geometry_ok(B, Sq, Skv, H, KVH, D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv,
                             H, KVH, causal, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv,
                              H, KVH, causal, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv, B,
                                     Sq, Skv, H, KVH, causal, scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv, B,
                                      Sq, Skv, H, KVH, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
