// Flash-attention FORWARD for Hopper (sm_90a).
//
// Replaces the TPU kernel kubeflow_tpu/ops/pallas_attention.py `_fwd` ->
// `_fwd_kernel` (call :111, body :54): causal or full grouped-query
// attention with an online softmax in float32. q is pre-scaled by
// 1/sqrt(D); KV rows at or past Skv, and under causal masking KV rows past
// the query row, get the logit -1e30; the KV loop stops at the diagonal.
// Writes O = acc / max(l, 1e-30) in the input dtype and the per-row
// lse = m + log(max(l, 1e-30)) in float32 ([B, H, Sq]), which the two
// backward kernels use to recompute P.
//
// Design. The TPU walks a sequential grid; here one CTA of 128 threads
// owns one (query block of 64 rows, query head, batch) and loops over the
// KV blocks itself, holding m, l and the 64 x D accumulator in registers
// (thread (r, c) = (tid / 16, tid % 16) owns rows r + 8i, i < 8, logit
// columns c + 16j, j < 4, and output columns c + 16j, j < D / 16). K and V
// tiles are staged in shared memory as float32 (see the common header);
// products are float32 FMAs from shared memory, no tensor cores.
//
// Bound. Causal attention at the training shape (B=2, S=2048, H=16, D=128)
// does 4 * D FLOPs per (q, k) pair that meets the mask: 3.44e10 FLOPs
// against ~50 MB of q, k, v, o and lse, so it is bound by operations. The
// least time is those FLOPs over the bf16 tensor-core peak (989 TFLOP/s).
// This first kernel runs on the float32 FMA units instead, whose peak is
// ~15x lower, and its inner loop reads shared memory for every FMA pair;
// wgmma with TMA-fed tiles is the later step.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Sq, int Skv, int H, int KVH, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  static bool opted_in = false;
  if (!opted_in) {
    const int err = set_smem(flash_fwd_kernel<T, D>, smem);
    if (err != 0) return err;
    opted_in = true;
  }
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), Sq, Skv, H, KVH, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); cudaErrorInvalidValue for a geometry the kernel
// does not take. Launches on `stream`, does not synchronize, allocates
// nothing.
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
    return launch<float, 64>(q, k, v, o, lse, B, Sq, Skv, H, KVH, causal,
                             scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, lse, B, Sq, Skv, H, KVH, causal,
                              scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, Sq, Skv, H, KVH,
                                     causal, scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, Sq, Skv, H, KVH,
                                      causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
