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
// The TPU accumulates dK/dV in place across a revisited grid axis
// (:255-289), which needs the grid's sequential order. Hopper runs blocks
// in parallel and in no order, so here one CTA owns one (KV block of 64
// rows, KV head, batch) and loops itself over the G query heads and, for
// each, over the query blocks from the diagonal on. dK and dV live in
// registers for the whole loop and are written once: no atomics and no
// second pass.
//
// Bound. 8 * D FLOPs per (q, k) pair that meets the mask (the two
// recomputed products and the two accumulated ones); bound by operations
// over the bf16 tensor-core peak at the training shape.
//
// Two bodies, chosen by dtype (the C entry below); neither gives way to
// the other.
//
// bf16: flash_dkv_kernel_sm90, on the tensor cores. One warpgroup (128
// threads) a CTA, two CTAs an SM (__launch_bounds__; 100,352 B of shared
// memory each at D = 128). k and v stay in shared memory; q, dO, lse and delta of each
// (query head, query block) stream through a two-stage ring, the next
// one's cp.async copies in flight while the current one is in the tensor
// cores. Each query block is taken in two halves of 32 query rows, and
// per half the tiles are computed transposed, with the KV rows as M:
// S^T = k . q^T and dP^T = v . dO^T (wgmma m64n32k16, both operands
// K-major from shared memory); P^T and dS^T in registers; dV += P^T . dO
// and dK += dS^T . q (wgmma m64nDk16 over the half's two k16 steps, P^T
// and dS^T as register A operands, dO and q read MN-major from the tiles
// the first two products read K-major; flash_attention_sm90.cuh). Each
// thread holds two 64 x D / 128 float32 accumulators (64 + 64 registers
// at D = 128); the 32-row half keeps S^T, dP^T and their operands at 16
// + 16 + 8 registers beside them, so nothing spills (234 registers at
// D = 128; a 64-row block spilled, at no gain in time: PERF.md). S^T
// comes first; P^T's operand then feeds dV += P^T . dO in the same wgmma
// group as dP^T = v . dO^T, and dS^T follows. Causal: the first KV blocks
// walk the most query blocks, so blockIdx.x runs over them first.
// Rounding points: P^T and dS^T are rounded to bf16 once, as they leave
// the accumulators for the P^T . dO and dS^T . q products; S, P, dP, dS
// before that rounding, and the dK and dV sums stay float32 until the one
// final write in bf16. Every tensor-core flash backward rounds there;
// the plain version's `operand_dtype=torch.bfloat16` rounds at the same
// points (ops/flash_attention.py).
//
// float32: flash_dkv_kernel, float32 FMAs on tiles staged in shared
// memory as float32, one CTA of 256 threads; thread (r, c) = (tid / 16,
// tid % 16) owns KV rows r + 16i, i < 4, and columns c + 16j, j < D / 16;
// each query block's q and dO tiles, its lse and delta, and the block's
// P^T and dS^T go through shared memory beside k and v. The tensor cores
// would take float32 as TF32 (10-bit mantissa), which cannot meet the
// float32 parity limit of 1e-4; this body keeps every product in
// float32. Its grid is not balanced for causal masking.

#include "flash_attention_common.cuh"
#include "flash_attention_sm90.cuh"

namespace {

using namespace flash;

// ------------------------------------------------------------ float32 body

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

// ------------------------------------------------------------- bf16 body

constexpr int kWgThreads = 128;   // one warpgroup

template <int D>
constexpr size_t dkv_sm90_smem_bytes() {
  // k, v, two stages of q and dO, two stages of lse and delta [64]
  // float32; 1 KB to align the base
  return (size_t)6 * sm90::tile_bytes<D>() + 2 * 2 * 64 * sizeof(float) +
         1024;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 2)
flash_dkv_kernel_sm90(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int B, int Sq, int Skv,
                      int H, int KVH, int causal, float scale) {
  using namespace sm90;
  constexpr int T = tile_bytes<D>();
  constexpr int KS = D / 16;    // k16 steps over D
  const int tid = threadIdx.x;
  const int per = KVH * B;
  const int kb = (int)(blockIdx.x / per);   // heaviest (first) KV blocks first
  const int kvh = (int)(blockIdx.x % per) % KVH;
  const int b = (int)(blockIdx.x % per) / KVH;
  const int k0 = kb * kBlockKV;
  const int G = H / KVH;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = base + T;
  const uint32_t qd_s = base + 2 * T;   // stage st: q at + 2 T st, dO + T
  const uint32_t st_s = base + 6 * T;   // stage st: lse [64], delta [64]
  const float* stats = reinterpret_cast<const float*>(smem_raw + (st_s - raw));

  // query block qb reaches KV block k0 iff its last row is at or below
  // the diagonal: (qb + 1) * 64 - 1 >= k0
  const int qb_first = causal ? k0 / kBlockQ : 0;
  const int n_q = (Sq + kBlockQ - 1) / kBlockQ;
  const int per_head = max(n_q - qb_first, 0);
  const int n_it = G * per_head;   // (query head, query block) pairs

  // copies of pair `it` into stage st
  auto load_pair = [&](int it, int st) {
    const int h = kvh * G + it / per_head;
    const int q0 = (qb_first + it % per_head) * kBlockQ;
    const uint32_t qs = qd_s + st * 2 * T;
    load_tile<D, kWgThreads>(qs, q, b, q0, Sq, H, h, tid);
    load_tile<D, kWgThreads>(qs + T, dout, b, q0, Sq, H, h, tid);
    const int r = tid % 64;
    const bool valid = q0 + r < Sq;
    const size_t at = ((size_t)b * H + h) * Sq + (valid ? q0 + r : 0);
    cp_async4(st_s + (st * 128 + tid) * 4, tid < 64 ? lse + at : delta + at,
              valid);
  };

  load_tile<D, kWgThreads>(k_s, k, b, k0, Skv, KVH, kvh, tid);
  load_tile<D, kWgThreads>(v_s, v, b, k0, Skv, KVH, kvh, tid);
  if (n_it > 0) load_pair(0, 0);
  cp_async_commit();

  // this thread's two accumulator rows (KV rows)
  const int kp0 = k0 + acc_row(tid, 0);
  const int kp1 = k0 + acc_row(tid, 2);

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    const int q0 = (qb_first + it % per_head) * kBlockQ;
    const uint32_t q_s = qd_s + st * 2 * T;
    const uint32_t do_s = q_s + T;
    const float* lse_s = stats + st * 128;
    const float* delta_s = lse_s + 64;
    if (it + 1 < n_it) {   // the next pair into the other stage
      load_pair(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    ready_for_wgmma();

    const bool edge = q0 + kBlockQ > Sq || k0 + kBlockKV > Skv ||
                      (causal && k0 + kBlockKV - 1 > q0);
    // the query block in two halves of 32 rows: S^T and dP^T as 64 x 32
    // tiles, so they and their operands fit beside dK and dV
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int c0 = 32 * half;
      // S^T = k . q^T, then P^T in its place; columns are query rows,
      // masked to 0 past the diagonal and past Sq
      float s[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_ss_n32(s, desc_kmajor(k_s, kk),
                   desc_kmajor(q_s + c0 * 128, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + acc_col(tid, j, e);
          const int qp = q0 + c;
          const int kp = e < 2 ? kp0 : kp1;
          const bool live =
              !edge || (kp < Skv && qp < Sq && !(causal && qp < kp));
          s[4 * j + e] = live ? expf(s[4 * j + e] * scale - lse_s[c]) : 0.f;
        }

      // dV += P^T . dO and dP^T = v . dO^T in one wgmma group; the
      // float32 P^T stays in s for dS^T
      uint32_t pa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) to_operand(s, kk, pa[kk]);
      float dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        mma_rs(dv_acc, pa[kk], desc_mnmajor(do_s, 2 * half + kk));
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_ss_n32(dp, desc_kmajor(v_s, kk),
                   desc_kmajor(do_s + c0 * 128, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dp);

      // dS^T = P^T * (dP^T - delta) * scale, then dK += dS^T . q
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          dp[i] = s[i] * (dp[i] - delta_s[c0 + acc_col(tid, j, e)]) * scale;
        }
      uint32_t da[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) to_operand(dp, kk, da[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        mma_rs(dk_acc, da[kk], desc_mnmajor(q_s, 2 * half + kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk_acc);
    }
    __syncthreads();   // the next iteration's copies reuse this stage
  }

  const int t = tid % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? kp1 : kp0;
    if (row < Skv) {
      const size_t at = (((size_t)b * Skv + row) * KVH + kvh) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int e = 4 * j + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j + 2 * t) =
            __floats2bfloat162_rn(dk_acc[e], dk_acc[e + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j + 2 * t) =
            __floats2bfloat162_rn(dv_acc[e], dv_acc[e + 1]);
      }
    }
  }
}

// ------------------------------------------------------------- launches

template <int D>
int launch_fma(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int Sq, int Skv, int H, int KVH, int causal, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static bool opted_in = false;
  if (!opted_in) {
    const int err = set_smem(flash_dkv_kernel<float, D>, smem);
    if (err != 0) return err;
    opted_in = true;
  }
  dim3 grid((Skv + kBlockKV - 1) / kBlockKV, KVH, B);
  flash_dkv_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), Sq, Skv, H, KVH,
      causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_sm90(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int B, int Sq, int Skv, int H, int KVH,
                int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_sm90_smem_bytes<D>();
  static bool opted_in = false;
  if (!opted_in) {
    const int err = set_smem(flash_dkv_kernel_sm90<D>, smem);
    if (err != 0) return err;
    opted_in = true;
  }
  const long long blocks =
      (long long)((Skv + kBlockKV - 1) / kBlockKV) * KVH * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  flash_dkv_kernel_sm90<D><<<(unsigned)blocks, kWgThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Sq, Skv, H, KVH,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the FMA body), 1 = bfloat16 (the tensor-core body);
// q, k, v, dO, dk and dv share it, lse and delta are float32. Returns
// cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// geometry the kernels do not take.
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
    return launch_fma<64>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, H,
                          KVH, causal, scale, s);
  if (dtype == 0 && D == 128)
    return launch_fma<128>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, H,
                           KVH, causal, scale, s);
  if (dtype == 1 && D == 64)
    return launch_sm90<64>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, H,
                           KVH, causal, scale, s);
  if (dtype == 1 && D == 128)
    return launch_sm90<128>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv,
                            H, KVH, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
