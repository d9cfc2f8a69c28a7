// Masked / causal multi-head attention for Hopper (sm_90a): the eval
// forward, the training forward that also writes the logsumexp, the flash
// training backward, and the pair of the two with dropout on the softmax
// weights.
//
// mha_forward replaces garbage_classification_rca_tpu/kernels/mha_fused.py
// ::mha (Pallas bodies `_kernel` / `_kernel_masked`). mha_forward_lse
// replaces ::_mha_fwd_lse (body `_fwd_lse_kernel`): the same kernel, which
// also writes lse = max + log(sum exp) [B, H, N] in fp32. Per head h of
// D = H * dh:
//   out = softmax(Q K^T * scale + (mask - 1) * 1e30) V,  causal: key > query
//   gets -1e30. The softmax runs in fp32 with the row max subtracted; the
//   weights are rounded to V's dtype before the PV product, which
//   accumulates in fp32 — the rounding of the JAX kernel and of
//   `mha_reference`.
//
// What bounds it on the H100: device-memory bytes. At the DistilBERT shape
// (B=128, N=64, D=768, bf16) one launch moves 50.3 MB of q/k/v/o against
// 1.61 GFLOP, far below the 295 FLOP/byte at which the tensor cores would
// be the limit. The design therefore reads every q/k/v element once per
// block that needs it, keeps scores in shared memory (never in device
// memory), and writes each output once. One block per (32 query rows,
// head, sample); keys stream through shared memory in chunks of 64, so any
// N up to 512 fits: the fp32 score rows of the block (32 x N) are the only
// buffer that grows with N. Softmax normalisation is two-pass over the
// stored scores (not online), which is what lets the weights be rounded
// exactly as the reference rounds them. The products run on the fp32 CUDA
// cores with 4x4 (QK) and 4x(dh/16) (PV) register tiles; moving them onto
// the tensor cores (mma / wgmma) is later work.

//
// mha_flash_backward replaces ::_mha_flash_bwd (body `_bwd_kernel`): the
// scores are recomputed from q, k and the saved lse, never stored in device
// memory. With W = exp(S - lse) in fp32:
//   Delta = rowsum(dO * O)  (fp32, from the stored O)
//   dV = W^T dO  with W rounded to V's dtype
//   dP = dO V^T,  dS = W * (dP - Delta) rounded to q's dtype
//   dQ = dS K * scale,  dK = dS^T Q * scale   (fp32 accumulation)
// the rounding points of the Pallas kernel, which keep bf16 parity. Two
// kernels: one block per (32 query rows, head, sample) gives dQ and Delta;
// then one block per (32 keys, head, sample) streams the queries through
// shared memory in chunks of 64 and gives dK and dV. Nothing is summed
// across blocks, so no atomics and the same gradients on every run. Bound,
// as for the forward: device-memory bytes at the DistilBERT shapes; the
// products run on the fp32 CUDA cores in this first version.
//
// mha_forward_lse_drop / mha_flash_backward_drop replace
// ::_mha_fwd_lse_drop (body `_fwd_lse_drop_kernel`) and
// ::_mha_flash_bwd_drop (body `_bwd_drop_kernel`): the same three kernels
// with the compile-time flag DROP, which applies a keep mask dm (uint8
// [B, H, N, N], drawn by the caller) to the softmax weights:
//   forward:  wl = (e / sum) in V's dtype; wld = dm ? wl / keep : 0, the
//             division in V's dtype (keep itself rounded to it);
//             out = wld V; lse = max + log(sum), the softmax before dropout;
//   backward: W = exp(S - lse) fp32; dV = wld^T dO with wld from W rounded
//             to V's dtype as in the forward; dW = dm ? dP / keep : 0 in
//             fp32; Delta = rowsum(dO * O) as without dropout, because
//             rowsum(dW * W) = rowsum(dP * wld) = rowsum(dO * O);
//             dS = W * (dW - Delta) in q's dtype.
// What bounds them on the H100: still device-memory bytes. At the text
// trainer's shape (B=128, N=64, D=768, 12 heads, fp32) the mask adds 6.3 MB
// to the forward's 100.7 MB of q/k/v/o and to the backward's 201.3 MB. The
// design reads each mask byte once per kernel that needs it: the forward and
// the dQ kernel read their 32 rows of dm along the rows; the dK/dV kernel
// needs 32 columns of every row, which it stages through shared memory in
// tiles of 64 queries x 32 keys, each warp load covering one 32-byte run of
// a row, so that no load is strided by N. All mask loads are single bytes:
// any N (odd ones, too) takes the same path. With DROP off the kernels
// compile to what they were.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;        // query rows per block
constexpr int BK = 64;        // keys per shared-memory chunk
constexpr int THREADS = 128;  // 8 row groups (4 rows each) x 16 column lanes
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int DH, bool LSE, bool DROP>
__global__ void __launch_bounds__(THREADS)
    mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ mask,
               const uint8_t* __restrict__ dm, T* __restrict__ o,
               float* __restrict__ lse, int N, int D, float scale, int causal,
               float keep) {
  constexpr int LDH = DH + 1;    // odd stride: conflict-free column reads
  constexpr int CPT = DH / 16;   // output columns per thread in PV
  extern __shared__ float sm[];
  float* Qs = sm;                // [BQ][LDH]
  float* KVs = Qs + BQ * LDH;    // [BK][LDH]: K chunk, later V chunk
  float* S = KVs + BK * LDH;     // [BQ][N]: scores, then weights

  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const size_t base = b * N * static_cast<size_t>(D) + h * DH;

  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int r = e / DH, d = e - r * DH, n = q0 + r;
    Qs[r * LDH + d] = n < N ? to_f(q[base + static_cast<size_t>(n) * D + d])
                            : 0.f;
  }

  // pass 1: scores for every key, chunk by chunk
  for (int k0 = 0; k0 < N; k0 += BK) {
    const int kn = min(BK, N - k0);
    __syncthreads();
    for (int e = tid; e < kn * DH; e += THREADS) {
      const int r = e / DH, d = e - r * DH;
      KVs[r * LDH + d] = to_f(k[base + static_cast<size_t>(k0 + r) * D + d]);
    }
    __syncthreads();
    float acc[4][4] = {};
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr * 4 + i) * LDH + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = KVs[(tc + 16 * j) * LDH + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tc + 16 * j;
      if (c >= kn) continue;
      const int key = k0 + c;
      const float bias =
          mask ? (static_cast<float>(mask[b * N + key]) - 1.f) * 1e30f : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tr * 4 + i;
        float s = acc[i][j] * scale + bias;
        if (causal && key > q0 + r) s = NEG;
        S[r * N + key] = s;
      }
    }
  }
  __syncthreads();

  // fp32 softmax per row, weights rounded to V's dtype; one warp per row
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < BQ; r += THREADS / 32) {
    float* row = S + r * N;
    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if constexpr (DROP) {
      // wl / keep in V's dtype on the kept weights, 0 on the dropped ones
      const bool live = q0 + r < N;
      const uint8_t* dmr =
          dm + ((b * gridDim.y + h) * N + (live ? q0 + r : 0)) *
                   static_cast<size_t>(N);
      const float keep_v = round_to(keep, v);
      for (int j = lane; j < N; j += 32) {
        const float wl = round_to(row[j] / sum, v);
        row[j] = live && dmr[j] ? round_to(wl / keep_v, v) : 0.f;
      }
    } else {
      for (int j = lane; j < N; j += 32) row[j] = round_to(row[j] / sum, v);
    }
    if (LSE && lane == 0 && q0 + r < N)
      lse[(b * gridDim.y + h) * static_cast<size_t>(N) + q0 + r] =
          mx + logf(sum);
  }

  // pass 2: out = W V, V streamed through the same chunk buffer
  float acc[4][CPT] = {};
  for (int k0 = 0; k0 < N; k0 += BK) {
    const int kn = min(BK, N - k0);
    __syncthreads();
    for (int e = tid; e < kn * DH; e += THREADS) {
      const int r = e / DH, d = e - r * DH;
      KVs[r * LDH + d] = to_f(v[base + static_cast<size_t>(k0 + r) * D + d]);
    }
    __syncthreads();
    for (int c = 0; c < kn; ++c) {
      float wv[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] = S[(tr * 4 + i) * N + k0 + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = KVs[c * LDH + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(wv[i], vv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + tr * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      st(o, base + static_cast<size_t>(n) * D + tc + 16 * j, acc[i][j]);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* mask, const uint8_t* dm, void* o, float* lse,
                   int B, int N, int D, int heads, float scale, int causal,
                   float keep, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((BQ + BK) * (DH + 1) + static_cast<size_t>(BQ) * N);
  auto kern = dm    ? mha_kernel<T, DH, true, true>
              : lse ? mha_kernel<T, DH, true, false>
                    : mha_kernel<T, DH, false, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, heads, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, dm, static_cast<T*>(o), lse, N, D,
      scale, causal, keep);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// flash backward
// ---------------------------------------------------------------------------

constexpr int BKV = 32;  // keys per block of the dK / dV kernel
constexpr int BQC = 64;  // queries per shared-memory chunk there
constexpr int DMS = BKV + 4;  // row stride of its keep-mask tile, in bytes

__device__ __forceinline__ float key_bias(const int* mask, size_t b, int N,
                                          int key) {
  return mask ? (static_cast<float>(mask[b * N + key]) - 1.f) * 1e30f : 0.f;
}

// dQ and Delta for 32 query rows of one head of one sample; keys and values
// stream through shared memory in chunks of 64.
template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(THREADS)
    mha_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ o,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const int* __restrict__ mask,
                      const uint8_t* __restrict__ dm, T* __restrict__ dq,
                      float* __restrict__ delta, int N, int D, float scale,
                      int causal, float keep) {
  constexpr int LDH = DH + 1;
  constexpr int CPT = DH / 16;
  extern __shared__ float sm[];
  float* Qs = sm;                  // [BQ][LDH]
  float* dOs = Qs + BQ * LDH;      // [BQ][LDH]
  float* Ks = dOs + BQ * LDH;      // [BK][LDH]
  float* Vs = Ks + BK * LDH;       // [BK][LDH]
  float* dS = Vs + BK * LDH;       // [BQ][BK + 1]
  float* L = dS + BQ * (BK + 1);   // [BQ]
  float* Dl = L + BQ;              // [BQ]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, H = gridDim.y;
  const size_t b = blockIdx.z;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const size_t base = b * N * static_cast<size_t>(D) + h * DH;
  const size_t rbase = (b * H + h) * static_cast<size_t>(N);

  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int r = e / DH, d = e - r * DH, n = q0 + r;
    const size_t a = base + static_cast<size_t>(n) * D + d;
    Qs[r * LDH + d] = n < N ? to_f(q[a]) : 0.f;
    dOs[r * LDH + d] = n < N ? to_f(dout[a]) : 0.f;
  }
  // Delta = rowsum(dO * O) in fp32; one warp per row
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < BQ; r += THREADS / 32) {
    const int n = q0 + r;
    float s = 0.f;
    if (n < N)
      for (int d = lane; d < DH; d += 32) {
        const size_t a = base + static_cast<size_t>(n) * D + d;
        s = fmaf(to_f(dout[a]), to_f(o[a]), s);
      }
    s = warp_sum(s);
    if (lane == 0) {
      Dl[r] = s;
      L[r] = n < N ? lse[rbase + n] : 0.f;
      if (n < N) delta[rbase + n] = s;
    }
  }

  float acc[4][CPT] = {};
  for (int k0 = 0; k0 < N; k0 += BK) {
    const int kn = min(BK, N - k0);
    __syncthreads();
    for (int e = tid; e < kn * DH; e += THREADS) {
      const int r = e / DH, d = e - r * DH;
      const size_t a = base + static_cast<size_t>(k0 + r) * D + d;
      Ks[r * LDH + d] = to_f(k[a]);
      Vs[r * LDH + d] = to_f(v[a]);
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    for (int d = 0; d < DH; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(tr * 4 + i) * LDH + d];
        ov[i] = dOs[(tr * 4 + i) * LDH + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tc + 16 * j) * LDH + d];
        vv[j] = Vs[(tc + 16 * j) * LDH + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tc + 16 * j, key = k0 + c;
      const float bias = c < kn ? key_bias(mask, b, N, key) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tr * 4 + i;
        float ds = 0.f;
        if (c < kn) {
          float sv = s[i][j] * scale + bias;
          if (causal && key > q0 + r) sv = NEG;
          const float w = expf(sv - L[r]);
          float dw = dp[i][j];
          if constexpr (DROP) {
            // dW = dm ? dP / keep : 0, along this block's rows of dm
            const int n = q0 + r;
            dw = n < N && dm[(rbase + n) * N + key] ? dw / keep : 0.f;
          }
          ds = round_to(w * (dw - Dl[r]), q);
        }
        dS[r * (BK + 1) + c] = ds;
      }
    }
    __syncthreads();
    for (int c = 0; c < kn; ++c) {
      float dv[4], kv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = dS[(tr * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[c * LDH + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(dv[i], kv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + tr * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      st(dq, base + static_cast<size_t>(n) * D + tc + 16 * j,
         acc[i][j] * scale);
  }
}

// dK and dV for 32 keys of one head of one sample; queries, dO, lse and
// Delta stream through shared memory in chunks of 64.
template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(THREADS)
    mha_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ mask,
                        const uint8_t* __restrict__ dm, T* __restrict__ dk,
                        T* __restrict__ dv, int N, int D, float scale,
                        int causal, float keep) {
  constexpr int LDH = DH + 1;
  constexpr int CPT = DH / 16;
  extern __shared__ float sm[];
  float* Ks = sm;                    // [BKV][LDH]
  float* Vs = Ks + BKV * LDH;        // [BKV][LDH]
  float* Qs = Vs + BKV * LDH;        // [BQC][LDH]
  float* dOs = Qs + BQC * LDH;       // [BQC][LDH]
  float* WT = dOs + BQC * LDH;       // [BKV][BQC + 1]  W^T, V's dtype
  float* dST = WT + BKV * (BQC + 1); // [BKV][BQC + 1]  dS^T, q's dtype
  float* L = dST + BKV * (BQC + 1);  // [BQC]
  float* Dl = L + BQC;               // [BQC]
  // [BQC][DMS] keep-mask tile (DROP only): this block's 32 columns of dm
  uint8_t* DM = reinterpret_cast<uint8_t*>(Dl + BQC);
  const float keep_v = round_to(keep, v);

  const int k0 = blockIdx.x * BKV, h = blockIdx.y, H = gridDim.y;
  const size_t b = blockIdx.z;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const size_t base = b * N * static_cast<size_t>(D) + h * DH;
  const size_t rbase = (b * H + h) * static_cast<size_t>(N);

  for (int e = tid; e < BKV * DH; e += THREADS) {
    const int r = e / DH, d = e - r * DH, n = k0 + r;
    const size_t a = base + static_cast<size_t>(n) * D + d;
    Ks[r * LDH + d] = n < N ? to_f(k[a]) : 0.f;
    Vs[r * LDH + d] = n < N ? to_f(v[a]) : 0.f;
  }
  float kb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + tr * 4 + i;
    kb[i] = key < N ? key_bias(mask, b, N, key) : 0.f;
  }

  float acck[4][CPT] = {}, accv[4][CPT] = {};
  for (int c0 = 0; c0 < N; c0 += BQC) {
    const int qn = min(BQC, N - c0);
    __syncthreads();
    for (int e = tid; e < qn * DH; e += THREADS) {
      const int r = e / DH, d = e - r * DH;
      const size_t a = base + static_cast<size_t>(c0 + r) * D + d;
      Qs[r * LDH + d] = to_f(q[a]);
      dOs[r * LDH + d] = to_f(dout[a]);
    }
    for (int r = tid; r < qn; r += THREADS) {
      L[r] = lse[rbase + c0 + r];
      Dl[r] = delta[rbase + c0 + r];
    }
    if constexpr (DROP) {
      // a warp reads the 32 consecutive bytes of one query's row
      for (int e = tid; e < qn * BKV; e += THREADS) {
        const int c = e / BKV, r = e - c * BKV, key = k0 + r;
        DM[c * DMS + r] = key < N ? dm[(rbase + c0 + c) * N + key] : 0;
      }
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    for (int d = 0; d < DH; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(tr * 4 + i) * LDH + d];
        vv[i] = Vs[(tr * 4 + i) * LDH + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tc + 16 * j) * LDH + d];
        ov[j] = dOs[(tc + 16 * j) * LDH + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i, key = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j, query = c0 + c;
        float w = 0.f, ds = 0.f;
        if (c < qn && key < N) {
          float sv = s[i][j] * scale + kb[i];
          if (causal && key > query) sv = NEG;
          const float wf = expf(sv - L[c]);
          w = round_to(wf, v);
          float dw = dp[i][j];
          if constexpr (DROP) {
            const bool kept = DM[c * DMS + r] != 0;
            w = kept ? round_to(w / keep_v, v) : 0.f;
            dw = kept ? dw / keep : 0.f;
          }
          ds = round_to(wf * (dw - Dl[c]), q);
        }
        WT[r * (BQC + 1) + c] = w;
        dST[r * (BQC + 1) + c] = ds;
      }
    }
    __syncthreads();
    for (int c = 0; c < qn; ++c) {
      float wv[4], sv[4], ov[CPT], qv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wv[i] = WT[(tr * 4 + i) * (BQC + 1) + c];
        sv[i] = dST[(tr * 4 + i) * (BQC + 1) + c];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        ov[j] = dOs[c * LDH + tc + 16 * j];
        qv[j] = Qs[c * LDH + tc + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          accv[i][j] = fmaf(wv[i], ov[j], accv[i][j]);
          acck[i][j] = fmaf(sv[i], qv[j], acck[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = k0 + tr * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const size_t a = base + static_cast<size_t>(n) * D + tc + 16 * j;
      st(dk, a, acck[i][j] * scale);
      st(dv, a, accv[i][j]);
    }
  }
}

template <typename T, int DH, bool DROP>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       const int* mask, const uint8_t* dm, void* dq, void* dk,
                       void* dv, float* delta, int B, int N, int D, int heads,
                       float scale, int causal, float keep,
                       cudaStream_t stream) {
  constexpr int LDH = DH + 1;
  const size_t smem_q =
      sizeof(float) * ((2 * BQ + 2 * BK) * LDH + BQ * (BK + 1) + 2 * BQ);
  const size_t smem_kv = sizeof(float) *
      ((2 * BKV + 2 * BQC) * LDH + 2 * BKV * (BQC + 1) + 2 * BQC) +
      (DROP ? BQC * DMS : 0);
  auto kq = mha_bwd_dq_kernel<T, DH, DROP>;
  auto kkv = mha_bwd_dkdv_kernel<T, DH, DROP>;
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  kq<<<dim3((N + BQ - 1) / BQ, heads, B), THREADS, smem_q, stream>>>(
      tq, tk, tv, static_cast<const T*>(o), tdo, lse, mask, dm,
      static_cast<T*>(dq), delta, N, D, scale, causal, keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<dim3((N + BKV - 1) / BKV, heads, B), THREADS, smem_kv, stream>>>(
      tq, tk, tv, tdo, lse, delta, mask, dm, static_cast<T*>(dk),
      static_cast<T*>(dv), N, D, scale, causal, keep);
  return cudaGetLastError();
}

// Calls CALL(T, DH) for the dtype code and head dim, or returns
// cudaErrorInvalidValue.
#define MHA_DISPATCH(DTYPE, DH, CALL)                             \
  if ((DTYPE) == 0) {                                             \
    if ((DH) == 32) return CALL(float, 32);                       \
    if ((DH) == 64) return CALL(float, 64);                       \
    if ((DH) == 128) return CALL(float, 128);                     \
  } else if ((DTYPE) == 1) {                                      \
    if ((DH) == 32) return CALL(__nv_bfloat16, 32);               \
    if ((DH) == 64) return CALL(__nv_bfloat16, 64);               \
    if ((DH) == 128) return CALL(__nv_bfloat16, 128);             \
  }                                                               \
  return cudaErrorInvalidValue;

// `dm` non-null selects the dropout variant (and needs `lse`).
cudaError_t forward(const void* q, const void* k, const void* v,
                    const int* mask, const uint8_t* dm, void* o, float* lse,
                    int B, int N, int D, int heads, float scale, int causal,
                    float keep, int dtype, cudaStream_t s) {
  if (N <= 0 || N > 512 || heads <= 0 || D % heads || (dm && !lse) ||
      (dm && !(keep > 0.f)))
    return cudaErrorInvalidValue;
#define FWD(T, DH)                                                          \
  launch<T, DH>(q, k, v, mask, dm, o, lse, B, N, D, heads, scale, causal, \
                keep, s)
  MHA_DISPATCH(dtype, D / heads, FWD)
#undef FWD
}

cudaError_t backward(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     const int* mask, const uint8_t* dm, void* dq, void* dk,
                     void* dv, float* delta, int B, int N, int D, int heads,
                     float scale, int causal, float keep, int dtype,
                     cudaStream_t s) {
  if (N <= 0 || heads <= 0 || D % heads || (dm && !(keep > 0.f)))
    return cudaErrorInvalidValue;
#define BWD(T, DH, DROP)                                                   \
  launch_bwd<T, DH, DROP>(q, k, v, o, dout, lse, mask, dm, dq, dk, dv,     \
                          delta, B, N, D, heads, scale, causal, keep, s)
#define BWD_DROP(T, DH) BWD(T, DH, true)
#define BWD_PLAIN(T, DH) BWD(T, DH, false)
  if (dm) {
    MHA_DISPATCH(dtype, D / heads, BWD_DROP)
  }
  MHA_DISPATCH(dtype, D / heads, BWD_PLAIN)
#undef BWD_PLAIN
#undef BWD_DROP
#undef BWD
}

}  // namespace

// q/k/v/o: [B, N, D] contiguous, head h = columns h*dh:(h+1)*dh; mask:
// [B, N] int32 key validity or null. dtype: 0 = float32, 1 = bfloat16.
// Supports dh in {32, 64, 128} and 1 <= N <= 512. Returns cudaGetLastError().
extern "C" int mha_forward(const void* q, const void* k, const void* v,
                           const void* mask, void* o, int B, int N, int D,
                           int heads, float scale, int causal, int dtype,
                           void* stream) {
  if (B <= 0) return 0;
  return static_cast<int>(forward(q, k, v, static_cast<const int*>(mask),
                                  nullptr, o, nullptr, B, N, D, heads, scale,
                                  causal, 1.f, dtype,
                                  static_cast<cudaStream_t>(stream)));
}

// mha_forward that also writes lse [B, heads, N] (float32): the training
// forward, whose lse the flash backward reads.
extern "C" int mha_forward_lse(const void* q, const void* k, const void* v,
                               const void* mask, void* o, void* lse, int B,
                               int N, int D, int heads, float scale,
                               int causal, int dtype, void* stream) {
  if (B <= 0) return 0;
  return static_cast<int>(forward(q, k, v, static_cast<const int*>(mask),
                                  nullptr, o, static_cast<float*>(lse), B, N,
                                  D, heads, scale, causal, 1.f, dtype,
                                  static_cast<cudaStream_t>(stream)));
}

// mha_forward_lse with dropout on the softmax weights. dm: uint8
// [B, heads, N, N], non-zero = kept; keep = 1 - p > 0. lse is the logsumexp
// of the scores before dropout.
extern "C" int mha_forward_lse_drop(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    const void* dm, void* o, void* lse, int B,
                                    int N, int D, int heads, float scale,
                                    int causal, float keep, int dtype,
                                    void* stream) {
  if (B <= 0) return 0;
  if (!dm) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(forward(q, k, v, static_cast<const int*>(mask),
                                  static_cast<const uint8_t*>(dm), o,
                                  static_cast<float*>(lse), B, N, D, heads,
                                  scale, causal, keep, dtype,
                                  static_cast<cudaStream_t>(stream)));
}

// Flash backward of mha_forward_lse. dout: the output cotangent in q's
// dtype; dq / dk / dv are written in q's dtype. `delta` is a float32
// workspace of B * heads * N values. Any N >= 1. Returns cudaGetLastError().
extern "C" int mha_flash_backward(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* dout, const void* lse,
                                  const void* mask, void* dq, void* dk,
                                  void* dv, void* delta, int B, int N, int D,
                                  int heads, float scale, int causal,
                                  int dtype, void* stream) {
  if (B <= 0) return 0;
  return static_cast<int>(backward(
      q, k, v, o, dout, static_cast<const float*>(lse),
      static_cast<const int*>(mask), nullptr, dq, dk, dv,
      static_cast<float*>(delta), B, N, D, heads, scale, causal, 1.f, dtype,
      static_cast<cudaStream_t>(stream)));
}

// Flash backward of mha_forward_lse_drop, with the same dm and keep.
extern "C" int mha_flash_backward_drop(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, const void* lse,
                                       const void* mask, const void* dm,
                                       void* dq, void* dk, void* dv,
                                       void* delta, int B, int N, int D,
                                       int heads, float scale, int causal,
                                       float keep, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (!dm) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(backward(
      q, k, v, o, dout, static_cast<const float*>(lse),
      static_cast<const int*>(mask), static_cast<const uint8_t*>(dm), dq, dk,
      dv, static_cast<float*>(delta), B, N, D, heads, scale, causal, keep,
      dtype, static_cast<cudaStream_t>(stream)));
}
