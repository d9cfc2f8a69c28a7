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
// exactly as the reference rounds them. In these kernels the products run
// on the fp32 CUDA cores with 4x4 (QK) and 4x ceil(dh/16) (PV) register
// tiles: they serve head dims 32 / 128, fp32 at N > 64, bf16 at N > 256, the
// fp32 eval forward, the fp32 training forward without dropout (its sums are
// taken in the plain version's order, bit for bit), the bf16 dropout
// forward, the eval forward at head dims 80 (OPT-2.7B, causal with a key
// mask, N = 132) and 88 (EVA ViT-g, N = 257), where a PV lane whose last
// column lies past the head skips it, and the training pair without dropout
// at head dim 80 (OPT-2.7B's LoRA training, N = 136, fp32 and bf16: five
// columns a lane in the backward). In bf16 at head dim 64 and N <= 256 (the MM-RCA eval's
// DistilBERT, the ViT val eval and the ViT-B/16 trainer) the eval forward
// and the training pair have a tensor-core route of their own,
// mha_forward_tc / mha_forward_lse_tc / mha_flash_backward_tc (namespace
// ftc below); in fp32 at head dim 64 and N <= 64 (the DistilBERT attention
// of the text and MM-RCA trainers) the backward, with or without dropout,
// and the dropout forward run on 3xTF32 products, mha_flash_backward_tc32
// / mha_forward_lse_tc32 (namespace tc32; the forward without dropout on
// request). kernels/mha_fused.py::flash_plan picks the route.

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
// products run on the fp32 CUDA cores (the bf16 / head dim 64 / N <= 256
// case goes to ftc's tensor-core kernels instead, and the fp32 / head dim
// 64 / N <= 64 case, with or without dropout, to the fused 3xTF32 kernel
// of namespace tc32, mha_flash_backward_tc32).
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

#include <initializer_list>

#include "flash_tc.cuh"  // the bf16 tensor-core forward (namespace ftc)
#include "tc_gemm.cuh"  // mbarrier, TMA and wgmma-descriptor primitives

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
  // output columns per thread in PV: column tc + 16 j; at DH = 88 (EVA
  // ViT-g) the last j covers only lanes tc < 8, the others skip it
  constexpr int CPT = (DH + 15) / 16;
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
      for (int j = 0; j < CPT; ++j)
        vv[j] = tc + 16 * j < DH ? KVs[c * LDH + tc + 16 * j] : 0.f;
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
      if (tc + 16 * j < DH)
        st(o, base + static_cast<size_t>(n) * D + tc + 16 * j, acc[i][j]);
  }
}

template <typename T, int DH, bool LSE, bool DROP>
cudaError_t launch_kernel(const void* q, const void* k, const void* v,
                          const int* mask, const uint8_t* dm, void* o,
                          float* lse, int B, int N, int D, int heads,
                          float scale, int causal, float keep,
                          cudaStream_t stream) {
  // (BQ + BK) x (DH + 1) fp32 tiles + BQ x N fp32 scores: 67,072 bytes at
  // EVA ViT-g's DH = 88, N = 257, over the 48 KB a launch gets by default
  const size_t smem =
      sizeof(float) * ((BQ + BK) * (DH + 1) + static_cast<size_t>(BQ) * N);
  auto kern = mha_kernel<T, DH, LSE, DROP>;
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

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* mask, const uint8_t* dm, void* o, float* lse,
                   int B, int N, int D, int heads, float scale, int causal,
                   float keep, cudaStream_t stream) {
  auto go = dm    ? launch_kernel<T, DH, true, true>
            : lse ? launch_kernel<T, DH, true, false>
                  : launch_kernel<T, DH, false, false>;
  return go(q, k, v, mask, dm, o, lse, B, N, D, heads, scale, causal, keep,
            stream);
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

// The eval forward alone (no lse, no dropout) also takes head dims 80
// (OPT-2.7B: 2560 / 32 heads) and 88 (EVA ViT-g: 1408 / 16 heads): calls
// CALL(T, DH) for them and falls through otherwise.
#define EVAL_ONLY_DISPATCH(DTYPE, DH, CALL)                       \
  if ((DTYPE) == 0) {                                             \
    if ((DH) == 80) return CALL(float, 80);                       \
    if ((DH) == 88) return CALL(float, 88);                       \
  } else if ((DTYPE) == 1) {                                      \
    if ((DH) == 80) return CALL(__nv_bfloat16, 80);               \
    if ((DH) == 88) return CALL(__nv_bfloat16, 88);               \
  }

// The flash pair without dropout (the lse forward and the backward) also
// takes head dim 80 (OPT-2.7B's LoRA training: 2560 / 32 heads, causal with
// the left-pad key mask, N = 136): calls CALL(T, 80) and falls through
// otherwise. The backward's lanes take DH / 16 = 5 columns each there; 88
// (EVA ViT-g, which never trains) does not divide into 16 lanes and stays
// refused, as the dropout pair stays at {32, 64, 128}.
#define TRAIN80_DISPATCH(DTYPE, DH, CALL)                         \
  if ((DH) == 80) {                                               \
    if ((DTYPE) == 0) return CALL(float, 80);                     \
    if ((DTYPE) == 1) return CALL(__nv_bfloat16, 80);             \
  }

// `dm` non-null selects the dropout variant (and needs `lse`).
cudaError_t forward(const void* q, const void* k, const void* v,
                    const int* mask, const uint8_t* dm, void* o, float* lse,
                    int B, int N, int D, int heads, float scale, int causal,
                    float keep, int dtype, cudaStream_t s) {
  if (N <= 0 || N > 512 || heads <= 0 || D % heads || (dm && !lse) ||
      (dm && !(keep > 0.f)))
    return cudaErrorInvalidValue;
  if (!lse) {
#define EVAL(T, DH)                                                       \
  launch_kernel<T, DH, false, false>(q, k, v, mask, nullptr, o, nullptr, B, \
                                     N, D, heads, scale, causal, 1.f, s)
    EVAL_ONLY_DISPATCH(dtype, D / heads, EVAL)
#undef EVAL
  } else if (!dm) {
#define FWD_LSE(T, DH)                                                    \
  launch_kernel<T, DH, true, false>(q, k, v, mask, nullptr, o, lse, B, N, D, \
                                    heads, scale, causal, 1.f, s)
    TRAIN80_DISPATCH(dtype, D / heads, FWD_LSE)
#undef FWD_LSE
  }
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
  TRAIN80_DISPATCH(dtype, D / heads, BWD_PLAIN)
  MHA_DISPATCH(dtype, D / heads, BWD_PLAIN)
#undef BWD_PLAIN
#undef BWD_DROP
#undef BWD
}

// ---------------------------------------------------------------------------
// the flash pair on the tensor cores: bf16, head dim 64, 1 <= N <= 256
// ---------------------------------------------------------------------------
//
// mha_forward_lse_tc and mha_flash_backward_tc compute what mha_forward_lse
// and mha_flash_backward compute, at the same rounding points, with every
// product on wgmma (bf16 operands, fp32 sums: the products the reference
// takes, summed in another order). The forward, its products, its plan
// check and its launch live in flash_tc.cuh (namespace ftc), which
// transformer_block.cu shares for the attention blocks' core; K2
// (mha_forward_tc) is the same kernel without the lse store. The backward
// below reuses its tiles and products: one warpgroup (128 threads) per
// block, two blocks per SM, every tile of q / k / v / dO by TMA through the
// same 3-D maps, read from shared memory by wgmma, K-major where d is the
// product's depth (S = Q K^T, dP = dO V^T) and MN-major where the keys or
// queries are (dQ = dS K, dV = W^T dO, dK = dS^T Q: A then comes from
// registers, the accumulator of the product before it, rounded to bf16
// pairwise: the fp32 accumulator of a 64 x 16 slab is laid out as wgmma's
// A fragment).
//
//   * backward: two kernels, no atomics, the same bits on every run, each
//     one block per (head, sample) that keeps one side of the head in
//     shared memory and streams the other side's 64-row tiles through two
//     stages (a block per 64-row tile re-read the kept side from L2 for
//     every tile: 2.5x the L2 traffic, 14% slower). The dQ kernel keeps K
//     and V; per query tile it writes Delta = rowsum(dO O) (fp32) and walks
//     the keys in tiles of 64: S and dP (64 x 64 each), W = exp(S - lse),
//     dS = W (dP - Delta) rounded to bf16, dQ += dS K. The dK / dV kernel
//     keeps Q and dO; per key tile it walks the queries: S^T = K Q^T,
//     dP^T = V dO^T, W^T and dS^T, then dV += W^T dO (W rounded to bf16)
//     and dK += dS^T Q.
// What bounds it: bytes (0.093 ms for the backward at 128 x 197 x 768
// on 3.35 TB/s against 0.039 ms of bf16 tensor-core time for 10 B N^2 D
// operations); the exp and the masking run on the CUDA cores beside the
// products.

namespace ftc {

// dynamic shared memory of the backward's kernels (+ 1024: the 1 KB
// alignment that the 128-byte swizzle needs); kept equal to the plan's in
// kernels/mha_fused.py::flash_plan
__host__ __device__ inline int dq_smem(int nt) {
  return (2 * nt + 4) * BOX + MAX_N * 4 + T * 4 + (nt + 2) * 8 + 1024;
}
__host__ __device__ inline int dkdv_smem(int nt) {
  return (2 * nt + 4) * BOX + 2 * MAX_N * 4 + (nt + 2) * 8 + 1024;
}

// Q and dO (dQ kernel) or K and V (dK / dV kernel) of 64-row tile t into
// stage t % 2 of the two-stage ring at `st`; completion on sbar[t % 2].
__device__ __forceinline__ void load_pair(uint32_t st, uint64_t* sbar,
                                          const CUtensorMap* a,
                                          const CUtensorMap* b2, int h,
                                          int t, int b) {
  const uint32_t dst = st + 2 * (t & 1) * BOX;
  tc::mbar_expect_tx(sbar + (t & 1), 2 * BOX);
  tc::tma_load_3d(dst, a, sbar + (t & 1), h * DH, t * T, b);
  tc::tma_load_3d(dst + BOX, b2, sbar + (t & 1), h * DH, t * T, b);
}

// dQ and Delta for all query tiles of one (head, sample): K and V of the
// head stay in shared memory, the query tiles' Q and dO stream through two
// stages.
template <bool MASKED, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 2)
    dq_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo,
              const __nv_bfloat16* __restrict__ o,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const int* __restrict__ mask,
              __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
              int N, int D, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1k(smem_raw);
  const int nt = tiles(N), np = pad16(N);
  const uint32_t ks = tc::smem_u32(smem), vs = ks + nt * BOX,
                 st = vs + nt * BOX;
  float* kb = reinterpret_cast<float*>(smem + (2 * nt + 4) * BOX);  // [MAX_N]
  float* dl = kb + MAX_N;                                            // [T]
  uint64_t* bar = reinterpret_cast<uint64_t*>(dl + T);  // K_c + V_c
  uint64_t* sbar = bar + nt;                            // the two stages
  const int h = blockIdx.x, H = gridDim.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  if (tid == 0) init_bars(bar, nt + 2);
  __syncthreads();
  if (tid == 0) {
    load_pair(st, sbar, &tq, &tdo, h, 0, b);
    for (int c = 0; c < nt; ++c) {
      tc::mbar_expect_tx(bar + c, 2 * BOX);
      tc::tma_load_3d(ks + c * BOX, &tk, bar + c, h * DH, c * T, b);
      tc::tma_load_3d(vs + c * BOX, &tv, bar + c, h * DH, c * T, b);
    }
    if (nt > 1) load_pair(st, sbar, &tq, &tdo, h, 1, b);
  }
  if (MASKED)
    for (int j = tid; j < N; j += THREADS) kb[j] = key_bias_of(mask, b, N, j);
  const size_t rbase = (static_cast<size_t>(b) * H + h) * N;
  const int lane = tid & 31, r0 = 16 * (tid >> 5) + (lane >> 2),
            c0 = 2 * (lane & 3);
  for (int qt = 0; qt < nt; ++qt) {
    // every thread is done with tile qt - 1: its stage and dl are free
    __syncthreads();
    if (tid == 0 && qt >= 1 && qt + 1 < nt)
      load_pair(st, sbar, &tq, &tdo, h, qt + 1, b);
    {
      // Delta = rowsum(dO O) in fp32, two threads a row, 32 columns each
      const int row = tid >> 1, qi = qt * T + row;
      float acc = 0.f;
      if (qi < N) {
        const size_t a =
            (static_cast<size_t>(b) * N + qi) * D + h * DH + 32 * (tid & 1);
#pragma unroll
        for (int d = 0; d < 32; d += 8) {
          const uint4 x = *reinterpret_cast<const uint4*>(dout + a + d);
          const uint4 y = *reinterpret_cast<const uint4*>(o + a + d);
          const __nv_bfloat162* xp =
              reinterpret_cast<const __nv_bfloat162*>(&x);
          const __nv_bfloat162* yp =
              reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 xf = __bfloat1622float2(xp[i]);
            const float2 yf = __bfloat1622float2(yp[i]);
            acc = fmaf(xf.x, yf.x, acc);
            acc = fmaf(xf.y, yf.y, acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if ((tid & 1) == 0) {
        dl[row] = acc;
        if (qi < N) delta[rbase + qi] = acc;
      }
    }
    __syncthreads();
    float L[2], Dl[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qi = qt * T + r0 + 8 * hh;
      L[hh] = qi < N ? lse[rbase + qi] : 0.f;  // a pad row's lse is not read
      Dl[hh] = dl[r0 + 8 * hh];
    }
    const uint32_t qs = st + 2 * (qt & 1) * BOX, dos = qs + BOX;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    tc::mbar_wait(sbar + (qt & 1), (qt >> 1) & 1);
    for (int c = 0; c < nt; ++c) {
      const int w = np - c * T;  // keys of this tile that the products cover
      tc::mbar_wait(bar + c, 0);
      float s[32], dp[32];
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ss(s, kmajor(qs + 32 * kk), kmajor(ks + c * BOX + 32 * kk), w, kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ss(dp, kmajor(dos + 32 * kk), kmajor(vs + c * BOX + 32 * kk), w, kk);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_acc(s);
      tc::fence_acc(dp);
      // dS = W (dP - Delta), W = exp(S - lse); 0 on pad keys
      const bool tail = c * T + T > N;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        const int key = c * T + 8 * (i >> 2) + c0 + (i & 1);
        float sv = s[i] * scale;
        if (MASKED) sv += kb[key];
        if (CAUSAL && key > qt * T + r0 + 8 * hh) sv = NEG;
        float x = expf(sv - L[hh]) * (dp[i] - Dl[hh]);
        if (tail && key >= N) x = 0.f;
        s[i] = x;
      }
      uint32_t a[16];
      frag(a, s);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (16 * kk < w)
          rs64(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
               mnmajor(ks + c * BOX + 2048 * kk));
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_acc(acc);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qi = qt * T + r0 + 8 * hh;
      if (qi >= N) continue;
      __nv_bfloat16* row =
          dq + (static_cast<size_t>(b) * N + qi) * D + h * DH;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + c0) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh] * scale,
                                  acc[4 * j + 2 * hh + 1] * scale);
    }
  }
}

// dK and dV for all key tiles of one (head, sample): Q and dO of the head
// stay in shared memory, the key tiles' K and V stream through two stages.
template <bool MASKED, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 2)
    dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ mask,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                int N, int D, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1k(smem_raw);
  const int nt = tiles(N), np = pad16(N);
  const uint32_t qs = tc::smem_u32(smem), dos = qs + nt * BOX,
                 st = dos + nt * BOX;
  float* Ls = reinterpret_cast<float*>(smem + (2 * nt + 4) * BOX);  // [MAX_N]
  float* Ds = Ls + MAX_N;                                            // [MAX_N]
  uint64_t* bar = reinterpret_cast<uint64_t*>(Ds + MAX_N);  // Q_c + dO_c
  uint64_t* sbar = bar + nt;                                // the two stages
  const int h = blockIdx.x, H = gridDim.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  if (tid == 0) init_bars(bar, nt + 2);
  __syncthreads();
  if (tid == 0) {
    load_pair(st, sbar, &tk, &tv, h, 0, b);
    for (int c = 0; c < nt; ++c) {
      tc::mbar_expect_tx(bar + c, 2 * BOX);
      tc::tma_load_3d(qs + c * BOX, &tq, bar + c, h * DH, c * T, b);
      tc::tma_load_3d(dos + c * BOX, &tdo, bar + c, h * DH, c * T, b);
    }
    if (nt > 1) load_pair(st, sbar, &tk, &tv, h, 1, b);
  }
  const size_t rbase = (static_cast<size_t>(b) * H + h) * N;
  for (int j = tid; j < nt * T; j += THREADS) {
    Ls[j] = j < N ? lse[rbase + j] : 0.f;
    Ds[j] = j < N ? delta[rbase + j] : 0.f;
  }
  const int lane = tid & 31, r0 = 16 * (tid >> 5) + (lane >> 2),
            c0 = 2 * (lane & 3);
  for (int kt = 0; kt < nt; ++kt) {
    // every thread is done with tile kt - 1: its stage is free
    __syncthreads();
    if (tid == 0 && kt >= 1 && kt + 1 < nt)
      load_pair(st, sbar, &tk, &tv, h, kt + 1, b);
    float kbias[2];
    bool live[2];  // this thread's two keys are real ones
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = kt * T + r0 + 8 * hh;
      live[hh] = key < N;
      kbias[hh] = MASKED && live[hh] ? key_bias_of(mask, b, N, key) : 0.f;
    }
    const uint32_t ks = st + 2 * (kt & 1) * BOX, vs = ks + BOX;
    float dka[32], dva[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
    tc::mbar_wait(sbar + (kt & 1), (kt >> 1) & 1);
    for (int c = 0; c < nt; ++c) {
      const int w = np - c * T;  // queries of this tile the products cover
      tc::mbar_wait(bar + c, 0);
      float stt[32], dpt[32];
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ss(stt, kmajor(ks + 32 * kk), kmajor(qs + c * BOX + 32 * kk), w, kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ss(dpt, kmajor(vs + 32 * kk), kmajor(dos + c * BOX + 32 * kk), w,
           kk);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_acc(stt);
      tc::fence_acc(dpt);
      // rows are keys, columns queries: W^T and dS^T, 0 on pad keys /
      // queries
      const bool tail = c * T + T > N;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        const int key = kt * T + r0 + 8 * hh;
        const int qi = c * T + 8 * (i >> 2) + c0 + (i & 1);
        float sv = stt[i] * scale;
        if (MASKED) sv += kbias[hh];
        if (CAUSAL && key > qi) sv = NEG;
        float wv = expf(sv - Ls[qi]);
        float x = wv * (dpt[i] - Ds[qi]);
        if (!live[hh] || (tail && qi >= N)) wv = x = 0.f;
        stt[i] = wv;
        dpt[i] = x;
      }
      uint32_t aw[16], ad[16];
      frag(aw, stt);
      frag(ad, dpt);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (16 * kk < w) {
          rs64(dva, aw[4 * kk], aw[4 * kk + 1], aw[4 * kk + 2],
               aw[4 * kk + 3], mnmajor(dos + c * BOX + 2048 * kk));
          rs64(dka, ad[4 * kk], ad[4 * kk + 1], ad[4 * kk + 2],
               ad[4 * kk + 3], mnmajor(qs + c * BOX + 2048 * kk));
        }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_acc(dva);
      tc::fence_acc(dka);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = kt * T + r0 + 8 * hh;
      if (key >= N) continue;
      const size_t a = (static_cast<size_t>(b) * N + key) * D + h * DH;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk + a + 8 * j + c0) =
            __floats2bfloat162_rn(dka[4 * j + 2 * hh] * scale,
                                  dka[4 * j + 2 * hh + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + a + 8 * j + c0) =
            __floats2bfloat162_rn(dva[4 * j + 2 * hh],
                                  dva[4 * j + 2 * hh + 1]);
      }
    }
  }
}

// The forward of flash_tc.cuh with lse (K4a) or without (K2), its instance
// picked from the call.
cudaError_t forward(const void* q, const void* k, const void* v,
                    const int* mask, void* o, float* lse, int B, int N, int D,
                    int heads, float scale, int causal, int np, dim3 grid,
                    int smem, cudaStream_t stream) {
#define FWD(M, C, L)                                                          \
  return launch_forward<M, C, L>(q, k, v, mask, o, lse, B, N, D, heads,    \
                                 scale, np, grid, smem, stream)
  if (lse) {
    if (mask) {
      if (causal) FWD(true, true, true);
      FWD(true, false, true);
    }
    if (causal) FWD(false, true, true);
    FWD(false, false, true);
  }
  if (mask) {
    if (causal) FWD(true, true, false);
    FWD(true, false, false);
  }
  if (causal) FWD(false, true, false);
  FWD(false, false, false);
#undef FWD
}

cudaError_t backward(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     const int* mask, void* dq, void* dk, void* dv,
                     float* delta, int B, int N, int D, int heads,
                     float scale, int causal, int np, dim3 grid_q,
                     int smem_q, dim3 grid_kv, int smem_kv,
                     cudaStream_t stream) {
  const int nt = tiles(N);
  if (!plan_ok(B, N, D, heads, np) || grid_q.x != unsigned(heads) ||
      grid_q.y != unsigned(B) || grid_q.z != 1 || grid_kv.x != grid_q.x ||
      grid_kv.y != grid_q.y || grid_kv.z != 1 || smem_q != dq_smem(nt) ||
      smem_kv != dkdv_smem(nt) || !aligned16({q, k, v, o, dout, dq, dk, dv}))
    return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = tc::make_map_3d(&mq, q, B, N, D, T);
  if (err == cudaSuccess) err = tc::make_map_3d(&mk, k, B, N, D, T);
  if (err == cudaSuccess) err = tc::make_map_3d(&mv, v, B, N, D, T);
  if (err == cudaSuccess) err = tc::make_map_3d(&mdo, dout, B, N, D, T);
  auto kq = mask ? (causal ? dq_kernel<true, true> : dq_kernel<true, false>)
                 : (causal ? dq_kernel<false, true>
                           : dq_kernel<false, false>);
  auto kkv = mask ? (causal ? dkdv_kernel<true, true>
                            : dkdv_kernel<true, false>)
                  : (causal ? dkdv_kernel<false, true>
                            : dkdv_kernel<false, false>);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  kq<<<grid_q, THREADS, smem_q, stream>>>(
      mq, mk, mv, mdo, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, mask,
      static_cast<__nv_bfloat16*>(dq), delta, N, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<grid_kv, THREADS, smem_kv, stream>>>(
      mq, mk, mv, mdo, lse, delta, mask, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), N, D, scale);
  return cudaGetLastError();
}

}  // namespace ftc

// ---------------------------------------------------------------------------
// the fp32 flash backward on the tensor cores: 3xTF32, head dim 64, N <= 64
// ---------------------------------------------------------------------------
//
// mha_flash_backward_tc32 computes what mha_flash_backward (dm null) and
// mha_flash_backward_drop compute in fp32 at head dim 64 and N <= 64 (the
// DistilBERT attention of the text and MM-RCA trainers, with and without
// --hf_internal_dropout), in one kernel where the CUDA-core route takes two.
// One block per (head, sample) holds the whole head in shared memory: Q, K,
// V and dO (64 x 64 fp32 each), its N x N keep-mask bytes (read once, along
// the rows), lse and Delta = rowsum(dO O). Each of its eight warps owns 16
// query rows and 32 of the keys: S = Q K^T and dP = dO V^T, then per score
// W = exp(S - lse), the weights after dropout wld = dm ? W / keep : 0, dW =
// dm ? dP / keep : 0 and dS = W (dW - Delta) (the CUDA-core kernels'
// rounding points; fp32 throughout), then its part of dQ = dS K * scale
// from dS still in registers; the two warps of a row slab add their parts
// through the freed V tile, in a fixed order. wld and dS go to shared
// memory; after a block barrier each warp owns 16 keys and 32 columns: dV =
// wld^T dO and dK = dS^T Q * scale. Five N x N x 64 products where the two
// CUDA-core kernels take seven, the mask read once, nothing summed across
// blocks: no atomics, the same bits on every run. Eight warps, not four:
// the products are chains of dependent mma.sync, so the SM needs warps in
// flight to hide their latency (two 107 KB blocks, 16 warps, an SM).
//
// Products: mma.sync m16n8k8 tf32 with fp32 sums. Each fp32 operand x is
// split as hi = tf32(x), lo = tf32(x - hi) (cvt.rna) and the product taken
// as lo.hi + hi.lo + hi.hi ("3xTF32", CUTLASS's fast fp32 multiply-add):
// about 2^-21 relative per product, inside the fp32 backward bar 5e-5
// (1 + |x|). Not wgmma: it reads tf32 operands from shared memory K-major
// only, and four of the five products (dQ, dV, dK: K, wld, dS, dO and Q)
// read an operand whose depth runs down the tile's rows. With mma.sync each
// fragment is loaded from a tile of row stride 68 floats (= 4 mod 32) in
// the orientation its product needs, free of bank conflicts: along a row for
// S and dP ((row g, column t): banks 4g + t) and down the rows for the
// other three, with the depth index permuted inside each group of 8 (k = t
// reads row 2t, k = t + 4 row 2t + 1: banks 8t + g and 8t + 4 + g). The
// same permutation makes the accumulator of S's n8 tile j the A fragment of
// dQ's k8 step j. Rows and keys past N are zeros in the tiles and are set
// to zero in wld and dS, so every product runs over the full 64.
// What bounds it: bytes. At 128 x 64 x 768 with the mask 208 MB move
// (0.062 ms at 3.35 TB/s), against 12.1 GFLOP of tf32 products (0.025 ms
// at 495 TFLOP/s); with two blocks an SM, one block's loads run beside
// the other's products.
//
// mha_forward_lse_tc32 is the forward of the same pair, K7a (dm the keep
// mask) and K4a (dm null; flash_plan takes it only on request, PERF.md §6
// says why), replacing ::_mha_fwd_lse_drop (body `_fwd_lse_drop_kernel`)
// and ::_mha_fwd_lse (`_fwd_lse_kernel`: the same body without the mask)
// in fp32 at head dim 64 and N <= 64, where the CUDA-core kernel above runs
// its products on fp32 SIMT, stores the score rows in shared memory and
// reads them back twice, and reads each head's K and V twice (a block per
// 32 rows). One block per (head, sample) with the same eight warps and
// tiles: cp.async brings Q and K, then V in a second group that lands while
// S is formed; S = Q K^T by the backward's own function (abt: the same
// bits, so the backward's W = exp(S - lse) meets this lse); scale, key
// bias and causal in the plain version's order; the exact two-pass softmax
// in registers, each row's max and sum over the quad and then over the two
// key halves through shared memory (half 0's sum first); lse = max +
// log(sum); wl = e / sum and, with dropout, wld = dm ? wl / keep : 0, both
// correctly rounded by div_rn; then O = wld V with wld still in registers
// (S's accumulator is the A fragment of the k8 steps, as dS is for dQ in
// the backward) over each warp's 32 keys, the halves' partial sums added
// through Q's freed tile, float2 stores. 58 KB of shared memory, three
// blocks an SM. Bound: bytes, 107 MB at 128 x 64 x 768 with the mask
// (0.032 ms) against 4.8 GFLOP of tf32 products (0.010 ms).

namespace tc32 {

constexpr int DH = 64;        // head dim
constexpr int MAX_N = 64;     // the whole head in one block
constexpr int THREADS = 256;  // eight warps: four 16-row slabs x two
                              // 32-column halves
constexpr int LD = 68;        // row stride of the fp32 tiles, in floats
constexpr int DMS = 68;       // row stride of the keep-mask tile, in bytes
// dynamic shared memory: Q, K, V, dO, wld and dS ([64][LD] fp32 each),
// lse, Delta and the key bias ([64] fp32 each), the keep mask ([64][DMS]
// bytes); kept equal to the plan's in kernels/mha_fused.py::flash_plan
constexpr int SMEM = 6 * MAX_N * LD * 4 + 3 * MAX_N * 4 + MAX_N * DMS;
// the forward's: Q, K and V ([64][LD] fp32 each), the key bias ([64]
// fp32), the row max / sum of each key half ([2][2][64] fp32), the keep
// mask ([64][DMS] bytes): 57,856 bytes, three blocks to an SM; kept equal
// to TC32_FWD_SMEM in kernels/mha_fused.py
constexpr int FWD_SMEM = 3 * MAX_N * LD * 4 + 5 * MAX_N * 4 + MAX_N * DMS;
constexpr int FWD_BLOCKS = 3;  // blocks an SM the forward is compiled for

// a / b rounded to nearest from rb = 1 / b (rounded to nearest): a * rb,
// then two Markstein corrections q + (a - q b) rb, each one exact residual
// and one rounding. For the finite, normal operands here it gives the bits
// of IEEE division without its branch to a slow path, which took 10% of
// a first version's time (0.391 -> 0.350 ms at 128 x 64 x 768, p 0.1).
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  float q = a * rb;
  q = fmaf(fmaf(-q, b, a), rb, q);
  return fmaf(fmaf(-q, b, a), rb, q);
}

struct Frag4 {  // an A fragment split in two tf32 halves
  uint32_t hi[4], lo[4];
};
struct Frag2 {  // a B fragment
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

__device__ __forceinline__ Frag4 split4(float a0, float a1, float a2,
                                        float a3) {
  Frag4 f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ Frag2 split2(float b0, float b1) {
  Frag2 f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

// D[16, 8] += A[16, 8] . B[8, 8] in tf32, fp32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const Frag4& a,
                                     const Frag2& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   tc::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   tc::smem_u32(dst)),
               "l"(src)
               : "memory");
}

// acc = A B^T over 16 rows of A from m0 and 32 rows of B from c0, both
// [64][LD] tiles in shared memory, depth 64, in 3xTF32: S = Q K^T in the
// forward and in the backward (the same bits, so the backward's W = exp(S -
// lse) meets the forward's lse), and dP = dO V^T. Accumulator element e of
// n8 tile j: row m0 + g + 8 (e / 2), column c0 + 8 j + 2 t + e % 2.
__device__ __forceinline__ void abt(float (&acc)[4][4], const float* A,
                                    const float* Bt, int m0, int c0, int g,
                                    int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const float* a = A + (m0 + g) * LD + 8 * kk + t;
    const Frag4 fa = split4(a[0], a[8 * LD], a[4], a[8 * LD + 4]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* br = Bt + (c0 + 8 * j + g) * LD + 8 * kk + t;
      mma3(acc[j], fa, split2(br[0], br[4]));
    }
  }
}

// The head's N x N keep-mask bytes into DM ([64][DMS]), once, along the
// rows: 4-byte cp.async copies where N and the mask's address allow them
// (they land with the caller's next cp.async wait), else bytes.
__device__ __forceinline__ void load_keep_mask(uint8_t* DM,
                                               const uint8_t* src, int N,
                                               bool words_ok, int tid) {
  if (words_ok) {
    const int words = N >> 2;
    for (int e = tid; e < N * words; e += THREADS) {
      const int r = e / words, c = e - r * words;
      cp_async4(DM + r * DMS + 4 * c, src + static_cast<size_t>(r) * N + 4 * c);
    }
  } else {
    for (int e = tid; e < N * N; e += THREADS) {
      const int r = e / N;
      DM[r * DMS + e - r * N] = src[e];
    }
  }
}

// MASKED / CAUSAL: a key mask / causal; DROP: the keep mask dm
template <bool MASKED, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(THREADS, 2)
    bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ o,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const int* __restrict__ mask, const uint8_t* __restrict__ dm,
               float* __restrict__ dq, float* __restrict__ dk,
               float* __restrict__ dv, int N, int D, float scale,
               float keep) {
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);  // [64][LD] each
  float* Ks = Qs + MAX_N * LD;
  float* Vs = Ks + MAX_N * LD;
  float* dOs = Vs + MAX_N * LD;
  float* Ws = dOs + MAX_N * LD;   // [query][key] wld
  float* dSs = Ws + MAX_N * LD;   // [query][key] dS
  float* Ls = dSs + MAX_N * LD;   // [64] lse
  float* Dl = Ls + MAX_N;         // [64] Delta
  float* kb = Dl + MAX_N;         // [64] the key bias
  uint8_t* DM = reinterpret_cast<uint8_t*>(kb + MAX_N);  // [64][DMS]

  const int h = blockIdx.x, H = gridDim.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // this warp's 16-row slab and its half of the 64 columns
  const int m0 = 16 * (warp & 3), half = warp >> 2, c0 = 32 * half;
  const size_t base = static_cast<size_t>(b) * N * D + h * DH;
  const size_t rbase = (static_cast<size_t>(b) * H + h) * N;

  // Q, K, V and dO of the head, 16 bytes a copy; rows past N are zeros
  for (int e = tid; e < 4 * MAX_N * 16; e += THREADS) {
    const int x = e >> 10, r = (e >> 4) & (MAX_N - 1), c = 4 * (e & 15);
    float* dst = Qs + x * MAX_N * LD + r * LD + c;
    if (r < N) {
      const float* src = x == 0 ? q : x == 1 ? k : x == 2 ? v : dout;
      cp_async16(dst, src + base + static_cast<size_t>(r) * D + c);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int j = tid; j < MAX_N; j += THREADS) {
    Ls[j] = j < N ? lse[rbase + j] : 0.f;
    kb[j] = MASKED && j < N
                ? (static_cast<float>(mask[static_cast<size_t>(b) * N + j]) -
                   1.f) * 1e30f
                : 0.f;
  }
  if constexpr (DROP)
    load_keep_mask(DM, dm + rbase * N, N,
                   (N & 3) == 0 && (reinterpret_cast<uintptr_t>(dm) & 3) == 0,
                   tid);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  if (warp < 4) {
    // Delta = rowsum(dO O) in fp32: lane l of warp w sums half l / 16 of
    // row 16 w + l % 16
    const int r = m0 + (lane & 15), cd = 32 * (lane >> 4);
    float acc = 0.f;
    if (r < N) {
      const float4* orow = reinterpret_cast<const float4*>(
          o + base + static_cast<size_t>(r) * D + cd);
      const float4* drow = reinterpret_cast<const float4*>(dOs + r * LD + cd);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 x = __ldg(orow + i), y = drow[i];
        acc = fmaf(y.x, x.x, acc);
        acc = fmaf(y.y, x.y, acc);
        acc = fmaf(y.z, x.z, acc);
        acc = fmaf(y.w, x.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 16);
    if (lane < 16) Dl[r] = acc;
  }
  __syncthreads();

  // S = Q K^T and dP = dO V^T: this warp's 16 query rows, its 32 keys
  float s[4][4], dp[4][4];
  abt(s, Qs, Ks, m0, c0, g, t);
  abt(dp, dOs, Vs, m0, c0, g, t);

  // W, wld and dS per score (accumulator element e of tile j: row
  // m0 + g + 8 (e / 2), key c0 + 8 j + 2 t + e % 2); dS stays in s
  const float L[2] = {Ls[m0 + g], Ls[m0 + g + 8]};
  const float Dd[2] = {Dl[m0 + g], Dl[m0 + g + 8]};
  const float rkeep = 1.f / keep;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + g + 8 * hh, key = c0 + 8 * j + 2 * t;
      uint32_t kept = 0x0101u;
      if constexpr (DROP)
        kept = *reinterpret_cast<const uint16_t*>(DM + row * DMS + key);
      float wd[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float sv = s[j][2 * hh + e] * scale;
        if (MASKED) sv += kb[key + e];
        if (CAUSAL && key + e > row) sv = NEG;
        const float w = expf(sv - L[hh]);
        float x = w, dw = dp[j][2 * hh + e];
        if constexpr (DROP) {
          const bool on = (kept >> (8 * e)) & 0xffu;
          x = on ? div_rn(w, keep, rkeep) : 0.f;
          dw = on ? div_rn(dw, keep, rkeep) : 0.f;
        }
        float y = w * (dw - Dd[hh]);
        if (row >= N || key + e >= N) x = y = 0.f;
        wd[e] = x;
        ds[e] = y;
        s[j][2 * hh + e] = y;
      }
      *reinterpret_cast<float2*>(Ws + row * LD + key) =
          make_float2(wd[0], wd[1]);
      *reinterpret_cast<float2*>(dSs + row * LD + key) =
          make_float2(ds[0], ds[1]);
    }
  }

  // dQ over this warp's 32 keys, all 64 columns, dS from the registers
  // (k = t: key c0 + 8 kk + 2 t); the two halves' sums meet below
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const Frag4 a = split4(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
    const float* kr = Ks + (c0 + 8 * kk + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      mma3(acc[n], a, split2(kr[8 * n], kr[LD + 8 * n]));
  }
  __syncthreads();  // V is free, and every warp's wld and dS are in place
  // the other half's columns of this warp's sum go through V's tile
  float* P = Vs;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if ((n >> 2) == half) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(P + (m0 + g + 8 * hh) * LD + 8 * n +
                                 2 * t) =
          make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
  }
  __syncthreads();
  // dQ = (both halves' sums) * scale, this warp's 32 columns
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + g + 8 * hh;
    if (row >= N) continue;
    float* out = dq + base + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if ((n >> 2) != half) continue;
      const float2 y = *reinterpret_cast<const float2*>(P + row * LD +
                                                        8 * n + 2 * t);
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2((acc[n][2 * hh] + y.x) * scale,
                      (acc[n][2 * hh + 1] + y.y) * scale);
    }
  }

  // dV = wld^T dO and dK = dS^T Q * scale: this warp's 16 keys, its 32
  // columns, over all 64 queries
  float av[4][4], ak[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) av[n][e] = ak[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int r = (8 * kk + 2 * t) * LD;  // query 8 kk + 2 t
    const float* wr = Ws + r + m0 + g;
    const float* sr = dSs + r + m0 + g;
    const Frag4 aw = split4(wr[0], wr[8], wr[LD], wr[LD + 8]);
    const Frag4 as = split4(sr[0], sr[8], sr[LD], sr[LD + 8]);
    const float* orr = dOs + r + c0 + g;
    const float* qr = Qs + r + c0 + g;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      mma3(av[n], aw, split2(orr[8 * n], orr[LD + 8 * n]));
      mma3(ak[n], as, split2(qr[8 * n], qr[LD + 8 * n]));
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = m0 + g + 8 * hh;
    if (key >= N) continue;
    const size_t a = base + static_cast<size_t>(key) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      *reinterpret_cast<float2*>(dv + a + 8 * n) =
          make_float2(av[n][2 * hh], av[n][2 * hh + 1]);
      *reinterpret_cast<float2*>(dk + a + 8 * n) = make_float2(
          ak[n][2 * hh] * scale, ak[n][2 * hh + 1] * scale);
    }
  }
}

// The plan of kernels/mha_fused.py::flash_plan's "tc32" backward (one block
// per (head, sample), SMEM bytes), checked against what the kernel takes.
cudaError_t backward(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     const int* mask, const uint8_t* dm, void* dq, void* dk,
                     void* dv, int B, int N, int D, int heads, float scale,
                     int causal, float keep, dim3 grid, int smem,
                     cudaStream_t stream) {
  if (B <= 0 || heads <= 0 || D != heads * DH || N < 1 || N > MAX_N ||
      grid.x != unsigned(heads) || grid.y != unsigned(B) || grid.z != 1 ||
      smem != SMEM || (dm && !(keep > 0.f)) ||
      !ftc::aligned16({q, k, v, o, dout, dq, dk, dv}))
    return cudaErrorInvalidValue;
  using Kern = void (*)(const float*, const float*, const float*,
                        const float*, const float*, const float*, const int*,
                        const uint8_t*, float*, float*, float*, int, int,
                        float, float);
  Kern kern;
  if (dm)
    kern = mask ? (causal ? bwd_kernel<true, true, true>
                          : bwd_kernel<true, false, true>)
                : (causal ? bwd_kernel<false, true, true>
                          : bwd_kernel<false, false, true>);
  else
    kern = mask ? (causal ? bwd_kernel<true, true, false>
                          : bwd_kernel<true, false, false>)
                : (causal ? bwd_kernel<false, true, false>
                          : bwd_kernel<false, false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), lse, mask, dm,
      static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), N, D, scale, keep);
  return cudaGetLastError();
}

// The forward: out and lse of one head, DROP the keep mask dm. Warp w owns
// query rows m0 = 16 (w % 4) .. + 16 and keys c0 = 32 (w / 4) .. + 32.
template <bool MASKED, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(THREADS, FWD_BLOCKS)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ mask,
               const uint8_t* __restrict__ dm, float* __restrict__ o,
               float* __restrict__ lse, int N, int D, float scale,
               float keep) {
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);  // [64][LD] each
  float* Ks = Qs + MAX_N * LD;
  float* Vs = Ks + MAX_N * LD;
  float* kb = Vs + MAX_N * LD;    // [64] the key bias
  float* red = kb + MAX_N;        // [half][max, sum][64 rows]
  uint8_t* DM = reinterpret_cast<uint8_t*>(red + 4 * MAX_N);  // [64][DMS]

  const int h = blockIdx.x, H = gridDim.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (warp & 3), half = warp >> 2, c0 = 32 * half;
  const size_t base = static_cast<size_t>(b) * N * D + h * DH;
  const size_t rbase = (static_cast<size_t>(b) * H + h) * N;

  // Q and K, then V and the keep mask in a second group that lands while S
  // is formed; 16 bytes a copy, rows past N zeros
  static_assert(2 * MAX_N * 16 % THREADS == 0, "V starts a round of copies");
  for (int e = tid; e < 3 * MAX_N * 16; e += THREADS) {
    if (e - tid == 2 * MAX_N * 16)  // this thread's first copy of V
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int x = e >> 10, r = (e >> 4) & (MAX_N - 1), c = 4 * (e & 15);
    float* dst = Qs + x * MAX_N * LD + r * LD + c;
    if (r < N) {
      const float* src = x == 0 ? q : x == 1 ? k : v;
      cp_async16(dst, src + base + static_cast<size_t>(r) * D + c);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if constexpr (DROP)  // with V's group: needed after the softmax
    load_keep_mask(DM, dm + rbase * N, N,
                   (N & 3) == 0 && (reinterpret_cast<uintptr_t>(dm) & 3) == 0,
                   tid);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int j = tid; j < MAX_N; j += THREADS)
    kb[j] = MASKED && j < N
                ? (static_cast<float>(mask[static_cast<size_t>(b) * N + j]) -
                   1.f) * 1e30f
                : 0.f;
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  // S = Q K^T, then scale, key bias, causal (the plain version's order);
  // keys past N leave the max and the sum
  float s[4][4];
  abt(s, Qs, Ks, m0, c0, g, t);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int hh = i >> 1, key = c0 + 8 * j + 2 * t + (i & 1);
      float x = s[j][i] * scale;
      if (MASKED) x += kb[key];
      if (CAUSAL && key > m0 + g + 8 * hh) x = NEG;
      if (key >= N) x = -INFINITY;
      s[j][i] = x;
      mx[hh] = fmaxf(mx[hh], x);
    }
  // the row max: over the quad, then the two key halves through `red`
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    if (t == 0) red[half * 2 * MAX_N + m0 + g + 8 * hh] = mx[hh];
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // V is in place, Q is free, both halves' maxima too
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + g + 8 * hh;
    mx[hh] = fmaxf(red[row], red[2 * MAX_N + row]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[j][i] = expf(s[j][i] - mx[i >> 1]);
      sum[i >> 1] += s[j][i];
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
    if (t == 0) red[(2 * half + 1) * MAX_N + m0 + g + 8 * hh] = sum[hh];
  }
  __syncthreads();
  // the row sum, half 0's part first; lse; wl = e / sum correctly rounded,
  // then wld = dm ? wl / keep : 0; rows past N get 0
  const float rkeep = 1.f / keep;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + g + 8 * hh;
    const float tot = red[MAX_N + row] + red[3 * MAX_N + row];
    const float rs = 1.f / tot;
    if (half == 0 && t == 0 && row < N) lse[rbase + row] = mx[hh] + logf(tot);
    uint32_t kept = 0x01010101u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = c0 + 8 * j + 2 * t;
      if constexpr (DROP)
        kept = *reinterpret_cast<const uint16_t*>(DM + row * DMS + key);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float w = div_rn(s[j][2 * hh + e], tot, rs);
        if constexpr (DROP)
          w = (kept >> (8 * e)) & 0xffu ? div_rn(w, keep, rkeep) : 0.f;
        s[j][2 * hh + e] = row < N ? w : 0.f;
      }
    }
  }

  // O = wld V over this warp's 32 keys, all 64 columns: wld from the
  // registers (k = t: key c0 + 8 kk + 2 t, k = t + 4: the key after), V
  // read down its rows; the two halves' sums meet below
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const Frag4 a = split4(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
    const float* vr = Vs + (c0 + 8 * kk + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      mma3(acc[n], a, split2(vr[8 * n], vr[LD + 8 * n]));
  }
  // the other half's columns of this warp's sum go through Q's tile
  float* P = Qs;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if ((n >> 2) == half) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(P + (m0 + g + 8 * hh) * LD + 8 * n +
                                 2 * t) =
          make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
  }
  __syncthreads();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + g + 8 * hh;
    if (row >= N) continue;
    float* out = o + base + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if ((n >> 2) != half) continue;
      const float2 y = *reinterpret_cast<const float2*>(P + row * LD +
                                                        8 * n + 2 * t);
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[n][2 * hh] + y.x, acc[n][2 * hh + 1] + y.y);
    }
  }
}

// The plan of kernels/mha_fused.py::flash_plan's "tc32" forward (one block
// per (head, sample), FWD_SMEM bytes), checked against what the kernel
// takes.
cudaError_t forward(const void* q, const void* k, const void* v,
                    const int* mask, const uint8_t* dm, void* o, float* lse,
                    int B, int N, int D, int heads, float scale, int causal,
                    float keep, dim3 grid, int smem, cudaStream_t stream) {
  if (B <= 0 || heads <= 0 || D != heads * DH || N < 1 || N > MAX_N ||
      grid.x != unsigned(heads) || grid.y != unsigned(B) || grid.z != 1 ||
      smem != FWD_SMEM || !lse || (dm && !(keep > 0.f)) ||
      !ftc::aligned16({q, k, v, o}))
    return cudaErrorInvalidValue;
  using Kern = void (*)(const float*, const float*, const float*, const int*,
                        const uint8_t*, float*, float*, int, int, float,
                        float);
  Kern kern;
  if (dm)
    kern = mask ? (causal ? fwd_kernel<true, true, true>
                          : fwd_kernel<true, false, true>)
                : (causal ? fwd_kernel<false, true, true>
                          : fwd_kernel<false, false, true>);
  else
    kern = mask ? (causal ? fwd_kernel<true, true, false>
                          : fwd_kernel<true, false, false>)
                : (causal ? fwd_kernel<false, true, false>
                          : fwd_kernel<false, false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, dm, static_cast<float*>(o), lse, N,
      D, scale, dm ? keep : 1.f);
  return cudaGetLastError();
}

}  // namespace tc32

}  // namespace

// q/k/v/o: [B, N, D] contiguous, head h = columns h*dh:(h+1)*dh; mask:
// [B, N] int32 key validity or null. dtype: 0 = float32, 1 = bfloat16.
// Supports dh in {32, 64, 80, 88, 128} and 1 <= N <= 512 (the forward with
// lse and the backward: dh in {32, 64, 80, 128}; the dropout pair: {32, 64,
// 128}). Returns cudaGetLastError().
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

// The tensor-core route of mha_forward_lse (bf16, head dim 64, 1 <= N <=
// 256): the launch plan of kernels/mha_fused.py::flash_plan as it is (np =
// N rounded up to 16, grid = (heads, B, 1), its dynamic shared memory),
// refused (cudaErrorInvalidValue) if it is not the plan of this shape;
// q / k / v / o 16-byte aligned.
extern "C" int mha_forward_lse_tc(const void* q, const void* k,
                                  const void* v, const void* mask, void* o,
                                  void* lse, int B, int N, int D, int heads,
                                  float scale, int causal, int np, int gx,
                                  int gy, int gz, int smem, void* stream) {
  if (B <= 0) return 0;
  if (!lse) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ftc::forward(
      q, k, v, static_cast<const int*>(mask), o, static_cast<float*>(lse), B,
      N, D, heads, scale, causal, np, dim3(gx, gy, gz), smem,
      static_cast<cudaStream_t>(stream)));
}

// The tensor-core route of mha_flash_backward, under the same plan: the dQ
// kernel on grid_q = (heads, B, 1) with smem_q, then the dK / dV kernel on
// grid_kv (the same grid) with smem_kv.
extern "C" int mha_flash_backward_tc(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* mask, void* dq, void* dk,
    void* dv, void* delta, int B, int N, int D, int heads, float scale,
    int causal, int np, int gqx, int gqy, int gqz, int smem_q, int gkx,
    int gky, int gkz, int smem_kv, void* stream) {
  if (B <= 0) return 0;
  return static_cast<int>(ftc::backward(
      q, k, v, o, dout, static_cast<const float*>(lse),
      static_cast<const int*>(mask), dq, dk, dv, static_cast<float*>(delta),
      B, N, D, heads, scale, causal, np, dim3(gqx, gqy, gqz), smem_q,
      dim3(gkx, gky, gkz), smem_kv, static_cast<cudaStream_t>(stream)));
}

// The tensor-core route of mha_forward (K2; bf16, head dim 64, 1 <= N <=
// 256): the forward part of kernels/mha_fused.py::flash_plan (np, grid =
// (heads, B, 1), its dynamic shared memory) as it is, refused
// (cudaErrorInvalidValue) if it is not the plan of this shape; the same
// kernel as mha_forward_lse_tc without the lse store.
extern "C" int mha_forward_tc(const void* q, const void* k, const void* v,
                              const void* mask, void* o, int B, int N, int D,
                              int heads, float scale, int causal, int np,
                              int gx, int gy, int gz, int smem,
                              void* stream) {
  if (B <= 0) return 0;
  return static_cast<int>(ftc::forward(
      q, k, v, static_cast<const int*>(mask), o, nullptr, B, N, D, heads,
      scale, causal, np, dim3(gx, gy, gz), smem,
      static_cast<cudaStream_t>(stream)));
}

// The fp32 flash backward on the tensor cores (3xTF32; head dim 64, 1 <= N
// <= 64), of mha_forward_lse (dm null) or of mha_forward_lse_drop (dm the
// same keep mask, keep = 1 - p > 0): one fused kernel on grid = (heads, B,
// 1) with `smem` bytes, the "tc32" backward of
// kernels/mha_fused.py::flash_plan as it is, refused (cudaErrorInvalidValue)
// for another plan; q / k / v / o / dout / dq / dk / dv float32, 16-byte
// aligned.
extern "C" int mha_flash_backward_tc32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* mask, const void* dm,
    void* dq, void* dk, void* dv, int B, int N, int D, int heads, float scale,
    int causal, float keep, int gx, int gy, int gz, int smem, void* stream) {
  if (B <= 0) return 0;
  return static_cast<int>(tc32::backward(
      q, k, v, o, dout, static_cast<const float*>(lse),
      static_cast<const int*>(mask), static_cast<const uint8_t*>(dm), dq, dk,
      dv, B, N, D, heads, scale, causal, keep, dim3(gx, gy, gz), smem,
      static_cast<cudaStream_t>(stream)));
}

// The fp32 training forward on the tensor cores (3xTF32; head dim 64, 1 <= N
// <= 64): mha_forward_lse (dm null) or mha_forward_lse_drop (dm the keep
// mask, keep = 1 - p > 0) in one kernel on grid = (heads, B, 1) with `smem`
// bytes, the "tc32" forward of kernels/mha_fused.py::flash_plan as it is,
// refused (cudaErrorInvalidValue) for another plan; q / k / v / o float32,
// 16-byte aligned; lse [B, heads, N] float32.
extern "C" int mha_forward_lse_tc32(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    const void* dm, void* o, void* lse, int B,
                                    int N, int D, int heads, float scale,
                                    int causal, float keep, int gx, int gy,
                                    int gz, int smem, void* stream) {
  if (B <= 0) return 0;
  return static_cast<int>(tc32::forward(
      q, k, v, static_cast<const int*>(mask), static_cast<const uint8_t*>(dm),
      o, static_cast<float*>(lse), B, N, D, heads, scale, causal, keep,
      dim3(gx, gy, gz), smem, static_cast<cudaStream_t>(stream)));
}
