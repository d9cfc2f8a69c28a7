// Masked / causal multi-head attention forward for Hopper (sm_90a).
//
// Replaces: garbage_classification_rca_tpu/kernels/mha_fused.py::mha
// (Pallas bodies `_kernel` / `_kernel_masked`). Per head h of D = H * dh:
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

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
    mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ mask,
               T* __restrict__ o, int N, int D, float scale, int causal) {
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
    for (int j = lane; j < N; j += 32) row[j] = round_to(row[j] / sum, v);
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
                   const int* mask, void* o, int B, int N, int D, int heads,
                   float scale, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((BQ + BK) * (DH + 1) + static_cast<size_t>(BQ) * N);
  auto kern = mha_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, heads, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), N, D, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* mask, void* o, int B, int N, int D,
                     int heads, float scale, int causal, cudaStream_t s) {
  switch (D / heads) {
    case 32:
      return launch<T, 32>(q, k, v, mask, o, B, N, D, heads, scale, causal, s);
    case 64:
      return launch<T, 64>(q, k, v, mask, o, B, N, D, heads, scale, causal, s);
    case 128:
      return launch<T, 128>(q, k, v, mask, o, B, N, D, heads, scale, causal,
                            s);
    default:
      return cudaErrorInvalidValue;
  }
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
  if (N <= 0 || N > 512 || heads <= 0 || D % heads) return cudaErrorInvalidValue;
  const int* m = static_cast<const int*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, m, o, B, N, D, heads, scale, causal, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, m, o, B, N, D, heads, scale,
                                  causal, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
