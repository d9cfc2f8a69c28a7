// Fused MM-RCA block forward for Hopper (sm_90a).
//
// Replaces: garbage_classification_rca_tpu/kernels/rca_fused.py::rca_fused
// (Pallas body `_kernel`). One launch computes the whole block:
//   t_sa = relu(LN(softmax(q_t k_t^T / sqrt 128) v_t))        [16, 96]
//   i_sa = relu(LN(softmax(q_i k_i^T / sqrt 128) v_i))        [16, 96]
//   ti   = relu(LN(W(q(t_sa), k(i_sa)) v(i_sa)))              [16, 48]
//   it   = relu(LN(W(q(i_sa), k(t_sa)) v(t_sa)))              [16, 48]
// with W = softmax(. / sqrt 64), or (1 - softmax) / 15 when `reverse`;
// LayerNorm eps 1e-5. All arithmetic is fp32 whatever the input and weight
// dtypes (the Pallas `_proj` promotes bf16 weights to fp32 the same way).
//
// What bounds it on the H100: arithmetic. 2.87 MFLOP per sample against
// ~13 KB of activations in and out, all in fp32 (no tensor-core path keeps
// fp32 exact), so the fp32 CUDA-core rate is the roof. The 32 weight
// tensors (78,848 values, 315 KB in fp32) do not fit one block's 227 KB of
// shared memory, so the design stages ONE attention unit's weights at a
// time (the largest, sa_img, is 110 KB), transposed to [in][out] with an
// odd leading dimension so both the transposing stores and the column-
// parallel reads are free of bank conflicts. Every intermediate stays in
// shared memory; only t, i and the two outputs touch device memory.
// One block per sample, so no batch padding: the ragged edge of the TPU
// tiling does not exist here. Re-staging the weights per sample is the
// known cost of this first version (they come from L2 after the first
// block); several samples per block amortise it in a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NP = 16;                       // patches
constexpr int DT = 48, DI = 80;              // text / image patch widths
constexpr int SA_KQ = 128, SA_V = 96;
constexpr int CA_KQ = 64, CA_V = 48;
constexpr int THREADS = 256;
constexpr int SA_C = 2 * SA_KQ + SA_V;       // 352 projected columns
constexpr int WT_FLOATS = DI * (SA_C + 1);   // largest staged unit: sa_img

// shared-memory carve-up, in floats
constexpr int OFF_BIAS = WT_FLOATS;
constexpr int OFF_GAM = OFF_BIAS + SA_C;
constexpr int OFF_BET = OFF_GAM + SA_V;
constexpr int OFF_XT = OFF_BET + SA_V;
constexpr int OFF_XI = OFF_XT + NP * DT;
constexpr int OFF_TSA = OFF_XI + NP * DI;
constexpr int OFF_ISA = OFF_TSA + NP * SA_V;
constexpr int OFF_P = OFF_ISA + NP * SA_V;
constexpr int OFF_S = OFF_P + NP * (SA_C + 1);
constexpr int OFF_Y = OFF_S + NP * NP;
constexpr int SMEM_FLOATS = OFF_Y + NP * SA_V;
constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_FLOATS;

struct Unit {
  const void *wq, *bq, *wk, *bk, *wv, *bv, *g, *be;
};
struct Weights {
  Unit u[4];  // sa_txt, sa_img, rca_ti, rca_it
};

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One attention unit over the 16 patches of this block's sample.
// xq: [16, din] queries, xkv: [16, din] keys/values (both shared, fp32).
// out: [16, dv] shared, fp32.
template <typename TW>
__device__ void attention_unit(const Unit& u, const float* xq,
                               const float* xkv, int din, int dkq, int dv,
                               bool reverse, float* sm, float* out) {
  float* Wt = sm;
  float* bias = sm + OFF_BIAS;
  float* gam = sm + OFF_GAM;
  float* bet = sm + OFF_BET;
  float* P = sm + OFF_P;
  float* S = sm + OFF_S;
  float* Y = sm + OFF_Y;
  const int tid = threadIdx.x;
  const int C = 2 * dkq + dv;
  const int LD = C + 1;  // odd: conflict-free transposing stores
  const TW* wq = static_cast<const TW*>(u.wq);
  const TW* wk = static_cast<const TW*>(u.wk);
  const TW* wv = static_cast<const TW*>(u.wv);

  __syncthreads();  // the previous unit is done with Wt / P / S / Y
  // stage W^T: torch layout W[out][in] -> Wt[in][col], q | k | v columns
  for (int e = tid; e < dkq * din; e += THREADS) {
    const int j = e / din, k = e - j * din;
    Wt[k * LD + j] = ld(wq, e);
    Wt[k * LD + dkq + j] = ld(wk, e);
  }
  for (int e = tid; e < dv * din; e += THREADS) {
    const int j = e / din, k = e - j * din;
    Wt[k * LD + 2 * dkq + j] = ld(wv, e);
  }
  for (int c = tid; c < dkq; c += THREADS) {
    bias[c] = ld(static_cast<const TW*>(u.bq), c);
    bias[dkq + c] = ld(static_cast<const TW*>(u.bk), c);
  }
  for (int c = tid; c < dv; c += THREADS) {
    bias[2 * dkq + c] = ld(static_cast<const TW*>(u.bv), c);
    gam[c] = ld(static_cast<const TW*>(u.g), c);
    bet[c] = ld(static_cast<const TW*>(u.be), c);
  }
  __syncthreads();

  // projections: P[n][c] = x[n] . W^T[:, c] + bias[c]; 4 rows per thread
  for (int e = tid; e < 4 * C; e += THREADS) {
    const int g = e / C, c = e - g * C;
    const float* x = (c < dkq ? xq : xkv) + 4 * g * din;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int k = 0; k < din; ++k) {
      const float w = Wt[k * LD + c];
      a0 = fmaf(x[k], w, a0);
      a1 = fmaf(x[din + k], w, a1);
      a2 = fmaf(x[2 * din + k], w, a2);
      a3 = fmaf(x[3 * din + k], w, a3);
    }
    const float bc = bias[c];
    P[(4 * g + 0) * LD + c] = a0 + bc;
    P[(4 * g + 1) * LD + c] = a1 + bc;
    P[(4 * g + 2) * LD + c] = a2 + bc;
    P[(4 * g + 3) * LD + c] = a3 + bc;
  }
  __syncthreads();

  // scores: one (n, m) pair per thread (256 = 16 x 16)
  {
    const int n = tid >> 4, m = tid & 15;
    float a = 0.f;
    for (int d = 0; d < dkq; ++d)
      a = fmaf(P[n * LD + d], P[m * LD + dkq + d], a);
    S[n * NP + m] = a / sqrtf(static_cast<float>(dkq));
  }
  __syncthreads();

  // fp32 softmax per row (max subtracted), then the reverse mixing
  if (tid < NP) {
    float* row = S + tid * NP;
    float mx = row[0];
    for (int m = 1; m < NP; ++m) mx = fmaxf(mx, row[m]);
    float sum = 0.f;
    for (int m = 0; m < NP; ++m) {
      const float e = expf(row[m] - mx);
      row[m] = e;
      sum += e;
    }
    for (int m = 0; m < NP; ++m) {
      const float w = row[m] / sum;
      row[m] = reverse ? (1.f - w) / static_cast<float>(NP - 1) : w;
    }
  }
  __syncthreads();

  // Y = W @ V
  for (int e = tid; e < NP * dv; e += THREADS) {
    const int n = e / dv, j = e - n * dv;
    float a = 0.f;
    for (int m = 0; m < NP; ++m)
      a = fmaf(S[n * NP + m], P[m * LD + 2 * dkq + j], a);
    Y[e] = a;
  }
  __syncthreads();

  // LayerNorm over the dv logical columns, then ReLU; one warp per row
  const int warp = tid >> 5, lane = tid & 31;
  for (int n = warp; n < NP; n += THREADS / 32) {
    const float* y = Y + n * dv;
    float s = 0.f;
    for (int j = lane; j < dv; j += 32) s += y[j];
    const float mean = warp_sum(s) / static_cast<float>(dv);
    float q = 0.f;
    for (int j = lane; j < dv; j += 32) {
      const float d = y[j] - mean;
      q = fmaf(d, d, q);
    }
    const float var = warp_sum(q) / static_cast<float>(dv);
    const float inv = 1.f / sqrtf(var + 1e-5f);
    for (int j = lane; j < dv; j += 32)
      out[n * dv + j] = fmaxf((y[j] - mean) * inv * gam[j] + bet[j], 0.f);
  }
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
    rca_fused_kernel(const TX* __restrict__ t, const TX* __restrict__ im,
                     Weights w, TX* __restrict__ ti, TX* __restrict__ it,
                     int reverse) {
  extern __shared__ float sm[];
  float* xt = sm + OFF_XT;
  float* xi = sm + OFF_XI;
  float* tsa = sm + OFF_TSA;
  float* isa = sm + OFF_ISA;
  const size_t b = blockIdx.x;
  for (int e = threadIdx.x; e < NP * DT; e += THREADS)
    xt[e] = ld(t, b * NP * DT + e);
  for (int e = threadIdx.x; e < NP * DI; e += THREADS)
    xi[e] = ld(im, b * NP * DI + e);

  attention_unit<TW>(w.u[0], xt, xt, DT, SA_KQ, SA_V, false, sm, tsa);
  attention_unit<TW>(w.u[1], xi, xi, DI, SA_KQ, SA_V, false, sm, isa);
  // the self-attention inputs are dead now: their buffers take the outputs
  attention_unit<TW>(w.u[2], tsa, isa, SA_V, CA_KQ, CA_V, reverse != 0, sm,
                     xt);
  attention_unit<TW>(w.u[3], isa, tsa, SA_V, CA_KQ, CA_V, reverse != 0, sm,
                     xi);
  __syncthreads();
  for (int e = threadIdx.x; e < NP * CA_V; e += THREADS) {
    st(ti, b * NP * CA_V + e, xt[e]);
    st(it, b * NP * CA_V + e, xi[e]);
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* t, const void* i, const Weights& w, void* ti,
                   void* it, int batch, int reverse, cudaStream_t stream) {
  auto kern = rca_fused_kernel<TX, TW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  kern<<<batch, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const TX*>(t), static_cast<const TX*>(i), w,
      static_cast<TX*>(ti), static_cast<TX*>(it), reverse);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. `weights` holds 32 device
// pointers, per unit (sa_txt, sa_img, rca_ti, rca_it): q.w [out,in], q.b,
// k.w, k.b, v.w, v.b, norm.scale, norm.bias. Returns cudaGetLastError().
extern "C" int rca_fused_forward(const void* t, const void* i,
                                 const void* const* weights, void* ti,
                                 void* it, int batch, int x_dtype,
                                 int w_dtype, int reverse, void* stream) {
  if (batch <= 0) return 0;
  Weights w;
  for (int u = 0; u < 4; ++u) {
    const void* const* p = weights + 8 * u;
    w.u[u] = Unit{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 0 && w_dtype == 0)
    err = launch<float, float>(t, i, w, ti, it, batch, reverse, s);
  else if (x_dtype == 0 && w_dtype == 1)
    err = launch<float, __nv_bfloat16>(t, i, w, ti, it, batch, reverse, s);
  else if (x_dtype == 1 && w_dtype == 0)
    err = launch<__nv_bfloat16, float>(t, i, w, ti, it, batch, reverse, s);
  else if (x_dtype == 1 && w_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(t, i, w, ti, it, batch,
                                              reverse, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
