// Fused MM-RCA block, forward and backward, for Hopper (sm_90a).
//
// Forward (rca_fused_forward) replaces
// garbage_classification_rca_tpu/kernels/rca_fused.py::rca_fused (Pallas
// body `_kernel`). One launch computes the whole block:
//   t_sa = relu(LN(softmax(q_t k_t^T / sqrt 128) v_t))        [16, 96]
//   i_sa = relu(LN(softmax(q_i k_i^T / sqrt 128) v_i))        [16, 96]
//   ti   = relu(LN(W(q(t_sa), k(i_sa)) v(i_sa)))              [16, 48]
//   it   = relu(LN(W(q(i_sa), k(t_sa)) v(t_sa)))              [16, 48]
// with W = softmax(. / sqrt 64), or (1 - softmax) / 15 when `reverse`;
// LayerNorm eps 1e-5. All arithmetic is fp32 whatever the input and weight
// dtypes (the Pallas `_proj` promotes bf16 weights to fp32 the same way).
// t and i may have different dtypes (fp32 text tower, bf16 image tower in
// training); each is read as fp32 and both outputs are written in t's dtype,
// as the Pallas kernel writes them.
//
// Backward (rca_fused_backward) replaces rca_fused.py::rca_fused_bwd
// (Pallas body `_bwd_kernel`, helpers `_unit_fwd_res` / `_unit_bwd`): it
// recomputes the block's forward from t and i, then gives dt, di and all
// 32 weight gradients in fp32. The TPU kernel summed the weight gradients
// across its sequential grid; blocks here run in no order, so each block
// writes its sample's partial gradients to a workspace and a second kernel
// sums them over the batch in a fixed order (no atomics: the same
// gradients on every run).
//
// What bounds both on the H100: arithmetic. 2.87 MFLOP per sample forward
// (about three times that backward, with the recomputation) against ~13 KB
// of activations in and out, all in fp32 (no tensor-core path keeps fp32
// exact), so the fp32 CUDA-core rate is the roof. The 32 weight tensors
// (80,480 values, 322 KB in fp32) do not fit one block's 227 KB of shared
// memory, so the design stages ONE attention unit's weights at a time (the
// largest, sa_img, is 110 KB), transposed to [in][out] with an odd leading
// dimension so both the transposing stores and the column-parallel reads
// are free of bank conflicts. Every intermediate stays in shared memory.
// One block per sample, so no batch padding: the ragged edge of the TPU
// tiling does not exist here. The backward keeps only one unit's residuals
// at a time: it recomputes each unit's forward right before that unit's
// backward, with the unit's weights staged once for both. Re-staging the
// weights per sample is the known cost of this first version (they come
// from L2 after the first block).

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
constexpr int N_WEIGHTS = 80480;             // values in the 32 tensors

// forward shared-memory carve-up, in floats
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

// backward shared-memory carve-up, in floats: one unit's staged weights
// and residuals, then the per-sample activations and their gradients
constexpr int B_P = OFF_GAM + SA_V + SA_V;          // after Wt/bias/gam/bet
constexpr int B_A = B_P + NP * (SA_C + 1);          // softmax a [16][16]
constexpr int B_YH = B_A + NP * NP;                 // yhat [16][dv]
constexpr int B_INV = B_YH + NP * SA_V;             // 1/std per row
constexpr int B_G = B_INV + NP;                     // dout -> dz -> dy
constexpr int B_DS = B_G + NP * SA_V;               // dw -> ds [16][16]
constexpr int B_DP = B_DS + NP * NP;                // dq | dk | dv
constexpr int B_XT = B_DP + NP * (SA_C + 1);
constexpr int B_XI = B_XT + NP * DT;
constexpr int B_TSA = B_XI + NP * DI;
constexpr int B_ISA = B_TSA + NP * SA_V;
constexpr int B_DTSA = B_ISA + NP * SA_V;
constexpr int B_DISA = B_DTSA + NP * SA_V;
constexpr int B_DXT = B_DISA + NP * SA_V;
constexpr int B_DXI = B_DXT + NP * DT;
constexpr int B_FLOATS = B_DXI + NP * DI;
constexpr size_t B_SMEM_BYTES = sizeof(float) * B_FLOATS;
static_assert(B_SMEM_BYTES <= 232448, "backward exceeds shared memory");

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

// Stage one unit's weights: torch layout W[out][in] -> Wt[in][col] with
// q | k | v columns and leading dimension C + 1, plus biases and the
// LayerNorm affine.
template <typename TW>
__device__ void stage_unit(const Unit& u, int din, int dkq, int dv,
                           float* sm) {
  float* Wt = sm;
  float* bias = sm + OFF_BIAS;
  float* gam = sm + OFF_GAM;
  float* bet = sm + OFF_BET;
  const int tid = threadIdx.x;
  const int LD = 2 * dkq + dv + 1;  // odd: conflict-free transposing stores
  const TW* wq = static_cast<const TW*>(u.wq);
  const TW* wk = static_cast<const TW*>(u.wk);
  const TW* wv = static_cast<const TW*>(u.wv);
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
}

// P[n][c] = x[n] . W^T[:, c] + bias[c] for the q columns (from xq) and the
// k | v columns (from xkv); 4 rows per thread.
__device__ void project(const float* xq, const float* xkv, int din, int dkq,
                        int dv, const float* sm, float* P) {
  const float* Wt = sm;
  const float* bias = sm + OFF_BIAS;
  const int C = 2 * dkq + dv, LD = C + 1;
  for (int e = threadIdx.x; e < 4 * C; e += THREADS) {
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
}

// S[n][m] = q[n] . k[m] / sqrt(dkq), one (n, m) pair per thread, then the
// fp32 softmax per row (max subtracted). Leaves the softmax `a` in S.
__device__ void scores_softmax(const float* P, int dkq, int LD, float* S) {
  const int tid = threadIdx.x;
  {
    const int n = tid >> 4, m = tid & 15;
    float a = 0.f;
    for (int d = 0; d < dkq; ++d)
      a = fmaf(P[n * LD + d], P[m * LD + dkq + d], a);
    S[n * NP + m] = a / sqrtf(static_cast<float>(dkq));
  }
  __syncthreads();
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
    for (int m = 0; m < NP; ++m) row[m] = row[m] / sum;
  }
}

__device__ __forceinline__ float mix(float a, bool reverse) {
  return reverse ? (1.f - a) / static_cast<float>(NP - 1) : a;
}

// One attention unit over the 16 patches of this block's sample.
// xq: [16, din] queries, xkv: [16, din] keys/values (both shared, fp32).
// out: [16, dv] shared, fp32.
template <typename TW>
__device__ void attention_unit(const Unit& u, const float* xq,
                               const float* xkv, int din, int dkq, int dv,
                               bool reverse, float* sm, float* out) {
  float* gam = sm + OFF_GAM;
  float* bet = sm + OFF_BET;
  float* P = sm + OFF_P;
  float* S = sm + OFF_S;
  float* Y = sm + OFF_Y;
  const int tid = threadIdx.x;
  const int LD = 2 * dkq + dv + 1;

  __syncthreads();  // the previous unit is done with Wt / P / S / Y
  stage_unit<TW>(u, din, dkq, dv, sm);
  __syncthreads();
  project(xq, xkv, din, dkq, dv, sm, P);
  __syncthreads();
  scores_softmax(P, dkq, LD, S);
  __syncthreads();

  // Y = W @ V
  for (int e = tid; e < NP * dv; e += THREADS) {
    const int n = e / dv, j = e - n * dv;
    float a = 0.f;
    for (int m = 0; m < NP; ++m)
      a = fmaf(mix(S[n * NP + m], reverse), P[m * LD + 2 * dkq + j], a);
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

template <typename TT, typename TI, typename TW>
__global__ void __launch_bounds__(THREADS)
    rca_fused_kernel(const TT* __restrict__ t, const TI* __restrict__ im,
                     Weights w, TT* __restrict__ ti, TT* __restrict__ it,
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

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Forward of one unit keeping what its backward needs, with the unit's
// weights already staged: P (q | k | v), A (softmax a), YH (yhat), INV.
// Writes relu(yhat * g + be) to `out` when it is not null.
__device__ void unit_fwd_res(const float* xq, const float* xkv, int din,
                             int dkq, int dv, bool reverse, float* sm,
                             float* out) {
  const float* gam = sm + OFF_GAM;
  const float* bet = sm + OFF_BET;
  float* P = sm + B_P;
  float* A = sm + B_A;
  float* YH = sm + B_YH;
  float* INV = sm + B_INV;
  const int tid = threadIdx.x;
  const int LD = 2 * dkq + dv + 1;

  project(xq, xkv, din, dkq, dv, sm, P);
  __syncthreads();
  scores_softmax(P, dkq, LD, A);
  __syncthreads();
  for (int e = tid; e < NP * dv; e += THREADS) {
    const int n = e / dv, j = e - n * dv;
    float a = 0.f;
    for (int m = 0; m < NP; ++m)
      a = fmaf(mix(A[n * NP + m], reverse), P[m * LD + 2 * dkq + j], a);
    YH[e] = a;
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  for (int n = warp; n < NP; n += THREADS / 32) {
    float* y = YH + n * dv;
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
    __syncwarp();
    for (int j = lane; j < dv; j += 32) {
      const float yh = (y[j] - mean) * inv;
      y[j] = yh;
      if (out) out[n * dv + j] = fmaxf(yh * gam[j] + bet[j], 0.f);
    }
    if (lane == 0) INV[n] = inv;
  }
  __syncthreads();
}

// Backward of one unit whose weights are staged and whose residuals
// unit_fwd_res left in shared memory. The cotangent of the unit's output is
// in G ([16][dv]). Writes this sample's 8 weight gradients (torch layouts,
// in the kernel's weight order) to `wg`, and dx_q / dx_kv to `dxq` /
// `dxkv`, added to what they hold when `acc_q` / `acc_kv`.
__device__ void unit_bwd(const float* xq, const float* xkv, int din, int dkq,
                         int dv, bool reverse, float* sm, float* __restrict__ wg,
                         float* dxq, bool acc_q, float* dxkv, bool acc_kv) {
  const float* Wt = sm;
  const float* gam = sm + OFF_GAM;
  const float* bet = sm + OFF_BET;
  const float* P = sm + B_P;
  const float* A = sm + B_A;
  const float* YH = sm + B_YH;
  const float* INV = sm + B_INV;
  float* G = sm + B_G;
  float* DS = sm + B_DS;
  float* DP = sm + B_DP;
  const int tid = threadIdx.x;
  const int C = 2 * dkq + dv, LD = C + 1;
  // offsets of the 8 gradients inside this unit's slice of `wg`
  float* g_wq = wg;
  float* g_bq = g_wq + dkq * din;
  float* g_wk = g_bq + dkq;
  float* g_bk = g_wk + dkq * din;
  float* g_wv = g_bk + dkq;
  float* g_bv = g_wv + dv * din;
  float* g_g = g_bv + dv;
  float* g_be = g_g + dv;

  // dz = dout where z = yhat * g + be > 0
  for (int e = tid; e < NP * dv; e += THREADS) {
    const int j = e % dv;
    if (!(YH[e] * gam[j] + bet[j] > 0.f)) G[e] = 0.f;
  }
  __syncthreads();
  // LayerNorm affine gradients: column sums over the 16 rows
  for (int j = tid; j < dv; j += THREADS) {
    float sg = 0.f, sb = 0.f;
    for (int n = 0; n < NP; ++n) {
      sg = fmaf(G[n * dv + j], YH[n * dv + j], sg);
      sb += G[n * dv + j];
    }
    g_g[j] = sg;
    g_be[j] = sb;
  }
  __syncthreads();
  // LayerNorm backward: dy = inv * (dyhat - mean(dyhat) - yhat *
  // mean(dyhat * yhat)), dyhat = dz * g; one warp per row
  {
    const int warp = tid >> 5, lane = tid & 31;
    for (int n = warp; n < NP; n += THREADS / 32) {
      float s1 = 0.f, s2 = 0.f;
      for (int j = lane; j < dv; j += 32) {
        const float dyh = G[n * dv + j] * gam[j];
        s1 += dyh;
        s2 = fmaf(dyh, YH[n * dv + j], s2);
      }
      const float m1 = warp_sum(s1) / static_cast<float>(dv);
      const float m2 = warp_sum(s2) / static_cast<float>(dv);
      __syncwarp();
      for (int j = lane; j < dv; j += 32) {
        const float dyh = G[n * dv + j] * gam[j];
        G[n * dv + j] = INV[n] * (dyh - m1 - YH[n * dv + j] * m2);
      }
    }
  }
  __syncthreads();
  // dw[n][m] = dy[n] . v[m]
  {
    const int n = tid >> 4, m = tid & 15;
    float a = 0.f;
    for (int j = 0; j < dv; ++j)
      a = fmaf(G[n * dv + j], P[m * LD + 2 * dkq + j], a);
    DS[n * NP + m] = reverse ? -a / static_cast<float>(NP - 1) : a;  // da
  }
  // dv[m][j] = sum_n w[n][m] dy[n][j]
  for (int e = tid; e < NP * dv; e += THREADS) {
    const int m = e / dv, j = e - m * dv;
    float a = 0.f;
    for (int n = 0; n < NP; ++n)
      a = fmaf(mix(A[n * NP + m], reverse), G[n * dv + j], a);
    DP[m * LD + 2 * dkq + j] = a;
  }
  __syncthreads();
  // softmax backward, scaled: ds = a * (da - sum_m da * a) / sqrt(dkq)
  if (tid < NP) {
    float* row = DS + tid * NP;
    const float* ar = A + tid * NP;
    float s = 0.f;
    for (int m = 0; m < NP; ++m) s = fmaf(row[m], ar[m], s);
    const float sc = 1.f / sqrtf(static_cast<float>(dkq));
    for (int m = 0; m < NP; ++m) row[m] = ar[m] * (row[m] - s) * sc;
  }
  __syncthreads();
  // dq[n][c] = sum_m ds[n][m] k[m][c];  dk[m][c] = sum_n ds[n][m] q[n][c]
  for (int e = tid; e < NP * dkq; e += THREADS) {
    const int r = e / dkq, c = e - r * dkq;
    float aq = 0.f, ak = 0.f;
    for (int s = 0; s < NP; ++s) {
      aq = fmaf(DS[r * NP + s], P[s * LD + dkq + c], aq);
      ak = fmaf(DS[s * NP + r], P[s * LD + c], ak);
    }
    DP[r * LD + c] = aq;
    DP[r * LD + dkq + c] = ak;
  }
  __syncthreads();
  // weight gradients: dW[c][k] = sum_n d[n][c] x[n][k] (torch [out][in])
  for (int e = tid; e < C * din; e += THREADS) {
    const int c = e / din, k = e - c * din;
    const float* x = c < dkq ? xq : xkv;
    float a = 0.f;
    for (int n = 0; n < NP; ++n) a = fmaf(DP[n * LD + c], x[n * din + k], a);
    if (c < dkq)
      g_wq[c * din + k] = a;
    else if (c < 2 * dkq)
      g_wk[(c - dkq) * din + k] = a;
    else
      g_wv[(c - 2 * dkq) * din + k] = a;
  }
  for (int c = tid; c < C; c += THREADS) {
    float a = 0.f;
    for (int n = 0; n < NP; ++n) a += DP[n * LD + c];
    if (c < dkq)
      g_bq[c] = a;
    else if (c < 2 * dkq)
      g_bk[c - dkq] = a;
    else
      g_bv[c - 2 * dkq] = a;
  }
  // input gradients: dx_q = dq Wq, dx_kv = dk Wk + dv Wv
  for (int e = tid; e < NP * din; e += THREADS) {
    const int n = e / din, k = e - n * din;
    const float* d = DP + n * LD;
    const float* w = Wt + k * LD;
    float aq = 0.f, akv = 0.f;
    for (int c = 0; c < dkq; ++c) aq = fmaf(d[c], w[c], aq);
    for (int c = dkq; c < C; ++c) akv = fmaf(d[c], w[c], akv);
    dxq[e] = acc_q ? dxq[e] + aq : aq;
    dxkv[e] = acc_kv ? dxkv[e] + akv : akv;
  }
  __syncthreads();
}

template <typename TW>
__device__ void unit_backward(const Unit& u, const float* xq,
                              const float* xkv, int din, int dkq, int dv,
                              bool reverse, const float* dout, float* sm,
                              float* wg, float* dxq, bool acc_q, float* dxkv,
                              bool acc_kv) {
  __syncthreads();
  stage_unit<TW>(u, din, dkq, dv, sm);
  for (int e = threadIdx.x; e < NP * dv; e += THREADS)
    sm[B_G + e] = dout[e];
  __syncthreads();
  unit_fwd_res(xq, xkv, din, dkq, dv, reverse, sm, nullptr);
  unit_bwd(xq, xkv, din, dkq, dv, reverse, sm, wg, dxq, acc_q, dxkv, acc_kv);
}

// One block per sample. `part` receives this sample's 80,480 weight
// gradients in kernel weight order; dt / di its input gradients.
template <typename TT, typename TI, typename TW>
__global__ void __launch_bounds__(THREADS)
    rca_bwd_kernel(const TT* __restrict__ t, const TI* __restrict__ im,
                   Weights w, const TT* __restrict__ g_ti,
                   const TT* __restrict__ g_it, TT* __restrict__ dt,
                   TI* __restrict__ di, float* __restrict__ part,
                   int reverse) {
  extern __shared__ float sm[];
  float* xt = sm + B_XT;
  float* xi = sm + B_XI;
  float* tsa = sm + B_TSA;
  float* isa = sm + B_ISA;
  float* dtsa = sm + B_DTSA;
  float* disa = sm + B_DISA;
  float* dxt = sm + B_DXT;
  float* dxi = sm + B_DXI;
  const size_t b = blockIdx.x;
  const bool rev = reverse != 0;
  float* wg = part + b * N_WEIGHTS;
  // unit slices of the per-sample gradient vector
  constexpr int SZ_T = 2 * (SA_KQ * DT + SA_KQ) + SA_V * DT + 3 * SA_V;
  constexpr int SZ_I = 2 * (SA_KQ * DI + SA_KQ) + SA_V * DI + 3 * SA_V;
  constexpr int SZ_C = 2 * (CA_KQ * SA_V + CA_KQ) + CA_V * SA_V + 3 * CA_V;
  static_assert(SZ_T + SZ_I + 2 * SZ_C == N_WEIGHTS, "weight count");

  for (int e = threadIdx.x; e < NP * DT; e += THREADS)
    xt[e] = ld(t, b * NP * DT + e);
  for (int e = threadIdx.x; e < NP * DI; e += THREADS)
    xi[e] = ld(im, b * NP * DI + e);

  // forward of the two self-attentions (their outputs feed the RCA units)
  for (int u = 0; u < 2; ++u) {
    const int din = u == 0 ? DT : DI;
    const float* x = u == 0 ? xt : xi;
    __syncthreads();
    stage_unit<TW>(w.u[u], din, SA_KQ, SA_V, sm);
    __syncthreads();
    unit_fwd_res(x, x, din, SA_KQ, SA_V, false, sm, u == 0 ? tsa : isa);
  }

  // the two reverse cross-attentions: dtsa / disa gather both
  float* go = sm + B_DXT;  // cotangent staging (dxt is not live yet)
  __syncthreads();
  for (int e = threadIdx.x; e < NP * CA_V; e += THREADS)
    go[e] = ld(g_ti, b * NP * CA_V + e);
  unit_backward<TW>(w.u[2], tsa, isa, SA_V, CA_KQ, CA_V, rev, go, sm,
                    wg + SZ_T + SZ_I, dtsa, false, disa, false);
  for (int e = threadIdx.x; e < NP * CA_V; e += THREADS)
    go[e] = ld(g_it, b * NP * CA_V + e);
  unit_backward<TW>(w.u[3], isa, tsa, SA_V, CA_KQ, CA_V, rev, go, sm,
                    wg + SZ_T + SZ_I + SZ_C, disa, true, dtsa, true);

  // the two self-attentions: dx = dx_q + dx_kv (the same input)
  unit_backward<TW>(w.u[0], xt, xt, DT, SA_KQ, SA_V, false, dtsa, sm, wg,
                    dxt, false, dxt, true);
  unit_backward<TW>(w.u[1], xi, xi, DI, SA_KQ, SA_V, false, disa, sm,
                    wg + SZ_T, dxi, false, dxi, true);

  for (int e = threadIdx.x; e < NP * DT; e += THREADS)
    st(dt, b * NP * DT + e, dxt[e]);
  for (int e = threadIdx.x; e < NP * DI; e += THREADS)
    st(di, b * NP * DI + e, dxi[e]);
}

// out[e] = sum_b part[b][e], the batch summed in order.
__global__ void rca_bwd_reduce(const float* __restrict__ part, int batch,
                               float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N_WEIGHTS) return;
  float a = 0.f;
  for (int b = 0; b < batch; ++b) a += part[static_cast<size_t>(b) * N_WEIGHTS + e];
  out[e] = a;
}

template <typename TT, typename TI, typename TW>
cudaError_t launch(const void* t, const void* i, const Weights& w, void* ti,
                   void* it, int batch, int reverse, cudaStream_t stream) {
  auto kern = rca_fused_kernel<TT, TI, TW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  kern<<<batch, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const TT*>(t), static_cast<const TI*>(i), w,
      static_cast<TT*>(ti), static_cast<TT*>(it), reverse);
  return cudaGetLastError();
}

template <typename TT, typename TI, typename TW>
cudaError_t launch_bwd(const void* t, const void* i, const Weights& w,
                       const void* g_ti, const void* g_it, void* dt, void* di,
                       float* part, float* dw, int batch, int reverse,
                       cudaStream_t stream) {
  auto kern = rca_bwd_kernel<TT, TI, TW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(B_SMEM_BYTES));
  if (err != cudaSuccess) return err;
  kern<<<batch, THREADS, B_SMEM_BYTES, stream>>>(
      static_cast<const TT*>(t), static_cast<const TI*>(i), w,
      static_cast<const TT*>(g_ti), static_cast<const TT*>(g_it),
      static_cast<TT*>(dt), static_cast<TI*>(di), part, reverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rca_bwd_reduce<<<(N_WEIGHTS + 255) / 256, 256, 0, stream>>>(part, batch, dw);
  return cudaGetLastError();
}

Weights unpack(const void* const* weights) {
  Weights w;
  for (int u = 0; u < 4; ++u) {
    const void* const* p = weights + 8 * u;
    w.u[u] = Unit{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
  }
  return w;
}

// Expands to a switch that returns CALL(TT, TI, TW) for the dtype codes
// (0 = float32, 1 = bfloat16 each), or cudaErrorInvalidValue.
#define RCA_DISPATCH(T_DT, I_DT, W_DT, CALL)                               \
  if ((T_DT) < 0 || (T_DT) > 1 || (I_DT) < 0 || (I_DT) > 1 || (W_DT) < 0 || \
      (W_DT) > 1)                                                         \
    return cudaErrorInvalidValue;                                         \
  switch ((T_DT) * 4 + (I_DT) * 2 + (W_DT)) {                             \
    case 0: return CALL(float, float, float);                             \
    case 1: return CALL(float, float, __nv_bfloat16);                     \
    case 2: return CALL(float, __nv_bfloat16, float);                     \
    case 3: return CALL(float, __nv_bfloat16, __nv_bfloat16);             \
    case 4: return CALL(__nv_bfloat16, float, float);                     \
    case 5: return CALL(__nv_bfloat16, float, __nv_bfloat16);             \
    case 6: return CALL(__nv_bfloat16, __nv_bfloat16, float);             \
    default: return CALL(__nv_bfloat16, __nv_bfloat16, __nv_bfloat16);   \
  }

cudaError_t forward(const void* t, const void* i, const Weights& w, void* ti,
                    void* it, int batch, int t_dt, int i_dt, int w_dt,
                    int reverse, cudaStream_t s) {
#define FWD(TT, TI, TW) launch<TT, TI, TW>(t, i, w, ti, it, batch, reverse, s)
  RCA_DISPATCH(t_dt, i_dt, w_dt, FWD)
#undef FWD
}

cudaError_t backward(const void* t, const void* i, const Weights& w,
                     const void* g_ti, const void* g_it, void* dt, void* di,
                     float* part, float* dw, int batch, int t_dt, int i_dt,
                     int w_dt, int reverse, cudaStream_t s) {
#define BWD(TT, TI, TW)                                                  \
  launch_bwd<TT, TI, TW>(t, i, w, g_ti, g_it, dt, di, part, dw, batch,   \
                         reverse, s)
  RCA_DISPATCH(t_dt, i_dt, w_dt, BWD)
#undef BWD
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, given for t, i and the weights
// separately. `weights` holds 32 device pointers, per unit (sa_txt, sa_img,
// rca_ti, rca_it): q.w [out,in], q.b, k.w, k.b, v.w, v.b, norm.scale,
// norm.bias. ti / it are written in t's dtype. Returns cudaGetLastError().
extern "C" int rca_fused_forward(const void* t, const void* i,
                                 const void* const* weights, void* ti,
                                 void* it, int batch, int t_dtype,
                                 int i_dtype, int w_dtype, int reverse,
                                 void* stream) {
  if (batch <= 0) return 0;
  const Weights w = unpack(weights);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(forward(t, i, w, ti, it, batch, t_dtype, i_dtype,
                                  w_dtype, reverse, s));
}

// Backward of rca_fused_forward. g_ti / g_it: output cotangents in t's
// dtype; dt / di are written in t's / i's dtype. `part` is a float32
// workspace of batch * 80,480 values; `dw` receives the 80,480 float32
// weight gradients, the 32 tensors back to back in the order of `weights`.
extern "C" int rca_fused_backward(const void* t, const void* i,
                                  const void* const* weights,
                                  const void* g_ti, const void* g_it,
                                  void* dt, void* di, void* part, void* dw,
                                  int batch, int t_dtype, int i_dtype,
                                  int w_dtype, int reverse, void* stream) {
  if (batch <= 0) return 0;
  const Weights w = unpack(weights);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(backward(t, i, w, g_ti, g_it, dt, di,
                                   static_cast<float*>(part),
                                   static_cast<float*>(dw), batch, t_dtype,
                                   i_dtype, w_dtype, reverse, s));
}
