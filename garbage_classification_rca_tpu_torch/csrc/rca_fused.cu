// Fused MM-RCA block, forward and backward, for Hopper (sm_90a).
//
// Forward (rca_fused_forward) replaces
// garbage_classification_rca_tpu/kernels/rca_fused.py::rca_fused (Pallas
// body `_kernel`). It computes the whole block:
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
// (Pallas body `_bwd_kernel`, helpers `_unit_fwd_res` / `_unit_bwd`): dt,
// di and all 32 weight gradients in fp32. The TPU kernel summed the weight
// gradients across its sequential grid; blocks here run in no order, so
// the batch is summed by one pass in a fixed order (no atomics: the same
// gradients on every run).
//
// What bounds both on the H100: arithmetic. 2.87 MFLOP per sample forward
// (about three times that backward) against ~13 KB of activations in and
// out, all in fp32 (no tensor-core path keeps fp32 exact), so the fp32
// CUDA-core rate is the roof. The 32 weight tensors (80,480 values, 322 KB
// in fp32) do not fit one block's 227 KB of shared memory, so a block
// stages ONE attention unit's weights at a time (the largest, sa_img, is
// 110 KB). The first versions transpose them to [in][out] with an odd
// leading dimension (conflict-free transposing stores and column-parallel
// reads); the stage kernels keep the [out][in] rows, padded to in + 4
// (16-byte copies, one 16-byte load for a column's 4 inputs, a
// quarter-warp's rows on distinct banks). One block per sample, or sample
// group, and unit, so no batch padding: the ragged edge of the TPU tiling
// does not exist here.
//
// The forward has two routes, every output the same chain of fp32
// operations in the same order (bit for bit):
// - "staged", the default: two kernels over (sample group, unit) blocks,
//     1 rca_fwd_self   sa_txt | sa_img of G samples; t_sa, i_sa to a
//                      global fp32 workspace (1.5 MB at B = 128: L2)
//     2 rca_fwd_cross  rca_ti | rca_it of G samples from it; ti, it
//   G = 1 while the 2B blocks are no more than the SMs (the train
//   microbatch, 16), else 2 (the eval batch, 128: one staged copy of a
//   unit's weights serves two samples). Stage 2 is launched as a
//   programmatic dependent of stage 1: its blocks stage their weights on
//   the SMs stage 1 leaves free and wait (griddepcontrol) before reading
//   the workspace. The first version ran the four units one after another
//   in one block a sample: 16 of 132 SMs busy at B = 16, each re-staging
//   322 KB. Stage 1 of the backward's staged route is stage 1 here with
//   the residuals stored (self_fwd<.., RES>), its stage 2 starts as stage
//   2 here (cross_load, project_group, attn_fwd_group). Inside a block:
//   the weights by cp.async (bf16: 16-byte loads, all of a thread's in
//   flight, converted exactly); the projection 8 x 4 outputs a thread; the
//   softmax of a row on the lanes of a warp (the max by shuffles, the sum
//   of the exponentials in order from the shuffled values) and each mixing
//   weight, a division when `reverse`, computed once; LayerNorm's warp
//   sums on 16 / G lanes a row, their butterfly's first steps in
//   registers. What bounds it now: each stage block's serial chain of
//   dependent phases (staging from L2, the projection at the rate shared
//   memory hands out its operands, the score chains of 128 / 64 dependent
//   FMAs), not the operations.
// - "per_sample" (rca_fused_kernel), the first version; taken only when
//   asked for.
// rca_fwd_plan (kernels/rca_fused.py) gives each route's grids, samples a
// block, shared memory and workspace; the C entry refuses any other.
//
// The backward has two routes. Every output of both is the same chain of
// fp32 fmaf / add operations in the same order (bit for bit; the stage
// kernels share unit_bwd_attn with the first version, their forward
// halves are the forward's stage code, and their own loops only give a
// thread several outputs):
// - "staged", the default: four kernels. A training microbatch is 16
//   samples; one block per sample running the whole chain (six unit passes
//   in order, the self-attentions' forward twice) kept 16 of the 132 SMs
//   busy at ~11% of their fp32 rate. The chain's dependencies allow two
//   units side by side at each step, so each stage is a grid of (sample,
//   unit) blocks:
//     1 rca_bwd_self_fwd  sa_txt | sa_img forward, once; its residuals
//                         (P = q|k|v, softmax A, yhat, 1/std) and output
//                         go to a global fp32 workspace (L2-resident: ~2.7
//                         MB at B = 16)
//     2 rca_bwd_cross     rca_ti | rca_it forward from the stored outputs,
//                         then backward to dq|dk|dv, the unit's dx_q and
//                         dx_kv (four separate slots), the LayerNorm affine
//                         gradients of the sample
//     3 rca_bwd_self_bwd  dtsa = ti's dx_q + it's dx_kv, disa = ti's dx_kv
//                         + it's dx_q, then sa_txt | sa_img backward from
//                         the stored residuals to dq|dk|dv and dt / di
//     4 rca_bwd_wgrad     every weight gradient as one thread's sum over
//                         the batch in order, sample by sample: each
//                         sample's 16-term fmaf chain, then added, as the
//                         per-sample route's partials and reduce add them
//   The weight gradients no longer make a 5 MB round trip through
//   per-sample partials (B x 322 KB). Inside a stage block, what the first
//   version's loops left exposed is answered: the weights are staged by
//   cp.async, all in flight at once (stage 3's land while its attention
//   backward runs); the projection and dx loops give a thread 8 x 4 / 4 x 4
//   and 2 x 4 outputs, loading 4 terms before their FMAs, dx from the
//   weights in their own [out][in] layout (stage 2: the rows its
//   projection read) and dq|dk|dv transposed (16- and 8-byte loads). What
//   bounds it now: each stage block's serial chain on one SM (2B of the
//   132 busy), the attention backward's phases with few threads active,
//   and four launches.
// - "per_sample" (rca_bwd_kernel + rca_bwd_reduce), the first version:
//   one block per sample recomputes the forward and runs the whole chain,
//   writing its sample's partial gradients for a second kernel to sum.
//   Kept for the A/B on the card; taken only when asked for.
// rca_bwd_plan (kernels/rca_fused.py) gives each route's grids, shared
// memory and workspace layout; the C entry refuses any other.

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

// unit_fwd_res from the projections in P on.
__device__ void unit_fwd_attn(int dkq, int dv, bool reverse, float* sm,
                              float* out) {
  const float* gam = sm + OFF_GAM;
  const float* bet = sm + OFF_BET;
  float* P = sm + B_P;
  float* A = sm + B_A;
  float* YH = sm + B_YH;
  float* INV = sm + B_INV;
  const int tid = threadIdx.x;
  const int LD = 2 * dkq + dv + 1;

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

// Forward of one unit keeping what its backward needs, with the unit's
// weights already staged: P (q | k | v), A (softmax a), YH (yhat), INV.
// Writes relu(yhat * g + be) to `out` when it is not null.
__device__ void unit_fwd_res(const float* xq, const float* xkv, int din,
                             int dkq, int dv, bool reverse, float* sm,
                             float* out) {
  project(xq, xkv, din, dkq, dv, sm, sm + B_P);
  __syncthreads();
  unit_fwd_attn(dkq, dv, reverse, sm, out);
}

// The attention part of one unit's backward, with the LayerNorm affine
// staged and the residuals of unit_fwd_res in shared memory. The cotangent
// of the unit's output is in G ([16][dv]). Writes this sample's LayerNorm
// affine gradients to g_g / g_be and leaves dq | dk | dv in DP.
__device__ void unit_bwd_attn(int dkq, int dv, bool reverse, float* sm,
                              float* g_g, float* g_be) {
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
}

// Backward of one unit whose weights are staged and whose residuals
// unit_fwd_res left in shared memory (the per-sample route). The cotangent
// of the unit's output is in G ([16][dv]). Writes this sample's 8 weight
// gradients (torch layouts, in the kernel's weight order) to `wg`, and
// dx_q / dx_kv to `dxq` / `dxkv`, added to what they hold when `acc_q` /
// `acc_kv`.
__device__ void unit_bwd(const float* xq, const float* xkv, int din, int dkq,
                         int dv, bool reverse, float* sm, float* __restrict__ wg,
                         float* dxq, bool acc_q, float* dxkv, bool acc_kv) {
  const float* Wt = sm;
  const float* DP = sm + B_DP;
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

  unit_bwd_attn(dkq, dv, reverse, sm, g_g, g_be);
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

constexpr int REDUCE_GRID = (N_WEIGHTS + 255) / 256;

// out[e] = sum_b part[b][e], the batch summed in order.
__global__ void rca_bwd_reduce(const float* __restrict__ part, int batch,
                               float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N_WEIGHTS) return;
  float a = 0.f;
  for (int b = 0; b < batch; ++b) a += part[static_cast<size_t>(b) * N_WEIGHTS + e];
  out[e] = a;
}

// ---------------------------------------------------------------------------
// the staged route
// ---------------------------------------------------------------------------

constexpr int CA_C = 2 * CA_KQ + CA_V;       // 176 projected columns
// K3's stage blocks' shared memory: stage 1 in the forward's compact
// carve-up (Lay below; its plan keeps the first version's size), stages 2
// and 3 in the per-sample kernel's, their own buffers past B_XT (the end
// of DP)
constexpr int S1_BYTES = sizeof(float) * (B_G + NP * (DI + SA_V));
constexpr int S2_XQ = B_XT, S2_XKV = S2_XQ + NP * SA_V;
constexpr int S2_BYTES = sizeof(float) * (S2_XKV + NP * SA_V);
constexpr int S2_DPT = S2_XQ;               // after the projection
constexpr int S3_DX = B_XT, S3_DPT = S3_DX + NP * DI;
constexpr int S3_BYTES = sizeof(float) * (S3_DPT + NP * SA_C);
static_assert(S2_BYTES <= 232448, "stage 2 exceeds shared memory");

// The workspace regions, in rca_bwd_plan's order; (unit, sample) slot s =
// u * B + b indexes the self-attention residuals and the LayerNorm parts.
enum Region {
  R_SA_P,    // [2][B][16][352]  q | k | v of sa_txt, sa_img
  R_SA_A,    // [2][B][16][16]   softmax
  R_SA_YH,   // [2][B][16][96]   yhat
  R_SA_INV,  // [2][B][16]       1 / std
  R_SA_OUT,  // [2][B][16][96]   t_sa, i_sa
  R_D0,      // [B][16][C]       dq | dk | dv of sa_txt, sa_img, rca_ti,
  R_D1,      //                  rca_it (C = 352, 352, 176, 176)
  R_D2,
  R_D3,
  R_DX,      // [4][B][16][96]   dx_q / dx_kv of rca_ti, then of rca_it
  R_LN,      // [4][B][2][96]    per-sample dg, dbe (the first dv used)
  N_REGIONS
};

long long region_floats(int r, long long b) {
  switch (r) {
    case R_SA_P: return 2 * b * NP * SA_C;
    case R_SA_A: return 2 * b * NP * NP;
    case R_SA_YH: case R_SA_OUT: return 2 * b * NP * SA_V;
    case R_SA_INV: return 2 * b * NP;
    case R_D0: case R_D1: return b * NP * SA_C;
    case R_D2: case R_D3: return b * NP * CA_C;
    case R_DX: return 4 * b * NP * SA_V;
    default: return 4 * b * 2 * SA_V;
  }
}

struct Ws {
  float* r[N_REGIONS];
};

// One sample's 16 x C compact rows from a shared [16][C + 1] buffer.
template <int C>
__device__ void rows_out(const float* src, float* dst) {
  for (int e = threadIdx.x; e < NP * C; e += THREADS) {
    const int n = e / C;
    dst[e] = src[n * (C + 1) + e - n * C];
  }
}
__device__ void copy(const float* src, int n, float* dst) {
  for (int e = threadIdx.x; e < n; e += THREADS) dst[e] = src[e];
}

// cp.async: 4- or 16-byte copies from global to shared memory that the
// threads do not wait for; cp_async_wait<N> waits until at most the N
// newest commit groups are in flight.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
constexpr bool IS_F32 = false;
template <>
constexpr bool IS_F32<float> = true;

// One staged value: fp32 by a 4-byte cp.async (the caller commits and
// waits), other dtypes converted by the thread.
template <typename TW>
__device__ __forceinline__ void put(float* dst, const TW* src, int i) {
  if constexpr (IS_F32<TW>)
    cp_async4(dst, src + i);
  else
    *dst = ld(src, i);
}

// Where a stage block keeps one unit's staged weights, in their own
// [out][in] layout, rows padded to DIN + 4 (stage_rows), its biases and
// LayerNorm affine, and, for each of its samples s (at + s * stride), the
// x tile(s) transposed to xT[in][16] and the attention buffers P (q | k |
// v, [16][C + 1]), W (the mixing weights mix(a)), A (the softmax a, kept
// for K3), Y (the attention output, then yhat) and 1/std.
struct Buf {
  float* wt;
  float *bias, *gam, *bet;
  float *xq, *xkv;   // the same tile for a self-attention
  float *P, *W, *A, *YH, *INV;
  int stride;
};

// The per-sample kernel's carve-up, which K3's stages 2 and 3 keep (their
// attention backward reads it), with the x tiles at xq / xkv; W in dS,
// which the backward writes later.
__device__ Buf fixed_buf(float* sm, int xq, int xkv) {
  return Buf{sm,          sm + OFF_BIAS, sm + OFF_GAM, sm + OFF_BET,
             sm + xq,     sm + xkv,      sm + B_P,     sm + B_DS,
             sm + B_A,    sm + B_YH,     sm + B_INV,   0};
}

// The forward's compact carve-up for a unit of input width DIN and NX x
// tiles a sample (1: self-attention, 2: cross): the weights and vectors,
// then a 16-byte aligned slot of PER floats per sample; W takes the x
// tile's place once the projection has read it (K1 keeps no A).
template <int DIN, int DKQ, int DV, int NX>
struct Lay {
  static constexpr int C = 2 * DKQ + DV, LD = C + 1, LDW = DIN + 4;
  static constexpr int HEAD = (C * LDW + C + 2 * DV + 3) / 4 * 4;
  static constexpr int P = NX * DIN * NP, A = P + NP * LD, Y = A + NP * NP,
                       INV = Y + NP * DV, PER = (INV + NP + 3) / 4 * 4;
  static constexpr int floats(int g) { return HEAD + g * PER; }
  static __device__ Buf buf(float* sm) {
    float* v = sm + C * LDW;
    float* s = sm + HEAD;
    return Buf{sm, v, v + C, v + C + DV, s, s + (NX - 1) * DIN * NP,
               s + P, s, s + A, s + Y, s + INV, PER};
  }
};

// stage_unit's biases and LayerNorm affine, every copy in flight at once
// (fp32; other dtypes converted by the threads).
template <typename TW, int DKQ, int DV>
__device__ void stage_vectors(const Unit& u, const Buf& m) {
  const TW* bq = static_cast<const TW*>(u.bq);
  const TW* bk = static_cast<const TW*>(u.bk);
  const TW* bv = static_cast<const TW*>(u.bv);
  for (int c = threadIdx.x; c < DKQ; c += THREADS) {
    put(m.bias + c, bq, c);
    put(m.bias + DKQ + c, bk, c);
  }
  for (int c = threadIdx.x; c < DV; c += THREADS) {
    put(m.bias + 2 * DKQ + c, bv, c);
    put(m.gam + c, static_cast<const TW*>(u.g), c);
    put(m.bet + c, static_cast<const TW*>(u.be), c);
  }
}

// A unit's q | k | v weight matrices in their own [out][in] layout, the
// rows stacked (c: q, then k, then v) at stride LDW: Wr[c][LDW]. fp32 by
// 16-byte cp.async (the caller commits and waits), bf16 8 values a 16-byte
// load, all of a thread's loads before their conversions and stores; a matrix
// that is not 16-byte aligned value by value. LDW = DIN + 4 where
// project_group reads them (a quarter-warp's rows on distinct banks), DIN
// where only dx_raw does.
template <typename TW, int DIN, int DKQ, int DV, int LDW>
__device__ void stage_rows(const Unit& u, float* wr) {
  constexpr int C = 2 * DKQ + DV;
  const TW* wq = static_cast<const TW*>(u.wq);
  const TW* wk = static_cast<const TW*>(u.wk);
  const TW* wv = static_cast<const TW*>(u.wv);
  auto row = [&](int c) {
    return c < DKQ ? wq + c * DIN
                   : (c < 2 * DKQ ? wk + (c - DKQ) * DIN
                                  : wv + (c - 2 * DKQ) * DIN);
  };
  const bool aligned = (reinterpret_cast<uintptr_t>(wq) |
                        reinterpret_cast<uintptr_t>(wk) |
                        reinterpret_cast<uintptr_t>(wv)) % 16 == 0;
  if constexpr (IS_F32<TW>) {
    if (aligned) {
      for (int q = threadIdx.x; q < C * DIN / 4; q += THREADS) {
        const int c = q / (DIN / 4), k = 4 * (q - c * (DIN / 4));
        cp_async16(wr + c * LDW + k, row(c) + k);
      }
      return;
    }
  } else {
    if (aligned) {
      // a thread's loads all in flight (at most 14 = 56 registers)
      constexpr int K8 = DIN / 8, N8 = C * K8,
                    R = (N8 + THREADS - 1) / THREADS < 14
                            ? (N8 + THREADS - 1) / THREADS : 14;
      static_assert(DIN % 8 == 0, "whole 16-byte loads");
      for (int q0 = threadIdx.x; q0 < N8; q0 += R * THREADS) {
        uint4 v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int q = q0 + r * THREADS, c = q / K8, k = 8 * (q - c * K8);
          if (q < N8) v[r] = *reinterpret_cast<const uint4*>(row(c) + k);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int q = q0 + r * THREADS, c = q / K8, k = 8 * (q - c * K8);
          if (q >= N8) break;
          // bf16 -> fp32 exactly: the bits in the upper half
          float4* d = reinterpret_cast<float4*>(wr + c * LDW + k);
          d[0] = make_float4(__uint_as_float(v[r].x << 16),
                             __uint_as_float(v[r].x & 0xffff0000u),
                             __uint_as_float(v[r].y << 16),
                             __uint_as_float(v[r].y & 0xffff0000u));
          d[1] = make_float4(__uint_as_float(v[r].z << 16),
                             __uint_as_float(v[r].z & 0xffff0000u),
                             __uint_as_float(v[r].w << 16),
                             __uint_as_float(v[r].w & 0xffff0000u));
        }
      }
      return;
    }
  }
  for (int e = threadIdx.x; e < C * DIN; e += THREADS) {
    const int c = e / DIN;
    put(wr + c * LDW + e - c * DIN, row(c), e - c * DIN);
  }
}

// The stage kernels' projection and input-gradient loops: the chains of
// project and unit_bwd's dx loop (each output's terms in the same order)
// with several outputs a thread: 6 shared loads per 32 FMAs (projection)
// or 2 per 8 (dx, 8 and 16 bytes), where those load 5 per 4 or 2 per 1.

// project for the ng samples of a block, x transposed, xT[k][16], the
// weights in their own layout (stage_rows, LDW = DIN + 4): a thread's RN
// rows n = RN ng + i of one sample in RN / 4 16-byte loads, its NC columns'
// 4 weights of a k step in one 16-byte load each. A thread's columns lie
// in one of q | k | v, each split NC ways (c = base + cg + j * stride), so
// a warp's columns are consecutive. Shared memory hands a warp 32 values a
// clock, the SM's FMA units take 128: a thread's RN + NC values per k for
// RN x NC FMAs keep the loads in their shadow only from 8 x 8 on, which
// leaves too few threads; self-attentions take 8 x 4 (176 threads a
// sample), cross-attentions 4 x 4 (176).
template <int RN, int NC, int DIN, int DKQ, int DV>
__device__ void project_group(const Buf& m, int ng) {
  constexpr int C = 2 * DKQ + DV, LD = C + 1, LDW = DIN + 4, Q = C / NC,
                T = NP / RN * Q;
  for (int e = threadIdx.x; e < ng * T; e += THREADS) {
    const int s = e / T, f = e - s * T, ng_ = f / Q, r = f - ng_ * Q;
    const int region = r < DKQ / NC ? 0 : (r < 2 * DKQ / NC ? 1 : 2);
    const int stride = (region < 2 ? DKQ : DV) / NC;
    const int c0 = region * DKQ + r - region * (DKQ / NC);
    const float* xT = (region == 0 ? m.xq : m.xkv) + s * m.stride;
    float* P = m.P + s * m.stride;
    float a[RN][NC] = {};
    // two k steps a pass: the second's loads issue under the first's FMAs
    // (1 - 2 warps a scheduler cannot hide them otherwise; unrolled whole,
    // the code outgrew the instruction cache)
#pragma unroll 2
    for (int k0 = 0; k0 < DIN; k0 += 4) {   // 4 k's loads, then their FMAs
      float xv[4][RN], wv[NC][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int h = 0; h < RN; h += 4) {
          const float4 x4 = *reinterpret_cast<const float4*>(
              xT + (k0 + q) * NP + RN * ng_ + h);
          xv[q][h] = x4.x, xv[q][h + 1] = x4.y, xv[q][h + 2] = x4.z,
          xv[q][h + 3] = x4.w;
        }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float4 w4 = *reinterpret_cast<const float4*>(
            m.wt + (c0 + j * stride) * LDW + k0);
        wv[j][0] = w4.x, wv[j][1] = w4.y, wv[j][2] = w4.z, wv[j][3] = w4.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < RN; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j)
            a[i][j] = fmaf(xv[q][i], wv[j][q], a[i][j]);
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = c0 + j * stride;
      const float bc = m.bias[c];
#pragma unroll
      for (int i = 0; i < RN; ++i) P[(RN * ng_ + i) * LD + c] = a[i][j] + bc;
    }
  }
}

// warp_sum of one LayerNorm row as unit_fwd_attn takes it (lane l's terms
// j = l, l + 32, .. added in order, then the xor butterfly 16, 8, 4, 2, 1)
// with L lanes a row: this thread holds lanes h + L r, r < 32 / L, in v
// and takes the butterfly's steps 16 .. L in registers, each lane's own
// value first as the shuffles add it; the same sums, bit for bit.
template <int L>
__device__ __forceinline__ float row_sum(float (&v)[32 / L]) {
#pragma unroll
  for (int o = 16; o >= L; o >>= 1)
#pragma unroll
    for (int r = 0; r < 32 / L; ++r)
      if (!(r & (o / L))) v[r] = v[r] + v[r + o / L];
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  return v[0];
}

// unit_fwd_attn for the ng <= G samples of a block, from their projections
// in P on: every output the same chain of operations (bit for bit), with
// more threads at work. Scores and softmax in one pass, a row's 16 (n, m)
// pairs on the lanes of a warp: the max by shuffles (fmaxf is exact in any
// order), the sum of the exponentials in order from m = 0 from shuffles,
// and the mixing weight mix(a) once per pair (reverse: a division, which
// the W V loop took per use); W V with 4 rows a thread; LayerNorm 16 / G
// lanes a row (row_sum). Hands relu(yhat * g + be) of sample s, element
// n * DV + j, to out(s, e, v); with RES it also leaves a in A, yhat in YH
// and 1/std in INV.
template <int DKQ, int DV, int G, bool RES, typename Out>
__device__ void attn_fwd_group(const Buf& m, int ng, bool reverse, Out out) {
  constexpr int LD = 2 * DKQ + DV + 1;
  // a thread's G x G pairs: rows n = G np + i, columns m = mp + 16 / G j,
  // a row's 16 on 16 / G lanes. One pair a thread at G = 1 (2 shared loads
  // per FMA, 8 warps); 2 x 2 at G = 2 (1 per FMA: two warps a sample, the
  // pairs of G = 1 would load 4,096 values a sample)
  constexpr int LR = NP / G, PER = NP * NP / (G * G);
  static_assert(G * PER <= THREADS, "a thread for each pair group");
  if (static_cast<int>(threadIdx.x) < ng * PER) {
    const int s = threadIdx.x / PER, u = threadIdx.x - s * PER,
              np = u / LR, mp = u - np * LR;
    const float* q0 = m.P + s * m.stride + G * np * LD;
    const float* k0 = m.P + s * m.stride + mp * LD + DKQ;
    float a[G][G] = {};
#pragma unroll 8
    for (int d = 0; d < DKQ; ++d) {
      float x[G], y[G];
#pragma unroll
      for (int i = 0; i < G; ++i)
        x[i] = q0[i * LD + d], y[i] = k0[i * LR * LD + d];
#pragma unroll
      for (int i = 0; i < G; ++i)
#pragma unroll
        for (int j = 0; j < G; ++j) a[i][j] = fmaf(x[i], y[j], a[i][j]);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      float sc[G], ex[G];
      float mx = a[i][0] / sqrtf(static_cast<float>(DKQ));
#pragma unroll
      for (int j = 0; j < G; ++j) {
        sc[j] = a[i][j] / sqrtf(static_cast<float>(DKQ));
        mx = fmaxf(mx, sc[j]);
      }
      for (int o = LR / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
#pragma unroll
      for (int j = 0; j < G; ++j) ex[j] = expf(sc[j] - mx);
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < NP; ++q)
        sum += __shfl_sync(0xffffffffu, ex[q / LR], q % LR, LR);
      const int row = s * m.stride + (G * np + i) * NP + mp;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float w = ex[j] / sum;
        if constexpr (RES) m.A[row + LR * j] = w;
        m.W[row + LR * j] = mix(w, reverse);
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < ng * 4 * DV; e += THREADS) {
    const int s = e / (4 * DV), f = e - s * 4 * DV, nq = f / DV,
              j = f - nq * DV;
    const float* P = m.P + s * m.stride;
    const float* W = m.W + s * m.stride;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const float v = P[k * LD + 2 * DKQ + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = fmaf(W[(nq + 4 * i) * NP + k], v, a[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      m.YH[s * m.stride + (nq + 4 * i) * DV + j] = a[i];
  }
  __syncthreads();
  constexpr int L = NP / G, R = 32 / L;   // all G x 16 rows at once
  for (int row = threadIdx.x / L; row < ng * NP; row += THREADS / L) {
    const int h = threadIdx.x % L, s = row / NP, n = row - s * NP;
    float* y = m.YH + s * m.stride + n * DV;
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float a = 0.f;
      for (int j = h + L * r; j < DV; j += 32) a += y[j];
      v[r] = a;
    }
    const float mean = row_sum<L>(v) / static_cast<float>(DV);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float q = 0.f;
      for (int j = h + L * r; j < DV; j += 32) {
        const float d = y[j] - mean;
        q = fmaf(d, d, q);
      }
      v[r] = q;
    }
    const float var = row_sum<L>(v) / static_cast<float>(DV);
    const float inv = 1.f / sqrtf(var + 1e-5f);
    __syncwarp();
    for (int j = h; j < DV; j += L) {
      const float yh = (y[j] - mean) * inv;
      if constexpr (RES) y[j] = yh;
      out(s, n * DV + j, fmaxf(yh * m.gam[j] + m.bet[j], 0.f));
    }
    if (RES && h == 0) m.INV[s * m.stride + n] = inv;
  }
  __syncthreads();
}

// x [16][DIN] from `src` (fp32 or not) into xT[k][16].
template <int DIN, typename T>
__device__ void load_transposed(const T* src, float* xT) {
  static_assert(NP * DIN % THREADS == 0, "whole rounds of loads");
#pragma unroll
  for (int r = 0; r < NP * DIN / THREADS; ++r) {
    const int e = threadIdx.x + r * THREADS, k = e / NP, n = e - k * NP;
    xT[e] = ld(src, static_cast<size_t>(n) * DIN + k);
  }
}

// DPT[c][16] = DP[n][c]: dq | dk | dv transposed for dx_raw.
template <int C>
__device__ void transpose_dp(const float* sm, float* DPT) {
  for (int e = threadIdx.x; e < NP * C; e += THREADS) {
    const int c = e / NP, n = e - c * NP;
    DPT[e] = sm[B_DP + n * (C + 1) + c];
  }
}

// a[i][j] = sum over c in [c_lo, c_hi) of d[2 ng + i][c] W[c][4 kg + j],
// 4 c's loads, then their FMAs (c_hi - c_lo a multiple of 4)
template <int LDW>
__device__ __forceinline__ void dx_raw_chain(const float* DPT, const float* Wr,
                                             int ng, int kg, int c_lo,
                                             int c_hi, float (&a)[2][4]) {
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
  for (int c0 = c_lo; c0 < c_hi; c0 += 4) {
    float2 d2[4];
    float4 w4[4];
    for (int q = 0; q < 4; ++q) {
      d2[q] = *reinterpret_cast<const float2*>(DPT + (c0 + q) * NP + 2 * ng);
      w4[q] = *reinterpret_cast<const float4*>(Wr + (c0 + q) * LDW + 4 * kg);
    }
    for (int q = 0; q < 4; ++q) {
      const float d[2] = {d2[q].x, d2[q].y};
      const float w[4] = {w4[q].x, w4[q].y, w4[q].z, w4[q].w};
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 4; ++j) a[i][j] = fmaf(d[i], w[j], a[i][j]);
    }
  }
}

// unit_bwd's dx chains from DPT and the weights' own layout at the start of
// shared memory (stage_rows, rows at stride LDW): rows n = 2 ng + i, inputs
// k = 4 kg + j (2 din threads), each c an 8- and a 16-byte load for 8 FMAs.
template <int DIN, int DKQ, int DV, int LDW>
__device__ void dx_raw(const float* sm, const float* DPT, float* dxq,
                       bool acc_q, float* dxkv, bool acc_kv) {
  constexpr int K4 = DIN / 4;
  for (int e = threadIdx.x; e < NP / 2 * K4; e += THREADS) {
    const int ng = e / K4, kg = e - ng * K4;
    float aq[2][4], akv[2][4];
    dx_raw_chain<LDW>(DPT, sm, ng, kg, 0, DKQ, aq);
    dx_raw_chain<LDW>(DPT, sm, ng, kg, DKQ, 2 * DKQ + DV, akv);
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 4; ++j) {
        const int o = (2 * ng + i) * DIN + 4 * kg + j;
        dxq[o] = acc_q ? dxq[o] + aq[i][j] : aq[i][j];
        dxkv[o] = acc_kv ? dxkv[o] + akv[i][j] : akv[i][j];
      }
  }
}

// The self-attention forward of a (sample group, unit) block: sa_txt (u =
// 0, x = t) or sa_img (u = 1, x = i) of samples b0 .. b0 + ng - 1 (ng <=
// G), in the compact carve-up. The outputs t_sa / i_sa go to sa_out
// ([2][B][16][96], slot u * B + b); with RES also the residuals K3's later
// stages read (P, A, yhat, 1/std).
template <typename TX, typename TW, int DIN, int G, bool RES>
__device__ void self_fwd(const Unit& un, const TX* __restrict__ x, int u,
                         int B, int b0, int ng, float* sm,
                         float* __restrict__ sa_out, const Ws* ws) {
  const Buf m = Lay<DIN, SA_KQ, SA_V, 1>::buf(sm);
  stage_vectors<TW, SA_KQ, SA_V>(un, m);
  stage_rows<TW, DIN, SA_KQ, SA_V, DIN + 4>(un, m.wt);
  cp_async_commit();
  for (int s = 0; s < ng; ++s)
    load_transposed<DIN>(x + static_cast<size_t>(b0 + s) * NP * DIN,
                         m.xq + s * m.stride);
  cp_async_wait<0>();
  __syncthreads();
  project_group<8, 4, DIN, SA_KQ, SA_V>(m, ng);
  __syncthreads();
  float* out = sa_out + (static_cast<size_t>(u) * B + b0) * NP * SA_V;
  attn_fwd_group<SA_KQ, SA_V, G, RES>(
      m, ng, false,
      [&](int s, int e, float v) { out[s * NP * SA_V + e] = v; });
  if constexpr (RES) {
    for (int s = 0; s < ng; ++s) {
      const size_t slot = static_cast<size_t>(u) * B + b0 + s;
      const int o = s * m.stride;
      rows_out<SA_C>(m.P + o, ws->r[R_SA_P] + slot * NP * SA_C);
      copy(m.A + o, NP * NP, ws->r[R_SA_A] + slot * NP * NP);
      copy(m.YH + o, NP * SA_V, ws->r[R_SA_YH] + slot * NP * SA_V);
      copy(m.INV + o, NP, ws->r[R_SA_INV] + slot * NP);
    }
  }
}

// A cross unit's weights (rca_ti for y = 0, rca_it for 1), then its ng
// samples' x tiles from sa_out, transposed (queries t_sa, keys / values
// i_sa for rca_ti; the other way round for rca_it), in one cp.async commit
// group (other weight dtypes are converted by the threads).
template <typename TW>
__device__ void cross_load(const Unit& un, const Buf& m,
                           const float* __restrict__ sa_out, int B, int y,
                           int b0, int ng) {
  stage_vectors<TW, CA_KQ, CA_V>(un, m);
  stage_rows<TW, SA_V, CA_KQ, CA_V, SA_V + 4>(un, m.wt);
  // launched as a programmatic dependent (K1's stage 2), the block has
  // started its weights while stage 1 ran: wait for stage 1 to finish and
  // its sa_out to be visible (a no-op in a kernel launched plainly)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int e = threadIdx.x; e < ng * NP * SA_V; e += THREADS) {
    const int s = e / (NP * SA_V), f = e - s * NP * SA_V;
    const int k = f / NP, n = f - k * NP;   // xT[k][16]
    const float* tsa = sa_out + static_cast<size_t>(b0 + s) * NP * SA_V;
    const float* isa = tsa + static_cast<size_t>(B) * NP * SA_V;
    cp_async4(m.xq + s * m.stride + f, (y == 0 ? tsa : isa) + n * SA_V + k);
    cp_async4(m.xkv + s * m.stride + f, (y == 0 ? isa : tsa) + n * SA_V + k);
  }
  cp_async_commit();
}

// ---------------------------------------------------------------------------
// the forward's staged route: two kernels over (sample group, unit) blocks
// ---------------------------------------------------------------------------

using SelfLay = Lay<DI, SA_KQ, SA_V, 1>;    // sa_img's, the larger
using CrossLay = Lay<SA_V, CA_KQ, CA_V, 2>;
constexpr int fwd_self_bytes(int g) { return 4 * SelfLay::floats(g); }
constexpr int fwd_cross_bytes(int g) { return 4 * CrossLay::floats(g); }
static_assert(Lay<DT, SA_KQ, SA_V, 1>::floats(2) <= SelfLay::floats(2) &&
                  fwd_self_bytes(2) <= 232448 &&
                  fwd_cross_bytes(2) <= 232448,
              "forward stages exceed shared memory");
static_assert(fwd_self_bytes(1) <= S1_BYTES, "K3's stage 1 fits its plan");

// Stage 1, grid (ceil(B / G), 2): sa_txt (y = 0) or sa_img (y = 1) of the
// block's G samples (the last block: those left); t_sa / i_sa to sa_out.
template <typename TT, typename TI, typename TW, int G>
__global__ void __launch_bounds__(THREADS)
    rca_fwd_self(const TT* __restrict__ t, const TI* __restrict__ im,
                 Weights w, float* __restrict__ sa_out, int batch) {
  extern __shared__ float sm[];
  // stage 2's blocks may start (and stage their weights) on the SMs left
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b0 = blockIdx.x * G;
  const int ng = batch - b0 < G ? batch - b0 : G;
  if (blockIdx.y == 0)
    self_fwd<TT, TW, DT, G, false>(w.u[0], t, 0, batch, b0, ng, sm, sa_out,
                                   nullptr);
  else
    self_fwd<TI, TW, DI, G, false>(w.u[1], im, 1, batch, b0, ng, sm, sa_out,
                                   nullptr);
}

// Stage 2, grid (ceil(B / G), 2): rca_ti (y = 0) or rca_it (y = 1) of the
// block's samples from sa_out; ti / it written in t's dtype. Two blocks an
// SM at G = 1. Launched as a programmatic dependent of stage 1.
template <typename TT, typename TW, int G>
__global__ void __launch_bounds__(THREADS, 2)
    rca_fwd_cross(Weights w, const float* __restrict__ sa_out,
                  TT* __restrict__ ti, TT* __restrict__ it, int batch,
                  int reverse) {
  extern __shared__ float sm[];
  const int y = blockIdx.y, b0 = blockIdx.x * G;
  const int ng = batch - b0 < G ? batch - b0 : G;
  const Buf m = CrossLay::buf(sm);
  cross_load<TW>(y == 0 ? w.u[2] : w.u[3], m, sa_out, batch, y, b0, ng);
  cp_async_wait<0>();
  __syncthreads();
  project_group<4, 4, SA_V, CA_KQ, CA_V>(m, ng);
  __syncthreads();
  TT* out = (y == 0 ? ti : it) + static_cast<size_t>(b0) * NP * CA_V;
  attn_fwd_group<CA_KQ, CA_V, G, false>(
      m, ng, reverse != 0,
      [&](int s, int e, float v) { st(out, s * NP * CA_V + e, v); });
}

// ---------------------------------------------------------------------------
// the backward's staged route
// ---------------------------------------------------------------------------

// Stage 1, grid (B, 2): the forward of sa_txt (y = 0) or sa_img (y = 1)
// of sample b (the forward's stage 1 at G = 1), with its residuals and
// output stored for stages 2-4.
template <typename TT, typename TI, typename TW>
__global__ void __launch_bounds__(THREADS)
    rca_bwd_self_fwd(const TT* __restrict__ t, const TI* __restrict__ im,
                     Weights w, Ws ws) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, B = gridDim.x;
  if (blockIdx.y == 0)
    self_fwd<TT, TW, DT, 1, true>(w.u[0], t, 0, B, b, 1, sm,
                                  ws.r[R_SA_OUT], &ws);
  else
    self_fwd<TI, TW, DI, 1, true>(w.u[1], im, 1, B, b, 1, sm,
                                  ws.r[R_SA_OUT], &ws);
}

// Stage 2, grid (B, 2): rca_ti (y = 0: queries t_sa, keys / values i_sa,
// cotangent g_ti) or rca_it (y = 1: the other way round) of sample b:
// forward (the forward's stage 2 at G = 1, in the per-sample carve-up),
// then backward to dq | dk | dv, dx_q, dx_kv and the LayerNorm parts.
template <typename TT, typename TW>
__global__ void __launch_bounds__(THREADS)
    rca_bwd_cross(const TT* __restrict__ g_ti, const TT* __restrict__ g_it,
                  Weights w, Ws ws, int reverse) {
  extern __shared__ float sm[];
  const int y = blockIdx.y;
  const size_t B = gridDim.x, b = blockIdx.x;
  const bool rev = reverse != 0;
  const Unit& un = y == 0 ? w.u[2] : w.u[3];
  const Buf m = fixed_buf(sm, S2_XQ, S2_XKV);
  cross_load<TW>(un, m, ws.r[R_SA_OUT], B, y, b, 1);
  const TT* go = y == 0 ? g_ti : g_it;
  for (int e = threadIdx.x; e < NP * CA_V; e += THREADS)
    sm[B_G + e] = ld(go, b * NP * CA_V + e);
  cp_async_wait<0>();
  __syncthreads();
  project_group<4, 4, SA_V, CA_KQ, CA_V>(m, 1);
  __syncthreads();
  attn_fwd_group<CA_KQ, CA_V, 1, true>(m, 1, rev, [](int, int, float) {});
  float* ln = ws.r[R_LN] + ((2 + y) * B + b) * 2 * SA_V;
  unit_bwd_attn(CA_KQ, CA_V, rev, sm, ln, ln + SA_V);
  rows_out<CA_C>(sm + B_DP, ws.r[R_D2 + y] + b * NP * CA_C);
  transpose_dp<CA_C>(sm, sm + S2_DPT);
  __syncthreads();
  // dx from the weight rows the projection read
  float* dx = ws.r[R_DX] + (2 * y * B + b) * NP * SA_V;
  dx_raw<SA_V, CA_KQ, CA_V, SA_V + 4>(sm, sm + S2_DPT, dx, false,
                                      dx + B * NP * SA_V, false);
}

// Stage 3, grid (B, 2): sa_txt (y = 0) or sa_img (y = 1) of sample b:
// its output's cotangent from the two cross units' dx slots, backward from
// the stored residuals to dq | dk | dv, the LayerNorm parts and dt / di.
template <typename TT, typename TI, typename TW>
__global__ void __launch_bounds__(THREADS)
    rca_bwd_self_bwd(Weights w, Ws ws, TT* __restrict__ dt,
                     TI* __restrict__ di) {
  extern __shared__ float sm[];
  const int u = blockIdx.y;
  const size_t B = gridDim.x, b = blockIdx.x, s = u * B + b;
  // the residuals and the LayerNorm affine first; the weight matrices,
  // which only dx reads, land while the attention backward runs
  const float* P = ws.r[R_SA_P] + s * NP * SA_C;
  for (int e = threadIdx.x; e < NP * SA_C; e += THREADS) {
    const int n = e / SA_C;
    cp_async4(sm + B_P + n * (SA_C + 1) + e - n * SA_C, P + e);
  }
  const float* A = ws.r[R_SA_A] + s * NP * NP;
  const float* YH = ws.r[R_SA_YH] + s * NP * SA_V;
  for (int e = 4 * threadIdx.x; e < NP * NP; e += 4 * THREADS)
    cp_async16(sm + B_A + e, A + e);
  for (int e = 4 * threadIdx.x; e < NP * SA_V; e += 4 * THREADS)
    cp_async16(sm + B_YH + e, YH + e);
  if (threadIdx.x < NP / 4)
    cp_async16(sm + B_INV + 4 * threadIdx.x,
               ws.r[R_SA_INV] + s * NP + 4 * threadIdx.x);
  const Unit& un = u == 0 ? w.u[0] : w.u[1];
  stage_vectors<TW, SA_KQ, SA_V>(un, fixed_buf(sm, 0, 0));
  cp_async_commit();
  if (u == 0)
    stage_rows<TW, DT, SA_KQ, SA_V, DT>(un, sm);
  else
    stage_rows<TW, DI, SA_KQ, SA_V, DI>(un, sm);
  cp_async_commit();
  // dtsa = ti's dx_q + it's dx_kv; disa = ti's dx_kv + it's dx_q
  const size_t slot = B * NP * SA_V;
  const float* dx = ws.r[R_DX] + b * NP * SA_V;
  const float* first = dx + (u == 0 ? 0 : slot);
  const float* second = dx + (u == 0 ? 3 * slot : 2 * slot);
#pragma unroll
  for (int r = 0; r < NP * SA_V / THREADS; ++r) {
    const int e = threadIdx.x + r * THREADS;
    sm[B_G + e] = first[e] + second[e];
  }
  cp_async_wait<1>();
  __syncthreads();
  float* ln = ws.r[R_LN] + s * 2 * SA_V;
  unit_bwd_attn(SA_KQ, SA_V, false, sm, ln, ln + SA_V);
  rows_out<SA_C>(sm + B_DP, ws.r[R_D0 + u] + b * NP * SA_C);
  transpose_dp<SA_C>(sm, sm + S3_DPT);
  cp_async_wait<0>();
  __syncthreads();
  float* dxs = sm + S3_DX;   // dx = dx_q + dx_kv (the same input)
  if (u == 0)
    dx_raw<DT, SA_KQ, SA_V, DT>(sm, sm + S3_DPT, dxs, false, dxs, true);
  else
    dx_raw<DI, SA_KQ, SA_V, DI>(sm, sm + S3_DPT, dxs, false, dxs, true);
  __syncthreads();
  if (u == 0)
    for (int e = threadIdx.x; e < NP * DT; e += THREADS)
      st(dt, b * NP * DT + e, dxs[e]);
  else
    for (int e = threadIdx.x; e < NP * DI; e += THREADS)
      st(di, b * NP * DI + e, dxs[e]);
}

// Stage 4: every weight gradient, each one thread's sum over the batch in
// order. A block's outputs are two 16 x 16 tiles of a unit's [C][din]
// q | k | v weight matrix (4 x 4 outputs a lane), walked in rca_bwd_plan's
// tile order (unit by unit, column tiles, then input tiles), or, past the
// WG_TILES / 2 tile blocks, 32 of the 1,632 bias and LayerNorm values.
// Its eight warps take eight samples at once, each a sample's 16-term
// chain for every output (a chain of L2 loads per sample in one warp was
// the pass's whole time); then each output's owner adds the eight sums in
// batch order.
constexpr int WG_THREADS = 256, WG_WARPS = WG_THREADS / 32, WG_TILE = 16;
constexpr int WG_TILES = (SA_C * DT + SA_C * DI + 2 * CA_C * SA_V) /
                         (WG_TILE * WG_TILE);              // 308
constexpr int WG_VECS = 2 * (SA_C + 2 * SA_V) + 2 * (CA_C + 2 * CA_V);
constexpr int WG_GRID = WG_TILES / 2 + (WG_VECS + 31) / 32;
constexpr int WG_LD = 17;   // a lane's 16 sums, padded: no bank conflicts
static_assert(WG_TILES * WG_TILE * WG_TILE + WG_VECS == N_WEIGHTS,
              "the wgrad pass covers every weight");

// p[i][j] = sum_n d[b][n][c0 + i] x[b][n][k0 + j], one fmaf chain from
// n = 0, for sample b.
template <typename TX>
__device__ __forceinline__ void wgrad_sample(const float* __restrict__ d,
                                             int C, int c0,
                                             const TX* __restrict__ x,
                                             int din, int k0, size_t b,
                                             float (&p)[4][4]) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) p[i][j] = 0.f;
  // half a sample's loads first, so they are in flight at once
  constexpr int H = NP / 2;
#pragma unroll
  for (int h = 0; h < NP; h += H) {
    float4 d4[H];
    float xv[H][4];
#pragma unroll
    for (int n = 0; n < H; ++n) {
      const size_t row = b * NP + h + n;
      // the workspace's rows are 16-byte aligned (rca_bwd_plan)
      d4[n] = *reinterpret_cast<const float4*>(d + row * C + c0);
      for (int j = 0; j < 4; ++j) xv[n][j] = ld(x, row * din + k0 + j);
    }
#pragma unroll
    for (int n = 0; n < H; ++n) {
      const float dv[4] = {d4[n].x, d4[n].y, d4[n].z, d4[n].w};
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) p[i][j] = fmaf(dv[i], xv[n][j], p[i][j]);
    }
  }
}

// Unit u's geometry: input width, q|k|v columns, d_kq, d_v, offset in dw.
struct UnitGeo {
  int din, C, dkq, dv, off;
};
__device__ UnitGeo unit_geo(int u) {
  const int din = u == 0 ? DT : (u == 1 ? DI : SA_V);
  const int dkq = u < 2 ? SA_KQ : CA_KQ, dv = u < 2 ? SA_V : CA_V;
  constexpr int SZ_T = SA_C * DT + SA_C + 2 * SA_V;
  constexpr int SZ_I = SA_C * DI + SA_C + 2 * SA_V;
  constexpr int SZ_C = CA_C * SA_V + CA_C + 2 * CA_V;
  const int off = u == 0 ? 0 : (u == 1 ? SZ_T : SZ_T + SZ_I + (u - 2) * SZ_C);
  return UnitGeo{din, 2 * dkq + dv, dkq, dv, off};
}

// The dw index of weight-matrix element (c, k) of unit g: torch [out][in]
// layouts in the order wq, bq, wk, bk, wv, bv, g, be.
__device__ int w_index(const UnitGeo& g, int c, int k) {
  const int part = c < g.dkq ? 0 : (c < 2 * g.dkq ? 1 : 2);
  return g.off + part * (g.dkq * g.din + g.dkq) + (c - part * g.dkq) * g.din +
         k;
}

// A lane's tile of the tile blocks: unit, first column, first input.
__device__ void lane_tile(int lane, int& u, int& c0, int& k0) {
  int tile = 2 * blockIdx.x + (lane >> 4);
  u = 0;
  while (tile >= unit_geo(u).C * unit_geo(u).din / (WG_TILE * WG_TILE)) {
    tile -= unit_geo(u).C * unit_geo(u).din / (WG_TILE * WG_TILE);
    ++u;
  }
  const int kt = unit_geo(u).din / WG_TILE, l = lane & 15;
  c0 = (tile / kt) * WG_TILE + (l >> 2) * 4;
  k0 = (tile % kt) * WG_TILE + (l & 3) * 4;
}

template <typename TT, typename TI>
__global__ void __launch_bounds__(WG_THREADS, 2)   // one wave: 2 a SM
    rca_bwd_wgrad(const TT* __restrict__ t, const TI* __restrict__ im, Ws ws,
                  int batch, float* __restrict__ dw) {
  __shared__ float part[WG_WARPS][32 * WG_LD];   // a group's per-sample sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t B = batch;
  const bool tiles = blockIdx.x < WG_TILES / 2;
  // the lane's outputs in the tile blocks
  int u, c0 = 0, k0 = 0, v = 0;
  if (tiles) {
    lane_tile(lane, u, c0, k0);
  } else {
    v = (blockIdx.x - WG_TILES / 2) * 32 + lane;
    for (u = 0; u < 3 && v >= unit_geo(u).C + 2 * unit_geo(u).dv; ++u)
      v -= unit_geo(u).C + 2 * unit_geo(u).dv;
  }
  const UnitGeo g = unit_geo(u);
  const float* d = ws.r[R_D0 + u];
  const float* tsa = ws.r[R_SA_OUT];
  const float* isa = tsa + B * NP * SA_V;
  // what each thread owns when the sums are added: tile blocks two of the
  // 512 outputs, vector blocks (warp 0) one of 32
  const int n_own = tiles ? 2 : (warp == 0 ? 1 : 0);
  float acc[2] = {0.f, 0.f};
  for (size_t b0 = 0; b0 < B; b0 += WG_WARPS) {
    const size_t b = b0 + warp;
    if (b < B) {
      float* mine = part[warp] + lane * WG_LD;
      if (tiles) {
        float p[4][4];
        if (u == 0)
          wgrad_sample(d, g.C, c0, t, g.din, k0, b, p);
        else if (u == 1)
          wgrad_sample(d, g.C, c0, im, g.din, k0, b, p);
        else  // rca_ti: q from t_sa, k | v from i_sa; rca_it the other way
          wgrad_sample(d, g.C, c0, (c0 < g.dkq) == (u == 2) ? tsa : isa,
                       g.din, k0, b, p);
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 4; ++j) mine[4 * i + j] = p[i][j];
      } else if (v < g.C) {   // a bias: sum_n d[b][n][c]
        float a = 0.f;
#pragma unroll
        for (int n = 0; n < NP; ++n) a += d[(b * NP + n) * g.C + v];
        mine[0] = a;
      } else if (v < g.C + 2 * g.dv) {   // LayerNorm scale, then shift
        const int j = v - g.C;
        mine[0] = ws.r[R_LN][(u * B + b) * 2 * SA_V +
                             (j < g.dv ? j : SA_V + j - g.dv)];
      }
    }
    __syncthreads();
    const int nb = static_cast<int>(B - b0 < WG_WARPS ? B - b0 : WG_WARPS);
    for (int o = 0; o < n_own; ++o) {
      const int e = threadIdx.x + o * WG_THREADS;   // lane e / 16, sum e % 16
      const int at = tiles ? (e >> 4) * WG_LD + (e & 15) : lane * WG_LD;
      for (int w = 0; w < nb; ++w) acc[o] += part[w][at];
    }
    __syncthreads();
  }
  if (tiles) {
    for (int o = 0; o < 2; ++o) {
      const int e = threadIdx.x + o * WG_THREADS, l = e >> 4, q = e & 15;
      int uo, co, ko;
      lane_tile(l, uo, co, ko);
      dw[w_index(unit_geo(uo), co + (q >> 2), ko + (q & 3))] = acc[o];
    }
  } else if (warp == 0 && v < g.C) {
    const int part_ = v < g.dkq ? 0 : (v < 2 * g.dkq ? 1 : 2);
    dw[g.off + part_ * (g.dkq * g.din + g.dkq) +
       (part_ < 2 ? g.dkq * g.din + v - part_ * g.dkq
                  : g.dv * g.din + v - 2 * g.dkq)] = acc[0];
  } else if (warp == 0 && v < g.C + 2 * g.dv) {
    dw[g.off + 2 * (g.dkq * g.din + g.dkq) + g.dv * g.din + g.dv +
       (v - g.C)] = acc[0];
  }
}

template <typename TT, typename TI, typename TW>
cudaError_t launch_fwd_staged(const void* t, const void* i, const Weights& w,
                              void* ti, void* it, float* sa_out, int g1,
                              int g2, int batch, int reverse,
                              cudaStream_t stream) {
  cudaError_t err;
  const auto smem = cudaFuncAttributeMaxDynamicSharedMemorySize;
  const int s1 = fwd_self_bytes(g1), s2 = fwd_cross_bytes(g2);
  auto k1 =
      g1 == 1 ? rca_fwd_self<TT, TI, TW, 1> : rca_fwd_self<TT, TI, TW, 2>;
  auto k2 = g2 == 1 ? rca_fwd_cross<TT, TW, 1> : rca_fwd_cross<TT, TW, 2>;
  if ((err = cudaFuncSetAttribute(k1, smem, s1)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(k2, smem, s2)) != cudaSuccess)
    return err;
  k1<<<dim3((batch + g1 - 1) / g1, 2), THREADS, s1, stream>>>(
      static_cast<const TT*>(t), static_cast<const TI*>(i), w, sa_out, batch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // stage 2 as a programmatic dependent of stage 1 (griddepcontrol)
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((batch + g2 - 1) / g2, 2);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = s2;
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, k2, w, static_cast<const float*>(sa_out),
                                static_cast<TT*>(ti), static_cast<TT*>(it),
                                batch, reverse)) != cudaSuccess)
    return err;
  return cudaGetLastError();
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
  rca_bwd_reduce<<<REDUCE_GRID, 256, 0, stream>>>(part, batch, dw);
  return cudaGetLastError();
}

template <typename TT, typename TI, typename TW>
cudaError_t launch_staged(const void* t, const void* i, const Weights& w,
                          const void* g_ti, const void* g_it, void* dt,
                          void* di, const Ws& ws, float* dw, int batch,
                          int reverse, cudaStream_t stream) {
  auto k1 = rca_bwd_self_fwd<TT, TI, TW>;
  auto k2 = rca_bwd_cross<TT, TW>;
  auto k3 = rca_bwd_self_bwd<TT, TI, TW>;
  const auto smem = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(k1, smem, S1_BYTES)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(k2, smem, S2_BYTES)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(k3, smem, S3_BYTES)) != cudaSuccess)
    return err;
  const dim3 grid(batch, 2);
  const TT* tt = static_cast<const TT*>(t);
  const TI* ti = static_cast<const TI*>(i);
  k1<<<grid, THREADS, S1_BYTES, stream>>>(tt, ti, w, ws);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k2<<<grid, THREADS, S2_BYTES, stream>>>(static_cast<const TT*>(g_ti),
                                          static_cast<const TT*>(g_it), w,
                                          ws, reverse);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k3<<<grid, THREADS, S3_BYTES, stream>>>(w, ws, static_cast<TT*>(dt),
                                          static_cast<TI*>(di));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rca_bwd_wgrad<TT, TI><<<WG_GRID, WG_THREADS, 0, stream>>>(tt, ti, ws, batch,
                                                            dw);
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

// route 0: per-sample; 1: staged, sa_out its workspace, g1 / g2 the
// samples a block of its two kernels
cudaError_t forward(const void* t, const void* i, const Weights& w, void* ti,
                    void* it, int route, float* sa_out, int g1, int g2,
                    int batch, int t_dt, int i_dt, int w_dt, int reverse,
                    cudaStream_t s) {
#define FWD(TT, TI, TW)                                                    \
  (route == 0 ? launch<TT, TI, TW>(t, i, w, ti, it, batch, reverse, s)     \
              : launch_fwd_staged<TT, TI, TW>(t, i, w, ti, it, sa_out, g1, \
                                              g2, batch, reverse, s))
  RCA_DISPATCH(t_dt, i_dt, w_dt, FWD)
#undef FWD
}

// The staged forward's samples a block, both stages: 1 while the (B, 2)
// blocks are no more than the SMs, else 2, so that one staged copy of a
// unit's weights serves two samples where an SM would otherwise stage it
// for two blocks (measured: PERF.md). kernels/rca_fused.py::rca_fwd_plan
// takes the same.
int fwd_group(int batch, int sms) { return 2LL * batch <= sms ? 1 : 2; }

// route 0: per-sample, `part` the workspace; 1: staged, `ws` its regions
cudaError_t backward(const void* t, const void* i, const Weights& w,
                     const void* g_ti, const void* g_it, void* dt, void* di,
                     int route, float* part, const Ws& ws, float* dw,
                     int batch, int t_dt, int i_dt, int w_dt, int reverse,
                     cudaStream_t s) {
#define BWD(TT, TI, TW)                                                    \
  (route == 0 ? launch_bwd<TT, TI, TW>(t, i, w, g_ti, g_it, dt, di, part,  \
                                       dw, batch, reverse, s)              \
              : launch_staged<TT, TI, TW>(t, i, w, g_ti, g_it, dt, di, ws, \
                                          dw, batch, reverse, s))
  RCA_DISPATCH(t_dt, i_dt, w_dt, BWD)
#undef BWD
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, given for t, i and the weights
// separately. `weights` holds 32 device pointers, per unit (sa_txt, sa_img,
// rca_ti, rca_it): q.w [out,in], q.b, k.w, k.b, v.w, v.b, norm.scale,
// norm.bias. ti / it are written in t's dtype. Runs the launch plan of
// kernels/rca_fused.py::rca_fwd_plan(batch, route, SMs of the current
// device): route 1 "staged", `ws` its float32 workspace of `ws_floats`
// values (t_sa | i_sa, [2][batch][16][96], at offsets[0] = 0), g1 / g2 the
// samples a block of its two kernels, smem1 / smem2 their dynamic shared
// memory; route 0 "per_sample" (the first version): no workspace, g1 = 1, g2 =
// 0, smem1 = 165,376, smem2 = 0. Any other plan is refused with
// cudaErrorInvalidValue before a launch. Returns cudaGetLastError().
extern "C" int rca_fused_forward(const void* t, const void* i,
                                 const void* const* weights, void* ti,
                                 void* it, void* ws, const long long* offsets,
                                 long long ws_floats, int batch, int t_dtype,
                                 int i_dtype, int w_dtype, int reverse,
                                 int route, int g1, int g2, int smem1,
                                 int smem2, void* stream) {
  if (batch <= 0) return 0;
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (route == 0) {
    if (g1 != 1 || g2 != 0 || smem1 != static_cast<int>(SMEM_BYTES) ||
        smem2 != 0 || ws_floats != 0)
      return invalid;
  } else if (route == 1) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (g1 != fwd_group(batch, sms) || g2 != g1 ||
        smem1 != fwd_self_bytes(g1) || smem2 != fwd_cross_bytes(g2) ||
        offsets == nullptr || offsets[0] != 0 ||
        ws_floats != 2LL * batch * NP * SA_V || ws == nullptr ||
        reinterpret_cast<uintptr_t>(ws) % 16)
      return invalid;
  } else {
    return invalid;
  }
  const Weights w = unpack(weights);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(forward(t, i, w, ti, it, route,
                                  static_cast<float*>(ws), g1, g2, batch,
                                  t_dtype, i_dtype, w_dtype, reverse, s));
}

// Backward of rca_fused_forward on the launch plan of
// kernels/rca_fused.py::rca_bwd_plan(batch, route). g_ti / g_it: output
// cotangents in t's dtype; dt / di are written in t's / i's dtype; `dw`
// receives the 80,480 float32 weight gradients, the 32 tensors back to back
// in the order of `weights`. `ws`: the plan's float32 workspace of
// `ws_floats` values, its regions at `offsets` (in floats, the plan's
// order); route 1 is "staged", 0 "per_sample" (`ws` = batch x 80,480
// per-sample partials); smem1..3: the plan's dynamic shared memory of its
// first three kernels (per-sample: 215,680, 0, 0); grid4: the grid of its
// last (the weight-gradient pass, or the per-sample route's reduce). Any
// other plan is refused with cudaErrorInvalidValue before a launch.
extern "C" int rca_fused_backward(const void* t, const void* i,
                                  const void* const* weights,
                                  const void* g_ti, const void* g_it,
                                  void* dt, void* di, void* ws,
                                  const long long* offsets,
                                  long long ws_floats, void* dw, int batch,
                                  int t_dtype, int i_dtype, int w_dtype,
                                  int reverse, int route, int smem1,
                                  int smem2, int smem3, int grid4,
                                  void* stream) {
  if (batch <= 0) return 0;
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (offsets == nullptr || reinterpret_cast<uintptr_t>(ws) % 16)
    return invalid;
  Ws regions{};
  if (route == 0) {
    if (smem1 != static_cast<int>(B_SMEM_BYTES) || smem2 != 0 || smem3 != 0 ||
        grid4 != REDUCE_GRID || offsets[0] != 0 ||
        ws_floats != static_cast<long long>(batch) * N_WEIGHTS)
      return invalid;
  } else if (route == 1) {
    if (smem1 != S1_BYTES || smem2 != S2_BYTES || smem3 != S3_BYTES ||
        grid4 != WG_GRID)
      return invalid;
    long long at = 0;
    for (int r = 0; r < N_REGIONS; ++r) {
      if (offsets[r] != at) return invalid;
      regions.r[r] = static_cast<float*>(ws) + at;
      at += (region_floats(r, batch) + 3) / 4 * 4;   // 16-byte aligned
    }
    if (at != ws_floats) return invalid;
  } else {
    return invalid;
  }
  const Weights w = unpack(weights);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(backward(t, i, w, g_ti, g_it, dt, di, route,
                                   static_cast<float*>(ws), regions,
                                   static_cast<float*>(dw), batch, t_dtype,
                                   i_dtype, w_dtype, reverse, s));
}
