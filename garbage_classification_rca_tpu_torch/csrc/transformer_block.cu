// Fused transformer-encoder blocks for Hopper (sm_90a): the post-norm pair
// of the BERT family and the pre-norm pair of ViT.
//
// Replaces garbage_classification_rca_tpu/kernels/transformer_block.py:
//   tb_attn_block, post = 1: ::postnorm_attn_block (`_postnorm_attn_kernel`)
//       y = LN(x + out_proj(MHA(x Wqkv + b, key mask)))
//   tb_attn_block, post = 0: ::attn_block (`_attn_kernel`)
//       y = x + out_proj(MHA(LN(x) Wqkv + b))
//   tb_mlp_block, post = 1: ::postnorm_mlp_block (`_postnorm_mlp_kernel`)
//       y = LN(x + act(x W1 + b1) W2 + b2)
//   tb_mlp_block, post = 0: ::mlp_block (`_mlp_kernel`)
//       y = x + act(LN(x) W1 + b1) W2 + b2
// One templated body per stage with a POST flag, so the twins cannot drift.
//
// Rounding points (T is x's dtype; they decide bf16 parity and are those of
// the Pallas bodies): LayerNorm in fp32, two-pass (mean, then the mean of
// squared deviations); a pre-norm LN output is rounded to T; q/k/v are
// rounded to T after the bias; softmax in fp32 with the row max subtracted,
// its weights rounded to T before the PV product; each head's output
// rounded to T; the MLP hidden gets bias and activation in fp32 and is then
// rounded to T. Post-norm: the projection output is rounded to T, added to
// x in T, and the LN result rounded on store. Pre-norm: the projection
// output stays fp32, the residual add is in fp32, rounded once on store.
// Every product accumulates in fp32. GELU is the exact erf form (erff); the
// key mask is the additive (mask - 1) * 1e30, so a row whose keys are all
// masked gives a uniform softmax.
//
// What bounds them on the H100: operations. Per token the attention block
// does 2 (3 D^2 + D^2) + 4 N D and the MLP block 4 D FFN operations against
// a few bytes of x and y (the weights are shared by every token), so at
// batch 256 x 64 tokens x 768 / 3072 the bound is the matrix rate, not the
// memory. This first version runs the products on the fp32 CUDA cores with
// shared-memory tiles and register micro-tiles; tensor cores (wgmma) are
// later work. What the design does about the 227 KB of shared memory
// (the Pallas kernels held a batch tile's qkv and all weights in 16 MB):
//   * attention, stage 1 (`attn_heads_kernel`): one block per (sample, head)
//     computes that head's q, k, v columns from x (LN applied while x is
//     staged, pre-norm), keeps them in shared memory as fp32 [N, 65] each,
//     and runs scores / softmax / PV over 32 query rows at a time. N <= 224.
//     Its output, the concatenated heads [B, N, D] in T, is the one
//     intermediate that passes through device memory: B N D sizeof(T) bytes
//     written and read once per launch;
//   * attention, stage 2 (`attn_out_kernel`): one block per 32 rows of
//     B * N does the out-projection, bias, residual and (post-norm) LN. It
//     needs all heads of a row, hence the second kernel;
//   * MLP (`mlp_kernel`): one block per tile of 32 / 16 / 8 rows holds the
//     [rows, FFN] hidden in shared memory in T (32 x 3072 bf16 = 192 KB)
//     and streams W1 / W2 through L2; the hidden never leaves the SM.
//   * post-norm: the rounded sum x + out is stored in y (it is already a T
//     value, so nothing is lost), and after a block barrier the same block
//     normalises its own rows of y in place; those bytes stay in L2.
// Weights are input-major ([D, 3D], [D, D], [D, FFN], [FFN, D]) in T;
// biases and LN scale / bias are fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 row groups x 32 column lanes
constexpr int BK = 16;        // depth of one shared-memory tile
constexpr int DH = 64;        // head dim
constexpr int BQ = 32;        // rows per tile in the attention kernels
constexpr int BNC = 256;      // columns per chunk of the wide products
constexpr int MAX_SMEM = 232448;

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

template <int V>
__device__ __forceinline__ void ldv(float* d, const float* s);
template <>
__device__ __forceinline__ void ldv<1>(float* d, const float* s) {
  d[0] = s[0];
}
template <>
__device__ __forceinline__ void ldv<2>(float* d, const float* s) {
  const float2 t = *reinterpret_cast<const float2*>(s);
  d[0] = t.x;
  d[1] = t.y;
}
template <>
__device__ __forceinline__ void ldv<4>(float* d, const float* s) {
  const float4 t = *reinterpret_cast<const float4*>(s);
  d[0] = t.x;
  d[1] = t.y;
  d[2] = t.z;
  d[3] = t.w;
}

// Column of accumulator slot jj for a lane: VEC neighbouring columns per
// lane, repeated every 32 * VEC columns.
template <int VEC>
__device__ __forceinline__ int col_of(int lane, int jj) {
  return lane * VEC + 32 * VEC * (jj / VEC) + (jj % VEC);
}

// acc += A [BM x K] * B [K x BN] for the whole block, K a multiple of BK.
// a(m, k) and b(k, c) give the operands as fp32 (rows and columns beyond
// the matrix as 0). Thread (tr = tid / 32, lane) owns rows tr * TM + i and
// the columns col_of<VEC>(lane, jj). The next tile is fetched into
// registers while the current one is multiplied. As: [BK][BM + 4],
// Bs: [BK][BN].
template <int BM, int BN, int VEC, typename AF, typename BF>
__device__ __forceinline__ void block_gemm(float (&acc)[BM / 8][BN / 32],
                                           int K, AF a, BF b, float* As,
                                           float* Bs) {
  constexpr int TM = BM / 8, TN = BN / 32, LDA = BM + 4;
  constexpr int NA = (BM * BK + THREADS - 1) / THREADS;
  constexpr int NB = BN * BK / THREADS;
  const int tid = threadIdx.x, tr = tid >> 5, lane = tid & 31;
  float ra[NA], rb[NB];
  __syncthreads();  // operands written by other threads; As / Bs free
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int e = tid + i * THREADS;
    ra[i] = e < BM * BK ? a(e / BK, e % BK) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int e = tid + i * THREADS;
    rb[i] = b(e / BN, e % BN);
  }
  for (int k0 = 0; k0 < K; k0 += BK) {
    if (k0) __syncthreads();  // the previous tile has been read
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int e = tid + i * THREADS;
      if (e < BM * BK) As[(e % BK) * LDA + e / BK] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) Bs[tid + i * THREADS] = rb[i];
    __syncthreads();
    if (k0 + BK < K) {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int e = tid + i * THREADS;
        ra[i] = e < BM * BK ? a(e / BK, k0 + BK + e % BK) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int e = tid + i * THREADS;
        rb[i] = b(k0 + BK + e / BN, e % BN);
      }
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
      ldv<TM>(av, As + k * LDA + tr * TM);
#pragma unroll
      for (int j = 0; j < TN / VEC; ++j)
        ldv<VEC>(bv + j * VEC, Bs + k * BN + lane * VEC + 32 * VEC * j);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// Mean and 1/sqrt(var + eps) of `nrows` rows of D values, two-pass in fp32;
// one warp per row.
template <typename T>
__device__ __forceinline__ void row_stats(const T* rows, int nrows, int D,
                                          float eps, float* mean,
                                          float* rstd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nrows; r += THREADS / 32) {
    const T* p = rows + static_cast<size_t>(r) * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += to_f(p[d]);
    const float mu = warp_sum(s) / D;
    float v = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float t = to_f(p[d]) - mu;
      v = fmaf(t, t, v);
    }
    v = warp_sum(v) / D;
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = rsqrtf(v + eps);
    }
  }
}

// LayerNorm of `nrows` rows of y in place (the post-norm tail); one warp
// per row, each lane rewrites the elements it read.
template <typename T>
__device__ __forceinline__ void ln_rows_inplace(T* rows, int nrows, int D,
                                                const float* ln_s,
                                                const float* ln_b,
                                                float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nrows; r += THREADS / 32) {
    T* p = rows + static_cast<size_t>(r) * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += to_f(p[d]);
    const float mu = warp_sum(s) / D;
    float v = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float t = to_f(p[d]) - mu;
      v = fmaf(t, t, v);
    }
    const float rs = rsqrtf(warp_sum(v) / D + eps);
    for (int d = lane; d < D; d += 32)
      st(p, d, (to_f(p[d]) - mu) * rs * ln_s[d] + ln_b[d]);
  }
}

// The epilogue shared by the out-projection and the second MLP product:
// bias, residual, store. POST: out rounded to T, the add in T. Else: the
// add in fp32, rounded on store.
template <typename T, bool POST, int TM, int TN, int VEC>
__device__ __forceinline__ void residual_store(
    const float (&acc)[TM][TN], const T* __restrict__ x,
    const float* __restrict__ bias, T* y, size_t r0, int nrows, int n0,
    int D) {
  const int tr = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = tr * TM + i;
    if (r >= nrows) continue;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int c = n0 + col_of<VEC>(lane, jj);
      if (c >= D) continue;
      const size_t idx = (r0 + r) * D + c;
      float o = acc[i][jj] + bias[c];
      const float xi = to_f(x[idx]);
      if (POST) {
        o = round_to(o, x);
        st(y, idx, round_to(xi + o, x));
      } else {
        st(y, idx, xi + o);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// attention, stage 1: one block per (sample, head)
// ---------------------------------------------------------------------------

template <typename T, bool PRE>
__global__ void __launch_bounds__(THREADS)
    attn_heads_kernel(const T* __restrict__ x, const int* __restrict__ mask,
                      const float* __restrict__ ln_s,
                      const float* __restrict__ ln_b,
                      const T* __restrict__ wqkv,
                      const float* __restrict__ bqkv, T* __restrict__ att,
                      int N, int D, int heads, float eps, float scale) {
  constexpr int LDH = DH + 1;  // odd stride: conflict-free column reads
  extern __shared__ __align__(16) float sm[];
  float* As = sm;                   // [BK][BQ + 4]
  float* Bs = As + BK * (BQ + 4);   // [BK][3 * DH]
  float* Qs = Bs + BK * 3 * DH;     // [N][LDH]
  float* Ks = Qs + N * LDH;         // [N][LDH]
  float* Vs = Ks + N * LDH;         // [N][LDH]
  float* S = Vs + N * LDH;          // [BQ][N]: scores, then weights
  float* mean = S + BQ * N;         // [N]
  float* rstd = mean + N;           // [N]

  const int h = blockIdx.x % heads;
  const size_t b = blockIdx.x / heads;
  const int tid = threadIdx.x, tr = tid >> 5, lane = tid & 31;
  const T* xb = x + b * N * static_cast<size_t>(D);

  if (PRE) row_stats(xb, N, D, eps, mean, rstd);

  // q, k, v of this head: [N, 3 * DH] = LN?(x) [N, D] * Wqkv[:, head cols]
  for (int m0 = 0; m0 < N; m0 += BQ) {
    float acc[BQ / 8][3 * DH / 32] = {};
    auto a = [&](int m, int k) -> float {
      const int r = m0 + m;
      if (r >= N) return 0.f;
      float v = to_f(xb[static_cast<size_t>(r) * D + k]);
      if (PRE) v = round_to((v - mean[r]) * rstd[r] * ln_s[k] + ln_b[k], x);
      return v;
    };
    auto bw = [&](int k, int c) -> float {
      return to_f(wqkv[static_cast<size_t>(k) * 3 * D + (c / DH) * D + h * DH +
                       c % DH]);
    };
    block_gemm<BQ, 3 * DH, 2>(acc, D, a, bw, As, Bs);
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const int r = m0 + tr * (BQ / 8) + i;
      if (r >= N) continue;
#pragma unroll
      for (int jj = 0; jj < 3 * DH / 32; ++jj) {
        const int c = col_of<2>(lane, jj), part = c / DH, cc = c % DH;
        const float v =
            round_to(acc[i][jj] + bqkv[part * D + h * DH + cc], x);
        (part == 0 ? Qs : part == 1 ? Ks : Vs)[r * LDH + cc] = v;
      }
    }
  }
  __syncthreads();

  for (int q0 = 0; q0 < N; q0 += BQ) {
    // scores of 32 query rows against every key, 128 keys at a time
    for (int k0 = 0; k0 < N; k0 += 128) {
      float acc[4][4] = {};
      int qr[4], kr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qr[i] = min(q0 + tr * 4 + i, N - 1) * LDH;
#pragma unroll
      for (int j = 0; j < 4; ++j) kr[j] = min(k0 + lane + 32 * j, N - 1) * LDH;
      for (int d = 0; d < DH; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[qr[i] + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[kr[j] + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + lane + 32 * j;
        if (key >= N) continue;
        const float bias =
            mask ? (static_cast<float>(mask[b * N + key]) - 1.f) * 1e30f : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          S[(tr * 4 + i) * N + key] = acc[i][j] * scale + bias;
      }
    }
    __syncthreads();
    // fp32 softmax per row, weights rounded to T; one warp per row
    for (int r = tr; r < BQ; r += THREADS / 32) {
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
      for (int j = lane; j < N; j += 32) row[j] = round_to(row[j] / sum, x);
    }
    __syncthreads();
    // out = W V: rows tr * 4 + i, columns lane and lane + 32
    float o[4][2] = {};
    for (int c = 0; c < N; ++c) {
      float wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] = S[(tr * 4 + i) * N + c];
      const float v0 = Vs[c * LDH + lane], v1 = Vs[c * LDH + lane + 32];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[i][0] = fmaf(wv[i], v0, o[i][0]);
        o[i][1] = fmaf(wv[i], v1, o[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + tr * 4 + i;
      if (r >= N) continue;
      const size_t idx = (b * N + r) * static_cast<size_t>(D) + h * DH + lane;
      st(att, idx, o[i][0]);
      st(att, idx + 32, o[i][1]);
    }
    __syncthreads();  // S is rewritten by the next query tile
  }
}

// ---------------------------------------------------------------------------
// attention, stage 2: out-projection + residual (+ LN) per 32 rows of B * N
// ---------------------------------------------------------------------------

template <typename T, bool POST>
__global__ void __launch_bounds__(THREADS)
    attn_out_kernel(const T* __restrict__ att, const T* __restrict__ x,
                    const T* __restrict__ wout,
                    const float* __restrict__ bout,
                    const float* __restrict__ ln_s,
                    const float* __restrict__ ln_b, T* y, long long rows,
                    int D, float eps) {
  __shared__ __align__(16) float As[BK * (BQ + 4)];
  __shared__ __align__(16) float Bs[BK * BNC];
  const size_t r0 = static_cast<size_t>(blockIdx.x) * BQ;
  const int nrows = static_cast<int>(min(static_cast<long long>(BQ),
                                         rows - static_cast<long long>(r0)));
  for (int n0 = 0; n0 < D; n0 += BNC) {
    float acc[BQ / 8][BNC / 32] = {};
    auto a = [&](int m, int k) -> float {
      return m < nrows ? to_f(att[(r0 + m) * D + k]) : 0.f;
    };
    auto bw = [&](int k, int c) -> float {
      return n0 + c < D ? to_f(wout[static_cast<size_t>(k) * D + n0 + c])
                        : 0.f;
    };
    block_gemm<BQ, BNC, 4>(acc, D, a, bw, As, Bs);
    residual_store<T, POST, BQ / 8, BNC / 32, 4>(acc, x, bout, y, r0, nrows,
                                                 n0, D);
  }
  if (POST) {
    __syncthreads();
    ln_rows_inplace(y + r0 * D, nrows, D, ln_s, ln_b, eps);
  }
}

// ---------------------------------------------------------------------------
// MLP: one block per RT rows; the hidden [RT, FFN] stays in shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752440f));
}

template <typename T, bool POST, int RT>
__global__ void __launch_bounds__(THREADS)
    mlp_kernel(const T* __restrict__ x, const float* __restrict__ ln_s,
               const float* __restrict__ ln_b, const T* __restrict__ w1,
               const float* __restrict__ b1, const T* __restrict__ w2,
               const float* __restrict__ b2, T* y, long long rows, int D,
               int FFN, float eps, int relu) {
  extern __shared__ __align__(16) float sm[];
  float* As = sm;                    // [BK][RT + 4]
  float* Bs = As + BK * (RT + 4);    // [BK][BNC]
  float* mean = Bs + BK * BNC;       // [32]
  float* rstd = mean + 32;           // [32]
  T* Hs = reinterpret_cast<T*>(rstd + 32);  // [RT][FFN]

  const int tid = threadIdx.x, tr = tid >> 5, lane = tid & 31;
  const size_t r0 = static_cast<size_t>(blockIdx.x) * RT;
  const int nrows = static_cast<int>(min(static_cast<long long>(RT),
                                         rows - static_cast<long long>(r0)));
  const T* xr = x + r0 * D;
  if (!POST) row_stats(xr, nrows, D, eps, mean, rstd);

  for (int n0 = 0; n0 < FFN; n0 += BNC) {
    float acc[RT / 8][BNC / 32] = {};
    auto a = [&](int m, int k) -> float {
      if (m >= nrows) return 0.f;
      float v = to_f(xr[static_cast<size_t>(m) * D + k]);
      if (!POST) v = round_to((v - mean[m]) * rstd[m] * ln_s[k] + ln_b[k], x);
      return v;
    };
    auto bw = [&](int k, int c) -> float {
      return n0 + c < FFN ? to_f(w1[static_cast<size_t>(k) * FFN + n0 + c])
                          : 0.f;
    };
    block_gemm<RT, BNC, 4>(acc, D, a, bw, As, Bs);
#pragma unroll
    for (int i = 0; i < RT / 8; ++i) {
      const int r = tr * (RT / 8) + i;
#pragma unroll
      for (int jj = 0; jj < BNC / 32; ++jj) {
        const int c = n0 + col_of<4>(lane, jj);
        if (c >= FFN) continue;
        float v = acc[i][jj] + b1[c];
        v = relu ? fmaxf(v, 0.f) : gelu_exact(v);
        st(Hs, static_cast<size_t>(r) * FFN + c, v);
      }
    }
  }

  for (int n0 = 0; n0 < D; n0 += BNC) {
    float acc[RT / 8][BNC / 32] = {};
    auto a = [&](int m, int k) -> float {
      return to_f(Hs[static_cast<size_t>(m) * FFN + k]);
    };
    auto bw = [&](int k, int c) -> float {
      return n0 + c < D ? to_f(w2[static_cast<size_t>(k) * D + n0 + c]) : 0.f;
    };
    block_gemm<RT, BNC, 4>(acc, FFN, a, bw, As, Bs);
    residual_store<T, POST, RT / 8, BNC / 32, 4>(acc, x, b2, y, r0, nrows, n0,
                                                 D);
  }
  if (POST) {
    __syncthreads();
    ln_rows_inplace(y + r0 * D, nrows, D, ln_s, ln_b, eps);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

size_t attn_smem(int N) {
  return sizeof(float) * (BK * (BQ + 4) + BK * 3 * DH +
                          static_cast<size_t>(N) * (3 * (DH + 1) + BQ + 2));
}

size_t mlp_smem(int rt, int FFN, size_t item) {
  return sizeof(float) * (BK * (rt + 4) + BK * BNC + 64) +
         static_cast<size_t>(rt) * FFN * item;
}

template <typename T, bool POST>
cudaError_t launch_attn(const void* x, const int* mask, const float* ln_s,
                        const float* ln_b, const void* wqkv,
                        const float* bqkv, const void* wout,
                        const float* bout, void* att, void* y, int B, int N,
                        int D, int heads, float eps, cudaStream_t s) {
  const size_t smem = attn_smem(N);
  auto k1 = attn_heads_kernel<T, !POST>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  k1<<<B * heads, THREADS, smem, s>>>(
      static_cast<const T*>(x), mask, ln_s, ln_b,
      static_cast<const T*>(wqkv), bqkv, static_cast<T*>(att), N, D, heads,
      eps, 1.f / sqrtf(static_cast<float>(DH)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(B) * N;
  attn_out_kernel<T, POST>
      <<<static_cast<unsigned>((rows + BQ - 1) / BQ), THREADS, 0, s>>>(
          static_cast<const T*>(att), static_cast<const T*>(x),
          static_cast<const T*>(wout), bout, ln_s, ln_b, static_cast<T*>(y),
          rows, D, eps);
  return cudaGetLastError();
}

template <typename T, bool POST, int RT>
cudaError_t launch_mlp_rt(const void* x, const float* ln_s, const float* ln_b,
                          const void* w1, const float* b1, const void* w2,
                          const float* b2, void* y, long long rows, int D,
                          int FFN, float eps, int relu, cudaStream_t s) {
  const size_t smem = mlp_smem(RT, FFN, sizeof(T));
  auto k = mlp_kernel<T, POST, RT>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  k<<<static_cast<unsigned>((rows + RT - 1) / RT), THREADS, smem, s>>>(
      static_cast<const T*>(x), ln_s, ln_b, static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, static_cast<T*>(y), rows, D, FFN, eps,
      relu);
  return cudaGetLastError();
}

template <typename T, bool POST>
cudaError_t launch_mlp(const void* x, const float* ln_s, const float* ln_b,
                       const void* w1, const float* b1, const void* w2,
                       const float* b2, void* y, long long rows, int D,
                       int FFN, float eps, int relu, cudaStream_t s) {
#define MLP_RT(RT)                                                         \
  if (mlp_smem(RT, FFN, sizeof(T)) <= MAX_SMEM)                            \
    return launch_mlp_rt<T, POST, RT>(x, ln_s, ln_b, w1, b1, w2, b2, y,    \
                                      rows, D, FFN, eps, relu, s);
  MLP_RT(32)
  MLP_RT(16)
  MLP_RT(8)
#undef MLP_RT
  return cudaErrorInvalidValue;
}

}  // namespace

// x, att (workspace), y: [B, N, D] contiguous in `dtype` (0 = float32,
// 1 = bfloat16); wqkv [D, 3D] (q | k | v columns) and wout [D, D]
// input-major in `dtype`; bqkv, bout, ln_s, ln_b float32; mask [B, N] int32
// key validity or null. post = 1: y = LN(x + out_proj(MHA(x))); post = 0:
// y = x + out_proj(MHA(LN(x))). Head dim 64, 1 <= N <= 224. Returns
// cudaGetLastError().
extern "C" int tb_attn_block(const void* x, const void* mask,
                             const void* ln_s, const void* ln_b,
                             const void* wqkv, const void* bqkv,
                             const void* wout, const void* bout, void* att,
                             void* y, int B, int N, int D, int heads,
                             float eps, int post, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (N <= 0 || heads <= 0 || D != heads * DH || attn_smem(N) > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
#define ATTN(T, POST)                                                       \
  return static_cast<int>(launch_attn<T, POST>(                             \
      x, static_cast<const int*>(mask), static_cast<const float*>(ln_s),    \
      static_cast<const float*>(ln_b), wqkv,                                \
      static_cast<const float*>(bqkv), wout,                                \
      static_cast<const float*>(bout), att, y, B, N, D, heads, eps,         \
      static_cast<cudaStream_t>(stream)))
  if (dtype == 0 && post) ATTN(float, true);
  if (dtype == 0) ATTN(float, false);
  if (dtype == 1 && post) ATTN(__nv_bfloat16, true);
  if (dtype == 1) ATTN(__nv_bfloat16, false);
#undef ATTN
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, y: [rows, D] contiguous in `dtype`; w1 [D, FFN] and w2 [FFN, D]
// input-major in `dtype`; b1, b2, ln_s, ln_b float32. post = 1:
// y = LN(x + act(x W1 + b1) W2 + b2); post = 0: y = x + act(LN(x) W1 + b1)
// W2 + b2; act is exact GELU, or ReLU when relu != 0. D and FFN multiples of
// 16. Returns cudaGetLastError().
extern "C" int tb_mlp_block(const void* x, const void* ln_s, const void* ln_b,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, void* y, long long rows, int D,
                            int FFN, float eps, int post, int relu, int dtype,
                            void* stream) {
  if (rows <= 0) return 0;
  if (D <= 0 || FFN <= 0 || D % BK || FFN % BK)
    return static_cast<int>(cudaErrorInvalidValue);
#define MLP(T, POST)                                                        \
  return static_cast<int>(launch_mlp<T, POST>(                              \
      x, static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),  \
      w1, static_cast<const float*>(b1), w2, static_cast<const float*>(b2), \
      y, rows, D, FFN, eps, relu, static_cast<cudaStream_t>(stream)))
  if (dtype == 0 && post) MLP(float, true);
  if (dtype == 0) MLP(float, false);
  if (dtype == 1 && post) MLP(__nv_bfloat16, true);
  if (dtype == 1) MLP(__nv_bfloat16, false);
#undef MLP
  return static_cast<int>(cudaErrorInvalidValue);
}
