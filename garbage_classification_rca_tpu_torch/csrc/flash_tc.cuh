// The bf16 attention forward on Hopper's tensor cores (sm_90a), shared by
// the kernels that run it: mha_fused.cu (K2, the eval forward without lse;
// K4a, the training forward with lse) and transformer_block.cu (the core of
// the bf16 attention blocks K5a / K6a, fed by their QKV GEMM).
//
// out = softmax(Q K^T * scale + (mask - 1) * 1e30) V per head of a [B, N, D]
// q / k / v (head h the columns 64 h .. 64 h + 63), bf16, head dim 64,
// 1 <= N <= 256, at the rounding points of the JAX package's mha_reference
// and _head_attention: S in fp32, the exact two-pass softmax in fp32, the
// weights rounded to bf16 before the PV product, which sums in fp32, the
// output rounded to bf16. A row whose keys are all masked attends
// uniformly (every score is -1e30 after the bias).
//
// One warpgroup (128 threads) per (head, sample), two blocks per SM; every
// tile of q / k / v comes by TMA (3-D map over [B, N, D], box 1 x 64 x 64,
// 128-byte swizzle: rows past N read as zeros, not as the next sample's)
// and is read from shared memory by wgmma. K and V of the head (N x 64
// each, <= 32 KB) and all its query tiles are loaded once. For each query
// tile S = Q K^T is m64nNPk16 (NP = N rounded up to 16, as up to three n64
// products and one n16..n64 tail), in registers (up to 128 fp32 a thread);
// the softmax is exact and two-pass over the registers (row max and row
// sum across the 4 threads of a row), keys >= N left out of both; w = e *
// (1 / sum) is rounded to bf16 after the division; O = W V over NP keys
// with W as the register-A operand (the accumulator of S, rounded to bf16
// pairwise, is laid out as wgmma's A fragment); with LSE, lse = max +
// log(sum) in fp32.
// What bounds it: bytes (0.047 ms at 128 x 197 x 768 on 3.35 TB/s against
// 0.015 ms of bf16 tensor-core time for 4 B N^2 D operations); the
// softmax's exp and the masking run on the CUDA cores beside the products.
//
// The host side checks a launch plan (kernels/mha_fused.py::flash_plan's
// forward: NP, grid (heads, B, 1), dynamic shared memory) against the
// shape and launches exactly it: launch_forward<MASKED, CAUSAL, LSE>, so
// that a file instantiates only the kernels it launches.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "tc_gemm.cuh"  // mbarrier, TMA and wgmma-descriptor primitives

namespace {
namespace ftc {

constexpr int DH = 64;            // head dim
constexpr int T = 64;             // rows of a query / key tile
constexpr int MAX_N = 256;        // four tiles: a query tile's S in registers
constexpr int BOX = T * DH * 2;   // one 64 x 64 bf16 tile, 8 KB
constexpr int THREADS = 128;      // one warpgroup
constexpr float NEG = -1e30f;     // a causally masked score

__host__ __device__ inline int tiles(int n) { return (n + T - 1) / T; }
__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }
// dynamic shared memory of the forward (+ 1024: the 1 KB alignment that
// the 128-byte swizzle needs); kept equal to the plan's in
// kernels/mha_fused.py::flash_plan
__host__ __device__ inline int fwd_smem(int nt) {
  return 3 * nt * BOX + MAX_N * 4 + 2 * 8 + 1024;
}

// D[64, N] += A[64, 16] . B[16, N], A and B K-major in shared memory, for
// N = 16, 32, 48, 64 (d[0 .. N / 2)); `acc` 0 overwrites D.
template <int N>
struct SS;

template <>
struct SS<16> {
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct SS<32> {
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct SS<48> {
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct SS<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
};

// D[64, 64] += A[64, 16] . B[16, 64]: A the bf16 pairs a0..a3 in registers,
// B MN-major in shared memory.
__device__ __forceinline__ void rs64(float (&d)[32], uint32_t a0,
                                     uint32_t a1, uint32_t a2, uint32_t a3,
                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// One k16 step of a product whose N is w (16, 32, 48 or >= 64: 64).
__device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db,
                                   int w, int acc) {
  if (w >= 64)
    SS<64>::mma(d, da, db, acc);
  else if (w == 48)
    SS<48>::mma(d, da, db, acc);
  else if (w == 32)
    SS<32>::mma(d, da, db, acc);
  else
    SS<16>::mma(d, da, db, acc);
}

// descriptors of a 64-row, 128-byte-swizzled tile: K-major (a k16 step adds
// 32 bytes) and MN-major (a k16 step adds 16 rows, 2048 bytes)
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
  return tc::sw128_desc(addr, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr) {
  return tc::sw128_desc(addr, 8192, 1024);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator x of a 64 x 64 product (thread t: rows r, r + 8 with
// r = 16 (t / 32) + (t % 32) / 4; x[4 j + 2 h + e] at row r + 8 h, column
// 8 j + 2 (t % 4) + e) rounded to bf16 as the A fragments of the four k16
// steps over its columns: a[4 kk ..] = (r, 16 kk + 2 (t % 4) + {0, 1}),
// (r + 8, same), (r, + 8), (r + 8, + 8).
__device__ __forceinline__ void frag(uint32_t (&a)[16], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[4 * kk + 0] = pack(x[8 * kk + 0], x[8 * kk + 1]);
    a[4 * kk + 1] = pack(x[8 * kk + 2], x[8 * kk + 3]);
    a[4 * kk + 2] = pack(x[8 * kk + 4], x[8 * kk + 5]);
    a[4 * kk + 3] = pack(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

__device__ __forceinline__ uint8_t* align1k(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void init_bars(uint64_t* bar, int n) {
  for (int i = 0; i < n; ++i) tc::mbar_init(bar + i, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the reference's key bias, (mask - 1) 1e30
__device__ __forceinline__ float key_bias_of(const int* mask, size_t b,
                                             int N, int key) {
  return mask ? (static_cast<float>(mask[b * N + key]) - 1.f) * 1e30f : 0.f;
}

// MASKED / CAUSAL: the call has a key mask / is causal. The elementwise
// work per score is what bounds these kernels beside the loads, so a call
// without them runs none of their instructions, and only the slab holding
// the last keys checks for pad keys. LSE: the training forward (K4a), which
// stores lse; without it the eval forward (K2). Both normalise by w = e *
// (1 / sum): an exact division (e / sum, as the reference) cost the eval
// forward 29% at 128 x 197 x 768 and moved no output past the bf16 bar
// that the reciprocal does not (PERF.md §6); S summed in another order
// than the reference's is what rounds the odd weight the other way.
template <bool MASKED, bool CAUSAL, bool LSE>
__global__ void __launch_bounds__(THREADS, 2)
    fwd_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const int* __restrict__ mask, __nv_bfloat16* __restrict__ o,
               float* __restrict__ lse, int N, int D, int NP, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1k(smem_raw);
  const int nt = tiles(N);
  const uint32_t ks = tc::smem_u32(smem), vs = ks + nt * BOX,
                 qs = vs + nt * BOX;
  float* kb = reinterpret_cast<float*>(smem + 3 * nt * BOX);   // [MAX_N]
  uint64_t* bar = reinterpret_cast<uint64_t*>(kb + MAX_N);     // K + Q, V
  const int h = blockIdx.x, H = gridDim.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  if (tid == 0) init_bars(bar, 2);
  __syncthreads();
  if (tid == 0) {
    tc::mbar_expect_tx(bar, 2 * nt * BOX);
    for (int t = 0; t < nt; ++t) {
      tc::tma_load_3d(ks + t * BOX, &tk, bar, h * DH, t * T, b);
      tc::tma_load_3d(qs + t * BOX, &tq, bar, h * DH, t * T, b);
    }
    tc::mbar_expect_tx(bar + 1, nt * BOX);
    for (int t = 0; t < nt; ++t)
      tc::tma_load_3d(vs + t * BOX, &tv, bar + 1, h * DH, t * T, b);
  }
  if (MASKED)
    for (int j = tid; j < N; j += THREADS) kb[j] = key_bias_of(mask, b, N, j);
  __syncthreads();

  const int lane = tid & 31, r0 = 16 * (tid >> 5) + (lane >> 2),
            c0 = 2 * (lane & 3);
  tc::mbar_wait(bar, 0);
  for (int t = 0; t < nt; ++t) {
    // S = Q K^T over NP keys, in four 64-column slabs
    float s[4][32];
    tc::wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c * T >= NP) continue;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ss(s[c], kmajor(qs + t * BOX + 32 * kk),
           kmajor(ks + c * BOX + 32 * kk), NP - c * T, kk);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < 4; ++c) tc::fence_acc(s[c]);

    // scale, key bias, causal; the row max over the N real keys
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c * T >= NP) continue;
      const bool tail = c * T + T > N;  // the slab that holds pad keys
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        const int key = c * T + 8 * (i >> 2) + c0 + (i & 1);
        float x = s[c][i] * scale;
        if (MASKED) x += kb[key];
        if (CAUSAL && key > t * T + r0 + 8 * hh) x = NEG;
        if (tail && key >= N) x = -INFINITY;  // out of the max and the sum
        s[c][i] = x;
        mx[hh] = fmaxf(mx[hh], x);
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c * T >= NP) continue;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        s[c][i] = expf(s[c][i] - mx[hh]);
        sum[hh] += s[c][i];
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
    }
    const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
    // the weights, normalised in fp32, then rounded to bf16 as A fragments
    uint32_t p[4][16];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c * T >= NP) continue;
#pragma unroll
      for (int i = 0; i < 32; ++i) s[c][i] *= inv[(i >> 1) & 1];
      frag(p[c], s[c]);
    }

    // O = W V over NP keys
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    tc::mbar_wait(bar + 1, 0);
    tc::wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (c * T + 16 * kk < NP)
          rs64(acc, p[c][4 * kk], p[c][4 * kk + 1], p[c][4 * kk + 2],
               p[c][4 * kk + 3], mnmajor(vs + c * BOX + 2048 * kk));
      }
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_acc(acc);

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qi = t * T + r0 + 8 * hh;
      if (qi >= N) continue;  // a pad query row: not stored
      __nv_bfloat16* orow = o + (static_cast<size_t>(b) * N + qi) * D + h * DH;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c0) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh],
                                  acc[4 * j + 2 * hh + 1]);
      if (LSE && (lane & 3) == 0)
        lse[(static_cast<size_t>(b) * H + h) * N + qi] =
            mx[hh] + logf(sum[hh]);
    }
  }
}

bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// The plan of kernels/mha_fused.py::flash_plan, checked against what these
// kernels take: the entries launch exactly the grid and shared memory they
// are given, and refuse any other.
bool plan_ok(int B, int N, int D, int heads, int np) {
  return B > 0 && heads > 0 && D == heads * DH && N >= 1 && N <= MAX_N &&
         np == pad16(N);
}

// The forward of one plan on `stream`: fwd_kernel<MASKED, CAUSAL, LSE>
// (lse null without LSE) on grid (heads, B, 1) with `smem` bytes, refused
// (cudaErrorInvalidValue) if the plan is not this shape's or a pointer is
// not 16-byte aligned. Three TMA descriptors are encoded per call.
template <bool MASKED, bool CAUSAL, bool LSE>
cudaError_t launch_forward(const void* q, const void* k, const void* v,
                           const int* mask, void* o, float* lse, int B, int N,
                           int D, int heads, float scale, int np, dim3 grid,
                           int smem, cudaStream_t stream) {
  if (!plan_ok(B, N, D, heads, np) || grid.x != unsigned(heads) ||
      grid.y != unsigned(B) || grid.z != 1 || smem != fwd_smem(tiles(N)) ||
      !aligned16({q, k, v, o}) || (mask != nullptr) != MASKED ||
      (lse != nullptr) != LSE)
    return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  cudaError_t err = tc::make_map_3d(&mq, q, B, N, D, T);
  if (err == cudaSuccess) err = tc::make_map_3d(&mk, k, B, N, D, T);
  if (err == cudaSuccess) err = tc::make_map_3d(&mv, v, B, N, D, T);
  auto kern = fwd_kernel<MASKED, CAUSAL, LSE>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, mask, static_cast<__nv_bfloat16*>(o), lse, N, D, np,
      scale);
  return cudaGetLastError();
}

}  // namespace ftc
}  // namespace
