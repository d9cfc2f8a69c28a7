// The bf16 attention forward on Hopper's tensor cores (sm_90a), shared by
// the kernels that run it: mha_fused.cu (K2, the eval forward without lse;
// K4a, the training forward with lse) and transformer_block.cu (the core of
// the bf16 attention blocks K5a / K6a, fed by their QKV GEMM).
//
// out = softmax(Q K^T * scale + (mask - 1) * 1e30) V per head of a [B, N, D]
// q / k / v (head h the columns dh h .. dh h + dh - 1), bf16, at the
// rounding points of the JAX package's mha_reference and _head_attention:
// S in fp32, the exact two-pass softmax in fp32, the weights rounded to
// bf16 before the PV product, which sums in fp32, the output rounded to
// bf16. A row whose keys are all masked attends uniformly (every score is
// -1e30 after the bias). Two kernels:
//   * fwd_kernel, head dim 64, 1 <= N <= 256 (DistilBERT, BERT, ViT: K2,
//     K4a and the blocks' core), below;
//   * wide_kernel, head dims 80 (OPT-2.7B: K2 and K4a, causal with a key
//     mask) and 88 (EVA ViT-g: K2, N = 257), 1 <= N <= 256 / 272, at the
//     end of this file: a block per (query tile, head, sample), 64-byte
//     swizzled 32-column chunks, causal key tiles past the diagonal
//     skipped.
//
// fwd_kernel: one warpgroup (128 threads) per (head, sample), two blocks
// per SM; every tile of q / k / v comes by TMA (3-D map over [B, N, D], box
// 1 x 64 x 64, 128-byte swizzle: rows past N read as zeros, not as the next
// sample's) and is read from shared memory by wgmma. K and V of the head
// (N x 64 each, <= 32 KB) and all its query tiles are loaded once. For each
// query tile S = Q K^T is m64nNPk16 (NP = N rounded up to 16, as up to
// three n64 products and one n16..n64 tail), in registers (up to 128 fp32 a
// thread); the softmax is exact and two-pass over the registers (row max
// and row sum across the 4 threads of a row), keys >= N left out of both;
// w = e * (1 / sum) is rounded to bf16 after the division; O = W V over NP
// keys with W as the register-A operand (the accumulator of S, rounded to
// bf16 pairwise, is laid out as wgmma's A fragment); with LSE, lse = max +
// log(sum) in fp32.
// What bounds it: bytes (0.047 ms at 128 x 197 x 768 on 3.35 TB/s against
// 0.015 ms of bf16 tensor-core time for 4 B N^2 D operations); the
// softmax's exp and the masking run on the CUDA cores beside the products.
//
// The host side checks a launch plan (kernels/mha_fused.py::flash_plan's
// forward: NP, grid (heads, B, 1), dynamic shared memory; at head dims 80 /
// 88 mha_plan's / flash_plan's: NP, grid (query tiles, heads, B),
// wide_smem) against the shape and launches exactly it:
// launch_forward<MASKED, CAUSAL, LSE> / launch_wide<DH, MASKED, CAUSAL,
// LSE>, so that a file instantiates only the kernels it launches.

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


// ---------------------------------------------------------------------------
// the forward at head dims 80 (OPT-2.7B) and 88 (EVA ViT-g)
// ---------------------------------------------------------------------------
//
// The same function at the same rounding points as fwd_kernel, for heads
// whose width is not a 128-byte swizzle row. Each 64-row tile of q / k / v
// is three chunks of 32 columns (64 bytes: the 64-byte swizzle), loaded by
// TMA from a 4-D map over [B, N, H, dh]: columns past dh (80..95 or
// 88..95) and rows past N read as zeros, never as the next head's or the
// next sample's. S = Q K^T takes ceil(dh / 16) k16 steps (five at 80, six
// at 88 over the zero columns); O = W V is one m64n80k16 / m64n88k16
// product a k16 step, its B operand MN-major across the three chunks.
//
// One warpgroup per (query tile, head, sample): EVA's 16 x 16 (head,
// sample) pairs become 1,280 blocks, three to an SM, where a block a pair
// would run as two waves of one. A block holds its Q tile and one key-side
// buffer of N rows: K for the score products, then V, loaded into the same
// buffer once the products have read K, behind the softmax (an EVA block:
// 75,872 bytes, three of them within the SM's 228 KB). Its scores stay in
// registers: up to 256 keys as four 64-column slabs (128 fp32 a thread),
// and at head dim 88 a fifth slab of 16 keys (EVA's N = 257 pads to 272:
// 136 fp32); the softmax is exact and two-pass over them, as in fwd_kernel.
// Three blocks to an SM hold the kernel to 168 registers a thread, with no
// spills (two allowed 185 - 198), and hide more of each block's waits for
// its loads behind the others' products and softmax.
//
// Causal calls skip the key tiles past the query tile's diagonal: query
// tile t reads key tiles 0..t. Their weights are exactly 0 in a row that
// has an attendable key (mask > 0) at or before its diagonal. A row that
// has none spreads its weights uniformly over all N keys, as mha_reference
// does (every score is -1e30), so a tile that holds such a row (a row
// before the sample's first attendable key) computes every key tile.
// What bounds it: bytes (0.0138 ms at EVA's 16 x 257 x 1408 on 3.35 TB/s;
// 5.95 GFLOP of products, 0.006 ms of bf16 tensor-core time); the
// softmax's exp and the masking run on the CUDA cores beside the products.

constexpr int WCH = 32;               // columns of a chunk
constexpr int WCB = T * WCH * 2;      // one 64-row x 32-column chunk, 4 KB
constexpr int WTB = 3 * WCB;          // a 64-row tile of 96 columns, 12 KB
constexpr int WMAX_KB = 272;          // the key-bias entries a block holds

// the longest N of the forward at head dim dh: four 64-key slabs, and a
// fifth slab of 16 keys at 88 (EVA's N = 257)
__host__ __device__ constexpr int wide_max_n(int dh) {
  return dh == 88 ? 272 : 256;
}
// dynamic shared memory of the forward at head dims 80 / 88 (+ 1024: the
// alignment of the swizzled tiles); kept equal to the plan's in
// kernels/mha_fused.py::_tc_wide_fwd
__host__ __device__ inline int wide_smem(int nt) {
  return (nt + 1) * WTB + WMAX_KB * 4 + 4 * 8 + 1024;
}

// descriptors of a 64-row tile of 64-byte swizzled 32-column chunks:
// K-major (8-row groups 512 bytes apart, a k16 step adds 32 bytes within
// a chunk) and MN-major (chunks WCB apart along N, a k16 step adds 16 rows,
// 1024 bytes)
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 2ull << 62;
}
__device__ __forceinline__ uint64_t kmajor64(uint32_t addr) {
  return sw64_desc(addr, 16, 512);
}
__device__ __forceinline__ uint64_t mnmajor64(uint32_t addr) {
  return sw64_desc(addr, WCB, 512);
}
// the byte offset of k16 step j of a product over a head's columns in a
// tile of 32-column chunks
__device__ __forceinline__ uint32_t wide_k(int j) {
  return (j >> 1) * WCB + 32 * (j & 1);
}

// D[64, 16] += A[64, 16] . B[16, 16], both K-major in shared memory: the
// 16-key slab of head dim 88; `acc` 0 overwrites D.
__device__ __forceinline__ void ss16(float (&d)[8], uint64_t da, uint64_t db,
                                     int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64, N] += A[64, 16] . B[16, N] for N = the head dim: A the bf16 pairs
// a0..a3 in registers, B MN-major in shared memory (the PV product).
template <int N>
struct RS;

template <>
struct RS<80> {
  __device__ static __forceinline__ void mma(float (&d)[40], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
  }
};

template <>
struct RS<88> {
  __device__ static __forceinline__ void mma(float (&d)[44], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %49, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43"
      "}, {%44, %45, %46, %47}, %48, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
  }
};

// One 64-row x 96-column tile (three chunks) of map `m` at rows 64 t of
// head h of sample b into `dst`; completion on `bar`.
__device__ __forceinline__ void load_wide(uint32_t dst, const CUtensorMap* m,
                                          uint64_t* bar, int h, int t,
                                          int b) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst + j * WCB), "l"(reinterpret_cast<uint64_t>(m)),
           "r"(tc::smem_u32(bar)), "r"(j * WCH), "r"(h), "r"(t * T), "r"(b)
        : "memory");
}

// scale, key bias, causal and pad keys of the slab of keys c T .. for the
// rows r0, r0 + 8 of query tile t; the row max into mx
template <bool MASKED, bool CAUSAL, int R>
__device__ __forceinline__ void bias_slab(float (&x)[R], int c, int t, int r0,
                                          int c0, int N, float scale,
                                          const float* kb, float (&mx)[2]) {
  const bool tail = c * T + T > N;  // the slab that holds pad keys
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int hh = (i >> 1) & 1;
    const int key = c * T + 8 * (i >> 2) + c0 + (i & 1);
    float v = x[i] * scale;
    if (MASKED) v += kb[key];
    if (CAUSAL && key > t * T + r0 + 8 * hh) v = NEG;
    if (tail && key >= N) v = -INFINITY;  // out of the max and the sum
    x[i] = v;
    mx[hh] = fmaxf(mx[hh], v);
  }
}

template <int R>
__device__ __forceinline__ void exp_slab(float (&x)[R], const float (&mx)[2],
                                         float (&sum)[2]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int hh = (i >> 1) & 1;
    x[i] = expf(x[i] - mx[hh]);
    sum[hh] += x[i];
  }
}

template <int DH, bool MASKED, bool CAUSAL, bool LSE>
__global__ void __launch_bounds__(THREADS, 3)
    wide_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const int* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int N, int D, int NP, float scale) {
  constexpr int KS = (DH + 15) / 16;  // k16 steps of S = Q K^T
  constexpr bool SLAB16 = DH == 88;   // the fifth slab, keys 256 .. 271
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1k(smem_raw);
  const int nt = tiles(N);
  // one key-side buffer (K, then V) and the query tile
  const uint32_t kvs = tc::smem_u32(smem), qs = kvs + nt * WTB;
  float* kb = reinterpret_cast<float*>(smem + (nt + 1) * WTB);  // [WMAX_KB]
  uint64_t* bar = reinterpret_cast<uint64_t*>(kb + WMAX_KB);  // Q+K, K, V
  int* first = reinterpret_cast<int*>(bar + 3);  // first attendable key
  const int t = blockIdx.x, h = blockIdx.y, H = gridDim.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nk0 = CAUSAL ? t + 1 : nt;  // key tiles up to the diagonal
  if (tid == 0) {
    init_bars(bar, 3);
    *first = MASKED ? N : 0;
    tc::mbar_expect_tx(bar, (nk0 + 1) * WTB);
    load_wide(qs, &tq, bar, h, t, b);
    for (int c = 0; c < nk0; ++c) load_wide(kvs + c * WTB, &tk, bar, h, c, b);
  }
  __syncthreads();
  if (MASKED)
    for (int j = tid; j < N; j += THREADS) {
      const int m = mask[static_cast<size_t>(b) * N + j];
      kb[j] = (static_cast<float>(m) - 1.f) * 1e30f;
      if (CAUSAL && m > 0) atomicMin(first, j);
    }
  __syncthreads();
  // a tile with a row before the first attendable key reads every key tile
  const int nk = CAUSAL && t * T < *first ? nt : nk0;
  if (CAUSAL && tid == 0 && nk > nk0) {
    tc::mbar_expect_tx(bar + 1, (nk - nk0) * WTB);
    for (int c = nk0; c < nk; ++c)
      load_wide(kvs + c * WTB, &tk, bar + 1, h, c, b);
  }

  const int lane = tid & 31, r0 = 16 * (tid >> 5) + (lane >> 2),
            c0 = 2 * (lane & 3);
  tc::mbar_wait(bar, 0);
  if (CAUSAL && nk > nk0) tc::mbar_wait(bar + 1, 0);
  // S = Q K^T over the key tiles read, in 64-column slabs (+ the 16-key
  // slab at head dim 88)
  float s[4][32], s4[8];
  tc::wgmma_fence();
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c >= nk) continue;
#pragma unroll
    for (int j = 0; j < KS; ++j)
      ss(s[c], kmajor64(qs + wide_k(j)), kmajor64(kvs + c * WTB + wide_k(j)),
         NP - c * T, j);
  }
  if (SLAB16 && nk > 4) {
#pragma unroll
    for (int j = 0; j < KS; ++j)
      ss16(s4, kmajor64(qs + wide_k(j)), kmajor64(kvs + 4 * WTB + wide_k(j)),
           j);
  }
  tc::wgmma_commit();
  tc::wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < 4; ++c) tc::fence_acc(s[c]);
  if constexpr (SLAB16) tc::fence_acc(s4);

  // every warp's products have read K: V takes its place behind the softmax
  __syncthreads();
  if (tid == 0) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    tc::mbar_expect_tx(bar + 2, nk * WTB);
    for (int c = 0; c < nk; ++c)
      load_wide(kvs + c * WTB, &tv, bar + 2, h, c, b);
  }

  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < nk && c * T < NP)
      bias_slab<MASKED, CAUSAL>(s[c], c, t, r0, c0, N, scale, kb, mx);
  if (SLAB16 && nk > 4)
    bias_slab<MASKED, CAUSAL>(s4, 4, t, r0, c0, N, scale, kb, mx);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < nk && c * T < NP) exp_slab(s[c], mx, sum);
  if (SLAB16 && nk > 4) exp_slab(s4, mx, sum);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
  }
  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
  // the weights, normalised in fp32, then rounded to bf16 as A fragments
  uint32_t p[4][16], p4[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c >= nk || c * T >= NP) continue;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[c][i] *= inv[(i >> 1) & 1];
    frag(p[c], s[c]);
  }
  if (SLAB16 && nk > 4) {
#pragma unroll
    for (int i = 0; i < 8; ++i) s4[i] *= inv[(i >> 1) & 1];
#pragma unroll
    for (int j = 0; j < 4; ++j) p4[j] = pack(s4[2 * j], s4[2 * j + 1]);
  }

  // O = W V over the keys read
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  tc::mbar_wait(bar + 2, 0);
  tc::wgmma_fence();
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c >= nk) continue;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (c * T + 16 * kk < NP)
        RS<DH>::mma(acc, p[c][4 * kk], p[c][4 * kk + 1], p[c][4 * kk + 2],
                    p[c][4 * kk + 3], mnmajor64(kvs + c * WTB + 1024 * kk));
  }
  if (SLAB16 && nk > 4)
    RS<DH>::mma(acc, p4[0], p4[1], p4[2], p4[3], mnmajor64(kvs + 4 * WTB));
  tc::wgmma_commit();
  tc::wgmma_wait<0>();
  tc::fence_acc(acc);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = t * T + r0 + 8 * hh;
    if (qi >= N) continue;  // a pad query row: not stored
    __nv_bfloat16* orow = o + (static_cast<size_t>(b) * N + qi) * D + h * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh],
                                acc[4 * j + 2 * hh + 1]);
    if (LSE && (lane & 3) == 0)
      lse[(static_cast<size_t>(b) * H + h) * N + qi] =
          mx[hh] + logf(sum[hh]);
  }
}

// A bf16 [B, N, H * dh] tensor as the 4-D [B, N, H, dh] (dh contiguous; dh
// 2 bytes a multiple of 16), read in boxes of 32 columns x 1 head x 64 rows
// with the 64-byte swizzle: columns past dh and rows past N read as zeros.
inline cudaError_t make_map_heads(CUtensorMap* map, const void* p,
                                  uint64_t B, uint64_t N, uint64_t H,
                                  uint64_t dh) {
  const tc::EncodeTiled enc = tc::encode_tiled();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {dh, H, N, B};
  const cuuint64_t strides[3] = {dh * 2, H * dh * 2, N * H * dh * 2};
  const cuuint32_t box[4] = {WCH, 1, T, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(p), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The plan check of the forward at head dim DH (80 or 88).
template <int DH>
bool wide_plan_ok(int B, int N, int D, int heads, int np) {
  return B > 0 && heads > 0 && D == heads * DH && N >= 1 &&
         N <= wide_max_n(DH) && np == pad16(N);
}

// The forward of one plan at head dim DH (80 or 88) on `stream`:
// wide_kernel<DH, MASKED, CAUSAL, LSE> on grid (tiles(N), heads, B) with
// `smem` bytes, refused (cudaErrorInvalidValue) if the plan is not this
// shape's or a pointer is not 16-byte aligned.
template <int DH, bool MASKED, bool CAUSAL, bool LSE>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        const int* mask, void* o, float* lse, int B, int N,
                        int D, int heads, float scale, int np, dim3 grid,
                        int smem, cudaStream_t stream) {
  if (!wide_plan_ok<DH>(B, N, D, heads, np) ||
      grid.x != unsigned(tiles(N)) || grid.y != unsigned(heads) ||
      grid.z != unsigned(B) || smem != wide_smem(tiles(N)) ||
      !aligned16({q, k, v, o}) || (mask != nullptr) != MASKED ||
      (lse != nullptr) != LSE)
    return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map_heads(&mq, q, B, N, heads, DH);
  if (err == cudaSuccess) err = make_map_heads(&mk, k, B, N, heads, DH);
  if (err == cudaSuccess) err = make_map_heads(&mv, v, B, N, heads, DH);
  auto kern = wide_kernel<DH, MASKED, CAUSAL, LSE>;
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
