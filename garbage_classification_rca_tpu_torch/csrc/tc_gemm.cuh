// A bf16 GEMM core on Hopper's tensor cores (sm_90a), for the port's
// kernels to build on: C[M, N] = A[M, K] . B[K, N] with fp32 accumulators,
// each output element handed to an epilogue in registers.
//
// Layouts: A row-major [M, K] (K-major for wgmma); B row-major [K, N], the
// JAX package's input-major weight layout as it is: N is contiguous, so B
// enters wgmma MN-major (its transpose bit set) and no repacked copy of a
// weight is needed. Both bf16, 16-byte aligned, rows a multiple of 8
// elements (TMA's 16-byte stride rule). M, N and K are otherwise free:
// TMA fills the parts of a tile that lie beyond the matrix with zeros, and
// the epilogue is not called for rows >= M or columns >= N (N even).
//
// Design (a persistent grid: each block walks output tiles of BM x BN):
//   * tile 128 x BN, BN = 192 or 256 (the caller picks per GEMM by wave
//     count), depth BK = 64 per stage: one 128-byte swizzle row of bf16;
//   * the caller's grid, one block per SM at most; block b takes tiles b,
//     b + grid, ... and the shared-memory ring runs on from one tile to the
//     next, so the next tile's loads overlap this tile's epilogue;
//   * a ring of STAGES shared-memory stages (4 of 48 KB at BN = 256, 5 of
//     40 KB at 192), each filled by TMA (cp.async.bulk.tensor, 128-byte
//     swizzle): A as one 128 x 64 box, B as BN / 64 boxes of 64 x 64;
//   * mbarriers: full[s] (the producer's expect_tx, completed by TMA's byte
//     count) and empty[s] (one arrival per consumer warp once the wgmma
//     that read stage s has retired);
//   * 384 threads: warpgroup 0 is the producer (one thread issues the
//     loads; setmaxnreg drops the group to 40 registers), warpgroups 1 and
//     2 are the consumers (setmaxnreg raises them to 232), each owning 64
//     rows of the tile: 4 x wgmma.m64nBNk16 per stage, one commit group
//     kept in flight so the tensor cores never wait for a stage release;
//   * the epilogue runs in the consumers' registers: epi(row, col, v0, v1)
//     for the two neighbouring columns a thread holds.
// wgmma descriptors (128-byte swizzle, 1024-byte aligned stage bases): A,
// K-major: SBO 1024 B between 8-row groups, a k16 step adds 32 B to the
// start address; B, MN-major: LBO 8192 B between 64-column boxes, SBO
// 1024 B between 8-row (k) groups, a k16 step adds 16 rows = 2048 B.
//
// The TMA descriptors are encoded on the host per launch (they hold the
// operands' addresses) and passed as __grid_constant__ kernel parameters,
// so a launch can be captured in a CUDA graph. cuTensorMapEncodeTiled is a
// driver-API function: it is fetched through cudaGetDriverEntryPoint, so
// the library links against the CUDA runtime alone (no -lcuda).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int BM = 128;          // rows per block: two consumers of 64
constexpr int BK = 64;           // depth of a stage: 64 bf16 = 128 bytes
constexpr int THREADS = 384;     // producer + two consumer warpgroups
constexpr int STAGE_BUDGET = 200 * 1024;
constexpr int A_BYTES = BM * BK * 2;
constexpr int BOX_BYTES = BK * 64 * 2;   // one 64 x 64 box of B

template <int BN>
struct Cfg {
  static_assert(BN % 64 == 0 && BN <= 256, "BN: 64-column boxes, <= 256");
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGES = STAGE_BUDGET / (A_BYTES + B_BYTES);
  static constexpr int SMEM = STAGES * (A_BYTES + B_BYTES) +
                              2 * STAGES * 8 + 1024;  // + barriers, align
};

// ---------------------------------------------------------------------------
// device primitives
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Returns once the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// One 2-D box of `map` at (c0 = column, c1 = row) into shared memory;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// One 3-D box of `map` at (c0, c1, c2), innermost first.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma that owns them.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

// D[64, BN] += A[64, 16] . B[16, BN]: A K-major, B MN-major (imm-trans-b
// 1), fp32 accumulators. Thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 + {0, 8} and columns 8 j + 2 (t % 4) + {0, 1}:
// d[4 j + 2 h + e] is (row + 8 h, column + e).
template <int BN>
struct Wgmma;

template <>
struct Wgmma<192> {
  __device__ static __forceinline__ void mma(float (&d)[96], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"
        ", %96, %97, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ static __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}"
        ", %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
};

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <int BN, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb, int M, int N, int K,
                const Epi epi) {
  using C = Cfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  // stage bases 1024-byte aligned: the swizzle pattern repeats every 1 KB
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t a_smem = smem_u32(smem);
  const uint32_t b_smem = a_smem + C::STAGES * A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + C::STAGES * (A_BYTES + C::B_BYTES));
  uint64_t* empty = full + C::STAGES;

  const int wg = threadIdx.x / 128;
  const int nk = (K + BK - 1) / BK;
  // tile t covers rows (t / tn) BM.. and columns (t % tn) BN..: the column
  // tiles of one row tile are neighbours, so they share A in L2
  const int tn = (N + BN - 1) / BN;
  const int tiles = tn * ((M + BM - 1) / BM);
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // the eight consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The ring's stage s and phase ph run on across a block's tiles in both
  // roles, so the producer loads the next tile while the consumers are in
  // the epilogue of this one.
  if (wg == 0) {
    // producer: one thread keeps the ring full
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      int s = 0, ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tn) * BM, n0 = (t % tn) * BN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(empty + s, ph ^ 1);
          mbar_expect_tx(full + s, A_BYTES + C::B_BYTES);
          tma_load(a_smem + s * A_BYTES, &ta, full + s, kb * BK, m0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(b_smem + s * C::B_BYTES + j * BOX_BYTES, &tb, full + s,
                     n0 + 64 * j, kb * BK);
          if (++s == C::STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: rows 64 (wg - 1) .. 64 (wg - 1) + 63 of each tile
    reg_alloc<232>();
    float acc[BN / 2];
    const uint32_t a_rows = a_smem + (wg - 1) * 64 * 128;
    const bool signals = (threadIdx.x & 31) == 0;
    const int t_in = threadIdx.x - 128 * wg;
    int s = 0, ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tn) * BM, n0 = (t % tn) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(full + s, ph);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          Wgmma<BN>::mma(
              acc, sw128_desc(a_rows + s * A_BYTES + 32 * kk, 16, 1024),
              sw128_desc(b_smem + s * C::B_BYTES + 2048 * kk, BOX_BYTES,
                         1024));
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products have retired
        fence_acc(acc);
        if (kb > 0 && signals) mbar_arrive(empty + prev);
        prev = s;
        if (++s == C::STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (signals) mbar_arrive(empty + prev);  // the tile's last stage

      const int row0 =
          m0 + 64 * (wg - 1) + 16 * (t_in >> 5) + ((t_in & 31) >> 2);
      const int col0 = n0 + 2 * (t_in & 3);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = col0 + 8 * j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * h;
          if (r < M && c < N)
            epi(r, c, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 row-major [rows, cols] matrix read in boxes of box_rows x 64.
inline cudaError_t make_map(CUtensorMap* map, const void* p, uint64_t rows,
                            uint64_t cols, uint32_t box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(p), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A bf16 [d2, d1, d0] tensor (d0 contiguous, rows 16-byte aligned) read in
// boxes of 1 x box_rows x 64: rows past d1 read as zeros, never as the next
// slice's.
inline cudaError_t make_map_3d(CUtensorMap* map, const void* p, uint64_t d2,
                               uint64_t d1, uint64_t d0, uint32_t box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d1 * d0 * 2};
  const cuuint32_t box[3] = {64, box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(p), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// C = A . B through `epi` on `stream`, on `grid` blocks that walk the
// ceil(M / BM) ceil(N / BN) tiles with a stride of `grid` (the caller's
// launch plan: one block per SM, fewer when there are fewer tiles).
template <int BN, class Epi>
cudaError_t gemm(const void* a, const void* b, int M, int N, int K,
                 const Epi& epi, int grid, cudaStream_t stream) {
  if (M <= 0) return cudaSuccess;
  if (N <= 0 || K <= 0 || N % 8 || K % 8 || grid <= 0 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  cudaError_t err = make_map(&ta, a, M, K, BM);
  if (err == cudaSuccess) err = make_map(&tb, b, K, N, BK);
  if (err != cudaSuccess) return err;
  auto k = gemm_kernel<BN, Epi>;
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cfg<BN>::SMEM);
  if (err != cudaSuccess) return err;
  k<<<grid, THREADS, Cfg<BN>::SMEM, stream>>>(ta, tb, M, N, K, epi);
  return cudaGetLastError();
}

}  // namespace tc
