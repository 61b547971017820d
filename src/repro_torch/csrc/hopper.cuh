// Hopper building blocks of the port's kernels: mbarriers, TMA tile loads
// through a tensor map, wgmma shared-memory descriptors and the wgmma
// instructions themselves (bf16 inputs, fp32 accumulators); cp.async
// copies, ldmatrix and mma.sync; the special-function unit's 2^x.
//
// Layout conventions.  A tile of `rows` rows of a (B, S, heads, D) bf16
// tensor lands in shared memory as D / kInner chunks of rows x kInner
// elements, kInner = min(D, 64), each row of a chunk 2 * kInner bytes long
// and swizzled by TMA in that span (128B swizzle at D >= 64, 64B at D = 32);
// the wgmma descriptors below name the same swizzle, so the two agree by
// construction.  Accumulator fragments of m64nNk16 follow PTX's layout:
// in warp w of the warpgroup, lane t holds, for i in [0, N/2), the element
// of row 16 w + t / 4 + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 (t % 4) +
// i % 2.  Four consecutive pairs of a 16-column slice are exactly the A
// fragment of a register-sourced wgmma, so P and dS go from the
// accumulators of one product into the next one without shared memory.
#pragma once

// cuda.h: CUtensorMap and libcuda's enums; libcuda is opened at run time
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace repro_torch {
namespace hopper {

// A wait that lasts this long has lost an arrival: it traps, so the launch
// fails with an error instead of hanging the card.
constexpr uint64_t kWaitLimitNs = 2000000000ull;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte aligned address at or after p (the 128B swizzle
// repeats every 1024 bytes of the shared address).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint64_t start = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 1023u) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (start == 0) {
        start = now;
      } else if (now - start > kWaitLimitNs) {
        __trap();
      }
    }
  }
}

// TMA: box (c0 = element along D, c1 = row, c2 = head, c3 = batch) of the
// tensor map into shared memory; completion counted in bytes on `bar`.
// Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), and the swizzle (1 = 128B, 2 = 64B).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) | (layout << 62);
}

// A tile of kRows rows x D bf16 as TMA leaves it (see the top of the file).
template <int D, int kRows>
struct Tile {
  static constexpr int kInner = D < 64 ? D : 64;
  static constexpr int kRowBytes = 2 * kInner;
  static constexpr int kChunks = D / kInner;
  static constexpr int kChunkBytes = kRows * kRowBytes;
  static constexpr int kBytes = kChunks * kChunkBytes;
  static constexpr int kSbo = 8 * kRowBytes;  // next 8-row group
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;

  // The tile as a K-major operand (D is the reduction axis): rows
  // [row0, row0 + 64) (A) or all rows (B), reduction slice [16 k, 16 k + 16).
  __device__ static uint64_t kmajor(const uint8_t* base, int row0, int k) {
    constexpr int kPerChunk = kInner / 16;
    return make_desc(base + (k / kPerChunk) * kChunkBytes + row0 * kRowBytes +
                         (k % kPerChunk) * 32,
                     16, kSbo, kLayout);
  }
  // The tile as an MN-major B operand (rows are the reduction axis, D the
  // output columns): rows [16 k, 16 k + 16), every column.
  __device__ static uint64_t mnmajor(const uint8_t* base, int k) {
    return make_desc(base + k * 16 * kRowBytes, kChunkBytes, kSbo, kLayout);
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from touching registers that an issued wgmma still
// reads or writes: reads of an accumulator stay after the wait, and the
// registers of an A fragment are not reused before it.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void hold(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of an m64 x 16 k-slice from accumulator fragments
// (N = 2 * M columns of fp32 pairs), rounded to bf16.
template <int M>
__device__ __forceinline__ void to_a_frags(const float (&acc)[M * 8],
                                           uint32_t (&a)[M][4]) {
#pragma unroll
  for (int k = 0; k < M; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[k][r] = pack_bf16(acc[8 * k + 2 * r], acc[8 * k + 2 * r + 1]);
}

// D (m64 x N, fp32) += A (m64 x 16, shared, K-major) * B (16 x N, shared,
// K-major); scale_d = 0 overwrites D.  Defined for the N the kernels use.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// D (m64 x N, fp32) += A (m64 x 16, registers) * B (16 x N, shared,
// MN-major).
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2],
                                            const uint32_t (&a)[4], uint64_t db,
                                            int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs_tb<32>(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<128>(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


// ---------------------------------------------------------------------------
// Asynchronous copies and warp-level tensor-core products (sm_80 and later)
// ---------------------------------------------------------------------------

// Copies 16 bytes from global to shared memory without the registers; with
// `full` false it reads nothing and writes 16 zero bytes (`src` must still
// be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// Closes the copies issued since the last commit into one group.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kPending of this thread's groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8 x 8 matrices of 16-bit elements from shared memory: lane l gives
// the address of row l % 8 of matrix l / 8 (16 contiguous bytes) and gets
// r[i] = elements (l / 4, 2 (l % 4) + {0, 1}) of matrix i; `trans` gives
// each matrix transposed, r[i] = elements (2 (l % 4) + {0, 1}, l / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row-major fragments) * b (16 x 8,
// bf16, column fragments).  Fragments of lane l: a0 (row l/4, cols 2(l%4)
// + {0,1}), a1 (row + 8), a2 (cols + 8), a3 (both); b0 (rows 2(l%4) + {0,1},
// col l/4), b1 (rows + 8); d0, d1 (row l/4, cols 2(l%4) + {0,1}), d2, d3
// (row + 8).
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit: one MUFU.EX2, relative error about
// 2^-22, subnormal results flushed to zero.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Host side: cuTensorMapEncodeTiled from libcuda, which the
// process has loaded already (the kernels link only the runtime).
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                   void*, const cuuint64_t*, const cuuint64_t*,
                                   const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib == nullptr) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// Tensor map of a (batch, seq, heads, d) bf16 tensor with a contiguous last
// dimension and the given element strides, cut into boxes of `rows` rows x
// min(d, 64) elements (one Tile chunk each).  Returns a cudaError_t.
inline int make_map(CUtensorMap* map, const void* base, int batch, int seq,
                    int heads, int d, int64_t sb, int64_t ss, int64_t sh,
                    int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint32_t inner = d < 64 ? d : 64;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(seq),
      static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {inner, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      inner == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Key tiles [lo, hi) of `bk` keys that query rows [q0, q0 + rows) at
// q_offset can attend under the causal and window masks; the tiles outside
// are skipped whole.
__device__ inline void key_tiles(int q0, int rows, int sk, int bk,
                                          int causal, int window, int q_offset,
                                          int* lo, int* hi) {
  const int first = q0 + q_offset, last = first + rows - 1;
  int n = (sk + bk - 1) / bk;
  if (causal) n = last < 0 ? 0 : (last / bk + 1 < n ? last / bk + 1 : n);
  int start = 0;
  if (window > 0 && first - window + 1 > 0) start = (first - window + 1) / bk;
  *lo = start;
  *hi = n > start ? n : start;
}

// Query tiles [lo, hi) of `bq` rows that can attend keys [k0, k0 + rows):
// the mirror of key_tiles for the dK/dV pass.
__device__ inline void query_tiles(int k0, int rows, int sq, int bq,
                                            int causal, int window, int q_offset,
                                            int* lo, int* hi) {
  int n = (sq + bq - 1) / bq;
  int start = 0;
  if (causal) {  // some query q >= k0 - q_offset
    const int qmin = k0 - q_offset;
    if (qmin > 0) start = qmin / bq;
  }
  if (window > 0) {  // some query q < k0 + rows - 1 + window - q_offset
    const int qend = k0 + rows - 1 + window - q_offset;
    const int m = qend <= 0 ? 0 : (qend + bq - 1) / bq;
    if (m < n) n = m;
  }
  *lo = start;
  *hi = n > start ? n : start;
}

}  // namespace hopper
}  // namespace repro_torch
