// FlashAttention backward for Hopper (sm_90a): dQ, dK and dV by recompute.
//
// Replaces the TPU kernel `flash_attention_bwd` of
// src/repro/kernels/flash_attention.py (bodies `_dq_kernel` and
// `_dkv_kernel`), together with the row sums delta = rowsum(dO * O) that the
// reference computes outside Pallas and the GQA group-sum of dK/dV that its
// wrapper does (src/repro/kernels/ops.py, `_bwd_vjp`).  The same function:
// P = exp(S - lse) rebuilt from the forward's fp32 LSE, dS = P (dP - delta)
// scale, causal, sliding-window and q_offset masks with whole tiles that a
// mask removes skipped (the reference's block tests), ragged tails masked,
// a finite NEG_INF so a fully masked row gives zero gradients.
//
// What bounds it on the H100: operations.  At the training shapes (S = 1024,
// D = 128) the five products QK^T, dO V^T, P^T dO, dS^T Q and dS K reuse each
// staged tile 64 times, hundreds of flops per byte moved.
//
// Three launches on the caller's stream, deterministic (no atomics):
//   1. delta: one warp per (batch, query, head) row, fp32 sum of dO * O.
//   2. dQ: one block per (query tile of 64 rows, head, batch) walks the K/V
//      tiles its masks leave.
//   3. dK/dV: one block per (key tile of 64 rows, KV head, batch) walks the
//      G query heads of its group and their query tiles, summing the group
//      in registers, so dK/dV come out per KV head.
//
// bf16 design (flash_bwd_*_wgmma_kernel): each block is one warpgroup of
// 128 threads owning 64 rows.  Its two resident tiles (Q and dO, or K and
// V) arrive once by TMA; the streamed pair (K and V, or Q and dO) runs
// through two stages, the next pair loading while the current one is used.
// All tiles are read through 4-D tensor maps from the model's
// (B, S, H|KV, D) layout, rows past S arriving as zeros.  The five products
// are wgmma with fp32 accumulators: S = Q K^T and dP = dO V^T (dK/dV
// kernel: S^T = K Q^T, dP^T = V dO^T) from shared memory, m64n64k16; then
// P = 2^(S scale log2(e) - lse log2(e)) and dS are computed on the
// accumulator fragments (the masks only on tiles that cross a mask's edge),
// rounded to bf16 in registers and fed as the A operand of dQ += dS K,
// dV += P^T dO and dK += dS^T Q (m64nDk16, the shared operand read
// MN-major through the descriptor's transpose bit).  The dK/dV block
// stages the next item's lse and delta rows in shared memory while it
// works on the current one, and holds dK, dV, S^T and dP^T (192 fp32
// registers a thread at D = 128), so it stays at 64 keys.  Shared memory
// is 97 KB a block at D = 128, two blocks to an SM.
//
// fp32 (flash_bwd_dq_kernel / flash_bwd_dkv_kernel, unchanged): the tensor
// cores take no fp32 inputs at the 1e-5 the fp32 checks hold, so fp32
// stays on the CUDA cores: 64 x 64 fp32 tiles in shared memory padded by
// one column, each of 256 threads owning a 4 x 4 block of the score tile.

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kDeltaThreads = 256;

// Offsets into BwdArgs::st of each tensor's (batch, seq, head) strides.
enum { kQ = 0, kK = 3, kV = 6, kO = 9, kDO = 12, kDQ = 15, kDK = 18, kDV = 21 };

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;   // (B, H, Sq), contiguous
  float* delta;       // (B, H, Sq), contiguous; written by launch 1
  void* dq;
  void* dk;
  void* dv;
  int batch, heads, group, sq, sk, causal, window, q_offset;
  float scale;
  int64_t st[24];
};

__device__ __forceinline__ bool attends(int qpos, int kpos, int sk,
                                        int causal, int window) {
  return kpos < sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

template <typename T, int D>
__global__ void __launch_bounds__(kDeltaThreads) flash_bwd_delta_kernel(
    const BwdArgs a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kDeltaThreads / 32) + warp;
  if (row >= static_cast<int64_t>(a.batch) * a.sq * a.heads) return;  // warp-uniform
  const int h = static_cast<int>(row % a.heads);
  const int64_t bq = row / a.heads;
  const int qi = static_cast<int>(bq % a.sq), b = static_cast<int>(bq / a.sq);
  const T* o = static_cast<const T*>(a.out) + b * a.st[kO] + qi * a.st[kO + 1] +
               h * a.st[kO + 2];
  const T* g = static_cast<const T*>(a.dout) + b * a.st[kDO] +
               qi * a.st[kDO + 1] + h * a.st[kDO + 2];
  float acc = 0.f;
  for (int e = lane; e < D; e += 32) acc += to_float(o[e]) * to_float(g[e]);
  acc = group_sum<32>(acc);
  if (lane == 0) a.delta[(static_cast<int64_t>(b) * a.heads + h) * a.sq + qi] = acc;
}

// Launch 1: delta = rowsum(dO * O) into a.delta.
template <typename T, int D>
int launch_delta(const BwdArgs& a, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(a.batch) * a.sq * a.heads;
  const int per_block = kDeltaThreads / 32;
  flash_bwd_delta_kernel<T, D>
      <<<static_cast<unsigned>((rows + per_block - 1) / per_block), kDeltaThreads,
         0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

namespace simt {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per tile
constexpr int kBK = 64;          // keys per tile
constexpr int kPer = kBQ / 16;   // score rows (or columns) per thread


// Dynamic shared memory, in floats.
template <int D>
constexpr size_t dq_smem_floats() {
  return 4 * static_cast<size_t>(kBQ) * (D + 1) + kBQ * (kBK + 1);
}
template <int D>
constexpr size_t dkv_smem_floats() {
  return 4 * static_cast<size_t>(kBK) * (D + 1) + 2 * kBK * (kBQ + 1) +
         2 * kBQ;
}

// Rows [r0, r0 + 64) of a (seq, D) slice into dst [64][D + 1] as fp32,
// times `mul`; rows at or past `n` become zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* base, int64_t row_stride,
                                      int r0, int n, float mul, float* dst) {
  constexpr int kVec = vec_width<T>();
  for (int i = threadIdx.x * kVec; i < 64 * D; i += kThreads * kVec) {
    const int r = i / D, e = i % D;
    float tmp[kVec];
    if (r0 + r < n) {
      load_vec(base + (r0 + r) * row_stride + e, tmp);
    } else {
#pragma unroll
      for (int t = 0; t < kVec; ++t) tmp[t] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < kVec; ++t) dst[r * (D + 1) + e + t] = tmp[t] * mul;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int kOut = D / 16;  // dQ columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                  // [kBQ][D+1], times scale
  float* dos = qs + kBQ * (D + 1);   // [kBQ][D+1]
  float* ks = dos + kBQ * (D + 1);   // [kBK][D+1]
  float* vs = ks + kBK * (D + 1);    // [kBK][D+1]
  float* dss = vs + kBK * (D + 1);   // [kBQ][kBK+1]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.group;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t* st = a.st;
  const T* qb = static_cast<const T*>(a.q) + b * st[kQ] + h * st[kQ + 2];
  const T* dob = static_cast<const T*>(a.dout) + b * st[kDO] + h * st[kDO + 2];
  const T* kb = static_cast<const T*>(a.k) + b * st[kK] + kvh * st[kK + 2];
  const T* vb = static_cast<const T*>(a.v) + b * st[kV] + kvh * st[kV + 2];
  stage<T, D>(qb, st[kQ + 1], q0, a.sq, a.scale, qs);
  stage<T, D>(dob, st[kDO + 1], q0, a.sq, 1.f, dos);

  float lse[kPer], delta[kPer], acc[kPer][kOut];
  const int64_t row0 = (static_cast<int64_t>(b) * a.heads + h) * a.sq;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = q0 + ty + 16 * i;
    lse[i] = r < a.sq ? a.lse[row0 + r] : 0.f;
    delta[i] = r < a.sq ? a.delta[row0 + r] : 0.f;
#pragma unroll
    for (int e = 0; e < kOut; ++e) acc[i][e] = 0.f;
  }

  const int qstart = q0 + a.q_offset;  // absolute position of the tile's row 0
  const int nk = (a.sk + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    // whole-tile skips (the reference's relevance tests), uniform over the block
    if (a.causal && k0 > qstart + kBQ - 1) break;
    if (a.window > 0 && k0 + kBK - 1 <= qstart - a.window) continue;

    __syncthreads();  // the previous tile's readers are done
    stage<T, D>(kb, st[kK + 1], k0, a.sk, 1.f, ks);
    stage<T, D>(vb, st[kV + 1], k0, a.sk, 1.f, vs);
    __syncthreads();

    float s[kPer][kPer], dp[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      float qa[kPer], da[kPer], kc[kPer], vc[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        qa[i] = qs[(ty + 16 * i) * (D + 1) + e];
        da[i] = dos[(ty + 16 * i) * (D + 1) + e];
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        kc[j] = ks[(tx + 16 * j) * (D + 1) + e];
        vc[j] = vs[(tx + 16 * j) * (D + 1) + e];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          s[i][j] = fmaf(qa[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(da[i], vc[j], dp[i][j]);
        }
    }

    // dS = P (dP - delta) scale; row ty + 16 i lives in the 16 lanes sharing ty
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + 16 * i;
      const bool row_ok = q0 + r < a.sq;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = tx + 16 * j;
        const bool ok = row_ok && attends(qstart + r, k0 + c, a.sk, a.causal, a.window);
        const float p = ok ? expf(s[i][j] - lse[i]) : 0.f;
        dss[r * (kBK + 1) + c] = p * (dp[i][j] - delta[i]) * a.scale;
      }
    }
    __syncwarp();  // a row's dS comes from lanes of the same warp

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float dsv[kPer], kv[kOut];
#pragma unroll
      for (int i = 0; i < kPer; ++i) dsv[i] = dss[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int e = 0; e < kOut; ++e) kv[e] = ks[c * (D + 1) + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int e = 0; e < kOut; ++e) acc[i][e] = fmaf(dsv[i], kv[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.sq) continue;
    T* row = static_cast<T*>(a.dq) + b * st[kDQ] + r * st[kDQ + 1] + h * st[kDQ + 2];
#pragma unroll
    for (int e = 0; e < kOut; ++e) store(row + tx + 16 * e, acc[i][e]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const BwdArgs a) {
  constexpr int kOut = D / 16;  // dK/dV columns per thread
  extern __shared__ float smem[];
  float* ks = smem;                     // [kBK][D+1]
  float* vs = ks + kBK * (D + 1);       // [kBK][D+1]
  float* qs = vs + kBK * (D + 1);       // [kBQ][D+1], times scale
  float* dos = qs + kBQ * (D + 1);      // [kBQ][D+1]
  float* ps = dos + kBQ * (D + 1);      // [kBK][kBQ+1]
  float* dss = ps + kBK * (kBQ + 1);    // [kBK][kBQ+1], without the scale
  float* lse_s = dss + kBK * (kBQ + 1); // [kBQ]
  float* delta_s = lse_s + kBQ;         // [kBQ]

  const int k0 = blockIdx.x * kBK, kvh = blockIdx.y, b = blockIdx.z;
  // keys on ty (rows ty + 16 i), queries on tx (columns tx + 16 j)
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t* st = a.st;
  stage<T, D>(static_cast<const T*>(a.k) + b * st[kK] + kvh * st[kK + 2],
              st[kK + 1], k0, a.sk, 1.f, ks);
  stage<T, D>(static_cast<const T*>(a.v) + b * st[kV] + kvh * st[kV + 2],
              st[kV + 1], k0, a.sk, 1.f, vs);

  float dk[kPer][kOut], dv[kPer][kOut];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int e = 0; e < kOut; ++e) dk[i][e] = dv[i][e] = 0.f;

  const int nq = (a.sq + kBQ - 1) / kBQ;
  for (int g = 0; g < a.group; ++g) {
    const int h = kvh * a.group + g;
    const T* qb = static_cast<const T*>(a.q) + b * st[kQ] + h * st[kQ + 2];
    const T* dob = static_cast<const T*>(a.dout) + b * st[kDO] + h * st[kDO + 2];
    const int64_t row0 = (static_cast<int64_t>(b) * a.heads + h) * a.sq;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * kBQ, qstart = q0 + a.q_offset;
      // the reference's relevance tests; later query tiles only move right
      if (a.causal && k0 > qstart + kBQ - 1) continue;
      if (a.window > 0 && k0 + kBK - 1 <= qstart - a.window) break;

      __syncthreads();  // the previous tile's readers are done
      stage<T, D>(qb, st[kQ + 1], q0, a.sq, a.scale, qs);
      stage<T, D>(dob, st[kDO + 1], q0, a.sq, 1.f, dos);
      for (int i = tid; i < kBQ; i += kThreads) {
        const bool in = q0 + i < a.sq;
        lse_s[i] = in ? a.lse[row0 + q0 + i] : 0.f;
        delta_s[i] = in ? a.delta[row0 + q0 + i] : 0.f;
      }
      __syncthreads();

      float s[kPer][kPer], dp[kPer][kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int e = 0; e < D; ++e) {
        float ka[kPer], va[kPer], qc[kPer], dc[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          ka[i] = ks[(ty + 16 * i) * (D + 1) + e];
          va[i] = vs[(ty + 16 * i) * (D + 1) + e];
        }
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          qc[j] = qs[(tx + 16 * j) * (D + 1) + e];
          dc[j] = dos[(tx + 16 * j) * (D + 1) + e];
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            s[i][j] = fmaf(ka[i], qc[j], s[i][j]);
            dp[i][j] = fmaf(va[i], dc[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int c = tx + 16 * j;
          const bool ok = q0 + c < a.sq &&
                          attends(qstart + c, k0 + r, a.sk, a.causal, a.window);
          const float p = ok ? expf(s[i][j] - lse_s[c]) : 0.f;
          ps[r * (kBQ + 1) + c] = p;
          dss[r * (kBQ + 1) + c] = p * (dp[i][j] - delta_s[c]);
        }
      }
      __syncwarp();  // a key row's P and dS come from lanes of the same warp

#pragma unroll 4
      for (int c = 0; c < kBQ; ++c) {
        float pv[kPer], dsv[kPer], dov[kOut], qv[kOut];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          pv[i] = ps[(ty + 16 * i) * (kBQ + 1) + c];
          dsv[i] = dss[(ty + 16 * i) * (kBQ + 1) + c];
        }
#pragma unroll
        for (int e = 0; e < kOut; ++e) {
          dov[e] = dos[c * (D + 1) + tx + 16 * e];
          qv[e] = qs[c * (D + 1) + tx + 16 * e];
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
          for (int e = 0; e < kOut; ++e) {
            dv[i][e] = fmaf(pv[i], dov[e], dv[i][e]);
            dk[i][e] = fmaf(dsv[i], qv[e], dk[i][e]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= a.sk) continue;
    T* dkr = static_cast<T*>(a.dk) + b * st[kDK] + r * st[kDK + 1] + kvh * st[kDK + 2];
    T* dvr = static_cast<T*>(a.dv) + b * st[kDV] + r * st[kDV + 1] + kvh * st[kDV + 2];
#pragma unroll
    for (int e = 0; e < kOut; ++e) {
      store(dkr + tx + 16 * e, dk[i][e]);
      store(dvr + tx + 16 * e, dv[i][e]);
    }
  }
}

template <typename T, int D>
int launch(const BwdArgs& a, cudaStream_t stream) {
  cudaError_t err = static_cast<cudaError_t>(launch_delta<T, D>(a, stream));
  if (err != cudaSuccess) return err;

  const size_t dq_smem = dq_smem_floats<D>() * sizeof(float);
  err = allow_smem(flash_bwd_dq_kernel<T, D>, dq_smem);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid((a.sq + kBQ - 1) / kBQ, a.heads, a.batch);
  flash_bwd_dq_kernel<T, D><<<dq_grid, kThreads, dq_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dkv_smem = dkv_smem_floats<D>() * sizeof(float);
  err = allow_smem(flash_bwd_dkv_kernel<T, D>, dkv_smem);
  if (err != cudaSuccess) return err;
  const dim3 dkv_grid((a.sk + kBK - 1) / kBK, a.heads / a.group, a.batch);
  flash_bwd_dkv_kernel<T, D><<<dkv_grid, kThreads, dkv_smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const BwdArgs& a, int d, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(a, stream);
    case 64:
      return launch<T, 64>(a, stream);
    case 128:
      return launch<T, 128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace simt

namespace tc {

using hopper::Tile;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kB = 64;         // query rows and keys per tile
constexpr int kStages = 2;

// Shared memory of both kernels: two resident tiles (Q and dO, or K and V),
// then kStages stages of two streamed tiles (K and V, or Q and dO), then
// the barriers: the resident pair's and one per stage.
template <int D>
struct Smem {
  using T = Tile<D, kB>;
  static constexpr int kStream = 2 * T::kBytes;
  // the dK/dV kernel's lse * log2(e) and delta of two items' query rows
  static constexpr int kRows = kStream + 2 * kStages * T::kBytes;
  static constexpr int kBars = kRows + 2 * 2 * kB * 4;
  static constexpr size_t kBytes = kBars + 8 * (1 + kStages) + 1024;
};

// Whether a tile of query rows [q0, q0 + 64) and keys [k0, k0 + 64) crosses
// a mask's edge or a ragged end; inside, every pair attends.
__device__ __forceinline__ bool crosses_edge(int q0, int k0, const BwdArgs& a) {
  const int qa = q0 + a.q_offset;
  return q0 + kB > a.sq || k0 + kB > a.sk || (a.causal && k0 + kB - 1 > qa) ||
         (a.window > 0 && k0 <= qa + kB - 1 - a.window);
}

// dQ pass: dS = P (dP - delta) in place of S, P = 2^(S c - lse2) with
// c = scale * log2(e) and lse2 = lse * log2(e).  sc[4 j + 2 rr + e] is query
// row `r + 8 rr` of the tile, key k0 + 8 j + 2 quad + e.
template <bool kMask>
__device__ __forceinline__ void dq_scores(float (&sc)[kB / 2],
                                          const float (&dp)[kB / 2],
                                          const float (&lse2)[2],
                                          const float (&delta)[2], float c,
                                          int q0, int r, int k0, int quad,
                                          const BwdArgs& a) {
#pragma unroll
  for (int j = 0; j < kB / 8; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * rr + e;
        float p = exp2f(fmaf(sc[x], c, -lse2[rr]));
        if (kMask) {
          const int q = q0 + r + 8 * rr;
          p = q < a.sq && attends(q + a.q_offset, k0 + 8 * j + 2 * quad + e, a.sk,
                                  a.causal, a.window)
                  ? p
                  : 0.f;
        }
        sc[x] = p * (dp[x] - delta[rr]);
      }
}

// dK/dV pass: P^T in place of S^T.  sc[4 j + 2 rr + e] is key row
// `r + 8 rr` of the tile, query column 8 j + 2 quad + e, whose lse2 is
// lse2[column].
template <bool kMask>
__device__ __forceinline__ void dkv_probs(float (&sc)[kB / 2], const float* lse2,
                                          float c, int q0, int k0, int r, int quad,
                                          const BwdArgs& a) {
#pragma unroll
  for (int j = 0; j < kB / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * quad + e;
      const float l2 = lse2[col];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int x = 4 * j + 2 * rr + e;
        float p = exp2f(fmaf(sc[x], c, -l2));
        if (kMask)
          p = q0 + col < a.sq && attends(q0 + col + a.q_offset, k0 + r + 8 * rr,
                                         a.sk, a.causal, a.window)
                  ? p
                  : 0.f;
        sc[x] = p;
      }
    }
}

// Loads the pair of tiles at row `row` of maps `ma`, `mb` (head `head`,
// batch `b`) into dst and dst + one tile, completing on `bar`.
template <int D>
__device__ __forceinline__ void load_pair(uint8_t* dst, const CUtensorMap* ma,
                                          const CUtensorMap* mb, uint64_t* bar,
                                          int row, int head, int b) {
  using T = Tile<D, kB>;
  hopper::mbar_expect_tx(bar, 2 * T::kBytes);
  for (int c = 0; c < T::kChunks; ++c) {
    hopper::tma_load(dst + c * T::kChunkBytes, ma, bar, c * T::kInner, row, head,
                     b);
    hopper::tma_load(dst + T::kBytes + c * T::kChunkBytes, mb, bar, c * T::kInner,
                     row, head, b);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dq_wgmma_kernel(
    __grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
    __grid_constant__ const CUtensorMap tv, __grid_constant__ const CUtensorMap tdo,
    const BwdArgs a) {
  using T = Tile<D, kB>;
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  const uint8_t* qs = smem;
  const uint8_t* dos = smem + T::kBytes;
  uint8_t* stream = smem + S::kStream;  // stage s: K, then V
  uint64_t* resident = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* full = resident + 1;

  const int h = blockIdx.x, b = blockIdx.y, kvh = h / a.group;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kB;  // longest causal tiles first
  int t_lo, t_hi;
  hopper::key_tiles(q0, kB, a.sk, kB, a.causal, a.window, a.q_offset, &t_lo, &t_hi);
  const int n = t_hi - t_lo;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(resident, 1);
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    load_pair<D>(smem, &tq, &tdo, resident, q0, h, b);
    if (n > 0) load_pair<D>(stream, &tk, &tv, &full[0], t_lo * kB, kvh, b);
  }

  // this thread's rows: row and row + 8 of the tile (fragment layout in
  // hopper.cuh)
  const int warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int row = 16 * warp + lane / 4;
  const int64_t row0 = (static_cast<int64_t>(b) * a.heads + h) * a.sq;
  const float c = a.scale * kLog2e;
  float lse2[2], delta[2], dq[D / 2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = q0 + row + 8 * rr;
    lse2[rr] = r < a.sq ? a.lse[row0 + r] * kLog2e : 0.f;
    delta[rr] = r < a.sq ? a.delta[row0 + r] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  hopper::mbar_wait(resident, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    if (tid == 0 && i + 1 < n)  // the other stage was released at the end of i - 1
      load_pair<D>(stream + 2 * ((i + 1) % kStages) * T::kBytes, &tk, &tv,
                   &full[(i + 1) % kStages], (t_lo + i + 1) * kB, kvh, b);
    hopper::mbar_wait(&full[s], (i / kStages) & 1);
    const uint8_t* kst = stream + 2 * s * T::kBytes;
    const uint8_t* vst = kst + T::kBytes;

    float sc[kB / 2], dp[kB / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      hopper::wgmma_ss<kB>(sc, T::kmajor(qs, 0, k), T::kmajor(kst, 0, k), k > 0);
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      hopper::wgmma_ss<kB>(dp, T::kmajor(dos, 0, k), T::kmajor(vst, 0, k), k > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::hold(sc);
    hopper::hold(dp);

    // dS = P (dP - delta) on the fragments, masked only at an edge
    const int k0 = (t_lo + i) * kB;
    if (crosses_edge(q0, k0, a))
      dq_scores<true>(sc, dp, lse2, delta, c, q0, row, k0, quad, a);
    else
      dq_scores<false>(sc, dp, lse2, delta, c, q0, row, k0, quad, a);
    uint32_t ds[kB / 16][4];
    hopper::to_a_frags<kB / 16>(sc, ds);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kB / 16; ++k)
      hopper::wgmma_rs_tb<D>(dq, ds[k], T::mnmajor(kst, k), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::hold(dq);
    hopper::hold(ds);
    __syncthreads();  // stage s is free for tile i + 2
  }

  const int64_t* st = a.st;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = q0 + row + 8 * rr;
    if (r >= a.sq) continue;
    bf16* out = static_cast<bf16*>(a.dq) + b * st[kDQ] + r * st[kDQ + 1] +
                h * st[kDQ + 2];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * quad) =
          __floats2bfloat162_rn(dq[4 * j + 2 * rr] * a.scale,
                                dq[4 * j + 2 * rr + 1] * a.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dkv_wgmma_kernel(
    __grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
    __grid_constant__ const CUtensorMap tv, __grid_constant__ const CUtensorMap tdo,
    const BwdArgs a) {
  using T = Tile<D, kB>;
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  const uint8_t* ks = smem;
  const uint8_t* vs = smem + T::kBytes;
  uint8_t* stream = smem + S::kStream;  // stage s: Q, then dO
  uint64_t* resident = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* full = resident + 1;

  // the first key tiles carry the most causal work: launched first
  const int kvh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kB;
  int qt_lo, qt_hi;
  hopper::query_tiles(k0, kB, a.sq, kB, a.causal, a.window, a.q_offset, &qt_lo,
                      &qt_hi);
  const int nq = qt_hi - qt_lo, n = a.group * nq;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(resident, 1);
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // item i: query head kvh * group + i / nq, query tile qt_lo + i % nq
  if (tid == 0) {
    load_pair<D>(smem, &tk, &tv, resident, k0, kvh, b);
    if (n > 0)
      load_pair<D>(stream, &tq, &tdo, &full[0], qt_lo * kB, kvh * a.group, b);
  }

  // this thread's keys: row and row + 8 of the tile; its query columns
  // 8 j + 2 quad + e
  const int warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int row = 16 * warp + lane / 4;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  // item it's lse * log2(e) (threads 0-63) and delta (64-127) of its query
  // rows into buffer it % 2
  float* rows = reinterpret_cast<float*>(smem + S::kRows);
  auto stage_rows = [&](int it) {
    const int h = kvh * a.group + it / nq, q = (qt_lo + it % nq) * kB + tid % kB;
    const int64_t at = (static_cast<int64_t>(b) * a.heads + h) * a.sq + q;
    rows[(it % 2) * 2 * kB + tid] =
        q >= a.sq ? 0.f : tid < kB ? a.lse[at] * kLog2e : a.delta[at];
  };
  if (n > 0) stage_rows(0);
  __syncthreads();
  const float c = a.scale * kLog2e;

  hopper::mbar_wait(resident, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    if (tid == 0 && i + 1 < n)  // the other stage was released at the end of i - 1
      load_pair<D>(stream + 2 * ((i + 1) % kStages) * T::kBytes, &tq, &tdo,
                   &full[(i + 1) % kStages], (qt_lo + (i + 1) % nq) * kB,
                   kvh * a.group + (i + 1) / nq, b);
    if (i + 1 < n) stage_rows(i + 1);  // read after the barrier that ends item i
    const float* lse2 = rows + (i % 2) * 2 * kB;
    const float* delta = lse2 + kB;
    const int q0 = (qt_lo + i % nq) * kB;
    hopper::mbar_wait(&full[s], (i / kStages) & 1);
    const uint8_t* qst = stream + 2 * s * T::kBytes;
    const uint8_t* dost = qst + T::kBytes;

    float sc[kB / 2], dp[kB / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      hopper::wgmma_ss<kB>(sc, T::kmajor(ks, 0, k), T::kmajor(qst, 0, k), k > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::hold(sc);

    // P^T on the fragments, masked only at an edge
    if (crosses_edge(q0, k0, a))
      dkv_probs<true>(sc, lse2, c, q0, k0, row, quad, a);
    else
      dkv_probs<false>(sc, lse2, c, q0, k0, row, quad, a);
    uint32_t pa[kB / 16][4];
    hopper::to_a_frags<kB / 16>(sc, pa);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kB / 16; ++k)
      hopper::wgmma_rs_tb<D>(dv, pa[k], T::mnmajor(dost, k), 1);
    hopper::wgmma_commit();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      hopper::wgmma_ss<kB>(dp, T::kmajor(vs, 0, k), T::kmajor(dost, 0, k), k > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::hold(dv);
    hopper::hold(dp);
    hopper::hold(pa);

    // dS^T = P^T (dP^T - delta), delta by query column
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = delta[8 * j + 2 * quad + e];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int x = 4 * j + 2 * rr + e;
          dp[x] = sc[x] * (dp[x] - dl);
        }
      }
    uint32_t ds[kB / 16][4];
    hopper::to_a_frags<kB / 16>(dp, ds);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kB / 16; ++k)
      hopper::wgmma_rs_tb<D>(dk, ds[k], T::mnmajor(qst, k), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::hold(dk);
    hopper::hold(ds);
    __syncthreads();  // stage s is free for item i + 2
  }

  const int64_t* st = a.st;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = k0 + row + 8 * rr;
    if (r >= a.sk) continue;
    bf16* dkr = static_cast<bf16*>(a.dk) + b * st[kDK] + r * st[kDK + 1] +
                kvh * st[kDK + 2];
    bf16* dvr = static_cast<bf16*>(a.dv) + b * st[kDV] + r * st[kDV + 1] +
                kvh * st[kDV + 2];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int x = 4 * j + 2 * rr;
      *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * j + 2 * quad) =
          __floats2bfloat162_rn(dk[x] * a.scale, dk[x + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * j + 2 * quad) =
          __floats2bfloat162_rn(dv[x], dv[x + 1]);
    }
  }
}

template <int D>
int launch(const BwdArgs& a, cudaStream_t stream) {
  int err = launch_delta<bf16, D>(a, stream);
  if (err != cudaSuccess) return err;
  const int64_t* st = a.st;
  const int kv = a.heads / a.group;
  CUtensorMap tq, tk, tv, tdo;
  err = hopper::make_map(&tq, a.q, a.batch, a.sq, a.heads, D, st[kQ], st[kQ + 1],
                         st[kQ + 2], kB);
  if (err == cudaSuccess)
    err = hopper::make_map(&tk, a.k, a.batch, a.sk, kv, D, st[kK], st[kK + 1],
                           st[kK + 2], kB);
  if (err == cudaSuccess)
    err = hopper::make_map(&tv, a.v, a.batch, a.sk, kv, D, st[kV], st[kV + 1],
                           st[kV + 2], kB);
  if (err == cudaSuccess)
    err = hopper::make_map(&tdo, a.dout, a.batch, a.sq, a.heads, D, st[kDO],
                           st[kDO + 1], st[kDO + 2], kB);
  if (err != cudaSuccess) return err;

  const size_t smem = Smem<D>::kBytes;
  err = allow_smem(flash_bwd_dq_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<D>
      <<<dim3(a.heads, a.batch, (a.sq + kB - 1) / kB), kThreads, smem, stream>>>(
          tq, tk, tv, tdo, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = allow_smem(flash_bwd_dkv_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_wgmma_kernel<D>
      <<<dim3(kv, a.batch, (a.sk + kB - 1) / kB), kThreads, smem, stream>>>(
          tq, tk, tv, tdo, a);
  return cudaGetLastError();
}

int dispatch(const BwdArgs& a, int d, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<32>(a, stream);
    case 64:
      return launch<64>(a, stream);
    case 128:
      return launch<128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc
}  // namespace repro_torch

// q, dout (B, Sq, H, D), k/v (B, Sk, KV, D), out (B, Sq, H, D), dq like q,
// dk/dv like k, all through strides with a contiguous last dimension;
// lse and the delta scratch (B, H, Sq) fp32, contiguous.  `strides` holds
// 24 values: (batch, seq, head) of q, k, v, out, dout, dq, dk, dv in that
// order.  Each entry launches three kernels and returns the first failing
// launch's cudaError_t, else cudaSuccess.
namespace {

repro_torch::BwdArgs bwd_args(const void* q, const void* k, const void* v,
                              const void* out, const void* dout, const float* lse,
                              float* delta, void* dq, void* dk, void* dv,
                              int batch, int heads, int group, int sq, int sk,
                              int causal, int window, int q_offset, float scale,
                              const int64_t* strides) {
  repro_torch::BwdArgs a{q,     k,     v,  out, dout, lse,    delta,  dq,
                         dk,    dv,    batch, heads, group, sq, sk, causal,
                         window, q_offset, scale, {}};
  for (int i = 0; i < 24; ++i) a.st[i] = strides[i];
  return a;
}

}  // namespace

extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout,
                                       const float* lse, float* delta, void* dq,
                                       void* dk, void* dv, int batch, int heads,
                                       int group, int sq, int sk, int d, int causal,
                                       int window, int q_offset, float scale,
                                       const int64_t* strides, void* stream) {
  return repro_torch::simt::dispatch<float>(
      bwd_args(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, heads, group, sq,
               sk, causal, window, q_offset, scale, strides),
      d, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout,
                                        const float* lse, float* delta, void* dq,
                                        void* dk, void* dv, int batch, int heads,
                                        int group, int sq, int sk, int d, int causal,
                                        int window, int q_offset, float scale,
                                        const int64_t* strides, void* stream) {
  return repro_torch::tc::dispatch(
      bwd_args(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, heads, group, sq,
               sk, causal, window, q_offset, scale, strides),
      d, static_cast<cudaStream_t>(stream));
}
