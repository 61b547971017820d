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
// Design, three launches on the caller's stream:
//   1. delta: one warp per (batch, query, head) row, fp32 sum of dO * O.
//   2. dQ: one block of 256 threads per (query tile of 64 rows, head, batch).
//      Q (pre-scaled) and dO stay in shared memory; the block walks the K/V
//      tiles its masks leave, rebuilds P and dS tile by tile and keeps dQ in
//      registers (each thread 4 rows x D/16 columns).
//   3. dK/dV: one block per (key tile of 64 rows, KV head, batch).  K and V
//      stay in shared memory; the block walks the G query heads of its group
//      and, for each, the query tiles its masks leave, accumulating
//      dV += P^T dO and dK += dS^T Q in registers.  dK/dV come out per KV
//      head, so the group-sum needs no (B, H, Sk, D) intermediate and no
//      atomics: the result is deterministic.
// All tensors are read in the model's (B, S, H|KV, D) layout through their
// strides, with 16-byte loads into fp32 tiles padded by one column against
// bank conflicts.  Shared memory at D = 128 is 145 KB (dQ) and 162 KB
// (dK/dV), under the 227 KB opt-in; the accumulators never touch it.  The
// products run on the CUDA cores in fp32, far below the tensor cores' bf16
// rate: wgmma, TMA staging and warp specialisation are later work.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per tile
constexpr int kBK = 64;          // keys per tile
constexpr int kPer = kBQ / 16;   // score rows (or columns) per thread

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

__device__ __forceinline__ bool attends(int qpos, int kpos, int sk,
                                        int causal, int window) {
  return kpos < sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_kernel(
    const BwdArgs a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + warp;
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
  const int64_t rows = static_cast<int64_t>(a.batch) * a.sq * a.heads;
  const int per_block = kThreads / 32;
  flash_bwd_delta_kernel<T, D>
      <<<static_cast<unsigned>((rows + per_block - 1) / per_block), kThreads, 0,
         stream>>>(a);
  cudaError_t err = cudaGetLastError();
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

}  // namespace
}  // namespace repro_torch

// q, dout (B, Sq, H, D), k/v (B, Sk, KV, D), out (B, Sq, H, D), dq like q,
// dk/dv like k, all through strides with a contiguous last dimension;
// lse and the delta scratch (B, H, Sq) fp32, contiguous.  `strides` holds
// 24 values: (batch, seq, head) of q, k, v, out, dout, dq, dk, dv in that
// order.  Launches three kernels; returns the first failing launch's
// cudaError_t, else cudaSuccess.
#define REPRO_FLASH_BWD_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      const void* out, const void* dout, const float* lse,   \
                      float* delta, void* dq, void* dk, void* dv, int batch, \
                      int heads, int group, int sq, int sk, int d,           \
                      int causal, int window, int q_offset, float scale,     \
                      const int64_t* strides, void* stream) {                \
    repro_torch::BwdArgs a{q,     k,     v,      out,    dout,  lse,   delta, \
                           dq,    dk,    dv,     batch,  heads, group, sq,    \
                           sk,    causal, window, q_offset, scale, {}};      \
    for (int i = 0; i < 24; ++i) a.st[i] = strides[i];                       \
    return repro_torch::dispatch<T>(a, d, static_cast<cudaStream_t>(stream)); \
  }

REPRO_FLASH_BWD_ENTRY(flash_attention_bwd_f32, float)
REPRO_FLASH_BWD_ENTRY(flash_attention_bwd_bf16, __nv_bfloat16)
