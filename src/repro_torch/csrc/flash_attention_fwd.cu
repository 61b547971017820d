// FlashAttention forward for Hopper (sm_90a), with the row log-sum-exp.
//
// Replaces the TPU kernel `flash_attention_fwd` of
// src/repro/kernels/flash_attention.py (body `_fwd_kernel`): the same
// function, with causal, sliding-window and q_offset masks, whole tiles that
// a mask removes skipped, GQA query head h reading KV head h / group, ragged
// tails masked, a finite NEG_INF so fully masked rows give zeros and not NaN,
// l clamped at 1e-20, and lse = m + log(l) in fp32.
//
// What bounds it on the H100: operations.  At the prefill shapes of the
// main path (S = 1024, D = 128) each K/V tile is reused by 64 query rows,
// hundreds of flops per byte, so the card's arithmetic is the limit.
//
// Design: one block of 256 threads per (query tile of 64 rows, head,
// batch).  Q, K and V tiles are staged in shared memory as fp32 with 16-byte
// loads straight from the model's (B, S, H|KV, D) layout through strides;
// no transposed copy is made.  Each thread owns a 4x4 block of the 64x64
// score tile and a 4 x D/16 block of the output, so the row max and row sum
// of the online softmax reduce over the 16 lanes of a half-warp.  The
// products run on the CUDA cores in fp32, far below the tensor cores' bf16
// rate: wgmma, TMA staging and warp specialisation are later work.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kRows = kBQ / 16;  // score rows per thread
constexpr int kCols = kBK / 16;  // score columns per thread

// Dynamic shared memory, in floats: qs [kBQ][D+1], ks [kBK][D+1],
// vs [kBK][D], ps [kBQ][kBK+1].  The +1 pads keep the inner loops free of
// bank conflicts.
template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kBQ) * (D + 1) + kBK * (D + 1) + kBK * D +
         kBQ * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int group, int sq, int sk,
    int causal, int window, int q_offset, float scale, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
    int64_t o_sh, int64_t l_sb, int64_t l_sh) {
  constexpr int kVec = vec_width<T>();
  constexpr int kOut = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * (D + 1);
  float* vs = ks + kBK * (D + 1);
  float* ps = vs + kBK * D;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int i = tid * kVec; i < kBQ * D; i += kThreads * kVec) {
    const int r = i / D, e = i % D;
    float tmp[kVec];
    if (q0 + r < sq) {
      load_vec(qb + (q0 + r) * q_ss + e, tmp);
    } else {
#pragma unroll
      for (int t = 0; t < kVec; ++t) tmp[t] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < kVec; ++t) qs[r * (D + 1) + e + t] = tmp[t] * scale;
  }

  float m[kRows], l[kRows], o[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kOut; ++e) o[i][e] = 0.f;
  }

  const int qstart = q0 + q_offset;  // absolute position of the tile's row 0
  const int nk = (sk + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    // whole-tile skips; the conditions are uniform over the block
    if (causal && k0 > qstart + kBQ - 1) break;
    if (window > 0 && k0 + kBK - 1 <= qstart - window) continue;

    __syncthreads();  // the previous tile's readers are done
    for (int i = tid * kVec; i < kBK * D; i += kThreads * kVec) {
      const int j = i / D, e = i % D;
      float kt_[kVec], vt_[kVec];
      if (k0 + j < sk) {
        load_vec(kb + (k0 + j) * k_ss + e, kt_);
        load_vec(vb + (k0 + j) * v_ss + e, vt_);
      } else {
#pragma unroll
        for (int t = 0; t < kVec; ++t) kt_[t] = vt_[t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        ks[j * (D + 1) + e + t] = kt_[t];
        vs[i + t] = vt_[t];
      }
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int e = 0; e < D; ++e) {
      float a[kRows], c[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[(ty + 16 * i) * (D + 1) + e];
#pragma unroll
      for (int j = 0; j < kCols; ++j) c[j] = ks[(tx + 16 * j) * (D + 1) + e];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

    // mask and online softmax; row ty + 16 i lives in the 16 lanes sharing ty
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      const int qpos = qstart + r;
      bool valid[kCols];
      float rowmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        valid[j] = kpos < sk && (!causal || kpos <= qpos) &&
                   (window <= 0 || kpos > qpos - window);
        if (!valid[j]) s[i][j] = kNegInf;
        rowmax = fmaxf(rowmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max<16>(rowmax));
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[r * (kBK + 1) + tx + 16 * j] = p;
        rowsum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + group_sum<16>(rowsum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kOut; ++e) o[i][e] *= corr;
    }
    __syncwarp();  // a row's probabilities come from lanes of the same warp

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[kRows], vv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = ps[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int e = 0; e < kOut; ++e) vv[e] = vs[c * D + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int e = 0; e < kOut; ++e) o[i][e] = fmaf(p[i], vv[e], o[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    const float ll = fmaxf(l[i], 1e-20f);
    T* orow = out + b * o_sb + r * o_ss + h * o_sh;
#pragma unroll
    for (int e = 0; e < kOut; ++e) store(orow + tx + 16 * e, o[i][e] / ll);
    if (tx == 0) lse[b * l_sb + h * l_sh + r] = m[i] + logf(ll);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int batch, int heads, int group, int sq, int sk, int causal,
           int window, int q_offset, float scale, const int64_t* st,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, group, sq, sk,
      causal, window, q_offset, scale, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13]);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int batch, int heads, int group, int sq, int sk,
             int d, int causal, int window, int q_offset, float scale,
             const int64_t* st, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, batch, heads, group, sq, sk,
                           causal, window, q_offset, scale, st, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, batch, heads, group, sq, sk,
                           causal, window, q_offset, scale, st, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, batch, heads, group, sq, sk,
                            causal, window, q_offset, scale, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// q (B, Sq, H, D), k/v (B, Sk, KV, D), out (B, Sq, H, D), all through
// strides with a contiguous last dimension; lse (B, H, Sq) fp32.
// `strides` holds 14 values: q, k, v, out as (batch, seq, head) each, then
// lse as (batch, head).  Returns the launch's cudaError_t.
#define REPRO_FLASH_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* out, \
                      float* lse, int batch, int heads, int group, int sq,    \
                      int sk, int d, int causal, int window, int q_offset,    \
                      float scale, const int64_t* strides, void* stream) {    \
    return repro_torch::dispatch<T>(q, k, v, out, lse, batch, heads, group,   \
                                    sq, sk, d, causal, window, q_offset,      \
                                    scale, strides,                           \
                                    static_cast<cudaStream_t>(stream));       \
  }

REPRO_FLASH_ENTRY(flash_attention_fwd_f32, float)
REPRO_FLASH_ENTRY(flash_attention_fwd_bf16, __nv_bfloat16)
