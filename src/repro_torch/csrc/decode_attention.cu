// Decode attention for Hopper (sm_90a): one new token per batch row against
// a padded KV cache.
//
// Replaces the TPU kernel `decode_attention` of
// src/repro/kernels/decode_attention.py (body `_kernel`): the same
// function, with an online softmax over the keys [max(0, len - window), len),
// keys masked to kpos < len and the window, l clamped at 1e-20 so that a row
// of length 0 comes out as zeros.
//
// What bounds it on the H100: bytes.  Each key and value row of the valid
// prefix is read once and used by the whole GQA group: G query heads, 2*G
// flops per element read, far below the ~295 flops/byte the card needs to be
// bound by its tensor cores.
//
// Design: one block of 128 threads per (batch row, KV head), holding the
// head's whole query group, so each cache row is read from device memory
// once.  The cache is read in the model's (B, S, KV, D) layout through its
// strides: no transposed copy of the cache is ever made.  Key tiles of 32
// rows are staged in shared memory with 16-byte loads; scores, the online
// softmax (one warp per query head) and the P.V update run from there in
// fp32.  At B=8 and KV=8 this launches 64 blocks on 132 SMs, so half the
// card idles and the loop over tiles is latency bound.  Splitting the keys
// over more blocks and merging the partial softmaxes (the merge is written
// out in src/repro/models/attention.py `_split_kv_decode`) is later work, as
// are TMA and deeper pipelining.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kBlockK = 32;  // keys per tile: one per lane in the softmax step
constexpr int kWarps = kThreads / 32;

// Dynamic shared memory, in floats:
//   ks [kBlockK][D + 1]  (the +1 keeps the score loop free of bank conflicts)
//   vs [kBlockK][Dv]
//   qs [G][D]            (pre-scaled queries)
//   ps [G][kBlockK]      (scores, then probabilities)
//   acc [G][Dv]
//   m, l, corr [G] each
inline size_t smem_floats(int group, int d, int dv) {
  return static_cast<size_t>(kBlockK) * (d + 1) + kBlockK * dv + group * d +
         group * kBlockK + group * dv + 3 * group;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int32_t* __restrict__ lengths, T* __restrict__ out, int group, int d,
    int dv, int smax, int window, float scale, int64_t q_sb, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, int64_t o_sb, int64_t o_sh) {
  constexpr int kVec = vec_width<T>();
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kBlockK * (d + 1);
  float* qs = vs + kBlockK * dv;
  float* ps = qs + group * d;
  float* acc = ps + group * kBlockK;
  float* m_s = acc + group * dv;
  float* l_s = m_s + group;
  float* c_s = l_s + group;

  const int b = blockIdx.x, kvh = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int head0 = kvh * group;  // first query head of this KV head's group
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int i = tid * kVec; i < group * d; i += kThreads * kVec) {
    const int g = i / d, e = i % d;
    float tmp[kVec];
    load_vec(q + b * q_sb + (head0 + g) * q_sh + e, tmp);
#pragma unroll
    for (int j = 0; j < kVec; ++j) qs[i + j] = tmp[j] * scale;
  }
  for (int i = tid; i < group * dv; i += kThreads) acc[i] = 0.f;
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int len = lengths[b];
  const int hi = min(len, smax);
  const int lo = window > 0 ? max(0, len - window) : 0;

  for (int k0 = lo; k0 < hi; k0 += kBlockK) {
    const int n = min(kBlockK, hi - k0);
    for (int i = tid * kVec; i < kBlockK * d; i += kThreads * kVec) {
      const int j = i / d, e = i % d;
      float tmp[kVec];
      if (j < n) {
        load_vec(kb + (k0 + j) * k_ss + e, tmp);
      } else {
#pragma unroll
        for (int t = 0; t < kVec; ++t) tmp[t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < kVec; ++t) ks[j * (d + 1) + e + t] = tmp[t];
    }
    for (int i = tid * kVec; i < kBlockK * dv; i += kThreads * kVec) {
      const int j = i / dv, e = i % dv;
      float tmp[kVec];
      if (j < n) {
        load_vec(vb + (k0 + j) * v_ss + e, tmp);
      } else {
#pragma unroll
        for (int t = 0; t < kVec; ++t) tmp[t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < kVec; ++t) vs[i + t] = tmp[t];
    }
    __syncthreads();

    // scores: one (query head, key) pair per thread and step
    for (int i = tid; i < group * kBlockK; i += kThreads) {
      const int g = i / kBlockK, j = i % kBlockK;
      float s = kNegInf;
      if (j < n) {
        const float* qr = qs + g * d;
        const float* kr = ks + j * (d + 1);
        s = 0.f;
        for (int e = 0; e < d; ++e) s = fmaf(qr[e], kr[e], s);
      }
      ps[i] = s;
    }
    __syncthreads();

    // online softmax: one warp per query head, one key per lane
    for (int g = warp; g < group; g += kWarps) {
      const float s = ps[g * kBlockK + lane];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, group_max(s));
      const float p = lane < n ? expf(s - m_new) : 0.f;
      ps[g * kBlockK + lane] = p;
      const float sum = group_sum(p);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P . V; each thread owns fixed (g, e) entries
    for (int i = tid; i < group * dv; i += kThreads) {
      const int g = i / dv, e = i % dv;
      const float* pr = ps + g * kBlockK;
      float a = acc[i] * c_s[g];
      for (int j = 0; j < n; ++j) a = fmaf(pr[j], vs[j * dv + e], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < group * dv; i += kThreads) {
    const int g = i / dv, e = i % dv;
    const float l = fmaxf(l_s[g], 1e-20f);
    store(out + b * o_sb + (head0 + g) * o_sh + e, acc[i] / l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int32_t* lengths,
           void* out, int batch, int kv_heads, int group, int d, int dv,
           int smax, int window, float scale, int64_t q_sb, int64_t q_sh,
           int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
           int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_sh,
           cudaStream_t stream) {
  const size_t smem = smem_floats(group, d, dv) * sizeof(float);
  cudaError_t err = allow_smem(decode_attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  decode_attention_kernel<T><<<dim3(batch, kv_heads), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), group, d, dv,
      smax, window, scale, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
      o_sb, o_sh);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// q (B, KV, G, D) as (batch stride, head stride) with head = kv * G + g;
// caches (B, Smax, KV, D[v]) through their strides; out likewise to q.
// Every last dimension is contiguous.  Returns the launch's cudaError_t.
#define REPRO_DECODE_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      const int32_t* lengths, void* out, int batch,          \
                      int kv_heads, int group, int d, int dv, int smax,      \
                      int window, float scale, int64_t q_sb, int64_t q_sh,   \
                      int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,\
                      int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_sh,\
                      void* stream) {                                        \
    return repro_torch::launch<T>(q, k, v, lengths, out, batch, kv_heads,    \
                                  group, d, dv, smax, window, scale, q_sb,   \
                                  q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,  \
                                  o_sb, o_sh,                                \
                                  static_cast<cudaStream_t>(stream));        \
  }

REPRO_DECODE_ENTRY(decode_attention_f32, float)
REPRO_DECODE_ENTRY(decode_attention_bf16, __nv_bfloat16)
