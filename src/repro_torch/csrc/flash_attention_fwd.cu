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
// main path (S = 1024, D = 128) each K/V tile is reused by 128 query rows,
// hundreds of flops per byte, so the tensor cores' bf16 rate is the limit.
//
// bf16 design (flash_fwd_wgmma_kernel): one block per (query tile of 128
// rows, head, batch), the longest causal tiles launched first.  A producer
// warp loads the Q tile once and K/V tiles of 64 keys into a ring of two
// stages with TMA, straight from the model's (B, S, H|KV, D) layout
// through a 4-D tensor map (no transposed copy; rows past S arrive as
// zeros), each stage guarded by a full and an empty mbarrier.  Two
// consumer warpgroups own 64 query rows each: S = Q K^T is wgmma m64n64k16
// from shared memory; the masks (only on tiles that cross a mask's edge)
// and the online softmax (base 2, m and l in fp32) run on the accumulator
// fragments, a row's keys in the 4 lanes of a quad reduced by two
// shuffles; P is rounded to bf16 in registers and is the A operand of
// O += P V (m64nDk16, V read MN-major through the descriptor's transpose
// bit).  ptxas gives each of the 288 threads 168 registers, which hold
// the S and O accumulators and P at 64-key tiles without spills (128-key
// tiles spilled, with or without setmaxnreg moving registers from the
// producer to the consumers, and were no faster).  Shared memory at
// D = 128 is 32 KB for Q and 32 KB per K/V stage, 96 KB in all.
//
// fp32 (flash_fwd_kernel, unchanged): the tensor cores take no fp32 inputs
// at the 2e-5 the fp32 checks hold (TF32 keeps 10 mantissa bits), so fp32
// stays on the CUDA cores: 64 x 64 tiles staged as fp32 in shared memory,
// each of 256 threads owning a 4 x 4 block of the score tile.

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace simt {

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

}  // namespace simt
}  // namespace repro_torch


namespace repro_torch {
namespace tc {

using hopper::Tile;
using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                    // warpgroups, 64 rows each
constexpr int kThreads = 128 * kConsumers + 32;  // and one producer warp
constexpr int kBQ = 64 * kConsumers;             // query rows per block
constexpr int kBK = 64;                          // keys per tile
constexpr int kStages = 2;

template <int D>
struct Smem {
  using TQ = Tile<D, kBQ>;
  using TK = Tile<D, kBK>;  // K and V
  static constexpr int kQ = 0;
  static constexpr int kK = TQ::kBytes;
  static constexpr int kV = kK + kStages * TK::kBytes;
  static constexpr int kBars = kV + kStages * TK::kBytes;
  // q_full, full[kStages], empty[kStages]; then slack for the alignment
  static constexpr size_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// One key tile's step of the online softmax, in base 2: c = scale * log2(e),
// so m holds max(S) * c and P = 2^(S c - m).  sc[4 j + 2 rr + e] is row
// `row + 8 rr` (at position qpos + 8 rr), key k0 + 8 j + 2 quad + e
// (fragment layout in hopper.cuh); a row's keys sit in the 4 lanes of a
// quad.  With kMask, masked scores become -inf, so their P is 0 and a row
// with no key left keeps m at the finite NEG_INF.  On return sc holds P.
template <int D, bool kMask>
__device__ __forceinline__ void online_softmax(float (&sc)[kBK / 2],
                                               float (&o)[D / 2], float (&m)[2],
                                               float (&l)[2], float c, int k0,
                                               int qpos, int quad, int sk,
                                               int causal, int window) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float rowmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * rr + e];
        if (kMask) {
          const int kpos = k0 + 8 * j + 2 * quad + e, q = qpos + 8 * rr;
          const bool ok = kpos < sk && (!causal || kpos <= q) &&
                          (window <= 0 || kpos > q - window);
          x = ok ? x : -INFINITY;
        }
        rowmax = fmaxf(rowmax, x);
      }
    const float m_new = fmaxf(m[rr], group_max<4>(rowmax) * c);
    float rowsum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * rr + e];
        x = exp2f(fmaf(x, c, -m_new));
        rowsum += x;
      }
    const float corr = exp2f(m[rr] - m_new);
    l[rr] = l[rr] * corr + group_sum<4>(rowsum);
    m[rr] = m_new;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 2 * rr] *= corr;
      o[4 * j + 2 * rr + 1] *= corr;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_wgmma_kernel(
    __grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
    __grid_constant__ const CUtensorMap tv, bf16* __restrict__ out,
    float* __restrict__ lse, int group, int sq, int sk, int causal, int window,
    int q_offset, float scale, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int64_t l_sb, int64_t l_sh) {
  using TQ = Tile<D, kBQ>;
  using TK = Tile<D, kBK>;
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint8_t* qs = smem + S::kQ;
  uint8_t* ks = smem + S::kK;
  uint8_t* vs = smem + S::kV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // longest causal tiles first
  int t_lo, t_hi;
  hopper::key_tiles(q0, kBQ, sk, kBK, causal, window, q_offset, &t_lo, &t_hi);
  const int n = t_hi - t_lo;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128 * kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {  // the producer warp
    if (threadIdx.x == 128 * kConsumers) {
      const int kvh = h / group;
      hopper::mbar_expect_tx(q_full, TQ::kBytes);
      for (int c = 0; c < TQ::kChunks; ++c)
        hopper::tma_load(qs + c * TQ::kChunkBytes, &tq, q_full, c * TQ::kInner, q0,
                         h, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        if (i >= kStages) hopper::mbar_wait(&empty[s], (i / kStages - 1) & 1);
        hopper::mbar_expect_tx(&full[s], 2 * TK::kBytes);
        const int k0 = (t_lo + i) * kBK;
        for (int c = 0; c < TK::kChunks; ++c) {
          hopper::tma_load(ks + s * TK::kBytes + c * TK::kChunkBytes, &tk, &full[s],
                           c * TK::kInner, k0, kvh, b);
          hopper::tma_load(vs + s * TK::kBytes + c * TK::kChunkBytes, &tv, &full[s],
                           c * TK::kInner, k0, kvh, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows [64 wg, 64 wg + 64) of the block's tile; this
  // thread holds rows `row` and row + 8 (fragment layout in hopper.cuh)
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, quad = lane % 4;
  const int row = 64 * wg + 16 * warp + lane / 4;
  float o[D / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  const float c = scale * kLog2e;
  hopper::mbar_wait(q_full, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    hopper::mbar_wait(&full[s], (i / kStages) & 1);
    const uint8_t* kst = ks + s * TK::kBytes;
    const uint8_t* vst = vs + s * TK::kBytes;

    float sc[kBK / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      hopper::wgmma_ss<kBK>(sc, TQ::kmajor(qs, 64 * wg, k), TK::kmajor(kst, 0, k),
                            k > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::hold(sc);

    // masks (only where the tile crosses a mask's edge) and the online
    // softmax on the fragments
    const int k0 = (t_lo + i) * kBK;
    const int qa = q0 + 64 * wg + q_offset;  // the warpgroup's first position
    if (k0 + kBK > sk || (causal && k0 + kBK - 1 > qa) ||
        (window > 0 && k0 <= qa + 63 - window))
      online_softmax<D, true>(sc, o, m, l, c, k0, q0 + row + q_offset, quad, sk,
                              causal, window);
    else
      online_softmax<D, false>(sc, o, m, l, c, k0, 0, quad, 0, 0, 0);

    uint32_t pa[kBK / 16][4];
    hopper::to_a_frags<kBK / 16>(sc, pa);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k)
      hopper::wgmma_rs_tb<D>(o, pa[k], TK::mnmajor(vst, k), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::hold(o);
    hopper::hold(pa);
    hopper::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = q0 + row + 8 * rr;
    if (r >= sq) continue;
    const float ll = fmaxf(l[rr], 1e-20f);
    bf16* orow = out + b * o_sb + r * o_ss + h * o_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * quad) =
          __floats2bfloat162_rn(o[4 * j + 2 * rr] / ll, o[4 * j + 2 * rr + 1] / ll);
    // m back to base e; a row that saw no key keeps NEG_INF, as the plain
    // version's lse = NEG_INF + log(1e-20)
    const float m_e = m[rr] == kNegInf ? kNegInf : m[rr] * kLn2;
    if (quad == 0) lse[b * l_sb + h * l_sh + r] = m_e + logf(ll);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int batch, int heads, int group, int sq, int sk, int causal,
           int window, int q_offset, float scale, const int64_t* st,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = hopper::make_map(&tq, q, batch, sq, heads, D, st[0], st[1], st[2], kBQ);
  if (err == cudaSuccess)
    err = hopper::make_map(&tk, k, batch, sk, heads / group, D, st[3], st[4],
                           st[5], kBK);
  if (err == cudaSuccess)
    err = hopper::make_map(&tv, v, batch, sk, heads / group, D, st[6], st[7],
                           st[8], kBK);
  if (err != cudaSuccess) return err;
  const size_t smem = Smem<D>::kBytes;
  err = allow_smem(flash_fwd_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(heads, batch, (sq + kBQ - 1) / kBQ);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, group, sq, sk, causal, window,
      q_offset, scale, st[9], st[10], st[11], st[12], st[13]);
  return cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* out, float* lse,
             int batch, int heads, int group, int sq, int sk, int d, int causal,
             int window, int q_offset, float scale, const int64_t* st,
             cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<32>(q, k, v, out, lse, batch, heads, group, sq, sk, causal,
                        window, q_offset, scale, st, stream);
    case 64:
      return launch<64>(q, k, v, out, lse, batch, heads, group, sq, sk, causal,
                        window, q_offset, scale, st, stream);
    case 128:
      return launch<128>(q, k, v, out, lse, batch, heads, group, sq, sk, causal,
                         window, q_offset, scale, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc
}  // namespace repro_torch

// q (B, Sq, H, D), k/v (B, Sk, KV, D), out (B, Sq, H, D), all through
// strides with a contiguous last dimension; lse (B, H, Sq) fp32.
// `strides` holds 14 values: q, k, v, out as (batch, seq, head) each, then
// lse as (batch, head).  Each entry returns its launch's cudaError_t.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                       void* out, float* lse, int batch, int heads,
                                       int group, int sq, int sk, int d, int causal,
                                       int window, int q_offset, float scale,
                                       const int64_t* strides, void* stream) {
  return repro_torch::simt::dispatch<float>(
      q, k, v, out, lse, batch, heads, group, sq, sk, d, causal, window, q_offset,
      scale, strides, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                        void* out, float* lse, int batch, int heads,
                                        int group, int sq, int sk, int d, int causal,
                                        int window, int q_offset, float scale,
                                        const int64_t* strides, void* stream) {
  return repro_torch::tc::dispatch(q, k, v, out, lse, batch, heads, group, sq, sk,
                                   d, causal, window, q_offset, scale, strides,
                                   static_cast<cudaStream_t>(stream));
}
