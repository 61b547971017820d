// Decode attention for Hopper (sm_90a): one new token per batch row against
// a padded KV cache.
//
// Replaces the TPU kernel `decode_attention` of
// src/repro/kernels/decode_attention.py (body `_kernel`): the same
// function, with an online softmax over the keys [max(0, len - window), len),
// keys masked to kpos < len and the window, l clamped at 1e-20 so that a row
// of length 0 comes out as zeros.  The caches are read in the model's
// (B, S, KV, D) layout through their strides: no transposed copy is made.
//
// What bounds it on the H100: bytes.  Each key and value row of the valid
// prefix is read once and used by the whole GQA group: G query heads, 2*G
// flops per element read, far below the ~295 flops/byte the card needs to be
// bound by its tensor cores.  So the design's aim is to keep enough bytes in
// flight on every SM, and to spend few instructions on each byte.
//
// bf16 (tc::, split-KV on the tensor cores):
//  - The keys of each (row, KV head) are split across `splits` blocks, a
//    grid of (splits, KV x slices, B), where a slice is up to kSlice = 32
//    query rows of the GQA group (two m-tiles of 16): a group of any size
//    runs as ceil(G / 32) slices, each with the registers of G <= 32, and
//    each slice reads its (row, head)'s keys again, from L2 when the slices
//    run side by side.  The wrapper picks `splits` from the shapes
//    and the SM count alone (never from `lengths`, which stay on the card,
//    so that the call can be captured in a CUDA graph); each block reads
//    its row's length and takes an even share, in whole 16-key tiles, of
//    [lo, len), so rows of any length spread over all their blocks.  At
//    B = 8, KV = 8 on 132 SMs that is 5 splits (320 blocks: two resident
//    blocks an SM, 106 KB of shared memory each at D = 128), at one row of a
//    2048-key cache 16 (128 blocks of 128 keys).
//  - Inside a block each of 4 warps walks its own tiles of 16 keys through
//    a private ring of 3 shared-memory stages filled by cp.async (16-byte
//    copies straight from the cache's rows, rows past the share zero
//    filled), two tiles ahead of its compute; a warp waits on its own
//    copies only, so the loop has no block-wide barrier.  Shared rows are
//    padded by 16 bytes, so the 8 rows that one ldmatrix reads fall in 8
//    different bank groups.
//  - Both products run on mma.sync m16n8k16 (bf16 in, fp32 out): S = Q K^T
//    with the query group padded to 16 rows (32 for G > 16) as the A
//    operand and the key tile as B, then O += P V with P taken from S's
//    accumulators in registers (FlashAttention-2's fragment reuse) and V
//    read through ldmatrix.trans.  This is the simpler of the two Hopper
//    options: wgmma needs 64-row A operands, which only the swapped form
//    S^T = K Q^T (and P^T staged through shared memory) could fill, while
//    12 of the 16 rows that mma.sync computes for G = 4 are padding that
//    costs nothing in a kernel bound by bytes.  What matters is that the
//    per-byte FMAs and the fp32 staging of the earlier SIMT kernel leave
//    the CUDA cores.  The online softmax works in base 2 with the scale
//    folded in (one FFMA and one MUFU.EX2 a score), as the flash kernels.
//  - The 4 warps' partial softmaxes are merged in shared memory, then each
//    block writes its (acc, m, l) to a scratch tensor that the wrapper takes
//    from PyTorch's allocator; a second small kernel merges the splits of
//    each (row, head) in split order, as `_split_kv_decode` in
//    src/repro/models/attention.py writes it out: the largest m, then the
//    sums of l and acc rescaled to it.  Every sum has one fixed order and
//    there are no atomics, so two calls agree bit for bit.  With a single
//    split the block writes the output itself.
//
// fp32 (simt::): the tensor cores take no fp32 inputs at the 2e-5 the fp32
// checks hold, so fp32 keeps the CUDA-core kernel: one block of 128 threads
// per (batch row, KV head, slice of up to 32 query rows), key tiles of 32
// rows staged as fp32 in shared memory, scores, softmax and P.V as scalar
// FMA loops.

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace simt {

constexpr int kThreads = 128;
constexpr int kBlockK = 32;  // keys per tile: one per lane in the softmax step
constexpr int kWarps = kThreads / 32;

constexpr int kSlice = 32;  // query rows of the GQA group per block

// Slices of the group: the grid's y index is kv_head * slices + slice.
__host__ __device__ inline int group_slices(int group) {
  return (group + kSlice - 1) / kSlice;
}

// What a block's grid y index stands for: its KV head, the first query row
// of its slice within the group, and the slice's rows.
struct Slice {
  int kvh, g0, rows;
};

__device__ inline Slice slice_of(int y, int group) {
  const int slices = group_slices(group);
  const int g0 = (y % slices) * kSlice;
  return {y / slices, g0, min(kSlice, group - g0)};
}

// Dynamic shared memory, in floats:
//   ks [kBlockK][D + 1]  (the +1 keeps the score loop free of bank conflicts)
//   vs [kBlockK][Dv]
//   qs [R][D]            (pre-scaled queries; R = the slice's rows)
//   ps [R][kBlockK]      (scores, then probabilities)
//   acc [R][Dv]
//   m, l, corr [R] each
inline size_t smem_floats(int rows, int d, int dv) {
  return static_cast<size_t>(kBlockK) * (d + 1) + kBlockK * dv + rows * d +
         rows * kBlockK + rows * dv + 3 * rows;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int32_t* __restrict__ lengths, T* __restrict__ out, int group, int d,
    int dv, int smax, int window, float scale, int64_t q_sb, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, int64_t o_sb, int64_t o_sh) {
  constexpr int kVec = vec_width<T>();
  const Slice sl = slice_of(blockIdx.y, group);
  const int b = blockIdx.x, kvh = sl.kvh, rows = sl.rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int head0 = kvh * group + sl.g0;  // first query head of this slice

  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kBlockK * (d + 1);
  float* qs = vs + kBlockK * dv;
  float* ps = qs + rows * d;
  float* acc = ps + rows * kBlockK;
  float* m_s = acc + rows * dv;
  float* l_s = m_s + rows;
  float* c_s = l_s + rows;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int i = tid * kVec; i < rows * d; i += kThreads * kVec) {
    const int g = i / d, e = i % d;
    float tmp[kVec];
    load_vec(q + b * q_sb + (head0 + g) * q_sh + e, tmp);
#pragma unroll
    for (int j = 0; j < kVec; ++j) qs[i + j] = tmp[j] * scale;
  }
  for (int i = tid; i < rows * dv; i += kThreads) acc[i] = 0.f;
  for (int g = tid; g < rows; g += kThreads) {
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
    for (int i = tid; i < rows * kBlockK; i += kThreads) {
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
    for (int g = warp; g < rows; g += kWarps) {
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
    for (int i = tid; i < rows * dv; i += kThreads) {
      const int g = i / dv, e = i % dv;
      const float* pr = ps + g * kBlockK;
      float a = acc[i] * c_s[g];
      for (int j = 0; j < n; ++j) a = fmaf(pr[j], vs[j * dv + e], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < rows * dv; i += kThreads) {
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
  const size_t smem = smem_floats(group < kSlice ? group : kSlice, d, dv) * sizeof(float);
  cudaError_t err = allow_smem(decode_attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  decode_attention_kernel<T>
      <<<dim3(batch, kv_heads * group_slices(group)), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), group, d, dv,
      smax, window, scale, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
      o_sb, o_sh);
  return cudaGetLastError();
}


}  // namespace simt
}  // namespace repro_torch

namespace repro_torch {
namespace tc {

using bf16 = __nv_bfloat16;
using simt::group_slices;
using simt::Slice;
using simt::slice_of;
using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::ldmatrix_x4;
using hopper::ldmatrix_x4_trans;
using hopper::mma_bf16_16816;
using hopper::pack_bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 16;   // keys per warp tile: one k-step of P V
constexpr int kStages = 3;  // tiles in each warp's ring
constexpr int kPad = 8;     // bf16 elements past each shared row (16 bytes)

// Dynamic shared memory of one block, in bytes: each warp's ring of K and V
// tiles, which the merge of the warps' partial softmaxes reuses once the
// rings are drained (per warp 16 MT rows of DV accumulators, m and l), then
// the query group padded to 16 MT rows.
template <int D, int DV, int MT>
struct Smem {
  static constexpr int kRowK = D + kPad, kRowV = DV + kPad;  // elements
  static constexpr int kStage = kKeys * (kRowK + kRowV);     // elements
  static constexpr int kRing = kWarps * kStages * kStage * 2;
  static constexpr int kMergeRow = DV + 2;                   // floats
  static constexpr int kMerge = kWarps * 16 * MT * kMergeRow * 4;
  static constexpr int kQ = kRing > kMerge ? kRing : kMerge;
  static constexpr int kBytes = kQ + 16 * MT * kRowK * 2;
};

// One block per (split, KV head and slice of the group, batch row); the
// slice's rows sit in 16 MT rows of registers.  The launch bounds ask for
// one resident block, which leaves ptxas every register it may give a
// thread: without it, the D = 64, Dv = 32 variant spilled at 96 registers.  `c` = scale * log2(e): m
// holds max(S) * c and P = 2^(S c - m).  `part` holds, per (row, head,
// split, g), DV unnormalised accumulators, then after all of them (m, l).
template <int D, int DV, int MT>
__global__ void __launch_bounds__(kThreads, 1) decode_split_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int32_t* __restrict__ lengths,
    bf16* __restrict__ out, float* __restrict__ part, int group, int smax,
    int window, float c, int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
    int64_t o_sh) {
  using S = Smem<D, DV, MT>;
  extern __shared__ __align__(16) uint8_t decode_smem[];
  uint8_t* smem = decode_smem;
  bf16* qs = reinterpret_cast<bf16*>(smem + S::kQ);
  const int split = blockIdx.x, splits = gridDim.x, b = blockIdx.z;
  const int kvh = slice_of(blockIdx.y, group).kvh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane % 4, mi = lane / 8, mr = lane % 8;

  // this block's keys: an even share, in whole warp tiles, of [lo, hi)
  const int len = lengths[b];
  const int hi = min(max(len, 0), smax);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int n = max(hi - lo, 0);
  const int per = ((n + splits - 1) / splits + kKeys - 1) / kKeys * kKeys;
  const int start = lo + split * per;
  const int end = min(hi, start + per);
  const int tiles = end > start ? (end - start + kKeys - 1) / kKeys : 0;
  const int mine = tiles > warp ? (tiles - 1 - warp) / kWarps + 1 : 0;

  {  // the slice's query rows, rows past it zero
    const Slice sl = slice_of(blockIdx.y, group);
    const bf16* qb = q + b * q_sb + (kvh * group + sl.g0) * q_sh;
    for (int i = threadIdx.x; i < 16 * MT * (D / 8); i += kThreads) {
      const int r = i / (D / 8), ch = i % (D / 8);
      const bool live = r < sl.rows;
      cp_async16(qs + r * S::kRowK + 8 * ch, qb + (live ? r : 0) * q_sh + 8 * ch,
                 live);
    }
  }
  cp_async_commit();

  bf16* ring = reinterpret_cast<bf16*>(smem) + warp * kStages * S::kStage;
  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;
  // this warp's tile j (keys start + 16 (warp + 4 j) on) into its stage;
  // rows past `end` arrive as zeros.  Every call closes a group, so that
  // the groups in flight count the same in every iteration.
  auto load = [&](int j) {
    if (j < mine) {
      bf16* ks = ring + (j % kStages) * S::kStage;
      bf16* vs = ks + kKeys * S::kRowK;
      const int k0 = start + (warp + kWarps * j) * kKeys;
#pragma unroll
      for (int i = lane; i < kKeys * (D / 8); i += 32) {
        const int r = i / (D / 8), ch = i % (D / 8);
        const bool live = k0 + r < end;
        cp_async16(ks + r * S::kRowK + 8 * ch,
                   kb + (live ? k0 + r : start) * k_ss + 8 * ch, live);
      }
#pragma unroll
      for (int i = lane; i < kKeys * (DV / 8); i += 32) {
        const int r = i / (DV / 8), ch = i % (DV / 8);
        const bool live = k0 + r < end;
        cp_async16(vs + r * S::kRowV + 8 * ch,
                   vb + (live ? k0 + r : start) * v_ss + 8 * ch, live);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load(j);
  cp_async_wait<kStages - 1>();  // the query group has landed
  __syncthreads();

  // fragments (common.cuh): this lane holds rows 16 mt + lane / 4 + 8 rr
  float o[MT][DV / 8][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      m[mt][rr] = kNegInf;
      l[mt][rr] = 0.f;
    }
#pragma unroll
    for (int jn = 0; jn < DV / 8; ++jn)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[mt][jn][i] = 0.f;
  }

  for (int j = 0; j < mine; ++j) {
    cp_async_wait<kStages - 2>();  // this lane's copies of tile j are done
    __syncwarp();                  // and every lane's; stage j - 1 is free
    load(j + kStages - 1);
    const bf16* ks = ring + (j % kStages) * S::kStage;
    const bf16* vs = ks + kKeys * S::kRowK;
    const int k0 = start + (warp + kWarps * j) * kKeys;

    // S = Q K^T: keys 0-7 in s[.][0], 8-15 in s[.][1]
    float s[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 8; ++i) s[mt][i / 4][i % 4] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kf[4];  // (keys 0-7 | 8-15) x (d 0-7 | 8-15) of this k-step
      ldmatrix_x4(kf, ks + ((mi / 2) * 8 + mr) * S::kRowK + 16 * kk + (mi % 2) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t qf[4];
        ldmatrix_x4(qf, qs + (16 * mt + (mi % 2) * 8 + mr) * S::kRowK + 16 * kk +
                            (mi / 2) * 8);
        mma_bf16_16816(s[mt][0], qf, kf[0], kf[1]);
        mma_bf16_16816(s[mt][1], qf, kf[2], kf[3]);
      }
    }

    // online softmax in base 2; a row's 16 keys sit in the 4 lanes of a quad
    const bool edge = k0 + kKeys > end;
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][nt][2 * rr + e];
            if (edge && k0 + 8 * nt + 2 * quad + e >= end) x = -INFINITY;
            mx = fmaxf(mx, x);
          }
        const float m_new = fmaxf(m[mt][rr], group_max<4>(mx) * c);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][nt][2 * rr + e];
            x = exp2f(fmaf(x, c, -m_new));
            sum += x;
          }
        const float corr = exp2f(m[mt][rr] - m_new);
        l[mt][rr] = l[mt][rr] * corr + group_sum<4>(sum);
        m[mt][rr] = m_new;
#pragma unroll
        for (int jn = 0; jn < DV / 8; ++jn) {
          o[mt][jn][2 * rr] *= corr;
          o[mt][jn][2 * rr + 1] *= corr;
        }
      }
      // P as the A operand of P V: the two 8-key halves side by side
      pa[mt][0] = pack_bf16(s[mt][0][0], s[mt][0][1]);
      pa[mt][1] = pack_bf16(s[mt][0][2], s[mt][0][3]);
      pa[mt][2] = pack_bf16(s[mt][1][0], s[mt][1][1]);
      pa[mt][3] = pack_bf16(s[mt][1][2], s[mt][1][3]);
    }

    // O += P V, 16 value columns per ldmatrix
#pragma unroll
    for (int jj = 0; jj < DV / 16; ++jj) {
      uint32_t vf[4];  // (keys 0-7 | 8-15) x (columns 0-7 | 8-15), transposed
      ldmatrix_x4_trans(vf, vs + ((mi % 2) * 8 + mr) * S::kRowV + 16 * jj + (mi / 2) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16_16816(o[mt][2 * jj], pa[mt], vf[0], vf[1]);
        mma_bf16_16816(o[mt][2 * jj + 1], pa[mt], vf[2], vf[3]);
      }
    }
  }

  // merge the 4 warps' partial softmaxes in warp order
  cp_async_wait<0>();
  __syncthreads();  // every ring is drained: the merge rows reuse them
  float* mine_rows = reinterpret_cast<float*>(smem) + warp * 16 * MT * S::kMergeRow;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float* row = mine_rows + (16 * mt + lane / 4 + 8 * rr) * S::kMergeRow;
#pragma unroll
      for (int jn = 0; jn < DV / 8; ++jn) {
        row[8 * jn + 2 * quad] = o[mt][jn][2 * rr];
        row[8 * jn + 2 * quad + 1] = o[mt][jn][2 * rr + 1];
      }
      if (quad == 0) {
        row[DV] = m[mt][rr];
        row[DV + 1] = l[mt][rr];
      }
    }
  __syncthreads();
  const float* warp_rows = reinterpret_cast<const float*>(smem);
  // the slice again (recomputed here rather than held through the loop)
  const Slice sl = slice_of(blockIdx.y, group);
  const int rows = sl.rows, g0 = sl.g0, head0 = kvh * group + g0;
  const int kv_heads = gridDim.y / group_slices(group);
  const int64_t n_acc = int64_t(gridDim.z) * kv_heads * splits * group * DV;
  for (int i = threadIdx.x; i < rows * DV; i += kThreads) {
    const int g = i / DV, e = i % DV;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, warp_rows[(w * 16 * MT + g) * S::kMergeRow + DV]);
    float sum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* row = warp_rows + (w * 16 * MT + g) * S::kMergeRow;
      const float f = exp2f(row[DV] - mx);
      sum = fmaf(row[DV + 1], f, sum);
      acc = fmaf(row[e], f, acc);
    }
    if (splits == 1) {
      store(out + b * o_sb + (head0 + g) * o_sh + e, acc / fmaxf(sum, 1e-20f));
    } else {
      const int64_t slot =
          ((int64_t(b) * kv_heads + kvh) * splits + split) * group + g0 + g;
      part[slot * DV + e] = acc;
      if (e == 0) {
        part[n_acc + 2 * slot] = mx;
        part[n_acc + 2 * slot + 1] = sum;
      }
    }
  }
}

// One thread per (g, column) of a (KV head, batch row): the splits' partial
// softmaxes merged in split order into the output.  The loops over splits
// are unrolled so that several loads are in flight at once.
template <int DV>
__global__ void __launch_bounds__(128) decode_merge_kernel(
    const float* __restrict__ part, bf16* __restrict__ out, int group, int splits,
    int64_t o_sb, int64_t o_sh) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= group * DV) return;
  const int kvh = blockIdx.y, kv_heads = gridDim.y, b = blockIdx.z;
  const int g = i / DV, e = i % DV;
  const int64_t n_acc = int64_t(gridDim.z) * kv_heads * splits * group * DV;
  const int64_t slot0 = (int64_t(b) * kv_heads + kvh) * splits * group + g;
  const float* ml = part + n_acc;
  float mx = kNegInf;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[2 * (slot0 + s * group)]);
  float sum = 0.f, acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) {
    const int64_t slot = slot0 + s * group;
    const float f = exp2f(ml[2 * slot] - mx);
    sum = fmaf(ml[2 * slot + 1], f, sum);
    acc = fmaf(part[slot * DV + e], f, acc);
  }
  store(out + b * o_sb + (kvh * group + g) * o_sh + e, acc / fmaxf(sum, 1e-20f));
}

template <int D, int DV, int MT>
int launch(const void* q, const void* k, const void* v, const int32_t* lengths,
           void* out, float* part, int batch, int kv_heads, int group, int smax,
           int window, int splits, float scale, const int64_t* st,
           cudaStream_t stream) {
  constexpr int kBytes = Smem<D, DV, MT>::kBytes;
  cudaError_t err = allow_smem(decode_split_kernel<D, DV, MT>, kBytes);
  if (err != cudaSuccess) return err;
  decode_split_kernel<D, DV, MT>
      <<<dim3(splits, kv_heads * group_slices(group), batch), kThreads, kBytes,
         stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), lengths, static_cast<bf16*>(out), part,
          group, smax, window, scale * kLog2e, st[0], st[1], st[2], st[3], st[4],
          st[5], st[6], st[7], st[8], st[9]);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  decode_merge_kernel<DV><<<dim3((group * DV + 127) / 128, kv_heads, batch), 128, 0,
                            stream>>>(
      part, static_cast<bf16*>(out), group, splits, st[8], st[9]);
  return cudaGetLastError();
}

template <int D, int DV>
int dispatch_mt(const void* q, const void* k, const void* v, const int32_t* lengths,
                void* out, float* part, int batch, int kv_heads, int group,
                int smax, int window, int splits, float scale, const int64_t* st,
                cudaStream_t stream) {
  // a group above kSlice runs as slices of up to 32 rows: two m-tiles
  if (group <= 16)
    return launch<D, DV, 1>(q, k, v, lengths, out, part, batch, kv_heads, group,
                            smax, window, splits, scale, st, stream);
  return launch<D, DV, 2>(q, k, v, lengths, out, part, batch, kv_heads, group,
                          smax, window, splits, scale, st, stream);
}

template <int D>
int dispatch_dv(const void* q, const void* k, const void* v, const int32_t* lengths,
                void* out, float* part, int batch, int kv_heads, int group, int dv,
                int smax, int window, int splits, float scale, const int64_t* st,
                cudaStream_t stream) {
  switch (dv) {
    case 32:
      return dispatch_mt<D, 32>(q, k, v, lengths, out, part, batch, kv_heads, group,
                                smax, window, splits, scale, st, stream);
    case 64:
      return dispatch_mt<D, 64>(q, k, v, lengths, out, part, batch, kv_heads, group,
                                smax, window, splits, scale, st, stream);
    case 128:
      return dispatch_mt<D, 128>(q, k, v, lengths, out, part, batch, kv_heads, group,
                                 smax, window, splits, scale, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int dispatch(const void* q, const void* k, const void* v, const int32_t* lengths,
             void* out, float* part, int batch, int kv_heads, int group, int d,
             int dv, int smax, int window, int splits, float scale,
             const int64_t* st, cudaStream_t stream) {
  if (splits < 1 || (splits > 1 && part == nullptr)) return cudaErrorInvalidValue;
  switch (d) {
    case 32:
      return dispatch_dv<32>(q, k, v, lengths, out, part, batch, kv_heads, group, dv,
                             smax, window, splits, scale, st, stream);
    case 64:
      return dispatch_dv<64>(q, k, v, lengths, out, part, batch, kv_heads, group, dv,
                             smax, window, splits, scale, st, stream);
    case 128:
      return dispatch_dv<128>(q, k, v, lengths, out, part, batch, kv_heads, group,
                              dv, smax, window, splits, scale, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc
}  // namespace repro_torch

// q (B, KV, G, D) as (batch stride, head stride) with head = kv * G + g;
// caches (B, Smax, KV, D[v]) through their strides; out (B, KV, G, Dv)
// likewise to q.  Every last dimension is contiguous.  `strides` holds 10
// values: q (batch, head), k and v (batch, seq, head) each, out (batch,
// head).  Any G: the group runs in slices of up to 32 query rows.
// `splits` blocks share each (row, KV head, slice)'s keys, and `part` holds
// their partial softmaxes, B * KV * splits * G * (Dv + 2) floats (unused
// with one split, and by the fp32 kernel, which runs one block per (row, KV
// head, slice)).  Each entry returns its launch's cudaError_t.
extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const int32_t* lengths, void* out, float* part,
                                    int batch, int kv_heads, int group, int d,
                                    int dv, int smax, int window, int splits,
                                    float scale, const int64_t* strides,
                                    void* stream) {
  const int64_t* st = strides;
  return repro_torch::simt::launch<float>(
      q, k, v, lengths, out, batch, kv_heads, group, d, dv, smax, window, scale,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      static_cast<cudaStream_t>(stream));
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const int32_t* lengths, void* out, float* part,
                                     int batch, int kv_heads, int group, int d,
                                     int dv, int smax, int window, int splits,
                                     float scale, const int64_t* strides,
                                     void* stream) {
  return repro_torch::tc::dispatch(q, k, v, lengths, out, part, batch, kv_heads,
                                   group, d, dv, smax, window, splits, scale,
                                   strides, static_cast<cudaStream_t>(stream));
}
