// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `mamba_scan` of src/repro/kernels/mamba_scan.py
// (body `_kernel`): for each batch row b and channel d, over t = 0..S-1,
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t,   y_t = C_t . h_t + D * x_t,
// from h0 (zeros when absent), returning y (B, S, Di) in x's dtype and h_S
// (B, Di, N) in fp32.  dt, A, D and h0 are fp32; x, B and C share the model
// dtype (fp32 or bf16).
//
// What bounds it on the H100: at falcon-mamba's prefill shapes, the one
// exponent per (t, d, n) on the special-function unit (16 results per clock
// per SM) more than the bytes (x, dt and y once each); at decode (S = 1),
// the bytes of the fp32 state, read once and written once.
//
// Exponents: A * log2(e) is formed once per (d, n) when a block starts, so
// exp(dt A) is one MUFU.EX2 of dt * A2 (`ex2.approx.ftz`, relative error
// about 2^-22: the fp32 cases stay within their 5e-5).
//
// Prefill (scan_chunk_kernel), time-parallel.  The Pallas kernel walks a
// sequential grid axis of 128-step chunks with the state in VMEM; one block
// per channel group looping over all of S (the earlier design here) put
// only 256 blocks of 128 threads on the card at B = 1, Di = 8192, each
// walking 1024 dependent steps.  Now S is cut into `chunks` chunks of
// `chunk` steps (the wrapper picks them from the shapes and the SM count;
// S need not divide), and two launches cover them:
//  1. a local pass over chunks 0..chunks-2: chunk 0 from the true start
//     state h0, emitting its y; every other chunk from a zero state,
//     emitting only its end state and the sum of its dt;
//  2. a final pass over chunks 1..chunks-1: each block first forms its true
//     start state from chunk 0's end state, carried in chunk order through
//     the local end states, h <- h * 2^(A2 sum dt) + h_local, then rescans
//     its chunk from it, emitting y (and h_S in the last chunk).
// With one chunk (S short against the card) the local pass alone writes y
// and h_S.  The end states and dt sums live in a scratch tensor from
// PyTorch's allocator; nothing is summed by atomics, so two calls agree bit
// for bit.  The rescan costs 2 (chunks - 1) / chunks exponents per entry
// and step against the bound's one: the design's cost, not the card's.
// The kernel's time follows that count, so the wrapper takes no more
// chunks than fill the card.
//
// Inside a block: 32 channels of one batch row and chunk, each thread
// holding 8 of its channel's N fp32 state entries in registers (2 lanes a
// channel at N = 16), so a channel's dt, x and y cost little per entry.
// Tiles of 32 steps of x and dt (along Di) and of B and C (the rows of
// their (B, S, N) views, column slices of x_proj's output) arrive by
// cp.async into two shared-memory stages, the next tile in flight under
// the current tile's steps; bf16 B and C are widened to fp32 once per tile.
// Each lane stages its part of a step's C . h in shared memory, and once
// per tile the parts are summed in lane order and y stored coalesced.
//
// Decode (scan_step_kernel, S = 1): no staging; one thread per 4 entries
// of a (row, channel) reads h0 and A and writes h_S with 16-byte accesses,
// which is where the bytes bound lies.

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::ex2_approx;

constexpr int kChannels = 32;  // channels per block
constexpr int kStepEntries = 4;  // state entries per thread at S = 1
constexpr int kSteps = 32;     // time steps per shared-memory tile

// Elements in a 16-byte copy; B and C rows hold a whole number of them
// (the wrapper pads a row that does not).
template <typename T>
constexpr int kVecOf = 16 / static_cast<int>(sizeof(T));

template <typename T, int N>
struct Stage {
  static constexpr int kRowBC = N > kVecOf<T> ? N : kVecOf<T>;
  __align__(16) T x[kSteps][kChannels];
  __align__(16) float dt[kSteps][kChannels];
  __align__(16) T b[kSteps][kRowBC];
  __align__(16) T c[kSteps][kRowBC];
};

// State entries per thread in the prefill kernel: 8 (or all N when N < 8),
// so that a channel's per-step work (its dt and x, the y sum) is shared by
// as many entries as the registers allow.
template <int N>
constexpr int kEntriesOf = N < 8 ? N : 8;
template <int N>
constexpr int kChunkThreads = kChannels * N / kEntriesOf<N>;

// P consecutive floats (P a multiple of 4) at a 16-byte aligned address.
template <int P>
__device__ __forceinline__ void load_f4(const float* p, float (&v)[P]) {
#pragma unroll
  for (int j = 0; j < P; j += 4) {
    const float4 r = *reinterpret_cast<const float4*>(p + j);
    v[j] = r.x;
    v[j + 1] = r.y;
    v[j + 2] = r.z;
    v[j + 3] = r.w;
  }
}
template <int P>
__device__ __forceinline__ void store_f4(float* p, const float (&v)[P]) {
#pragma unroll
  for (int j = 0; j < P; j += 4)
    *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
}

// One block per (32 channels, chunk, batch row); `final_pass` selects the
// pass (see the top of the file).  h_part (B, chunks - 1, Di, N) and
// dt_part (B, chunks - 1, Di) hold the local pass's end states and dt sums.
template <typename T, int N>
__global__ void __launch_bounds__(kChunkThreads<N>) scan_chunk_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ bc,
    const T* __restrict__ cc, const float* __restrict__ dvec,
    const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ h_out,
    float* __restrict__ h_part, float* __restrict__ dt_part, int seq, int di,
    int chunk, int chunks, int final_pass, int64_t b_sb, int64_t b_ss,
    int64_t c_sb, int64_t c_ss) {
  constexpr int P = kEntriesOf<N>;        // state entries per thread
  constexpr int kLanes = N / P;           // lanes per channel
  constexpr int kThreads = kChunkThreads<N>;
  constexpr int kVec = kVecOf<T>;
  using St = Stage<T, N>;
  // bf16 B and C rows are widened to fp32 once per tile, not once per
  // thread and step
  constexpr bool kWiden = sizeof(T) == 2;
  __shared__ St stage[2];
  // each lane's part of a step's C . h, summed per channel once per tile
  __shared__ float ys[kSteps][kChannels][kLanes];
  __shared__ __align__(16) float bcw[kWiden ? 2 : 1][kWiden ? kSteps : 1][N];

  const int tid = threadIdx.x;
  const int ch = tid / kLanes;  // channel within the block
  const int lane = tid % kLanes, n0 = lane * P;
  const int d0 = blockIdx.x * kChannels, d = d0 + ch;
  const int b = blockIdx.z;
  const int c = blockIdx.y + final_pass;  // this block's chunk
  const bool live = d < di;
  const bool emit = final_pass || c == 0;
  const int64_t row0 = static_cast<int64_t>(b) * seq;  // (b, t) -> row0 + t
  const int64_t stride_part = static_cast<int64_t>(di) * N;
  const int64_t part0 = (static_cast<int64_t>(b) * (chunks - 1)) * stride_part;
  const int64_t entry = static_cast<int64_t>(d) * N + n0;  // (d, n0) in a state

  // dead channels (past Di) run on zeros and store nothing
  float a2[P], h[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    a2[j] = live ? A[entry + j] * kLog2e : 0.f;
    h[j] = 0.f;
  }
  if (live && c == 0 && h0 != nullptr) load_f4(h0 + b * stride_part + entry, h);
  if (live && final_pass) {  // carry: chunk 0's end state through chunks 1..c-1
    load_f4(h_part + part0 + entry, h);
    for (int k = 1; k < c; ++k) {
      const float sum_dt = dt_part[(static_cast<int64_t>(b) * (chunks - 1) + k) * di + d];
      float hl[P];
      load_f4(h_part + part0 + k * stride_part + entry, hl);
#pragma unroll
      for (int j = 0; j < P; ++j) h[j] = fmaf(ex2_approx(sum_dt * a2[j]), h[j], hl[j]);
    }
  }

  const float dv = live ? dvec[d] : 0.f;

  const int cs = c * chunk, ce = min(seq, cs + chunk);
  const int ntiles = (ce - cs + kSteps - 1) / kSteps;
  // tile i (steps cs + 32 i on) into stage s; channels past Di and steps
  // past the chunk arrive as zeros
  auto load = [&](int i, int s) {
    St& st = stage[s];
    const int t0 = cs + i * kSteps;
    constexpr int kX = kChannels / kVec, kDt = kChannels / 4;
    constexpr int kBC = St::kRowBC / kVec;
    for (int q = tid; q < kSteps * kX; q += kThreads) {
      const int t = q / kX, part = q % kX;
      const bool ok = t0 + t < ce && d0 + part * kVec < di;
      cp_async16(&st.x[t][part * kVec],
                 x + (row0 + (ok ? t0 + t : 0)) * di + (ok ? d0 + part * kVec : 0), ok);
    }
    for (int q = tid; q < kSteps * kDt; q += kThreads) {
      const int t = q / kDt, part = q % kDt;
      const bool ok = t0 + t < ce && d0 + part * 4 < di;
      cp_async16(&st.dt[t][part * 4],
                 dt + (row0 + (ok ? t0 + t : 0)) * di + (ok ? d0 + part * 4 : 0), ok);
    }
    for (int q = tid; q < kSteps * kBC; q += kThreads) {
      const int t = q / kBC, part = q % kBC;
      const bool ok = t0 + t < ce;
      const int64_t s_ = ok ? t0 + t : 0;
      cp_async16(&st.b[t][part * kVec], bc + b * b_sb + s_ * b_ss + part * kVec, ok);
      cp_async16(&st.c[t][part * kVec], cc + b * c_sb + s_ * c_ss + part * kVec, ok);
    }
    cp_async_commit();
  };

  float sum_dt = 0.f;
  load(0, 0);
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      load(i + 1, (i + 1) % 2);
    } else {
      cp_async_commit();  // an empty group keeps the count in step
    }
    cp_async_wait<1>();  // tile i has landed
    __syncthreads();
    const St& st = stage[i % 2];
    const int steps = min(kSteps, ce - cs - i * kSteps);
    const float *brow, *crow;  // rows of B and C as fp32, row_bc apart
    int row_bc;
    if constexpr (kWiden) {
      for (int q = tid; q < steps * N; q += kThreads) {
        bcw[0][q / N][q % N] = to_float(st.b[q / N][q % N]);
        bcw[1][q / N][q % N] = to_float(st.c[q / N][q % N]);
      }
      __syncthreads();
      brow = &bcw[0][0][0];
      crow = &bcw[1][0][0];
      row_bc = N;
    } else {
      brow = &st.b[0][0];
      crow = &st.c[0][0];
      row_bc = St::kRowBC;
    }
    if (emit) {
#pragma unroll 4
      for (int t = 0; t < steps; ++t) {
        const float dtv = st.dt[t][ch], xv = to_float(st.x[t][ch]);
        const float dtx = dtv * xv;
        float bj[P], cj[P];
        load_f4(brow + t * row_bc + n0, bj);
        load_f4(crow + t * row_bc + n0, cj);
        float acc = lane == 0 ? dv * xv : 0.f;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          h[j] = fmaf(ex2_approx(dtv * a2[j]), h[j], dtx * bj[j]);
          acc = fmaf(h[j], cj[j], acc);
        }
        ys[t][ch][lane] = acc;
      }
    } else {
#pragma unroll 4
      for (int t = 0; t < steps; ++t) {
        const float dtv = st.dt[t][ch];
        const float dtx = dtv * to_float(st.x[t][ch]);
        float bj[P];
        load_f4(brow + t * row_bc + n0, bj);
#pragma unroll
        for (int j = 0; j < P; ++j) h[j] = fmaf(ex2_approx(dtv * a2[j]), h[j], dtx * bj[j]);
        sum_dt += dtv;
      }
    }
    __syncthreads();  // the stage and ys are read; the next load may land
    if (emit) {  // y: the lanes' parts in lane order, coalesced along Di
      const int t0 = cs + i * kSteps;
      for (int q = tid; q < steps * kChannels; q += kThreads) {
        const int t = q / kChannels, cq = q % kChannels;
        float acc = 0.f;
#pragma unroll
        for (int l = 0; l < kLanes; ++l) acc += ys[t][cq][l];
        if (d0 + cq < di) store(y + (row0 + t0 + t) * di + d0 + cq, acc);
      }
    }
  }
  cp_async_wait<0>();

  if (!live) return;
  if (final_pass ? c == chunks - 1 : chunks == 1) {
    store_f4(h_out + b * stride_part + entry, h);
  } else if (!final_pass) {
    store_f4(h_part + part0 + c * stride_part + entry, h);
    if (lane == 0) dt_part[(static_cast<int64_t>(b) * (chunks - 1) + c) * di + d] = sum_dt;
  }
}

// S = 1: one thread per 4 state entries of a (row, channel).
template <typename T, int N>
__global__ void __launch_bounds__(256) scan_step_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ bc,
    const T* __restrict__ cc, const float* __restrict__ dvec,
    const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ h_out,
    int batch, int di, int64_t b_sb, int64_t b_sn, int64_t c_sb, int64_t c_sn) {
  constexpr int kLanes = N / kStepEntries;
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t bd = gid / kLanes;  // (row, channel)
  const int n0 = static_cast<int>(gid % kLanes) * kStepEntries;
  const bool live = bd < static_cast<int64_t>(batch) * di;
  const int b = live ? static_cast<int>(bd / di) : 0;
  const int d = live ? static_cast<int>(bd % di) : 0;
  const int64_t entry = bd * N + n0;

  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), h = a;
  float xv = 0.f, dtv = 0.f, bj[kStepEntries] = {}, cj[kStepEntries] = {};
  if (live) {
    a = *reinterpret_cast<const float4*>(A + static_cast<int64_t>(d) * N + n0);
    if (h0 != nullptr) h = *reinterpret_cast<const float4*>(h0 + entry);
    xv = to_float(x[bd]);
    dtv = dt[bd];
#pragma unroll
    for (int j = 0; j < kStepEntries; ++j) {
      bj[j] = to_float(bc[b * b_sb + (n0 + j) * b_sn]);
      cj[j] = to_float(cc[b * c_sb + (n0 + j) * c_sn]);
    }
  }
  const float dtx = dtv * xv;
  float hv[kStepEntries] = {h.x, h.y, h.z, h.w};
  const float av[kStepEntries] = {a.x, a.y, a.z, a.w};
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kStepEntries; ++j) {
    hv[j] = fmaf(ex2_approx(dtv * (av[j] * kLog2e)), hv[j], dtx * bj[j]);
    acc = fmaf(hv[j], cj[j], acc);
  }
  acc = group_sum<kLanes>(acc);
  if (!live) return;
  *reinterpret_cast<float4*>(h_out + entry) = make_float4(hv[0], hv[1], hv[2], hv[3]);
  if (n0 == 0) store(y + bd, fmaf(dvec[d], xv, acc));
}

template <typename T, int N>
cudaError_t launch_n(const void* x, const void* dt, const void* A,
                     const void* bc, const void* cc, const void* dvec,
                     const void* h0, void* y, void* h_out, void* h_part,
                     void* dt_part, int batch, int seq, int di, int chunk,
                     int chunks, const int64_t* st, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const T* bt = static_cast<const T*>(bc);
  const T* ct = static_cast<const T*>(cc);
  const float* df = static_cast<const float*>(dvec);
  const float* h0f = static_cast<const float*>(h0);
  T* yt = static_cast<T*>(y);
  float* hf = static_cast<float*>(h_out);
  if (seq == 1) {
    const int64_t threads = static_cast<int64_t>(batch) * di * (N / kStepEntries);
    scan_step_kernel<T, N><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
        xt, dtf, af, bt, ct, df, h0f, yt, hf, batch, di, st[0], st[2], st[3], st[5]);
    return cudaGetLastError();
  }
  if (chunks < 1 || static_cast<int64_t>(chunk) * chunks < seq ||
      (chunks > 1 && (h_part == nullptr || dt_part == nullptr)))
    return cudaErrorInvalidValue;
  constexpr int kThreads = kChunkThreads<N>;
  const int blocks = (di + kChannels - 1) / kChannels;
  float* hp = static_cast<float*>(h_part);
  float* dp = static_cast<float*>(dt_part);
  scan_chunk_kernel<T, N><<<dim3(blocks, chunks > 1 ? chunks - 1 : 1, batch), kThreads,
                            0, stream>>>(xt, dtf, af, bt, ct, df, h0f, yt, hf, hp, dp,
                                         seq, di, chunk, chunks, 0, st[0], st[1],
                                         st[3], st[4]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  scan_chunk_kernel<T, N><<<dim3(blocks, chunks - 1, batch), kThreads, 0, stream>>>(
      xt, dtf, af, bt, ct, df, h0f, yt, hf, hp, dp, seq, di, chunk, chunks, 1, st[0],
      st[1], st[3], st[4]);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* bc,
           const void* cc, const void* dvec, const void* h0, void* y,
           void* h_out, void* h_part, void* dt_part, int batch, int seq, int di,
           int n, int chunk, int chunks, const int64_t* st, cudaStream_t stream) {
#define REPRO_SCAN_CASE(NN)                                                    \
  case NN:                                                                     \
    return launch_n<T, NN>(x, dt, A, bc, cc, dvec, h0, y, h_out, h_part,       \
                           dt_part, batch, seq, di, chunk, chunks, st, stream);
  switch (n) {
    REPRO_SCAN_CASE(4)
    REPRO_SCAN_CASE(8)
    REPRO_SCAN_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_SCAN_CASE
}

}  // namespace
}  // namespace repro_torch

// x, dt, y (B, S, Di), A (Di, N), D (Di,), h0 and h_out (B, Di, N), all
// contiguous and 16-byte aligned; B and C (B, S, N) through `strides`, 6
// values: B's (batch, seq, n) then C's, in elements.  At S > 1, Di is a
// multiple of 8 and B and C rows are 16-byte aligned runs of whole 16-byte
// vectors (n stride 1); S is cut into `chunks` chunks of `chunk` steps,
// h_part (B, chunks - 1, Di, N) and dt_part (B, chunks - 1, Di) are fp32
// scratch (unused with one chunk).  h0 may be null (zeros).  N is 4, 8 or
// 16.  Each entry returns its launch's cudaError_t.
#define REPRO_SCAN_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* x, const void* dt, const void* A,            \
                      const void* bc, const void* cc, const void* dvec,        \
                      const void* h0, void* y, void* h_out, void* h_part,      \
                      void* dt_part, int batch, int seq, int di, int n,        \
                      int chunk, int chunks, const int64_t* strides,           \
                      void* stream) {                                          \
    return repro_torch::launch<T>(x, dt, A, bc, cc, dvec, h0, y, h_out,        \
                                  h_part, dt_part, batch, seq, di, n, chunk,   \
                                  chunks, strides,                             \
                                  static_cast<cudaStream_t>(stream));          \
  }

REPRO_SCAN_ENTRY(mamba_scan_f32, float)
REPRO_SCAN_ENTRY(mamba_scan_bf16, __nv_bfloat16)
