// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `mamba_scan` of src/repro/kernels/mamba_scan.py
// (body `_kernel`): for each batch row b and channel d, over t = 0..S-1,
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t,   y_t = C_t . h_t + D * x_t,
// from h0 (zeros when absent), returning y (B, S, Di) in x's dtype and h_S
// (B, Di, N) in fp32.  dt, A, D and h0 are fp32; x, B and C share the model
// dtype (fp32 or bf16).
//
// What bounds it on the H100: at falcon-mamba's prefill shapes, the one exp
// per (t, d, n) on the SFU (16 results per clock per SM) more than the bytes
// (x, dt and y once each); at decode (S = 1), the bytes of the fp32 state,
// read once and written once.
//
// Design: the Pallas kernel walks a sequential grid axis of 128-step chunks
// with the (512, N) state in VMEM, padding S and masking the pad.  Here one
// block owns 32 channels of one batch row and loops over all of S itself,
// each thread holding 4 of its channel's N fp32 state entries in registers,
// N/4 neighbouring lanes per channel.  No step is padded, and h_S is written
// once at the end.  Four entries a thread is the middle of two extremes: one
// thread per channel gives 8192 threads at B = 1 (64 blocks of 128 on 132
// SMs, one warp per scheduler), and one entry a thread (16 lanes per
// channel) spends four shuffles and four shared-memory loads per entry and
// step; here the card gets 256 blocks of 128 threads at B = 1, N = 16, and
// each step costs 2 float4 loads and 2 shuffles per 4 entries.  Tiles of 64
// steps of x and dt (read coalesced along Di) and of B and C (read through
// their strides: they are column slices of x_proj's output, shared by all
// channels of a row) are staged in shared memory; each step's y is summed
// over the lanes of a channel with shuffles, staged, and stored coalesced
// once per tile.  exp is the accurate expf: the fp32 cases are held at 5e-5.
// A chunked parallel scan over S, TMA staging and a pipelined tile loop are
// later work.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kChannels = 32;   // channels per block
constexpr int kPerThread = 4;   // state entries per thread
constexpr int kSteps = 64;      // time steps per shared-memory tile

template <typename T, int N>
__global__ void __launch_bounds__(kChannels * N / kPerThread) mamba_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ bc,
    const T* __restrict__ cc, const float* __restrict__ dvec,
    const float* __restrict__ h0, T* __restrict__ y,
    float* __restrict__ h_out, int seq, int di, int64_t b_sb, int64_t b_ss,
    int64_t b_sn, int64_t c_sb, int64_t c_ss, int64_t c_sn) {
  constexpr int kLanes = N / kPerThread;  // lanes per channel
  constexpr int kThreads = kChannels * kLanes;
  __shared__ float xs[kSteps][kChannels];
  __shared__ float dts[kSteps][kChannels];
  __shared__ float ys[kSteps][kChannels];
  __shared__ __align__(16) float bs[kSteps][N];
  __shared__ __align__(16) float cs[kSteps][N];

  const int tid = threadIdx.x;
  const int ch = tid / kLanes;    // channel within the block
  const int n0 = (tid % kLanes) * kPerThread;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + ch;
  const bool live = d < di;
  const int64_t state0 = (static_cast<int64_t>(b) * di + d) * N + n0;

  // dead channels (past Di) run on zeros, so every lane takes the shuffles
  float a[kPerThread], h[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    a[j] = live ? A[static_cast<int64_t>(d) * N + n0 + j] : 0.f;
    h[j] = (live && h0 != nullptr) ? h0[state0 + j] : 0.f;
  }
  const float dv = live ? dvec[d] : 0.f;
  const int64_t row0 = static_cast<int64_t>(b) * seq;  // (b, t) -> row0 + t

  for (int t0 = 0; t0 < seq; t0 += kSteps) {
    const int steps = min(kSteps, seq - t0);
    for (int i = tid; i < kSteps * kChannels; i += kThreads) {
      const int t = i / kChannels, c = i % kChannels;
      float xv = 0.f, dtv = 0.f;
      if (t < steps && d0 + c < di) {
        const int64_t off = (row0 + t0 + t) * di + d0 + c;
        xv = to_float(x[off]);
        dtv = dt[off];
      }
      xs[t][c] = xv;
      dts[t][c] = dtv;
    }
    for (int i = tid; i < kSteps * N; i += kThreads) {
      const int t = i / N, n = i % N;
      float bv = 0.f, cv = 0.f;
      if (t < steps) {
        const int64_t s = t0 + t;
        bv = to_float(bc[b * b_sb + s * b_ss + n * b_sn]);
        cv = to_float(cc[b * c_sb + s * c_ss + n * c_sn]);
      }
      bs[t][n] = bv;
      cs[t][n] = cv;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      const float dtv = dts[t][ch], xv = xs[t][ch];
      const float dtx = dtv * xv;
      const float4 bv = *reinterpret_cast<const float4*>(&bs[t][n0]);
      const float4 cv = *reinterpret_cast<const float4*>(&cs[t][n0]);
      const float bj[kPerThread] = {bv.x, bv.y, bv.z, bv.w};
      const float cj[kPerThread] = {cv.x, cv.y, cv.z, cv.w};
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        h[j] = fmaf(expf(dtv * a[j]), h[j], dtx * bj[j]);
        acc = fmaf(h[j], cj[j], acc);
      }
      acc = group_sum<kLanes>(acc);
      if (n0 == 0) ys[t][ch] = fmaf(dv, xv, acc);
    }
    __syncthreads();

    for (int i = tid; i < steps * kChannels; i += kThreads) {
      const int t = i / kChannels, c = i % kChannels;
      if (d0 + c < di) store(y + (row0 + t0 + t) * di + d0 + c, ys[t][c]);
    }
    __syncthreads();  // the next tile overwrites the staged steps
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) h_out[state0 + j] = h[j];
  }
}

template <typename T, int N>
cudaError_t launch_n(const void* x, const void* dt, const void* A,
                     const void* bc, const void* cc, const void* dvec,
                     const void* h0, void* y, void* h_out, int batch, int seq,
                     int di, int64_t b_sb, int64_t b_ss, int64_t b_sn,
                     int64_t c_sb, int64_t c_ss, int64_t c_sn,
                     cudaStream_t stream) {
  const dim3 grid((di + kChannels - 1) / kChannels, batch);
  mamba_scan_kernel<T, N><<<grid, kChannels * N / kPerThread, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(bc),
      static_cast<const T*>(cc), static_cast<const float*>(dvec),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_out), seq, di, b_sb, b_ss, b_sn, c_sb, c_ss, c_sn);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* bc,
           const void* cc, const void* dvec, const void* h0, void* y,
           void* h_out, int batch, int seq, int di, int n, int64_t b_sb,
           int64_t b_ss, int64_t b_sn, int64_t c_sb, int64_t c_ss,
           int64_t c_sn, cudaStream_t stream) {
#define REPRO_SCAN_CASE(NN)                                                  \
  case NN:                                                                   \
    return launch_n<T, NN>(x, dt, A, bc, cc, dvec, h0, y, h_out, batch, seq, \
                           di, b_sb, b_ss, b_sn, c_sb, c_ss, c_sn, stream);
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
// contiguous; B and C (B, S, N) through their strides (elements).  h0 may be
// null (zeros).  N is 4, 8 or 16.  Returns the launch's cudaError_t.
#define REPRO_SCAN_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* x, const void* dt, const void* A,          \
                      const void* bc, const void* cc, const void* dvec,      \
                      const void* h0, void* y, void* h_out, int batch,       \
                      int seq, int di, int n, int64_t b_sb, int64_t b_ss,    \
                      int64_t b_sn, int64_t c_sb, int64_t c_ss,              \
                      int64_t c_sn, void* stream) {                          \
    return repro_torch::launch<T>(x, dt, A, bc, cc, dvec, h0, y, h_out,      \
                                  batch, seq, di, n, b_sb, b_ss, b_sn, c_sb, \
                                  c_ss, c_sn,                                \
                                  static_cast<cudaStream_t>(stream));        \
  }

REPRO_SCAN_ENTRY(mamba_scan_f32, float)
REPRO_SCAN_ENTRY(mamba_scan_bf16, __nv_bfloat16)
