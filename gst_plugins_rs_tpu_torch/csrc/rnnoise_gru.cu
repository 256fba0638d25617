// Kernel R1: the RNNoise GRU stack over a buffer's frames, for Hopper.
//
// Replaces the GRU scan of the JAX package: gst_plugins_rs_tpu/ops/rnnoise.py
// ::rnn_frame (:309; the RNNoise-ordered GRU `_gru` :144) scanned by
// ::denoise_frames_fast (:510-521), which holds a channel's state on a silent
// frame and forces its VAD to 0.  Per frame and channel: dense 42 -> 24
// (tanh), the VAD GRU (24, tanh), the noise GRU (48, ReLU, input [dense,
// vad_h, features]), the denoise GRU (96, ReLU, input [vad_h, noise_h,
// features]), 22 sigmoid band gains and a sigmoid VAD.  The GRU applies r to
// h @ U before the add, h~ = act(x W_h + b_h + r * (h U_h)): cuDNN's form
// with no recurrent bias, but two of the three GRUs take ReLU where cuDNN
// takes only tanh, and dense layers and concatenations sit between them, so
// no library call computes the stack.  Weights in the JAX layout: W [in,
// 3*size], U [size, 3*size], gates packed [z | r | h~].
//
// What bounds it on an H100.  A frame and channel is 86,952 multiply-adds
// (2.6 ns at 67 TFLOP/s f32) and the weights are 350 KB, so the bound of the
// function is tiny; what binds a kernel is the recurrence.  One call is two
// kernel launches on the caller's stream:
//
//  1. rnnoise_hoist_kernel: everything that does not depend on the state,
//     for every frame and channel (silent or not), over a grid of K x C rows
//     (8 rows a block, one output column a thread, each weight read once a
//     block): dense = tanh(features @ input_dense_w + b) and
//       Xv = dense @ vad_gru_w + vad_gru_b                          [72]
//       Xn = dense @ noise_gru_w[0:24] + features @ noise_gru_w[48:90]
//            + noise_gru_b                                          [144]
//       Xd = features @ denoise_gru_w[72:114] + denoise_gru_b       [288]
//     into a [K, C, 504] scratch the wrapper allocates.  Parallel over
//     frames, it spreads over many SMs.
//  2. rnnoise_gru_kernel: the recurrence, one block of 288 threads a
//     channel (so N streams sit on N SMs), the frame loop inside.  What is
//     left on the chain is 24 (VAD) + 24 + 48 (noise) + 72 + 96 (denoise)
//     = 264 terms a frame, where the whole stack is 534.  Each block loads
//     its chain weights once, 250,464 B from L2:
//      - thread t holds column t of denoise_gru_u, 96 floats, in registers;
//      - denoise_gru_w[0:72] (vad_h, noise_h), vad_gru_u,
//        noise_gru_w[24:48], noise_gru_u, denoise_output_w and
//        vad_output_w, 34,968 floats (139,872 B), in dynamic shared memory,
//        as float4 groups of four rows so a thread reads four terms of its
//        column in one load.
//     Nine warps put three on one SM sub-partition (16,384 registers), so
//     a thread may use 168 registers, not 224: with denoise_gru_w[0:72] in
//     registers too (168 floats a thread) ptxas spilled 220 bytes a thread.
//     This placement uses 168 registers and spills 36 bytes a thread (the
//     prefetched hoisted values).  The states and every input vector are
//     read as float4 broadcasts.  A frame is five stages, each ending at a
//     barrier; the chain runs through them and the rest runs beside it on
//     other warps:
//       a the VAD GRU's update (warp 8) || den_h @ U_d (registers, warps
//         0-7) and the band gains of the last frame that ran (4 threads a
//         band, 24 rows each: den_h is not written again until e);
//       b vad_h @ noise_gru_w[24:48] + Xn (threads 0-143) || vad_h @
//         denoise_gru_w[0:24] for the rows of threads 144-287;
//       c the noise GRU's update (threads 192-239) || the same product for
//         rows 0-143, den_h @ U_d for warp 8, this frame's VAD;
//       d noise_h @ denoise_gru_w[24:72] (every row), the hoisted term added
//         last;
//       e the denoise GRU's update (warps 0-2) || the next frame's vad_h @
//         vad_gru_u and noise_h @ noise_gru_u (a silent frame changes
//         neither state, so they hold for the next frame that runs).
//     Xn, Xv and the silence flag of frame k + 1 are loaded while frame k
//     runs, Xd at the top of its frame, all by coherent loads after
//     griddepcontrol.wait (ld_hoisted).  The gains and the VAD are off the
//     chain: nothing later reads them.
//
// Per-frame floor of the recurrence, a reckoning (not a measurement):
// shared-memory wavefronts (128 B a cycle per SM) are the largest part:
// 1,093 for the shared weights (34,968 floats), ~510 for the float4
// broadcasts of the states and inputs (a warp reads each vector it needs:
// 42 loads a warp for the denoise GRU on 9 warps, the rest for the smaller
// products) and ~80 for the gate buffers: ~1,680 cycles.  The register FMA
// chain is 96 / 4 partial sums = 24 dependent FMAs (~100 cycles, under the
// wavefronts).  Five barriers (~30 cycles each) and three gate updates on
// the chain (two sigmoids and a tanh or ReLU, ~100 cycles each) add ~450:
// ~2,130 cycles, ~1.08 us a frame at 1.98 GHz (chip_smoke.py
// R1_FRAME_CYCLES).  Measured, a frame takes about twice that (PERF.md).
//
// A silent frame (of a channel) skips the network: the state is held, the
// VAD written 0 and the gains 1; its hoisted values are never read.  The
// state enters from h0 and leaves in h1 (device tensors): nothing goes to
// the host, and neither launch allocates or synchronises, so a CUDA graph
// can take both.  Built without -fmad=false (the dot products contract to
// FMAs; the gate math rounds as the plain version does): the kernel agrees
// with its plain version to float rounding (hoisted sums, other summation
// order, expf/tanhf), not bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFeat = 42;
constexpr int kFeatPad = 44;  // a feature row in shared memory, float4-aligned
constexpr int kDense = 24;
constexpr int kVad = 24;
constexpr int kNoise = 48;
constexpr int kDen = 96;
constexpr int kBands = 22;
constexpr int kThreads = 3 * kDen;  // 288: one a gate row of the denoise GRU

// the hoisted products of a frame and channel: [Xv 72 | Xn 144 | Xd 288]
constexpr int kXv = 0;
constexpr int kXn = kXv + 3 * kVad;
constexpr int kXd = kXn + 3 * kNoise;
constexpr int kX = kXd + 3 * kDen;  // 504
constexpr int kHoistRows = 8;       // frames x channels a block
constexpr int kHoistThreads = 512;  // >= kX, one output column a thread

// the denoise GRU's chain input rows of W (vad_h, noise_h), in shared memory
// (its U rows are in registers)
constexpr int kDenIn = kVad + kNoise;  // 72

// dynamic shared memory of the recurrence (floats), each matrix [n, m] as
// float4 groups of four rows: W4[(i / 4) * m + col] holds rows i..i+3
constexpr int kSmUv = 0;                            // vad_gru_u [24, 72]
constexpr int kSmWn = kSmUv + kVad * 3 * kVad;      // noise_gru_w[24:48] [24, 144]
constexpr int kSmUn = kSmWn + kVad * 3 * kNoise;    // noise_gru_u [48, 144]
constexpr int kSmWo = kSmUn + kNoise * 3 * kNoise;  // denoise_output_w [96, 22]
constexpr int kSmWvo = kSmWo + kDen * kBands;       // vad_output_w [24, 1]
constexpr int kSmWd = kSmWvo + kVad;                // denoise_gru_w[0:72] [72, 288]
constexpr int kSmFloats = kSmWd + kDenIn * 3 * kDen;  // 34,968
constexpr int kSmBytes = kSmFloats * 4;               // 139,872

// thread roles of the recurrence (thread t is also row t of the denoise GRU)
constexpr int kNoiseRows = 3 * kNoise;        // threads 0-143: the noise GRU's input rows
constexpr int kGain0 = 32;                    // threads 32-119: the band gains
constexpr int kGainParts = 4;                 // threads a band
constexpr int kGainRows = kDen / kGainParts;  // 24 rows each
constexpr int kVadURow0 = 96;                 // threads 96-167: the VAD GRU's U rows
constexpr int kNoiseURow0 = 144;              // threads 144-287: the noise GRU's U rows
constexpr int kVadHead = 160;                 // the thread of the VAD output
constexpr int kNoiseGate0 = 192;              // threads 192-239: the noise GRU's units
constexpr int kVadGate0 = 256;                // threads 256-279 (warp 8): the VAD GRU's units

// the 15 weight arrays, in WEIGHT_KEYS order
enum {
  kInW, kInB, kVadW, kVadU, kVadB, kNoiseW, kNoiseU, kNoiseB, kDenW, kDenU, kDenB,
  kOutW, kOutB, kVadOutW, kVadOutB, kNumWeights
};

struct Weights {
  const float* p[kNumWeights];
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float sum4(const float (&a)[4]) {
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// ---------------------------------------------------------------------------
// 1. The hoisted products
// ---------------------------------------------------------------------------

// acc[r][i % 4] += in[r * stride + i] * W[i * ld + col] for i < N and every
// row r of the block; in is 16-byte aligned, stride a multiple of 4
template <int N>
__device__ __forceinline__ void rows_dot(float (&acc)[kHoistRows][4], const float* in, int stride,
                                         const float* __restrict__ W, int ld, int col) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    float w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = (i + j < N) ? __ldg(W + (i + j) * ld + col) : 0.0f;
#pragma unroll
    for (int r = 0; r < kHoistRows; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(in + r * stride + i);
      acc[r][0] = fmaf(v.x, w[0], acc[r][0]);
      if (i + 1 < N) acc[r][1] = fmaf(v.y, w[1], acc[r][1]);
      if (i + 2 < N) acc[r][2] = fmaf(v.z, w[2], acc[r][2]);
      if (i + 3 < N) acc[r][3] = fmaf(v.w, w[3], acc[r][3]);
    }
  }
}

__global__ void __launch_bounds__(kHoistThreads)
rnnoise_hoist_kernel(const float* __restrict__ features, Weights w, int rows,
                     float* __restrict__ X) {
  __shared__ __align__(16) float feat[kHoistRows * kFeatPad];
  __shared__ __align__(16) float dense[kHoistRows * kDense];
  // the recurrence may start its prologue now (it waits for this grid's
  // results before it reads them)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * kHoistRows;
  const int n = min(kHoistRows, rows - row0);
  for (int i = t; i < kHoistRows * kFeatPad; i += kHoistThreads) {
    const int r = i / kFeatPad, j = i - r * kFeatPad;
    feat[i] = (r < n && j < kFeat) ? features[(size_t)(row0 + r) * kFeat + j] : 0.0f;
  }
  __syncthreads();
  if (t < kHoistRows * kDense) {
    const int r = t / kDense, j = t - r * kDense;
    const float* in = feat + r * kFeatPad;
    const float* __restrict__ W = w.p[kInW];
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kFeat; ++i) a[i & 3] = fmaf(in[i], __ldg(W + i * kDense + j), a[i & 3]);
    dense[t] = tanhf(sum4(a) + w.p[kInB][j]);
  }
  __syncthreads();
  if (t >= kX) return;
  float acc[kHoistRows][4];
#pragma unroll
  for (int r = 0; r < kHoistRows; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
  float bias;
  if (t < kXn) {  // Xv
    rows_dot<kDense>(acc, dense, kDense, w.p[kVadW], 3 * kVad, t);
    bias = w.p[kVadB][t];
  } else if (t < kXd) {  // Xn: rows 0:24 (dense) and 48:90 (features)
    const int col = t - kXn;
    rows_dot<kDense>(acc, dense, kDense, w.p[kNoiseW], 3 * kNoise, col);
    rows_dot<kFeat>(acc, feat, kFeatPad, w.p[kNoiseW] + (kDense + kVad) * 3 * kNoise,
                    3 * kNoise, col);
    bias = w.p[kNoiseB][col];
  } else {  // Xd: rows 72:114 (features)
    const int col = t - kXd;
    rows_dot<kFeat>(acc, feat, kFeatPad, w.p[kDenW] + kDenIn * 3 * kDen, 3 * kDen, col);
    bias = w.p[kDenB][col];
  }
#pragma unroll
  for (int r = 0; r < kHoistRows; ++r)
    if (r < n) X[(size_t)(row0 + r) * kX + t] = sum4(acc[r]) + bias;
}

// ---------------------------------------------------------------------------
// 2. The recurrence
// ---------------------------------------------------------------------------

// src [n, m] (row-major, global) into dst as float4 groups of four rows,
// by asynchronous copies: every copy of a thread is in flight at once
// (complete after cp.async.wait_all and a barrier)
__device__ __forceinline__ void stage_groups(float* dst, const float* __restrict__ src, int n,
                                             int m) {
  for (int idx = threadIdx.x; idx < n * m; idx += kThreads) {
    const int i = idx / m, j = idx - i * m;
    const unsigned d = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + ((i >> 2) * m + j) * 4 + (i & 3)));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src + idx)
                 : "memory");
  }
}

// A value of the hoisted products, which the grid launched before this one
// writes while this one's prologue runs: a coherent load (L2, not the
// read-only path), through a pointer that is not __restrict__, so nothing
// lets the compiler take it for read-only memory and move it above
// griddepcontrol.wait.  Through __ldg and a __restrict__ X, the compiler
// issued frame 0's Xn and Xv loads (LDG.E.CONSTANT) before the barrier
// and before ACQBULK, the instruction griddepcontrol.wait becomes, and a
// few calls in 8,000 (C = 16, enqueued back to back) read what an earlier
// allocation had left in the scratch (ROADMAP C.2)
__device__ __forceinline__ float ld_hoisted(const float* p) { return __ldcg(p); }

// a[i % 4] += h[i] * W[i, col] over N rows (N % 4 == 0); W4 in the group
// layout with m columns, h 16-byte aligned
template <int N>
__device__ __forceinline__ void dot_shared_acc(float (&a)[4], const float* h, const float* W4,
                                               int m, int col) {
  const float4* h4 = reinterpret_cast<const float4*>(h);
  const float4* w4 = reinterpret_cast<const float4*>(W4) + col;
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 x = h4[q], v = w4[q * m];
    a[0] = fmaf(x.x, v.x, a[0]);
    a[1] = fmaf(x.y, v.y, a[1]);
    a[2] = fmaf(x.z, v.z, a[2]);
    a[3] = fmaf(x.w, v.w, a[3]);
  }
}

template <int N>
__device__ __forceinline__ float dot_shared(const float* h, const float* W4, int m, int col) {
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  dot_shared_acc<N>(a, h, W4, m, col);
  return sum4(a);
}

// a[i % 4] += h[i] * wr[i]: h = den_h, wr the thread's column of U
__device__ __forceinline__ void dot_regs(float (&a)[4], const float (&wr)[kDen], const float* h) {
  const float4* h4 = reinterpret_cast<const float4*>(h);
#pragma unroll
  for (int q = 0; q < kDen / 4; ++q) {
    const float4 x = h4[q];
    a[0] = fmaf(x.x, wr[4 * q], a[0]);
    a[1] = fmaf(x.y, wr[4 * q + 1], a[1]);
    a[2] = fmaf(x.z, wr[4 * q + 2], a[2]);
    a[3] = fmaf(x.w, wr[4 * q + 3], a[3]);
  }
}

// a GRU unit's new state from its gate inputs: x_* of x W + b, u_* of h U.
// Each product and sum rounds on its own, as in the plain version: after an
// onset the pre-activations are large and both versions sit ~2e-5 from a
// float64 evaluation, so the kernel keeps within R1_TOL of the plain version
// by rounding where it rounds
template <bool kRelu>
__device__ __forceinline__ float gru_update(float h, float xz, float xr, float xh, float uz,
                                            float ur, float uh) {
  const float z = sigmoid(xz + uz);
  const float r = sigmoid(xr + ur);
  const float c = __fadd_rn(xh, __fmul_rn(r, uh));
  const float hh = kRelu ? fmaxf(c, 0.0f) : tanhf(c);
  return __fadd_rn(__fmul_rn(z, h), __fmul_rn(1.0f - z, hh));
}

// unit j of a GRU of `size` units, its gate inputs in shared memory
template <bool kRelu>
__device__ __forceinline__ void gru_unit(float* h, const float* gx, const float* gh, int size,
                                         int j) {
  h[j] = gru_update<kRelu>(h[j], gx[j], gx[size + j], gx[2 * size + j], gh[j], gh[size + j],
                           gh[2 * size + j]);
}

// the 22 band gains from den_h, four threads a band (thread t in
// [kGain0, kGain0 + 88)): each sums 24 rows, two shuffles add the parts
__device__ __forceinline__ void band_gains(const float* den_h, const float* Wo4,
                                           const float* __restrict__ bo, float* out, int t) {
  const int u = t - kGain0, band = u / kGainParts, part = u % kGainParts;
  const unsigned group = 0xFu << ((t & 31) & ~3);
  float g = dot_shared<kGainRows>(den_h + part * kGainRows,
                                  Wo4 + part * (kGainRows / 4) * kBands * 4, kBands, band);
  g += __shfl_xor_sync(group, g, 1);
  g += __shfl_xor_sync(group, g, 2);
  if (part == 0) out[band] = sigmoid(g + bo[band]);
}

__global__ void __launch_bounds__(kThreads, 1)
rnnoise_gru_kernel(const float* X, const uint8_t* __restrict__ silence,
                   const float* __restrict__ h_vad0, const float* __restrict__ h_noise0,
                   const float* __restrict__ h_den0, Weights w, int K, int C,
                   float* __restrict__ gains, float* __restrict__ vads,
                   float* __restrict__ h_vad1, float* __restrict__ h_noise1,
                   float* __restrict__ h_den1) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ __align__(16) float vad_h[kVad];
  __shared__ __align__(16) float noise_h[kNoise];
  __shared__ __align__(16) float den_h[kDen];
  __shared__ float v_gh[3 * kVad];
  __shared__ float n_gx[3 * kNoise], n_gh[3 * kNoise];
  __shared__ float d_gx[3 * kDen], d_gh[3 * kDen];
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const bool noise_row = t < kNoiseRows;
  const bool vad_u_row = t >= kVadURow0 && t < kVadURow0 + 3 * kVad;
  const bool noise_u_row = t >= kNoiseURow0;
  const bool vad_gate = t >= kVadGate0 && t < kVadGate0 + kVad;
  const bool noise_gate = t >= kNoiseGate0 && t < kNoiseGate0 + kNoise;
  const bool gain_row = t >= kGain0 && t < kGain0 + kGainParts * kBands;
  const int vj = t - kVadGate0;  // the VAD unit of a vad_gate thread

  // the prologue: thread t's register column, the shared weights, the states
  float wr[kDen];
#pragma unroll
  for (int i = 0; i < kDen; ++i) wr[i] = __ldg(w.p[kDenU] + i * 3 * kDen + t);
  stage_groups(sm + kSmUv, w.p[kVadU], kVad, 3 * kVad);
  stage_groups(sm + kSmWn, w.p[kNoiseW] + kDense * 3 * kNoise, kVad, 3 * kNoise);
  stage_groups(sm + kSmUn, w.p[kNoiseU], kNoise, 3 * kNoise);
  stage_groups(sm + kSmWo, w.p[kOutW], kDen, kBands);
  stage_groups(sm + kSmWvo, w.p[kVadOutW], kVad, 1);
  stage_groups(sm + kSmWd, w.p[kDenW], kDenIn, 3 * kDen);
  if (t < kVad) vad_h[t] = h_vad0[c * kVad + t];
  if (t < kNoise) noise_h[t] = h_noise0[c * kNoise + t];
  if (t < kDen) den_h[t] = h_den0[c * kDen + t];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // the VAD and noise GRUs' recurrent products of the states in; later, of
  // each frame's new states, under the denoise GRU's update (stage e)
  if (vad_u_row)
    v_gh[t - kVadURow0] = dot_shared<kVad>(vad_h, sm + kSmUv, 3 * kVad, t - kVadURow0);
  if (noise_u_row)
    n_gh[t - kNoiseURow0] = dot_shared<kNoise>(noise_h, sm + kSmUn, 3 * kNoise, t - kNoiseURow0);
  // the hoisted products: written by the grid launched before this one,
  // which this prologue overlaps (programmatic dependent launch)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // frame 0's Xn and Xv rows (a VAD unit's z, r and h~) and flag; later,
  // frame k + 1's while k runs (Xd is read at the top of its frame)
  const float* x0 = X + (size_t)c * kX;
  float xn = noise_row ? ld_hoisted(x0 + kXn + t) : 0.0f;
  float xvz = 0.0f, xvr = 0.0f, xvh = 0.0f;
  if (vad_gate) {
    xvz = ld_hoisted(x0 + kXv + vj);
    xvr = ld_hoisted(x0 + kXv + kVad + vj);
    xvh = ld_hoisted(x0 + kXv + 2 * kVad + vj);
  }
  bool silent = silence[c] != 0;
  int pending = -1;  // the frame and channel whose gains wait on den_h
  __syncthreads();

  // Five stages a frame, each ending at a barrier; on the chain: the VAD
  // GRU's update (a), the noise GRU's input product (b), its update (c),
  // the denoise GRU's input product of noise_h (d) and its update (e).  The
  // rest runs beside them on other warps.
  for (int k = 0; k < K; ++k) {
    const int kc = k * C + c;
    const float* xk = X + (size_t)kc * kX;
    float nxn = 0.0f, nxvz = 0.0f, nxvr = 0.0f, nxvh = 0.0f;
    bool nsilent = false;
    if (k + 1 < K) {
      const float* nr = xk + (size_t)C * kX;
      if (noise_row) nxn = ld_hoisted(nr + kXn + t);
      if (vad_gate) {
        nxvz = ld_hoisted(nr + kXv + vj);
        nxvr = ld_hoisted(nr + kXv + kVad + vj);
        nxvh = ld_hoisted(nr + kXv + 2 * kVad + vj);
      }
      nsilent = silence[kc + C] != 0;
    }
    if (silent) {  // the same for every thread of the block
      if (t < kBands) gains[kc * kBands + t] = 1.0f;
      if (t == 0) vads[kc] = 0.0f;
    } else {
      const float xd = ld_hoisted(xk + kXd + t);
      // a: the VAD GRU (warp 8); den_h @ U_d (warps 0-7); the gains of the
      //    last frame that ran (den_h is not written again until e)
      float ah[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (vad_gate) {
        vad_h[vj] = gru_update<false>(vad_h[vj], xvz, xvr, xvh, v_gh[vj], v_gh[kVad + vj],
                                      v_gh[2 * kVad + vj]);
      } else if (t < kVadGate0) {
        dot_regs(ah, wr, den_h);
        if (pending >= 0 && gain_row)
          band_gains(den_h, sm + kSmWo, w.p[kOutB], gains + pending * kBands, t);
      }
      __syncthreads();
      // b: vad_h @ noise_gru_w[24:48] + Xn (threads 0-143); vad_h @
      //    denoise_gru_w[0:24] for the rows of threads 144-287
      float ax[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (noise_row) {
        n_gx[t] = dot_shared<kVad>(vad_h, sm + kSmWn, 3 * kNoise, t) + xn;
      } else {
        dot_shared_acc<kVad>(ax, vad_h, sm + kSmWd, 3 * kDen, t);
      }
      __syncthreads();
      // c: the noise GRU (threads 192-239); vad_h @ denoise_gru_w[0:24] for
      //    rows 0-143; den_h @ U_d for warp 8; this frame's VAD
      if (noise_gate) {
        gru_unit<true>(noise_h, n_gx, n_gh, kNoise, t - kNoiseGate0);
      } else if (noise_row) {
        dot_shared_acc<kVad>(ax, vad_h, sm + kSmWd, 3 * kDen, t);
      } else if (t >= kVadGate0) {
        dot_regs(ah, wr, den_h);
      } else if (t == kVadHead) {
        vads[kc] = sigmoid(dot_shared<kVad>(vad_h, sm + kSmWvo, 1, 0) + w.p[kVadOutB][0]);
      }
      __syncthreads();
      // d: noise_h @ denoise_gru_w[24:72], the hoisted term last
      dot_shared_acc<kNoise>(ax, noise_h, sm + kSmWd + (kVad / 4) * 3 * kDen * 4, 3 * kDen, t);
      d_gx[t] = sum4(ax) + xd;
      d_gh[t] = sum4(ah);
      __syncthreads();
      // e: the denoise GRU (warps 0-2); the next frame's vad_h @ U_v and
      //    noise_h @ U_n (a silent frame changes neither state)
      if (t < kDen) {
        gru_unit<true>(den_h, d_gx, d_gh, kDen, t);
      } else {
        if (vad_u_row)
          v_gh[t - kVadURow0] = dot_shared<kVad>(vad_h, sm + kSmUv, 3 * kVad, t - kVadURow0);
        if (noise_u_row)
          n_gh[t - kNoiseURow0] =
              dot_shared<kNoise>(noise_h, sm + kSmUn, 3 * kNoise, t - kNoiseURow0);
      }
      __syncthreads();
      pending = kc;
    }
    xn = nxn;
    xvz = nxvz;
    xvr = nxvr;
    xvh = nxvh;
    silent = nsilent;
  }
  if (pending >= 0 && gain_row)
    band_gains(den_h, sm + kSmWo, w.p[kOutB], gains + pending * kBands, t);
  if (t < kVad) h_vad1[c * kVad + t] = vad_h[t];
  if (t < kNoise) h_noise1[c * kNoise + t] = noise_h[t];
  if (t < kDen) h_den1[c * kDen + t] = den_h[t];
}

}  // namespace

extern "C" {

// Runs the GRU stack over K frames of C channels on `stream`: two launches,
// the hoisted products into `hoisted` ([K, C, 504] f32 scratch), then the
// recurrence.  features [K, C, 42], silence [K, C] (bytes), h_*0 the states
// in, weights a host array of the 15 device pointers (WEIGHT_KEYS order);
// writes gains [K, C, 22], vads [K, C] and the states after the last frame
// to h_*1.  Returns 0 or the first cudaError_t that is not 0.
int rnnoise_gru(const float* features, const uint8_t* silence, const float* h_vad0,
                const float* h_noise0, const float* h_den0, const void* const* weights,
                int K, int C, float* hoisted, float* gains, float* vads, float* h_vad1,
                float* h_noise1, float* h_den1, void* stream) {
  if (K < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  Weights w;
  for (int i = 0; i < kNumWeights; ++i) w.p[i] = static_cast<const float*>(weights[i]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = K * C;
  rnnoise_hoist_kernel<<<(rows + kHoistRows - 1) / kHoistRows, kHoistThreads, 0, s>>>(
      features, w, rows, hoisted);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(rnnoise_gru_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a programmatic dependent launch: the recurrence's blocks load their
  // weights while the hoist kernel runs, then wait for its results
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmBytes;
  cfg.stream = s;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rnnoise_gru_kernel, static_cast<const float*>(hoisted), silence,
                           h_vad0, h_noise0, h_den0, w, K, C, gains, vads, h_vad1, h_noise1,
                           h_den1);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* rnnoise_gru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
