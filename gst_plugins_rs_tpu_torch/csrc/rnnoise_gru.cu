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
// (2 x 86,952 operations at 67 TFLOP/s f32: 2.6 ns) and reads 350 KB of
// weights, which stay in the 50 MB L2 across frames.  The bound of the
// function (weights read once, features, gains and states once) is tiny;
// what binds this design is the recurrence: frame k+1 needs frame k's
// states, and inside a frame the five stages depend on each other.  Each
// stage is a dot product per gate row (the longest 114 + 96 terms), an L2
// round trip for the first weights after each barrier and the gate math, so
// a frame is a chain of ~2,100 cycles by estimate (chip_smoke.py phase 3d
// prints it).  This simple form is slower still: each thread waits on L2
// for every group of four weights it loads (the widest row is 210 loads,
// ~52 round trips), so a frame took 17.7 us on an NVIDIA H100 80GB HBM3 at
// 700 W (100 frames x 2 channels, chip_smoke.py phase 3d), ~8x the chain.
//
// Design (a simple correct kernel; weights staged in shared memory across a
// cluster, several streams a launch and tensor cores are later work):
//  - one block per channel, 288 threads: one per gate row of the widest GRU
//    (3 x 96), fewer active in the narrower stages;
//  - the frame loop runs inside the kernel; inputs, the hidden states and
//    the gate pre-activations live in shared memory, a barrier between
//    stages;
//  - weights are read from global memory (L2): thread t reads column t of
//    W [in, out], so a warp reads 32 consecutive floats of a row at once;
//  - each dot product runs four partial sums (a chain a quarter as long);
//  - a silent frame skips the network: the state is held, the VAD written
//    0 and the gains 1, as the plain version does.
// The state enters from h0 and leaves in h1 (device tensors): nothing goes
// to the host.  Built without -fmad=false: the kernel agrees with its plain
// version to float rounding (other summation order, expf/tanhf).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFeat = 42;
constexpr int kDense = 24;
constexpr int kVad = 24;
constexpr int kNoise = 48;
constexpr int kDen = 96;
constexpr int kBands = 22;
constexpr int kThreads = 3 * kDen;  // 288

// the 15 weight arrays, in WEIGHT_KEYS order
enum {
  kInW, kInB, kVadW, kVadU, kVadB, kNoiseW, kNoiseU, kNoiseB, kDenW, kDenU, kDenB,
  kOutW, kOutB, kVadOutW, kVadOutB, kNumWeights
};

struct Weights {
  const float* p[kNumWeights];
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// sum_i in[i] * W[i * ld + col] over n rows, four partial sums
__device__ __forceinline__ float dot_col(const float* in, const float* __restrict__ W, int n,
                                         int ld, int col) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int i = 0;
#pragma unroll 4
  for (; i + 4 <= n; i += 4) {
    a0 = fmaf(in[i], __ldg(W + (i + 0) * ld + col), a0);
    a1 = fmaf(in[i + 1], __ldg(W + (i + 1) * ld + col), a1);
    a2 = fmaf(in[i + 2], __ldg(W + (i + 2) * ld + col), a2);
    a3 = fmaf(in[i + 3], __ldg(W + (i + 3) * ld + col), a3);
  }
  for (; i < n; ++i) a0 = fmaf(in[i], __ldg(W + i * ld + col), a0);
  return (a0 + a1) + (a2 + a3);
}

// One GRU of `size` units: the 3*size gate rows (thread t < 3*size) from
// the input segments [in1 (n1 rows of W), in2 (n2 rows)] and h, then the
// update of h in place (thread t < size).  Ends after a barrier.
template <bool kRelu>
__device__ __forceinline__ void gru(const float* in1, int n1, const float* in2, int n2,
                                    float* h, int size, const float* __restrict__ W,
                                    const float* __restrict__ U, const float* __restrict__ b,
                                    float* gx, float* gh) {
  const int t = threadIdx.x;
  const int rows = 3 * size;
  if (t < rows) {
    float x = dot_col(in1, W, n1, rows, t);
    if (n2 > 0) x += dot_col(in2, W + n1 * rows, n2, rows, t);
    gx[t] = x + b[t];
    gh[t] = dot_col(h, U, size, rows, t);
  }
  __syncthreads();
  if (t < size) {
    const float z = sigmoid(gx[t] + gh[t]);
    const float r = sigmoid(gx[size + t] + gh[size + t]);
    const float c = gx[2 * size + t] + r * gh[2 * size + t];
    const float hh = kRelu ? fmaxf(c, 0.0f) : tanhf(c);
    h[t] = z * h[t] + (1.0f - z) * hh;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
rnnoise_gru_kernel(const float* __restrict__ features, const uint8_t* __restrict__ silence,
                   const float* __restrict__ h_vad0, const float* __restrict__ h_noise0,
                   const float* __restrict__ h_den0, Weights w, int K, int C,
                   float* __restrict__ gains, float* __restrict__ vads,
                   float* __restrict__ h_vad1, float* __restrict__ h_noise1,
                   float* __restrict__ h_den1) {
  // s = [dense 24 | vad_h 24 | noise_h 48]: the noise GRU's input starts
  // with [dense, vad_h] = s[0:48], the denoise GRU's with [vad_h, noise_h]
  // = s[24:96]; the features follow each from `feat`
  __shared__ float s[kDense + kVad + kNoise];
  __shared__ float den_h[kDen];
  __shared__ float feat[kFeat];
  __shared__ float gx[3 * kDen];
  __shared__ float gh[3 * kDen];
  float* dense = s;
  float* vad_h = s + kDense;
  float* noise_h = s + kDense + kVad;
  const int c = blockIdx.x;
  const int t = threadIdx.x;

  if (t < kVad) vad_h[t] = h_vad0[c * kVad + t];
  if (t < kNoise) noise_h[t] = h_noise0[c * kNoise + t];
  if (t < kDen) den_h[t] = h_den0[c * kDen + t];

  for (int k = 0; k < K; ++k) {
    const int kc = k * C + c;
    if (t < kFeat) feat[t] = features[kc * kFeat + t];
    const bool silent = silence[kc] != 0;
    __syncthreads();
    if (silent) {  // the same for every thread of the block
      if (t < kBands) gains[kc * kBands + t] = 1.0f;
      if (t == 0) vads[kc] = 0.0f;
      continue;
    }
    if (t < kDense) dense[t] = tanhf(dot_col(feat, w.p[kInW], kFeat, kDense, t) + w.p[kInB][t]);
    __syncthreads();
    gru<false>(dense, kDense, nullptr, 0, vad_h, kVad, w.p[kVadW], w.p[kVadU], w.p[kVadB],
               gx, gh);
    gru<true>(s, kDense + kVad, feat, kFeat, noise_h, kNoise, w.p[kNoiseW], w.p[kNoiseU],
              w.p[kNoiseB], gx, gh);
    gru<true>(vad_h, kVad + kNoise, feat, kFeat, den_h, kDen, w.p[kDenW], w.p[kDenU],
              w.p[kDenB], gx, gh);
    if (t < kBands) {
      gains[kc * kBands + t] = sigmoid(dot_col(den_h, w.p[kOutW], kDen, kBands, t) +
                                       w.p[kOutB][t]);
    } else if (t == 32) {  // another warp
      vads[kc] = sigmoid(dot_col(vad_h, w.p[kVadOutW], kVad, 1, 0) + w.p[kVadOutB][0]);
    }
    // the next frame's first writes (feat) and state updates come after
    // barriers that every thread reaches once its reads here are done
  }
  __syncthreads();
  if (t < kVad) h_vad1[c * kVad + t] = vad_h[t];
  if (t < kNoise) h_noise1[c * kNoise + t] = noise_h[t];
  if (t < kDen) h_den1[c * kDen + t] = den_h[t];
}

}  // namespace

extern "C" {

// Runs the GRU stack over K frames of C channels on `stream`.  features
// [K, C, 42], silence [K, C] (bytes), h_*0 the states in, weights a host
// array of the 15 device pointers (WEIGHT_KEYS order); writes gains
// [K, C, 22], vads [K, C] and the states after the last frame to h_*1.
// Returns 0 or the cudaError_t of the launch.
int rnnoise_gru(const float* features, const uint8_t* silence, const float* h_vad0,
                const float* h_noise0, const float* h_den0, const void* const* weights,
                int K, int C, float* gains, float* vads, float* h_vad1, float* h_noise1,
                float* h_den1, void* stream) {
  if (K < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  Weights w;
  for (int i = 0; i < kNumWeights; ++i) w.p[i] = static_cast<const float*>(weights[i]);
  rnnoise_gru_kernel<<<C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      features, silence, h_vad0, h_noise0, h_den0, w, K, C, gains, vads, h_vad1, h_noise1,
      h_den1);
  return static_cast<int>(cudaGetLastError());
}

const char* rnnoise_gru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
