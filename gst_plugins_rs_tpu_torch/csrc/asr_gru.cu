// Kernel T1: asr-lite's bidirectional GRU recurrence over an utterance, for Hopper.
//
// Replaces the recurrence of the JAX package's BiGRU:
// gst_plugins_rs_tpu/ops/asr.py::_gru_scan (:124, a lax.scan over the frames
// :137, reversed for the backward direction), two scans per layer, two
// layers.  It is XLA there, not Pallas.  The JAX cell is
//   z = sigmoid([x, h] @ Wz + bz),  r = sigmoid([x, h] @ Wr + br),
//   hh = tanh([x, r*h] @ Wh + bh),  h' = (1 - z) * h + z * hh,
// with the reset gate multiplying h BEFORE the product: cuDNN's GRU (and so
// nn.GRU) applies it after, so no library call computes it.  The input part
// of each gate, X_g = x @ W_g[:D] + b_g, does not depend on h: the caller
// computes it for all frames and both directions in one product
// (ops/asr.py::input_projections), and this kernel runs what is left:
//   z = sigmoid(X_z[t] + h U_z),  r = sigmoid(X_r[t] + h U_r),
//   hh = tanh(X_h[t] + (r*h) U_h),  h = (1 - z) * h + z * hh,
// with U_g = W_g[D:] [H, H], H = 96, t from 0 up (forward) or T-1 down
// (backward).
//
// What bounds it on an H100.  An utterance of T = 500 frames is 2 x 500 x 3
// x 96 x 96 multiply-adds per layer (55 MFLOP, 0.8 us at 67 TFLOP/s f32) and
// reads 1.15 MB of X and writes 0.38 MB of states (0.5 us at 3.35 TB/s).
// What binds is the recurrence: step t+1 needs step t's h, and inside a step
// the candidate needs r.  A step is a chain of two dot products of 96 terms
// (four partial sums each), a sigmoid, a tanh and two barriers, ~400 cycles
// by estimate, so a layer's 500 steps take ~0.1 ms however many SMs there
// are (chip_smoke.py phase 3g prints the estimate beside the time).
//
// Design (a simple correct kernel):
//  - one block per (utterance, direction), 288 threads: one per gate row
//    (3 x 96); thread t computes row t % 96 of gate t / 96;
//  - the three recurrent matrices of the direction, 3 x 96 x 96 f32 =
//    110.6 KB, are staged in shared memory once per launch (dynamic shared
//    memory above 48 KB, set with cudaFuncSetAttribute), so no step waits
//    on L2 for a weight (R1 reads its weights from L2 and waits on it);
//    thread j reads column j of U[i][j], a warp 32 consecutive words: no
//    bank conflict; h and the gates are broadcast reads;
//  - per step: the z and r threads compute their gates (barrier), then the
//    h threads the candidate from r*h and the new state into the other half
//    of a double buffer (barrier); each thread's X value for the next step
//    is loaded while the current step runs;
//  - the states leave as out[b, d, t, :]; nothing goes to the host.
// Built with contraction on, as R1: the kernel agrees with its plain
// version (ops/asr_gru.py::bigru_plain) to float rounding, not bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kH = 96;
constexpr int kGates = 3 * kH;  // 288
constexpr int kThreads = kGates;
constexpr int kUFloats = 3 * kH * kH;
constexpr size_t kSmemBytes = (kUFloats + 2 * kH + 2 * kH) * sizeof(float);

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void __launch_bounds__(kThreads)
asr_gru_kernel(const float* __restrict__ X, const float* __restrict__ U, int T,
               float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* Us = reinterpret_cast<float*>(smem4);  // [3][H][H]
  float* hbuf = Us + kUFloats;                  // [2][H], double buffer
  float* gate = hbuf + 2 * kH;                  // [2H]: z, then r
  const int dir = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x, g = t / kH, j = t % kH;

  const float4* U4 = reinterpret_cast<const float4*>(U + static_cast<size_t>(dir) * kUFloats);
  for (int i = t; i < kUFloats / 4; i += kThreads) smem4[i] = U4[i];
  if (t < kH) hbuf[t] = 0.0f;
  __syncthreads();

  const size_t seq = static_cast<size_t>(b) * 2 + dir;
  const float* Xs = X + seq * T * kGates;
  float* os = out + seq * T * kH;
  const float* Ug = Us + g * kH * kH + j;
  int cur = 0;
  float x = Xs[static_cast<size_t>(dir ? T - 1 : 0) * kGates + t];
  for (int s = 0; s < T; ++s) {
    const int tt = dir ? T - 1 - s : s;
    // the next step's input, in flight while this step runs
    const float xn = s + 1 < T ? Xs[static_cast<size_t>(dir ? tt - 1 : tt + 1) * kGates + t] : 0.0f;
    const float* h = hbuf + cur * kH;
    if (g < 2) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int i = 0; i < kH; i += 4) {
        a0 = fmaf(h[i], Ug[(i + 0) * kH], a0);
        a1 = fmaf(h[i + 1], Ug[(i + 1) * kH], a1);
        a2 = fmaf(h[i + 2], Ug[(i + 2) * kH], a2);
        a3 = fmaf(h[i + 3], Ug[(i + 3) * kH], a3);
      }
      gate[t] = sigmoid(x + ((a0 + a1) + (a2 + a3)));
    }
    __syncthreads();
    if (g == 2) {
      const float* r = gate + kH;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int i = 0; i < kH; i += 4) {
        a0 = fmaf(r[i] * h[i], Ug[(i + 0) * kH], a0);
        a1 = fmaf(r[i + 1] * h[i + 1], Ug[(i + 1) * kH], a1);
        a2 = fmaf(r[i + 2] * h[i + 2], Ug[(i + 2) * kH], a2);
        a3 = fmaf(r[i + 3] * h[i + 3], Ug[(i + 3) * kH], a3);
      }
      const float hh = tanhf(x + ((a0 + a1) + (a2 + a3)));
      const float z = gate[j];
      const float hn = (1.0f - z) * h[j] + z * hh;
      hbuf[(cur ^ 1) * kH + j] = hn;
      os[static_cast<size_t>(tt) * kH + j] = hn;
    }
    __syncthreads();
    cur ^= 1;
    x = xn;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  X [B, 2, T, 3H] and U [2, 3, H,
// H] f32, contiguous; out [B, 2, T, H].  Every pointer and the stream are
// void*.  Returns the launch's cudaError_t (0 = launched).
extern "C" int asr_gru(const void* X, const void* U, int B, int T, void* out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(asr_gru_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  asr_gru_kernel<<<dim3(2, B), kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(U), T, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* asr_gru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
