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
// the candidate needs r, so a direction's steps run one after another on
// one SM, however many SMs there are.  A step is a chain of two all-to-all
// exchanges through shared memory (h to the r rows, r * h to the candidate
// rows), each followed by a dot product of 96 terms, a reduction and a
// sigmoid or tanh.
//
// Design: one block per (utterance, direction), 288 threads (nine warps of
// 32 gate rows), the step loop inside.
//  - U in registers.  A lane holds 2 rows x 48 inputs of one gate's U (96
//    floats, loaded once per launch): the lanes 2p and 2p + 1 sum rows
//    j0, j0 + 1 over inputs 0-47 and 48-95, and one shuffle leaves lane g
//    with row j0 + g.  No step reads a weight from shared or global memory.
//    Each row part is two FMA chains (even and odd inputs), so a lane runs
//    four chains of 24.
//  - h and r * h are read from shared memory as float4 loads that 16 lanes
//    share.  Shared memory hands registers 128 B a cycle per SM, broadcast or
//    not, so the fewer values a lane reads the better; the fewer lanes a row
//    is cut over, the fewer shuffles sit on the chain.  On the card (PERF.md
//    §6) a column of U a thread (96 values of h a lane, no shuffle) ran at
//    1,210 cycles a step, four lanes a row (24 values, two shuffle levels)
//    at 1,001, two lanes a row at 950, all with the precise gate math.
//  - Roles by warp: warps 1-3 the r rows, 5-7 the candidate rows, 0, 4 and
//    8 the z rows.  Warps w and w + 4 share an SM sub-partition, so the
//    chain (r, then the candidate) has three sub-partitions to itself, and z,
//    needed only by the blend, runs on the fourth beside it.
//  - Per step, with named barriers (producers arrive, consumers wait): the
//    r warps write rh[j] = r_j * h_j (the plain version's single rounding of
//    r * h) and arrive at barrier 1; the z warps write z and arrive at 2;
//    the candidate warps wait at 1, sum rh U_h, take the tanh, wait at 2,
//    blend, write h and out and arrive at 3, where the r and z warps wait
//    before the next step.
//  - The gates take the MUFU's ex2.approx and rcp.approx: sigmoid(a) =
//    1 / (1 + 2^(-a log2 e)), tanh(a) = 1 - 2 / (1 + 2^(2 a log2 e)).  The
//    libm expf, tanhf and IEEE division cost ~250 cycles a step on the
//    chain (two gates); these are within ~3e-7 of them (sigmoid and tanh
//    are bounded, so an absolute error is what the state sees).
//  - X arrives by cp.async into a ring of kDepth steps in shared memory,
//    kDepth - 1 steps ahead of its use, copied by 72 lanes of the r warps
//    once r * h is written (the z warps, which run closer to their deadline,
//    made a step slower with the copies); the states leave as
//    out[b, d, t, :], fire and forget.
//
// Floor a step, a reckoning (not a measurement): on the chain, for the r
// rows and again for the candidate rows, the first shared load after the
// hand-off (~30 cycles), 96 FMAs (one warp a sub-partition issues one a
// cycle), one shuffle and add (~30) and a gate (~40): 2 x 196; the two
// hand-offs (a store, a named barrier, ~40 each) and the blend and store
// (~20): 392 + 100 = 492 cycles, ~0.124 ms a layer of 500 steps at 1.98 GHz
// (chip_smoke.py T1_STEP_CYCLES prints it beside the measured cycles a
// step).  The z rows' 9,216 FMAs take one sub-partition 288 cycles, beside
// the chain.
//
// Not used, and why:
//  - Tensor cores.  At B = 1 a step is a [1 x 96] by [96 x 288] product:
//    an mma tile of 16 rows would use 1 row in 16, and a warpgroup's wgmma
//    1 in 64.  TF32 keeps ~3 decimal digits, which breaks the 1e-5 gate
//    against the plain version, and 3xTF32 costs three products for one.
//    The FMAs are not the bound either (192 of ~490 cycles on the chain).
//  - More threads a row (two threads of 48 terms, 576 threads; 384 threads
//    running both phases): slower than 288 on the card (PERF.md §6).
//  - A programmatic dependent launch to overlap the U prologue with the
//    kernel before it (R1 does so behind its own hoist kernel).  Here the
//    kernel before is PyTorch's, which may have written U: loading U before
//    griddepcontrol.wait would race with it, and after it nothing overlaps.
//
// Built with contraction on (the dot products are explicit fmaf); r * h and
// the blend (1 - z) * h + z * hh round once a product and sum, as the plain
// version (ops/asr_gru.py::bigru_plain) does.  The two agree to float
// rounding (summation order, the MUFU's gates), within 1e-5 of 1 + |ref|;
// tests/test_torch_asr_split.py models this kernel's order on the CPU.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kH = 96;
constexpr int kGates = 3 * kH;        // 288 X columns a step: z, r, the candidate
constexpr int kThreads = kGates;      // nine warps of 32 rows
constexpr int kParts = 2;             // lanes a row, and rows a lane
constexpr int kIn = kH / kParts;      // 48 inputs a lane
constexpr int kDepth = 8;             // steps of X in the shared ring
constexpr int kCopiers = kGates / 4;  // 72 lanes, one float4 of a step's X each
constexpr int kCopier0 = 32;          // the first: lane 0 of warp 1, an r warp
constexpr int kPairThreads = 2 * kH;  // named barriers 1 (r -> candidate), 2 (z -> candidate)
constexpr float kLog2e = 1.4426950408889634f;

enum Role { kZ = 0, kR = 1, kCand = 2 };  // also the gate's index in U and X

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sigmoid(float a) {
  return rcp_approx(1.0f + ex2_approx(-kLog2e * a));
}

__device__ __forceinline__ float tanh_(float a) {
  return 1.0f - 2.0f * rcp_approx(1.0f + ex2_approx(2.0f * kLog2e * a));
}

// arrive at (producers) or wait at (consumers) named barrier `id` of n threads
template <int n>
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(n) : "memory");
}

template <int n>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(n) : "memory");
}

// The lane's row of the warp's 32: sum_i v[i] U[i, row] over the 96 inputs.
// The lane's part of its rows j0 + k (k = 0, 1): v[48 g + m] w[k][m] over m,
// even and odd m in two FMA chains, added; then lane g keeps row j0 + g and
// adds the part of it that lane g ^ 1 sends: P0 + P1.  v in shared memory,
// 16-byte aligned.
__device__ __forceinline__ float row_sum(const float (&w)[kParts][kIn], const float* v, int g) {
  const float4* v4 = reinterpret_cast<const float4*>(v + kIn * g);
  float e[kParts] = {0.0f, 0.0f}, o[kParts] = {0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < kIn / 4; ++q) {
    const float4 x = v4[q];
#pragma unroll
    for (int k = 0; k < kParts; ++k) {
      e[k] = fmaf(x.x, w[k][4 * q], e[k]);
      o[k] = fmaf(x.y, w[k][4 * q + 1], o[k]);
      e[k] = fmaf(x.z, w[k][4 * q + 2], e[k]);
      o[k] = fmaf(x.w, w[k][4 * q + 3], o[k]);
    }
  }
  const float p0 = e[0] + o[0], p1 = e[1] + o[1];
  return (g ? p1 : p0) + __shfl_xor_sync(0xffffffffu, g ? p0 : p1, 1);
}

// step s's X row (if s < T) into ring slot s % kDepth, one float4 a copier
// (c = 0 .. 71), then a commit (an empty group past the end keeps the count)
__device__ __forceinline__ void fetch_x(float (*ring)[kGates], const float* __restrict__ Xs,
                                        int s, int T, int dir, int c) {
  if (s < T) {
    const int tt = dir ? T - 1 - s : s;
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(&ring[s % kDepth][4 * c]));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(Xs + static_cast<size_t>(tt) * kGates + 4 * c)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
asr_gru_kernel(const float* __restrict__ X, const float* __restrict__ U, int T,
               float* __restrict__ out) {
  __shared__ __align__(16) float hs[kH];  // h
  __shared__ __align__(16) float rh[kH];  // r * h
  __shared__ float zs[kH];                // z
  __shared__ __align__(16) float ring[kDepth][kGates];
  const int dir = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const Role role = warp % 4 == 0 ? kZ : (warp < 4 ? kR : kCand);
  const int blk = role == kZ ? warp / 4 : (role == kR ? warp - 1 : warp - 5);
  const int g = lane % kParts;         // the lane's inputs: 48 g .. 48 g + 47
  const int j0 = 32 * blk + lane - g;  // its two rows: j0, j0 + 1
  const int j = j0 + g;                // the row it ends with
  const int c = t - kCopier0;
  const bool copier = c >= 0 && c < kCopiers;

  // the lane's tile of U_role: w[k][m] = U[48 g + m, j0 + k]
  float w[kParts][kIn];
  const float* Ug = U + (static_cast<size_t>(dir) * 3 + role) * kH * kH;
#pragma unroll
  for (int m = 0; m < kIn; ++m)
#pragma unroll
    for (int k = 0; k < kParts; ++k) w[k][m] = __ldg(Ug + (kIn * g + m) * kH + j0 + k);

  const size_t seq = static_cast<size_t>(b) * 2 + dir;
  const float* Xs = X + seq * T * kGates;
  float* os = out + seq * T * kH;
  if (t < kH) hs[t] = 0.0f;
  if (copier) {
    for (int s = 0; s < kDepth - 1; ++s) fetch_x(ring, Xs, s, T, dir, c);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 2) : "memory");
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const float* x = ring[s % kDepth];
    if (role == kR) {
      if (s > 0) bar_sync<kThreads>(3);  // the last step's h
      const float r = sigmoid(x[kH + j] + row_sum(w, hs, g));
      rh[j] = r * hs[j];
      bar_arrive<kPairThreads>(1);
      // step s + kDepth - 1's X into the slot step s - 1 read; then step
      // s + 1's has landed (kDepth - 2 younger groups may be in flight), in
      // view of every warp once barrier 3 completes
      if (copier) {
        fetch_x(ring, Xs, s + kDepth - 1, T, dir, c);
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 2) : "memory");
      }
    } else if (role == kZ) {
      if (s > 0) bar_sync<kThreads>(3);
      zs[j] = sigmoid(x[j] + row_sum(w, hs, g));
      bar_arrive<kPairThreads>(2);
    } else {
      bar_sync<kPairThreads>(1);
      const float hh = tanh_(x[2 * kH + j] + row_sum(w, rh, g));
      bar_sync<kPairThreads>(2);
      // every read of h, rh and z this step is behind barriers 1 and 2
      const float z = zs[j];
      const float hn = __fadd_rn(__fmul_rn(1.0f - z, hs[j]), __fmul_rn(z, hh));
      hs[j] = hn;
      os[static_cast<size_t>(dir ? T - 1 - s : s) * kH + j] = hn;
      if (s + 1 < T) bar_arrive<kThreads>(3);
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  X [B, 2, T, 3H] (16-byte
// aligned) and U [2, 3, H, H] f32, contiguous; out [B, 2, T, H].  Every
// pointer and the stream are void*.  Returns the launch's cudaError_t
// (0 = launched).
extern "C" int asr_gru(const void* X, const void* U, int B, int T, void* out, void* stream) {
  if (B < 1 || B > 65535 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  asr_gru_kernel<<<dim3(2, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(U), T, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* asr_gru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
