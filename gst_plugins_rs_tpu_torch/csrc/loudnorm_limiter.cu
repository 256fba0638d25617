// audioloudnorm's true-peak limiter over one 100 ms frame of N streams, for Hopper.
//
// Replaces the limiter scan of the JAX package:
// gst_plugins_rs_tpu/ops/loudnorm.py::_make_limiter_step (the per-sample
// FSM Out / Attack / Sustain / Release, reference imp.rs:1377-1430) scanned
// by ::_limiter_scan over the first FRAME = 19,200 samples of the limiter
// window, with its idle fast path and the final clamp to +-target_tp, and
// by ::_limiter_scan_batched (:286) over N streams of a loudnormbank tick.
// The peak detection (pk, pv, future per output sample) is vectorised torch
// before the launch (ops/loudnorm_limiter.py::precompute_peaks).
//
// What bounds it on an H100.  Bytes: a stereo f64 frame reads 19,200 x 2 x 8
// B of window and 19,200 x 2 B of pk/future flags, pv only at the peaks, and
// writes 19,200 x 2 x 8 B of output, ~0.65 MB, 0.19 us at 3.35 TB/s.  But the
// FSM is a serial recurrence: each sample's state depends on the previous
// one, so the floor is 19,200 steps x the loop-carried chain of one step
// (the state compare, its select and the envelope count's add, ~12 cycles
// by estimate; 0.12 ms at 1.98 GHz).  The gain of a sample (an f64 multiply and an FMA) is off that
// chain.  This simple form runs each step's compares, branches and gain in
// order on one thread, far above that floor (PERF.md has its time).
//
// Design (a simple correct kernel; later work: the serial walk skipping the
// spans between peaks).
//  - One block per stream, N streams a launch: audioloudnorm launches one,
//    loudnormbank one block per stream of the bank.  Each block decides the
//    idle case for its own stream, so idle streams leave after the scaling
//    pass and one peaky stream holds only its own block (the JAX bank's
//    per-block conds, without the other streams waiting in lockstep).
//  - All threads of a block first stage the frame's
//    peak flags (pk | future << 1) in shared memory, 19.2 KB, so the serial
//    thread reads each in ~30 cycles instead of a device-memory round trip.
//  - Thread 0 decides the idle case (state Out and no peak in the frame):
//    the carry passes through and the output is the clamped input, as the
//    scan's lax.cond fast path.  Otherwise it runs the FSM over the frame,
//    keeps the carry in registers, reads pv only where a peak is (new_gr =
//    target_tp / pv, an f64 division, only there) and writes each sample's
//    gain to the scratch `mult`.
//  - After a barrier all threads scale the [FRAME, ch] frame by its gain and
//    clamp, coalesced.
//  - The carry (int32 state, env, sustain; gr0, gr1) is read from and
//    written to small device tensors: nothing goes to the host.
// Roundings: built with -fmad=false, every operation rounds on its own as
// in the plain PyTorch version, except where both evaluate what XLA's CPU
// backend makes of the JAX scan: env / (len - 1) as env * (1 / (len - 1))
// and the envelope's multiply-add as one explicit fused multiply-add
// (fma_rn).  Divisions are IEEE (no fast math).  So the kernel equals the
// plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFrame = 19200;
constexpr int kAttack = 1920;
constexpr int kRelease = 19200;
constexpr int kLookahead = 1920;
constexpr int kThreads = 1024;
enum { kOut = 0, kAtt = 1, kSus = 2, kRel = 3 };

// one rounding of a*b + c, never rewritten by the compiler
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }

template <typename T>
__device__ __forceinline__ T clamp_tp(T y, T tp) {
  // jnp.clip(y, -tp, tp) = minimum(maximum(y, -tp), tp)
  y = y < -tp ? -tp : y;
  return y > tp ? tp : y;
}

// Stream n = blockIdx.x reads window + n * win_stride ([W, ch] rows), the
// [FRAME] rows n of pk, pv, fut and mult, carries n ([3] ints, [2] T) and
// writes [FRAME, ch] row n of out.
template <typename T>
__global__ void __launch_bounds__(kThreads)
limiter_kernel(const T* __restrict__ window, long long win_stride, const uint8_t* __restrict__ pk,
               const T* __restrict__ pv, const uint8_t* __restrict__ fut,
               const int* __restrict__ carry_i, const T* __restrict__ carry_f,
               int* __restrict__ new_i, T* __restrict__ new_f, T* __restrict__ mult,
               T tp, int ch, T* __restrict__ out) {
  const long long n_s = blockIdx.x;
  window += n_s * win_stride;
  pk += n_s * kFrame;
  pv += n_s * kFrame;
  fut += n_s * kFrame;
  mult += n_s * kFrame;
  carry_i += 3 * n_s;
  new_i += 3 * n_s;
  carry_f += 2 * n_s;
  new_f += 2 * n_s;
  out += n_s * kFrame * ch;
  __shared__ uint8_t flags[kFrame];
  __shared__ int idle;
  for (int n = threadIdx.x; n < kFrame; n += blockDim.x)
    flags[n] = static_cast<uint8_t>((pk[n] ? 1 : 0) | (fut[n] ? 2 : 0));
  __syncthreads();
  if (threadIdx.x == 0) {
    int st = carry_i[0], env = carry_i[1], sus = carry_i[2];
    T gr0 = carry_f[0], gr1 = carry_f[1];
    // future[0]: a peak anywhere in the frame
    const bool is_idle = st == kOut && !(flags[0] & 2);
    idle = is_idle;
    if (!is_idle) {
      const T one = T(1), zero = T(0);
      const T att_den = T(kAttack - 1);
      const T att_rcp = one / att_den;
      const T rel_rcp = one / T(kRelease - 1);
      const T tiny = T(-1e-30);
      for (int n = 0; n < kFrame; ++n) {
        const uint8_t f = flags[n];
        const bool p = f & 1;
        T envf = T(env);
        if (st == kAtt && env >= kAttack) st = kSus;
        if (st == kRel && env >= kRelease) st = kOut;
        if (p) {
          const T pvn = pv[n];
          const T new_gr = tp / (pvn > zero ? pvn : one);
          if (st == kOut) {
            gr0 = one; gr1 = new_gr; env = 0; sus = -1; st = kAtt;
          } else if (st == kAtt) {
            const T cur_att = fma_rn(-(envf * att_rcp), gr0 - gr1, gr0);
            const T old_slope = -(gr0 - gr1);
            const T new_slope = -(cur_att - new_gr);
            if (new_gr < gr1 && new_slope <= old_slope) {  // restart the attack
              gr0 = cur_att; gr1 = new_gr; env = 0; sus = -1;
            } else if (new_gr < gr1) {  // steepen the running attack
              const T safe = old_slope != zero ? old_slope : tiny;
              T new_end = (new_gr - gr0) / safe;
              new_end = new_end < one ? one : new_end;
              const T adj_gr0 = fma_rn(new_end - one, old_slope, gr0);
              T cur_pos = (cur_att - adj_gr0) / safe;
              cur_pos = cur_pos < zero ? zero : cur_pos;
              cur_pos = cur_pos > one ? one : cur_pos;
              const int adj_env = static_cast<int>(att_den * cur_pos);
              gr0 = adj_gr0; gr1 = new_gr; env = adj_env; sus = adj_env;
            } else if (env < kAttack) {  // a lower peak inside the attack
              sus = env;
            }
          } else if (st == kSus) {
            if (new_gr < gr1) {
              gr0 = gr1; gr1 = new_gr; env = 0; sus = -1; st = kAtt;
            } else {
              sus = kLookahead;
            }
          } else {  // release
            const T cur_rel = fma_rn(-(envf * rel_rcp), gr1 - gr0, gr0);
            if (new_gr < cur_rel) {
              gr0 = cur_rel; gr1 = new_gr; env = 0; sus = -1; st = kAtt;
            } else {
              gr1 = cur_rel; st = kSus;
            }
          }
        }
        if (st == kSus && !p && sus <= 0 && !(f & 2)) {
          gr0 = gr1; gr1 = one; env = 0; st = kRel;
        }
        envf = T(env);
        T m;
        if (st == kOut) m = one;
        else if (st == kAtt) m = fma_rn(-(envf * att_rcp), gr0 - gr1, gr0);
        else if (st == kSus) m = gr1;
        else m = fma_rn(-(envf * rel_rcp), gr1 - gr0, gr0);
        mult[n] = m;
        if (st == kAtt || st == kRel) ++env;
        if (st == kSus && sus > 0 && !p) --sus;
      }
    }
    new_i[0] = st; new_i[1] = env; new_i[2] = sus;
    new_f[0] = gr0; new_f[1] = gr1;
  }
  __syncthreads();
  const int total = kFrame * ch;
  if (idle) {
    for (int i = threadIdx.x; i < total; i += blockDim.x) out[i] = clamp_tp(window[i], tp);
  } else {
    for (int i = threadIdx.x; i < total; i += blockDim.x)
      out[i] = clamp_tp(window[i] * mult[i / ch], tp);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): every pointer and the stream are
// void*; n streams, each window win_stride elements after the previous one;
// f64 != 0 selects double, else float.  Returns the launch's cudaError_t
// (0 = launched).
extern "C" int loudnorm_limiter(const void* window, long long win_stride, const void* pk,
                                const void* pv, const void* fut, const void* carry_i,
                                const void* carry_f, void* new_i, void* new_f, void* mult,
                                double tp, int ch, int f64, int n, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* pk8 = static_cast<const uint8_t*>(pk);
  const uint8_t* fut8 = static_cast<const uint8_t*>(fut);
  const int* ci = static_cast<const int*>(carry_i);
  int* ni = static_cast<int*>(new_i);
  if (f64) {
    limiter_kernel<double><<<n, kThreads, 0, s>>>(
        static_cast<const double*>(window), win_stride, pk8, static_cast<const double*>(pv),
        fut8, ci,
        static_cast<const double*>(carry_f), ni, static_cast<double*>(new_f),
        static_cast<double*>(mult), tp, ch, static_cast<double*>(out));
  } else {
    limiter_kernel<float><<<n, kThreads, 0, s>>>(
        static_cast<const float*>(window), win_stride, pk8, static_cast<const float*>(pv),
        fut8, ci,
        static_cast<const float*>(carry_f), ni, static_cast<float*>(new_f),
        static_cast<float*>(mult), static_cast<float>(tp), ch, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* loudnorm_limiter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
