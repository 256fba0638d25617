// audioloudnorm's true-peak limiter over one 100 ms frame of N streams, for Hopper.
//
// Replaces the limiter scan of the JAX package:
// gst_plugins_rs_tpu/ops/loudnorm.py::_precompute_peaks (:146, the peak
// detection) and ::_make_limiter_step (:175, the per-sample FSM Out /
// Attack / Sustain / Release, reference imp.rs:1377-1430) scanned by
// ::_limiter_scan (:261) over the first FRAME = 19,200 samples of the
// limiter window, with its idle fast path and the final clamp to
// +-target_tp, and by ::_limiter_scan_batched (:286) over N streams of a
// loudnormbank tick.  The kernel reads the window and the carry, nothing
// else: it detects the peaks itself.
//
// The FSM is a serial recurrence, but between two peaks its state moves in
// closed form: an Attack counts env up to ATTACK and turns to Sustain, a
// Sustain holds (counting sus down) and releases only after the frame's
// last peak, a Release counts env up to RELEASE and turns to Out.  Each
// sample's gain is a pure function of its segment (state, env at the
// segment's start, gr0, gr1) and of its offset in it.  So the serial work
// is one step per event (a peak, or a turn between peaks), not one per
// sample, and the per-sample gain and scaling are parallel work.
//
// Design: one block of 1024 threads per stream, N streams a launch
// (audioloudnorm launches one, loudnormbank one block per stream of the
// bank, each block deciding its own idle case).  Five phases:
//  1. Detection, all threads, over the frame's elements (output n, channel
//     c at window row LOOKAHEAD + n), eight a thread at a time with their
//     loads started together and coalesced: only an element above target_tp
//     reads its neighbours (the rows before and after, and the next 2..11,
//     none higher).  These are compares, abs and max only, so the peaks
//     equal precompute_peaks' bit for bit.  At a peak the thread also
//     divides, gr[n] = tp / pv (pv the max |x| over the row's channels), so
//     no division is left on the serial walk, and sets the row's bit in a
//     peak mask in shared memory.
//  2. Compaction: one thread a mask word, a block-wide prefix count of the
//     words' popcounts, then the peak positions in order as uint16 (at most
//     19,200: 37.5 KB).  `future[n]` of the
//     scan is "a peak at n or later", which between peaks is "a later peak
//     exists".  The idle case (carry state Out and no peak) is decided from
//     the count: the carry passes through and the output is the clamped
//     input.
//  3. The walk, warp 0 (every lane holds the same state): the gap before
//     each peak in closed form (the turns above), then at the peak the
//     scan's transition code unchanged (the restart and steepen branches,
//     adj_env), then the final gap to FRAME with no later peak.  A run of
//     peaks that change nothing but sus (in an Attack before env reaches
//     ATTACK with new_gr >= gr1, in a Sustain with new_gr >= gr1) is
//     stepped over in closed form: the 32 lanes test 32 peaks a ballot for
//     the run's end.  Each change of state, env or gains starts a segment
//     (start, state, env - start, gr0, gr1) in a device scratch and sets
//     the start's bit in a second mask; a later change at the same sample
//     replaces it, so at most FRAME segments a stream.  A peak that changes
//     nothing starts none, so a clipped frame, where every sample is a
//     peak, takes ~600 ballots and writes two segments from an Out carry
//     (the attack, the sustain).  The carry at the frame's end is the
//     walker's state.
//  4. The gains, all threads: a block-wide prefix count over the start
//     mask's words gives every sample its segment (the starts at or before it,
//     less one), and each sample's gain, with the scan's expressions and
//     roundings, goes to shared memory over the dead gr.
//  5. The fill, all threads: the frame's elements scaled by their row's
//     gain and clamped, eight a thread at a time, coalesced.
//
// What bounds it on an H100.  Bytes: a stereo f64 frame reads window rows
// 0 .. LOOKAHEAD + FRAME + 10 (21,131 x 2 x 8 B) and writes 19,200 x 2 x 8
// B, ~0.65 MB, 0.19 us at 3.35 TB/s; but one block moves them through one
// SM, so on a sparse frame the detection's and the fill's bytes through
// that SM bound it (microseconds: latency-bound loads, eight in flight a
// thread).  On a dense frame the walk's chain bounds it: an event (a peak
// whose step changes the state, a ballot over 32 inert peaks, a segment)
// is a few dependent compares, selects and adds, estimated ~40 cycles.  A
// clipped plateau is ~600 ballots; a frame whose every peak changes the
// state (each peak higher than the last) walks 19,200 steps, ~0.39 ms at
// 1.98 GHz by that estimate.  A dense frame's detection also reads the 12
// neighbours of every element above the target.  No cluster or TMA is
// used.
//
// Shared memory (dynamic, above 48 KB, set with cudaFuncSetAttribute):
// gr [FRAME] of T, the peak and segment-start masks [600] words each, the
// positions [FRAME] uint16: 196,800 B for f64, 120,000 B for f32; one block
// a SM.
//
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
constexpr int kWarps = kThreads / 32;
constexpr int kWords = kFrame / 32;  // mask words, a bit a sample: 600
enum { kOut = 0, kAtt = 1, kSus = 2, kRel = 3 };

template <typename T> struct Pair;
template <> struct Pair<double> { using type = double2; };
template <> struct Pair<float> { using type = float2; };

constexpr int kU = 8;  // elements whose loads a thread starts together

template <typename T>
constexpr size_t smem_bytes() {
  return kFrame * sizeof(T) + 2 * kWords * sizeof(uint32_t) + kFrame * sizeof(uint16_t);
}

// one rounding of a*b + c, never rewritten by the compiler
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }

template <typename T>
__device__ __forceinline__ T clamp_tp(T y, T tp) {
  // jnp.clip(y, -tp, tp) = minimum(maximum(y, -tp), tp)
  y = y < -tp ? -tp : y;
  return y > tp ? tp : y;
}

// The FSM of one stream on one thread, stepping from event to event.
template <typename T>
struct Walker {
  using P = typename Pair<T>::type;
  int st, env, sus;
  T gr0, gr1;
  int nseg, last;
  bool writer;        // the one lane of the walking warp that stores
  int4* seg_i;
  P* seg_f;
  uint32_t* starts;   // a bit per sample where a segment starts

  // a segment from sample `start` on: the state now in force there
  __device__ __forceinline__ void emit(int start) {
    if (start == last) --nseg;  // a later change at the same sample replaces it
    if (writer) {
      seg_i[nseg] = make_int4(start, st, env - start, 0);
      P g;
      g.x = gr0;
      g.y = gr1;
      seg_f[nseg] = g;
      starts[start >> 5] |= 1u << (start & 31);
    }
    ++nseg;
    last = start;
  }

  // Samples a .. t-1, none a peak, in closed form; kLater: a peak follows
  // (the scan's future flag is set over the whole gap).
  template <bool kLater>
  __device__ __forceinline__ void advance(int a, int t) {
    while (a < t) {
      if (st == kAtt) {
        if (env >= kAttack) { st = kSus; emit(a); continue; }
        const int len = min(t - a, kAttack - env);
        a += len;
        env += len;
      } else if (st == kSus) {
        if (kLater) {  // holds to the peak, sus counting down to 0
          if (sus > 0) sus = max(sus - (t - a), 0);
          return;
        }
        if (sus > 0) {  // holds while sus > 0, then releases
          const int len = min(sus, t - a);
          sus -= len;
          a += len;
          continue;
        }
        gr0 = gr1; gr1 = T(1); env = 0; st = kRel;
        emit(a);
      } else if (st == kRel) {
        if (env >= kRelease) { st = kOut; emit(a); continue; }
        const int len = min(t - a, kRelease - env);
        a += len;
        env += len;
      } else {
        return;  // Out stays Out
      }
    }
  }

  // The scan's step at a peak at sample t, new_gr = tp / pv there.
  __device__ __forceinline__ void peak(int t, T new_gr, T att_den, T att_rcp, T rel_rcp) {
    const T one = T(1), zero = T(0), tiny = T(-1e-30);
    const T envf = T(env);
    bool chg = false;
    if (st == kAtt && env >= kAttack) { st = kSus; chg = true; }
    if (st == kRel && env >= kRelease) { st = kOut; chg = true; }
    if (st == kOut) {
      gr0 = one; gr1 = new_gr; env = 0; sus = -1; st = kAtt;
      chg = true;
    } else if (st == kAtt) {
      if (new_gr < gr1) {
        const T cur_att = fma_rn(-(envf * att_rcp), gr0 - gr1, gr0);
        const T old_slope = -(gr0 - gr1);
        const T new_slope = -(cur_att - new_gr);
        if (new_slope <= old_slope) {  // restart the attack
          gr0 = cur_att; gr1 = new_gr; env = 0; sus = -1;
        } else {  // steepen the running attack
          const T safe = old_slope != zero ? old_slope : tiny;
          T new_end = (new_gr - gr0) / safe;
          new_end = new_end < one ? one : new_end;
          const T adj_gr0 = fma_rn(new_end - one, old_slope, gr0);
          T cur_pos = (cur_att - adj_gr0) / safe;
          cur_pos = cur_pos < zero ? zero : cur_pos;
          cur_pos = cur_pos > one ? one : cur_pos;
          const int adj_env = static_cast<int>(att_den * cur_pos);
          gr0 = adj_gr0; gr1 = new_gr; env = adj_env; sus = adj_env;
        }
        chg = true;
      } else if (env < kAttack) {  // a lower peak inside the attack
        sus = env;
      }
    } else if (st == kSus) {
      if (new_gr < gr1) {
        gr0 = gr1; gr1 = new_gr; env = 0; sus = -1; st = kAtt;
        chg = true;
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
      chg = true;
    }
    // (the scan's Sustain -> Release check skips a peak's own sample)
    if (chg) emit(t);
    if (st == kAtt || st == kRel) ++env;
  }
};

// Stream s = blockIdx.x reads window + s * win_stride ([W, ch] rows) and
// carries s ([3] ints, [2] T), writes [FRAME, ch] row s of out, the new
// carries s, and its segments to row s of seg_i / seg_f ([FRAME] each);
// stats, when given, gets (peaks, segments, walk steps) of stream s: a
// step is one peak's transition or one ballot over 32 peaks.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)  // one block a SM: its shared memory
limiter_kernel(const T* __restrict__ window, long long win_stride,
               const int* __restrict__ carry_i, const T* __restrict__ carry_f,
               int* __restrict__ new_i, T* __restrict__ new_f, int4* seg_i,
               typename Pair<T>::type* seg_f, int* stats, T tp, int ch, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* gr = reinterpret_cast<T*>(smem);                               // [kFrame]
  T* mult = gr;  // after the walk: each sample's gain
  uint32_t* bits = reinterpret_cast<uint32_t*>(gr + kFrame);        // [kWords] peaks
  uint32_t* starts = bits + kWords;                                 // [kWords] segment starts
  uint16_t* pos = reinterpret_cast<uint16_t*>(starts + kWords);     // [kFrame]
  int* before_word = reinterpret_cast<int*>(pos);  // after the walk: starts before each word
  __shared__ int wsum[kWarps];
  __shared__ int s_nseg;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned full = 0xffffffffu;
  const long long s = blockIdx.x;
  window += s * win_stride;
  carry_i += 3 * s;
  new_i += 3 * s;
  carry_f += 2 * s;
  new_f += 2 * s;
  seg_i += s * kFrame;
  seg_f += s * kFrame;
  out += s * kFrame * ch;
  // element i of a [kFrame, ch] frame lies in row i / ch = umulhi(i, ceil(2^32 / ch)),
  // exact for i < 2^32 / ch: every element while ch < 473 (the wrapper checks)
  const unsigned magic = ch > 1 ? 0xffffffffu / static_cast<unsigned>(ch) + 1u : 0u;
  const int n_el = kFrame * ch;
  auto row_of = [&](int i) {
    return ch > 1 ? static_cast<int>(__umulhi(static_cast<unsigned>(i), magic)) : i;
  };

  for (int w = tid; w < kWords; w += kThreads) {
    bits[w] = 0u;
    starts[w] = 0u;
  }
  __syncthreads();

  // 1. detection over the frame's elements (output n, channel c reads
  // window row kLookahead + n), kU loads a thread at a time, coalesced;
  // only an element above the target reads its neighbours
  const T* rows = window + static_cast<long long>(kLookahead) * ch;
  for (int i0 = tid; i0 < n_el; i0 += kU * kThreads) {
    T x[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      x[u] = i < n_el ? abs_t(rows[i]) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n_el && x[u] > tp) {
        bool ok = abs_t(rows[i - ch]) <= x[u] && abs_t(rows[i + ch]) <= x[u];
        for (int j = 2; ok && j <= 11; ++j) ok = abs_t(rows[i + j * ch]) <= x[u];
        if (ok) {  // a peak at row n: gr = tp / pv, pv the max |x| over its channels
          const int n = row_of(i);
          const T* r = rows + static_cast<long long>(n) * ch;
          T pv = abs_t(r[0]);
          for (int c = 1; c < ch; ++c) {
            const T v = abs_t(r[c]);
            pv = (v > pv || v != v) ? v : pv;  // amax: NaN wins
          }
          gr[n] = tp / (pv > T(0) ? pv : T(1));  // the same value from every channel
          atomicOr(&bits[n >> 5], 1u << (n & 31));
        }
      }
    }
  }
  __syncthreads();

  // 2. compaction: the peak positions in order
  uint32_t word = tid < kWords ? bits[tid] : 0u;
  const int cnt = __popc(word);
  int incl = cnt;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(full, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
  {
    const int v = wsum[lane];
    before = lane < warp ? v : 0;
    total = v;
    for (int d = 16; d > 0; d >>= 1) {
      before += __shfl_xor_sync(full, before, d);
      total += __shfl_xor_sync(full, total, d);
    }
  }
  int off = before + incl - cnt;
  while (word) {
    pos[off++] = static_cast<uint16_t>(tid * 32 + __ffs(word) - 1);
    word &= word - 1;
  }
  const bool idle = carry_i[0] == kOut && total == 0;
  __syncthreads();

  const T one = T(1);
  if (!idle) {
    const T att_rcp = one / T(kAttack - 1);
    const T rel_rcp = one / T(kRelease - 1);
    // 3. the walk: warp 0, every lane holding the same state (lane 0 stores
    // the segments); the lanes part only to search 32 peaks at a time for
    // the end of an inert run
    if (warp == 0) {
      Walker<T> w;
      w.st = carry_i[0]; w.env = carry_i[1]; w.sus = carry_i[2];
      w.gr0 = carry_f[0]; w.gr1 = carry_f[1];
      w.nseg = 0; w.last = -1; w.writer = lane == 0;
      w.seg_i = seg_i; w.seg_f = seg_f; w.starts = starts;
      const T att_den = T(kAttack - 1);
      w.emit(0);
      int a = 0, i = 0, steps = 0;
      while (i < total) {
        const int t = pos[i];
        w.template advance<true>(a, t);
        // Peaks that change nothing but sus: in an Attack before env reaches
        // ATTACK (q) with new_gr >= gr1, in a Sustain with new_gr >= gr1.
        // Find the first peak j >= i that is not, and step over i .. j-1.
        if (w.st == kAtt || w.st == kSus) {
          const int q = w.st == kAtt ? t + (kAttack - w.env) : kFrame;
          int j = i;
          for (;;) {
            const int idx = j + lane;
            const int p = idx < total ? pos[idx] : kFrame;
            const bool stop = idx >= total || p >= q || gr[p] < w.gr1;
            const unsigned b = __ballot_sync(full, stop);
            ++steps;
            if (b) { j += __ffs(b) - 1; break; }
            j += 32;
          }
          if (j > i) {
            const int last = pos[j - 1];
            if (w.st == kAtt) {  // env counted on to the run's last peak, sus = env there
              w.sus = w.env + (last - t);
              w.env = w.sus + 1;
            } else {
              w.sus = kLookahead;
            }
            a = last + 1;
            i = j;
            continue;
          }
        }
        w.peak(t, gr[t], att_den, att_rcp, rel_rcp);
        ++steps;
        a = t + 1;
        ++i;
      }
      w.template advance<false>(a, kFrame);
      if (lane == 0) {
        new_i[0] = w.st; new_i[1] = w.env; new_i[2] = w.sus;
        new_f[0] = w.gr0; new_f[1] = w.gr1;
        s_nseg = w.nseg;
        if (stats) { stats[3 * s] = total; stats[3 * s + 1] = w.nseg; stats[3 * s + 2] = steps; }
      }
    }
    __syncthreads();
    const int nseg = s_nseg;

    // 4. each sample's segment, the count of segment starts at or before it
    // less one (a block-wide prefix count over the mask words), and its gain
    // with the scan's expressions, into shared memory (gr is dead)
    if (nseg > 1) {
      const int c = tid < kWords ? __popc(starts[tid]) : 0;
      int in = c;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(full, in, d);
        if (lane >= d) in += v;
      }
      if (lane == 31) wsum[warp] = in;
      __syncthreads();
      int base = lane < warp ? wsum[lane] : 0;
      for (int d = 16; d > 0; d >>= 1) base += __shfl_xor_sync(full, base, d);
      if (tid < kWords) before_word[tid] = base + in - c;
      __syncthreads();
    }
#pragma unroll 4
    for (int n = tid; n < kFrame; n += kThreads) {
      const int si = nseg > 1 ? before_word[n >> 5] +
                                    __popc(starts[n >> 5] & (full >> (31 - (n & 31)))) - 1
                              : 0;
      const int4 r = seg_i[si];
      const typename Pair<T>::type g = seg_f[si];
      T m = one;
      if (r.y == kAtt) m = fma_rn(-(T(r.z + n) * att_rcp), g.x - g.y, g.x);
      else if (r.y == kSus) m = g.y;
      else if (r.y == kRel) m = fma_rn(-(T(r.z + n) * rel_rcp), g.y - g.x, g.x);
      mult[n] = m;
    }
    __syncthreads();
  } else if (tid == 0) {  // idle: the carry passes through
    new_i[0] = carry_i[0]; new_i[1] = carry_i[1]; new_i[2] = carry_i[2];
    new_f[0] = carry_f[0]; new_f[1] = carry_f[1];
    if (stats) { stats[3 * s] = 0; stats[3 * s + 1] = 0; stats[3 * s + 2] = 0; }
  }

  // 5. the frame scaled by its gains (idle: as it is) and clamped, kU
  // elements a thread at a time, coalesced
  for (int i0 = tid; i0 < n_el; i0 += kU * kThreads) {
    T x[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      x[u] = i < n_el ? window[i] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n_el) out[i] = clamp_tp(idle ? x[u] : x[u] * mult[row_of(i)], tp);
    }
  }
}

template <typename T>
int launch(const void* window, long long win_stride, const void* carry_i, const void* carry_f,
           void* new_i, void* new_f, void* seg_i, void* seg_f, void* stats, double tp, int ch,
           int n, void* out, cudaStream_t stream) {
  const int smem = static_cast<int>(smem_bytes<T>());
  cudaError_t err = cudaFuncSetAttribute(limiter_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  limiter_kernel<T><<<n, kThreads, smem, stream>>>(
      static_cast<const T*>(window), win_stride, static_cast<const int*>(carry_i),
      static_cast<const T*>(carry_f), static_cast<int*>(new_i), static_cast<T*>(new_f),
      static_cast<int4*>(seg_i), static_cast<typename Pair<T>::type*>(seg_f),
      static_cast<int*>(stats), static_cast<T>(tp), ch, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes): every pointer and the stream are
// void*; n streams, each window win_stride elements after the previous one;
// seg_i int32 [n, FRAME, 4] and seg_f [n, FRAME, 2] of the window's type
// are scratch; stats is null or int32 [n, 3]; f64 != 0 selects double, else
// float.  Returns the cudaError_t of the shared-memory attribute or of the
// launch (0 = launched).
extern "C" int loudnorm_limiter(const void* window, long long win_stride, const void* carry_i,
                                const void* carry_f, void* new_i, void* new_f, void* seg_i,
                                void* seg_f, void* stats, double tp, int ch, int f64, int n,
                                void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    return launch<double>(window, win_stride, carry_i, carry_f, new_i, new_f, seg_i, seg_f,
                          stats, tp, ch, n, out, s);
  return launch<float>(window, win_stride, carry_i, carry_f, new_i, new_f, seg_i, seg_f, stats,
                       tp, ch, n, out, s);
}

extern "C" const char* loudnorm_limiter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
