// The hsvfilter core over planar f32 channels, for Hopper.
//
// Replaces the TPU kernel gst_plugins_rs_tpu/ops/pallas_hsv.py::
// hsv_filter_pallas (body _hsv_kernel): r, g, b [H,W] f32 planes in [0,1]
// and params[5] = (hue shift in degrees, reduced mod 360; sat mul, sat off;
// val mul, val off) -> adjusted r, g, b planes.  The math is the TPU
// kernel's, in sextant units (h/60): the same where-chain (EPSILON 1e-5,
// tested in r, g, b order), one reciprocal each for chroma and value, the
// hue shift as one add and two conditional subtracts, floor for the
// sextant parity.
//
// What bounds it on an H100 (1080p, 2,073,600 pixels): it reads 12 B and
// writes 12 B per pixel, 49.8 MB, 14.9 us at 3.35 TB/s; its ~45 f32
// operations per pixel (two of them divisions) take ~1.4 us at 67 TFLOP/s.
// The kernel is bound by bytes.
//
// Design.  The TPU kernel tiles the planes in (8, 512) blocks for Mosaic's
// (8,128) layout.  Here one thread owns one pixel: the planes are read and
// written once each, coalesced, and the five parameters come from one
// broadcast load.  Nothing more is needed to reach the byte bound.
// Built with -fmad=false: the plain PyTorch version rounds every product and
// sum on its own (sat_mul * sat + sat_off, ...), and so does this kernel;
// the divisions stay IEEE (no fast math).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hsv_filter_kernel(const float* __restrict__ rp, const float* __restrict__ gp,
                  const float* __restrict__ bp, const float* __restrict__ params,
                  float* __restrict__ ro, float* __restrict__ go, float* __restrict__ bo,
                  long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float r = rp[i], g = gp[i], b = bp[i];
  const float shift_sextant = params[0] * static_cast<float>(1.0 / 60.0);
  const float sat_mul = params[1], sat_off = params[2];
  const float val_mul = params[3], val_off = params[4];

  const float value = fmaxf(fmaxf(r, g), b);
  const float minv = fminf(fminf(r, g), b);
  const float chroma = value - minv;
  const float inv_c = 1.0f / (chroma == 0.0f ? 1.0f : chroma);
  const float eps = 1e-5f;
  const bool is_r = fabsf(value - r) < eps;
  const bool is_g = fabsf(value - g) < eps;
  const bool is_b = fabsf(value - b) < eps;
  const float num = is_r ? g - b : (is_g ? b - r : (is_b ? r - g : 0.0f));
  const float base = is_r ? 0.0f : (is_g ? 2.0f : (is_b ? 4.0f : 0.0f));
  float hp = (chroma == 0.0f ? 0.0f : base + num * inv_c) + shift_sextant;
  hp = hp < 0.0f ? hp + 6.0f : hp;
  hp = hp >= 6.0f ? hp - 6.0f : hp;

  float sat = chroma * (1.0f / (value == 0.0f ? 1.0f : value));
  sat = value == 0.0f ? 0.0f : sat;
  const float s = fminf(fmaxf(sat_mul * sat + sat_off, 0.0f), 1.0f);
  const float v = fminf(fmaxf(val_mul * value + val_off, 0.0f), 1.0f);

  const float c = v * s;
  const float x = c * (1.0f - fabsf(hp - 2.0f * floorf(hp * 0.5f) - 1.0f));
  const float m = v - c;
  // sextant selection (hp <= 1, 2, 3, 4, 5, else) of (r', g', b')
  float r2, g2, b2;
  if (hp <= 1.0f) {
    r2 = c; g2 = x; b2 = 0.0f;
  } else if (hp <= 2.0f) {
    r2 = x; g2 = c; b2 = 0.0f;
  } else if (hp <= 3.0f) {
    r2 = 0.0f; g2 = c; b2 = x;
  } else if (hp <= 4.0f) {
    r2 = 0.0f; g2 = x; b2 = c;
  } else if (hp <= 5.0f) {
    r2 = x; g2 = 0.0f; b2 = c;
  } else {
    r2 = c; g2 = 0.0f; b2 = x;
  }
  ro[i] = r2 + m;
  go[i] = g2 + m;
  bo[i] = b2 + m;
}

}  // namespace

// Plain C entry point (bound with ctypes): every pointer and the stream are
// void*; the return value is the launch's cudaError_t (0 = launched).
extern "C" int hsv_filter_planes(const void* r, const void* g, const void* b,
                                 const void* params, void* ro, void* go, void* bo,
                                 long long n, void* stream) {
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  hsv_filter_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<const float*>(params), static_cast<float*>(ro), static_cast<float*>(go),
      static_cast<float*>(bo), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hsv_planes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
