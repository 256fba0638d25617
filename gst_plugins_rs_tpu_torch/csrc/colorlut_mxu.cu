// Trilinear 3D-LUT sampling against the bf16 packed table, for Hopper.
//
// Replaces the TPU kernel gst_plugins_rs_tpu/ops/pallas_colorlut.py::
// _lut3d_positions_mxu (body _lut_kernel): positions x, y, z [P] f32 in
// [0, S-1] and the packed table T2 [YZPAD,128] bf16 (row y*S+z, lane c*S+i
// holds channel c at (i, y, z); pack_matmul_table) -> r, g, b [P] f32.
// The TPU kernel forms the hat-product weights bf16(wy*wz) of every (y,z)
// row, takes the dense product [P,S^2] @ [S^2,128] with f32 accumulation,
// then reduces each channel's lanes against the x hat weights in f32.
//
// A pixel's weight row has at most 4 nonzeros, at y0 = floor(y), y0+1 and
// z0 = floor(z), z0+1, and its x hat 2, at x0 and x0+1: the dense product
// is 4/1089 useful at S = 33.  This kernel does only the useful part:
//
//     o[l]  = sum over the 4 rows j of bf16(wy*wz)_j * T2[j, l]   (f32)
//     out_c = o[c*S+x0] * wx0 + o[c*S+x0+1] * wx1               (f32)
//
// bf16 x bf16 products are exact in f32 and the dense sum's other terms are
// exact zeros, so o equals the dense product up to the order of its four
// terms (rows ascending here; the TPU's order is the MXU's).  Indices past
// S-1 carry weight 0 and are read clamped to S-1.
//
// What bounds it on an H100 (1080p, P = 2,073,600, S = 33): it reads 12 B
// and writes 12 B per pixel, 49.8 MB, 14.9 us at 3.35 TB/s (the 295 KB
// table once, from L2 after that); its ~88 f32 operations per pixel take
// ~2.7 us at 67 TFLOP/s.  The kernel is bound by bytes.
//
// Design.  One thread owns one pixel and reads 24 table entries (4 rows x
// 3 channels x 2 lanes); the table stays resident in the 50 MB L2.  No
// shared memory: neighbouring pixels read neighbouring entries.
// Built with -fmad=false: the plain PyTorch version rounds every product and
// sum on its own, and so does this kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;

__device__ __forceinline__ void hat(float x, int S, int& i0, int& i1, float& h0, float& h1) {
  const float f = floorf(x);
  i0 = static_cast<int>(f);
  i1 = min(i0 + 1, S - 1);
  h0 = fmaxf(0.0f, 1.0f - fabsf(x - f));
  h1 = fmaxf(0.0f, 1.0f - fabsf(x - (f + 1.0f)));
}

__global__ void __launch_bounds__(kThreads)
lut_mxu_kernel(const float* __restrict__ xp, const float* __restrict__ yp,
               const float* __restrict__ zp, const __nv_bfloat16* __restrict__ t2,
               float* __restrict__ ro, float* __restrict__ go, float* __restrict__ bo,
               long long P, int S) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= P) return;
  int x0, x1, y0, y1, z0, z1;
  float wx0, wx1, wy0, wy1, wz0, wz1;
  hat(xp[p], S, x0, x1, wx0, wx1);
  hat(yp[p], S, y0, y1, wy0, wy1);
  hat(zp[p], S, z0, z1, wz0, wz1);
  // the 4 (y,z) rows, ascending, and their weights bf16(wy*wz)
  const __nv_bfloat16* rows[4] = {t2 + (y0 * S + z0) * kLanes, t2 + (y0 * S + z1) * kLanes,
                                  t2 + (y1 * S + z0) * kLanes, t2 + (y1 * S + z1) * kLanes};
  const float w[4] = {__bfloat162float(__float2bfloat16_rn(wy0 * wz0)),
                      __bfloat162float(__float2bfloat16_rn(wy0 * wz1)),
                      __bfloat162float(__float2bfloat16_rn(wy1 * wz0)),
                      __bfloat162float(__float2bfloat16_rn(wy1 * wz1))};
  float out[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int l0 = c * S + x0, l1 = c * S + x1;
    float o0 = 0.0f, o1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o0 = o0 + w[j] * __bfloat162float(rows[j][l0]);
      o1 = o1 + w[j] * __bfloat162float(rows[j][l1]);
    }
    out[c] = o0 * wx0 + o1 * wx1;
  }
  ro[p] = out[0];
  go[p] = out[1];
  bo[p] = out[2];
}

}  // namespace

// Plain C entry point (bound with ctypes): every pointer and the stream are
// void*; the return value is the launch's cudaError_t (0 = launched).
extern "C" int colorlut_mxu(const void* x, const void* y, const void* z, const void* t2,
                            void* r, void* g, void* b, long long P, int S, void* stream) {
  if (P == 0) return 0;
  const long long blocks = (P + kThreads - 1) / kThreads;
  lut_mxu_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<const float*>(z),
      static_cast<const __nv_bfloat16*>(t2), static_cast<float*>(r), static_cast<float*>(g),
      static_cast<float*>(b), P, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* colorlut_mxu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
