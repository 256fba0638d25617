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
// terms (rows ascending here: (y0,z0), (y0,z1), (y1,z0), (y1,z1); the TPU's
// order is the MXU's).  Indices past S-1 carry weight 0 and are read
// clamped to S-1.
//
// Two entries run that chain:
//  - colorlut_mxu, the TPU signature: f32 positions in, f32 planes out;
//  - colorlut_mxu_packed: RGBA pixels (4 x u8 as a 32-bit word, or 4 x u16
//    as a 64-bit word, R in the low bits) in and out, with the
//    normalisation (scale, offset, maxval from params[8]), the rounding
//    (half to even) and the repacking in the kernel; alpha rides through.
//    The JAX package runs that glue as XLA ops around its pallas_call.
//
// What bounds it on an H100 (1080p, P = 2,073,600, S = 33, random pixels).
// Not the HBM bytes: 24 B a pixel for the TPU signature (14.9 us at 3.35
// TB/s), 8 B for RGBA (5.0 us), 16 B for RGBA64 (9.9 us); nor its ~88 f32
// operations a pixel (2.7 us at 67 TFLOP/s).  The first design read T2
// itself: 24 separate 2-byte loads a pixel (4 rows x 3 channels x lanes x0,
// x0+1), the channels' lanes 2S = 66 bytes apart, about 12.75 different
// 32-byte sectors a pixel (~845 MB a frame), and took 0.1097 ms: it was
// bound by the table sectors it pulled through the caches.
//
// Design.  Each call first builds a cell table from T2 (build_cells, ~0.3
// MB read, 1.2 MB written, resident in the 50 MB L2; ~2 us):
//
//     cell (y, z, x) = 16 bf16, 32 bytes, one sector, 32-byte aligned:
//       for c = 0..2:  T2[(y,z), c*S+x], T2[(y,z), c*S+x1],
//                      T2[(y,z1), c*S+x], T2[(y,z1), c*S+x1]
//       then 4 zeros;  x1 = min(x+1, S-1), z1 = min(z+1, S-1)
//
// so cell (y0, z0, x0) holds everything a pixel needs from rows (y0,z0) and
// (y0,z1), and cell (y1, z0, x0) everything from (y1,z0) and (y1,z1): two
// sectors a pixel, read as four 16-byte loads through the read-only path,
// instead of ~12.75.  The clamped edges (x0 = S-1, z0 = S-1, y1 = S-1) hold
// the values the first design read there, with weight 0, so the four row
// terms and their order are unchanged and the result is the same bit for
// bit.  One thread owns one pixel; no shared memory.
//
// Outcome (NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py phase 3b): the TPU
// signature 0.046 ms (was 0.1097), RGBA 0.040, RGBA64 0.043, the cell build
// included.  The cells cut the sectors 6x but the time only 2.4x: at ~2
// sectors a pixel the kernel moves ~4 TB/s of cells, under the ~7.7 TB/s
// the first design drew.  A/Bs on the same card: lane pairs loading whole
// cells (one request a sector, not two halves) gained 1-2%; the same cells
// read through L2 only (__ldcg) ran 1.5x slower, and 16-byte row cells (four
// a pixel, a 0.58 MB table) 1.6x slower, so L1 hits carry much of the
// speed and the 1.15 MB table, which overflows the ~256 KB L1, is what
// random pixels pay for.  On a smooth frame (neighbours alike) every variant
// ran RGBA in 0.023 ms.
// Built with -fmad=false: the plain PyTorch version rounds every product and
// sum on its own, and so does this kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;
constexpr int kCellWords = 2;  // uint4 words a cell: 16 bf16, 32 bytes

__device__ __forceinline__ void hat(float x, int S, int& i0, int& i1, float& h0, float& h1) {
  const float f = floorf(x);
  i0 = static_cast<int>(f);
  i1 = min(i0 + 1, S - 1);
  h0 = fmaxf(0.0f, 1.0f - fabsf(x - f));
  h1 = fmaxf(0.0f, 1.0f - fabsf(x - (f + 1.0f)));
}

__device__ __forceinline__ unsigned int bf16_bits(const __nv_bfloat16* t, int i) {
  return static_cast<unsigned int>(__bfloat16_as_ushort(t[i]));
}

// One cell per thread: two rows of T2, lanes x and x1, three channels.
__global__ void __launch_bounds__(kThreads)
build_cells(const __nv_bfloat16* __restrict__ t2, uint4* __restrict__ cells, int S) {
  const int n = S * S * S;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int x = idx % S, z = (idx / S) % S, y = idx / (S * S);
  const int x1 = min(x + 1, S - 1), z1 = min(z + 1, S - 1);
  const __nv_bfloat16* r0 = t2 + (y * S + z) * kLanes;
  const __nv_bfloat16* r1 = t2 + (y * S + z1) * kLanes;
  unsigned int w[8];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int l0 = c * S + x, l1 = c * S + x1;
    w[2 * c] = bf16_bits(r0, l0) | (bf16_bits(r0, l1) << 16);
    w[2 * c + 1] = bf16_bits(r1, l0) | (bf16_bits(r1, l1) << 16);
  }
  w[6] = w[7] = 0u;
  cells[kCellWords * idx] = make_uint4(w[0], w[1], w[2], w[3]);
  cells[kCellWords * idx + 1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// bf16 pair word -> its low and high value as f32 (exact)
__device__ __forceinline__ float lo(unsigned int w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(unsigned int w) { return __uint_as_float(w & 0xffff0000u); }

// The per-pixel chain of both entries.
__device__ __forceinline__ void sample(const uint4* __restrict__ cells, float x, float y, float z,
                                       int S, float (&out)[3]) {
  int x0, x1, y0, y1, z0, z1;
  float wx0, wx1, wy0, wy1, wz0, wz1;
  hat(x, S, x0, x1, wx0, wx1);
  hat(y, S, y0, y1, wy0, wy1);
  hat(z, S, z0, z1, wz0, wz1);
  const uint4* a = cells + kCellWords * ((y0 * S + z0) * S + x0);  // rows (y0,z0), (y0,z1)
  const uint4* b = cells + kCellWords * ((y1 * S + z0) * S + x0);  // rows (y1,z0), (y1,z1)
  const uint4 a0 = __ldg(a), a1 = __ldg(a + 1), b0 = __ldg(b), b1 = __ldg(b + 1);
  // the 4 (y,z) rows' weights bf16(wy*wz), ascending
  const float w[4] = {__bfloat162float(__float2bfloat16_rn(wy0 * wz0)),
                      __bfloat162float(__float2bfloat16_rn(wy0 * wz1)),
                      __bfloat162float(__float2bfloat16_rn(wy1 * wz0)),
                      __bfloat162float(__float2bfloat16_rn(wy1 * wz1))};
  // per channel, the rows' (x0, x1) pairs in row order
  const unsigned int rows[3][4] = {{a0.x, a0.y, b0.x, b0.y},
                                   {a0.z, a0.w, b0.z, b0.w},
                                   {a1.x, a1.y, b1.x, b1.y}};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float o0 = 0.0f, o1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o0 = o0 + w[j] * lo(rows[c][j]);
      o1 = o1 + w[j] * hi(rows[c][j]);
    }
    out[c] = o0 * wx0 + o1 * wx1;
  }
}

__global__ void __launch_bounds__(kThreads)
lut_mxu_kernel(const float* __restrict__ xp, const float* __restrict__ yp,
               const float* __restrict__ zp, const uint4* __restrict__ cells,
               float* __restrict__ ro, float* __restrict__ go, float* __restrict__ bo,
               long long P, int S) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float out[3];
  sample(cells, xp[p], yp[p], zp[p], S, out);
  ro[p] = out[0];
  go[p] = out[1];
  bo[p] = out[2];
}

// The element's normalisation: clip(v / maxval * scale + offset, 0, 1) * (S-1),
// the division taken as a product with the f32 reciprocal, as XLA takes the
// JAX package's division by a constant (ops/pixels.py).
__device__ __forceinline__ float grid_coord(unsigned int v, float inv_maxval, float scale,
                                            float offset, float smax) {
  const float t = static_cast<float>(v) * inv_maxval;
  return fminf(fmaxf(t * scale + offset, 0.0f), 1.0f) * smax;
}

__device__ __forceinline__ unsigned int quantize(float y, float maxval) {
  return static_cast<unsigned int>(rintf(fminf(fmaxf(y, 0.0f), 1.0f) * maxval));
}

// Pixels of four components of B bits, R in the low bits: B = 8 (RGBA u8 as
// a 32-bit word) or 16 (RGBA64 as a 64-bit word).  Component 3 (alpha)
// rides through.
template <typename Word>
__global__ void __launch_bounds__(kThreads)
lut_mxu_packed_kernel(const Word* __restrict__ px, const float* __restrict__ params,
                      const uint4* __restrict__ cells, Word* __restrict__ out, long long P,
                      int S) {
  constexpr int B = 2 * sizeof(Word);
  constexpr Word kMask = (Word(1) << B) - 1;
  constexpr Word kAlpha = ~((Word(1) << (3 * B)) - 1);
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float maxval = params[6];
  const float inv_maxval = 1.0f / maxval;
  const float smax = static_cast<float>(S - 1);
  const Word v = px[p];
  float o[3];
  sample(cells,
         grid_coord(static_cast<unsigned int>(v & kMask), inv_maxval, params[0], params[3], smax),
         grid_coord(static_cast<unsigned int>((v >> B) & kMask), inv_maxval, params[1], params[4],
                    smax),
         grid_coord(static_cast<unsigned int>((v >> (2 * B)) & kMask), inv_maxval, params[2],
                    params[5], smax),
         S, o);
  out[p] = static_cast<Word>(quantize(o[0], maxval)) |
           (static_cast<Word>(quantize(o[1], maxval)) << B) |
           (static_cast<Word>(quantize(o[2], maxval)) << (2 * B)) | (v & kAlpha);
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// Launches build_cells into `cells` ([S,S,S,16] bf16) on the stream.
int launch_cells(const void* t2, void* cells, int S, cudaStream_t stream) {
  build_cells<<<blocks_for(static_cast<long long>(S) * S * S), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(t2), static_cast<uint4*>(cells), S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes): every pointer and the stream are
// void*; the return value is the launch's cudaError_t (0 = launched).
// Each builds the cell table from t2 into `cells` (scratch of S^3 * 32
// bytes, 32-byte aligned, from the caller), then samples it.

// The cell table alone (a test hook).
extern "C" int colorlut_mxu_cells(const void* t2, void* cells, int S, void* stream) {
  return launch_cells(t2, cells, S, static_cast<cudaStream_t>(stream));
}

extern "C" int colorlut_mxu(const void* x, const void* y, const void* z, const void* t2,
                            void* cells, void* r, void* g, void* b, long long P, int S,
                            void* stream) {
  if (P == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_cells(t2, cells, S, s);
  if (err != 0) return err;
  lut_mxu_kernel<<<blocks_for(P), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<const float*>(z),
      static_cast<const uint4*>(cells), static_cast<float*>(r), static_cast<float*>(g),
      static_cast<float*>(b), P, S);
  return static_cast<int>(cudaGetLastError());
}

// bits: 8 (px/out as 32-bit words) or 16 (64-bit words); params [8] f32:
// scale0..2, offset0..2, maxval, 0.
extern "C" int colorlut_mxu_packed(const void* px, const void* params, const void* t2,
                                   void* cells, void* out, long long P, int S, int bits,
                                   void* stream) {
  if (bits != 8 && bits != 16) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_cells(t2, cells, S, s);
  if (err != 0) return err;
  const uint4* c = static_cast<const uint4*>(cells);
  const float* prm = static_cast<const float*>(params);
  if (bits == 8)
    lut_mxu_packed_kernel<unsigned int><<<blocks_for(P), kThreads, 0, s>>>(
        static_cast<const unsigned int*>(px), prm, c, static_cast<unsigned int*>(out), P, S);
  else
    lut_mxu_packed_kernel<unsigned long long><<<blocks_for(P), kThreads, 0, s>>>(
        static_cast<const unsigned long long*>(px), prm, c,
        static_cast<unsigned long long*>(out), P, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* colorlut_mxu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
