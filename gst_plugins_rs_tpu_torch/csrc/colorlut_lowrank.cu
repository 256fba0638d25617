// Low-rank (CP) 3D-LUT sampling for colorlut precision=approx, for Hopper.
//
// Replaces two TPU kernels of gst_plugins_rs_tpu/ops/pallas_colorlut_lowrank.py:
//   B3  lowrank_sample_pallas (body _kernel): f32 grid coordinates xyz [3,P]
//       in [0,S-1] -> interpolated LUT outputs [3,P] f32;
//   B2  lowrank_sample_pallas_packed (body _packed_kernel): RGBA u8 pixels
//       as int32 [P] -> RGBA int32 [P], with the normalisation (scale,
//       offset, maxval from params[8]), the rounding (half to even) and the
//       repacking in the kernel; alpha rides through.
// and adds a third entry of B3's chain, packed64: RGBA64 pixels (4 x u16) as
// int64 [P] -> int64 [P], B2's kernel at 16 bits a component.  The JAX
// element runs that glue (normalise, stack, round, restack) as XLA ops
// around B3's pallas_call; here it runs in the kernel, with one 8-byte load
// and one 8-byte store per pixel.
// All three run the same per-pixel chain, lowrank_chain() below, so they are
// bit-equal on the same pixel (as the TPU kernels are):
//
//     u_k = sum_i hat_i(x) U[k,i]     (v: y and V, w: z and W)
//     out_c = sum_k (u_k v_k w_k) C[c,k]
//
// The TPU kernel takes three dense bf16 products [K,48]@[48,TPL] with f32
// accumulation.  A hat row has two nonzeros, at i0 = floor(x) and i0+1,
// with weights max(0, 1-|x-i|) rounded to bf16; each factor is rounded to
// bf16 too, so every product is exact in f32 and the zero terms add exact
// zeros: the sum of the two nonzero products is the dense product, bit for
// bit.  C stays f32 and the rank sum runs in f32, k ascending.
//
// What bounds it on an H100 (1080p, P = 2,073,600 per frame): not the bytes
// (4 B in and 4 B out per pixel for B2, 8 + 8 for packed64, 12 + 12 for B3)
// but the rank loop's instructions.  Per pixel and rank the chain does 17
// f32 operations (2 products and a sum per axis, 2 products, 3 products and
// 3 sums), each its own instruction under -fmad=false, so its ceiling is
// half the 67 TFLOP/s that counts an FMA as two.  The first design (one
// pixel per thread, the factors as [Kp,48] f32, C as [3,Kp]) issued 9
// shared loads per pixel and rank: two factor words per axis and three
// words of C.  A warp's 32-bit shared load without bank conflicts is one
// wavefront, and an SM serves one wavefront a clock, so a warp spent 9
// clocks a rank on loads against 17/4 on f32 issue; 9*K*P/32 wavefronts over
// 132 SMs at 1.98 GHz predict 1.14 and 2.29 ms for 8 frames at ranks 64 and
// 128, and an H100 80GB HBM3 at 700 W read 1.176 and 2.314 ms.
//
// Design.  The TPU kernel tiles pixels along lanes and runs the products on
// the MXU.  Here each thread owns N pixels and reads only the two nonzero
// rows of each factor: the dense product's 48 rows would be 24x the work.
// Shared memory holds, per block:
//  - C as float4 [Kp] (lane 3 zero): a rank reads its three channel weights
//    with one warp-uniform 128-bit load, shared by the thread's N pixels;
//  - U, V, W as 32-bit words, [Kp, row] each.  bf16 (the element's
//    default): word i of a row is the pair (F[k,i], F[k,i+1]) of two bf16,
//    so one load gives both hat rows of an axis, widened to f32 with a shift
//    and a mask (row = 48; word 47 has a zero second half).  f32: word i is
//    F[k,i], and an axis takes two loads (row = 49, word 48 zero).  Rows >= S
//    are zero, so i0+1 = S at x = S-1 reads a zero, as in the plain version,
//    and needs no branch.  74 KB (bf16) or 76 KB (f32) at Kp = 128.
// A warp reads factor row k at 32 pixels' columns: neighbouring words, no
// bank conflicts where neighbouring pixels are alike (two words share a bank
// only 32 columns apart).  So a warp spends 3 (bf16) or 6 (f32) wavefronts
// per pixel and rank plus 1/N for C, against 9.  Blocks loop over chunks of
// 256*N pixels (a grid of as many blocks as fit on the SMs at once), so each
// block stages the factors once.  N is 4 for B2 and packed64 and 2 for B3,
// each the fastest of 1, 2 and 4 on the card.
//
// Outcome (H100 80GB HBM3 at 700 W, chip_smoke.py phase 3b; bf16): 8 frames
// of 1080p take 0.329 / 1.042 / 2.000 ms at ranks 16 / 64 / 128 (B2; first
// design 0.359 / 1.176 / 2.314), 1.13-1.16x from rank 64 up.  The loads are
// no longer the limit: the unrolled loop issues 28.1 instructions per pixel
// and rank (17 f32, 3 loads, 6 integer widenings, 1.6 of address
// arithmetic, the C load and the loop counter), and a warp takes 7.9 SM
// clocks a rank, 89% of the issue rate that count allows.  bf16 pairs as
// float2 (8-byte loads, no widening) ran 1.45-1.9x slower on random pixels:
// 8-byte loads of columns 16 apart conflict.  So f32 keeps single words:
// 1.069 / 2.060 ms at ranks 64 / 128 (B2; as float2 pairs 1.625 / 3.731,
// the first design 1.171 / 2.306; utils/lowrank_timing.py).
// Built with -fmad=false: the plain PyTorch version rounds every product and
// sum on its own, and so does this kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int SB = 48;  // basis rows of the padded factor layout
constexpr int kThreads = 256;
constexpr int kFusedPixels = 2;   // pixels per thread: B3
constexpr int kPackedPixels = 4;  // B2 and packed64

// Words of a factor row in shared memory (see above).
template <bool BF16>
constexpr int kRow = BF16 ? SB : SB + 1;

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Factor row entries i and i+1 of the row at f.
template <bool BF16>
__device__ __forceinline__ float2 factor_pair(const unsigned int* f, int i) {
  if constexpr (BF16) {
    const unsigned int w = f[i];
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
  } else {
    return make_float2(__uint_as_float(f[i]), __uint_as_float(f[i + 1]));
  }
}

// The two nonzero hat weights of x in [0, S-1], at rows i0 = floor(x) and
// i0+1.
template <bool BF16>
__device__ __forceinline__ void hat(float x, int& i0, float& h0, float& h1) {
  const float f = floorf(x);
  i0 = static_cast<int>(f);
  h0 = fmaxf(0.0f, 1.0f - fabsf(x - f));
  h1 = fmaxf(0.0f, 1.0f - fabsf(x - (f + 1.0f)));
  if (BF16) {
    h0 = to_bf16(h0);
    h1 = to_bf16(h1);
  }
}

// The per-pixel chain of every entry, for N pixels at once.  smem: C as
// float4 [K], then U, V, W as words [K, kRow] each (load_factors).
template <bool BF16, int N>
__device__ __forceinline__ void lowrank_chain(const float (&x)[N], const float (&y)[N],
                                              const float (&z)[N], const float4* smem, int K,
                                              float (&out)[N][3]) {
  constexpr int R = kRow<BF16>;
  const unsigned int* su = reinterpret_cast<const unsigned int*>(smem + K);
  const unsigned int* sv = su + K * R;
  const unsigned int* sw = sv + K * R;
  int xi[N], yi[N], zi[N];
  float xh0[N], xh1[N], yh0[N], yh1[N], zh0[N], zh1[N], r[N], g[N], b[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    hat<BF16>(x[j], xi[j], xh0[j], xh1[j]);
    hat<BF16>(y[j], yi[j], yh0[j], yh1[j]);
    hat<BF16>(z[j], zi[j], zh0[j], zh1[j]);
    r[j] = g[j] = b[j] = 0.0f;
  }
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 ck = smem[k];
    const int row = k * R;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float2 fu = factor_pair<BF16>(su + row, xi[j]);
      const float2 fv = factor_pair<BF16>(sv + row, yi[j]);
      const float2 fw = factor_pair<BF16>(sw + row, zi[j]);
      const float u = fu.x * xh0[j] + fu.y * xh1[j];
      const float v = fv.x * yh0[j] + fv.y * yh1[j];
      const float w = fw.x * zh0[j] + fw.y * zh1[j];
      const float p = u * v * w;
      r[j] = r[j] + p * ck.x;
      g[j] = g[j] + p * ck.y;
      b[j] = b[j] + p * ck.z;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    out[j][0] = r[j];
    out[j][1] = g[j];
    out[j][2] = b[j];
  }
}

// Stages the factors in shared memory: C's rows 0..2 as float4 [K], then
// [U | V | W] as words [K, kRow] each, rounded to the compute type.
template <bool BF16>
__device__ __forceinline__ void load_factors(const float* __restrict__ ut,
                                             const float* __restrict__ vt,
                                             const float* __restrict__ wt,
                                             const float* __restrict__ c, int K, float4* smem) {
  constexpr int R = kRow<BF16>;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    smem[k] = make_float4(c[k], c[K + k], c[2 * K + k], 0.0f);
  unsigned int* sf = reinterpret_cast<unsigned int*>(smem + K);
  const int n = K * R;
  const float* const factors[3] = {ut, vt, wt};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* f = factors[a];
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int k = e / R, i = e % R;
      const float lo = i < SB ? f[k * SB + i] : 0.0f;
      if constexpr (BF16) {
        const float hi = i + 1 < SB ? f[k * SB + i + 1] : 0.0f;
        sf[a * n + e] =
            static_cast<unsigned int>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
            (static_cast<unsigned int>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
      } else {
        sf[a * n + e] = __float_as_uint(lo);
      }
    }
  }
  __syncthreads();
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
lowrank_fused_kernel(const float* __restrict__ xyz, const float* __restrict__ ut,
                     const float* __restrict__ vt, const float* __restrict__ wt,
                     const float* __restrict__ c, float* __restrict__ out, long long P, int K) {
  constexpr int N = kFusedPixels;
  extern __shared__ float4 smem[];
  load_factors<BF16>(ut, vt, wt, c, K, smem);
  constexpr long long kChunk = static_cast<long long>(kThreads) * N;
  for (long long base = blockIdx.x * kChunk + threadIdx.x; base < P; base += gridDim.x * kChunk) {
    float x[N], y[N], z[N], o[N][3];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const long long p = base + j * kThreads;
      const bool in = p < P;
      x[j] = in ? xyz[p] : 0.0f;
      y[j] = in ? xyz[P + p] : 0.0f;
      z[j] = in ? xyz[2 * P + p] : 0.0f;
    }
    lowrank_chain<BF16, N>(x, y, z, smem, K, o);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const long long p = base + j * kThreads;
      if (p < P) {
        out[p] = o[j][0];
        out[P + p] = o[j][1];
        out[2 * P + p] = o[j][2];
      }
    }
  }
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
// a 32-bit word, B2) or 16 (RGBA64 as a 64-bit word, packed64).  Component 3
// (alpha) rides through.
template <bool BF16, typename Word>
__global__ void __launch_bounds__(kThreads)
lowrank_packed_kernel(const Word* __restrict__ px, const float* __restrict__ params,
                      const float* __restrict__ ut, const float* __restrict__ vt,
                      const float* __restrict__ wt, const float* __restrict__ c,
                      Word* __restrict__ out, long long P, int K, int size) {
  constexpr int N = kPackedPixels;
  constexpr int B = 2 * sizeof(Word);
  constexpr Word kMask = (Word(1) << B) - 1;
  constexpr Word kAlpha = ~((Word(1) << (3 * B)) - 1);
  extern __shared__ float4 smem[];
  load_factors<BF16>(ut, vt, wt, c, K, smem);
  const float maxval = params[6];
  const float inv_maxval = 1.0f / maxval;
  const float sx = params[0], sy = params[1], sz = params[2];
  const float ox = params[3], oy = params[4], oz = params[5];
  const float smax = static_cast<float>(size - 1);
  constexpr long long kChunk = static_cast<long long>(kThreads) * N;
  for (long long base = blockIdx.x * kChunk + threadIdx.x; base < P; base += gridDim.x * kChunk) {
    Word v[N];
    float x[N], y[N], z[N], o[N][3];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const long long p = base + j * kThreads;
      v[j] = p < P ? px[p] : Word(0);
      x[j] = grid_coord(static_cast<unsigned int>(v[j] & kMask), inv_maxval, sx, ox, smax);
      y[j] = grid_coord(static_cast<unsigned int>((v[j] >> B) & kMask), inv_maxval, sy, oy, smax);
      z[j] = grid_coord(static_cast<unsigned int>((v[j] >> (2 * B)) & kMask), inv_maxval, sz, oz,
                        smax);
    }
    lowrank_chain<BF16, N>(x, y, z, smem, K, o);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const long long p = base + j * kThreads;
      if (p < P)
        out[p] = static_cast<Word>(quantize(o[j][0], maxval)) |
                 (static_cast<Word>(quantize(o[j][1], maxval)) << B) |
                 (static_cast<Word>(quantize(o[j][2], maxval)) << (2 * B)) | (v[j] & kAlpha);
    }
  }
}

size_t smem_bytes(bool bf16, int K) {
  return static_cast<size_t>(K) * sizeof(float4) +
         static_cast<size_t>(3) * K * (bf16 ? kRow<true> : kRow<false>) * sizeof(unsigned int);
}

// Launches kernel on a grid of as many blocks as fit on the card at once
// (each loops over its share of pixels), at most one per chunk of
// `per_block` pixels.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), bool bf16, long long P, int K, int per_block,
           void* stream, Args... args) {
  if (P == 0) return 0;
  const size_t smem = smem_bytes(bf16, K);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const long long need = (P + per_block - 1) / per_block;
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(need < fit ? need : fit);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int launch_fused(const void* xyz, const void* ut, const void* vt, const void* wt, const void* c,
                 void* out, long long P, int K, void* stream) {
  return launch(lowrank_fused_kernel<BF16>, BF16, P, K, kThreads * kFusedPixels, stream,
                static_cast<const float*>(xyz), static_cast<const float*>(ut),
                static_cast<const float*>(vt), static_cast<const float*>(wt),
                static_cast<const float*>(c), static_cast<float*>(out), P, K);
}

template <bool BF16, typename Word>
int launch_packed(const void* px, const void* params, const void* ut, const void* vt,
                  const void* wt, const void* c, void* out, long long P, int K, int size,
                  void* stream) {
  return launch(lowrank_packed_kernel<BF16, Word>, BF16, P, K, kThreads * kPackedPixels, stream,
                static_cast<const Word*>(px), static_cast<const float*>(params),
                static_cast<const float*>(ut), static_cast<const float*>(vt),
                static_cast<const float*>(wt), static_cast<const float*>(c),
                static_cast<Word*>(out), P, K, size);
}

}  // namespace

// Plain C entry points (bound with ctypes): every pointer and the stream are
// void*; the return value is the launch's cudaError_t (0 = launched).
// ut/vt/wt: [K,48] f32, c: [8,K] f32 (rows 0..2 read); bf16: round the
// factors and hat weights to bf16 (compute_dtype bfloat16), else f32.
extern "C" int colorlut_lowrank_fused(const void* xyz, const void* ut, const void* vt,
                                      const void* wt, const void* c, void* out, long long P,
                                      int K, int bf16, void* stream) {
  return bf16 ? launch_fused<true>(xyz, ut, vt, wt, c, out, P, K, stream)
              : launch_fused<false>(xyz, ut, vt, wt, c, out, P, K, stream);
}

// bits: 8 (B2, px/out as 32-bit words) or 16 (packed64, 64-bit words).
extern "C" int colorlut_lowrank_packed(const void* px, const void* params, const void* ut,
                                       const void* vt, const void* wt, const void* c,
                                       void* out, long long P, int K, int size, int bits,
                                       int bf16, void* stream) {
  if (bits == 8)
    return bf16 ? launch_packed<true, unsigned int>(px, params, ut, vt, wt, c, out, P, K, size,
                                                    stream)
                : launch_packed<false, unsigned int>(px, params, ut, vt, wt, c, out, P, K, size,
                                                     stream);
  if (bits == 16)
    return bf16 ? launch_packed<true, unsigned long long>(px, params, ut, vt, wt, c, out, P, K,
                                                          size, stream)
                : launch_packed<false, unsigned long long>(px, params, ut, vt, wt, c, out, P, K,
                                                           size, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* colorlut_lowrank_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
