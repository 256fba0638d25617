// Low-rank (CP) 3D-LUT sampling for colorlut precision=approx, for Hopper.
//
// Replaces two TPU kernels of gst_plugins_rs_tpu/ops/pallas_colorlut_lowrank.py:
//   B3  lowrank_sample_pallas (body _kernel): f32 grid coordinates xyz [3,P]
//       in [0,S-1] -> interpolated LUT outputs [3,P] f32;
//   B2  lowrank_sample_pallas_packed (body _packed_kernel): RGBA u8 pixels
//       as int32 [P] -> RGBA int32 [P], with the normalisation (scale,
//       offset, maxval from params[8]), the rounding (half to even) and the
//       repacking in the kernel; alpha rides through.
// Both run the same per-pixel chain, lowrank_chain() below, so they are
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
// What bounds it on an H100 (1080p, P = 2,073,600 per frame): 17 f32
// operations per pixel and rank (2 products and a sum per axis, 2 products,
// 3 products and 3 sums), 17*K*P in all, against 4 B in and 4 B out per
// pixel (B2) or 12 + 12 (B3).  At K = 64 that is 2.26 GFLOP per frame, 34 us
// at the 67 TFLOP/s of the CUDA cores, against 2.5 us (B2) or 7.4 us (B3)
// for the bytes at 3.35 TB/s: the kernel is bound by operations.
//
// Design.  The TPU kernel tiles pixels along lanes and runs the products on
// the MXU.  Here one thread owns one pixel and reads only the two nonzero
// rows of each factor: the dense product's 48 rows would be 24x the work.
// The factors sit in shared memory in their padded [Kp,48] layout, already
// rounded to bf16 (3 x Kp x 48 f32: 72 KB at Kp = 128); rows >= S are zero,
// so i0+1 = S at x = S-1 reads a zero and needs no branch (the read index is
// clamped to 47, where the weight is 0).  A warp reads factor row k at 32
// pixels' columns: neighbouring columns, no bank conflicts where neighbouring
// pixels are alike.  Blocks loop over the pixels (a grid of as many blocks
// as fit on the SMs at once), so each block loads the factors once.
// Built with -fmad=false: the plain PyTorch version rounds every product and
// sum on its own, and so does this kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int SB = 48;  // basis rows of the padded factor layout
constexpr int kThreads = 256;

template <bool BF16>
__device__ __forceinline__ float to_compute(float v) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// The two nonzero hat weights of x in [0, S-1]: rows i0 = floor(x) and i0+1
// (read index clamped to SB-1, where the weight is 0).
template <bool BF16>
__device__ __forceinline__ void hat(float x, int& i0, int& i1, float& h0, float& h1) {
  const float f = floorf(x);
  i0 = static_cast<int>(f);
  i1 = min(i0 + 1, SB - 1);
  h0 = to_compute<BF16>(fmaxf(0.0f, 1.0f - fabsf(x - f)));
  h1 = to_compute<BF16>(fmaxf(0.0f, 1.0f - fabsf(x - (f + 1.0f))));
}

// The per-pixel chain shared by B2 and B3.  su/sv/sw: [K,SB] factors in
// shared memory, rounded to the compute type; sc: [3,K] f32.
template <bool BF16>
__device__ __forceinline__ void lowrank_chain(float x, float y, float z, const float* su,
                                              const float* sv, const float* sw,
                                              const float* sc, int K, float out[3]) {
  int xi0, xi1, yi0, yi1, zi0, zi1;
  float xh0, xh1, yh0, yh1, zh0, zh1;
  hat<BF16>(x, xi0, xi1, xh0, xh1);
  hat<BF16>(y, yi0, yi1, yh0, yh1);
  hat<BF16>(z, zi0, zi1, zh0, zh1);
  float r = 0.0f, g = 0.0f, b = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float* uk = su + k * SB;
    const float* vk = sv + k * SB;
    const float* wk = sw + k * SB;
    const float u = uk[xi0] * xh0 + uk[xi1] * xh1;
    const float v = vk[yi0] * yh0 + vk[yi1] * yh1;
    const float w = wk[zi0] * zh0 + wk[zi1] * zh1;
    const float p = u * v * w;
    r = r + p * sc[k];
    g = g + p * sc[K + k];
    b = b + p * sc[2 * K + k];
  }
  out[0] = r;
  out[1] = g;
  out[2] = b;
}

// Copies the factors into shared memory, rounded to the compute type:
// [U | V | W] as [K,SB] each, then C's rows 0..2 as [3,K].
template <bool BF16>
__device__ __forceinline__ void load_factors(const float* __restrict__ ut,
                                             const float* __restrict__ vt,
                                             const float* __restrict__ wt,
                                             const float* __restrict__ c, int K, float* smem) {
  const int n = K * SB;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    smem[i] = to_compute<BF16>(ut[i]);
    smem[n + i] = to_compute<BF16>(vt[i]);
    smem[2 * n + i] = to_compute<BF16>(wt[i]);
  }
  for (int i = threadIdx.x; i < 3 * K; i += blockDim.x) smem[3 * n + i] = c[i];
  __syncthreads();
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
lowrank_fused_kernel(const float* __restrict__ xyz, const float* __restrict__ ut,
                     const float* __restrict__ vt, const float* __restrict__ wt,
                     const float* __restrict__ c, float* __restrict__ out, long long P, int K) {
  extern __shared__ float smem[];
  load_factors<BF16>(ut, vt, wt, c, K, smem);
  const int n = K * SB;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p < P;
       p += stride) {
    float o[3];
    lowrank_chain<BF16>(xyz[p], xyz[P + p], xyz[2 * P + p], smem, smem + n, smem + 2 * n,
                        smem + 3 * n, K, o);
    out[p] = o[0];
    out[P + p] = o[1];
    out[2 * P + p] = o[2];
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

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
lowrank_packed_kernel(const unsigned int* __restrict__ px, const float* __restrict__ params,
                      const float* __restrict__ ut, const float* __restrict__ vt,
                      const float* __restrict__ wt, const float* __restrict__ c,
                      unsigned int* __restrict__ out, long long P, int K, int size) {
  extern __shared__ float smem[];
  load_factors<BF16>(ut, vt, wt, c, K, smem);
  const int n = K * SB;
  const float maxval = params[6];
  const float inv_maxval = 1.0f / maxval;
  const float smax = static_cast<float>(size - 1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p < P;
       p += stride) {
    const unsigned int v = px[p];
    const float x = grid_coord(v & 255u, inv_maxval, params[0], params[3], smax);
    const float y = grid_coord((v >> 8) & 255u, inv_maxval, params[1], params[4], smax);
    const float z = grid_coord((v >> 16) & 255u, inv_maxval, params[2], params[5], smax);
    float o[3];
    lowrank_chain<BF16>(x, y, z, smem, smem + n, smem + 2 * n, smem + 3 * n, K, o);
    out[p] = quantize(o[0], maxval) | (quantize(o[1], maxval) << 8) |
             (quantize(o[2], maxval) << 16) | (v & 0xff000000u);
  }
}

size_t smem_bytes(int K) { return (static_cast<size_t>(3) * K * SB + 3 * K) * sizeof(float); }

// Blocks that fit on the card at once (each loops over its share of pixels),
// at most one per 256 pixels.
template <typename Kernel>
int grid_for(Kernel kernel, size_t smem, long long P, int* blocks) {
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
  const long long need = (P + kThreads - 1) / kThreads;
  long long g = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *blocks = static_cast<int>(need < g ? need : g);
  return 0;
}

template <bool BF16>
int launch_fused(const void* xyz, const void* ut, const void* vt, const void* wt, const void* c,
                 void* out, long long P, int K, void* stream) {
  if (P == 0) return 0;
  const size_t smem = smem_bytes(K);
  int blocks = 0;
  if (int err = grid_for(lowrank_fused_kernel<BF16>, smem, P, &blocks)) return err;
  lowrank_fused_kernel<BF16><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(ut),
      static_cast<const float*>(vt), static_cast<const float*>(wt),
      static_cast<const float*>(c), static_cast<float*>(out), P, K);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int launch_packed(const void* px, const void* params, const void* ut, const void* vt,
                  const void* wt, const void* c, void* out, long long P, int K, int size,
                  void* stream) {
  if (P == 0) return 0;
  const size_t smem = smem_bytes(K);
  int blocks = 0;
  if (int err = grid_for(lowrank_packed_kernel<BF16>, smem, P, &blocks)) return err;
  lowrank_packed_kernel<BF16><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned int*>(px), static_cast<const float*>(params),
      static_cast<const float*>(ut), static_cast<const float*>(vt),
      static_cast<const float*>(wt), static_cast<const float*>(c),
      static_cast<unsigned int*>(out), P, K, size);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes): every pointer and the stream are
// void*; the return value is the launch's cudaError_t (0 = launched).
// ut/vt/wt: [K,48] f32, c: [8,K] f32 (rows 0..2 read); bf16 != 0 rounds the
// factors and hat weights to bfloat16 (compute_dtype="bfloat16").
extern "C" int colorlut_lowrank_fused(const void* xyz, const void* ut, const void* vt,
                                      const void* wt, const void* c, void* out, long long P,
                                      int K, int bf16, void* stream) {
  return bf16 ? launch_fused<true>(xyz, ut, vt, wt, c, out, P, K, stream)
              : launch_fused<false>(xyz, ut, vt, wt, c, out, P, K, stream);
}

extern "C" int colorlut_lowrank_packed(const void* px, const void* params, const void* ut,
                                       const void* vt, const void* wt, const void* c,
                                       void* out, long long P, int K, int size, int bf16,
                                       void* stream) {
  return bf16 ? launch_packed<true>(px, params, ut, vt, wt, c, out, P, K, size, stream)
              : launch_packed<false>(px, params, ut, vt, wt, c, out, P, K, size, stream);
}

extern "C" const char* colorlut_lowrank_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
