// Fused YOLOX dark2 C3 block over space-to-depth (s2d) activations, for Hopper.
//
// Replaces the TPU kernel gst_plugins_rs_tpu/ops/pallas_yolox_c3.py::
// c3_s2d_fused (body _make_kernel).  Same function, f32 accumulation,
// activations stored in the input's type (float or bf16):
//
//     x1 = silu(y W1 + b1)                      1x1, [P,C] -> [P,h]
//     x2 = silu(y W2 + b2)                      1x1
//     n times:  t  = silu(x1 Wa_i + ba_i)       1x1
//               x1 = x1 + silu(conv3x3(t, Wb_i) + bb_i)   zero padded
//     out = silu(x1 W3[:h] + x2 W3[h:] + b3)    1x1 over the concat
//
// Operands are COMPACT (ops/yolox_c3.py): the original folded convs as
// in x out matrices, C normal-domain channels in and out, h hidden:
// W1,W2 [C,h], Wa [n,h,h], Wb [9n,h,h] (taps row-major (u,v)), W3 [2h,C],
// in the storage type; biases f32.  y/out stay [B,H,W,4C] in the s2d
// layout: normal-domain pixel (2i+e, 2j+f), channel c, is at
// [b,i,j,(2e+f)C+c], so the kernel reads and writes the normal domain in
// place and no layout pass surrounds it.  The one numeric difference from
// the TPU kernel: it rounds the x2 half of conv3 to the storage type before
// adding the x1 half; here the whole conv3 sum stays in f32.
//
// What bounds it on an H100.  The TPU kernel multiplies dense s2d matrices
// (4C x 4h ...), three quarters of whose blocks are zero: the 1x1s are
// block-diagonal over the 4 phases and the 3x3 puts each original tap in 4
// of 16 phase blocks.  The work the function needs is the normal-domain
// convs, 2Ch + n h^2 + 9n h^2 + 2hC MACs per normal pixel: YOLOX-tiny at
// 640 (s2d 80x80x192, C=48, h=24, n=1) is 10,368 MACs per pixel, 0.531
// GFLOP per image, and moves 9.9 MB in f32 (4.9 MB in, 4.9 MB out).  In f32
// the arithmetic stays full f32 (TF32 would break the model's 1e-3 gate),
// so the peak is the CUDA cores' 67 TFLOP/s: 7.9 us per image, bound by
// operations.  In bf16 the tensor cores (989 TFLOP/s) take 0.54 us and the
// 4.9 MB take 1.5 us: bound by bytes.
//
// Design.  The TPU kernel keeps one whole image resident (~26 MiB of VMEM);
// an H100 block has at most 227 KB of shared memory, so this kernel tiles
// space: each block owns a TSxTS tile of NORMAL-domain pixels of one image
// (TS even, so tiles align with s2d pixels) and recomputes an n-pixel halo
// around it (the n compact 3x3s reach one normal pixel each).  x1 and t
// live in shared memory over the (TS+2n)^2 region and x2 over the core
// tile; nothing but y, the weights and out touches device memory, and one
// launch covers the whole batch (grid = tiles x B).  Only the non-zero
// blocks are computed: every product is a compact one.
//  - f32: FMA on the CUDA cores.  Each thread owns a 4-pixel x 4-channel
//    register tile, reads activations as 16-byte vectors (y from device
//    memory, x1/t/x2 from shared memory) and weights through the read-only
//    cache (41 KB at tiny, L1-resident).
//  - bf16: warp-level tensor cores, mma.sync m16n8k16 (m16n8k8 for a K tail
//    of 8) with f32 accumulators.  y's region is staged in shared memory;
//    A fragments come from shared memory by ldmatrix, one pixel row address
//    per lane, so the 3x3's nine taps read shifted pixel rows of t with no
//    copies (the TPU kernel's row-shifted views).  The weights of each
//    group of passes (W1/W2, then Wa_i with Wb_i, W3) are staged transposed
//    ([out][in]) in shared memory by plain loads, and B fragments are read
//    from there.  Row strides are padded to an odd number of 16-byte units,
//    so ldmatrix rows and B fragment words hit distinct banks.  Bias and
//    SiLU in f32, results stored as bf16 where the TPU kernel stores.
// No cp.async, TMA or wgmma yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int MP = 4;     // f32: pixels per thread tile
constexpr int NP = 4;     // f32: output channels per thread tile
constexpr int NTMAX = 4;  // bf16: n8 tiles per warp task (32 output channels)

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }
// bf16 results keep 8 bits: the fast exponential and division (2 ulp) do
__device__ __forceinline__ float silu_fast(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

// The geometry of one block: a TSxTS core tile of normal-domain pixels and
// its n-pixel halo, the region of side S = TS+2n.  Level L is the square of
// side TS+2L centred on the core (level 0); region(L, m) is the region index
// (row-major over side S) of its pixel m.
struct Tile {
  int NH, NW;  // normal-domain image size (2H, 2W)
  int W, C;    // s2d width, normal-domain channels
  int TS, n, S;
  int oy, ox;  // image row/col of region pixel 0

  __device__ Tile(int H, int W_, int C_, int TS_, int n_, int tile)
      : NH(2 * H), NW(2 * W_), W(W_), C(C_), TS(TS_), n(n_), S(TS_ + 2 * n_) {
    const int tiles_x = (NW + TS - 1) / TS;
    oy = (tile / tiles_x) * TS - n;
    ox = (tile % tiles_x) * TS - n;
  }
  __device__ __forceinline__ int region(int L, int m) const {
    const int side = TS + 2 * L, off = n - L;
    return (off + m / side) * S + off + m % side;
  }
  __device__ __forceinline__ bool in_image(int r) const {
    const int gy = oy + r / S, gx = ox + r % S;
    return gy >= 0 && gy < NH && gx >= 0 && gx < NW;
  }
  // offset of region pixel r's C channels in one s2d image
  __device__ __forceinline__ size_t offset(int r) const {
    const int gy = oy + r / S, gx = ox + r % S;
    return (static_cast<size_t>(gy >> 1) * W + (gx >> 1)) * 4 * C + ((gy & 1) * 2 + (gx & 1)) * C;
  }
};

// ---------------------------------------------------------------------------
// f32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

// acc[i][j] += sum_{k<K} a[i][k] * w[k*ldw + j]; a null row reads as zeros.
__device__ __forceinline__ void mac(float (&acc)[MP][NP], const float* const (&a)[MP], int K,
                                    const float* __restrict__ w, int ldw) {
  for (int k = 0; k < K; k += 4) {
    float av[MP][4];
#pragma unroll
    for (int i = 0; i < MP; ++i) {
      if (a[i] != nullptr) {
        const float4 v = *reinterpret_cast<const float4*>(a[i] + k);
        av[i][0] = v.x; av[i][1] = v.y; av[i][2] = v.z; av[i][3] = v.w;
      } else {
        av[i][0] = av[i][1] = av[i][2] = av[i][3] = 0.0f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 wv =
          __ldg(reinterpret_cast<const float4*>(w + static_cast<size_t>(k + kk) * ldw));
#pragma unroll
      for (int i = 0; i < MP; ++i) {
        acc[i][0] = fmaf(av[i][kk], wv.x, acc[i][0]);
        acc[i][1] = fmaf(av[i][kk], wv.y, acc[i][1]);
        acc[i][2] = fmaf(av[i][kk], wv.z, acc[i][2]);
        acc[i][3] = fmaf(av[i][kk], wv.w, acc[i][3]);
      }
    }
  }
}

// One [M x N] product over the block: thread tiles of MP pixels x NP
// channels, `body(acc, m0, n0)` accumulates a tile, `epi(m, n0, v)` stores
// the NP values of pixel m (pixels past M are dropped).
template <typename Body, typename Epi>
__device__ __forceinline__ void fma_pass(int M, int N, Body body, Epi epi) {
  const int ng = N / NP;
  const int tiles = ((M + MP - 1) / MP) * ng;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const int m0 = (t / ng) * MP, n0 = (t % ng) * NP;
    float acc[MP][NP] = {};
    body(acc, m0, n0);
#pragma unroll
    for (int i = 0; i < MP; ++i)
      if (m0 + i < M) epi(m0 + i, n0, acc[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
c3_f32_kernel(const float* __restrict__ y, const float* __restrict__ W1,
              const float* __restrict__ b1, const float* __restrict__ W2,
              const float* __restrict__ b2, const float* __restrict__ Wa,
              const float* __restrict__ ba, const float* __restrict__ Wb,
              const float* __restrict__ bb, const float* __restrict__ W3,
              const float* __restrict__ b3, float* __restrict__ out,
              int H, int W, int C, int h, int n, int TS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile g(H, W, C, TS, n, blockIdx.x);
  const int S = g.S;
  float* X1 = reinterpret_cast<float*>(smem_raw);              // [S*S][h]   x1 over the region
  float* Tb = X1 + S * S * h;     // [S*S][h]   t, the 3x3's operand
  float* X2 = Tb + S * S * h;     // [TS*TS][h] x2 over the core tile
  const size_t image = static_cast<size_t>(H) * W * 4 * C;
  const float* yb = y + blockIdx.y * image;
  float* ob = out + blockIdx.y * image;
  auto y_row = [&](int r) -> const float* { return g.in_image(r) ? yb + g.offset(r) : nullptr; };

  // x1 = silu(y W1 + b1) on level n
  const int Mn = S * S;
  fma_pass(Mn, h,
      [&](float (&acc)[MP][NP], int m0, int n0) {
        const float* a[MP];
#pragma unroll
        for (int i = 0; i < MP; ++i) a[i] = y_row(g.region(n, min(m0 + i, Mn - 1)));
        mac(acc, a, C, W1 + n0, h);
      },
      [&](int m, int n0, const float (&v)[NP]) {
        float* dst = X1 + g.region(n, m) * h + n0;
#pragma unroll
        for (int j = 0; j < NP; ++j) dst[j] = silu(v[j] + b1[n0 + j]);
      });
  // x2 = silu(y W2 + b2) on the core
  const int M0 = TS * TS;
  fma_pass(M0, h,
      [&](float (&acc)[MP][NP], int m0, int n0) {
        const float* a[MP];
#pragma unroll
        for (int i = 0; i < MP; ++i) a[i] = y_row(g.region(0, min(m0 + i, M0 - 1)));
        mac(acc, a, C, W2 + n0, h);
      },
      [&](int m, int n0, const float (&v)[NP]) {
        float* dst = X2 + m * h + n0;
#pragma unroll
        for (int j = 0; j < NP; ++j) dst[j] = silu(v[j] + b2[n0 + j]);
      });
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    const int L = n - i;
    const int ML = (TS + 2 * L) * (TS + 2 * L);
    // t = silu(x1 Wa_i + ba_i) on level L, zero outside the image (the
    // 3x3's zero padding)
    fma_pass(ML, h,
        [&](float (&acc)[MP][NP], int m0, int n0) {
          const float* a[MP];
#pragma unroll
          for (int k = 0; k < MP; ++k) a[k] = X1 + g.region(L, min(m0 + k, ML - 1)) * h;
          mac(acc, a, h, Wa + static_cast<size_t>(i) * h * h + n0, h);
        },
        [&](int m, int n0, const float (&v)[NP]) {
          const int r = g.region(L, m);
          const bool inside = g.in_image(r);
          float* dst = Tb + r * h + n0;
#pragma unroll
          for (int j = 0; j < NP; ++j) dst[j] = inside ? silu(v[j] + ba[i * h + n0 + j]) : 0.0f;
        });
    __syncthreads();
    // x1 += silu(conv3x3(t, Wb_i) + bb_i) on level L-1: 9 shifted tap products
    const int ML1 = (TS + 2 * L - 2) * (TS + 2 * L - 2);
    fma_pass(ML1, h,
        [&](float (&acc)[MP][NP], int m0, int n0) {
          int rows[MP];
#pragma unroll
          for (int k = 0; k < MP; ++k) rows[k] = g.region(L - 1, min(m0 + k, ML1 - 1));
          for (int tap = 0; tap < 9; ++tap) {
            const int shift = (tap / 3 - 1) * S + (tap % 3 - 1);
            const float* a[MP];
#pragma unroll
            for (int k = 0; k < MP; ++k) a[k] = Tb + (rows[k] + shift) * h;
            mac(acc, a, h, Wb + static_cast<size_t>(i * 9 + tap) * h * h + n0, h);
          }
        },
        [&](int m, int n0, const float (&v)[NP]) {
          float* dst = X1 + g.region(L - 1, m) * h + n0;
#pragma unroll
          for (int j = 0; j < NP; ++j) dst[j] += silu(v[j] + bb[i * h + n0 + j]);
        });
    __syncthreads();
  }

  // out = silu(x1 W3[:h] + x2 W3[h:] + b3) on the core, inside the image
  fma_pass(M0, C,
      [&](float (&acc)[MP][NP], int m0, int n0) {
        const float* a[MP];
#pragma unroll
        for (int k = 0; k < MP; ++k) a[k] = X1 + g.region(0, min(m0 + k, M0 - 1)) * h;
        mac(acc, a, h, W3 + n0, C);
#pragma unroll
        for (int k = 0; k < MP; ++k) a[k] = X2 + min(m0 + k, M0 - 1) * h;
        mac(acc, a, h, W3 + static_cast<size_t>(h) * C + n0, C);
      },
      [&](int m, int n0, const float (&v)[NP]) {
        const int r = g.region(0, m);
        if (!g.in_image(r)) return;
        float4 o;
        o.x = silu(v[0] + b3[n0]);
        o.y = silu(v[1] + b3[n0 + 1]);
        o.z = silu(v[2] + b3[n0 + 2]);
        o.w = silu(v[3] + b3[n0 + 3]);
        *reinterpret_cast<float4*>(ob + g.offset(r) + n0) = o;
      });
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

// A row stride (elements) for K bf16 values: a multiple of 8 (16-byte rows
// for ldmatrix) that is an odd number of 16-byte units, so the 8 rows of an
// ldmatrix phase and the 8 rows of a B fragment fall in distinct banks.
__host__ __device__ __forceinline__ int padded(int K) { return (K / 8) % 2 ? K : K + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&a)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t (&a)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(a[0]), "=r"(a[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// acc[j] += A[16 x K] Bt[8j..8j+8][K]^T for j < nt.  arow: this lane's A
// row in shared memory (lane l holds pixel row l%16); Bt: [N][ldb] weights,
// K contiguous, already offset to the warp's first output channel.
__device__ __forceinline__ void mma_seg(float (&acc)[NTMAX][4], int nt, const bf16* arow,
                                        const bf16* Bt, int ldb, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t a0 = smem_addr(arow);
  const bf16* b = Bt + g * ldb + 2 * t;
  int k = 0;
  for (; k + 16 <= K; k += 16) {
    uint32_t a[4];
    ldsm_x4(a0 + (k + (lane >> 4) * 8) * 2, a);
#pragma unroll
    for (int j = 0; j < NTMAX; ++j) {
      if (j < nt) {
        const bf16* bj = b + 8 * j * ldb + k;
        mma_k16(acc[j], a, *reinterpret_cast<const uint32_t*>(bj),
                *reinterpret_cast<const uint32_t*>(bj + 8));
      }
    }
  }
  if (k < K) {  // K % 16 == 8
    uint32_t a[2];
    ldsm_x2(a0 + k * 2, a);
#pragma unroll
    for (int j = 0; j < NTMAX; ++j)
      if (j < nt) mma_k8(acc[j], a, *reinterpret_cast<const uint32_t*>(b + 8 * j * ldb + k));
  }
}

// One [M x N] product over the block: warp tasks of 16 pixels x up to 64
// channels.  `body(acc, nt, am, n0)` accumulates a task (am: this lane's A
// pixel, clamped to M-1); `epi(m, n, v0, v1)` stores channels n, n+1 of
// pixel m (pixels past M are dropped).
template <typename Body, typename Epi>
__device__ __forceinline__ void mma_pass(int M, int N, Body body, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = (N + 8 * NTMAX - 1) / (8 * NTMAX);
  const int tasks = ((M + 15) / 16) * nch;
  for (int task = warp; task < tasks; task += kWarps) {
    const int m0 = (task / nch) * 16, n0 = (task % nch) * 8 * NTMAX;
    const int nt = min(NTMAX, (N - n0) / 8);
    float acc[NTMAX][4] = {};
    body(acc, nt, min(m0 + (lane & 15), M - 1), n0);
    const int r0 = m0 + (lane >> 2), c0 = n0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NTMAX; ++j) {
      if (j < nt) {
        if (r0 < M) epi(r0, c0 + 8 * j, acc[j][0], acc[j][1]);
        if (r0 + 8 < M) epi(r0 + 8, c0 + 8 * j, acc[j][2], acc[j][3]);
      }
    }
  }
}

// dst[o*ld + k] = src[k*N + o]: a K x N (in x out) matrix, transposed; a
// warp per row k, its lanes along o.
__device__ __forceinline__ void stage_t(bf16* dst, int ld, const bf16* __restrict__ src, int K,
                                        int N) {
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < K; k += kWarps)
    for (int o = lane; o < N; o += 32) dst[o * ld + k] = src[k * N + o];
}

__device__ __forceinline__ float2 unpack2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Shared memory of the bf16 kernel, in bf16 elements: Y (y over the region,
// later t), X1, X2, WA (W1|W2, later W3), WB (Wa_i|Wb_i).
struct Bf16Smem {
  int ldC, ldh, ld2h, y, x1, x2, wa, wb;
  __host__ __device__ Bf16Smem(int C, int h, int n, int TS) {
    const int S = TS + 2 * n, R = S * S;
    ldC = padded(C);
    ldh = padded(h);
    ld2h = padded(2 * h);
    y = R * (ldC > ldh ? ldC : ldh);
    x1 = R * ldh;
    x2 = TS * TS * ldh;
    wa = 2 * h * ldC > C * ld2h ? 2 * h * ldC : C * ld2h;
    wb = 10 * h * ldh;
  }
  __host__ __device__ size_t bytes() const {
    return static_cast<size_t>(y + x1 + x2 + wa + wb) * sizeof(bf16);
  }
};

__global__ void __launch_bounds__(kThreads)
c3_bf16_kernel(const bf16* __restrict__ y, const bf16* __restrict__ W1,
               const float* __restrict__ b1, const bf16* __restrict__ W2,
               const float* __restrict__ b2, const bf16* __restrict__ Wa,
               const float* __restrict__ ba, const bf16* __restrict__ Wb,
               const float* __restrict__ bb, const bf16* __restrict__ W3,
               const float* __restrict__ b3, bf16* __restrict__ out,
               int H, int W, int C, int h, int n, int TS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile g(H, W, C, TS, n, blockIdx.x);
  const int S = g.S;
  const Bf16Smem lay(C, h, n, TS);
  const int ldC = lay.ldC, ldh = lay.ldh, ld2h = lay.ld2h;
  bf16* Ys = reinterpret_cast<bf16*>(smem_raw);  // [S*S][ldC] y over the region
  bf16* Tb = Ys;                                  // then t, [S*S][ldh]
  bf16* X1 = Ys + lay.y;     // [S*S][ldh]   x1 over the region
  bf16* X2 = X1 + lay.x1;    // [TS*TS][ldh] x2 over the core tile
  bf16* WA = X2 + lay.x2;    // W1t [h][ldC] | W2t [h][ldC]; then W3t [C][ld2h]
  bf16* WB = WA + lay.wa;    // Wat_i [h][ldh] | Wbt_i 9 x [h][ldh]
  const size_t image = static_cast<size_t>(H) * W * 4 * C;
  const bf16* yb = y + blockIdx.y * image;
  bf16* ob = out + blockIdx.y * image;

  // stage y over the region (zeros outside the image), W1, W2, Wa_0, Wb_0
  const int R = S * S, cv = C / 8;
  for (int idx = threadIdx.x; idx < R * cv; idx += kThreads) {
    const int r = idx / cv, c = (idx % cv) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (g.in_image(r)) v = __ldg(reinterpret_cast<const uint4*>(yb + g.offset(r) + c));
    *reinterpret_cast<uint4*>(Ys + r * ldC + c) = v;
  }
  stage_t(WA, ldC, W1, C, h);
  stage_t(WA + h * ldC, ldC, W2, C, h);
  auto stage_bottleneck = [&](int i) {
    stage_t(WB, ldh, Wa + static_cast<size_t>(i) * h * h, h, h);
    for (int tap = 0; tap < 9; ++tap)
      stage_t(WB + (1 + tap) * h * ldh, ldh, Wb + static_cast<size_t>(i * 9 + tap) * h * h, h, h);
  };
  stage_bottleneck(0);
  __syncthreads();

  // x1 = silu(y W1 + b1) on level n, x2 = silu(y W2 + b2) on the core
  mma_pass(R, h,
      [&](float (&acc)[NTMAX][4], int nt, int am, int n0) {
        mma_seg(acc, nt, Ys + g.region(n, am) * ldC, WA + n0 * ldC, ldC, C);
      },
      [&](int m, int c, float v0, float v1) {
        store2(X1 + g.region(n, m) * ldh + c, silu_fast(v0 + b1[c]),
               silu_fast(v1 + b1[c + 1]));
      });
  const int M0 = TS * TS;
  mma_pass(M0, h,
      [&](float (&acc)[NTMAX][4], int nt, int am, int n0) {
        mma_seg(acc, nt, Ys + g.region(0, am) * ldC, WA + (h + n0) * ldC, ldC, C);
      },
      [&](int m, int c, float v0, float v1) {
        store2(X2 + m * ldh + c, silu_fast(v0 + b2[c]), silu_fast(v1 + b2[c + 1]));
      });
  __syncthreads();
  stage_t(WA, ld2h, W3, 2 * h, C);  // read only after the syncs below

  for (int i = 0; i < n; ++i) {
    if (i > 0) {
      stage_bottleneck(i);
      __syncthreads();
    }
    const int L = n - i;
    const int ML = (TS + 2 * L) * (TS + 2 * L);
    // t = silu(x1 Wa_i + ba_i) on level L, zero outside the image
    mma_pass(ML, h,
        [&](float (&acc)[NTMAX][4], int nt, int am, int n0) {
          mma_seg(acc, nt, X1 + g.region(L, am) * ldh, WB + n0 * ldh, ldh, h);
        },
        [&](int m, int c, float v0, float v1) {
          const int r = g.region(L, m);
          if (g.in_image(r))
            store2(Tb + r * ldh + c, silu_fast(v0 + ba[i * h + c]),
                   silu_fast(v1 + ba[i * h + c + 1]));
          else
            store2(Tb + r * ldh + c, 0.0f, 0.0f);
        });
    __syncthreads();
    // x1 += silu(conv3x3(t, Wb_i) + bb_i) on level L-1: 9 shifted tap products
    const int ML1 = (TS + 2 * L - 2) * (TS + 2 * L - 2);
    mma_pass(ML1, h,
        [&](float (&acc)[NTMAX][4], int nt, int am, int n0) {
          const int r = g.region(L - 1, am);
          for (int tap = 0; tap < 9; ++tap) {
            const int shift = (tap / 3 - 1) * S + (tap % 3 - 1);
            mma_seg(acc, nt, Tb + (r + shift) * ldh, WB + ((1 + tap) * h + n0) * ldh, ldh, h);
          }
        },
        [&](int m, int c, float v0, float v1) {
          bf16* dst = X1 + g.region(L - 1, m) * ldh + c;
          const float2 old = unpack2(dst);
          store2(dst, old.x + silu_fast(v0 + bb[i * h + c]),
                 old.y + silu_fast(v1 + bb[i * h + c + 1]));
        });
    __syncthreads();
  }

  // out = silu(x1 W3[:h] + x2 W3[h:] + b3) on the core, inside the image
  mma_pass(M0, C,
      [&](float (&acc)[NTMAX][4], int nt, int am, int n0) {
        mma_seg(acc, nt, X1 + g.region(0, am) * ldh, WA + n0 * ld2h, ld2h, h);
        mma_seg(acc, nt, X2 + am * ldh, WA + n0 * ld2h + h, ld2h, h);
      },
      [&](int m, int c, float v0, float v1) {
        const int r = g.region(0, m);
        if (g.in_image(r))
          store2(ob + g.offset(r) + c, silu_fast(v0 + b3[c]), silu_fast(v1 + b3[c + 1]));
      });
}

size_t smem_bytes(bool bf16_, int C, int h, int n, int TS) {
  if (bf16_) return Bf16Smem(C, h, n, TS).bytes();
  const int S = TS + 2 * n;
  return static_cast<size_t>(2 * S * S + TS * TS) * h * sizeof(float);
}

template <typename T, typename Kernel>
int launch(Kernel kernel, const void* y, const void* W1, const void* b1, const void* W2,
           const void* b2, const void* Wa, const void* ba, const void* Wb, const void* bb,
           const void* W3, const void* b3, void* out, int B, int H, int W, int C, int h, int n,
           int TS, void* stream) {
  const size_t smem = smem_bytes(sizeof(T) == 2, C, h, n, TS);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((2 * H + TS - 1) / TS) * ((2 * W + TS - 1) / TS), B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(W1), static_cast<const float*>(b1),
      static_cast<const T*>(W2), static_cast<const float*>(b2),
      static_cast<const T*>(Wa), static_cast<const float*>(ba),
      static_cast<const T*>(Wb), static_cast<const float*>(bb),
      static_cast<const T*>(W3), static_cast<const float*>(b3),
      static_cast<T*>(out), H, W, C, h, n, TS);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes): every pointer and the stream are
// void*; the return value is the launch's cudaError_t (0 = launched).  C and
// h are the normal-domain channels (multiples of 8), TS the tile side.
extern "C" int yolox_c3_f32(const void* y, const void* W1, const void* b1, const void* W2,
                            const void* b2, const void* Wa, const void* ba, const void* Wb,
                            const void* bb, const void* W3, const void* b3, void* out,
                            int B, int H, int W, int C, int h, int n, int TS, void* stream) {
  return launch<float>(c3_f32_kernel, y, W1, b1, W2, b2, Wa, ba, Wb, bb, W3, b3, out,
                       B, H, W, C, h, n, TS, stream);
}

extern "C" int yolox_c3_bf16(const void* y, const void* W1, const void* b1, const void* W2,
                             const void* b2, const void* Wa, const void* ba, const void* Wb,
                             const void* bb, const void* W3, const void* b3, void* out,
                             int B, int H, int W, int C, int h, int n, int TS, void* stream) {
  return launch<bf16>(c3_bf16_kernel, y, W1, b1, W2, b2, Wa, ba, Wb, bb, W3, b3, out,
                      B, H, W, C, h, n, TS, stream);
}

// Dynamic shared memory of one block (bytes); bf16 != 0 for the bf16 kernel.
extern "C" int yolox_c3_smem_bytes(int bf16_, int C, int h, int n, int TS) {
  return static_cast<int>(smem_bytes(bf16_ != 0, C, h, n, TS));
}

extern "C" const char* yolox_c3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
