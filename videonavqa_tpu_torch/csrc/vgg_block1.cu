// Fused first block of the frozen VGG stem: conv1_1 -> ReLU -> conv1_2 -> ReLU -> pool1.
//
// Replaces videonavqa_tpu/kernels/vgg_block1_pallas.py (vgg_block1_pallas):
//   h1  = relu(conv3x3(x, w1) + b1)        SAME padding, f32 sums, stored in T
//   y   = relu(conv3x3(h1, w2) + b2)       SAME padding, f32 sums
//   out = maxpool2x2(y)                    stored in T
// x [M, 160, 208, 3] NHWC, w1 [64, 3, 3, 3] and w2 [64, 64, 3, 3] OIHW (all in
// T, bf16 for serving or f32 for the tight check), b1 and b2 [64] f32 ->
// out [M, 80, 104, 64] NHWC in T. h1 is rounded to T before conv1_2, where
// the Pallas kernel rounds it.
//
// What bounds it on an H100: operations. A frame is 2.57 GFLOP (conv1_1
// 0.115, conv1_2 2.45) against 1.26 MB in and out in bf16, ~2,000 FLOP a
// byte, far above the card's ~295. Unfused, the 64-channel h1 and conv1_2's
// output at 160x208 (4.3 MB a frame each in bf16) go to device memory and
// back; here neither leaves the SM. Design:
//   - a persistent grid, one 512-thread block per SM (the shared tiles take
//     175 KB), walks 32x16-pixel tiles of conv1_2's output (16x8 pooled);
//   - bf16: conv1_2's weights [64 out][9 taps x 64 in] are loaded into
//     shared memory once per block; each tile loads its 36x20x3 input window
//     (2-pixel halo, zeros outside the frame), computes h1 for the 34x18
//     window on the CUDA cores into shared memory, then conv1_2 as an
//     implicit GEMM on the tensor cores (mma.sync m16n8k16 bf16 -> f32; each
//     warp owns two output rows x 16 pixels x 64 channels, fragments by
//     ldmatrix from rows padded by 16 bytes so the loads hit 32 banks);
//     bias, ReLU and the 2x2 max run on the accumulators (row pairs in one
//     thread, column pairs one shuffle apart) and only the pooled tile is
//     stored. The next tile's input window loads while the tensor cores work;
//   - f32 (the tight check, not a served path): the same tiles, conv1_2 on
//     the CUDA cores with w2 read through the read-only cache.
// conv1_1 sums its 27 products in a fixed order (tap by tap, then input
// channel) with FMAs; vgg_block1_plain sums in the same order, so in bf16,
// where every product is exact in f32, both round h1 to the same values.
// h1 positions outside the frame are zero, not relu(b1): conv1_2's SAME
// padding reads zeros there. wgmma, TMA and conv1_1 on the tensor cores are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int H = 160, W = 208, CIN = 3, C = 64;   // the frame, conv1_1's channels
constexpr int PH = H / 2, PW = W / 2;               // pooled output
constexpr int TH = 32, TW = 16;                     // conv1_2 outputs per tile
constexpr int HH = TH + 2, HWD = TW + 2;            // h1 window (1-pixel halo)
constexpr int XH = TH + 4, XWD = TW + 4;            // input window (2-pixel halo)
constexpr int NPIX = HH * HWD;                      // 612 h1 pixels a tile
constexpr int TILES_X = W / TW, TILES = (H / TH) * TILES_X;   // 13, 65 a frame
constexpr int THREADS = 512;                        // 16 warps, two output rows each
constexpr int K2 = 9 * C;                           // conv1_2's reduction depth
constexpr int WS = K2 + 8;                          // bf16 w2 row stride (16-byte pad)
constexpr int HS_BF16 = C + 8;                      // bf16 h1 pixel stride (16-byte pad)
constexpr int HS_F32 = C + 1;                       // f32 h1 pixel stride
static_assert(H % TH == 0 && W % TW == 0 && TW == 16 && THREADS == 32 * TH / 2, "tiling");

constexpr size_t XS_BYTES = (size_t)XH * XWD * CIN * 4;
constexpr size_t W1_BYTES = (size_t)9 * CIN * C * 4;
constexpr size_t SMALL_BYTES = XS_BYTES + W1_BYTES + 2 * C * 4;
constexpr size_t SMEM_BF16 = (size_t)C * WS * 2 + (size_t)NPIX * HS_BF16 * 2 + SMALL_BYTES;
constexpr size_t SMEM_F32 = (size_t)NPIX * HS_F32 * 4 + SMALL_BYTES;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tile's input window, rows y0-2 .. y0+TH+1 and columns x0-2 .. x0+TW+1,
// as f32 (exact from bf16), zero outside the frame.
template <typename T>
__device__ void load_input(const T* __restrict__ x, int m, int y0, int x0, float* xs) {
  const T* frame = x + (size_t)m * H * W * CIN;
  for (int i = threadIdx.x; i < XH * XWD * CIN; i += THREADS) {
    const int c = i % CIN, p = i / CIN, wx = p % XWD, wy = p / XWD;
    const int gy = y0 - 2 + wy, gx = x0 - 2 + wx;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = to_f32(frame[((size_t)gy * W + gx) * CIN + c]);
    xs[i] = v;
  }
}

// h1 over the tile's window: h1 pixel (hy, hx) is frame pixel
// (y0-1+hy, x0-1+hx). One thread computes one pixel x 8 channels.
template <typename T, int HS>
__device__ void conv1_1(const float* xs, const float* w1s, const float* b1s, T* h1s, int y0,
                        int x0) {
  for (int i = threadIdx.x; i < NPIX * (C / 8); i += THREADS) {
    const int g = i / NPIX, p = i % NPIX, hy = p / HWD, hx = p % HWD;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
      for (int c = 0; c < CIN; ++c) {
        const float xv = xs[((hy + tap / 3) * XWD + hx + tap % 3) * CIN + c];
        const float4* wr = reinterpret_cast<const float4*>(w1s + (tap * CIN + c) * C + g * 8);
        const float4 a = wr[0], b = wr[1];
        acc[0] = fmaf(xv, a.x, acc[0]);
        acc[1] = fmaf(xv, a.y, acc[1]);
        acc[2] = fmaf(xv, a.z, acc[2]);
        acc[3] = fmaf(xv, a.w, acc[3]);
        acc[4] = fmaf(xv, b.x, acc[4]);
        acc[5] = fmaf(xv, b.y, acc[5]);
        acc[6] = fmaf(xv, b.z, acc[6]);
        acc[7] = fmaf(xv, b.w, acc[7]);
      }
    }
    const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = inside ? fmaxf(acc[j] + b1s[g * 8 + j], 0.f) : 0.f;
    T* dst = h1s + p * HS + g * 8;
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]),
                                                  pack_bf16(acc[4], acc[5]), pack_bf16(acc[6], acc[7]));
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = acc[j];
    }
  }
}

// conv1_2 + bias + ReLU + pool on the tensor cores. Warp w owns output rows
// 2w and 2w+1 (two 16-pixel M tiles) x 64 channels (eight n8 tiles).
__device__ void conv1_2_mma(const __nv_bfloat16* h1s, const __nv_bfloat16* w2s, const float* b2s,
                            __nv_bfloat16* __restrict__ out, int m, int y0, int x0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  // ldmatrix row addresses: A rows are pixels (k = channels), B rows are
  // output channels (k = tap x input channel).
  const int a_pix = lane % 8 + ((lane / 8) % 2) * 8, a_k = (lane / 16) * 8;
  const int b_n = lane % 8 + (lane / 16) * 8, b_k = ((lane / 8) % 2) * 8;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int u = tap / 3, v = tap % 3;
#pragma unroll
    for (int kc = 0; kc < C; kc += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], h1s + ((2 * warp + mt + u) * HWD + a_pix + v) * HS_BF16 + kc + a_k);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, w2s + (16 * np + b_n) * WS + tap * C + kc + b_k);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }

  // Accumulator (mt, nt, r): pixel g (r < 2) or g+8 (r >= 2) of row 2w+mt,
  // channel nt*8 + 2t + r%2. relu(s + b) rises with s, so the max of the
  // raw sums, then bias and ReLU, equals the pool of relu(s + b).
  const int g = lane / 4, t = lane % 4;
  const size_t row = ((size_t)m * PH + y0 / 2 + warp) * PW + x0 / 2 + g / 2;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      v[r] = fmaxf(acc[0][nt][r], acc[1][nt][r]);
      v[r] = fmaxf(v[r], __shfl_xor_sync(0xffffffffu, v[r], 4));
    }
    if (g % 2 == 0) {
      const int ch = nt * 8 + 2 * t;
      const float b0 = b2s[ch], b1 = b2s[ch + 1];
      *reinterpret_cast<uint32_t*>(out + row * C + ch) =
          pack_bf16(fmaxf(v[0] + b0, 0.f), fmaxf(v[1] + b1, 0.f));
      *reinterpret_cast<uint32_t*>(out + (row + 4) * C + ch) =
          pack_bf16(fmaxf(v[2] + b0, 0.f), fmaxf(v[3] + b1, 0.f));
    }
  }
}

// conv1_2 + bias + ReLU + pool on the CUDA cores (f32). One thread computes
// one pooled pixel (its 2x2 conv outputs) x 8 channels.
__device__ void conv1_2_fma(const float* h1s, const float* __restrict__ w2, const float* b2s,
                            float* __restrict__ out, int m, int y0, int x0) {
  constexpr int QW = TW / 2, NQ = (TH / 2) * QW;
  for (int i = threadIdx.x; i < NQ * (C / 8); i += THREADS) {
    const int g = i / NQ, q = i % NQ, qy = q / QW, qx = q % QW;
    float acc[4][8];
#pragma unroll
    for (int o = 0; o < 4; ++o)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[o][j] = 0.f;
#pragma unroll 1
    for (int c = 0; c < C; ++c) {
      float hv[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) hv[a][b] = h1s[((2 * qy + a) * HWD + 2 * qx + b) * HS_F32 + c];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int u = tap / 3, v = tap % 3;
        float wv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) wv[j] = __ldg(w2 + ((g * 8 + j) * C + c) * 9 + tap);
#pragma unroll
        for (int o = 0; o < 4; ++o)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[o][j] = fmaf(hv[o / 2 + u][o % 2 + v], wv[j], acc[o][j]);
      }
    }
    float* dst = out + (((size_t)m * PH + y0 / 2 + qy) * PW + x0 / 2 + qx) * C + g * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float s = fmaxf(fmaxf(acc[0][j], acc[1][j]), fmaxf(acc[2][j], acc[3][j]));
      dst[j] = fmaxf(s + b2s[g * 8 + j], 0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    vgg_block1_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
                      const T* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ out,
                      int M) {
  constexpr bool kMma = std::is_same_v<T, __nv_bfloat16>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* p = smem;
  T* w2s = reinterpret_cast<T*>(p);   // bf16 only
  if constexpr (kMma) p += (size_t)C * WS * 2;
  T* h1s = reinterpret_cast<T*>(p);
  p += (size_t)NPIX * (kMma ? HS_BF16 : HS_F32) * sizeof(T);
  float* xs = reinterpret_cast<float*>(p);
  float* w1s = xs + XH * XWD * CIN;
  float* b1s = w1s + 9 * CIN * C;
  float* b2s = b1s + C;

  // w1 [o][c][u][v] -> w1s[(tap*3 + c)*64 + o]; w2 [o][c][u][v] -> w2s[o][tap*64 + c]
  for (int i = threadIdx.x; i < 9 * CIN * C; i += THREADS) {
    const int o = i % C, c = (i / C) % CIN, tap = i / (C * CIN);
    w1s[i] = to_f32(w1[(o * CIN + c) * 9 + tap]);
  }
  if constexpr (kMma) {
    for (int i = threadIdx.x; i < C * K2; i += THREADS) {
      const int o = i / K2, k = i % K2, tap = k / C, c = k % C;
      w2s[o * WS + k] = w2[(o * C + c) * 9 + tap];
    }
  }
  for (int i = threadIdx.x; i < C; i += THREADS) {
    b1s[i] = b1[i];
    b2s[i] = b2[i];
  }

  const int total = M * TILES;
  int tile = blockIdx.x;
  auto origin = [](int t, int& m, int& y0, int& x0) {
    m = t / TILES;
    const int r = t % TILES;
    y0 = (r / TILES_X) * TH;
    x0 = (r % TILES_X) * TW;
  };
  int m, y0, x0;
  if (tile < total) {
    origin(tile, m, y0, x0);
    load_input(x, m, y0, x0, xs);
  }
  for (; tile < total; tile += gridDim.x) {
    origin(tile, m, y0, x0);
    __syncthreads();   // this tile's input (and the weights) are in; the last tile's h1 is read
    conv1_1<T, kMma ? HS_BF16 : HS_F32>(xs, w1s, b1s, h1s, y0, x0);
    __syncthreads();   // h1 is written; the input window is free
    if (tile + (int)gridDim.x < total) {
      int mn, yn, xn;
      origin(tile + gridDim.x, mn, yn, xn);
      load_input(x, mn, yn, xn, xs);
    }
    if constexpr (kMma)
      conv1_2_mma(h1s, w2s, b2s, out, m, y0, x0);
    else
      conv1_2_fma(h1s, w2, b2s, out, m, y0, x0);
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, int M, cudaStream_t stream) {
  constexpr size_t smem = std::is_same_v<T, __nv_bfloat16> ? SMEM_BF16 : SMEM_F32;
  cudaError_t err = cudaFuncSetAttribute(vgg_block1_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const long long total = (long long)M * TILES;
  const int grid = (int)(total < sms ? total : sms);
  vgg_block1_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const T*)w1, (const float*)b1, (const T*)w2, (const float*)b2, (T*)out, M);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, 160, 208, 3], w1 [64, 3, 3, 3], w2 [64, 64, 3, 3] in bf16 (or f32 when
// is_f32), b1 and b2 [64] f32 -> out [M, 80, 104, 64] in the same type. All
// contiguous. Returns the CUDA error of the launch (0 on success; 1 for an M
// the kernel does not take).
extern "C" int vgg_block1_forward(const void* x, const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* out, int M, int is_f32, void* stream) {
  if (M < 1 || (long long)M * TILES > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return is_f32 ? launch<float>(x, w1, b1, w2, b2, out, M, s)
                : launch<__nv_bfloat16>(x, w1, b1, w2, b2, out, M, s);
}
