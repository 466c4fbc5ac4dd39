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
// What bounds it on an H100. Operations, on paper: a frame is 2.57 GFLOP
// (conv1_1 0.115, conv1_2 2.45) against 1.26 MB in and out in bf16, ~2,000
// FLOP a byte, far above the card's ~295. Unfused, the 64-channel h1 and
// conv1_2's output at 160x208 (4.3 MB a frame each in bf16) go to device
// memory and back; here neither leaves the SM. conv1_2 runs on the tensor
// cores; conv1_1 must run on the CUDA cores in a fixed order (below), at
// 1/16 of their rate, so the two units need times of the same order for a
// tile (~2.5 us each at full rate). The design before this one ran them one
// after the other, and conv1_1 took 55% of its time (NVIDIA H100 80GB HBM3,
// 700 W power limit; PERF.md). This one runs
// them at once in different warps, so a tile costs the slower of the two,
// not their sum:
//   - bf16 (served): a persistent grid, one 512-thread block per SM, walks
//     16x16-pixel tiles of conv1_2's output (8x8 pooled). w2 stays in shared
//     memory for the whole run as [k group of 8][out channel][8 k] (k = tap x
//     64 + input channel), a no-swizzle wgmma operand. Two roles hand tiles
//     over through two h1 buffers, one mbarrier a buffer each way:
//       * two producer warpgroups compute the 18x18x64 h1 window on the
//         CUDA cores, laid out [channel group of 8][pixel][8 channels], so 8
//         neighbouring pixels x 16 bytes are one wgmma core matrix (the
//         groups 16 bytes further apart than the pixels need, so a warp's
//         stores into 8 groups meet no bank twice). A warp computes 6
//         pixels of an h1 row x all 64 channels, lane l channels 2l and
//         2l + 1 from w1 held in its registers, so each input float comes
//         as a broadcast load and feeds 12 FMAs. The 54 items of a tile go
//         to the 8 warps in a rotation that moves from tile to tile, so the
//         warps with one item more change and no warp waits on another;
//       * two consumer warpgroups run conv1_2 as an implicit GEMM with
//         wgmma m64n128k16 (bf16 -> f32), A = w2 (64 out channels), B = h1:
//         N = 128 pixels is a 16-row x 8-column half of the tile, whose
//         8-pixel rows lie one h1 row (288 bytes) apart, and each of the 9
//         taps is only another start address of the same descriptor (dx: 16
//         bytes, dy: one h1 row), never a copy. Bias, ReLU and the 2x2 max
//         run on the accumulators (both pooled neighbours are in the same
//         thread), through a small staging tile into 16-byte stores of the
//         pooled tile only. While their products run, the consumers load the
//         input window two tiles ahead (2-pixel halo, zeros outside the
//         frame, f32 exact from bf16).
//     Measured on the same card (PERF.md): conv1_1 alone takes
//     5.1 ms at M = 1,120 (57% of the FMA rate), conv1_2 alone 4.7 ms (66%
//     of the tensor rate), both at once 7.0 ms, where they ran 13.2 one
//     after the other before. Together the card draws its full 700 W and
//     the SM clock falls from 1,980 to ~1,800 MHz. Three producer
//     warpgroups (96 registers: spills), 9-pixel segments, items of 2-6
//     rows that load each input row once (44% fewer shared-memory loads)
//     and one ping-pong consumer warpgroup under setmaxnreg (the compiler
//     serialised its products) were no faster.
//   - f32 (the tight check, not a served path): 32x16-pixel tiles, conv1_1
//     as below, conv1_2 on the CUDA cores with w2 read through the
//     read-only cache, one phase after the other.
// conv1_1 sums its 27 products in a fixed order (tap by tap, then input
// channel) with FMAs; vgg_block1_plain sums in the same order, so in bf16,
// where every product is exact in f32, both round h1 to the same values.
// (On the tensor cores conv1_1 would sum in an order the hardware chooses.)
// h1 positions outside the frame are zero, not relu(b1): conv1_2's SAME
// padding reads zeros there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int H = 160, W = 208, CIN = 3, C = 64;   // the frame, conv1_1's channels
constexpr int PH = H / 2, PW = W / 2;               // pooled output

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ------------------------------------------------------------- bf16: wgmma

namespace bf16 {

constexpr int T = 16;                          // conv1_2 outputs a tile side
constexpr int HT = T + 2, XT = T + 4;          // h1 and input window sides
constexpr int NPIX = HT * HT;                  // 324 h1 pixels a tile
constexpr int TILES_X = W / T, TILES = (H / T) * TILES_X;   // 13, 130 a frame
constexpr int CG = C / 8;                      // channel groups of 8 (16 bytes)
// bytes from one channel group of h1 to the next: 16 more than the pixels
// take, so the 8 groups a producer warp stores into start on 8 distinct
// 4-bank sets (5,200 / 4 = 20 banks mod 32)
constexpr int H1_GROUP = NPIX * 16 + 16;
constexpr int H1_BYTES = CG * H1_GROUP;        // one h1 buffer
constexpr int W2_BYTES = 9 * C * C * 2;
constexpr int SEG = 6, SEGS = HT / SEG;        // h1 rows in segments of 6 pixels, 3 a row
constexpr int SEG_IN = (SEG + 2) * CIN;        // input floats under a segment row
constexpr int XS = XT * SEGS * SEG_IN;         // input window, [row][segment][column][c]
constexpr int ITEMS = HT * SEGS;               // 54 producer items: a segment x 64 channels
constexpr int STAGE_PITCH = C + 8;             // bf16 a pooled pixel (+16 bytes: no bank clash)
constexpr int CONSUMERS = 2, PRODUCERS = 2;    // warpgroups
constexpr int PRODUCER_WARPS = 4 * PRODUCERS;
constexpr int THREADS = 128 * (CONSUMERS + PRODUCERS);
static_assert(H % T == 0 && W % T == 0 && HT % SEG == 0 && SEG_IN % 4 == 0, "tiling");

struct Smem {
  __align__(128) uint8_t w2[W2_BYTES];         // [k / 8][out channel][k % 8] bf16
  __align__(128) uint8_t h1[2][H1_BYTES];      // [channel / 8][pixel][channel % 8] bf16
  __align__(16) float xs[2][XS];
  float b2[C];
  __align__(16) __nv_bfloat16 stage[CONSUMERS][8 * 4 * STAGE_PITCH];
  uint64_t full[2], empty[2], xfull[2];
};

__device__ __forceinline__ void origin(int t, int& m, int& y0, int& x0) {
  m = t / TILES;
  const int r = t % TILES;
  y0 = (r / TILES_X) * T;
  x0 = (r % TILES_X) * T;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// wgmma descriptor of a K-major operand without swizzle: core matrices of
// 8 rows x 16 bytes, `lbo` bytes apart along K, `sbo` bytes apart along M/N.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16
       | (uint64_t)(sbo >> 4) << 32;
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 -> f32; d = A B where !acc.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
      " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52,"
      " %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// Consumer thread `ct` of 256: its share of tile `tile`'s input
// window, rows y0-2 .. y0+17 and columns x0-2 .. x0+17, as f32 (exact from
// bf16), zero outside the frame, into `xs`, where each h1 segment's 8
// input columns x 3 channels lie together (16-byte aligned: the 2 columns
// two segments share are stored twice); loads first, then stores; then
// counted on `xfull`.
__device__ __forceinline__ void load_window(float* xs, uint64_t* xfull,
                                            const __nv_bfloat16* __restrict__ x, int tile,
                                            int ct) {
  constexpr int PER_THREAD = (XS + 128 * CONSUMERS - 1) / (128 * CONSUMERS);
  int m, y0, x0;
  origin(tile, m, y0, x0);
  const __nv_bfloat16* frame = x + (size_t)m * H * W * CIN;
  float v[PER_THREAD];
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    const int e = ct + 128 * CONSUMERS * r, row = e / (SEGS * SEG_IN), f = e % SEG_IN;
    const int gy = y0 - 2 + row, gx = x0 - 2 + SEG * (e / SEG_IN % SEGS) + f / CIN;
    v[r] = e < XS && gy >= 0 && gy < H && gx >= 0 && gx < W
               ? __bfloat162float(frame[((size_t)gy * W + gx) * CIN + f % CIN]) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r)
    if (ct + 128 * CONSUMERS * r < XS) xs[ct + 128 * CONSUMERS * r] = v[r];
  mbar_arrive(xfull);
}

// A producer warp's item: h1 row hy, pixels hx .. hx + 5 of the window, all
// 64 channels, lane l computing channels 2l and 2l + 1 from w1 in its
// registers (w[j][(3u + v) * 3 + c]); the input comes as broadcast 16-byte
// loads, each float feeding 12 FMAs. Stored as bf16 pairs into `h1`.
__device__ __forceinline__ void conv1_1_item(const float* xs, const float (&w)[2][9 * CIN],
                                             const float (&bias)[2], uint8_t* h1, int item,
                                             int y0, int x0) {
  const int l = threadIdx.x % 32, hy = item / SEGS, sg = item % SEGS, hx = SEG * sg;
  float acc[SEG][2];
#pragma unroll
  for (int p = 0; p < SEG; ++p) acc[p][0] = acc[p][1] = 0.f;
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    float xr[SEG_IN];   // input row hy + u, columns hx .. hx + 7, [column][c]
    const float4* src = reinterpret_cast<const float4*>(xs + ((hy + u) * SEGS + sg) * SEG_IN);
#pragma unroll
    for (int i = 0; i < SEG_IN / 4; ++i) {
      const float4 q = src[i];
      xr[4 * i] = q.x; xr[4 * i + 1] = q.y; xr[4 * i + 2] = q.z; xr[4 * i + 3] = q.w;
    }
#pragma unroll
    for (int v = 0; v < 3; ++v)
#pragma unroll
      for (int c = 0; c < CIN; ++c)
#pragma unroll
        for (int p = 0; p < SEG; ++p)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            acc[p][j] = fmaf(xr[(p + v) * CIN + c], w[j][(u * 3 + v) * CIN + c], acc[p][j]);
  }
  const int gy = y0 - 1 + hy;
#pragma unroll
  for (int p = 0; p < SEG; ++p) {
    const int gx = x0 - 1 + hx + p;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    *reinterpret_cast<uint32_t*>(h1 + (l / 4) * H1_GROUP + (hy * HT + hx + p) * 16 + (l % 4) * 4) =
        inside ? pack_bf16(fmaxf(acc[p][0] + bias[0], 0.f), fmaxf(acc[p][1] + bias[1], 0.f)) : 0u;
  }
}

// Producer warp `pw` of PRODUCER_WARPS: items r, r + 8, ... of each tile, r
// rotating by ITEMS % PRODUCER_WARPS a tile, so the warps with one item more
// change from tile to tile and no warp waits on another within a tile.
__device__ void produce(Smem& sm, const __nv_bfloat16* __restrict__ w1,
                        const float* __restrict__ b1, int pw, int total) {
  constexpr int SHIFT = ITEMS % PRODUCER_WARPS;
  const int l = threadIdx.x % 32;
  // w1 [o][c][u][v] of the lane's channels 2l, 2l + 1, and their biases
  float w[2][9 * CIN], bias[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int c = 0; c < CIN; ++c)
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        w[j][tap * CIN + c] = __bfloat162float(w1[((2 * l + j) * CIN + c) * 9 + tap]);
    bias[j] = b1[2 * l + j];
  }
  int k = 0;
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x, ++k) {
    const int s = k & 1, ph = (k >> 1) & 1;
    int m, y0, x0;
    origin(tile, m, y0, x0);
    mbar_wait(&sm.xfull[s], ph);
    mbar_wait(&sm.empty[s], ph ^ 1);
    const int first = (pw + PRODUCER_WARPS - (k * SHIFT) % PRODUCER_WARPS) % PRODUCER_WARPS;
#pragma unroll 1
    for (int i = first; i < ITEMS; i += PRODUCER_WARPS)
      conv1_1_item(sm.xs[s], w, bias, sm.h1[s], i, y0, x0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // h1 -> wgmma
    mbar_arrive(&sm.full[s]);   // also: this thread read xs[s] for the last time
  }
}

// Consumer warpgroup `half`: conv1_2 of output columns 8 half .. 8 half + 7
// of each tile (16 rows x 8 columns = N 128), then bias, ReLU, pool, store.
// While its products run, the consumers load tile k + 2's input window into
// xs[k % 2]: the full barrier of tile k says every producer has read it.
__device__ void consume(Smem& sm, const __nv_bfloat16* __restrict__ x,
                        __nv_bfloat16* __restrict__ out, int half, int total) {
  const int ct = threadIdx.x, t = ct % 128, w = t / 32, l = t % 32;
  for (int s = 0; s < 2; ++s)
    if (blockIdx.x + s * gridDim.x < total)
      load_window(sm.xs[s], &sm.xfull[s], x, blockIdx.x + s * gridDim.x, ct);
  const uint64_t da0 = desc(smem_u32(sm.w2), 1024, 128);
  __nv_bfloat16* stage = sm.stage[half];
  float acc[64];
  int k = 0;
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x, ++k) {
    const int s = k & 1;
    int m, y0, x0;
    origin(tile, m, y0, x0);
    mbar_wait(&sm.full[s], (k >> 1) & 1);
    // a descriptor's start address is its low field, in 16-byte units:
    // moving an operand by `b` bytes adds b / 16
    const uint64_t db0 = desc(smem_u32(sm.h1[s]) + 8 * half * 16, H1_GROUP, HT * 16);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16(acc, da0 + (tap * 8 + 2 * kk) * 1024 / 16,
                   db0 + (((tap / 3) * HT + tap % 3) * 16 + 2 * kk * H1_GROUP) / 16,
                   tap > 0 || kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (tile + 2 * gridDim.x < total)
      load_window(sm.xs[s], &sm.xfull[s], x, tile + 2 * gridDim.x, ct);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    mbar_arrive(&sm.empty[s]);

    // Accumulator 4 i + 2 e + j: out channel 16 w + l / 4 + 8 e, pixel row i,
    // column 2 (l % 4) + j of this half. relu(s + b) rises with s, so the
    // max of the raw sums, then bias and ReLU, equals the pool of relu(s + b).
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = 16 * w + l / 4 + 8 * e;
      const float bias = sm.b2[ch];
#pragma unroll
      for (int py = 0; py < 8; ++py) {
        const float v = fmaxf(fmaxf(acc[8 * py + 2 * e], acc[8 * py + 2 * e + 1]),
                              fmaxf(acc[8 * py + 4 + 2 * e], acc[8 * py + 4 + 2 * e + 1]));
        stage[(py * 4 + l % 4) * STAGE_PITCH + ch] = __float2bfloat16_rn(fmaxf(v + bias, 0.f));
      }
    }
    named_sync(1 + half, 128);
    // 8 x 4 pooled pixels x 128 bytes, 16 bytes a thread and pass
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = t + 128 * r, p = q / 8, part = q % 8;
      const size_t o = (((size_t)m * PH + y0 / 2 + p / 4) * PW + x0 / 2 + 4 * half + p % 4) * C;
      *reinterpret_cast<uint4*>(out + o + 8 * part) =
          *reinterpret_cast<const uint4*>(stage + p * STAGE_PITCH + 8 * part);
    }
    named_sync(1 + half, 128);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
vgg_block1_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                       const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                       const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int M) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  // w2 [o][c][u][v] -> w2s[k / 8][o][k % 8], k = (3u + v) * 64 + c
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(sm.w2);
  for (int i = threadIdx.x; i < 9 * C * C; i += THREADS) {
    const int o = i / (9 * C), k = i % (9 * C), tap = k / C, c = k % C;
    w2s[((k / 8) * C + o) * 8 + k % 8] = w2[(o * C + c) * 9 + tap];
  }
  for (int i = threadIdx.x; i < C; i += THREADS) sm.b2[i] = b2[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.full[s], 32 * PRODUCER_WARPS);
      mbar_init(&sm.empty[s], 128 * CONSUMERS);
      mbar_init(&sm.xfull[s], 128 * CONSUMERS);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // w2 -> wgmma
  __syncthreads();

  const int total = M * TILES;
  if (threadIdx.x < 128 * CONSUMERS)
    consume(sm, x, out, threadIdx.x / 128, total);
  else
    produce(sm, w1, b1, threadIdx.x / 32 - 4 * CONSUMERS, total);
}

}  // namespace bf16

// ----------------------------------------------------- f32: the CUDA cores

namespace f32 {

constexpr int TH = 32, TW = 16;                     // conv1_2 outputs per tile
constexpr int HH = TH + 2, HWD = TW + 2;            // h1 window (1-pixel halo)
constexpr int XH = TH + 4, XWD = TW + 4;            // input window (2-pixel halo)
constexpr int NPIX = HH * HWD;                      // 612 h1 pixels a tile
constexpr int TILES_X = W / TW, TILES = (H / TH) * TILES_X;   // 13, 65 a frame
constexpr int THREADS = 512;
constexpr int HS = C + 1;                           // f32 h1 pixel stride
static_assert(H % TH == 0 && W % TW == 0, "tiling");
constexpr size_t SMEM = ((size_t)NPIX * HS + XH * XWD * CIN + 9 * CIN * C + 2 * C) * 4;

// The tile's input window, rows y0-2 .. y0+TH+1 and columns x0-2 .. x0+TW+1,
// zero outside the frame.
__device__ void load_input(const float* __restrict__ x, int m, int y0, int x0, float* xs) {
  const float* frame = x + (size_t)m * H * W * CIN;
  for (int i = threadIdx.x; i < XH * XWD * CIN; i += THREADS) {
    const int c = i % CIN, p = i / CIN, wx = p % XWD, wy = p / XWD;
    const int gy = y0 - 2 + wy, gx = x0 - 2 + wx;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = frame[((size_t)gy * W + gx) * CIN + c];
    xs[i] = v;
  }
}

// h1 over the tile's window: h1 pixel (hy, hx) is frame pixel
// (y0-1+hy, x0-1+hx). One thread computes one pixel x 8 channels.
__device__ void conv1_1(const float* xs, const float* w1s, const float* b1s, float* h1s, int y0,
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
    for (int j = 0; j < 8; ++j)
      h1s[p * HS + g * 8 + j] = inside ? fmaxf(acc[j] + b1s[g * 8 + j], 0.f) : 0.f;
  }
}

// conv1_2 + bias + ReLU + pool. One thread computes one pooled pixel (its
// 2x2 conv outputs) x 8 channels.
__device__ void conv1_2(const float* h1s, const float* __restrict__ w2, const float* b2s,
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
        for (int b = 0; b < 4; ++b) hv[a][b] = h1s[((2 * qy + a) * HWD + 2 * qx + b) * HS + c];
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

__global__ void __launch_bounds__(THREADS, 1)
vgg_block1_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ w2,
                      const float* __restrict__ b2, float* __restrict__ out, int M) {
  extern __shared__ __align__(16) float smem_f[];
  float* h1s = smem_f;
  float* xs = h1s + NPIX * HS;
  float* w1s = xs + XH * XWD * CIN;
  float* b1s = w1s + 9 * CIN * C;
  float* b2s = b1s + C;
  // w1 [o][c][u][v] -> w1s[(tap*3 + c)*64 + o]
  for (int i = threadIdx.x; i < 9 * CIN * C; i += THREADS) {
    const int o = i % C, c = (i / C) % CIN, tap = i / (C * CIN);
    w1s[i] = w1[(o * CIN + c) * 9 + tap];
  }
  for (int i = threadIdx.x; i < C; i += THREADS) {
    b1s[i] = b1[i];
    b2s[i] = b2[i];
  }
  const int total = M * TILES;
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int m = tile / TILES, r = tile % TILES;
    const int y0 = (r / TILES_X) * TH, x0 = (r % TILES_X) * TW;
    __syncthreads();   // the weights are in; the last tile's h1 is read
    load_input(x, m, y0, x0, xs);
    __syncthreads();
    conv1_1(xs, w1s, b1s, h1s, y0, x0);
    __syncthreads();
    conv1_2(h1s, w2, b2s, out, m, y0, x0);
  }
}

}  // namespace f32

template <class Kernel>
int launch(Kernel kernel, int threads, size_t smem, long long tiles, void** args,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int grid = (int)(tiles < sms ? tiles : sms);
  err = cudaLaunchKernel((const void*)kernel, dim3(grid), dim3(threads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, 160, 208, 3], w1 [64, 3, 3, 3], w2 [64, 64, 3, 3] in bf16 (or f32 when
// is_f32), b1 and b2 [64] f32 -> out [M, 80, 104, 64] in the same type. All
// contiguous. Returns the CUDA error of the launch (0 on success; 1 for an M
// the kernel does not take).
extern "C" int vgg_block1_forward(const void* x, const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* out, int M, int is_f32, void* stream) {
  if (M < 1 || (long long)M * bf16::TILES > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&x, (void*)&w1, (void*)&b1, (void*)&w2, (void*)&b2, (void*)&out,
                  (void*)&M};
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_f32)
    return launch(f32::vgg_block1_f32_kernel, f32::THREADS, f32::SMEM,
                  (long long)M * f32::TILES, args, s);
  return launch(bf16::vgg_block1_bf16_kernel, bf16::THREADS, sizeof(bf16::Smem),
                (long long)M * bf16::TILES, args, s);
}
