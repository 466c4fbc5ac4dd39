// int8 SAME 3x3 conv of the calibrated FiLM trunk as one implicit GEMM, with
// its dequantization, bias and FiLM tail in the epilogue.
//
// Replaces no TPU kernel: the JAX package leaves this conv to XLA, which
// fuses the epilogue into the convolution. In eager PyTorch the same conv is
// an im2col copy, torch._int_mm and four to seven elementwise passes
// (ops/quant.py conv_i8 and _dequant, then models/film.py's FiLM tail), which
// took most of a served batch's device time. Here, per output row m =
// (frame, h, w) and channel o:
//   acc = sum over taps (i, j) and input channels c of
//         x[frame, h + i - 1, w + j - 1, c] * wq[o, (i, j, c)]   (int32, exact;
//         zero outside the frame)
//   y   = bf16(f32(acc) * scale[o] + bias[o])                  (ReLU if asked)
// and in the FiLM form (a, b one bf16 row per frame, res bf16 [M, O])
//   out = bf16(bf16(relu(bf16(bf16(a * y) + b))) + res)
// each step rounded where PyTorch's eager bf16 ops round (__fmul_rn and
// __fadd_rn: no contraction into an FMA), so the outputs are bit-equal to the
// im2col route's (kernels/conv3x3_int8.py conv3x3_int8_plain).
//
// What bounds it on an H100: operations. One FiLM block conv at batch 32 x
// 35 frames (145,600 rows, C = O = 1,024, K = 9,216) is 2.75 TOP of int8
// work, 1.39 ms at the card's 1,979 TOP/s, against ~0.75 GB of bytes
// (0.23 ms). The design keeps the tensor cores fed and nothing else in
// device memory:
//   - no im2col and no padded copy: the A tile of a k-block (tap (i, j),
//     128 input channels) comes straight from x by TMA in im2col mode, 128
//     consecutive output rows, each the pixel under that tap; the tensor map's
//     bounding box (corners -1, -1) walks the rows across row and frame ends
//     as the output rows run, and fills the pixels outside the frame (and
//     past the last frame) with zeros;
//   - the B tile [256 output channels][128 input channels] of the same
//     k-block comes by TMA from wq viewed as [O][9][C], so input channels past
//     C read as zeros whatever C is (a multiple of 16: TMA's 16-byte strides);
//   - a 3-stage ring of (A 16 KB, B 32 KB) tiles in the 128-byte swizzle,
//     filled by one producer warp and gated by mbarriers (4 stages were no
//     faster, and the staging tiles below need the room);
//   - two consumer warpgroups, 64 rows each, run wgmma m64n256k32 s8 x s8 ->
//     s32 on the shared B tile: a 128 x 256 output tile a block;
//   - persistent: one block per SM walks the tiles (column tiles of one row
//     tile on neighbouring blocks, so x is read from device memory about
//     once and the taps' re-reads hit L2); the producer runs ahead into the
//     next tile's k-blocks while the consumers run the epilogue.
// The epilogue dequantizes the accumulators in registers into a bf16 staging
// tile in shared memory; then each warp takes whole 512-byte rows of it,
// applies the FiLM tail there (reading res, a and b the same way) and stores
// y in 16-byte chunks. Done straight from the accumulators' layout (8 rows x
// 16 bytes a warp instruction), the FiLM form's call at 145,600 rows took
// 0.13-0.17 ms longer (2.62 against 2.46-2.51 ms with its glue, NVIDIA H100
// 80GB HBM3, 700 W); the ReLU form, which loads nothing, was ~0.1 ms faster
// that way, but conv_init is one conv in six. Rows past M and columns past O
// are not stored.
// Measured there: 2.36 ms a FiLM-form launch, 59% of the operations bound.
// Each SM reads a 48 KB stage from L2 for every 0.56 us of tensor work at
// the peak rate; a cluster of two blocks sharing the B tile by TMA multicast
// would cut that by a third.

#include <cuda.h>   // CUtensorMap and its enums; the encoders are looked up from libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                   // output rows of a tile (two warpgroups of 64)
constexpr int BN = 256;                   // output channels of a tile (one wgmma n256)
constexpr int BK = 128;                   // input channels of a k-block: one 128-byte swizzle row
constexpr int STAGES = 3;
constexpr int THREADS = 2 * 128 + 32;     // two consumer warpgroups, then the producer warp
constexpr uint32_t A_BYTES = BM * BK;     // 16 KB
constexpr uint32_t B_BYTES = BN * BK;     // 32 KB
constexpr int ROW_BYTES = BN * 2;         // a staged bf16 output row
constexpr int ROW_CHUNKS = ROW_BYTES / 16;
constexpr uint32_t STAGE_BYTES = 64 * ROW_BYTES;   // a consumer warpgroup's staged rows (32 KB)
constexpr size_t SMEM_BYTES = STAGES * (size_t)(A_BYTES + B_BYTES) + 2 * (size_t)STAGE_BYTES
                            + 2 * STAGES * sizeof(uint64_t) + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(addr), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// The A tile: BM pixels x BK channels of x [N, H, W, C] in im2col mode, the
// first pixel (w, h, n) (a filter window's top-left corner, so -1 at the
// frame's top or left edge), each shifted by the tap (dx, dy).
__device__ __forceinline__ void tma_im2col(void* dst, const CUtensorMap* map, uint64_t* bar,
                                           int c, int w, int h, int n, uint16_t dx,
                                           uint16_t dy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n"
      :: "r"(smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c), "r"(w), "r"(h),
         "r"(n), "h"(dx), "h"(dy)
      : "memory");
}

// The B tile: BN output channels x BK input channels of tap t of wq [O][9][C].
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c, int t, int o) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c), "r"(t), "r"(o)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32
       | (uint64_t)1 << 62;
}

__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110,"
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124,"
      "%125, %126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
        "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ float2 bf2_to_f2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// A pair of f32 values rounded to bf16 and back (the rounding of one eager
// bf16 op).
__device__ __forceinline__ float2 round_bf16(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A FiLM block's tail on a pair of bf16 values: relu(a * y + b) + res, each
// step rounded to bf16 as an eager bf16 op rounds it.
__device__ __forceinline__ uint32_t film2(uint32_t y, uint32_t a, uint32_t b, uint32_t res) {
  const float2 yv = bf2_to_f2(y), av = bf2_to_f2(a), bv = bf2_to_f2(b), rv = bf2_to_f2(res);
  float2 o = round_bf16(__fmul_rn(av.x, yv.x), __fmul_rn(av.y, yv.y));
  o = round_bf16(__fadd_rn(o.x, bv.x), __fadd_rn(o.y, bv.y));
  o.x = o.x > 0.f ? o.x : 0.f;
  o.y = o.y > 0.f ? o.y : 0.f;
  return as_u32(__floats2bfloat162_rn(__fadd_rn(o.x, rv.x), __fadd_rn(o.y, rv.y)));
}

// One 128 x 256 output tile a block at a time; FILM selects the epilogue.
// Accumulator element 4 * nb + 2 * half + j of thread t of a consumer
// warpgroup sits at row 16 * (t / 32) + (t % 32) / 4 + 8 * half of the
// warpgroup's 64, column 8 * nb + 2 * (t % 4) + j.
template <bool FILM>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_int8_kernel(const __grid_constant__ CUtensorMap amap,  // x [N, H, W, C], im2col
                    const __grid_constant__ CUtensorMap bmap,  // wq [O][9][C]
                    const float* __restrict__ scale,          // [O]
                    const float* __restrict__ bias,           // [O], or null
                    const __nv_bfloat16* __restrict__ fa,     // FILM: [N, O]
                    const __nv_bfloat16* __restrict__ fb,     // FILM: [N, O]
                    const __nv_bfloat16* __restrict__ res,    // FILM: [M, O]
                    __nv_bfloat16* __restrict__ y,            // [M, O]
                    int H, int W, int C, int O, int M, int relu) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* ring_a = smem;                                  // [STAGES][BM][128], swizzled
  uint8_t* ring_b = smem + STAGES * A_BYTES;               // [STAGES][BN][128], swizzled
  uint8_t* staging = ring_b + STAGES * B_BYTES;           // [2][64][ROW_BYTES], swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int HW = H * W, CB = (C + BK - 1) / BK, KB = 9 * CB;
  const int NT = (O + BN - 1) / BN, tiles = ((M + BM - 1) / BM) * NT;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);   // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {   // the producer: every k-block of every tile of this block, in order
    if (lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / NT) * BM, o0 = (tile % NT) * BN;
        const int n = m0 / HW, p = m0 % HW, h = p / W, w = p % W;
        for (int kb = 0; kb < KB; ++kb, ++it) {
          const int s = it % STAGES, tap = kb / CB, c0 = (kb % CB) * BK;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], A_BYTES + B_BYTES);
          tma_im2col(ring_a + s * A_BYTES, &amap, &full[s], c0, w - 1, h - 1, n,
                     (uint16_t)(tap % 3), (uint16_t)(tap / 3));
          tma_load_3d(ring_b + s * B_BYTES, &bmap, &full[s], c0, tap, o0);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, t = tid & 127, q = lane & 3;
  const int row_in_wg = (t >> 5) * 16 + (lane >> 2);   // + 8 * half
  uint8_t* st = staging + wg * STAGE_BYTES;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / NT) * BM, o0 = (tile % NT) * BN;
    int acc[128];
#pragma unroll
    for (int e = 0; e < 128; ++e) acc[e] = 0;
    int prev = -1;
    for (int kb = 0; kb < KB; ++kb, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      __syncwarp();
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const uint32_t a = smem_u32(ring_a + s * A_BYTES) + wg * 64 * 128;
      const uint32_t b = smem_u32(ring_b + s * B_BYTES);
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(acc);
      if (prev >= 0) {   // the k-block before this one is read: hand its stage back
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (t == 0) mbar_arrive(&empty[prev]);
        __syncwarp();
      }
      prev = s;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (t == 0) mbar_arrive(&empty[prev]);
    __syncwarp();

    // the epilogue, 1: the conv's output y = bf16(acc * scale + bias) (and
    // conv_init's ReLU) into the warpgroup's staging tile, two rows a thread
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      const int c = o0 + nb * 8 + 2 * q;
      if (c < O) {
        const float2 s = *reinterpret_cast<const float2*>(scale + c);
        const float2 bb = bias != nullptr ? *reinterpret_cast<const float2*>(bias + c)
                                          : make_float2(0.f, 0.f);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v0 = __fmul_rn(__int2float_rn(acc[4 * nb + 2 * half]), s.x);
          float v1 = __fmul_rn(__int2float_rn(acc[4 * nb + 2 * half + 1]), s.y);
          if (bias != nullptr) {
            v0 = __fadd_rn(v0, bb.x);
            v1 = __fadd_rn(v1, bb.y);
          }
          __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
          if (!FILM && relu) o = __hmax2(o, __floats2bfloat162_rn(0.f, 0.f));
          const int r = row_in_wg + 8 * half;
          *reinterpret_cast<__nv_bfloat162*>(st + r * ROW_BYTES + ((nb ^ (r & 7)) << 4) + 4 * q) = o;
        }
      }
    }
    named_sync(1 + wg, 128);
    // 2: whole 16-byte chunks of rows out of the staging tile, a warp a row;
    // the FiLM form reads res, a and b the same way and rounds each step to
    // bf16 where the eager ops round
#pragma unroll 4
    for (int k = 0; k < 64 * ROW_CHUNKS / 128; ++k) {
      const int ch = t + 128 * k, r = ch / ROW_CHUNKS, cc = ch % ROW_CHUNKS;
      const int m = m0 + wg * 64 + r, c = o0 + 8 * cc;
      if (m < M && c < O) {
        uint4 v = *reinterpret_cast<const uint4*>(st + r * ROW_BYTES + ((cc ^ (r & 7)) << 4));
        const size_t off = (size_t)m * O + c;
        if (FILM) {
          const size_t frame = (size_t)(m / HW) * O + c;
          const uint4 av = *reinterpret_cast<const uint4*>(fa + frame);
          const uint4 bv = *reinterpret_cast<const uint4*>(fb + frame);
          const uint4 rv = *reinterpret_cast<const uint4*>(res + off);
          v.x = film2(v.x, av.x, bv.x, rv.x);
          v.y = film2(v.y, av.y, bv.y, rv.y);
          v.z = film2(v.z, av.z, bv.z, rv.z);
          v.w = film2(v.w, av.w, bv.w, rv.w);
        }
        *reinterpret_cast<uint4*>(y + off) = v;
      }
    }
    named_sync(1 + wg, 128);   // the tile is out before the next one is staged
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A libcuda entry point, looked up through the CUDA runtime in the libcuda it
// has already loaded (no link against libcuda); null where it is missing.
void* libcuda_fn(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault,
                                                           &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? p : nullptr;
}

// x [N, H, W, C] int8 in im2col mode: BM pixels of BK channels a box; the
// bounding box's corners (-1, -1) in W and H make a window's top-left corner
// run over [-1, W - 2] x [-1, H - 2], one start a SAME output pixel.
bool encode_x(CUtensorMap* map, const void* x, int N, int H, int W, int C) {
  static const EncodeIm2col encode = (EncodeIm2col)libcuda_fn("cuTensorMapEncodeIm2col");
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)C, (cuuint64_t)W * C, (cuuint64_t)H * W * C};
  const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), dims, strides,
                lower, upper, BK, BM, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// wq [O, 9 * C] int8 as [O][9][C]: boxes of BN output channels x one tap x BK
// input channels.
bool encode_w(CUtensorMap* map, const void* wq, int C, int O) {
  static const EncodeTiled encode = (EncodeTiled)libcuda_fn("cuTensorMapEncodeTiled");
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)C, 9, (cuuint64_t)O};
  const cuuint64_t strides[2] = {(cuuint64_t)C, (cuuint64_t)9 * C};
  const cuuint32_t box[3] = {BK, 1, BN};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(wq), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool FILM>
int launch(const CUtensorMap& amap, const CUtensorMap& bmap, const void* scale, const void* bias,
           const void* fa, const void* fb, const void* res, void* y, int N, int H, int W, int C,
           int O, int relu, cudaStream_t stream) {
  const auto kernel = conv3x3_int8_kernel<FILM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  const int M = N * H * W;
  const long long tiles = (long long)((M + BM - 1) / BM) * ((O + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      amap, bmap, (const float*)scale, (const float*)bias, (const __nv_bfloat16*)fa,
      (const __nv_bfloat16*)fb, (const __nv_bfloat16*)res, (__nv_bfloat16*)y, H, W, C, O, M,
      relu);
  return (int)cudaGetLastError();
}

}  // namespace

// xq [N, H, W, C] int8, wq [O, 9 * C] int8 in (i, j, c) order, scale [O] f32
// (the activation scale times the weight's), bias [O] f32 or null -> y [N, H,
// W, O] bf16: the SAME 3x3 conv, dequantized, plus bias, ReLU where relu is
// set. With fa, fb ([N, O] bf16, one row a frame) and res ([N, H, W, O]
// bf16), y is the FiLM block's relu(fa * conv + fb) + res instead (relu is
// then ignored). Needs C and O multiples of 16 and 16-byte aligned tensors.
// Returns the CUDA error of the launch (0 on success).
extern "C" int conv3x3_int8(const void* xq, const void* wq, const void* scale, const void* bias,
                            const void* fa, const void* fb, const void* res, void* y, int N,
                            int H, int W, int C, int O, int relu, void* stream) {
  const bool film = fa != nullptr;
  if (N < 1 || H < 1 || W < 1 || C < 16 || C % 16 != 0 || O < 16 || O % 16 != 0 ||
      (long long)N * H * W >= (1LL << 31) || ((uintptr_t)xq | (uintptr_t)wq) % 16 != 0 ||
      (film && (fb == nullptr || res == nullptr ||
                ((uintptr_t)fa | (uintptr_t)fb | (uintptr_t)res) % 16 != 0)) ||
      (uintptr_t)y % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap amap, bmap;
  if (!encode_x(&amap, xq, N, H, W, C) || !encode_w(&bmap, wq, C, O))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return film ? launch<true>(amap, bmap, scale, bias, fa, fb, res, y, N, H, W, C, O, 0, s)
              : launch<false>(amap, bmap, scale, bias, nullptr, nullptr, nullptr, y, N, H, W, C,
                              O, relu, s);
}
