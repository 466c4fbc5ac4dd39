// Fused int8 1x1 conv of the FiLM trunk: quantize -> int8 GEMM -> dequant.
//
// Replaces videonavqa_tpu/kernels/int8_matmul_pallas.py (_kernel and
// _kernel_requant, called by matmul_int8_fused_pallas):
//   xq  = clip(round_half_even(x / sx), -127, 127)          (int8)
//   acc = xq @ wq^T                                           (int32, exact)
//   y   = acc * comb + bias, then ReLU if asked              (f32, stored bf16/f32)
//   yq  = clip(round_half_even(y / nx), -127, 127)           (int8, optional)
// where yq's y is either the f32 value (the Pallas kernel's source) or, with
// `stored`, the value as stored at bf16 (the source of the JAX package's
// plain route, which quantizes the stored conv output for the 3x3 conv).
// comb = sx * w_scale is formed in f32 by the caller. The divisions are
// correctly rounded (a reciprocal multiply plus one FMA correction, below),
// and the epilogue rounds after the product and after the sum (__fmul_rn,
// __fadd_rn: no contraction into an FMA), so the kernel repeats the plain
// version's arithmetic step for step and its outputs are bit-equal.
//
// What bounds it on an H100: bytes, in principle. At the batch-1 serving
// shape (4,550 x 1024 x 1024) it moves ~24 MB (x bf16 in; y bf16 and yq int8
// out; the 1 MB weight) for 9.5 GOP, which the int8 tensor cores finish in
// less time than the memory takes. The kernel keeps the int8 copy of x and
// the int32 accumulator out of device memory, and overlaps the three kinds of
// work a row panel needs on each SM:
//   - persistent: one block per SM walks a contiguous range of work items
//     (64 rows x 128 columns, row-panel major), so 4,550 rows (576 items)
//     spread over all 132 SMs, and a block quantizes each 64-row panel of x
//     it touches once, for all the columns it computes there;
//   - the panel sits in shared memory as int8 [64, K] (K <= 1024), written by
//     the threads straight into the 128-byte swizzled K-major layout that the
//     wgmma descriptor reads. Panels are double-buffered: three quantizer
//     warps fill the next one while the current one is in use;
//   - one producer thread streams the weight tiles [128 n, 128 k] by TMA
//     (128-byte swizzle) into a 4-stage ring gated by mbarriers;
//   - two consumer warpgroups take alternate items (ping-pong): while one
//     runs its item's wgmma m64n128k32 s8 x s8 -> s32 from shared memory, the
//     other runs its epilogue (dequant, bias, ReLU, requant) on its
//     accumulators and stores y and yq through a swizzled staging tile in
//     whole 16-byte chunks of rows (f32 y, for the tight check, is stored
//     from the registers).
// Quantizing is exact without a division per value: x * (1 / scale) lies
// within 2^-22 of the quotient, so it rounds as the quotient does unless a
// half-integer is that close (or the clip decides); only then is the
// correctly rounded quotient formed.
// What holds it back on the card is no single queue. Variants that halved
// the weight bytes an output needs (128-row items on both warpgroups; pairs
// of blocks sharing each weight tile by TMA multicast) or doubled the ring
// (one panel buffer, 8 stages) moved it by under 10%, and some made it
// slower. Each item's product runs on one warpgroup at a time in m64n128
// steps, and the quantize and requant arithmetic (~15 instructions a value)
// shares the SM with it; a wider product per warpgroup (m64n256, with the
// registers rebalanced by setmaxnreg) is the next thing to try.
// Designs tried before this one: a cluster of 8 blocks sharing one 128-row
// panel (quantized once, exchanged through distributed shared memory by
// per-thread stores, then by the copy engine), one 128 x 128 tile a block;
// its phases ran one after another in the one block an SM holds.
//
// Every other width takes the streamed route (int8_matmul_streamed): two
// panels [64, K] fit shared memory only up to K = 1,024, so above that, and
// where N or K is no multiple of 128, one small kernel quantizes x into an
// int8 copy xq [M, K'] in device memory (K' the next multiple of 128, the
// columns past K zero), and the product kernel (A_TMA) streams xq's
// [64, 128] tiles by TMA beside the weight tiles through the same ring,
// with the same epilogue; the wrapper zero-pads wq, comb and bias to
// multiples of 128 and drops the padded outputs. Zeros quantize to 0 and
// add nothing to an int32 sum, so y and yq stay bit-equal to the plain
// version's. The route moves xq out and back in (M K' bytes each way) that
// the panel route keeps on chip; K is bounded only by device memory.

#include <cuda.h>   // CUtensorMap and its enums; the encoder is looked up from libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                    // rows of a work item and of a panel (one wgmma m64)
constexpr int BN = 128;                   // columns of a work item
constexpr int BK = 128;                   // K bytes per tile: one 128-byte swizzle row
constexpr int STAGES = 4;                 // weight-tile ring depth
constexpr int MAX_K = 1024;               // two panels [BM, K] must fit shared memory
constexpr int THREADS = 3 * 128;          // 2 consumer warpgroups, then the producer warpgroup
constexpr int QUANT_THREADS = 96;         // warps 9-11 quantize the coming panels
constexpr uint32_t TILE_BYTES = BN * BK;  // 16 KB
constexpr int STAGE_BYTES = BM * BN * 2;  // a consumer's staged bf16 tile (16 KB)
constexpr uint32_t A_TILE_BYTES = BM * BK;  // streamed: an int8 tile of x (8 KB)
// streamed (A_TMA): no panels; the ring holds an x tile beside each weight tile
constexpr size_t smem_bytes(int K, bool a_tma) {
  return (a_tma ? 0 : 2 * (size_t)BM * K)
       + (size_t)STAGES * (TILE_BYTES + (a_tma ? A_TILE_BYTES : 0)) + 2 * (size_t)STAGE_BYTES
       + (2 * STAGES + 6) * sizeof(uint64_t) + 1024;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 a = *reinterpret_cast<const float4*>(p + 4 * i);
    v[4 * i] = a.x; v[4 * i + 1] = a.y; v[4 * i + 2] = a.z; v[4 * i + 3] = a.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[16]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint4 r = *reinterpret_cast<const uint4*>(p + 8 * j);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[8 * j + 2 * i] = f.x;
      v[8 * j + 2 * i + 1] = f.y;
    }
  }
}

// a / b correctly rounded, given rb = the correctly rounded 1 / b: q0 = a*rb
// is within an ulp of a / b, and one FMA-exact residual step rounds it
// correctly (Markstein). Valid away from overflow and underflow; a quotient
// that tiny rounds to 0 under rintf either way.
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  const float q0 = __fmul_rn(a, rb);
  const float r = __fmaf_rn(-b, q0, a);
  return __fmaf_rn(r, rb, q0);
}

// clip(rint(x / scale), -127, 127) as an int8 bit pattern. x * rscale is
// within 2^-22 |x / scale| of the quotient, so its rounding is the quotient's
// unless a half-integer lies that close (or the clip decides anyway); only
// then is the correctly rounded quotient formed.
__device__ __forceinline__ uint32_t quant(float x, float scale, float rscale) {
  const float t = __fmul_rn(x, rscale);
  float q = rintf(t);
  if (fabsf(t - q) > 0.49f) q = rintf(div_rn(x, scale, rscale));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)(int)q;
}

__device__ __forceinline__ uint32_t quant4(const float* v, float s, float rs) {
  return quant(v[0], s, rs) | quant(v[1], s, rs) << 8 | quant(v[2], s, rs) << 16
       | quant(v[3], s, rs) << 24;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

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

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32
       | (uint64_t)1 << 62;
}

__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
      " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52,"
      " %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
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
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// One consumer's item [64 rows, 128 columns] out of its accumulators (the
// dequantized f32 values' bits), rows past M not stored, with yq where asked.
// An accumulator element 4 * nb + 2 * half + j sits at row 16 * (t / 32) +
// (t % 32) / 4 + 8 * half, column 8 * nb + 2 * (t % 4) + j.
// f32 y (the tight check): straight from the registers; the stored value is
// the f32 one, so `stored` changes nothing.
__device__ __forceinline__ void store_item(float* y, int8_t* yq, const int (&acc)[64], uint8_t*,
                                           int m0, int n0, int M, int N, float nx, float rnx,
                                           int, int t, int) {
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + (t >> 5) * 16 + ((t & 31) >> 2) + 8 * half;
      const float v0 = __int_as_float(acc[4 * nb + 2 * half]);
      const float v1 = __int_as_float(acc[4 * nb + 2 * half + 1]);
      const size_t off = (size_t)r * N + n0 + nb * 8 + (t & 3) * 2;
      if (r < M) {
        store2(y + off, v0, v1);
        if (yq != nullptr)
          *reinterpret_cast<uint16_t*>(yq + off) =
              (uint16_t)(quant(v0, nx, rnx) | quant(v1, nx, rnx) << 8);
      }
    }
}

// bf16 y, then yq, through the consumer's staging tile `st` (named barrier
// 1 + w): y as [64][256 B], yq as [64][128 B], the 16-byte chunk c of row r
// at c ^ (r % 8), so that the register writes and the row reads both miss
// bank conflicts and every global store is a whole 16-byte chunk of a row.
// With `stored`, yq quantizes each value as rounded to bf16 (what y holds).
__device__ __forceinline__ void store_item(__nv_bfloat16* y, int8_t* yq, const int (&acc)[64],
                                           uint8_t* st, int m0, int n0, int M, int N, float nx,
                                           float rnx, int w, int t, int stored) {
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = (t >> 5) * 16 + ((t & 31) >> 2) + 8 * half;
      store2(reinterpret_cast<__nv_bfloat16*>(st + r * 256 + ((nb ^ (r & 7)) << 4)) + (t & 3) * 2,
             __int_as_float(acc[4 * nb + 2 * half]), __int_as_float(acc[4 * nb + 2 * half + 1]));
    }
  named_sync(1 + w, 128);
#pragma unroll
  for (int k = 0; k < BM * 16 / 128; ++k) {
    const int ch = t + 128 * k, r = ch >> 4, c = ch & 15;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(y + (size_t)(m0 + r) * N + n0 + c * 8) =
          *reinterpret_cast<const uint4*>(st + r * 256 + ((c ^ (r & 7)) << 4));
  }
  named_sync(1 + w, 128);
  if (yq == nullptr) return;
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = (t >> 5) * 16 + ((t & 31) >> 2) + 8 * half;
      float v0 = __int_as_float(acc[4 * nb + 2 * half]);
      float v1 = __int_as_float(acc[4 * nb + 2 * half + 1]);
      if (stored) {
        const float2 s = __bfloat1622float2(__floats2bfloat162_rn(v0, v1));
        v0 = s.x;
        v1 = s.y;
      }
      *reinterpret_cast<uint16_t*>(st + r * 128 + (((nb >> 1) ^ (r & 7)) << 4) + (nb & 1) * 8
                                   + (t & 3) * 2) =
          (uint16_t)(quant(v0, nx, rnx) | quant(v1, nx, rnx) << 8);
    }
  named_sync(1 + w, 128);
#pragma unroll
  for (int k = 0; k < BM * 8 / 128; ++k) {
    const int ch = t + 128 * k, r = ch >> 3, c = ch & 7;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(yq + (size_t)(m0 + r) * N + n0 + c * 16) =
          *reinterpret_cast<const uint4*>(st + r * 128 + ((c ^ (r & 7)) << 4));
  }
  named_sync(1 + w, 128);
}

// Rows [m0, m0 + BM) of x quantized into the swizzled panel [K / BK][BM][128]
// (rows past M are zero), by thread t of n; a thread's loads of 256 bytes of
// x are all in flight before it quantizes them.
template <typename Tin>
__device__ void quantize_panel(const Tin* __restrict__ x, uint8_t* panel, int m0, int M, int K,
                               float sx, float rsx, int t, int n) {
  constexpr int V = 16 * sizeof(Tin) / 16;    // 16-byte loads per 16 values
  constexpr int U = 16 / V;                   // chunks of 16 values in flight
  const int row_chunks = K / 16, chunks = BM * row_chunks;
  for (int base = t; base < chunks; base += U * n) {
    uint4 raw[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ch = base + u * n, r = ch / row_chunks;
      const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K
                                                        + (ch % row_chunks) * 16);
#pragma unroll
      for (int j = 0; j < V; ++j)
        raw[u][j] = ch < chunks && m0 + r < M ? src[j] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ch = base + u * n;
      if (ch < chunks) {
        float v[16];
        load16(reinterpret_cast<const Tin*>(raw[u]), v);
        const int r = ch / row_chunks, k = (ch % row_chunks) * 16;
        *reinterpret_cast<uint4*>(panel + (k / BK) * (BM * 128) + r * 128
                                  + ((((k % BK) / 16) ^ (r & 7)) << 4)) =
            make_uint4(quant4(v, sx, rsx), quant4(v + 4, sx, rsx),
                       quant4(v + 8, sx, rsx), quant4(v + 12, sx, rsx));
      }
    }
  }
}

// A_TMA (streamed): x comes pre-quantized, xq [M, K] int8, its [64, 128]
// tiles brought in by TMA beside the weight tiles; the quantizer warps idle.
template <typename Tin, typename Tout, bool A_TMA>
__global__ void __launch_bounds__(THREADS, 1)
int8_matmul_kernel(const __grid_constant__ CUtensorMap wmap,  // wq [N, K] int8, 128 x 128 boxes
                   const __grid_constant__ CUtensorMap amap,  // A_TMA: xq [M, K], 128 x 64 boxes
                   const Tin* __restrict__ x,        // [M, K]
                   const float* __restrict__ comb,   // [N]
                   const float* __restrict__ bias,   // [N]
                   const float* __restrict__ sx_p,   // scalar
                   const float* __restrict__ nx_p,   // scalar, or null
                   Tout* __restrict__ y,             // [M, N]
                   int8_t* __restrict__ yq,          // [M, N], or null
                   int M, int N, int K, int relu, int stored) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int KB = K / BK, NT = N / BN, panel_bytes = A_TMA ? 0 : BM * K;
  uint8_t* panels = smem;                                 // [2][KB][BM][128], swizzled
  uint8_t* ring_a = smem + 2 * panel_bytes;               // A_TMA: [STAGES][BM][128], by TMA
  uint8_t* ring = ring_a + (A_TMA ? STAGES * A_TILE_BYTES : 0);  // [STAGES][BN][128], by TMA
  uint8_t* staging = ring + STAGES * TILE_BYTES;          // [2][STAGE_BYTES]
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* pfull = empty + STAGES;   // [2]: panel buffer b holds its coming panel
  uint64_t* pempty = pfull + 2;       // [2]: both consumers are done with buffer b
  uint64_t* order = pempty + 2;       // [2]: consumer w may start its next product

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this block's items [first, last): item i is row panel i / NT, column tile i % NT
  const long long total = (long long)((M + BM - 1) / BM) * NT;
  const int first = (int)(total * blockIdx.x / gridDim.x);
  const int last = (int)(total * (blockIdx.x + 1) / gridDim.x);
  const int items = last - first, p0 = first / NT, n_panels = (last - 1) / NT - p0 + 1;
  const float sx = *sx_p, rsx = __frcp_rn(sx);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&pfull[b], QUANT_THREADS);
      mbar_init(&pempty[b], 2);
      mbar_init(&order[b], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (!A_TMA) {   // the first panel, by all
    quantize_panel(x, panels, p0 * BM, M, K, sx, rsx, tid, THREADS);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    if (warp == 8) {   // the producer: weight tiles of every item, in order
      if (lane == 0) {
        int slot = 0;
        for (int i = 0; i < items; ++i)
          for (int kb = 0; kb < KB; ++kb, ++slot) {
            const int s = slot % STAGES;
            if (slot >= STAGES) mbar_wait(&empty[s], ((slot / STAGES) & 1) ^ 1);
            mbar_expect_tx(&full[s], TILE_BYTES + (A_TMA ? A_TILE_BYTES : 0));
            if constexpr (A_TMA)
              tma_load_2d(ring_a + s * A_TILE_BYTES, &amap, &full[s], kb * BK,
                          ((first + i) / NT) * BM);
            tma_load_2d(ring + s * TILE_BYTES, &wmap, &full[s], kb * BK, ((first + i) % NT) * BN);
          }
      }
    } else if constexpr (!A_TMA) {   // the quantizers: panel l into buffer l % 2
      for (int l = 1; l < n_panels; ++l) {
        const int b = l & 1;
        if (l >= 2) mbar_wait(&pempty[b], ((l >> 1) + 1) & 1);
        quantize_panel(x, panels + b * panel_bytes, (p0 + l) * BM, M, K, sx, rsx, tid - 288,
                       QUANT_THREADS);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&pfull[b]);
      }
    }
    return;
  }

  // consumer warpgroup w takes the items first + w, first + w + 2, ...; the
  // products run in item order (each waits for the other warpgroup's previous
  // one), so each ring slot is awaited in its own phase and one warpgroup's
  // epilogue overlaps the other's product
  const int w = warp >> 2, t = tid & 127;
  const float nx = yq != nullptr ? *nx_p : 1.f;
  const float rnx = __frcp_rn(nx);
  uint8_t* st = staging + w * STAGE_BYTES;
  int cur = 0;   // local panel this warpgroup is on
  for (int i = w; i < items; i += 2) {
    const int item = first + i, l = item / NT - p0, n0 = (item % NT) * BN;
    const int m0 = (p0 + l) * BM;
    if constexpr (!A_TMA) {
      if (l > cur) {
        for (; cur < l; ++cur)
          if (t == 0) mbar_arrive(&pempty[cur & 1]);
        __syncwarp();
      }
      if (l > 0) mbar_wait(&pfull[l & 1], ((l >> 1) + ((l & 1) ^ 1)) & 1);
    }

    const int nth = i >> 1;   // this warpgroup's nth item
    if (w == 1) mbar_wait(&order[1], nth & 1);
    else if (nth > 0) mbar_wait(&order[0], (nth - 1) & 1);
    int acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0;
    const uint32_t a_base = smem_u32(panels + (l & 1) * panel_bytes);
    int prev = -1;
    for (int kb = 0; kb < KB; ++kb) {
      const int slot = i * KB + kb, s = slot % STAGES;
      mbar_wait(&full[s], (slot / STAGES) & 1);
      __syncwarp();
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const uint32_t a = A_TMA ? smem_u32(ring_a + s * A_TILE_BYTES) : a_base + kb * (BM * 128);
      const uint32_t b = smem_u32(ring + s * TILE_BYTES);
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(acc);
      if (prev >= 0) {   // the stage before this one is read: hand it back
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (t == 0) mbar_arrive(&empty[prev]);
        __syncwarp();
      }
      prev = s;
    }
    if (t == 0) mbar_arrive(&order[w ^ 1]);   // every slot of this item has landed
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (t == 0) mbar_arrive(&empty[prev]);
    __syncwarp();

    // epilogue: dequantized in place (the f32 bits in the int registers; the
    // layout is store_item's), then stored
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      const int c = n0 + nb * 8 + (lane & 3) * 2;
      const float c0 = comb[c], c1 = comb[c + 1], b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v0 = __fadd_rn(__fmul_rn((float)acc[4 * nb + 2 * half], c0), b0);
        float v1 = __fadd_rn(__fmul_rn((float)acc[4 * nb + 2 * half + 1], c1), b1);
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        acc[4 * nb + 2 * half] = __float_as_int(v0);
        acc[4 * nb + 2 * half + 1] = __float_as_int(v1);
      }
    }
    store_item(y, yq, acc, st, m0, n0, M, N, nx, rnx, w, t, stored);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime in the libcuda it
// has already loaded (no link against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

template <typename Tin, typename Tout, bool A_TMA>
int launch(const CUtensorMap& wmap, const CUtensorMap& amap, const void* x, const void* comb,
           const void* bias, const void* sx, const void* nx, void* y, void* yq, int M, int N,
           int K, int relu, int stored, cudaStream_t stream) {
  const auto kernel = int8_matmul_kernel<Tin, Tout, A_TMA>;
  const size_t smem = smem_bytes(K, A_TMA);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  const long long items = (long long)((M + BM - 1) / BM) * (N / BN);
  const int grid = (int)(items < sms ? items : sms);
  kernel<<<grid, THREADS, smem, stream>>>(wmap, amap, (const Tin*)x, (const float*)comb,
                                          (const float*)bias, (const float*)sx, (const float*)nx,
                                          (Tout*)y, (int8_t*)yq, M, N, K, relu, stored);
  return (int)cudaGetLastError();
}

// The streamed route's first kernel: x [M, Kx] quantized into xq [M, K]
// int8 (K >= Kx; the columns from Kx on are zeros, as quantized zeros are),
// 16 values a thread and pass, with the panels' arithmetic.
template <typename Tin>
__global__ void __launch_bounds__(256)
int8_quantize_kernel(const Tin* __restrict__ x, const float* __restrict__ sx_p,
                     uint8_t* __restrict__ xq, int M, int Kx, int K) {
  const float sx = *sx_p, rsx = __frcp_rn(sx);
  const int row_chunks = K / 16;
  const long long chunks = (long long)M * row_chunks;
  for (long long ch = (long long)blockIdx.x * blockDim.x + threadIdx.x; ch < chunks;
       ch += (long long)gridDim.x * blockDim.x) {
    const long long r = ch / row_chunks;
    const int k0 = (int)(ch % row_chunks) * 16;
    float v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      v[i] = k0 + i < Kx ? to_float(x[r * Kx + k0 + i]) : 0.f;
    *reinterpret_cast<uint4*>(xq + r * K + k0) =
        make_uint4(quant4(v, sx, rsx), quant4(v + 4, sx, rsx), quant4(v + 8, sx, rsx),
                   quant4(v + 12, sx, rsx));
  }
}

// An int8 [rows, K] tensor map of boxes [box_rows, 128], 128-byte swizzle.
bool encode_map(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {BK, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The panel route's product kernel at the four dtype pairs.
int launch_panels(const CUtensorMap& wmap, const void* x, int x_f32, const void* comb,
                  const void* bias, const void* sx, const void* nx, void* y, int y_f32, void* yq,
                  int M, int N, int K, int relu, int stored, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  const CUtensorMap none = {};
  if (x_f32)
    return y_f32 ? launch<float, float, false>(wmap, none, x, comb, bias, sx, nx, y, yq, M, N,
                                               K, relu, stored, s)
                 : launch<float, bf16, false>(wmap, none, x, comb, bias, sx, nx, y, yq, M, N,
                                              K, relu, stored, s);
  return y_f32 ? launch<bf16, float, false>(wmap, none, x, comb, bias, sx, nx, y, yq, M, N, K,
                                            relu, stored, s)
               : launch<bf16, bf16, false>(wmap, none, x, comb, bias, sx, nx, y, yq, M, N, K,
                                           relu, stored, s);
}

}  // namespace

// x [M, K] (bf16, or f32 when x_f32), wq [N, K] int8, comb and bias [N] f32,
// sx (and nx when yq is not null) f32 scalars on the device -> y [M, N] (bf16,
// or f32 when y_f32) and optionally yq [M, N] int8, quantized from the f32
// value or, with yq_stored, from the value y stores. Needs N % 128 == 0,
// K % 128 == 0, K <= 1024 (two panels [64, K] in shared memory) and 16-byte
// aligned x and wq. Returns the CUDA error of the launch (0 on success).
extern "C" int int8_matmul_fused(const void* x, int x_f32, const void* wq, const void* comb,
                                 const void* bias, const void* sx, const void* nx, void* y,
                                 int y_f32, void* yq, int M, int N, int K, int relu,
                                 int yq_stored, void* stream) {
  if (M < 1 || N < BN || N % BN != 0 || K < BK || K % BK != 0 || K > MAX_K)
    return (int)cudaErrorInvalidValue;
  CUtensorMap wmap;
  if (!encode_map(&wmap, wq, N, K, BN)) return (int)cudaErrorInvalidValue;
  return launch_panels(wmap, x, x_f32, comb, bias, sx, nx, y, y_f32, yq, M, N, K, relu,
                       yq_stored, (cudaStream_t)stream);
}

// The streamed route, for any other width: x [M, Kx] is quantized into xq
// [M, K] int8 (scratch; K >= Kx a multiple of 128, the columns from Kx on
// zero) by one kernel, then the product kernel streams xq's tiles by TMA
// beside the weight tiles, with no panel in shared memory, so K is bounded
// only by device memory. wq [N, K], comb and bias [N] come zero-padded to
// multiples of 128 (the padded outputs are 0 and the caller drops them); y
// and yq are [M, N]. Two launches. Returns the CUDA error of the first
// launch that failed (0 on success).
extern "C" int int8_matmul_streamed(const void* x, int x_f32, int Kx, void* xq, const void* wq,
                                    const void* comb, const void* bias, const void* sx,
                                    const void* nx, void* y, int y_f32, void* yq, int M, int N,
                                    int K, int relu, int yq_stored, void* stream) {
  if (M < 1 || N < BN || N % BN != 0 || K < BK || K % BK != 0 || Kx < 1 || Kx > K ||
      ((uintptr_t)xq | (uintptr_t)wq) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int device = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  const long long chunks = (long long)M * (K / 16);
  const int blocks = (int)((chunks + 255) / 256 < 8LL * sms ? (chunks + 255) / 256 : 8LL * sms);
  if (x_f32)
    int8_quantize_kernel<float><<<blocks, 256, 0, s>>>((const float*)x, (const float*)sx,
                                                       (uint8_t*)xq, M, Kx, K);
  else
    int8_quantize_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)sx, (uint8_t*)xq, M, Kx, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  CUtensorMap wmap, amap;
  if (!encode_map(&wmap, wq, N, K, BN) || !encode_map(&amap, xq, M, K, BM))
    return (int)cudaErrorInvalidValue;
  // the product reads no x: its tiles come from xq by TMA
  return y_f32 ? launch<__nv_bfloat16, float, true>(wmap, amap, nullptr, comb, bias, sx, nx, y,
                                                    yq, M, N, K, relu, yq_stored, s)
               : launch<__nv_bfloat16, __nv_bfloat16, true>(wmap, amap, nullptr, comb, bias, sx,
                                                            nx, y, yq, M, N, K, relu, yq_stored,
                                                            s);
}
