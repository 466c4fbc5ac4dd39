// Fused int8 1x1 conv of the FiLM trunk: quantize -> int8 GEMM -> dequant.
//
// Replaces videonavqa_tpu/kernels/int8_matmul_pallas.py (_kernel and
// _kernel_requant, called by matmul_int8_fused_pallas):
//   xq  = clip(round_half_even(x / sx), -127, 127)          (int8)
//   acc = xq @ wq^T                                           (int32, exact)
//   y   = acc * comb + bias, then ReLU if asked              (f32, stored bf16/f32)
//   yq  = clip(round_half_even(y / nx), -127, 127)           (int8, optional)
// comb = sx * w_scale is formed in f32 by the caller. The divisions are
// correctly rounded (a reciprocal multiply plus one FMA correction, below),
// and the epilogue rounds after the product and after the sum (__fmul_rn,
// __fadd_rn: no contraction into an FMA), so the kernel repeats the plain
// version's arithmetic step for step and its outputs are bit-equal.
//
// What bounds it on an H100: bytes. At the serving shape (4,550 x 1024 x
// 1024) it moves ~24 MB (x bf16 in; y bf16 and yq int8 out; the 1 MB weight)
// for 9.5 GOP, which the int8 tensor cores finish in less time than the
// memory takes. The design fuses the whole chain so the int8 copy of x and
// the int32 accumulator never reach device memory:
//   - a block owns 32 rows of x and quantizes them ONCE into a shared-memory
//     panel [32, K] (quantizing per output tile would repeat the work N/128
//     times, and quantization, not the product, was then the cost);
//   - it walks all N in 128-column tiles; the weight tiles [128, BK] stream
//     from L2 through a 3-stage cp.async ring while the tensor cores work;
//   - mma.sync m16n8k32 s8 x s8 -> s32, 8 warps of 16 x 32; rows of every
//     shared tile are padded by 16 bytes so fragment loads hit 32 banks;
//   - the epilogue of each 128-column tile is written as soon as it is done.
// wgmma, TMA and a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PBM = 32;          // rows of x per block (its int8 panel)
constexpr int BN = 128;          // output columns per tile
constexpr int BK = 128;          // reduction depth per pipeline step
constexpr int LDS = BK + 16;     // weight-tile row stride in bytes
constexpr int STAGES = 3;        // weight-tile ring depth
constexpr int THREADS = 256;

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
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

__device__ __forceinline__ uint32_t quant(float x, float scale, float rscale) {
  float q = rintf(div_rn(x, scale, rscale));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)(int)q;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const Tin* __restrict__ x,        // [M, K]
                   const int8_t* __restrict__ wq,    // [N, K]
                   const float* __restrict__ comb,   // [N]
                   const float* __restrict__ bias,   // [N]
                   const float* __restrict__ sx_p,   // scalar
                   const float* __restrict__ nx_p,   // scalar, or null
                   Tout* __restrict__ y,             // [M, N]
                   int8_t* __restrict__ yq,          // [M, N], or null
                   int M, int N, int K, int relu) {
  extern __shared__ __align__(16) int8_t smem[];
  const int lda = K + 16;
  int8_t* As = smem;                   // [PBM][K + 16]: this block's int8 rows of x
  int8_t* Bs = smem + PBM * lda;       // [STAGES][BN][LDS]: weight tiles

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 16 x 32
  const int grp = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * PBM;
  const int KT = K / BK, steps = (N / BN) * KT;

  auto load_tile = [&](int step) {
    const int n0 = (step / KT) * BN, k0 = (step % KT) * BK;
    int8_t* dst = Bs + (step % STAGES) * BN * LDS;
#pragma unroll
    for (int it = 0; it < (BN * BK / 16) / THREADS; ++it) {
      const int ch = tid + it * THREADS;
      const int r = ch / (BK / 16), kc = (ch % (BK / 16)) * 16;
      cp_async16(dst + r * LDS + kc, wq + (size_t)(n0 + r) * K + k0 + kc);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_tile(s);
    cp_async_commit();
  }

  // quantize this block's rows of x once, while the first weight tiles load
  const float sx = *sx_p, rsx = __frcp_rn(sx);
  const int row_chunks = K / 8;
  for (int ch = tid; ch < PBM * row_chunks; ch += THREADS) {
    const int r = ch / row_chunks, kc = (ch % row_chunks) * 8;
    uint2 packed = make_uint2(0u, 0u);
    if (m0 + r < M) {
      float v[8];
      load8(x + (size_t)(m0 + r) * K + kc, v);
      packed.x = quant(v[0], sx, rsx) | quant(v[1], sx, rsx) << 8
               | quant(v[2], sx, rsx) << 16 | quant(v[3], sx, rsx) << 24;
      packed.y = quant(v[4], sx, rsx) | quant(v[5], sx, rsx) << 8
               | quant(v[6], sx, rsx) << 16 | quant(v[7], sx, rsx) << 24;
    }
    *reinterpret_cast<uint2*>(As + r * lda + kc) = packed;
  }
  const float nx = yq != nullptr ? *nx_p : 1.f;
  const float rnx = __frcp_rn(nx);

  int acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait();
    __syncthreads();  // tile `step` has landed; the ring slot refilled next is free
    if (step + STAGES - 1 < steps) load_tile(step + STAGES - 1);
    cp_async_commit();
    const int kt = step % KT;
    const int8_t* Bt = Bs + (step % STAGES) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4], bf[4][2];
      const int8_t* pa = As + (wm * 16 + grp) * lda + kt * BK + kk + tig * 4;
      a[0] = *reinterpret_cast<const uint32_t*>(pa);
      a[1] = *reinterpret_cast<const uint32_t*>(pa + 8 * lda);
      a[2] = *reinterpret_cast<const uint32_t*>(pa + 16);
      a[3] = *reinterpret_cast<const uint32_t*>(pa + 8 * lda + 16);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* pb = Bt + (wn * 32 + ni * 8 + grp) * LDS + kk + tig * 4;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(pb);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(pb + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[ni], a, bf[ni]);
    }
    if (kt != KT - 1) continue;
    // the 128-column tile is complete: epilogue
    const int n0 = (step / KT) * BN;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + tig * 2;
      const float c0 = comb[col], c1 = comb[col + 1];
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 16 + grp + half * 8;
        if (row < M) {
          float v0 = __fadd_rn(__fmul_rn((float)acc[ni][2 * half], c0), b0);
          float v1 = __fadd_rn(__fmul_rn((float)acc[ni][2 * half + 1], c1), b1);
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          const size_t off = (size_t)row * N + col;
          store2(y + off, v0, v1);
          if (yq != nullptr)
            *reinterpret_cast<uint16_t*>(yq + off) =
                (uint16_t)(quant(v0, nx, rnx) | quant(v1, nx, rnx) << 8);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[ni][r] = 0;
    }
  }
}

template <typename Tin, typename Tout>
int launch(const void* x, const void* wq, const void* comb, const void* bias, const void* sx,
           const void* nx, void* y, void* yq, int M, int N, int K, int relu,
           cudaStream_t stream) {
  const size_t smem = (size_t)PBM * (K + 16) + (size_t)STAGES * BN * LDS;
  const cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_kernel<Tin, Tout>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int8_matmul_kernel<Tin, Tout><<<(M + PBM - 1) / PBM, THREADS, smem, stream>>>(
      (const Tin*)x, (const int8_t*)wq, (const float*)comb, (const float*)bias,
      (const float*)sx, (const float*)nx, (Tout*)y, (int8_t*)yq, M, N, K, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] (bf16, or f32 when x_f32), wq [N, K] int8, comb and bias [N] f32,
// sx (and nx when yq is not null) f32 scalars on the device -> y [M, N] (bf16,
// or f32 when y_f32) and optionally yq [M, N] int8. Needs N % 128 == 0,
// K % 128 == 0, K <= 4096 and 16-byte aligned x and wq. Returns the CUDA
// error of the launch (0 on success).
extern "C" int int8_matmul_fused(const void* x, int x_f32, const void* wq, const void* comb,
                                 const void* bias, const void* sx, const void* nx, void* y,
                                 int y_f32, void* yq, int M, int N, int K, int relu,
                                 void* stream) {
  if (M < 1 || N % BN != 0 || K % BK != 0 || K > 4096) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_f32)
    return y_f32 ? launch<float, float>(x, wq, comb, bias, sx, nx, y, yq, M, N, K, relu, s)
                 : launch<float, __nv_bfloat16>(x, wq, comb, bias, sx, nx, y, yq, M, N, K, relu, s);
  return y_f32 ? launch<__nv_bfloat16, float>(x, wq, comb, bias, sx, nx, y, yq, M, N, K, relu, s)
               : launch<__nv_bfloat16, __nv_bfloat16>(x, wq, comb, bias, sx, nx, y, yq, M, N, K, relu, s);
}
