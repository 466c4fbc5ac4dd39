// FiLM question re-encode: F chained masked LSTM passes over one question.
//
// Replaces videonavqa_tpu/kernels/film_reencode_pallas.py (_reencode_kernel,
// called by film_reencode_pallas). The FiLM generator re-encodes the question
// once per frame with a carried (h, c): num_frames x q_len steps in series
// (35 x 56 = 1,960 at full width). The input projection xw = emb W_ih^T + b_ih
// is one matmul outside the kernel.
//
// What bounds it on an H100: the serial chain, not device-memory bytes or
// operations. Each step is a [4H, H] x [H] product whose result the next
// step needs, so a step's latency sets the time. W_hh in f32 is 256 KB: over
// a block's 227 KB of shared memory, and all of an SM's registers. One block
// per batch row that held half of it in registers and read the other half,
// and all of h per thread, from shared memory every step spent ~3,000 clocks
// a step on shared-memory delivery. The design spreads W_hh over a
// thread-block cluster instead:
//   - a cluster of CS = 8 blocks per batch row; block r owns hidden
//     units [r H / CS, (r + 1) H / CS) and holds the four gate rows of each
//     of its units wholly in registers (256 KB / CS per block);
//   - eight threads share a unit, each holding its 4 gates x 16 columns of
//     W_hh (64 floats): a thread reads 16 h values a step (not 128), four
//     16-byte loads that neighbouring threads take from neighbouring words,
//     does 64 FMAs, and three butterfly shuffles sum the unit's 4 gates;
//   - every thread of a unit keeps the unit's c; the new h goes straight
//     into each block's double-buffered h through distributed shared memory
//     (thread j of the unit writes to block j of the cluster) by st.async,
//     which also counts its 4 bytes on that block's mbarrier of the buffer;
//   - so a block waits only until all 128 values of the next h have landed
//     in its own shared memory: a one-way signal, not an all-to-all barrier
//     (one cluster barrier a step, tried first, took about twice as long a
//     step). The double buffer is safe without a barrier: a block writes a
//     buffer for step n + 1 only after every block's h of step n reached it,
//     that is after every block finished reading the same buffer at n - 1;
//   - the next step's xw is loaded before the wait, so the load overlaps it;
//   - the carry freezes at t >= q_len, so those steps change nothing and are
//     skipped: a row runs F x q_len steps, not F x Tq. Clusters beyond one
//     wave queue, so any B runs; batch 1 uses CS SMs.
// CS = 8 was the fastest of 2, 4 and 8 on an H100 at batch 1, 32 and 45 (the
// sweep is in PERF.md); another size is a -D CS=... build of this file.
// All arithmetic is f32 (no reduced-precision weights); the sums are taken in
// another order than the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int H = 128;          // hidden size the kernel is written for
constexpr int KS = 8;           // threads that share a hidden unit, each 16 columns
constexpr int KPT = H / KS;     // columns of W_hh per thread (for each of the 4 gates)
#ifndef CS
#define CS 8                    // blocks in the cluster that runs one batch row
#endif
static_assert(CS == 2 || CS == 4 || CS == 8, "a cluster of 2, 4 or 8 blocks");

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// v into the shared memory of block `rank` of the cluster, at the address
// `p` has in this block, counted on that block's mbarrier at `bar`'s address.
__device__ __forceinline__ void st_async(float* p, uint64_t* bar, uint32_t rank, float v) {
  uint32_t rp, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rp) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rb) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n"
               :: "r"(rp), "f"(v), "r"(rb) : "memory");
}

__global__ void __launch_bounds__(KS * H / CS, 1)
film_reencode_kernel(const float* __restrict__ xw,    // [Tq, B, 4H]
                     const float* __restrict__ w_hh,  // [4H, H]
                     const float* __restrict__ b_hh,  // [4H]
                     const int* __restrict__ lens,    // [B]
                     float* __restrict__ finals,      // [F, B, H]
                     int Tq, int B, int F) {
  constexpr int U = H / CS;     // hidden units per block
  __shared__ __align__(16) float h_s[2][H];   // double-buffered h, all H units
  __shared__ __align__(8) uint64_t full[2];   // h_s[i] holds the h of the coming step

  const int b = blockIdx.y;
  const uint32_t rank = cluster_rank();
  const int t = threadIdx.x, j = t % KS;
  const int u = rank * U + t / KS;

  // thread j of a unit takes the columns 4j + 32m + i (m, i < 4), so the eight
  // threads' 16-byte loads of h cover 128 neighbouring bytes
  float w[4][KPT];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float4 v = *reinterpret_cast<const float4*>(w_hh + (size_t)(g * H + u) * H + 4 * j
                                                        + 32 * m);
      w[g][4 * m] = v.x; w[g][4 * m + 1] = v.y; w[g][4 * m + 2] = v.z; w[g][4 * m + 3] = v.w;
    }
  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = b_hh[g * H + u];
  for (int i = t; i < 2 * H; i += blockDim.x) (&h_s[0][0])[i] = 0.f;
  const int len = min(max(lens[b], 0), Tq);
  if (t == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();   // every block runs, with its h zeroed and its barriers set

  const float* xw_b = xw + (size_t)b * 4 * H + u;
  const size_t xw_step = (size_t)B * 4 * H;
  float xv[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) xv[g] = len > 0 ? xw_b[g * H] : 0.f;
  float c = 0.f, h = 0.f;
  // step n of the F x len reads h_s[n % 2], written at step n - 1 (zero at
  // n = 0); full[b] completes once for each step n >= 1 with n % 2 == b
  const int total = F * len;
  int n = 0;
  for (int f = 0; f < F; ++f) {
    for (int s = 0; s < len; ++s, ++n) {
      const int cur = n & 1;
      if (n > 0) mbar_wait(&full[cur], ((n >> 1) + cur + 1) & 1);
      if (t == 0 && n + 1 < total) mbar_expect_tx(&full[cur ^ 1], H * sizeof(float));
      const float4* hv = reinterpret_cast<const float4*>(h_s[cur]);
      float acc[4][2];
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g][0] = acc[g][1] = 0.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 hh = hv[j + 8 * m];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[g][0] = fmaf(hh.x, w[g][4 * m], acc[g][0]);
          acc[g][1] = fmaf(hh.y, w[g][4 * m + 1], acc[g][1]);
          acc[g][0] = fmaf(hh.z, w[g][4 * m + 2], acc[g][0]);
          acc[g][1] = fmaf(hh.w, w[g][4 * m + 3], acc[g][1]);
        }
      }
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float a = acc[g][0] + acc[g][1];
#pragma unroll
        for (int off = 1; off < KS; off <<= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
        gate[g] = (xv[g] + a) + bias[g];
      }
      c = sigmoidf(gate[1]) * c + sigmoidf(gate[0]) * tanhf(gate[2]);
      h = sigmoidf(gate[3]) * tanhf(c);
      if (j < CS && n + 1 < total) st_async(&h_s[cur ^ 1][u], &full[cur ^ 1], j, h);
      const int s_next = s + 1 < len ? s + 1 : 0;
#pragma unroll
      for (int g = 0; g < 4; ++g) xv[g] = xw_b[s_next * xw_step + g * H];
    }
    if (j == 0) finals[((size_t)f * B + b) * H + u] = h;
  }
  __syncwarp();
  cluster_sync();   // no block leaves while a peer may still write into it
}

int launch(const void* xw, const void* w_hh, const void* b_hh, const void* lens, void* finals,
           int Tq, int B, int F, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS, B, 1);
  cfg.blockDim = dim3(KS * H / CS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, film_reencode_kernel, (const float*)xw, (const float*)w_hh, (const float*)b_hh,
      (const int*)lens, (float*)finals, Tq, B, F);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// xw [Tq, B, 4H], w_hh [4H, H], b_hh [4H] f32; lens [B] int32 -> finals [F, B, H] f32,
// with a cluster of CS blocks per batch row. Returns the CUDA error of the
// launch (0 on success). Needs hidden == 128 and 1 <= B <= 65,535.
extern "C" int film_reencode(const void* xw, const void* w_hh, const void* b_hh,
                             const void* lens, void* finals, int Tq, int B, int F,
                             int hidden, void* stream) {
  if (hidden != H || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  return launch(xw, w_hh, b_hh, lens, finals, Tq, B, F, (cudaStream_t)stream);
}
