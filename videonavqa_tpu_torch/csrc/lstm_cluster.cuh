// The cluster-spread masked LSTM chain at hidden size 128, shared by
// film_reencode.cu (the FiLM question re-encode) and lstm.cu (the masked
// LSTM pass, and F such passes chained).
//
// A chain runs F passes over the same xw [T, B, 4H] for one batch row: each
// pass takes the row's first len steps, and pass f + 1 starts from pass f's
// final (frozen) carry. Per step,
//   gates = xw[s] + h W_hh^T + b_hh, gate order (i, f, g, o);
//   c' = sigmoid(f) c + sigmoid(i) tanh(g);  h' = sigmoid(o) tanh(c').
// Steps at s >= len change nothing and are skipped.
//
// What bounds it on an H100: the serial chain, not device-memory bytes or
// operations. Each step is a [4H, H] x [H] product whose result the next
// step needs, so a step's latency sets the time. W_hh in f32 is 256 KB: over
// a block's 227 KB of shared memory, and all of an SM's registers. One block
// per batch row that held half of it in registers and read the other half,
// and all of h per thread, from shared memory every step spent ~3,000 clocks
// a step on shared-memory delivery. The chain spreads W_hh over a
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
//   - the next step's xw is loaded before the wait, so the load overlaps it.
// Clusters beyond one wave queue, so any B runs; batch 1 uses CS SMs.
// CS = 8 was the fastest of 2, 4 and 8 on an NVIDIA H100 80GB HBM3 at a 700 W
// power limit, at batch 1, 32 and 45 (the sweep is in PERF.md); another size
// is a -D CS=... build of a kernel file. On the same card the chain takes
// ~0.6 us a step.
// All arithmetic is f32; the sums are taken in another order than the plain
// version's.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lstm_cluster {

constexpr int H = 128;          // hidden size the chain is written for
constexpr int KS = 8;           // threads that share a hidden unit, each 16 columns
constexpr int KPT = H / KS;     // columns of W_hh per thread (for each of the 4 gates)
#ifndef CS
#define CS 8                    // blocks in the cluster that runs one batch row
#endif
static_assert(CS == 2 || CS == 4 || CS == 8, "a cluster of 2, 4 or 8 blocks");
constexpr int U = H / CS;           // hidden units per block
constexpr int THREADS = KS * U;     // threads per block

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

// One block's part of the chain of batch row b. The block runs THREADS
// threads in a cluster of CS along x; thread t serves unit
// u = rank U + t / KS, column slice j = t % KS. h0_row (H floats, or null for
// zeros) starts every block's h; the thread's (h, c) start as the caller set
// them. on_step(f, s, h) runs in every thread after each valid step, and
// on_frame(f, h) after each pass; (h, c) hold the frozen carry at the end.
struct Chain {
  __align__(16) float h_s[2][H];   // double-buffered h, all H units
  __align__(8) uint64_t full[2];   // h_s[i] holds the h of the coming step
};

template <class OnStep, class OnFrame>
__device__ __forceinline__ void run_chain(Chain& ch, const float* __restrict__ xw,
                                          const float* __restrict__ w_hh,
                                          const float* __restrict__ b_hh,
                                          const float* __restrict__ h0_row, int b, int B,
                                          int len, int F, float& h, float& c, OnStep on_step,
                                          OnFrame on_frame) {
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
  for (int i = t; i < 2 * H; i += blockDim.x)
    (&ch.h_s[0][0])[i] = h0_row != nullptr && i < H ? h0_row[i] : 0.f;
  if (t == 0) {
    mbar_init(&ch.full[0], 1);
    mbar_init(&ch.full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();   // every block runs, with its h set and its barriers armed

  const float* xw_b = xw + (size_t)b * 4 * H + u;
  const size_t xw_step = (size_t)B * 4 * H;
  float xv[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) xv[g] = len > 0 ? xw_b[g * H] : 0.f;
  // step n of the F x len reads h_s[n % 2], written at step n - 1 (set before
  // the chain at n = 0); full[b] completes once for each step n >= 1 with
  // n % 2 == b
  const int total = F * len;
  int n = 0;
  for (int f = 0; f < F; ++f) {
    for (int s = 0; s < len; ++s, ++n) {
      const int cur = n & 1;
      if (n > 0) mbar_wait(&ch.full[cur], ((n >> 1) + cur + 1) & 1);
      if (t == 0 && n + 1 < total) mbar_expect_tx(&ch.full[cur ^ 1], H * sizeof(float));
      const float4* hv = reinterpret_cast<const float4*>(ch.h_s[cur]);
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
      if (j < CS && n + 1 < total) st_async(&ch.h_s[cur ^ 1][u], &ch.full[cur ^ 1], j, h);
      on_step(f, s, h);
      const int s_next = s + 1 < len ? s + 1 : 0;
#pragma unroll
      for (int g = 0; g < 4; ++g) xv[g] = xw_b[s_next * xw_step + g * H];
    }
    on_frame(f, h);
  }
}

// Launches kernel(args...) with a grid of CS x B blocks of THREADS threads,
// CS blocks along x forming one cluster per batch row. Returns the CUDA error.
template <class... KArgs, class... Args>
int launch_clusters(void (*kernel)(KArgs...), int B, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS, B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, (KArgs)args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace lstm_cluster
