// Masked LSTM over one batch of sequences, from a given (h0, c0), and F
// such passes chained over the same input.
//
// Replaces videonavqa_tpu/kernels/lstm_pallas.py (_lstm_kernel, called by
// lstm_pallas; the JAX time_multi_hop calls it once per frame from a scan).
// The input projection xw = x W_ih^T + b_ih is one matmul outside; the
// recurrent product h W_hh^T is computed here. Per step t:
//   gates = xw[t] + h W_hh^T + b_hh, gate order (i, f, g, o);
//   c' = sigmoid(f) c + sigmoid(i) tanh(g);  h' = sigmoid(o) tanh(c');
//   where t < len: (h, c) = (h', c') and outs[t] = h'; elsewhere the carry
//   stays and outs[t] = 0.
// All arithmetic is f32.
//
// What bounds it on an H100: the serial chain of T steps, each of which needs
// all of the previous h, and within a step the delivery of W_hh (256 KB at
// hidden size 128, 4 MB at 512, 37.7 MB at 1536) to the FMA units. Device
// memory bytes and operations are small beside that. Two designs:
//
//   - hidden size 128 (lstm_h128_cluster_kernel): the chain of
//     lstm_cluster.cuh, shared with film_reencode.cu: a cluster of 8 blocks
//     per batch row, W_hh spread over the cluster's registers, 8 threads a
//     hidden unit, the new h handed to every block by st.async into
//     distributed shared memory with one mbarrier a buffer and no barrier a
//     step. It runs F passes over the same xw in one launch, pass f + 1 from
//     pass f's frozen final carry (F = 1: one pass from (h0, c0)), so a
//     model that re-encodes its question once per frame loads W_hh once,
//     not once a frame. Steps at t >= len change nothing and are skipped;
//     their outputs are stored as zeros after the chain.
//   - any other hidden size (lstm_wide_kernel): W_hh does not fit in one SM,
//     so the hidden units are spread over the SMs: a cooperative launch of
//     ceil(H / U) blocks, U hidden units each, one unit (its four gate rows)
//     per warp, and every block serves all batch rows, so one read of a
//     weight serves them all. Each step a block copies h [B, H] from device
//     memory (L2) into shared memory; each lane walks the columns
//     k = 4 lane .. 4 lane + 3, then + 128, ... of the warp's four rows (read
//     from L2, or from L1 where the block's slice fits) against all batch
//     rows, in 16-byte loads; a butterfly reduce-scatter over the lanes
//     leaves batch row b's four gate sums in lane b, which holds c[b, u] in a
//     register for the whole sequence; and the new h goes to the other half
//     of a double buffer in device memory. One grid barrier per step. The
//     loop runs to max(len), not T. Per step and SM the shared memory
//     delivers U x B x H x 4 bytes of h, four FMAs for each 4 bytes: the FMA
//     rate and the shared-memory rate bound a step together, and the copy of
//     h into every block and the grid barrier come on top. A launch takes at
//     most 32 batch rows; the wrapper runs a wider batch as launches of 32.
//     Why not more of Hopper: one 512-thread block per SM holding W_hh on
//     chip, with register tiles, cp.async-pipelined h and an arrival counter
//     in place of grid.sync, was measured against this kernel on an H100 and
//     was no faster at batch 32 and about 2x slower at batch 1; its step,
//     like this one's, is bound by every SM reading all of h from L2 and by
//     the step barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

using lstm_cluster::sigmoidf;

// ---------------------------------------------------------------- hidden 128

__global__ void __launch_bounds__(lstm_cluster::THREADS, 1)
lstm_h128_cluster_kernel(const float* __restrict__ xw,    // [T, B, 4H]
                         const float* __restrict__ w_hh,  // [4H, H]
                         const float* __restrict__ b_hh,  // [4H]
                         const int* __restrict__ lens,    // [B]
                         const float* __restrict__ h0,    // [B, H]
                         const float* __restrict__ c0,    // [B, H]
                         float* __restrict__ outs,        // [F, T, B, H]
                         float* __restrict__ h_f,         // [B, H]
                         float* __restrict__ c_f,         // [B, H]
                         int T, int B, int F) {
  using namespace lstm_cluster;
  __shared__ Chain ch;
  const int b = blockIdx.y;
  const int t = threadIdx.x, j = t % KS;
  const int u0 = cluster_rank() * U, u = u0 + t / KS;
  const int len = min(max(lens[b], 0), T);
  float h = h0[(size_t)b * H + u], c = c0[(size_t)b * H + u];
  const size_t step = (size_t)B * H, frame = (size_t)T * step;
  float* out_b = outs + (size_t)b * H;
  run_chain(ch, xw, w_hh, b_hh, h0 + (size_t)b * H, b, B, len, F, h, c,
            [&](int f, int s, float hs) {
              if (j == 0) out_b[f * frame + s * step + u] = hs;
            },
            [](int, float) {});
  if (j == 0) {
    h_f[(size_t)b * H + u] = h;
    c_f[(size_t)b * H + u] = c;
  }
  // zeros at t >= len in every pass: the block's U units, 16 neighbouring
  // threads on one row's neighbouring words
  const int pad = T - len;
  for (int i = t; i < F * pad * U; i += THREADS) {
    const int r = i / U;
    out_b[(r / pad) * frame + (len + r % pad) * step + u0 + i % U] = 0.f;
  }
  __syncwarp();
  cluster_sync();   // no block leaves while a peer may still write into it
}

// ------------------------------------------------------------ any hidden size

constexpr int MAX_U = 12;  // most hidden units (warps) a block of the wide kernel takes
constexpr int SMEM_LIMIT = 232448;  // shared memory a block can use on sm_90

// One exchange of the butterfly below: the lane keeps HALF of its 2*HALF
// values and adds the partner lane's copies of them. A template, so that
// every index into ``a`` is a compile-time constant and ``a`` stays in
// registers.
template <int HALF>
__device__ __forceinline__ void scatter_step(float* a, int lane) {
  if constexpr (HALF >= 1) {
    const bool upper = (lane & HALF) != 0;
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const float send = upper ? a[j] : a[j + HALF];
      const float keep = upper ? a[j + HALF] : a[j];
      a[j] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
    }
    scatter_step<HALF / 2>(a, lane);
  }
}

// Every lane holds NB partial sums a[0..NB). Returns, in lane L, the sum over
// all 32 lanes of a[L % NB]: a butterfly that halves the values a lane keeps
// at each exchange, then plain exchanges over the lane bits above NB.
template <int NB>
__device__ __forceinline__ float lane_sums(float (&a)[NB], int lane) {
  scatter_step<NB / 2>(a, lane);
  float v = a[0];
#pragma unroll
  for (int off = 16; off >= NB; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// NB: batch rows the block's arithmetic runs over (a power of two >= B; the
// rows from B on are zeros in shared memory and are never stored).
template <int NB>
__global__ void __launch_bounds__(32 * MAX_U, 1)
lstm_wide_kernel(const float* __restrict__ xw,    // [T, B, 4H]
                 const float* __restrict__ w_hh,  // [4H, H]
                 const float* __restrict__ b_hh,  // [4H]
                 const int* __restrict__ lens,    // [B]
                 const float* __restrict__ h0,    // [B, H]
                 const float* __restrict__ c0,    // [B, H]
                 float* __restrict__ outs,        // [T, B, H]
                 float* __restrict__ h_f,         // [B, H]
                 float* __restrict__ c_f,         // [B, H]
                 float* h_steps,                  // [2, B, H], h between steps
                 int T, int B, int H, int U) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float h_s[];  // [NB][H]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int u = blockIdx.x * U + warp;   // this warp's hidden unit
  // the same for a whole warp; warps from U on only help to copy h
  const bool has_unit = warp < U && u < H;
  const int b = lane & (NB - 1);         // this lane's batch row
  const bool owner = has_unit && lane < NB && b < B;

  // the longest sequence: every block runs that many steps
  int t_max = 0;
  for (int i = 0; i < B; ++i) t_max = max(t_max, min(max(lens[i], 0), T));
  const int len = owner ? min(max(lens[b], 0), T) : 0;

  float c = 0.f, h = 0.f, bias[4] = {0.f, 0.f, 0.f, 0.f};
  const float* w_row[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) w_row[g] = w_hh + (size_t)(g * H + (has_unit ? u : 0)) * H;
  if (owner) {
    c = c0[(size_t)b * H + u];
    h = h0[(size_t)b * H + u];
#pragma unroll
    for (int g = 0; g < 4; ++g) bias[g] = b_hh[g * H + u];
  }
  const int n_real = B * H;
  for (int i = n_real + threadIdx.x; i < NB * H; i += blockDim.x) h_s[i] = 0.f;

  for (int t = 0; t < t_max; ++t) {
    // all of h as the previous step left it (written by other blocks: read
    // through L2, never from this SM's L1)
    const float* h_prev = t == 0 ? h0 : h_steps + (size_t)(t & 1) * n_real;
    const float4* src = reinterpret_cast<const float4*>(h_prev);
    float4* dst = reinterpret_cast<float4*>(h_s);
#pragma unroll 4
    for (int i = threadIdx.x; i < n_real / 4; i += blockDim.x) dst[i] = __ldcg(src + i);
    float xv[4] = {0.f, 0.f, 0.f, 0.f};
    if (owner) {
#pragma unroll
      for (int g = 0; g < 4; ++g) xv[g] = xw[((size_t)t * B + b) * 4 * H + g * H + u];
    }
    __syncthreads();

    if (has_unit) {
      float acc[4][NB];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j = 0; j < NB; ++j) acc[g][j] = 0.f;
      // four columns a lane and pass: 16-byte loads of the weights and of h
      for (int k = 4 * lane; k < H; k += 128) {
        float4 w[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) w[g] = __ldg(reinterpret_cast<const float4*>(w_row[g] + k));
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float4 hv = *reinterpret_cast<const float4*>(h_s + j * H + k);
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            acc[g][j] = fmaf(hv.x, w[g].x, acc[g][j]);
            acc[g][j] = fmaf(hv.y, w[g].y, acc[g][j]);
            acc[g][j] = fmaf(hv.z, w[g].z, acc[g][j]);
            acc[g][j] = fmaf(hv.w, w[g].w, acc[g][j]);
          }
        }
      }
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) gate[g] = (xv[g] + lane_sums<NB>(acc[g], lane)) + bias[g];
      if (owner) {
        const float c_new = sigmoidf(gate[1]) * c + sigmoidf(gate[0]) * tanhf(gate[2]);
        const float h_new = sigmoidf(gate[3]) * tanhf(c_new);
        const bool valid = t < len;
        if (valid) {
          c = c_new;
          h = h_new;
        }
        outs[((size_t)t * B + b) * H + u] = valid ? h_new : 0.f;
        h_steps[(size_t)((t + 1) & 1) * n_real + (size_t)b * H + u] = h;
      }
    }
    grid.sync();  // every block has read this step's h and written the next
  }
  if (owner) {
    for (int t = t_max; t < T; ++t) outs[((size_t)t * B + b) * H + u] = 0.f;
    h_f[(size_t)b * H + u] = h;
    c_f[(size_t)b * H + u] = c;
  }
}

template <int NB>
cudaError_t launch_wide(void** args, int blocks, int H, cudaStream_t stream) {
  const size_t smem = (size_t)NB * H * sizeof(float);
  if (smem > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
  const void* kernel = (const void*)lstm_wide_kernel<NB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  // refused, not hung, if the blocks cannot all be resident at once
  return cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(32 * MAX_U), args, smem, stream);
}

}  // namespace

// xw [T, B, 4H], w_hh [4H, H], b_hh [4H], h0 and c0 [B, H] f32, lens [B] int32
// -> outs [F, T, B, H], h_f and c_f [B, H] f32: F passes over xw, each from
// the last one's final carry. h_steps [2, B, H] f32 is scratch. Returns the
// CUDA error of the launch (0 on success; cudaErrorInvalidValue for a shape
// the kernels do not take: at a hidden size other than 128, F other than 1,
// more than 32 batch rows, a hidden size that is no multiple of 4 or over
// MAX_U units per SM, an h [B', H] (B' the next power of two) that does not
// fit in shared memory, or buffers off a 16-byte boundary; at 128, more than
// 65,535 batch rows).
extern "C" int lstm_forward(const void* xw, const void* w_hh, const void* b_hh,
                            const void* lens, const void* h0, const void* c0, void* outs,
                            void* h_f, void* c_f, void* h_steps, int T, int B, int H, int F,
                            void* stream) {
  if (T < 1 || B < 1 || H < 1 || F < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (H == lstm_cluster::H) {
    if (B > 65535) return (int)cudaErrorInvalidValue;
    return lstm_cluster::launch_clusters(
        lstm_h128_cluster_kernel, B, st, (const float*)xw, (const float*)w_hh,
        (const float*)b_hh, (const int*)lens, (const float*)h0, (const float*)c0, (float*)outs,
        (float*)h_f, (float*)c_f, T, B, F);
  }
  if (F != 1) return (int)cudaErrorInvalidValue;
  if (B > 32) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int U = (H + sms - 1) / sms;
  if (U > MAX_U) return (int)cudaErrorInvalidValue;
  int blocks = (H + U - 1) / U;
  // the wide kernel moves h and the weights 16 bytes at a time
  if (H % 4 != 0 || ((uintptr_t)h0 | (uintptr_t)h_steps | (uintptr_t)w_hh) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&xw, (void*)&w_hh, (void*)&b_hh, (void*)&lens, (void*)&h0,
                  (void*)&c0, (void*)&outs, (void*)&h_f, (void*)&c_f, (void*)&h_steps,
                  (void*)&T, (void*)&B, (void*)&H, (void*)&U};
  if (B <= 1) err = launch_wide<1>(args, blocks, H, st);
  else if (B <= 2) err = launch_wide<2>(args, blocks, H, st);
  else if (B <= 4) err = launch_wide<4>(args, blocks, H, st);
  else if (B <= 8) err = launch_wide<8>(args, blocks, H, st);
  else if (B <= 16) err = launch_wide<16>(args, blocks, H, st);
  else err = launch_wide<32>(args, blocks, H, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
