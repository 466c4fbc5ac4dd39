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
//   - any other hidden size (lstm_wide_kernel): the chain of lstm_wide.cuh,
//     shared with film_reencode.cu and attn_tail.cu: the hidden units spread
//     over all SMs in one cooperative launch, every block serving all batch
//     rows, h handed from step to step through device memory, one grid
//     barrier a step. A launch takes up to 32 batch rows (fewer where h
//     [rows, H] would not fit shared memory: 16 above hidden 1,816); the C
//     entry runs a wider batch as launches of that many rows. Why not more
//     of Hopper: one 512-thread block per SM holding W_hh on chip, with
//     register tiles, cp.async-pipelined h and an arrival counter in place
//     of grid.sync, was measured against this kernel on an H100 and was no
//     faster at batch 32 and about 2x slower at batch 1; its step, like this
//     one's, is bound by every SM reading all of h from L2 and by the step
//     barrier.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_cluster.cuh"
#include "lstm_wide.cuh"

namespace {

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

// ------------------------------------------------------------ any other hidden size

LSTM_WIDE_KERNEL(lstm_wide_kernel, false)

}  // namespace

// At hidden size 128: xw [T, B, 4H], w_hh [4H, H], b_hh [4H], h0 and c0
// [B, H] f32, lens [B] int32 -> outs [F, T, B, H], h_f and c_f [B, H] f32: F
// passes over xw, each from the last one's final carry, in one launch.
// Returns the CUDA error of the launch (0 on success; cudaErrorInvalidValue
// for another hidden size, or more than 65,535 batch rows).
extern "C" int lstm_forward(const void* xw, const void* w_hh, const void* b_hh,
                            const void* lens, const void* h0, const void* c0, void* outs,
                            void* h_f, void* c_f, int T, int B, int H, int F, void* stream) {
  if (T < 1 || B < 1 || B > 65535 || F < 1 || H != lstm_cluster::H)
    return (int)cudaErrorInvalidValue;
  return lstm_cluster::launch_clusters(
      lstm_h128_cluster_kernel, B, (cudaStream_t)stream, (const float*)xw, (const float*)w_hh,
      (const float*)b_hh, (const int*)lens, (const float*)h0, (const float*)c0, (float*)outs,
      (float*)h_f, (float*)c_f, T, B, F);
}

// The most batch rows one launch of the wide kernel takes at hidden size H
// on this device (0: not even one row of h fits shared memory).
extern "C" int lstm_wide_rows(int H) { return lstm_wide::device_rows(H); }

// At any hidden size H that is a multiple of 4: one pass, xw [T, B, 4H],
// w_hh [4H, H], b_hh [4H], h0 and c0 [B, H] f32, lens [B] int32 -> outs
// [T, B, H], h_f and c_f [B, H] f32, as launches of lstm_wide_rows(H) batch
// rows (*launched counts them). h_steps [2, lstm_wide_rows(H), H] f32 is
// scratch. Returns the CUDA error of the first launch that failed (0 on
// success; cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int lstm_wide_forward(const void* xw, const void* w_hh, const void* b_hh,
                                 const void* lens, const void* h0, const void* c0, void* outs,
                                 void* h_f, void* c_f, void* h_steps, int T, int B, int H,
                                 int* launched, void* stream) {
  *launched = 0;
  const int rows = lstm_wide::device_rows(H);
  if (T < 1 || B < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < B; s += rows) {
    lstm_wide::Args a = {};
    a.xw = (const float*)xw + (size_t)s * 4 * H;
    a.ldb = B;
    a.w_hh = (const float*)w_hh;
    a.b_hh = (const float*)b_hh;
    a.lens = (const int*)lens + s;
    a.h0 = (const float*)h0 + (size_t)s * H;
    a.c0 = (const float*)c0 + (size_t)s * H;
    a.outs = (float*)outs + (size_t)s * H;
    a.h_f = (float*)h_f + (size_t)s * H;
    a.c_f = (float*)c_f + (size_t)s * H;
    a.h_steps = (float*)h_steps;
    a.T = T;
    a.B = B - s < rows ? B - s : rows;
    a.H = H;
    const cudaError_t err = lstm_wide::launch<lstm_wide_kernel_kernels>(a, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return 0;
}
