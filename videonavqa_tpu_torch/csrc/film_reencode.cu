// FiLM question re-encode: F chained masked LSTM passes over one question.
//
// Replaces videonavqa_tpu/kernels/film_reencode_pallas.py (_reencode_kernel,
// called by film_reencode_pallas). The FiLM generator re-encodes the question
// once per frame with a carried (h, c): num_frames x q_len steps in series
// (35 x 56 = 1,960 at full width). The input projection xw = emb W_ih^T + b_ih
// is one matmul outside the kernel.
//
// The chain (what bounds it on an H100, and how a thread-block cluster per
// batch row spreads W_hh and hands h from step to step) is lstm_cluster.cuh,
// shared with lstm.cu. Here it runs from zero state, and each pass's final
// (frozen) h is the output: the carry freezes at t >= q_len, so those steps
// change nothing and are skipped, and a row runs F x q_len steps, not F x Tq.
//
// That chain is written for hidden size 128; the wrapper zero-pads a smaller
// one up to it, which is exact (a padded unit's weights, biases and inputs
// are zero, so its c and h stay 0). Above 128, W_hh (16 H^2 bytes: 1 MB at
// 256, 4 MB at 512) no longer fits a cluster's registers, and the re-encode
// runs as F chained passes of the wide chain of lstm_wide.cuh
// (film_reencode_wide_kernel: the hidden units spread over all SMs, one grid
// barrier a step), each pass from the last one's frozen carry, its final h
// written straight into finals[f]: the carry freezes at t >= len, so the
// final carry is the pass's last valid h, and no gather is needed.

#include "lstm_cluster.cuh"
#include "lstm_wide.cuh"

namespace {

using namespace lstm_cluster;

__global__ void __launch_bounds__(THREADS, 1)
film_reencode_kernel(const float* __restrict__ xw,    // [Tq, B, 4H]
                     const float* __restrict__ w_hh,  // [4H, H]
                     const float* __restrict__ b_hh,  // [4H]
                     const int* __restrict__ lens,    // [B]
                     float* __restrict__ finals,      // [F, B, H]
                     int Tq, int B, int F) {
  __shared__ Chain ch;
  const int b = blockIdx.y;
  const int t = threadIdx.x, j = t % KS;
  const int u = cluster_rank() * U + t / KS;
  const int len = min(max(lens[b], 0), Tq);
  float h = 0.f, c = 0.f;
  run_chain(ch, xw, w_hh, b_hh, nullptr, b, B, len, F, h, c, [](int, int, float) {},
            [&](int f, float hf) {
              if (j == 0) finals[((size_t)f * B + b) * H + u] = hf;
            });
  __syncwarp();
  cluster_sync();   // no block leaves while a peer may still write into it
}

LSTM_WIDE_KERNEL(film_reencode_wide_kernel, false)

}  // namespace

// xw [Tq, B, 4H], w_hh [4H, H], b_hh [4H] f32; lens [B] int32 -> finals [F, B, H] f32,
// with a cluster of CS blocks per batch row. Returns the CUDA error of the
// launch (0 on success). Needs hidden == 128 and 1 <= B <= 65,535.
extern "C" int film_reencode(const void* xw, const void* w_hh, const void* b_hh,
                             const void* lens, void* finals, int Tq, int B, int F,
                             int hidden, void* stream) {
  if (hidden != H || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  return launch_clusters(film_reencode_kernel, B, (cudaStream_t)stream, (const float*)xw,
                         (const float*)w_hh, (const float*)b_hh, (const int*)lens, (float*)finals,
                         Tq, B, F);
}

// The same at any hidden size H that is a multiple of 4, as F chained passes
// of the wide chain, in launches of lstm_wide::device_rows(H) batch rows
// (*launched counts them). scratch is f32, zeroed: h0 [B, H] (zeros), c
// [B, H] and h_steps [2, rows, H]. Returns the CUDA error of the first launch that
// failed (0 on success; cudaErrorInvalidValue for a shape the chain does not
// take).
extern "C" int film_reencode_wide(const void* xw, const void* w_hh, const void* b_hh,
                                  const void* lens, void* finals, void* scratch, int Tq, int B,
                                  int F, int H, int* launched, void* stream) {
  *launched = 0;
  const int rows = lstm_wide::device_rows(H);
  if (Tq < 1 || B < 1 || F < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  float* zeros = (float*)scratch;
  float* c = zeros + (size_t)B * H;
  float* h_steps = c + (size_t)B * H;
  float* out = (float*)finals;
  for (int s = 0; s < B; s += rows)
    for (int f = 0; f < F; ++f) {
      lstm_wide::Args a = {};
      a.xw = (const float*)xw + (size_t)s * 4 * H;
      a.ldb = B;
      a.w_hh = (const float*)w_hh;
      a.b_hh = (const float*)b_hh;
      a.lens = (const int*)lens + s;
      a.h0 = (f == 0 ? zeros : out + (size_t)(f - 1) * B * H) + (size_t)s * H;
      a.c0 = c + (size_t)s * H;
      a.outs = nullptr;
      a.h_f = out + ((size_t)f * B + s) * H;
      a.c_f = c + (size_t)s * H;
      a.h_steps = h_steps;
      a.T = Tq;
      a.B = B - s < rows ? B - s : rows;
      a.H = H;
      const cudaError_t err =
          lstm_wide::launch<film_reencode_wide_kernel_kernels>(a, (cudaStream_t)stream);
      if (err != cudaSuccess) return (int)err;
      ++*launched;
    }
  return 0;
}
