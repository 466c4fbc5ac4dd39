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

#include "lstm_cluster.cuh"

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
