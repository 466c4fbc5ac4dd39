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
// step needs, so a step's latency sets the time, and within a step the
// shared-memory delivery rate (128 bytes a clock per SM) does: every step
// each of the 512 threads reads all 128 h values (256 KB in all) and its
// 64 shared-memory weights (128 KB), ~3,000 clocks. Reading h as 16-byte
// broadcast loads delivers the same bytes and measured no faster. Fewer
// bytes per step need register blocking over several gate rows per thread,
// or the weights spread over a cluster of SMs (later work). The design
// keeps everything a step touches on chip:
//   - one block per batch row (rows are independent), 4H = 512 threads, one
//     gate row per thread;
//   - W_hh in f32 is 256 KB, over the 227 KB a block can use, so each thread
//     holds half of its row (64 floats) in registers and the other half sits
//     in shared memory, laid out so that neighbouring threads read
//     neighbouring words;
//   - thread t = 4u + g owns gate g of hidden unit u, so the four gates of a
//     unit meet in four neighbouring lanes by warp shuffles, and h is double
//     buffered in shared memory: one block barrier per step;
//   - the carry freezes at t >= q_len, so those steps change nothing and are
//     skipped: a row runs F x q_len steps, not F x Tq;
//   - xw for the next step is loaded a step ahead to hide its latency.
// All arithmetic is f32 (no reduced-precision weights).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int H = 128;          // hidden size the kernel is written for
constexpr int G = 4 * H;        // gate rows = threads per block
constexpr int KREG = 64;        // W_hh columns held in registers
constexpr int KSM = H - KREG;   // W_hh columns held in shared memory
constexpr size_t SMEM_BYTES = (size_t)(KSM * G + 2 * H) * sizeof(float);

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(G, 1)
film_reencode_kernel(const float* __restrict__ xw,    // [Tq, B, 4H]
                     const float* __restrict__ w_hh,  // [4H, H]
                     const float* __restrict__ b_hh,  // [4H]
                     const int* __restrict__ lens,    // [B]
                     float* __restrict__ finals,      // [F, B, H]
                     int Tq, int B, int F) {
  extern __shared__ float smem[];
  float* w_s = smem;             // w_s[k * G + t] = W_hh[row(t)][KREG + k]
  float* h_s = smem + KSM * G;   // [2][H], double-buffered h

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int u = t >> 2, g = t & 3;
  const int row = g * H + u;

  float w_r[KREG];
#pragma unroll
  for (int k = 0; k < KREG; ++k) w_r[k] = w_hh[row * H + k];
  for (int k = 0; k < KSM; ++k) w_s[k * G + t] = w_hh[row * H + KREG + k];
  if (t < 2 * H) h_s[t] = 0.f;
  const float bias = b_hh[row];
  const int len = min(max(lens[b], 0), Tq);
  __syncthreads();

  float c = 0.f, h = 0.f;  // the carry, live in lanes with g == 0
  int cur = 0;
  const float* xw_b = xw + (size_t)b * G + row;
  const size_t xw_step = (size_t)B * G;
  float xv = len > 0 ? xw_b[0] : 0.f;
  for (int f = 0; f < F; ++f) {
    for (int s = 0; s < len; ++s) {
      const int s_next = s + 1 < len ? s + 1 : 0;
      const float xv_next = xw_b[s_next * xw_step];
      const float* hc = h_s + cur * H;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int k = 0; k < KREG; k += 4) {
        a0 = fmaf(hc[k], w_r[k], a0);
        a1 = fmaf(hc[k + 1], w_r[k + 1], a1);
        a2 = fmaf(hc[k + 2], w_r[k + 2], a2);
        a3 = fmaf(hc[k + 3], w_r[k + 3], a3);
      }
#pragma unroll 8
      for (int k = 0; k < KSM; k += 4) {
        a0 = fmaf(hc[KREG + k], w_s[k * G + t], a0);
        a1 = fmaf(hc[KREG + k + 1], w_s[(k + 1) * G + t], a1);
        a2 = fmaf(hc[KREG + k + 2], w_s[(k + 2) * G + t], a2);
        a3 = fmaf(hc[KREG + k + 3], w_s[(k + 3) * G + t], a3);
      }
      const float gate = (xv + ((a0 + a1) + (a2 + a3))) + bias;
      const int base = lane & ~3;
      const float gi = __shfl_sync(0xffffffffu, gate, base);
      const float gf = __shfl_sync(0xffffffffu, gate, base + 1);
      const float gg = __shfl_sync(0xffffffffu, gate, base + 2);
      const float go = __shfl_sync(0xffffffffu, gate, base + 3);
      if (g == 0) {
        c = sigmoidf(gf) * c + sigmoidf(gi) * tanhf(gg);
        h = sigmoidf(go) * tanhf(c);
        h_s[(cur ^ 1) * H + u] = h;
      }
      cur ^= 1;
      xv = xv_next;
      __syncthreads();
    }
    if (g == 0) finals[((size_t)f * B + b) * H + u] = h;
  }
}

}  // namespace

// xw [Tq, B, 4H], w_hh [4H, H], b_hh [4H] f32; lens [B] int32 -> finals [F, B, H] f32.
// Returns the CUDA error of the launch (0 on success). Needs hidden == 128.
extern "C" int film_reencode(const void* xw, const void* w_hh, const void* b_hh,
                             const void* lens, void* finals, int Tq, int B, int F,
                             int hidden, void* stream) {
  if (hidden != H) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      film_reencode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  film_reencode_kernel<<<B, G, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)xw, (const float*)w_hh, (const float*)b_hh, (const int*)lens,
      (float*)finals, Tq, B, F);
  return (int)cudaGetLastError();
}
