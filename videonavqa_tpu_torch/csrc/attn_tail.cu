// film_attn attention tail: 35 steps of attention over frames + an LSTMCell.
//
// Replaces videonavqa_tpu/kernels/attn_tail_pallas.py (_attn_tail_kernel,
// called by attn_tail_pallas). Per step:
//   v = h . w_hid + b_hid;  logits = v + (scores + mask);
//   m = max(max_t logits, v);
//   denom = sum_t exp(logits - m) + n_phantom * exp(v - m);
//   ctxt = sum_t (exp(logits - m) / denom) * feats[t];
//   (h, c) = LSTMCell(ctxt, (h, c)) with bias b_ih + b_hh.
// The -2^31 mask arithmetic stays in f32, with scores + mask formed first.
//
// What bounds it on an H100: the serial chain of num_steps (35) steps, each
// of which needs the previous h. Bytes and operations are small (at batch 32:
// 0.6 MB of features, 0.5 MB of weights). The design:
//   - one block per batch row, 4A = 512 threads, one gate row per thread;
//   - the row's features [T, A] (<= 32 KB) sit in shared memory for all
//     steps; the softmax runs inside one warp (T <= 64: two frames a lane);
//   - W_ih and W_hh (512 KB together, too large for one SM) are read from
//     L2 every step, re-laid by the wrapper as [k][4u + g] so that
//     neighbouring threads read neighbouring addresses;
//   - thread t = 4u + g owns gate g of unit u: the four gates meet by warp
//     shuffles; h is double-buffered in shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int A = 128;      // attention hidden size the kernel is written for
constexpr int G = 4 * A;    // gate rows = threads per block
constexpr int TMAX = 64;    // most frames the warp softmax handles

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(G, 1)
attn_tail_kernel(const float* __restrict__ feats,   // [B, T, A]
                 const float* __restrict__ scores,  // [B, T]
                 const float* __restrict__ mask,    // [B, T]
                 const float* __restrict__ w_hid,   // [A]
                 const float* __restrict__ b_hid,   // [1]
                 const float* __restrict__ w_ih_t,  // [A, 4A]: [k][4u + g] = w_ih[g*A + u][k]
                 const float* __restrict__ w_hh_t,  // [A, 4A], same layout
                 const float* __restrict__ bias,    // [4A]:    [4u + g] = (b_ih + b_hh)[g*A + u]
                 float* __restrict__ hs,            // [B, S, A]
                 int T, int S, float n_phantom) {
  extern __shared__ float smem[];
  float* f_s = smem;             // [T][A]
  float* sm_s = f_s + T * A;     // [TMAX] scores + mask
  float* co_s = sm_s + TMAX;     // [TMAX] attention weights
  float* h_s = co_s + TMAX;      // [2][A]
  float* x_s = h_s + 2 * A;      // [A] context

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int u = t >> 2, g = t & 3;

  for (int i = t; i < T * A; i += G) f_s[i] = feats[(size_t)b * T * A + i];
  for (int i = t; i < T; i += G) sm_s[i] = scores[b * T + i] + mask[b * T + i];
  if (t < 2 * A) h_s[t] = 0.f;
  const float bias_t = bias[t];
  const float bh = b_hid[0];
  float wh[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wh[j] = w_hid[lane + 32 * j];
  __syncthreads();

  float c = 0.f;  // the cell state, live in lanes with g == 0
  int cur = 0;
  for (int step = 0; step < S; ++step) {
    const float* hc = h_s + cur * A;
    if (warp == 0) {
      float p = hc[lane] * wh[0] + hc[lane + 32] * wh[1]
              + hc[lane + 64] * wh[2] + hc[lane + 96] * wh[3];
      const float v = warp_sum(p) + bh;
      const bool in0 = lane < T, in1 = lane + 32 < T;
      const float l0 = in0 ? v + sm_s[lane] : -INFINITY;
      const float l1 = in1 ? v + sm_s[lane + 32] : -INFINITY;
      const float m = fmaxf(warp_max(fmaxf(l0, l1)), v);
      const float e0 = in0 ? expf(l0 - m) : 0.f;
      const float e1 = in1 ? expf(l1 - m) : 0.f;
      const float denom = warp_sum(e0 + e1) + n_phantom * expf(v - m);
      if (in0) co_s[lane] = e0 / denom;
      if (in1) co_s[lane + 32] = e1 / denom;
    }
    __syncthreads();
    if (t < A) {
      float ctx = 0.f;
      for (int j = 0; j < T; ++j) ctx = fmaf(co_s[j], f_s[j * A + t], ctx);
      x_s[t] = ctx;
    }
    __syncthreads();
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
    for (int k = 0; k < A; k += 2) {
      a0 = fmaf(x_s[k], __ldg(w_ih_t + k * G + t), a0);
      a1 = fmaf(hc[k], __ldg(w_hh_t + k * G + t), a1);
      a2 = fmaf(x_s[k + 1], __ldg(w_ih_t + (k + 1) * G + t), a2);
      a3 = fmaf(hc[k + 1], __ldg(w_hh_t + (k + 1) * G + t), a3);
    }
    const float gate = ((a0 + a2) + (a1 + a3)) + bias_t;
    const int base = lane & ~3;
    const float gi = __shfl_sync(0xffffffffu, gate, base);
    const float gf = __shfl_sync(0xffffffffu, gate, base + 1);
    const float gg = __shfl_sync(0xffffffffu, gate, base + 2);
    const float go = __shfl_sync(0xffffffffu, gate, base + 3);
    if (g == 0) {
      c = sigmoidf(gf) * c + sigmoidf(gi) * tanhf(gg);
      const float h = sigmoidf(go) * tanhf(c);
      h_s[(cur ^ 1) * A + u] = h;
      hs[((size_t)b * S + step) * A + u] = h;
    }
    cur ^= 1;
    __syncthreads();
  }
}

}  // namespace

// feats [B, T, A], scores and mask [B, T], w_hid [A], b_hid [1], w_ih_t and
// w_hh_t [A, 4A] and bias [4A] in the interleaved gate layout, all f32
// -> hs [B, S, A] f32. Returns the CUDA error of the launch (0 on success).
extern "C" int attn_tail(const void* feats, const void* scores, const void* mask,
                         const void* w_hid, const void* b_hid, const void* w_ih_t,
                         const void* w_hh_t, const void* bias, void* hs, int B, int T,
                         int S, int hidden, float n_phantom, void* stream) {
  if (hidden != A || T < 1 || T > TMAX) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(T * A + 2 * TMAX + 3 * A) * sizeof(float);
  attn_tail_kernel<<<B, G, smem, (cudaStream_t)stream>>>(
      (const float*)feats, (const float*)scores, (const float*)mask, (const float*)w_hid,
      (const float*)b_hid, (const float*)w_ih_t, (const float*)w_hh_t, (const float*)bias,
      (float*)hs, T, S, n_phantom);
  return (int)cudaGetLastError();
}
