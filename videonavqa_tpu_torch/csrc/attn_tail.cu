// film_attn attention tail: num_steps (35) steps of attention over frames + an LSTMCell.
//
// Replaces videonavqa_tpu/kernels/attn_tail_pallas.py (_attn_tail_kernel,
// called by attn_tail_pallas). Per step:
//   v = h . w_hid + b_hid;  logits = v + (scores + mask);
//   m = max(max_t logits, v), or max_t logits where n_phantom is 0;
//   denom = sum_t exp(logits - m) + n_phantom * exp(v - m) (no such term
//   where n_phantom is 0);
//   ctxt = sum_t (exp(logits - m) / denom) * feats[t];
//   (h, c) = LSTMCell(ctxt, (h, c)) with bias b_ih + b_hh.
// The -2^31 mask arithmetic stays in f32, with scores + mask formed first.
//
// What bounds it on an H100: the serial chain of num_steps steps, each of
// which needs the previous h. Bytes and operations are small (at batch 32:
// 0.6 MB of features, 0.5 MB of weights). Two things make the chain short:
//   - the softmax does not depend on the step. Every frame's logit is
//     v + (scores + mask)[t] and the phantom frames' is v, so v cancels:
//     coef_t = exp(s_t - M) / (sum_t exp(s_t - M) + n_phantom exp(-M)) with
//     s = scores + mask and M = max(max_t s_t, 0) (max_t s_t without
//     phantom frames: the Pallas kernel's max with v then lets every exp
//     underflow to 0 / 0 where all s_t are far under 0), the same at every
//     step (the plain version's v = 0). So the context, and with it the input
//     gates ctxt W_ih^T + b_ih + b_hh, are formed once per launch, reading
//     the row's features once from device memory; the -2^31 mask arithmetic
//     stays in f32 with scores + mask formed first. In real arithmetic this
//     is the same function; in f32 it moves only roundings (the result stays
//     within 1e-5 of the plain version);
//   - a step is then an LSTM cell over a constant input, which runs the way
//     lstm_cluster.cuh runs the re-encode's (whose PTX helpers it uses): a
//     cluster of 8 blocks per batch row, block r owning the hidden units
//     [r AP / 8, (r + 1) AP / 8) with the four W_hh rows of each of them in
//     registers, KS = AP / 16 threads a unit, 16 columns a thread; the new h
//     goes straight into every block's double-buffered h through distributed
//     shared memory by st.async, counted on one mbarrier a buffer, so a block
//     waits only until the whole next h has landed in its own shared memory,
//     with no barrier a step.
// AP, the hidden size the kernel runs, is 128 or 256; the wrapper zero-pads
// a smaller attention size to it, which is exact (a padded unit's weights,
// biases and feature column are zero, so its c and h stay 0). Above 256,
// W_hh (16 AP^2 bytes, 4 MB at 512) no longer fits a cluster's registers:
// attn_tail_wide forms the context and the input gates in two small
// kernels and runs the steps on the wide chain of lstm_wide.cuh, with AP
// zero-padded to a multiple of 4.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lstm_cluster.cuh"
#include "lstm_wide.cuh"

namespace {

using lstm_cluster::cluster_rank;
using lstm_cluster::cluster_sync;
using lstm_cluster::mbar_expect_tx;
using lstm_cluster::mbar_init;
using lstm_cluster::mbar_wait;
using lstm_cluster::sigmoidf;
using lstm_cluster::st_async;

constexpr int ACS = 8;              // blocks in the cluster of one batch row
constexpr int KPT = 16;             // columns a thread takes, for each of the 4 gates
constexpr int SMEM_LIMIT = 232448;  // shared memory a block can use on sm_90

template <int AP>
struct Tail {
  static constexpr int KS = AP / KPT;         // threads a hidden unit: 8 at 128, 16 at 256
  static constexpr int U = AP / ACS;          // hidden units a block
  static constexpr int THREADS = U * KS;      // 128 or 512
  // dynamic shared memory a frame takes: its scores + mask and its
  // coefficient; static: the double-buffered h, the context, barriers
  static constexpr int FRAME_BYTES = 8;
  static constexpr int STATIC_BYTES = 3 * AP * 4 + 16;
};

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

// The row's context into ctx[0..AP), by all the block's threads: the
// attention weights (the plain version's at v = 0) into co_s [T] from
// scores + mask in sm_s [T], then the weighted sum of the row's features,
// read once.
__device__ __forceinline__ void context(const float* __restrict__ feats,
                                        const float* __restrict__ scores,
                                        const float* __restrict__ mask, int b, int T, int AP,
                                        float n_phantom, float* sm_s, float* co_s, float* ctx) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int i = t; i < T; i += blockDim.x)
    sm_s[i] = scores[(size_t)b * T + i] + mask[(size_t)b * T + i];
  __syncthreads();
  if (warp == 0) {   // the weights, the plain version's at v = 0
    float mx = -INFINITY;
    for (int f = lane; f < T; f += 32) mx = fmaxf(mx, sm_s[f]);
    const float m = n_phantom > 0.f ? fmaxf(warp_max(mx), 0.f) : warp_max(mx);
    float se = 0.f;
    for (int f = lane; f < T; f += 32) {
      const float e = expf(sm_s[f] - m);
      co_s[f] = e;
      se += e;
    }
    const float denom = warp_sum(se) + (n_phantom > 0.f ? n_phantom * expf(0.f - m) : 0.f);
    for (int f = lane; f < T; f += 32) co_s[f] = co_s[f] / denom;
  }
  __syncthreads();
  const float* f_b = feats + (size_t)b * T * AP;   // the row's features, read once
  for (int k = t; k < AP; k += blockDim.x) {       // the context
    float x = 0.f;
#pragma unroll 8
    for (int f = 0; f < T; ++f) x = fmaf(co_s[f], __ldg(f_b + (size_t)f * AP + k), x);
    ctx[k] = x;
  }
  __syncthreads();
}

// The four W rows g AP + u of one unit, the thread's 16 columns
// 4 j + 4 KS m + i (m, i < 4): neighbouring threads, neighbouring words.
template <int AP>
__device__ __forceinline__ void load_rows(float (&w)[4][KPT], const float* __restrict__ mat,
                                          int u, int j) {
  constexpr int KS = Tail<AP>::KS;
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float4 v = *reinterpret_cast<const float4*>(mat + (size_t)(g * AP + u) * AP + 4 * j
                                                        + 4 * KS * m);
      w[g][4 * m] = v.x; w[g][4 * m + 1] = v.y; w[g][4 * m + 2] = v.z; w[g][4 * m + 3] = v.w;
    }
}

// acc[g][0..1] += the thread's 16 columns of row g times x's same columns
template <int AP>
__device__ __forceinline__ void dot16(float (&acc)[4][2], const float (&w)[4][KPT],
                                      const float4* x, int j) {
  constexpr int KS = Tail<AP>::KS;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float4 xv = x[j + KS * m];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      acc[g][0] = fmaf(xv.x, w[g][4 * m], acc[g][0]);
      acc[g][1] = fmaf(xv.y, w[g][4 * m + 1], acc[g][1]);
      acc[g][0] = fmaf(xv.z, w[g][4 * m + 2], acc[g][0]);
      acc[g][1] = fmaf(xv.w, w[g][4 * m + 3], acc[g][1]);
    }
  }
}

// the sum over the KS threads of a unit (neighbouring lanes of one warp)
template <int AP>
__device__ __forceinline__ float unit_sum(float a) {
#pragma unroll
  for (int off = 1; off < Tail<AP>::KS; off <<= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
  return a;
}

template <int AP>
__global__ void __launch_bounds__(Tail<AP>::THREADS, 1)
attn_tail_kernel(const float* __restrict__ feats,   // [B, T, AP]
                 const float* __restrict__ scores,  // [B, T]
                 const float* __restrict__ mask,    // [B, T]
                 const float* __restrict__ w_ih,    // [4 AP, AP]
                 const float* __restrict__ w_hh,    // [4 AP, AP]
                 const float* __restrict__ bias,    // [4 AP]: b_ih + b_hh
                 float* __restrict__ hs,            // [B, S, AP]
                 int T, int S, float n_phantom) {
  using P = Tail<AP>;
  constexpr int KS = P::KS, U = P::U;
  __shared__ __align__(16) float h_s[2][AP];
  __shared__ __align__(16) float ctx_s[AP];
  __shared__ __align__(8) uint64_t full[2];
  extern __shared__ float sm_s[];   // [T] scores + mask
  float* co_s = sm_s + T;           // [T] attention weights

  const int b = blockIdx.y;
  const uint32_t rank = cluster_rank();
  const int t = threadIdx.x;
  const int ul = t / KS, j = t % KS, u = rank * U + ul;

  context(feats, scores, mask, b, T, AP, n_phantom, sm_s, co_s, ctx_s);
  float gin[4];   // the unit's input gates: ctxt W_ih^T + b_ih + b_hh
  {
    float w[4][KPT];
    load_rows<AP>(w, w_ih, u, j);
    float a[4][2] = {};
    dot16<AP>(a, w, reinterpret_cast<const float4*>(ctx_s), j);
#pragma unroll
    for (int g = 0; g < 4; ++g) gin[g] = unit_sum<AP>(a[g][0] + a[g][1]) + bias[g * AP + u];
  }
  float w[4][KPT];
  load_rows<AP>(w, w_hh, u, j);
  for (int i = t; i < 2 * AP; i += P::THREADS) (&h_s[0][0])[i] = 0.f;
  if (t == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();   // h is in place
  cluster_sync();    // every block runs, with its barriers armed

  float c = 0.f;
  for (int s = 0; s < S; ++s) {
    const int cur = s & 1;
    // step s reads h_s[cur], written at step s - 1 (zeros at s = 0); full[i]
    // completes once for each step s >= 1 with s % 2 == i
    if (s > 0) mbar_wait(&full[cur], ((s >> 1) + cur + 1) & 1);
    if (t == 0 && s + 1 < S) mbar_expect_tx(&full[cur ^ 1], AP * sizeof(float));
    float acc[4][2];
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[g][0] = acc[g][1] = 0.f;
    dot16<AP>(acc, w, reinterpret_cast<const float4*>(h_s[cur]), j);
    float gate[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) gate[g] = gin[g] + unit_sum<AP>(acc[g][0] + acc[g][1]);
    c = sigmoidf(gate[1]) * c + sigmoidf(gate[0]) * tanhf(gate[2]);
    const float h = sigmoidf(gate[3]) * tanhf(c);
    if (j < ACS && s + 1 < S) st_async(&h_s[cur ^ 1][u], &full[cur ^ 1], j, h);
    if (j == 0) hs[((size_t)b * S + s) * AP + u] = h;
  }
  __syncwarp();
  cluster_sync();   // no block leaves while a peer may still write into it
}

template <int AP>
int max_frames() {
  return (SMEM_LIMIT - Tail<AP>::STATIC_BYTES) / Tail<AP>::FRAME_BYTES;
}

template <int AP>
int launch(int B, int T, cudaStream_t stream, const float* feats, const float* scores,
           const float* mask, const float* w_ih, const float* w_hh, const float* bias, float* hs,
           int S, float n_phantom) {
  if (T > max_frames<AP>()) return (int)cudaErrorInvalidValue;
  const int smem = T * Tail<AP>::FRAME_BYTES;
  cudaError_t err = cudaFuncSetAttribute(attn_tail_kernel<AP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ACS, B, 1);
  cfg.blockDim = dim3(Tail<AP>::THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ACS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attn_tail_kernel<AP>, feats, scores, mask, w_ih, w_hh, bias, hs,
                           T, S, n_phantom);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ attention above 256
// The context of each row (one block a row), then the input gates
// gin [B, 4 AP] = ctx W_ih^T + b_ih + b_hh (one warp a gate row, over all
// batch rows), then the steps: an LSTM with the constant input gin on the
// wide chain of lstm_wide.cuh (hidden units over all SMs, one grid barrier a
// step), its outputs written straight into hs [B, S, AP].

constexpr int WIDE_THREADS = 256;

__global__ void __launch_bounds__(WIDE_THREADS)
attn_tail_context_kernel(const float* __restrict__ feats, const float* __restrict__ scores,
                         const float* __restrict__ mask, float* __restrict__ ctx, int T, int AP,
                         float n_phantom) {
  extern __shared__ float sm_s[];   // [T] scores + mask, then [T] attention weights
  context(feats, scores, mask, blockIdx.x, T, AP, n_phantom, sm_s, sm_s + T,
          ctx + (size_t)blockIdx.x * AP);
}

__global__ void __launch_bounds__(WIDE_THREADS)
attn_tail_gates_kernel(const float* __restrict__ ctx, const float* __restrict__ w_ih,
                       const float* __restrict__ bias, float* __restrict__ gin, int B, int AP) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (WIDE_THREADS / 32) + (threadIdx.x >> 5);
  if (r >= 4 * AP) return;
  const float4* w = reinterpret_cast<const float4*>(w_ih + (size_t)r * AP);
  for (int b = 0; b < B; ++b) {
    const float4* x = reinterpret_cast<const float4*>(ctx + (size_t)b * AP);
    float a = 0.f;
    for (int k = lane; k < AP / 4; k += 32) {
      const float4 wv = __ldg(w + k), xv = x[k];
      a = fmaf(xv.x, wv.x, a);
      a = fmaf(xv.y, wv.y, a);
      a = fmaf(xv.z, wv.z, a);
      a = fmaf(xv.w, wv.w, a);
    }
    a = warp_sum(a);
    if (lane == 0) gin[(size_t)b * 4 * AP + r] = a + bias[r];
  }
}

LSTM_WIDE_KERNEL(attn_tail_wide_kernel, true)

}  // namespace

// The most frames the kernel holds in shared memory at hidden size ``hidden``
// (-1 for a size it does not run: not 128 or 256, and above 256 no multiple
// of 4): 28,862 at 128, 28,670 at 256, 29,056 above 256 (the context
// kernel's scores + mask and weights).
extern "C" int attn_tail_max_frames(int hidden) {
  if (hidden == 128) return max_frames<128>();
  if (hidden == 256) return max_frames<256>();
  if (hidden > 256 && hidden % 4 == 0) return SMEM_LIMIT / 8;
  return -1;
}

// feats [B, T, AP], scores and mask [B, T], w_ih and w_hh [4 AP, AP], bias
// [4 AP] (b_ih + b_hh), all f32, with AP (``hidden``) 128 or 256 -> hs
// [B, S, AP] f32. Returns the CUDA error of the launch (0 on success;
// cudaErrorInvalidValue for another AP, B over 65,535, or more frames than
// shared memory holds: 28,862 at 128, 28,670 at 256).
extern "C" int attn_tail(const void* feats, const void* scores, const void* mask,
                         const void* w_ih, const void* w_hh, const void* bias, void* hs, int B,
                         int T, int S, int hidden, float n_phantom, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || S < 1) return (int)cudaErrorInvalidValue;
  auto run = [&](auto launcher) {
    return launcher(B, T, (cudaStream_t)stream, (const float*)feats, (const float*)scores,
                    (const float*)mask, (const float*)w_ih, (const float*)w_hh,
                    (const float*)bias, (float*)hs, S, n_phantom);
  };
  if (hidden == 128) return run(launch<128>);
  if (hidden == 256) return run(launch<256>);
  return (int)cudaErrorInvalidValue;
}

// The same above attention size 256: feats [B, T, AP], scores and mask
// [B, T], w_ih and w_hh [4 AP, AP], bias [4 AP] (b_ih + b_hh), all f32, AP
// (``hidden``) a multiple of 4 -> hs [B, S, AP] f32. lens [B] int32 holds S
// in every row; scratch is f32, zeroed: ctx [B, AP], gin [B, 4 AP], zeros
// [4 AP + B AP] (b_hh and h0), c [B, AP], h_f [B, AP] and h_steps [2, rows,
// AP] (rows: lstm_wide::device_rows(AP)). Two launches, then one a slice of rows
// (*launched counts them all). Returns the CUDA error of the first launch
// that failed (0 on success; cudaErrorInvalidValue for a shape it does not
// take).
extern "C" int attn_tail_wide(const void* feats, const void* scores, const void* mask,
                              const void* w_ih, const void* w_hh, const void* bias,
                              const void* lens, void* scratch, void* hs, int B, int T, int S,
                              int hidden, float n_phantom, int* launched, void* stream) {
  *launched = 0;
  const int AP = hidden, rows = lstm_wide::device_rows(AP);
  if (B < 1 || T < 1 || S < 1 || AP <= 256 || AP % 4 != 0 || T > SMEM_LIMIT / 8 || rows < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* ctx = (float*)scratch;
  float* gin = ctx + (size_t)B * AP;
  float* zeros = gin + (size_t)B * 4 * AP;   // b_hh (folded into gin), then h0
  float* c = zeros + (size_t)4 * AP + (size_t)B * AP;
  float* h_f = c + (size_t)B * AP;
  float* h_steps = h_f + (size_t)B * AP;
  const int smem = T * 2 * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attn_tail_context_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  attn_tail_context_kernel<<<B, WIDE_THREADS, smem, st>>>(
      (const float*)feats, (const float*)scores, (const float*)mask, ctx, T, AP, n_phantom);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  const int per_block = WIDE_THREADS / 32;
  attn_tail_gates_kernel<<<(4 * AP + per_block - 1) / per_block, WIDE_THREADS, 0, st>>>(
      ctx, (const float*)w_ih, (const float*)bias, gin, B, AP);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  for (int s = 0; s < B; s += rows) {
    lstm_wide::Args a = {};
    a.xw = gin + (size_t)s * 4 * AP;
    a.xw_t = 0;   // the same input at every step
    a.xw_b = 4 * AP;
    a.w_hh = (const float*)w_hh;
    a.b_hh = zeros;
    a.lens = (const int*)lens + s;
    a.h0 = zeros + 4 * AP + (size_t)s * AP;
    a.c0 = c + (size_t)s * AP;
    a.outs = (float*)hs + (size_t)s * S * AP;
    a.out_t = AP;
    a.out_b = S * AP;
    a.h_f = h_f + (size_t)s * AP;
    a.c_f = c + (size_t)s * AP;
    a.h_steps = h_steps;
    a.T = S;
    a.B = B - s < rows ? B - s : rows;
    a.H = AP;
    if ((err = lstm_wide::launch<attn_tail_wide_kernel_kernels>(a, st)) != cudaSuccess)
      return (int)err;
    ++*launched;
  }
  return 0;
}
