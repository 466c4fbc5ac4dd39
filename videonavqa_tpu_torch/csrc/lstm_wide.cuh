// The masked LSTM chain spread over the whole card, at any hidden size: the
// wide kernel of lstm.cu, shared with film_reencode.cu (its re-encode above
// hidden size 128) and attn_tail.cu (its LSTMCell steps above attention size
// 256).
//
// Per step t, for every batch row b and hidden unit u:
//   gates = xw[t, b] + h W_hh^T + b_hh, gate order (i, f, g, o);
//   c' = sigmoid(f) c + sigmoid(i) tanh(g);  h' = sigmoid(o) tanh(c');
//   where t < len[b]: (h, c) = (h', c') and outs[t, b] = h'; elsewhere the
//   carry stays and outs[t, b] = 0.
// xw [T, ldb, 4H] and outs [T, ldb, H] are read and written from a slice's
// first row (ldb: the rows of the whole batch), or, in the STRIDED form,
// through strides, so a caller can give a constant input (a step stride of
// 0) or a batch-major output. The plain form keeps the index arithmetic in
// 32-bit terms of ldb: 64-bit strides cost the 32-row kernel registers
// (more spills, and +2-3% at hidden 1,536 on an H100).
//
// W_hh does not fit in one SM, so the hidden units are spread over the SMs:
// a cooperative launch of ceil(H / U) blocks, U hidden units each
// (U = ceil(H / SMs)), and every block serves all batch rows, so one read of
// a weight serves them all. Each step a block copies h [B, H] from device
// memory (L2) into shared memory; a warp takes one unit (its four gate rows)
// at a time, each lane walking the columns k = 4 lane .. 4 lane + 3, then
// + 128, ... against all batch rows in 16-byte loads; a butterfly
// reduce-scatter over the lanes leaves batch row b's four gate sums in lane
// b; and the new h goes to the other half of a double buffer in device
// memory. One grid barrier per step; the loop runs to max(len), not T.
//   - up to MAX_U units a block (hidden sizes up to MAX_U x SMs, 1,584 on 132
//     SMs), one unit a warp, whose lane b keeps c[b, u] in a register;
//   - above that (MULTI), a warp takes the units warp, warp + MAX_U, ... of
//     its block in turn, and c lives in shared memory beside h.
// A launch takes B <= 32 batch rows (one a lane), padded to NB, a power of
// two, in shared memory: h [NB, H] must fit the 227 KB a block can use
// (``rows``: 32 rows up to hidden 1,816, 16 up to 3,632, 8 up to 7,264, ...,
// 1 up to ~58,000; the hardware's limit for a row of h in one SM). H must
// be a multiple of 4 (16-byte loads): callers zero-pad the hidden units,
// which is exact (a padded unit's weights, biases and inputs are zero, so
// its c and h stay 0).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lstm_wide {

namespace cg = cooperative_groups;

constexpr int MAX_U = 12;           // warps a block, and units a block with one unit a warp
constexpr int THREADS = 32 * MAX_U;
constexpr int SMEM_LIMIT = 232448;  // shared memory a block can use on sm_90

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

struct Args {
  const float* xw;        // gate g of unit u, row b, step t: xw[(t ldb + b) 4H + g H + u],
  long long xw_t;         // STRIDED: xw[t xw_t + b xw_b + g H + u]
  int xw_b;
  const float* w_hh;      // [4H, H]
  const float* b_hh;      // [4H]
  const int* lens;        // [B]
  const float* h0;        // [B, H]
  const float* c0;        // [B, H]
  float* outs;            // outs[(t ldb + b) H + u] (STRIDED: [t out_t + b out_b + u]),
  long long out_t;        // or null: not stored
  int out_b;
  float* h_f;             // [B, H]
  float* c_f;             // [B, H] (may be c0: each element is read, then written, by one lane)
  float* h_steps;         // [2, B, H]: h between steps
  int T, B, H, U;
  int ldb;                // rows of the whole batch (the plain form's row stride)
};

// Offsets of step t, row b in xw (gate 0, unit 0) and in outs (unit 0).
template <bool STRIDED>
__device__ __forceinline__ size_t xw_at(const Args& a, int t, int b) {
  if constexpr (STRIDED) return t * a.xw_t + (size_t)b * a.xw_b;
  else return ((size_t)t * a.ldb + b) * 4 * a.H;
}

template <bool STRIDED>
__device__ __forceinline__ size_t out_at(const Args& a, int t, int b) {
  if constexpr (STRIDED) return t * a.out_t + (size_t)b * a.out_b;
  else return ((size_t)t * a.ldb + b) * a.H;
}

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

// The warp's recurrent sums for one unit: in lane L, sum_k h[L % NB, k]
// W_hh[g H + u, k] for each gate g, w_row[g] pointing at row g H + u.
template <int NB>
__device__ __forceinline__ void unit_sums(const float* const (&w_row)[4], const float* h_s,
                                          int H, int lane, float (&sums)[4]) {
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
#pragma unroll
  for (int g = 0; g < 4; ++g) sums[g] = lane_sums<NB>(acc[g], lane);
}

// h of the previous step into shared memory (written by other blocks: read
// through L2, never from this SM's L1)
__device__ __forceinline__ void load_h(float* h_s, const float* h_prev, int n_real) {
  const float4* src = reinterpret_cast<const float4*>(h_prev);
  float4* dst = reinterpret_cast<float4*>(h_s);
#pragma unroll 4
  for (int i = threadIdx.x; i < n_real / 4; i += blockDim.x) dst[i] = __ldcg(src + i);
}

// The body of a wide kernel: NB batch rows in shared memory (a power of two
// >= B; the rows from B on are zeros and are never stored); MULTI: more
// units a block than warps; STRIDED: xw and outs through strides.
template <int NB, bool MULTI, bool STRIDED>
__device__ __forceinline__ void run(const Args& a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float h_s[];  // [NB][H], then (MULTI) c [U][NB]
  const int T = a.T, B = a.B, H = a.H, U = a.U;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = lane & (NB - 1);   // this lane's batch row
  const bool row = lane < NB && b < B;

  // the longest sequence: every block runs that many steps
  int t_max = 0;
  for (int i = 0; i < B; ++i) t_max = max(t_max, min(max(a.lens[i], 0), T));
  const int len = row ? min(max(a.lens[b], 0), T) : 0;
  const int n_real = B * H;
  for (int i = n_real + threadIdx.x; i < NB * H; i += blockDim.x) h_s[i] = 0.f;

  if constexpr (!MULTI) {
    const int u = blockIdx.x * U + warp;   // this warp's hidden unit
    // the same for a whole warp; warps from U on only help to copy h
    const bool has_unit = warp < U && u < H;
    const bool owner = has_unit && row;
    float c = 0.f, h = 0.f, bias[4] = {0.f, 0.f, 0.f, 0.f};
    const float* w_row[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) w_row[g] = a.w_hh + (size_t)(g * H + (has_unit ? u : 0)) * H;
    if (owner) {
      c = a.c0[(size_t)b * H + u];
      h = a.h0[(size_t)b * H + u];
#pragma unroll
      for (int g = 0; g < 4; ++g) bias[g] = a.b_hh[g * H + u];
    }
    for (int t = 0; t < t_max; ++t) {
      load_h(h_s, t == 0 ? a.h0 : a.h_steps + (size_t)(t & 1) * n_real, n_real);
      float xv[4] = {0.f, 0.f, 0.f, 0.f};
      if (owner) {
#pragma unroll
        for (int g = 0; g < 4; ++g) xv[g] = a.xw[xw_at<STRIDED>(a, t, b) + g * H + u];
      }
      __syncthreads();
      if (has_unit) {
        float sums[4];
        unit_sums<NB>(w_row, h_s, H, lane, sums);
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) gate[g] = (xv[g] + sums[g]) + bias[g];
        if (owner) {
          const float c_new = sigmoidf(gate[1]) * c + sigmoidf(gate[0]) * tanhf(gate[2]);
          const float h_new = sigmoidf(gate[3]) * tanhf(c_new);
          const bool valid = t < len;
          if (valid) {
            c = c_new;
            h = h_new;
          }
          if (a.outs != nullptr) a.outs[out_at<STRIDED>(a, t, b) + u] = valid ? h_new : 0.f;
          a.h_steps[(size_t)((t + 1) & 1) * n_real + (size_t)b * H + u] = h;
        }
      }
      grid.sync();  // every block has read this step's h and written the next
    }
    if (owner) {
      if (a.outs != nullptr)
        for (int t = t_max; t < T; ++t) a.outs[out_at<STRIDED>(a, t, b) + u] = 0.f;
      a.h_f[(size_t)b * H + u] = h;
      a.c_f[(size_t)b * H + u] = c;
    }
  } else {
    float* c_s = h_s + NB * H;   // [U][NB]
    for (int lu = warp; lu < U; lu += MAX_U) {
      const int u = blockIdx.x * U + lu;
      if (u < H && row) c_s[lu * NB + b] = a.c0[(size_t)b * H + u];
    }
    for (int t = 0; t < t_max; ++t) {
      const float* h_prev = t == 0 ? a.h0 : a.h_steps + (size_t)(t & 1) * n_real;
      load_h(h_s, h_prev, n_real);
      __syncthreads();
      for (int lu = warp; lu < U; lu += MAX_U) {
        const int u = blockIdx.x * U + lu;
        if (u >= H) break;   // the same for the whole warp
        const float* w_row[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) w_row[g] = a.w_hh + (size_t)(g * H + u) * H;
        float sums[4];
        unit_sums<NB>(w_row, h_s, H, lane, sums);
        if (row) {
          float gate[4];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            gate[g] = (a.xw[xw_at<STRIDED>(a, t, b) + g * H + u] + sums[g]) + a.b_hh[g * H + u];
          const float c = c_s[lu * NB + b];
          const float c_new = sigmoidf(gate[1]) * c + sigmoidf(gate[0]) * tanhf(gate[2]);
          const float h_new = sigmoidf(gate[3]) * tanhf(c_new);
          const bool valid = t < len;
          if (valid) c_s[lu * NB + b] = c_new;
          if (a.outs != nullptr) a.outs[out_at<STRIDED>(a, t, b) + u] = valid ? h_new : 0.f;
          a.h_steps[(size_t)((t + 1) & 1) * n_real + (size_t)b * H + u] =
              valid ? h_new : h_s[b * H + u];
        }
      }
      grid.sync();  // every block has read this step's h and written the next
    }
    // the carry: h as the last step left it (or h0), c from shared memory
    const float* h_last = t_max == 0 ? a.h0 : a.h_steps + (size_t)(t_max & 1) * n_real;
    for (int lu = warp; lu < U; lu += MAX_U) {
      const int u = blockIdx.x * U + lu;
      if (u >= H || !row) continue;
      if (a.outs != nullptr)
        for (int t = t_max; t < T; ++t) a.outs[out_at<STRIDED>(a, t, b) + u] = 0.f;
      a.h_f[(size_t)b * H + u] = __ldcg(h_last + (size_t)b * H + u);
      a.c_f[(size_t)b * H + u] = c_s[lu * NB + b];
    }
  }
}

// Units a block at hidden size H on a card of ``sms`` SMs.
inline int units(int H, int sms) { return (H + sms - 1) / sms; }

// Shared memory of a launch of NB rows at hidden size H.
inline size_t smem_bytes(int NB, int H, int sms) {
  const int U = units(H, sms);
  return ((size_t)NB * H + (U > MAX_U ? (size_t)U * NB : 0)) * sizeof(float);
}

// The most batch rows a launch takes at hidden size H: a power of two of at
// most 32 whose h (and c) fit shared memory; 0 where not even one row does.
inline int rows(int H, int sms) {
  for (int nb = 32; nb >= 1; nb >>= 1)
    if (smem_bytes(nb, H, sms) <= (size_t)SMEM_LIMIT) return nb;
  return 0;
}

template <class Kernels, int NB>
cudaError_t launch_nb(Args& a, int sms, cudaStream_t stream) {
  const bool multi = a.U > MAX_U;
  const void* kernel = multi ? Kernels::template get<NB, true>() : Kernels::template get<NB, false>();
  const size_t smem = smem_bytes(NB, a.H, sms);
  if (smem > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&a};
  // refused, not hung, if the blocks cannot all be resident at once
  return cudaLaunchCooperativeKernel(kernel, dim3((a.H + a.U - 1) / a.U), dim3(THREADS), args,
                                     smem, stream);
}

// Launches one pass of the wide chain over a.B <= 32 rows. ``Kernels::get<NB,
// MULTI>()`` names the caller's __global__ kernel that calls run<NB, MULTI>.
// Sets a.U. Returns the CUDA error (cudaErrorInvalidValue for a shape the
// chain does not take: B over 32, a hidden size that is no multiple of 4,
// rows that do not fit shared memory, buffers off a 16-byte boundary).
template <class Kernels>
cudaError_t launch(Args& a, cudaStream_t stream) {
  if (a.T < 1 || a.B < 1 || a.B > 32 || a.H < 4 || a.H % 4 != 0 ||
      ((uintptr_t)a.h0 | (uintptr_t)a.h_steps | (uintptr_t)a.w_hh) % 16 != 0)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  a.U = units(a.H, sms);
  if (a.B <= 1) err = launch_nb<Kernels, 1>(a, sms, stream);
  else if (a.B <= 2) err = launch_nb<Kernels, 2>(a, sms, stream);
  else if (a.B <= 4) err = launch_nb<Kernels, 4>(a, sms, stream);
  else if (a.B <= 8) err = launch_nb<Kernels, 8>(a, sms, stream);
  else if (a.B <= 16) err = launch_nb<Kernels, 16>(a, sms, stream);
  else err = launch_nb<Kernels, 32>(a, sms, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The most rows a launch takes at hidden size H on the current device.
inline int device_rows(int H) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return rows(H, sms);
}

}  // namespace lstm_wide

// Defines the __global__ template NAME<NB, MULTI> running lstm_wide::run in
// the plain or the STRIDED form, and NAME_kernels, the ``Kernels`` that
// lstm_wide::launch takes. Each source that runs the chain gives it a name
// of its own, so that a profile tells its launches apart.
#define LSTM_WIDE_KERNEL(NAME, STRIDED)                                          \
  template <int NB, bool MULTI>                                                  \
  __global__ void __launch_bounds__(lstm_wide::THREADS, 1)                       \
  NAME(const lstm_wide::Args a) {                                                \
    lstm_wide::run<NB, MULTI, STRIDED>(a);                                       \
  }                                                                              \
  struct NAME##_kernels {                                                        \
    template <int NB, bool MULTI>                                                \
    static const void* get() { return (const void*)NAME<NB, MULTI>; }            \
  };
