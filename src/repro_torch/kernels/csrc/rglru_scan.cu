// RG-LRU diagonal linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rglru_scan` in
// src/repro/kernels/rglru_scan.py (body `_kernel`): h_t = a_t * h_{t-1}
// + b_t elementwise over the time axis, the state carried in fp32 from
// h0 (zeros when absent), the output in a's dtype.
//
// What bounds it on this card: bytes.  Each element of a and b is read
// once and each h written once, for one multiply-add: far below the
// H100's ~295 op/byte balance point.  At recurrentgemma-2b's prefill
// (B = 4, S = 2048, R = 2560, fp32 as the model passes it) that is
// 3 x 83.9 MB = 252 MB, 0.075 ms at 3.35 TB/s (chip_smoke.py also
// times a PyTorch elementwise product over the same bytes, the rate a
// plain stream reaches).  To run near that rate the card needs several
// MB of loads in flight all the time.
//
// Design: a stream per (batch, channel) with its loads software-
// pipelined in registers.  One thread owns one (b, channel) and carries
// the state in a register along the whole time axis (the time axis is
// the serial one; neighbouring threads own neighbouring channels, so
// every step's loads and stores are coalesced).  It keeps two buffers
// of D = 32 steps of a and b: while it runs the multiply-adds and stores
// of one, the 64 loads of the next are in flight, so the pipe never
// drains (the first version loaded 16 steps, then waited for them, then
// computed).  10,240 threads x 64 loads x 4 B keep ~2.6 MB in flight at
// the path shape.  The register budget (4 D values of a and b) caps D:
// at D = 64 the buffers spill.
//
// Why not a ring of shared memory (PERF.md, Findings): this kernel's first
// revision gave a block (b, 32 channels) and streamed a and b through
// an 8-stage cp.async ring under mbarriers, one producer warp feeding
// one consumer warp; it ran slower than this design, and so did every
// variant tried on the card (wider channel groups, deeper rings, 2-8
// producer warps, bulk copies): a block's copies in flight, not the
// card's bandwidth, set its pace.  A chunked scan with
// decoupled look-back (every block loading a (T x C) tile at once) would
// put more bytes in flight, at the cost of scratch state that outlives
// the call and a serial look-back chain between chunks; it is left for
// later work.
//
// Ragged S and R take the same path: loads and stores past either end
// are predicated off.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREAD = 64;  // channels a block
constexpr int D = 32;        // time steps a register buffer holds

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename E> __device__ __forceinline__ E from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// steps [t0, t0 + D) of a and b (zeros past S) into registers
template <typename E>
__device__ __forceinline__ void load(float (&av)[D], float (&bv)[D],
                                     const E* ap, const E* bp, int t0, int S,
                                     int R) {
#pragma unroll
  for (int u = 0; u < D; ++u) {
    const bool in = t0 + u < S;
    av[u] = in ? to_f(ap[int64_t(t0 + u) * R]) : 0.f;
    bv[u] = in ? to_f(bp[int64_t(t0 + u) * R]) : 0.f;
  }
}

// the recurrence over steps [t0, t0 + D) from registers, storing h
template <typename E>
__device__ __forceinline__ void scan(float& state, const float (&av)[D],
                                     const float (&bv)[D], E* hp, int t0,
                                     int S, int R) {
#pragma unroll
  for (int u = 0; u < D; ++u) {
    if (t0 + u < S) {
      state = fmaf(av[u], state, bv[u]);
      hp[int64_t(t0 + u) * R] = from_f<E>(state);
    }
  }
}

// grid (ceil(R / NTHREAD), B): thread (r, b) scans a[b, :, r], b[b, :, r]
// of contiguous (B, S, R) arrays into h[b, :, r].  h0: (B, R) fp32 or
// null.
template <typename E>
__global__ void __launch_bounds__(NTHREAD)
rglru_fwd(const E* __restrict__ a, const E* __restrict__ b,
          const float* __restrict__ h0, E* __restrict__ h, int S, int R) {
  const int r = blockIdx.x * NTHREAD + threadIdx.x;
  const int bi = blockIdx.y;
  if (r >= R) return;
  const int64_t base = int64_t(bi) * S * R + r;
  const E* ap = a + base;
  const E* bp = b + base;
  E* hp = h + base;
  float state = h0 ? h0[int64_t(bi) * R + r] : 0.f;

  float a0[D], b0[D], a1[D], b1[D];  // two buffers, named so that their
  load(a0, b0, ap, bp, 0, S, R);     // indices stay compile-time
  for (int t0 = 0; t0 < S; t0 += 2 * D) {
    load(a1, b1, ap, bp, t0 + D, S, R);
    scan(state, a0, b0, hp, t0, S, R);
    load(a0, b0, ap, bp, t0 + 2 * D, S, R);
    scan(state, a1, b1, hp, t0 + D, S, R);
  }
}

template <typename E>
cudaError_t launch(const void* a, const void* b, const float* h0, void* h,
                   int B, int S, int R, cudaStream_t stream) {
  dim3 grid((R + NTHREAD - 1) / NTHREAD, B);
  rglru_fwd<E><<<grid, NTHREAD, 0, stream>>>(
      static_cast<const E*>(a), static_cast<const E*>(b), h0,
      static_cast<E*>(h), S, R);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a, b, h: contiguous (B, S, R) of one dtype (0 = float32, 1 =
// bfloat16); h0: contiguous (B, R) float32, or null for zeros.  Returns
// the launch's cudaError_t (0 = success).
int rglru_scan_fwd(const void* a, const void* b, const void* h0, void* h,
                   int dtype, int B, int S, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  if (dtype == 0) return launch<float>(a, b, h0f, h, B, S, R, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h0f, h, B, S, R, st);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
