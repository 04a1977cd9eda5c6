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
// 3 x 83.9 MB = 252 MB, 0.075 ms at 3.35 TB/s.
//
// Design (first version).  The TPU grid (b, channel block, time block)
// runs its time axis in order and carries the state in VMEM; here one
// thread owns one (b, channel) and walks the whole time axis itself,
// with the state in a register.  Neighbouring threads own neighbouring
// channels, so every time step's loads and stores are coalesced.  Time
// steps are loaded UNROLL at a time into registers before the dependent
// multiply-adds, so each thread keeps 2 * UNROLL loads in flight.
//
// What it lacks: B * R = 10,240 threads make 160 blocks of 64 for 132
// SMs, one or two blocks each, so far fewer bytes are in flight than
// the card's memory needs to run at its rate.  A chunked two-pass scan
// over time (each block scans a time chunk from zero, a second pass
// carries the chunk-end states across chunks) would put S / chunk times
// more threads to work; that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREAD = 64;  // channels per block
constexpr int UNROLL = 16;   // time steps loaded ahead of the FMAs

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// grid (ceil(R / NTHREAD), B): thread (r, b) scans a[b, :, r], b[b, :, r]
// of contiguous (B, S, R) arrays into h[b, :, r].  h0: (B, R) fp32 or
// null.
template <typename T>
__global__ void __launch_bounds__(NTHREAD)
rglru_fwd(const T* __restrict__ a, const T* __restrict__ b,
          const float* __restrict__ h0, T* __restrict__ h, int S, int R) {
  const int r = blockIdx.x * NTHREAD + threadIdx.x;
  const int bi = blockIdx.y;
  if (r >= R) return;
  const int64_t base = int64_t(bi) * S * R + r;
  const T* ap = a + base;
  const T* bp = b + base;
  T* hp = h + base;
  float state = h0 ? h0[int64_t(bi) * R + r] : 0.f;

  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      av[u] = to_f(ap[int64_t(t + u) * R]);
      bv[u] = to_f(bp[int64_t(t + u) * R]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      state = fmaf(av[u], state, bv[u]);
      hp[int64_t(t + u) * R] = from_f<T>(state);
    }
  }
  for (; t < S; ++t) {  // ragged tail of the time axis
    state = fmaf(to_f(ap[int64_t(t) * R]), state, to_f(bp[int64_t(t) * R]));
    hp[int64_t(t) * R] = from_f<T>(state);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const float* h0, void* h,
                   int B, int S, int R, cudaStream_t stream) {
  dim3 grid((R + NTHREAD - 1) / NTHREAD, B);
  rglru_fwd<T><<<grid, NTHREAD, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0,
      static_cast<T*>(h), S, R);
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
