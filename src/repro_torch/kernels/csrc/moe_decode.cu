// The MoE layer at decode, expert-sparse, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves the MoE layer to XLA
// (`src/repro/models/layers.py` `moe_apply`, a one-hot dispatch into an
// (E, G*C, D) buffer and two batched products over every expert).  The
// port's batched path does the same with torch.matmul, and at decode,
// where a call has a handful of rows, that product reads every expert's
// weights to multiply mostly rows of zeros.  These kernels compute the
// same function, `moe_apply` after `moe_route`, reading the weights of
// the experts that hold a kept slot and no others.
//
// What bounds it on this card: bytes.  A decode call has R = G * cap
// rows per expert (1 at olmoe-1b-7b's batch of 4): one weight element
// feeds R multiply-adds, far below the H100's ~295 op/byte balance
// point.  At olmoe's batch of 4 the tokens reach ~26 of 64 experts, so
// the least time a layer can take is ~26 x 12.6 MB at 3.35 TB/s, 0.1 ms.
// What the design does about that:
//
// * A block first reads the routing (top_e, pos; N * k entries) and
//   finds its expert's kept rows.  A block of an expert with none
//   returns before it loads a byte of weight, so an idle expert costs
//   one pass over a few hundred bytes of routing.
// * The grid is experts x column tiles, with tiles narrow enough
//   (`tiles` in the wrapper) that the experts a call can reach give each
//   SM two or more blocks; every thread keeps UNROLL 16-byte weight
//   loads in flight, so a block keeps 16 KB in flight.
// * The dispatch is folded in: the up kernel loads its rows of x by
//   index (no scatter buffer), the down kernel reads h where the up
//   kernel wrote it, and the combine reads each token's kept slots of
//   the fp32 expert outputs by index.
//
// Three launches a call: up (h = gelu(x wi_g) * (x wi_u) per kept row),
// down (hout = h wo, fp32) and combine (y = sum over the token's kept
// slots, k = 0..top_k-1 in order, of top_p * hout, fp32, then cast).
// Each block reduces its columns in a fixed order and the combine uses
// no atomics, so two calls give the same bits.  Rounding follows the
// batched path: gu rounded to the working dtype, the GELU taken in fp32
// and rounded, times u in the working dtype; hout and the combine fp32.
// A dropped slot is skipped, never multiplied by 0: the hout row it
// would name belongs to no kept row and is never written.
//
// The up kernel adds 1 to a device counter for each expert it does not
// skip (one atomic, from the expert's first column tile): the experts a
// call read, summed over calls.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads a block
constexpr int UNROLL = 4;    // 16-byte weight loads in flight a thread
constexpr int MAX_ROWS = 8;  // rows per expert the kernels hold (R <= 8)

template <typename T> struct Vec;  // elements of T in 16 bytes
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

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
// x rounded to T and back (the batched path's T-typed intermediates)
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

// the 16 bytes at w as floats
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // element 2i in the low half
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// PyTorch's tanh-approximated GELU, in fp32
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.f + tanhf(inner));
}

// The kept rows of expert e: tok[r] is the token in row r (r < R) or -1.
// Row r of group g's slot p is g * cap + p, the batched path's order.
// Returns, to every thread, whether the expert has any.
__device__ __forceinline__ bool expert_rows(int* tok, const int64_t* top_e,
                                            const int* pos, int n_slots,
                                            int k, int gs, int cap, int R,
                                            int e) {
  for (int r = threadIdx.x; r < R; r += NT) tok[r] = -1;
  __syncthreads();
  bool found = false;
  for (int i = threadIdx.x; i < n_slots; i += NT) {
    const int p = pos[i];
    if (top_e[i] == e && p < cap) {
      const int t = i / k;
      tok[(t / gs) * cap + p] = t;
      found = true;
    }
  }
  return __syncthreads_or(found);
}

// acc[r][v] += sum over rows d of in[d * RT + r] * w[d * ld + v], for the
// rows d = lane, lane + lanes, ... < K of this thread's lane; w points at
// the thread's VEC columns of row 0
template <typename T, int RT>
__device__ __forceinline__ void gemv(float (&acc)[RT][Vec<T>::n],
                                     const T* w, int64_t ld, const float* in,
                                     int K, int lane, int lanes) {
  constexpr int VEC = Vec<T>::n;
  for (int d0 = lane; d0 < K; d0 += lanes * UNROLL) {
    uint4 wv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int d = d0 + u * lanes;
      wv[u] = d < K ? __ldg(reinterpret_cast<const uint4*>(w + d * ld))
                    : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int d = d0 + u * lanes;
      if (d >= K) break;
      float f[VEC];
      unpack(wv[u], f);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float xr = in[d * RT + r];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(xr, f[v], acc[r][v]);
      }
    }
  }
}

// Shared memory of both product kernels, in floats: the row table, the
// RT input rows (K of them) as fp32, and one VEC-wide partial per thread.
template <typename T, int RT>
constexpr size_t smem_floats(int K) {
  return MAX_ROWS + size_t(K) * RT + size_t(NT) * Vec<T>::n;
}

// Grid (F / tn, E): block (j, e) computes columns [j tn, (j + 1) tn) of
// h for expert e's kept rows.  Thread c of a row lane holds VEC columns
// of g (c < tn / VEC) or of u; lanes split the D rows of wi[e].
template <typename T, int RT>
__global__ void __launch_bounds__(NT)
    moe_decode_up(const T* __restrict__ x, const int64_t* __restrict__ top_e,
                  const int* __restrict__ pos, const T* __restrict__ wi,
                  T* __restrict__ h, unsigned long long* counter,
                  int n_slots, int k, int gs, int cap, int R, int D, int F,
                  int tn) {
  constexpr int VEC = Vec<T>::n;
  extern __shared__ float smem[];
  int* tok = reinterpret_cast<int*>(smem);
  float* xs = smem + MAX_ROWS;          // (D, RT)
  float* red = xs + size_t(D) * RT;     // (lanes, 2 tn)
  const int e = blockIdx.y;
  if (!expert_rows(tok, top_e, pos, n_slots, k, gs, cap, R, e)) return;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(counter, 1ull);
  for (int i = threadIdx.x; i < D * RT; i += NT) {
    const int r = i % RT;
    const int t = r < R ? tok[r] : -1;
    xs[i] = t >= 0 ? to_f(x[int64_t(t) * D + i / RT]) : 0.f;
  }
  __syncthreads();

  const int half = tn / VEC, ch = 2 * half, lanes = NT / ch;
  const int c = threadIdx.x % ch, lane = threadIdx.x / ch;
  const int n0 = blockIdx.x * tn;
  const int n = n0 + (c % half) * VEC;  // the column within g or u
  float acc[RT][VEC];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
  if (n < F)
    gemv<T, RT>(acc, wi + int64_t(e) * D * 2 * F + (c < half ? 0 : F) + n,
                2 * F, xs, D, lane, lanes);

#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (r >= R || tok[r] < 0) continue;  // the same in every thread
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[lane * 2 * tn + c * VEC + v] = acc[r][v];
    __syncthreads();
    const int j = threadIdx.x;
    if (j < tn && n0 + j < F) {
      float g = 0.f, u = 0.f;
      for (int l = 0; l < lanes; ++l) {
        g += red[l * 2 * tn + j];
        u += red[l * 2 * tn + tn + j];
      }
      const float a = rnd<T>(gelu_tanh(rnd<T>(g)));
      h[(int64_t(e) * R + r) * F + n0 + j] = from_f<T>(a * rnd<T>(u));
    }
    __syncthreads();
  }
}

// Grid (D / tn, E): block (j, e) computes columns [j tn, (j + 1) tn) of
// hout = h wo[e] in fp32 for expert e's kept rows.
template <typename T, int RT>
__global__ void __launch_bounds__(NT)
    moe_decode_down(const int64_t* __restrict__ top_e,
                    const int* __restrict__ pos, const T* __restrict__ h,
                    const T* __restrict__ wo, float* __restrict__ hout,
                    int n_slots, int k, int gs, int cap, int R, int D, int F,
                    int tn) {
  constexpr int VEC = Vec<T>::n;
  extern __shared__ float smem[];
  int* tok = reinterpret_cast<int*>(smem);
  float* hs = smem + MAX_ROWS;          // (F, RT)
  float* red = hs + size_t(F) * RT;     // (lanes, tn)
  const int e = blockIdx.y;
  if (!expert_rows(tok, top_e, pos, n_slots, k, gs, cap, R, e)) return;
  for (int i = threadIdx.x; i < F * RT; i += NT) {
    const int r = i % RT;  // a row the up kernel did not write is 0 here
    const bool kept = r < R && tok[r] >= 0;
    hs[i] = kept ? to_f(h[(int64_t(e) * R + r) * F + i / RT]) : 0.f;
  }
  __syncthreads();

  const int ch = tn / VEC, lanes = NT / ch;
  const int c = threadIdx.x % ch, lane = threadIdx.x / ch;
  const int n0 = blockIdx.x * tn, n = n0 + c * VEC;
  float acc[RT][VEC];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
  if (n < D)
    gemv<T, RT>(acc, wo + int64_t(e) * F * D + n, D, hs, F, lane, lanes);

#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (r >= R || tok[r] < 0) continue;
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[lane * tn + c * VEC + v] = acc[r][v];
    __syncthreads();
    const int j = threadIdx.x;
    if (j < tn && n0 + j < D) {
      float s = 0.f;
      for (int l = 0; l < lanes; ++l) s += red[l * tn + j];
      hout[(int64_t(e) * R + r) * D + n0 + j] = s;
    }
    __syncthreads();
  }
}

// Grid (D / (4 NT), N): y[t] = sum over the kept slots j of token t, in
// the order j = 0..k-1, of top_p[t, j] * hout[its row], in fp32.
template <typename T>
__global__ void __launch_bounds__(NT)
    moe_decode_combine(const int64_t* __restrict__ top_e,
                       const int* __restrict__ pos,
                       const float* __restrict__ top_p,
                       const float* __restrict__ hout, T* __restrict__ y,
                       int k, int gs, int cap, int R, int D) {
  const int t = blockIdx.y;
  const int d = (blockIdx.x * NT + threadIdx.x) * 4;
  if (d >= D) return;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < k; ++j) {
    const int i = t * k + j;
    const int p = pos[i];
    if (p >= cap) continue;  // dropped: skipped, its row is not written
    const float w = top_p[i];
    const float4 v = *reinterpret_cast<const float4*>(
        hout + (top_e[i] * R + (t / gs) * cap + p) * D + d);
    s[0] = __fadd_rn(s[0], __fmul_rn(w, v.x));
    s[1] = __fadd_rn(s[1], __fmul_rn(w, v.y));
    s[2] = __fadd_rn(s[2], __fmul_rn(w, v.z));
    s[3] = __fadd_rn(s[3], __fmul_rn(w, v.w));
  }
#pragma unroll
  for (int v = 0; v < 4; ++v) y[int64_t(t) * D + d + v] = from_f<T>(s[v]);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <typename T, int RT>
cudaError_t launch(const void* x, const int64_t* top_e, const int* pos,
                   const float* top_p, const void* wi, const void* wo,
                   void* h, float* hout, void* y,
                   unsigned long long* counter, int N, int E, int k, int gs,
                   int cap, int R, int D, int F, int tn_up, int tn_down,
                   cudaStream_t st) {
  const size_t up_smem = smem_floats<T, RT>(D) * sizeof(float);
  const size_t down_smem = smem_floats<T, RT>(F) * sizeof(float);
  cudaError_t err = allow_smem(moe_decode_up<T, RT>, up_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(moe_decode_down<T, RT>, down_smem);
  if (err != cudaSuccess) return err;
  const int n_slots = N * k;
  moe_decode_up<T, RT><<<dim3((F + tn_up - 1) / tn_up, E), NT, up_smem,
                         st>>>(
      static_cast<const T*>(x), top_e, pos, static_cast<const T*>(wi),
      static_cast<T*>(h), counter, n_slots, k, gs, cap, R, D, F, tn_up);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_decode_down<T, RT><<<dim3((D + tn_down - 1) / tn_down, E), NT,
                           down_smem, st>>>(
      top_e, pos, static_cast<const T*>(h), static_cast<const T*>(wo), hout,
      n_slots, k, gs, cap, R, D, F, tn_down);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_decode_combine<T><<<dim3((D + 4 * NT - 1) / (4 * NT), N), NT, 0,
                          st>>>(top_e, pos, top_p, hout, static_cast<T*>(y),
                                k, gs, cap, R, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(int rt, const void* x, const int64_t* top_e,
                        const int* pos, const float* top_p, const void* wi,
                        const void* wo, void* h, float* hout, void* y,
                        unsigned long long* counter, int N, int E, int k,
                        int gs, int cap, int R, int D, int F, int tn_up,
                        int tn_down, cudaStream_t st) {
#define MOE_LAUNCH(RT_)                                                     \
  return launch<T, RT_>(x, top_e, pos, top_p, wi, wo, h, hout, y, counter, \
                        N, E, k, gs, cap, R, D, F, tn_up, tn_down, st)
  switch (rt) {
    case 1: MOE_LAUNCH(1);
    case 2: MOE_LAUNCH(2);
    case 4: MOE_LAUNCH(4);
    case 8: MOE_LAUNCH(8);
    default: return cudaErrorInvalidValue;
  }
#undef MOE_LAUNCH
}

}  // namespace

extern "C" {

// x: contiguous (N, D) of one dtype (0 = float32, 1 = bfloat16), as are
// wi (E, D, 2F), wo (E, F, D), the scratch h (E, R, F) and y (N, D);
// top_e (N k) int64, pos (N k) int32, top_p (N k) float32: the routing
// of N tokens in groups of gs with queue length cap; R = (N / gs) cap;
// hout: (E, R, D) float32 scratch; counter: one uint64.  rt: the
// instance's rows (1, 2, 4 or 8, at least R); tn_up, tn_down: column
// tiles (powers of two, 16-byte multiples).  Returns the launches'
// cudaError_t (0 = success).
int moe_decode_fwd(const void* x, const void* top_e, const void* pos,
                   const void* top_p, const void* wi, const void* wo,
                   void* h, void* hout, void* y, void* counter, int dtype,
                   int rt, int N, int E, int k, int gs, int cap, int R,
                   int D, int F, int tn_up, int tn_down, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* te = static_cast<const int64_t*>(top_e);
  const int* ps = static_cast<const int*>(pos);
  const float* tp = static_cast<const float*>(top_p);
  float* ho = static_cast<float*>(hout);
  unsigned long long* cnt = static_cast<unsigned long long*>(counter);
  if (dtype == 0)
    return launch_rows<float>(rt, x, te, ps, tp, wi, wo, h, ho, y, cnt, N,
                              E, k, gs, cap, R, D, F, tn_up, tn_down, st);
  if (dtype == 1)
    return launch_rows<__nv_bfloat16>(rt, x, te, ps, tp, wi, wo, h, ho, y,
                                      cnt, N, E, k, gs, cap, R, D, F, tn_up,
                                      tn_down, st);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
