// Causal / windowed / softcapped GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (body `_kernel`): softmax(q k^T *
// hd^-0.5) v with an fp32 online softmax, softcap before the mask,
// additive -1e30 masks, positions = indices from 0.
//
// What bounds it on this card: at prefill shapes (S = 512, hd = 128;
// S = 2048, hd = 256) the two products do ~hd/2 operations per byte of
// q, k, v and o or more, far above the H100's ~295 op/byte balance
// point, so the bound is arithmetic.
// This first version computes in fp32 on the CUDA cores (67 TFLOP/s
// peak), not on the tensor cores (989 TFLOP/s bf16): wgmma, TMA and warp
// specialisation are later work.  What the design does about it: every
// q row stays in shared memory for the whole kv loop, each k/v tile is
// loaded once per 64 query rows, and the inner products read shared
// memory as float4 so each lane does four FMAs per load.
//
// Design.  The TPU grid (b, h, q_block, kv_block) runs its kv axis in
// order and carries acc/m/l in VMEM; here one block owns (b, h, BQ query
// rows) and loops over kv tiles of 32 keys itself, stopping at the
// causal bound and starting at the window bound (the Pallas skip test).
// Warp w owns query rows [RPW w, RPW w + RPW); lane j owns key j of the
// tile for the scores and, for the p.v product, output dims [4j, 4j + 4)
// of every 128-dim chunk of the head.  The running max is warp-uniform
// (one shuffle reduction per row and tile); the denominator is summed
// per lane and reduced once at the end.
//
// Rows per warp and warps per block follow the head dim so that each
// lane keeps 64 fp32 accumulators and each k/v tile still serves 64
// query rows: hd <= 128 takes 4 warps of 16 rows (4 dims a lane); hd =
// 256 takes 8 warps of 8 rows (8 dims a lane, two float4 columns 128
// dims apart so the warp's shared-memory reads stay conflict-free) and
// ~140 KB of shared memory, one block an SM.
//
// Keys past Skv and query rows past Sq are excluded by bounds checks
// (no padding copies).  Inputs are read in place through element
// strides, so the model layout (B, S, K, G, hd) needs no transpose.
// The k and v tiles are read as 16-byte vectors (4 fp32 or 8 bf16 a
// load), so their rows must be 16-byte aligned: the wrapper checks it.
// Filled element by element, the tiles kept the hd = 256 instance
// waiting on its loads (13.7 ms against 4.3 ms with vector loads and 8
// warps at recurrentgemma's prefill on an H100, chip_smoke.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BKV = 32;           // keys per tile (one per lane)
constexpr float NEG_INF = -1e30f;

// per-head-dim tiling: warps, query rows per warp and per block, and the
// number of 128-dim chunks of the head a lane holds 4 output dims of
template <int HD> struct Tile {
  static constexpr int NWARP = HD > 128 ? 8 : 4;
  static constexpr int NTHREAD = NWARP * 32;
  static constexpr int RPW = HD > 128 ? 8 : 16;
  static constexpr int BQ = NWARP * RPW;
  static constexpr int NC = (HD + 127) / 128;
};

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 16 bytes of a row -> fp32
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 y = __bfloat1622float2(h[e]);
    f[2 * e] = y.x;
    f[2 * e + 1] = y.y;
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  // Q (BQ x HD+4), K (BKV x HD+4), V (BKV x HD), P (NWARP x RPW x BKV)
  return sizeof(float) *
         (size_t(Tile<HD>::BQ) * (HD + 4) + size_t(BKV) * (HD + 4) +
          size_t(BKV) * HD +
          size_t(Tile<HD>::NWARP) * Tile<HD>::RPW * BKV);
}

template <typename T, int HD>
__global__ void __launch_bounds__(Tile<HD>::NTHREAD)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int G, int Sq, int Skv,
          int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh,
          int64_t kss, int64_t vsb, int64_t vsh, int64_t vss, int64_t osb,
          int64_t osh, int64_t oss, int causal, int window, float softcap,
          float scale) {
  constexpr int LD = HD + 4;  // padded row stride: conflict-free float4 rows
  constexpr int RPW = Tile<HD>::RPW, BQ = Tile<HD>::BQ, NC = Tile<HD>::NC;
  constexpr int NTHREAD = Tile<HD>::NTHREAD;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BKV * LD;
  float* Ps = Vs + BKV * HD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / G;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;

  for (int i = tid; i < BQ * HD; i += NTHREAD) {
    const int r = i / HD, d = i % HD;
    Qs[r * LD + d] = (q0 + r < Sq) ? to_f(qb[(q0 + r) * qss + d]) : 0.f;
  }

  // kv tiles to visit: the causal bound ends the loop, the window bound
  // starts it (tiles wholly outside either are skipped, as on the TPU)
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  int kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0)
    kv_begin = ((q0 - window + 1) / BKV) * BKV;

  // lane owns output dims [128c + 4l, 128c + 4l + 4) for c < NC
  const bool dim_ok = 4 * lane < HD;  // (chunk 0; full chunks beyond it)
  float m[RPW], l[RPW], acc[RPW][4 * NC];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[r][c] = 0.f;
  }
  const float* qw = Qs + warp * RPW * LD;
  float* pw = Ps + warp * RPW * BKV;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // Q loaded / previous K, V tile consumed
    constexpr int VEC = 16 / sizeof(T);
    for (int i = tid; i < BKV * HD / VEC; i += NTHREAD) {
      const int j = i / (HD / VEC), d = (i % (HD / VEC)) * VEC;
      const bool in = k0 + j < Skv;
      float kf[VEC], vf[VEC];
      if (in) {
        load_vec(kb + (k0 + j) * kss + d, kf);
        load_vec(vb + (k0 + j) * vss + d, vf);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        *reinterpret_cast<float4*>(Ks + j * LD + d + e) =
            make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
        *reinterpret_cast<float4*>(Vs + j * HD + d + e) =
            make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
      }
    }
    __syncthreads();

    // scores of this lane's key against the warp's RPW query rows
    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * LD;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qw + r * LD + d);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    const int kpos = k0 + lane;
    const bool in_range = kpos < Skv;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qpos = q0 + warp * RPW + r;
      float x = s[r] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      bool ok = true;
      if (causal) ok = kpos <= qpos;
      if (window > 0) ok = ok && (kpos > qpos - window);
      x = ok ? x : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(in_range ? x : -INFINITY));
      const float alpha = expf(m[r] - m_new);
      const float p = in_range ? expf(x - m_new) : 0.f;
      l[r] = l[r] * alpha + p;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
      pw[r * BKV + lane] = p;
    }
    __syncwarp();

    if (dim_ok) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float* vc = Vs + 128 * c + 4 * lane;
#pragma unroll 2
        for (int j = 0; j < BKV; j += 4) {
          const float4 v0 =
              *reinterpret_cast<const float4*>(vc + (j + 0) * HD);
          const float4 v1 =
              *reinterpret_cast<const float4*>(vc + (j + 1) * HD);
          const float4 v2 =
              *reinterpret_cast<const float4*>(vc + (j + 2) * HD);
          const float4 v3 =
              *reinterpret_cast<const float4*>(vc + (j + 3) * HD);
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            const float4 pp =
                *reinterpret_cast<const float4*>(pw + r * BKV + j);
            acc[r][4 * c + 0] +=
                pp.x * v0.x + pp.y * v1.x + pp.z * v2.x + pp.w * v3.x;
            acc[r][4 * c + 1] +=
                pp.x * v0.y + pp.y * v1.y + pp.z * v2.y + pp.w * v3.y;
            acc[r][4 * c + 2] +=
                pp.x * v0.z + pp.y * v1.z + pp.z * v2.z + pp.w * v3.z;
            acc[r][4 * c + 3] +=
                pp.x * v0.w + pp.y * v1.w + pp.z * v2.w + pp.w * v3.w;
          }
        }
      }
    }
    __syncwarp();  // P of this tile read before the next tile writes it
  }

  T* ob = o + b * osb + h * osh;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const float denom = fmaxf(warp_sum(l[r]), 1e-30f);
    const int qpos = q0 + warp * RPW + r;
    if (qpos < Sq && dim_ok) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        T* orow = ob + qpos * oss + 128 * c + 4 * lane;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          orow[e] = from_f<T>(acc[r][4 * c + e] / denom);
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int K, int Sq, int Skv, const int64_t* st,
                   int causal, int window, float softcap, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_fwd<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  constexpr int BQ = Tile<HD>::BQ;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, Tile<HD>::NTHREAD, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H / K, Sq, Skv, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int B, int H, int K, int Sq, int Skv,
                        const int64_t* st, int causal, int window,
                        float softcap, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, K, Sq, Skv, st, causal,
                                  window, softcap, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, K, Sq, Skv, st, causal,
                                  window, softcap, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, K, Sq, Skv, st, causal,
                                  window, softcap, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, K, Sq, Skv, st, causal,
                                    window, softcap, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, H, K, Sq, Skv, st, causal,
                                    window, softcap, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, H, Sq, hd), k/v (B, K, Skv, hd), o like q, all addressed through
// element strides (batch, head, sequence) with a unit stride over hd:
// strides = {q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s}.
// dtype: 0 = float32, 1 = bfloat16.  window <= 0 and softcap <= 0 mean
// none.  Returns the launch's cudaError_t (0 = success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int hd, int B, int H, int K, int Sq,
                        int Skv, const int64_t* strides, int causal,
                        int window, float softcap, float scale, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, B, H, K, Sq, Skv, strides,
                              causal, window, softcap, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, K, Sq, Skv,
                                      strides, causal, window, softcap, scale,
                                      st);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
