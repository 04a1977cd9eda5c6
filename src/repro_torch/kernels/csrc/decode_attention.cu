// One-token GQA decode attention over a KV cache for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_attention` in
// src/repro/kernels/decode_attention.py (body `_kernel`): the G = H/K
// query heads of one kv head attend over that head's cache slots; slot
// t is valid iff kv_pos[t] >= 0 and kv_pos[t] <= q_pos (and
// kv_pos[t] > q_pos - window); softcap before the mask; additive -1e30
// masks; fp32 online softmax.
//
// What bounds it on this card: memory.  Every cache byte is read once
// and used for G multiply-adds per dot, about G/2 operations per byte
// in bf16, far below the ~295 op/byte balance point.  The bound is the
// cache's bytes over 3.35 TB/s.  What the design does about it: the grid
// must put enough loads in flight to draw that rate, and at decode there
// are only B*K (b, kv-head) pairs for 132 SMs (32 at B=4, K=8; 4 for
// recurrentgemma's single kv head).  So the cache axis is split across
// blocks (flash-decoding): each block keeps per-split m/l/acc for its G
// heads in fp32 scratch, and a second launch combines the splits.
// Each k/v tile is staged once in shared memory and serves all G heads,
// as on the TPU.
//
// Warp w holds query heads w, w + 4, ... (HPW of them: 2 when G <= 8,
// 4 when G <= 16, chosen per launch so that G <= 8 keeps the smaller
// instance); lane j owns slot j of the tile for the scores and, for the
// p.v product, output dims [4j, 4j + 4) of every 128-dim chunk of the
// head (two chunks at hd = 256).
//
// Slots past the cache length S are excluded (they contribute nothing),
// not given -1e30: a row with no valid slot averages v over the S real
// slots, as the oracle does (the Pallas kernel averages over its padded
// length).  The model never makes such a row.  Inputs are read in place
// through element strides, so the stacked per-layer cache (B, S, K, hd)
// is used as stored, with no copy into kernel layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DKV = 32;            // slots per tile (one per lane)
constexpr int NWARP = 4;
constexpr int NTHREAD = NWARP * 32;
constexpr int MAXG = NWARP * 4;    // query heads per kv head: G <= 16
constexpr float NEG_INF = -1e30f;

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

template <int HD, int HPW>
constexpr size_t smem_bytes() {
  // Q (G <= NWARP*HPW rows x HD+4), K (DKV x HD+4), V (DKV x HD), slot
  // positions (DKV)
  return sizeof(float) * (size_t(NWARP * HPW) * (HD + 4) +
                          size_t(DKV) * (HD + 4) + size_t(DKV) * HD + DKV);
}

// grid (n_split, K, B): block (split, kh, b) covers slots
// [split * chunk, min(S, split * chunk + chunk)).  Writes, per query head
// g, the split's running max and denominator to part_ml[(idx) * 2 + {0,1}]
// and its unnormalised accumulator to part_acc[idx * HD + d], with
// idx = ((b * K + kh) * n_split + split) * G + g.
template <typename T, int HD, int HPW>
__global__ void __launch_bounds__(NTHREAD)
decode_split(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int32_t* __restrict__ q_pos,
             const int32_t* __restrict__ kv_pos, float* __restrict__ part_acc,
             float* __restrict__ part_ml, int G, int S, int chunk,
             int64_t qsb, int64_t qsk, int64_t qsg, int64_t ksb, int64_t ksk,
             int64_t kss, int64_t vsb, int64_t vsk, int64_t vss,
             int64_t psb, int64_t pss, int window, float softcap,
             float scale) {
  constexpr int LD = HD + 4;
  constexpr int NC = (HD + 127) / 128;  // 128-dim chunks a lane spans
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + NWARP * HPW * LD;
  float* Vs = Ks + DKV * LD;
  int* Pos = reinterpret_cast<int*>(Vs + DKV * HD);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int K = gridDim.y, n_split = gridDim.x;
  const int t_begin = split * chunk;
  const int t_end = min(S, t_begin + chunk);
  const int qp = q_pos[b];
  const T* kb = k + b * ksb + kh * ksk;
  const T* vb = v + b * vsb + kh * vsk;

  for (int i = tid; i < G * HD; i += NTHREAD) {
    const int g = i / HD, d = i % HD;
    Qs[g * LD + d] = to_f(q[b * qsb + kh * qsk + g * qsg + d]);
  }

  // lane owns output dims [128c + 4l, 128c + 4l + 4) for c < NC
  const bool dim_ok = 4 * lane < HD;  // (chunk 0; full chunks beyond it)
  float m[HPW], l[HPW], acc[HPW][4 * NC];
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = t_begin; t0 < t_end; t0 += DKV) {
    __syncthreads();  // Q loaded / previous tile consumed
    for (int i = tid; i < DKV * HD; i += NTHREAD) {
      const int j = i / HD, d = i % HD;
      const bool in = t0 + j < t_end;
      Ks[j * LD + d] = in ? to_f(kb[(t0 + j) * kss + d]) : 0.f;
      Vs[j * HD + d] = in ? to_f(vb[(t0 + j) * vss + d]) : 0.f;
    }
    if (tid < DKV)
      Pos[tid] = (t0 + tid < t_end) ? kv_pos[b * psb + (t0 + tid) * pss] : -1;
    __syncthreads();

    const bool in_range = t0 + lane < t_end;
    const int pos = Pos[lane];
    bool valid = pos >= 0 && pos <= qp;
    if (window > 0) valid = valid && pos > qp - window;
    const float* kr = Ks + lane * LD;

#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const int g = warp + NWARP * i;  // warp-uniform
      if (g >= G) continue;
      const float* qr = Qs + g * LD;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + d);
        const float4 qq = *reinterpret_cast<const float4*>(qr + d);
        s = fmaf(qq.x, kk.x, s);
        s = fmaf(qq.y, kk.y, s);
        s = fmaf(qq.z, kk.z, s);
        s = fmaf(qq.w, kk.w, s);
      }
      float x = s * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      x = valid ? x : NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(in_range ? x : -INFINITY));
      const float alpha = expf(m[i] - m_new);
      const float p = in_range ? expf(x - m_new) : 0.f;
      l[i] = l[i] * alpha + p;
      m[i] = m_new;
      float a[4 * NC];
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) a[c] = acc[i][c] * alpha;
#pragma unroll 8
      for (int j = 0; j < DKV; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        if (dim_ok) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float4 vv = *reinterpret_cast<const float4*>(
                Vs + j * HD + 128 * c + 4 * lane);
            a[4 * c] = fmaf(pj, vv.x, a[4 * c]);
            a[4 * c + 1] = fmaf(pj, vv.y, a[4 * c + 1]);
            a[4 * c + 2] = fmaf(pj, vv.z, a[4 * c + 2]);
            a[4 * c + 3] = fmaf(pj, vv.w, a[4 * c + 3]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] = a[c];
    }
  }

#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int g = warp + NWARP * i;
    if (g >= G) continue;
    const float denom = warp_sum(l[i]);
    const int64_t idx = (int64_t(b * K + kh) * n_split + split) * G + g;
    if (dim_ok) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float* pa = part_acc + idx * HD + 128 * c + 4 * lane;
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[e] = acc[i][4 * c + e];
      }
    }
    if (lane == 0) {
      part_ml[idx * 2] = m[i];
      part_ml[idx * 2 + 1] = denom;
    }
  }
}

// grid (G, K, B), HD threads: o[b, kh, g, d] from the splits' partials.
template <typename T>
__global__ void decode_combine(const float* __restrict__ part_acc,
                               const float* __restrict__ part_ml,
                               T* __restrict__ o, int n_split, int hd,
                               int64_t osb, int64_t osk, int64_t osg) {
  const int g = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = gridDim.x, K = gridDim.y;
  const int d = threadIdx.x;
  const int64_t base = int64_t(b * K + kh) * n_split * G + g;
  float M = NEG_INF;
  for (int s = 0; s < n_split; ++s)
    M = fmaxf(M, part_ml[(base + int64_t(s) * G) * 2]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const int64_t idx = base + int64_t(s) * G;
    const float w = expf(part_ml[idx * 2] - M);
    L += part_ml[idx * 2 + 1] * w;
    A += part_acc[idx * hd + d] * w;
  }
  o[b * osb + kh * osk + g * osg + d] = from_f<T>(A / fmaxf(L, 1e-30f));
}

template <typename T, int HD, int HPW>
cudaError_t launch_hpw(const void* q, const void* k, const void* v,
                       const int32_t* q_pos, const int32_t* kv_pos, void* o,
                       float* part_acc, float* part_ml, int B, int K, int G,
                       int S, int chunk, int n_split, const int64_t* st,
                       int window, float softcap, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, HPW>();
  auto kern = decode_split<T, HD, HPW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kern<<<dim3(n_split, K, B), NTHREAD, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, part_acc, part_ml, G, S, chunk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], window, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T><<<dim3(G, K, B), HD, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(o), n_split, HD, st[11], st[12],
      st[13]);
  return cudaGetLastError();
}

// the smaller instance (2 heads a warp) for G <= 8, else 4 heads a warp
template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* q_pos, const int32_t* kv_pos, void* o,
                   float* part_acc, float* part_ml, int B, int K, int G,
                   int S, int chunk, int n_split, const int64_t* st,
                   int window, float softcap, float scale,
                   cudaStream_t stream) {
  if (G <= NWARP * 2)
    return launch_hpw<T, HD, 2>(q, k, v, q_pos, kv_pos, o, part_acc,
                                part_ml, B, K, G, S, chunk, n_split, st,
                                window, softcap, scale, stream);
  return launch_hpw<T, HD, 4>(q, k, v, q_pos, kv_pos, o, part_acc, part_ml,
                              B, K, G, S, chunk, n_split, st, window,
                              softcap, scale, stream);
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int32_t* q_pos, const int32_t* kv_pos, void* o,
                        float* part_acc, float* part_ml, int B, int K, int G,
                        int S, int chunk, int n_split, const int64_t* st,
                        int window, float softcap, float scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, q_pos, kv_pos, o, part_acc,
                                  part_ml, B, K, G, S, chunk, n_split, st,
                                  window, softcap, scale, stream);
    case 32: return launch<T, 32>(q, k, v, q_pos, kv_pos, o, part_acc,
                                  part_ml, B, K, G, S, chunk, n_split, st,
                                  window, softcap, scale, stream);
    case 64: return launch<T, 64>(q, k, v, q_pos, kv_pos, o, part_acc,
                                  part_ml, B, K, G, S, chunk, n_split, st,
                                  window, softcap, scale, stream);
    case 128: return launch<T, 128>(q, k, v, q_pos, kv_pos, o, part_acc,
                                    part_ml, B, K, G, S, chunk, n_split, st,
                                    window, softcap, scale, stream);
    case 256: return launch<T, 256>(q, k, v, q_pos, kv_pos, o, part_acc,
                                    part_ml, B, K, G, S, chunk, n_split, st,
                                    window, softcap, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, K, G, hd), k/v (B, K, S, hd), o like q, addressed through element
// strides with a unit stride over hd: strides = {q_b, q_k, q_g, k_b, k_k,
// k_s, v_b, v_k, v_s, pos_b, pos_s, o_b, o_k, o_g}.  q_pos (B,) and
// kv_pos int32.  part_acc: n_split*B*K*G*hd floats, part_ml:
// n_split*B*K*G*2 floats of scratch.  dtype: 0 = float32, 1 = bfloat16.
// window <= 0 and softcap <= 0 mean none.  G must be <= 16.  Returns the
// first failing launch's cudaError_t (0 = success).
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* q_pos, const void* kv_pos, void* o,
                         void* part_acc, void* part_ml, int dtype, int hd,
                         int B, int K, int G, int S, int chunk, int n_split,
                         const int64_t* strides, int window, float softcap,
                         float scale, int device, void* stream) {
  if (G > MAXG) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* qp = static_cast<const int32_t*>(q_pos);
  const int32_t* kp = static_cast<const int32_t*>(kv_pos);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, qp, kp, o, pa, pm, B, K, G, S,
                              chunk, n_split, strides, window, softcap, scale,
                              st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, qp, kp, o, pa, pm, B, K, G,
                                      S, chunk, n_split, strides, window,
                                      softcap, scale, st);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
