// Causal / windowed / softcapped GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (body `_kernel`): softmax(q k^T *
// hd^-0.5) v with an fp32 online softmax, softcap before the mask,
// additive -1e30 masks, positions = indices from 0.
//
// What bounds it on this card: at prefill shapes (S = 512, hd = 128;
// S = 2048, hd = 256) the two products do ~hd/2 operations per byte of
// q, k, v and o or more.  At hd 256 that is above the H100's ~295 op/byte
// balance point (the bound is the tensor cores' 989 TFLOP/s); at granite's
// hd 128 and S 512 the bytes bound it.  Either way the products must run
// on the tensor cores, as the reference runs them on the TPU's matrix
// unit with fp32 accumulation.
//
// Two kernels, chosen by (dtype, hd) in flash_attention_fwd:
//
// flash_fwd_wgmma, bf16 at hd 64, 128 and 256 (both main paths).  One
// block owns 128 query rows of one (b, h) and runs three warpgroups:
// warpgroup 2 is the producer, one thread of which loads the q tile once
// and then each k/v tile (64 keys at hd 256, 128 below) with TMA into a
// two-stage ring of shared memory, completed on full/empty mbarrier
// pairs; warpgroups 0 and 1 each own 64 query rows and compute.  For
// every tile a consumer runs S = q k^T with wgmma from shared memory
// (both operands K-major), the online softmax on the accumulator
// fragment in registers (a thread holds two rows; row max and sum over
// the 4 lanes of a quad; exp2 with scale * log2(e) folded in; masks
// only on tiles that straddle the causal diagonal, the window's edge or
// Skv), then O += P v with P as the register A operand (the S
// fragment, packed to bf16, is the A fragment) and v MN-major (the
// transpose bit).  setmaxnreg gives the consumers 240 registers and the
// producer 24; the role index is a shuffle (warp-uniform to ptxas), and
// only the producer's waits carry the 4 s trap against a lost transfer:
// with a trap in the consumers' code ptxas held them to the kernel's
// entry count (168) and spilled the hd 256 accumulators.  The producer
// ends by waiting for the ring to drain, so a consumer stuck on a stage
// still trips its trap.  The head is loaded as 64-column boxes (the
// 128-byte swizzle's width), one descriptor chunk each.  q, k and v are
// read in place through 4-D tensor maps (hd, S, heads, B) built on the
// host from the element strides, so the model's (B, S, K, G, hd) views
// need no copy; their base and strides must be 16-byte multiples (the
// wrapper checks).  TMA fills rows past Sq or Skv with zeros: keys past Skv are
// masked to -inf, rows past Sq are not stored.  Blocks walk q tiles
// from the last, so the longest causal tiles start first.  P is rounded
// to bf16 before P v (the plain version keeps it fp32).
//
// flash_fwd_simt, fp32 at every head dim and bf16 at hd 16 and 32: fp32
// on the CUDA cores (67 TFLOP/s peak).  fp32 keeps it because TF32
// tensor cores keep ~3 digits, which the fp32 parity runs (2e-5) do not
// allow.  One block owns (b, h, BQ query rows) and loops over kv tiles
// of 32 keys itself, stopping at the causal bound and starting at the
// window bound (the Pallas skip test).  Warp w owns query rows [RPW w,
// RPW w + RPW); lane j owns key j of the tile for the scores and, for
// the p.v product, output dims [4j, 4j + 4) of every 128-dim chunk of
// the head.  The running max is warp-uniform (one shuffle reduction per
// row and tile); the denominator is summed per lane and reduced once at
// the end.  Rows per warp and warps per block follow the head dim so
// that each lane keeps 64 fp32 accumulators and each k/v tile still
// serves 64 query rows: hd <= 128 takes 4 warps of 16 rows (4 dims a
// lane); hd = 256 takes 8 warps of 8 rows (8 dims a lane, two float4
// columns 128 dims apart so the warp's shared-memory reads stay
// conflict-free) and ~140 KB of shared memory, one block an SM.  Keys
// past Skv and query rows past Sq are excluded by bounds checks.  The k
// and v tiles are read as 16-byte vectors, so their rows must be
// 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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
flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k,
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
  auto kern = flash_fwd_simt<T, HD>;
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

// fp32: the CUDA-core kernel at every head dim
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

// ------------------------------------------------- bf16 on the tensor cores
namespace wg {

using namespace hopper;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int NTHREAD = 384;  // consumer warpgroups 0 and 1, producer 2

template <int HD> struct Cfg {
  static constexpr int BQ = 128;                   // query rows a block
  static constexpr int BKV = HD > 128 ? 64 : 128;  // keys a k/v tile
  static constexpr int STAGES = 2;
  static constexpr int NCH = HD / 64;           // 128-byte column chunks
  static constexpr int Q_CHUNK = BQ * 128;      // bytes of a q chunk
  static constexpr int KV_CHUNK = BKV * 128;    // bytes of a k or v chunk
  static constexpr int Q_BYTES = NCH * Q_CHUNK;
  static constexpr int KV_BYTES = NCH * KV_CHUNK;  // one k (or v) tile
  // q, STAGES k and v tiles, 8-byte barriers, slack to align to 1024
  static constexpr int SMEM =
      Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 2 * STAGES) + 1024;
  static constexpr int NS = BKV / 2;  // score registers a thread
  static constexpr int NO = HD / 2;   // output registers a thread
};

template <int HD>
__global__ void __launch_bounds__(NTHREAD, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, int64_t osb, int64_t osh,
                int64_t oss, int G, int Sq, int Skv, int causal, int window,
                float softcap, float scale) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;  // stage s at sK + s * KV_BYTES
  const uint32_t sV = sK + C::STAGES * C::KV_BYTES;
  const uint32_t q_full = sV + C::STAGES * C::KV_BYTES;
  const uint32_t full0 = q_full + 8;                  // full[s]
  const uint32_t empty0 = full0 + 8 * C::STAGES;      // empty[s]

  const int h = blockIdx.x, b = blockIdx.y, kh = h / G;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::BQ;  // longest first
  // kv tiles to visit: the causal bound ends the loop, the window bound
  // starts it (tiles wholly outside either are skipped, as on the TPU)
  const int kv_end = causal ? min(Skv, q0 + C::BQ) : Skv;
  int kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0)
    kv_begin = ((q0 - window + 1) / C::BKV) * C::BKV;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + C::BKV - 1) / C::BKV : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  // warp-uniform in the compiler's view (a shuffle), so that ptxas can
  // give each role its own register count
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wgi == 2) {
    // ---- producer: one thread keeps the TMA loads in flight
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::NCH; ++c)
        tma_load_4d(sQ + c * C::Q_CHUNK, &tm_q, q_full, 64 * c, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::STAGES;
        const uint32_t round = i / C::STAGES;
        mbar_wait_or_trap(empty0 + 8 * s, (round & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * C::KV_BYTES);
        const int k0 = kv_begin + i * C::BKV;
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          tma_load_4d(sK + s * C::KV_BYTES + c * C::KV_CHUNK, &tm_k,
                      full0 + 8 * s, 64 * c, k0, kh, b);
          tma_load_4d(sV + s * C::KV_BYTES + c * C::KV_CHUNK, &tm_v,
                      full0 + 8 * s, 64 * c, k0, kh, b);
        }
      }
      // outlive the consumers' use of the ring, so that a consumer that
      // hangs on a stage makes this wait trap
      for (int i = max(n_tiles - C::STAGES, 0); i < n_tiles; ++i)
        mbar_wait_or_trap(empty0 + 8 * (i % C::STAGES),
                          (i / C::STAGES) & 1);
    }
    return;
  }

  // ---- consumers: warpgroup wgi owns query rows [qa, qa + 64)
  setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int t = lane % 4;
  const int qa = q0 + 64 * wgi;
  const int r0 = qa + 16 * warp + lane / 4, r1 = r0 + 8;  // my two rows
  const float scale_log2 = scale * LOG2E;
  const uint32_t q_wg = sQ + wgi * 64 * 128;

  float acc_o[C::NO], acc_s[C::NS];
#pragma unroll
  for (int i = 0; i < C::NO; ++i) acc_o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < C::NS; ++i) acc_s[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % C::STAGES;
    const int k0 = kv_begin + i * C::BKV;
    mbar_wait(full0 + 8 * s, (i / C::STAGES) & 1);
    // a tile wholly past these rows' causal bound or before their window
    // is loaded for the other warpgroup only
    const bool live = qa < Sq && !(causal && k0 > qa + 63) &&
                      !(window > 0 && k0 + C::BKV - 1 <= qa - window);
    if (live) {
      const uint32_t k_s = sK + s * C::KV_BYTES, v_s = sV + s * C::KV_BYTES;
      // S = q k^T over the head, 16 dims a wgmma
      fence_regs(acc_s);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < C::NCH; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(acc_s,
                   desc_sw128(q_wg + c * C::Q_CHUNK + 32 * kk, 16, 1024),
                   desc_sw128(k_s + c * C::KV_CHUNK + 32 * kk, 16, 1024),
                   (c | kk) != 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_s);

      // scores in log2 units; masks only where the tile straddles the
      // causal diagonal, the window's edge or Skv
      const bool masked = k0 + C::BKV > Skv ||
                          (causal && k0 + C::BKV - 1 > qa) ||
                          (window > 0 && k0 <= qa + 63 - window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < C::NS; ++j) {
        float x = acc_s[j];
        x = softcap > 0.f ? softcap * tanhf(x * scale / softcap) * LOG2E
                          : x * scale_log2;
        if (masked) {
          const int key = k0 + 8 * (j / 4) + 2 * t + (j & 1);
          const int row = (j & 2) ? r1 : r0;
          if (key >= Skv)
            x = -INFINITY;
          else if ((causal && key > row) ||
                   (window > 0 && key <= row - window))
            x = NEG_INF;
        }
        acc_s[j] = x;
        if (j & 2) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float alpha0 = ex2(m0 - mn0), alpha1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;

      // P as the A operand of P v: 16 keys a wgmma, 4 registers a thread
      uint32_t pa[C::BKV / 16][4];
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < C::NS; j += 2) {
        const float mm = (j & 2) ? mn1 : mn0;
        const float p_lo = ex2(acc_s[j] - mm), p_hi = ex2(acc_s[j + 1] - mm);
        if (j & 2) ps1 += p_lo + p_hi;
        else ps0 += p_lo + p_hi;
        pa[j / 8][(j % 8) / 2] = pack_bf16(p_lo, p_hi);
      }
      l0 = l0 * alpha0 + ps0;
      l1 = l1 * alpha1 + ps1;
#pragma unroll
      for (int j = 0; j < C::NO; ++j) acc_o[j] *= (j & 2) ? alpha1 : alpha0;

      // O += P v, v MN-major: 16 keys (two 1024-byte row groups) a wgmma
      fence_regs(acc_o);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C::BKV / 16; ++ks)
        wgmma_rs(acc_o, pa[ks],
                 desc_sw128(v_s + 2048 * ks, C::KV_CHUNK, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  if (qa >= Sq) return;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * oss + col) =
          __floats2bfloat162_rn(acc_o[4 * j] * inv0, acc_o[4 * j + 1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * oss + col) =
          __floats2bfloat162_rn(acc_o[4 * j + 2] * inv1,
                                acc_o[4 * j + 3] * inv1);
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver, found at run time (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 4-D map (hd, S, heads, B) of a bf16 tensor addressed through element
// strides (s = sequence, h = head, b = batch), boxes of 64 columns by
// `rows` rows, 128-byte swizzle.  False where TMA cannot take it.
bool make_map(CUtensorMap* map, const void* base, int hd, int S, int heads,
              int B, int64_t sb, int64_t sh, int64_t ss, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int64_t st[3] = {ss * 2, sh * 2, sb * 2};
  if (reinterpret_cast<uintptr_t>(base) % 16) return false;
  for (int64_t x : st)
    if (x <= 0 || x % 16) return false;
  cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(S), cuuint64_t(heads),
                        cuuint64_t(B)};
  cuuint64_t strides[3] = {cuuint64_t(st[0]), cuuint64_t(st[1]),
                           cuuint64_t(st[2])};
  cuuint32_t box[4] = {64, cuuint32_t(rows), 1, 1};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, estride,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int K, int Sq, int Skv, const int64_t* st,
                   int causal, int window, float softcap, float scale,
                   cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, HD, Sq, H, B, st[0], st[1], st[2], C::BQ) ||
      !make_map(&mk, k, HD, Skv, K, B, st[3], st[4], st[5], C::BKV) ||
      !make_map(&mv, v, HD, Skv, K, B, st[6], st[7], st[8], C::BKV))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, (Sq + C::BQ - 1) / C::BQ);
  kern<<<grid, NTHREAD, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11],
      H / K, Sq, Skv, causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace wg

// bf16: the tensor-core kernel at hd 64, 128 and 256, the CUDA-core one
// at 16 and 32
cudaError_t dispatch_bf16(int hd, const void* q, const void* k,
                          const void* v, void* o, int B, int H, int K,
                          int Sq, int Skv, const int64_t* st, int causal,
                          int window, float softcap, float scale,
                          cudaStream_t stream) {
  using T = __nv_bfloat16;
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, K, Sq, Skv, st, causal,
                                  window, softcap, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, K, Sq, Skv, st, causal,
                                  window, softcap, scale, stream);
    case 64: return wg::launch<64>(q, k, v, o, B, H, K, Sq, Skv, st, causal,
                                   window, softcap, scale, stream);
    case 128: return wg::launch<128>(q, k, v, o, B, H, K, Sq, Skv, st,
                                     causal, window, softcap, scale, stream);
    case 256: return wg::launch<256>(q, k, v, o, B, H, K, Sq, Skv, st,
                                     causal, window, softcap, scale, stream);
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
    return dispatch_bf16(hd, q, k, v, o, B, H, K, Sq, Skv, strides, causal,
                         window, softcap, scale, st);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
