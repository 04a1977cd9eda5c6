// One-token GQA decode attention over a KV cache for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_attention` in
// src/repro/kernels/decode_attention.py (body `_kernel`): the G = H/K
// query heads of one kv head attend over that head's cache slots; slot
// t is valid iff kv_pos[t] >= 0 and kv_pos[t] <= q_pos (and
// kv_pos[t] > q_pos - window); softcap before the mask; additive -1e30
// masks; fp32 online softmax.
//
// What bounds it on this card: bytes.  Every cache byte is read once and
// used for G multiply-adds per dot, about G/2 operations per byte in
// bf16, far below the ~295 op/byte balance point: the bound is the
// cache's bytes over 3.35 TB/s (~2.5 us at both main paths' 8.4-10.5
// MB).  So the design is about putting those bytes in flight early, on
// every SM, and about finishing in one launch:
//
// - The split plan (split_plan in decode_attention.py) sizes each
//   block's share of the cache by bytes: about 1/132 of the call's k/v
//   per block (tiles of 32 slots), so at decode's few (b, kv-head) pairs
//   (32 for granite-8b, 4 for recurrentgemma-2b) one wave of blocks
//   covers the card with each block's share in flight at once; and at
//   least sqrt(G S / 2) slots a split, so that the combine's partials
//   (n_split G hd floats a pair) stay within about twice a block's k/v.
//   granite-8b: 4 splits of 160 slots; recurrentgemma-2b: 16 of 128.
// - The combine is folded into the same launch (design (b)): each block
//   writes its split's partial (running max, denominator, unnormalised
//   accumulator) to a scratch buffer and takes a ticket on its (b,
//   kv-head) counter (one acq_rel atomic); the block that draws the last
//   ticket reduces all the splits' partials into o (the (m, l) pairs in
//   one pass, then the accumulators with 32 loads a thread in flight)
//   and sets the counter back to 0 for the next call.  The counters live
//   in a per-device int32 buffer the wrapper keeps (zeroed once); a call
//   with one split writes o directly.
//
// decode_mma, bf16 at hd 64/128/256 (both main paths).  Two producer
// warps and two groups of four consumer warps; the groups take
// alternate tiles, each with its own online-softmax state, and meet in
// shared memory at the end.  The producers fill a ring of NST = 4
// stages, each 32 slots of k and v (bf16, as stored) and their 32 slot
// positions, with 16-byte cp.async copies (4-byte for the positions;
// q's rows are copied before the first stage, so each group's first
// stage covers them: a group waits for q on that stage, which only it
// releases).  Each stage completes on a "full" mbarrier through
// cp.async.mbarrier.arrive and is released by the consumers on an
// "empty" one; rows past the split's end repeat its
// last row (finite, masked out).  So a block has its first tiles in
// flight before any consumer computes.  Two producer warps, not one:
// on the card one warp could not keep a long split's copies in flight
// (PERF.md, Findings).  Rows are padded by 16 bytes in shared memory so
// that ldmatrix reads them without bank conflicts.
//
// Both products run on the tensor cores with mma.sync.m16n8k16 (bf16
// in, fp32 accumulate), the G <= 16 query heads as the 16 rows:
// S = q k^T takes q's fragments (held in registers for the whole split)
// and k rows through ldmatrix; the online softmax runs on the S
// fragment (a thread holds two head rows; max and sum over the quad);
// O += P v takes P from the S fragment, packed to bf16 (it is the A
// fragment), and v through ldmatrix.trans.  Each consumer warp of a
// group owns a quarter of the head's output columns, so all four compute
// the same scores (the k tile is read from shared memory four times,
// never from device memory twice) and share one softmax state.
// mma.sync, not wgmma: wgmma's 64-row tile would be >= 75% padding
// (G <= 16; 94% at G = 4, 84% at G = 10), and the kernel is bound by
// bytes, not by the tensor cores' rate; mma.sync's 16 rows pad G = 4 by
// 75% and G = 10 by 38% of work that costs nothing here.
//
// decode_simt, fp32 at every head dim and bf16 at hd 16 and 32: fp32 on
// the CUDA cores (the fp32 parity runs need more digits than TF32
// keeps).  Warp w holds query heads w, w + 4, ... (HPW of them: 2 when
// G <= 8, 4 when G <= 16); lane j owns slot j of the 32-slot tile for
// the scores and, for the p.v product, output dims [4j, 4j + 4) of
// every 128-dim chunk of the head.  Tiles are filled with 16-byte loads,
// converted to fp32 in shared memory.  Same split plan, same folded
// combine.
//
// Slots past the cache length S are excluded (they contribute nothing),
// not given -1e30: a row with no valid slot averages v over the S real
// slots, as the oracle does (the Pallas kernel averages over its padded
// length).  The model never makes such a row.  Inputs are read in place
// through element strides, so the stacked per-layer cache (B, S, K, hd)
// is used as stored, with no copy into kernel layout; k's and v's rows
// must start on 16-byte boundaries, and q's too for decode_mma (the
// wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int TILE = 32;           // slots per tile / ring stage
constexpr int MAXG = 16;           // query heads per kv head: G <= 16
constexpr int MAX_SPLIT = 128;     // splits a (b, kv-head), so that the
                                   // combine's 12 B a head and split fit
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* q_pos;
  const int32_t* kv_pos;
  void* o;
  float* part;   // partial acc (pairs, n_split, G, hd), then (m, l) pairs
  int* ticket;   // one counter per (b, kv-head), 0 between calls
  int G, S, chunk, n_split;
  int64_t qsb, qsk, qsg, ksb, ksk, kss, vsb, vsk, vss, psb, pss, osb, osk,
      osg;
  int window;
  float softcap, scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
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

__device__ __forceinline__ bool slot_valid(int pos, int qp, int window) {
  return pos >= 0 && pos <= qp && (window <= 0 || pos > qp - window);
}

__device__ __forceinline__ float score(float s, const Params& p, bool valid) {
  float x = s * p.scale;
  if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
  return valid ? x : NEG_INF;
}

// ------------------------------------------------------- folded combine
// Write one query head's split result (running max m, denominator l and
// the unnormalised accumulator's columns [d, d + n)) where it belongs:
// straight into o when there is one split, else into the partials.
template <typename T>
__device__ __forceinline__ void put_row(const Params& p, int hd, int b,
                                        int kh, int g, int d, int n,
                                        const float* acc, float m, float l,
                                        bool write_ml) {
  const int pair = b * gridDim.y + kh;
  if (p.n_split == 1) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = static_cast<T*>(p.o) + b * p.osb + kh * p.osk + g * p.osg;
    for (int e = 0; e < n; ++e) orow[d + e] = from_f<T>(acc[e] * inv);
    return;
  }
  const int64_t idx = (int64_t(pair) * p.n_split + blockIdx.x) * p.G + g;
  float* pa = p.part + idx * hd + d;
  for (int e = 0; e < n; ++e) pa[e] = acc[e];
  if (write_ml) {
    const int64_t pairs = int64_t(gridDim.y) * gridDim.z;
    float* pm = p.part + pairs * p.n_split * p.G * hd + idx * 2;
    pm[0] = m;
    pm[1] = l;
  }
}

// After every thread of the block has put its rows: the block that
// draws the last ticket of its (b, kv-head) reduces the splits into o
// and resets the counter.  sm: 3 G n_split floats of shared memory (the
// splits' (m, l) pairs, then their weights).
constexpr int CPT = 4;  // output columns (of 4 floats) a thread combines
                        // at once: CPT x 8 splits of loads in flight

__host__ __device__ constexpr int combine_floats(int G, int n_split) {
  return 3 * G * n_split;
}

__device__ __forceinline__ int ticket_add(int* counter) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

template <typename T, int NTH>
__device__ void finish(const Params& p, int hd, int b, int kh, float* sm) {
  __shared__ int last;
  if (p.n_split == 1) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pair = b * gridDim.y + kh;
  const int G = p.G, ns = p.n_split;
  // every partial of the block written (CTA scope); the ticket releases
  // them to the card and acquires the other blocks'
  __syncthreads();
  if (tid == 0) last = ticket_add(p.ticket + pair) == ns - 1;
  __syncthreads();
  if (!last) return;

  const int64_t pairs = int64_t(gridDim.y) * gridDim.z;
  const float* acc = p.part + int64_t(pair) * ns * G * hd;
  const float* ml = p.part + pairs * ns * G * hd + int64_t(pair) * ns * G * 2;
  float* ML = sm;               // (s, g, {m, l}) as in the partials
  float* W = sm + 2 * G * ns;   // (g, s): exp(m - M) / L
  for (int i = tid; i < 2 * G * ns; i += NTH) ML[i] = __ldcg(ml + i);
  __syncthreads();
  for (int g = warp; g < G; g += NTH / 32) {
    float M = -INFINITY;
    for (int s = lane; s < ns; s += 32) M = fmaxf(M, ML[(s * G + g) * 2]);
    M = warp_max(M);
    float L = 0.f;
    for (int s = lane; s < ns; s += 32)
      L += ML[(s * G + g) * 2 + 1] * __expf(ML[(s * G + g) * 2] - M);
    const float inv = 1.f / fmaxf(warp_sum(L), 1e-30f);
    for (int s = lane; s < ns; s += 32)
      W[g * ns + s] = __expf(ML[(s * G + g) * 2] - M) * inv;
  }
  __syncthreads();
  const int n4 = hd / 4;
  const float4* acc4 = reinterpret_cast<const float4*>(acc);
  for (int i0 = tid; i0 < G * n4; i0 += NTH * CPT) {
    float4 r[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) r[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < ns; ++s) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int i = i0 + j * NTH;
        if (i < G * n4) {
          const float w = W[(i / n4) * ns + s];
          const float4 x = __ldcg(acc4 + int64_t(s) * G * n4 + i);
          r[j].x = fmaf(w, x.x, r[j].x);
          r[j].y = fmaf(w, x.y, r[j].y);
          r[j].z = fmaf(w, x.z, r[j].z);
          r[j].w = fmaf(w, x.w, r[j].w);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int i = i0 + j * NTH;
      if (i >= G * n4) continue;
      const int g = i / n4, d = (i % n4) * 4;
      T* orow = static_cast<T*>(p.o) + b * p.osb + kh * p.osk + g * p.osg + d;
      orow[0] = from_f<T>(r[j].x);
      orow[1] = from_f<T>(r[j].y);
      orow[2] = from_f<T>(r[j].z);
      orow[3] = from_f<T>(r[j].w);
    }
  }
  if (tid == 0) p.ticket[pair] = 0;
}

// ------------------------------------------------------------ decode_mma
constexpr int NST = 4;                  // ring stages
constexpr int NCW = 4;                  // consumer warps a group
constexpr int NGRP = 2;                 // consumer groups (alternate tiles)
constexpr int NPW = 2;                  // producer warps
constexpr int NCONS = NCW * NGRP;       // consumer warps in all
constexpr int MMA_THREADS = (NCONS + NPW) * 32;

template <int HD>
struct Mma {
  static constexpr int ROWB = HD * 2;               // bytes of a k/v row
  static constexpr int PROW = ROWB + 16;            // ... padded in smem
  static constexpr int CH = HD / 8;                 // 16-byte chunks a row
  static constexpr int KV = TILE * PROW;            // one k (or v) tile
  static constexpr int STAGE = 2 * KV + TILE * 4;   // k, v, positions
  static constexpr int QS = NST * STAGE;            // q: 16 rows
  static constexpr int BARS = QS + 16 * PROW;       // full[NST], empty[NST]
  static constexpr int SMEM = BARS + 2 * NST * 8;
  static constexpr int WCOLS = HD / NCW;            // output cols a warp
  static constexpr int NTO = WCOLS / 8;             // its n8 tiles
};

// byte offset of (row, col) in a tile of padded HD-element bf16 rows:
// 16 bytes of padding a row put the 8 rows an ldmatrix reads in 8
// different bank groups
template <int HD>
__device__ __forceinline__ uint32_t pad(int row, int col) {
  return row * Mma<HD>::PROW + col * 2;
}

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
decode_mma(const __grid_constant__ Params p) {
  using C = Mma<HD>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full0 = sbase + C::BARS, empty0 = full0 + NST * 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int t_begin = split * p.chunk;
  const int t_end = min(p.S, t_begin + p.chunk);
  const int n_tiles = (t_end - t_begin + TILE - 1) / TILE;

  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full0 + s * 8, 32 * NPW);  // every producer lane arrives
      mbar_init(empty0 + s * 8, NCW);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= NCONS) {  // ---------------------------------- producer warps
    // lane pl of the producers copies 16-byte chunks pl, pl + 32 NPW, ...
    // of each tile's k and v rows; rows past the split's end repeat its
    // last row (finite values, masked out)
    const int pl = tid - NCONS * 32;
    const bf16* kb = static_cast<const bf16*>(p.k) + b * p.ksb + kh * p.ksk;
    const bf16* vb = static_cast<const bf16*>(p.v) + b * p.vsb + kh * p.vsk;
    const int32_t* pb = p.kv_pos + b * p.psb;
    const bf16* qb = static_cast<const bf16*>(p.q) + b * p.qsb + kh * p.qsk;
    for (int c = pl; c < 16 * C::CH; c += 32 * NPW) {  // before tile 0
      const int g = c / C::CH, col = (c % C::CH) * 8;  // rows past G
      cp_async16(sbase + C::QS + pad<HD>(g, col),      // repeat row G - 1
                 qb + min(g, p.G - 1) * p.qsg + col, 16);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % NST, u = i / NST;
      if (u > 0) mbar_wait_or_trap(empty0 + s * 8, (u - 1) & 1);
      const int t0 = t_begin + i * TILE;
      const uint32_t st = sbase + s * C::STAGE;
      for (int c = pl; c < TILE * C::CH; c += 32 * NPW) {
        const int row = c / C::CH, col = (c % C::CH) * 8;
        const int64_t t = min(t0 + row, t_end - 1);
        cp_async16(st + pad<HD>(row, col), kb + t * p.kss + col, 16);
        cp_async16(st + C::KV + pad<HD>(row, col), vb + t * p.vss + col, 16);
      }
      if (pl < TILE) {
        const bool in = t0 + pl < t_end;
        cp_async4(st + 2 * C::KV + pl * 4, pb + (in ? t0 + pl : 0) * p.pss,
                  in ? 4 : 0);
      }
      cp_async_mbar_arrive(full0 + s * 8);
    }
  } else {  // ----------------------------------------- consumer warps
    const int qp = p.q_pos[b];
    const int tq = lane & 3;
    const int grp = warp / NCW, col_base = (warp % NCW) * C::WCOLS;

    // q's fragments, once the group's first stage has landed: the
    // producers' cp.async.mbarrier.arrive on it covers every earlier
    // copy of theirs, q's included.  Each group waits on a stage only it
    // releases, so the phase it waits for cannot have been passed (a
    // group with no tile skips the wait and never uses q)
    if (grp < n_tiles) mbar_wait_or_trap(full0 + grp * 8, 0);
    uint32_t qf[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldsm_x4(qf[kk], sbase + C::QS +
                          pad<HD>((lane & 7) + ((lane >> 3) & 1) * 8,
                                  kk * 16 + (lane >> 4) * 8));
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float o[C::NTO][4];
#pragma unroll
    for (int n = 0; n < C::NTO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

    for (int i = grp; i < n_tiles; i += NGRP) {
      const int s = i % NST, u = i / NST;
      mbar_wait_or_trap(full0 + s * 8, u & 1);
      const int t0 = t_begin + i * TILE;
      const uint32_t st = sbase + s * C::STAGE;
      const int* pos = reinterpret_cast<const int*>(smem + s * C::STAGE +
                                                    2 * C::KV);

      // S = q k^T: 16 heads x 32 slots, as four n8 tiles
      float sc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t kf[4];
          ldsm_x4(kf, st + pad<HD>(16 * j + (lane & 7) + (lane >> 4) * 8,
                                   kk * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16(sc[2 * j], qf[kk], kf[0], kf[1]);
          mma_bf16(sc[2 * j + 1], qf[kk], kf[2], kf[3]);
        }
      }

      // scale, softcap, masks; online softmax over the thread's two rows
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int slot = n * 8 + 2 * tq + (e & 1);
          const float x = score(sc[n][e], p,
                                slot_valid(pos[slot], qp, p.window));
          sc[n][e] = t0 + slot < t_end ? x : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = __expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = __expf(sc[n][e] - m[e >> 1]);
          l[e >> 1] += sc[n][e];
        }
#pragma unroll
      for (int n = 0; n < C::NTO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

      // O += P v over the warp's columns, 16 slots a step
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t a[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                               pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                               pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                               pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
        for (int n2 = 0; n2 < C::NTO / 2; ++n2) {
          uint32_t vf[4];
          ldsm_x4_t(vf, st + C::KV +
                            pad<HD>(16 * j + (lane & 7) + ((lane >> 3) & 1) * 8,
                                    col_base + n2 * 16 + (lane >> 4) * 8));
          mma_bf16(o[2 * n2], a, vf[0], vf[1]);
          mma_bf16(o[2 * n2 + 1], a, vf[2], vf[3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + s * 8);
    }

    // the groups' states meet in shared memory (the ring's, every tile
    // consumed): group 0 takes in the others' running max, denominator
    // and accumulators, rescaled to the common max
    constexpr int NV = 4 + 4 * C::NTO;  // floats a lane hands over
    float* xfer = reinterpret_cast<float*>(smem) +
                  ((warp % NCW) * 32 + lane) * NV;
    for (int g2 = 1; g2 < NGRP; ++g2) {
      asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS * 32) : "memory");
      if (grp == g2) {
        xfer[0] = m[0], xfer[1] = m[1], xfer[2] = l[0], xfer[3] = l[1];
#pragma unroll
        for (int n = 0; n < C::NTO; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) xfer[4 + 4 * n + e] = o[n][e];
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS * 32) : "memory");
      if (grp == 0) {
        float a0[2], a1[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], xfer[r]);
          a0[r] = __expf(m[r] - m_new);
          a1[r] = __expf(xfer[r] - m_new);
          m[r] = m_new;
          l[r] = l[r] * a0[r] + xfer[2 + r] * a1[r];
        }
#pragma unroll
        for (int n = 0; n < C::NTO; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[n][e] = o[n][e] * a0[e >> 1] + xfer[4 + 4 * n + e] * a1[e >> 1];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = (lane >> 2) + 8 * r;
      if (grp != 0 || g >= p.G) continue;
#pragma unroll
      for (int n = 0; n < C::NTO; ++n) {
        const float acc[2] = {o[n][2 * r], o[n][2 * r + 1]};
        put_row<bf16>(p, HD, b, kh, g, col_base + n * 8 + 2 * tq, 2, acc,
                      m[r], l[r], warp == 0 && n == 0 && tq == 0);
      }
    }
  }
  finish<bf16, MMA_THREADS>(p, HD, b, kh, reinterpret_cast<float*>(smem));
}

// ----------------------------------------------------------- decode_simt
constexpr int NWARP = 4;
constexpr int NTHREAD = NWARP * 32;

template <int HD, int HPW>
struct Simt {
  static constexpr int LD = HD + 4;
  // Q (NWARP*HPW rows x LD), K (TILE x LD), V (TILE x HD), positions
  static constexpr int SMEM = 4 * (NWARP * HPW * LD + TILE * LD +
                                   TILE * HD + TILE);
};

// a 16-byte vector of T at src (or zeros) as fp32 into dst
__device__ __forceinline__ void vec_to_f(float* dst, const float* src,
                                         bool in) {
  const float4 x = in ? *reinterpret_cast<const float4*>(src)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  *reinterpret_cast<float4*>(dst) = x;
}
__device__ __forceinline__ void vec_to_f(float* dst, const bf16* src,
                                         bool in) {
  uint4 x = in ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  float4 lo, hi;
  lo.x = __low2float(h[0]);
  lo.y = __high2float(h[0]);
  lo.z = __low2float(h[1]);
  lo.w = __high2float(h[1]);
  hi.x = __low2float(h[2]);
  hi.y = __high2float(h[2]);
  hi.z = __low2float(h[3]);
  hi.w = __high2float(h[3]);
  reinterpret_cast<float4*>(dst)[0] = lo;
  reinterpret_cast<float4*>(dst)[1] = hi;
}

template <typename T, int HD, int HPW>
__global__ void __launch_bounds__(NTHREAD)
decode_simt(const __grid_constant__ Params p) {
  using C = Simt<HD, HPW>;
  constexpr int LD = C::LD;
  constexpr int NC = (HD + 127) / 128;  // 128-dim chunks a lane spans
  constexpr int VEC = 16 / sizeof(T);   // elements a 16-byte load holds
  extern __shared__ __align__(128) uint8_t smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + NWARP * HPW * LD;
  float* Vs = Ks + TILE * LD;
  int* Pos = reinterpret_cast<int*>(Vs + TILE * HD);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = p.G;
  const int t_begin = split * p.chunk;
  const int t_end = min(p.S, t_begin + p.chunk);
  const int qp = p.q_pos[b];
  const T* qb = static_cast<const T*>(p.q) + b * p.qsb + kh * p.qsk;
  const T* kb = static_cast<const T*>(p.k) + b * p.ksb + kh * p.ksk;
  const T* vb = static_cast<const T*>(p.v) + b * p.vsb + kh * p.vsk;

  for (int i = tid; i < G * HD; i += NTHREAD) {
    const int g = i / HD, d = i % HD;
    Qs[g * LD + d] = to_f(qb[g * p.qsg + d]);
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

  for (int t0 = t_begin; t0 < t_end; t0 += TILE) {
    __syncthreads();  // Q loaded / previous tile consumed
    for (int i = tid; i < TILE * HD / VEC; i += NTHREAD) {
      const int j = i / (HD / VEC), d = (i % (HD / VEC)) * VEC;
      const bool in = t0 + j < t_end;
      const int64_t t = in ? t0 + j : 0;
      vec_to_f(Ks + j * LD + d, kb + t * p.kss + d, in);
      vec_to_f(Vs + j * HD + d, vb + t * p.vss + d, in);
    }
    if (tid < TILE)
      Pos[tid] = (t0 + tid < t_end) ? p.kv_pos[b * p.psb + (t0 + tid) * p.pss]
                                    : -1;
    __syncthreads();

    const bool in_range = t0 + lane < t_end;
    const bool valid = slot_valid(Pos[lane], qp, p.window);
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
      const float x = score(s, p, valid);
      const float m_new = fmaxf(m[i], warp_max(in_range ? x : -INFINITY));
      const float alpha = expf(m[i] - m_new);
      const float pr = in_range ? expf(x - m_new) : 0.f;
      l[i] = l[i] * alpha + pr;
      m[i] = m_new;
      float a[4 * NC];
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) a[c] = acc[i][c] * alpha;
#pragma unroll 8
      for (int j = 0; j < TILE; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
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
    if (dim_ok) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        put_row<T>(p, HD, b, kh, g, 128 * c + 4 * lane, 4, &acc[i][4 * c],
                   m[i], denom, c == 0 && lane == 0);
    }
  }
  finish<T, NTHREAD>(p, HD, b, kh, reinterpret_cast<float*>(smem));
}

// ---------------------------------------------------------------- launch
// the combine's (m, l) pairs and weights reuse the tiles' memory once
// every thread is past its last tile
int smem_for(int tiles, int G, int n_split) {
  const int w = n_split > 1 ? 4 * combine_floats(G, n_split) : 0;
  return tiles > w ? tiles : w;
}

// Launch one instance; its shared-memory limit is raised once a device,
// to the most any call can ask of it (G = 16 heads at MAX_SPLIT splits).
template <auto kern>
cudaError_t run(int threads, int tiles, const Params& p, int B, int K,
                int device, cudaStream_t stream) {
  static uint64_t raised = 0;  // a bit a device
  if (!(raised >> device & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_for(tiles, MAXG, MAX_SPLIT));
    if (err != cudaSuccess) return err;
    raised |= uint64_t(1) << device;
  }
  kern<<<dim3(p.n_split, K, B), threads, smem_for(tiles, p.G, p.n_split),
         stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_simt(const Params& p, int B, int K, int device,
                        cudaStream_t stream) {
  // the smaller instance (2 heads a warp) for G <= 8, else 4 heads a warp
  if (p.G <= NWARP * 2)
    return run<decode_simt<T, HD, 2>>(NTHREAD, Simt<HD, 2>::SMEM, p, B, K,
                                      device, stream);
  return run<decode_simt<T, HD, 4>>(NTHREAD, Simt<HD, 4>::SMEM, p, B, K,
                                    device, stream);
}

template <typename T>
cudaError_t dispatch(int hd, const Params& p, int B, int K, int device,
                     cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_simt<T, 16>(p, B, K, device, stream);
    case 32: return launch_simt<T, 32>(p, B, K, device, stream);
    case 64: return launch_simt<T, 64>(p, B, K, device, stream);
    case 128: return launch_simt<T, 128>(p, B, K, device, stream);
    case 256: return launch_simt<T, 256>(p, B, K, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int HD>
cudaError_t launch_mma(const Params& p, int B, int K, int device,
                       cudaStream_t stream) {
  return run<decode_mma<HD>>(MMA_THREADS, Mma<HD>::SMEM, p, B, K, device,
                             stream);
}

// bf16 runs on the tensor cores at hd 64/128/256, else on the CUDA cores
cudaError_t dispatch_bf16(int hd, const Params& p, int B, int K,
                          int device, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch_mma<64>(p, B, K, device, stream);
    case 128: return launch_mma<128>(p, B, K, device, stream);
    case 256: return launch_mma<256>(p, B, K, device, stream);
    default: return dispatch<bf16>(hd, p, B, K, device, stream);
  }
}

}  // namespace

extern "C" {

// q (B, K, G, hd), k/v (B, K, S, hd), o like q, addressed through element
// strides with a unit stride over hd: strides = {q_b, q_k, q_g, k_b, k_k,
// k_s, v_b, v_k, v_s, pos_b, pos_s, o_b, o_k, o_g}.  q_pos (B,) and
// kv_pos int32.  part: B*K*n_split*G*(hd + 2) floats of scratch (unused
// when n_split is 1); ticket: B*K int32 counters, all 0 on entry and on
// return.  Blocks cover `chunk` slots each, n_split (<= 128) of them a
// (b, kv head).  dtype: 0 = float32, 1 = bfloat16.  window <= 0 and
// softcap <= 0 mean none.  G must be <= 16.  One launch; returns its
// cudaError_t (0 = success).
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* q_pos, const void* kv_pos, void* o,
                         void* part, void* ticket, int dtype, int hd, int B,
                         int K, int G, int S, int chunk, int n_split,
                         const int64_t* strides, int window, float softcap,
                         float scale, int device, void* stream) {
  if (G > MAXG || G < 1 || n_split < 1 || n_split > MAX_SPLIT)
    return cudaErrorInvalidValue;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t* s = strides;
  const Params p{q, k, v, static_cast<const int32_t*>(q_pos),
                 static_cast<const int32_t*>(kv_pos), o,
                 static_cast<float*>(part), static_cast<int*>(ticket), G, S,
                 chunk, n_split, s[0], s[1], s[2], s[3], s[4], s[5], s[6],
                 s[7], s[8], s[9], s[10], s[11], s[12], s[13], window,
                 softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(hd, p, B, K, device, st);
  if (dtype == 1) return dispatch_bf16(hd, p, B, K, device, st);
  return cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory the tensor-core instance at this head
// dim takes for its ring, q and barriers (0 for a head dim it lacks).
int decode_attention_mma_smem(int hd) {
  switch (hd) {
    case 64: return Mma<64>::SMEM;
    case 128: return Mma<128>::SMEM;
    case 256: return Mma<256>::SMEM;
    default: return 0;
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
