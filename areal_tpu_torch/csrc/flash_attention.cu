// Segment-masked causal flash attention for Hopper (sm_90a): the forward,
// dq and dk/dv kernels of the training and logprob path, at head dim 128
// and 256.
//
// Replaces the TPU splash-attention kernel that areal_tpu/ops/attention.py
// builds (`_make_kernel`) and launches (`_splash_call`, `_sharded_splash`):
// jax's splash forward, its dq kernel and its dk/dv kernel, which take any
// head dim that is a multiple of 128.  Per (row, q head) the kernels
// compute softmax(q_s k^T) v over the keys j of the same segment with j <= i
// (buffer-index causality), j > i - window when a left window is set, and
// an optional logit softcap tanh(s / c) * c.  q arrives pre-scaled by
// 1/sqrt(hd) (q_s, scaled by the wrapper in q's dtype, as splash is fed).
// Padding (segment id < 0) attends nothing: its output is 0 and its lse
// -inf, and no (query, key) pair touching it is visited, so it neither
// sends nor receives gradient.
//
// Query offset (the sequence-parallel shard of `_sharded_splash`, which
// runs these kernels for one sp shard's T/sp query rows against the whole
// K/V).  Queries are rows [q_start, q_start + Tq) of a packed row of Tk
// keys: query i (local) is global position q_start + i, and causality and
// the window are taken on global positions (key j is visible to query i
// when j <= q_start + i and j > q_start + i - window).  q's segment ids are
// [B, Tq], the keys' [B, Tk], and q's are the keys' slice [q_start,
// q_start + Tq).  The forward and dq stop at the last key the shard's last
// query can see; dk/dv's grid covers all Tk keys, and a key tile that no
// query of the shard sees visits no query tile and writes zeros, so a
// shard's dk/dv is its partial over every key, to be summed across shards.
// q_start = 0 with Tq = Tk (and one segment-id array for both) is the
// unsharded call, with the same arithmetic.
//
// Layouts are the model's: q, dout, out, dq [B, Tq, Hq, hd]; k, v, dk, dv
// [B, Tk, Hkv, hd]; segment ids int32 [B, Tq] (queries) and [B, Tk] (keys);
// lse and di f32 [B, Hq, Tq].
// Inputs are float32 or bfloat16; every product, the softmax statistics
// and the accumulators are f32, outputs are rounded once to the input type.
// The exceptions are the bf16 kernels' tensor-core operands: the forward
// rounds P to bf16 before its PV product, and the backward rounds P (for
// dV) and dS (for dK and dQ) to bf16 before those products.
//
// What bounds it on this card: operations.  Attention over a packed row
// does ~4 hd flops per attended (q, k) pair forward (8 and 6 for dk/dv and
// dq) against ~2 hd bytes of q/k/v per token, far above the ~300 flops per
// byte where the H100's arithmetic becomes the limit.
//
// What the design does about it.  For bf16 inputs all three kernels run
// on the tensor cores.  The forward at hd 128 and 256, and dq at hd 256,
// run on Hopper's warpgroup products (namespace wg: wgmma on K/V tiles
// that TMA brings into shared memory, which two q heads of a GQA group
// share).  dq at hd 128 and dk/dv are namespace tc below (mma.sync
// m16n8k16, bf16 operands in padded shared memory read by ldmatrix, f32
// accumulators in registers, double-buffered 16-byte cp.async tile
// pipelines): tc::flash_bwd_dq_tc_kernel, tc::flash_bwd_dkv_tc_kernel at
// hd 128 and tc::flash_bwd_dkv_tc256_kernel at hd 256.  The f32 kernels stay plain and right rather than fast:
// they run on the CUDA cores in f32, because the tensor cores would round
// the f32 operands (TF32 at best).  Each such block stages tiles of q, k, v (and
// dout) in shared memory as f32 (64 rows at hd 128, 32 at hd 256, where 64
// rows of dq or dk/dv would need more than a block's 227 KB) and keeps a
// score tile slice and head-dim slices per thread in registers.  What every
// kernel keeps from splash: the blockwise softmax (no [T, T] score matrix
// ever reaches device memory) and the skipping of masked tiles.  Segments
// are contiguous, so a q tile needs only the keys from the segment start of
// its first valid query to its last query (and a k tile only the queries
// from its first key to the segment end of its last key); each block finds
// that range from the segment ids, and the window narrows it further.
//
// Head dim 256 doubles every per-thread head-dim slice.  The wgmma kernels
// hold a 64 x hd f32 accumulator a warpgroup (64 registers a thread at hd
// 128, 128 at 256) and read Q, dO, K and V from shared memory.  The
// dk/dv block at hd 256 has 8 warps in two groups over the same 64 keys:
// one computes S^T and P^T and accumulates dV, the other dP^T and dS^T (with
// P^T (1 - t^2) handed over through shared memory) and accumulates dK, so
// each thread holds 128 accumulators, not 256, and no product is done twice.
//
// Grids: the wgmma forward one persistent block an SM, walking items of two
// q heads' 64-row tile (or two q tiles at group 1) of one kv head and row,
// and dq at hd 256 a block an item; dq at hd 128 one block per (q tile, q
// head, row); dk/dv at hd 128
// one block per (k tile, kv head, row), looping over the group's q heads
// and the q tiles that see its keys; dk/dv at hd 256 a thread block cluster
// per (k tile, kv head, row) whose blocks split the group's q heads and sum
// their f32 partials through distributed shared memory in rank order.  GQA
// and MQA need no atomics and every result is the same from run to run.
//
// Interface: plain C entry points bound with ctypes; each launches on the
// caller's stream and returns cudaGetLastError().

#include <algorithm>
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // f32 kernels: thread (tr, tc): tr = tid / 8, tc = tid % 8

// the f32 kernels' tiling: a TILE-row tile of q or k, thread (tr, tc) owns
// rows tr + 32 i, score columns tc + 8 j and head-dim columns tc + 8 j
template <int HD, int TILE>
struct F32Tiles {
  static constexpr int kRows = TILE / 32;  // tile rows per thread
  static constexpr int kCols = TILE / 8;   // score columns per thread
  static constexpr int kDCols = HD / 8;    // head-dim columns per thread
  static constexpr int kLD = HD + 1;       // row stride of a [TILE, hd] f32 tile (no bank conflicts)
  static constexpr int kLDP = TILE + 1;    // row stride of a [TILE, TILE] f32 tile
  static constexpr int kTileFloats = TILE * kLD;
  static constexpr int kSqFloats = TILE * kLDP;
  static constexpr int kFwdSmem = (3 * kTileFloats + kSqFloats) * 4;
  static constexpr int kDqSmem = (4 * kTileFloats + kSqFloats) * 4;
  static constexpr int kDkvSmem = (4 * kTileFloats + 2 * kSqFloats) * 4;
};

// 64-row f32 tiles at hd 128; 32 at hd 256 (64 rows would need 279,808 B
// for dq and 296,448 B for dk/dv)
template <int HD>
constexpr int f32_tile() {
  return HD <= 128 ? 64 : 32;
}

// the CUDA-core kernels are instantiated for float only (bf16 runs on the
// tensor-core kernels of namespace tc)
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// the 8 lanes of one thread row (tc = 0..7) are neighbours in a warp
__device__ __forceinline__ float row8_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float row8_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// may query i (segment sq) attend key j (segment sk)?  Without branches:
// code between a wgmma and its wait must have none, or ptxas serializes the
// products
__device__ __forceinline__ bool allowed(int sq, int sk, int i, int j, int window) {
  return (sq >= 0) & (sq == sk) & (j <= i) & ((window <= 0) | (j > i - window));
}

// the score after the dot product: softcap (t = tanh(raw / c) kept for the
// backward's 1 - t^2) or the raw dot
__device__ __forceinline__ float capped(float raw, float softcap, float* t) {
  if (softcap > 0.f) {
    *t = tanhf(raw / softcap);
    return *t * softcap;
  }
  *t = 0.f;
  return raw;
}

// rows [r0, r0 + TILE) of head h of a [B, T, H, hd] tensor -> f32 tile
// (rows outside [0, T) read as zero)
template <typename T, int HD, int TILE>
__device__ void load_tile(float* dst, const T* __restrict__ src, int b, int r0, int Tn,
                          int H, int h) {
  constexpr int kLD = HD + 1;
  for (int idx = threadIdx.x; idx < TILE * HD; idx += kThreads) {
    const int r = idx / HD, d = idx - r * HD;
    const int t = r0 + r;
    dst[r * kLD + d] =
        (t >= 0 && t < Tn) ? to_f(src[(((long long)b * Tn + t) * H + h) * HD + d]) : 0.f;
  }
}

// segment ids of rows [r0, r0 + TILE) (-2 past T: matches nothing) and the
// first / last tile row holding a valid (>= 0) id; first > last if none
template <int TILE>
__device__ void tile_span(const int* __restrict__ segb, int r0, int Tn, int* seg_tile,
                          int* s_first, int* s_last) {
  if (threadIdx.x == 0) {
    *s_first = TILE;
    *s_last = -1;
  }
  if (threadIdx.x < TILE) {
    const int t = r0 + threadIdx.x;
    seg_tile[threadIdx.x] = t < Tn ? segb[t] : -2;
  }
  __syncthreads();
  if (threadIdx.x < TILE && seg_tile[threadIdx.x] >= 0) {
    atomicMin(s_first, (int)threadIdx.x);
    atomicMax(s_last, (int)threadIdx.x);
  }
  __syncthreads();
}

// first index of the (contiguous) segment that holds position i
__device__ int segment_start(const int* __restrict__ segb, int i, int* s_out) {
  const int s = segb[i];
  if (threadIdx.x == 0) *s_out = 0;
  __syncthreads();
  for (int base = i - 1; base >= 0; base -= (int)blockDim.x) {
    const int j = base - (int)threadIdx.x;
    const bool hit = j >= 0 && segb[j] != s;
    if (hit) atomicMax(s_out, j + 1);
    if (__syncthreads_or(hit)) break;
  }
  __syncthreads();
  return *s_out;
}

// one past the last index of the (contiguous) segment that holds position i
__device__ int segment_end(const int* __restrict__ segb, int i, int Tn, int* s_out) {
  const int s = segb[i];
  if (threadIdx.x == 0) *s_out = Tn;
  __syncthreads();
  for (int base = i + 1; base < Tn; base += (int)blockDim.x) {
    const int j = base + (int)threadIdx.x;
    const bool hit = j < Tn && segb[j] != s;
    if (hit) atomicMin(s_out, j);
    if (__syncthreads_or(hit)) break;
  }
  __syncthreads();
  return *s_out;
}

// acc[i][j] = sum_d A[tr + 32 i][d] * Bm[tc + 8 j][d] over two f32 tiles
template <int HD, int TILE>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm, int tr, int tc,
                                         float acc[F32Tiles<HD, TILE>::kRows]
                                                  [F32Tiles<HD, TILE>::kCols]) {
  using C = F32Tiles<HD, TILE>;
#pragma unroll
  for (int i = 0; i < C::kRows; ++i)
#pragma unroll
    for (int j = 0; j < C::kCols; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[C::kRows], bb[C::kCols];
#pragma unroll
    for (int i = 0; i < C::kRows; ++i) a[i] = A[(tr + 32 * i) * C::kLD + d];
#pragma unroll
    for (int j = 0; j < C::kCols; ++j) bb[j] = Bm[(tc + 8 * j) * C::kLD + d];
#pragma unroll
    for (int i = 0; i < C::kRows; ++i)
#pragma unroll
      for (int j = 0; j < C::kCols; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c P[tr + 32 i][c] * M[c][tc + 8 j]: a [TILE, TILE]
// square tile times a [TILE, hd] tile
template <int HD, int TILE>
__device__ __forceinline__ void tile_pv(const float* P, const float* M, int tr, int tc,
                                        float acc[F32Tiles<HD, TILE>::kRows]
                                                 [F32Tiles<HD, TILE>::kDCols]) {
  using C = F32Tiles<HD, TILE>;
#pragma unroll 4
  for (int c = 0; c < TILE; ++c) {
    float p[C::kRows], m[C::kDCols];
#pragma unroll
    for (int i = 0; i < C::kRows; ++i) p[i] = P[(tr + 32 * i) * C::kLDP + c];
#pragma unroll
    for (int j = 0; j < C::kDCols; ++j) m[j] = M[c * C::kLD + tc + 8 * j];
#pragma unroll
    for (int i = 0; i < C::kRows; ++i)
#pragma unroll
      for (int j = 0; j < C::kDCols; ++j) acc[i][j] = fmaf(p[i], m[j], acc[i][j]);
  }
}

// write a thread's row and head-dim slice of rows [r0, r0 + TILE) of head h
template <typename T, int HD, int TILE>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           const float acc[F32Tiles<HD, TILE>::kRows]
                                                          [F32Tiles<HD, TILE>::kDCols],
                                           int b, int r0, int Tn, int H, int h, int tr,
                                           int tc) {
  using C = F32Tiles<HD, TILE>;
#pragma unroll
  for (int i = 0; i < C::kRows; ++i) {
    const int t = r0 + tr + 32 * i;
    if (t >= Tn) continue;
    T* row = dst + (((long long)b * Tn + t) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < C::kDCols; ++j) row[tc + 8 * j] = from_f<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// forward: out and lse
// ---------------------------------------------------------------------------

template <typename T, int HD, int TILE>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ segq, const int* __restrict__ segk, T* __restrict__ out,
    float* __restrict__ lse, int q_start, int Tq, int Tk, int Hq, int Hkv, float softcap,
    int window) {
  using C = F32Tiles<HD, TILE>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + C::kTileFloats;
  float* Vs = Ks + C::kTileFloats;
  float* Ps = Vs + C::kTileFloats;
  __shared__ int seg_q[TILE], seg_k[TILE];
  __shared__ int s_first, s_last, s_lo;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * TILE;  // i0: local query
  const int kh = h / (Hq / Hkv);
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
  const int* segqb = segq + (long long)b * Tq;
  const int* segkb = segk + (long long)b * Tk;

  float m[C::kRows], l[C::kRows], o[C::kRows][C::kDCols];
#pragma unroll
  for (int i = 0; i < C::kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < C::kDCols; ++j) o[i][j] = 0.f;
  }

  tile_span<TILE>(segqb, i0, Tq, seg_q, &s_first, &s_last);
  const int first = s_first, last = s_last;
  if (first <= last) {
    const int i_first = q_start + i0 + first;  // global positions from here on
    int lo = segment_start(segkb, i_first, &s_lo);
    if (window > 0) lo = max(lo, i_first - window + 1);
    const int hi = q_start + i0 + last + 1;
    load_tile<T, HD, TILE>(Qs, q, b, i0, Tq, Hq, h);
    for (int j0 = lo; j0 < hi; j0 += TILE) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, HD, TILE>(Ks, k, b, j0, Tk, Hkv, kh);
      load_tile<T, HD, TILE>(Vs, v, b, j0, Tk, Hkv, kh);
      if (threadIdx.x < TILE) {
        const int t = j0 + threadIdx.x;
        seg_k[threadIdx.x] = t < Tk ? segkb[t] : -2;
      }
      __syncthreads();
      float s[C::kRows][C::kCols];
      tile_dot<HD, TILE>(Qs, Ks, tr, tc, s);
#pragma unroll
      for (int i = 0; i < C::kRows; ++i) {
        const int r = tr + 32 * i, qi = q_start + i0 + r, sq = seg_q[r];
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < C::kCols; ++j) {
          const int c = tc + 8 * j;
          float t;
          const float x = capped(s[i][j], softcap, &t);
          s[i][j] = allowed(sq, seg_k[c], qi, j0 + c, window) ? x : -INFINITY;
          mx = fmaxf(mx, s[i][j]);
        }
        mx = row8_max(mx);
        const float m_new = fmaxf(m[i], mx);
        const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < C::kCols; ++j) {
          const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
          Ps[r * C::kLDP + tc + 8 * j] = p;
          sum += p;
        }
        l[i] = l[i] * alpha + row8_sum(sum);
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < C::kDCols; ++j) o[i][j] *= alpha;
      }
      __syncthreads();
      tile_pv<HD, TILE>(Ps, Vs, tr, tc, o);
    }
  }
#pragma unroll
  for (int i = 0; i < C::kRows; ++i) {
    const int qi = i0 + tr + 32 * i;  // local
#pragma unroll
    for (int j = 0; j < C::kDCols; ++j) o[i][j] = l[i] > 0.f ? o[i][j] / l[i] : 0.f;
    if (tc == 0 && qi < Tq)
      lse[((long long)b * Hq + h) * Tq + qi] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
  store_rows<T, HD, TILE>(out, o, b, i0, Tq, Hq, h, tr, tc);
}

// ---------------------------------------------------------------------------
// dq: sum over keys of dS k, dS = P * (dP - di) (times 1 - t^2 under softcap)
// ---------------------------------------------------------------------------

template <typename T, int HD, int TILE>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ segq, const int* __restrict__ segk, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di, T* __restrict__ dq,
    int q_start, int Tq, int Tk, int Hq, int Hkv, float softcap, int window) {
  using C = F32Tiles<HD, TILE>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + C::kTileFloats;
  float* Ks = dOs + C::kTileFloats;
  float* Vs = Ks + C::kTileFloats;
  float* dSs = Vs + C::kTileFloats;
  __shared__ int seg_q[TILE], seg_k[TILE];
  __shared__ int s_first, s_last, s_lo;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * TILE;  // i0: local query
  const int kh = h / (Hq / Hkv);
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
  const int* segqb = segq + (long long)b * Tq;
  const int* segkb = segk + (long long)b * Tk;

  float acc[C::kRows][C::kDCols];
#pragma unroll
  for (int i = 0; i < C::kRows; ++i)
#pragma unroll
    for (int j = 0; j < C::kDCols; ++j) acc[i][j] = 0.f;

  tile_span<TILE>(segqb, i0, Tq, seg_q, &s_first, &s_last);
  const int first = s_first, last = s_last;
  if (first <= last) {
    const int i_first = q_start + i0 + first;  // global positions from here on
    int lo = segment_start(segkb, i_first, &s_lo);
    if (window > 0) lo = max(lo, i_first - window + 1);
    const int hi = q_start + i0 + last + 1;
    load_tile<T, HD, TILE>(Qs, q, b, i0, Tq, Hq, h);
    load_tile<T, HD, TILE>(dOs, dout, b, i0, Tq, Hq, h);
    float lse_r[C::kRows], di_r[C::kRows];
#pragma unroll
    for (int i = 0; i < C::kRows; ++i) {
      const int qi = min(i0 + tr + 32 * i, Tq - 1);  // local
      lse_r[i] = lse[((long long)b * Hq + h) * Tq + qi];
      di_r[i] = di[((long long)b * Hq + h) * Tq + qi];
    }
    for (int j0 = lo; j0 < hi; j0 += TILE) {
      __syncthreads();
      load_tile<T, HD, TILE>(Ks, k, b, j0, Tk, Hkv, kh);
      load_tile<T, HD, TILE>(Vs, v, b, j0, Tk, Hkv, kh);
      if (threadIdx.x < TILE) {
        const int t = j0 + threadIdx.x;
        seg_k[threadIdx.x] = t < Tk ? segkb[t] : -2;
      }
      __syncthreads();
      float s[C::kRows][C::kCols], dp[C::kRows][C::kCols];
      tile_dot<HD, TILE>(Qs, Ks, tr, tc, s);
      tile_dot<HD, TILE>(dOs, Vs, tr, tc, dp);
#pragma unroll
      for (int i = 0; i < C::kRows; ++i) {
        const int r = tr + 32 * i, qi = q_start + i0 + r, sq = seg_q[r];
#pragma unroll
        for (int j = 0; j < C::kCols; ++j) {
          const int c = tc + 8 * j;
          float t;
          const float x = capped(s[i][j], softcap, &t);
          const bool ok = allowed(sq, seg_k[c], qi, j0 + c, window);
          const float p = ok ? expf(x - lse_r[i]) : 0.f;
          float ds = p * (dp[i][j] - di_r[i]);
          if (softcap > 0.f) ds *= 1.f - t * t;
          dSs[r * C::kLDP + c] = ds;
        }
      }
      __syncthreads();
      tile_pv<HD, TILE>(dSs, Ks, tr, tc, acc);
    }
  }
  store_rows<T, HD, TILE>(dq, acc, b, i0, Tq, Hq, h, tr, tc);
}

// ---------------------------------------------------------------------------
// dk / dv: per key tile, summed over the group's q heads and the q tiles
// that see it
// ---------------------------------------------------------------------------

template <typename T, int HD, int TILE>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ segq, const int* __restrict__ segk, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di, T* __restrict__ dk,
    T* __restrict__ dv, int q_start, int Tq, int Tk, int Hq, int Hkv, float softcap,
    int window) {
  using C = F32Tiles<HD, TILE>;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + C::kTileFloats;
  float* Qs = Vs + C::kTileFloats;
  float* dOs = Qs + C::kTileFloats;
  float* Ps = dOs + C::kTileFloats;
  float* dSs = Ps + C::kSqFloats;
  __shared__ int seg_q[TILE], seg_k[TILE];
  __shared__ float lse_q[TILE], di_q[TILE];
  __shared__ int s_first, s_last, s_hi;
  const int b = blockIdx.z, kh = blockIdx.y, j0 = blockIdx.x * TILE;
  const int group = Hq / Hkv;
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
  const int* segqb = segq + (long long)b * Tq;
  const int* segkb = segk + (long long)b * Tk;

  float dk_acc[C::kRows][C::kDCols], dv_acc[C::kRows][C::kDCols];
#pragma unroll
  for (int i = 0; i < C::kRows; ++i)
#pragma unroll
    for (int j = 0; j < C::kDCols; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  tile_span<TILE>(segkb, j0, Tk, seg_k, &s_first, &s_last);
  const int first = s_first, last = s_last;
  if (first <= last) {
    const int j_last = j0 + last;
    int lo = j0 + first;  // causal: a query sees only keys at or before it
    int hi = segment_end(segkb, j_last, Tk, &s_hi);
    if (window > 0) hi = min(hi, j_last + window);
    // the shard's queries among them, as local rows [lo, hi)
    lo = max(lo, q_start) - q_start;
    hi = min(hi, q_start + Tq) - q_start;
    if (lo < hi) {
      load_tile<T, HD, TILE>(Ks, k, b, j0, Tk, Hkv, kh);
      load_tile<T, HD, TILE>(Vs, v, b, j0, Tk, Hkv, kh);
    }
    for (int g = 0; g < group && lo < hi; ++g) {
      const int h = kh * group + g;
      const float* lse_h = lse + ((long long)b * Hq + h) * Tq;
      const float* di_h = di + ((long long)b * Hq + h) * Tq;
      for (int i0 = lo; i0 < hi; i0 += TILE) {
        __syncthreads();  // the previous q tile's readers are done
        load_tile<T, HD, TILE>(Qs, q, b, i0, Tq, Hq, h);
        load_tile<T, HD, TILE>(dOs, dout, b, i0, Tq, Hq, h);
        if (threadIdx.x < TILE) {
          const int t = i0 + threadIdx.x;
          seg_q[threadIdx.x] = t < Tq ? segqb[t] : -2;
          lse_q[threadIdx.x] = t < Tq ? lse_h[t] : 0.f;
          di_q[threadIdx.x] = t < Tq ? di_h[t] : 0.f;
        }
        __syncthreads();
        float st[C::kRows][C::kCols], dpt[C::kRows][C::kCols];  // rows: keys, columns: queries
        tile_dot<HD, TILE>(Ks, Qs, tr, tc, st);
        tile_dot<HD, TILE>(Vs, dOs, tr, tc, dpt);
#pragma unroll
        for (int i = 0; i < C::kRows; ++i) {
          const int r = tr + 32 * i, kj = j0 + r, sk = seg_k[r];
#pragma unroll
          for (int j = 0; j < C::kCols; ++j) {
            const int c = tc + 8 * j;
            float t;
            const float x = capped(st[i][j], softcap, &t);
            const bool ok = allowed(seg_q[c], sk, q_start + i0 + c, kj, window);
            const float p = ok ? expf(x - lse_q[c]) : 0.f;
            float ds = p * (dpt[i][j] - di_q[c]);
            if (softcap > 0.f) ds *= 1.f - t * t;
            Ps[r * C::kLDP + c] = p;
            dSs[r * C::kLDP + c] = ds;
          }
        }
        __syncthreads();
        tile_pv<HD, TILE>(Ps, dOs, tr, tc, dv_acc);
        tile_pv<HD, TILE>(dSs, Qs, tr, tc, dk_acc);
      }
    }
  }
  store_rows<T, HD, TILE>(dk, dk_acc, b, j0, Tk, Hkv, kh, tr, tc);
  store_rows<T, HD, TILE>(dv, dv_acc, b, j0, Tk, Hkv, kh, tr, tc);
}

namespace tc {

namespace cg = cooperative_groups;

constexpr int kBr = 64;        // q rows per block (keys per dk/dv block)
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tiles {
  static constexpr int kLDS = HD + 8;        // bf16 row stride in shared memory
  static constexpr int kChunks = HD / 8;     // 16-byte chunks in a row
  static constexpr int kBc = 64;             // keys per tile of the forward and dq
  static constexpr int kTileQ = kBr * kLDS;  // elements of a 64-row tile
  static constexpr int kTileK = kBc * kLDS;  // elements of a key tile
  // dq: Q, dO, K x 2, V x 2 (104,448 B): twice an SM
  static constexpr int kDqSmem = (2 * kTileQ + 4 * kTileK) * 2;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float c[4], const unsigned a[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// rows [r0, r0 + ROWS) of head h of a [B, T, H, hd] bf16 tensor -> padded
// shared tile, by cp.async from NT threads (rows outside [0, T) become
// zeros)
template <int HD, int ROWS, int NT = kThreads>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* __restrict__ src, int b,
                                                int r0, int Tn, int H, int h) {
  using C = Tiles<HD>;
  for (int i = threadIdx.x; i < ROWS * C::kChunks; i += NT) {
    const int r = i / C::kChunks, c = (i % C::kChunks) * 8;
    const int t = r0 + r;
    const bool ok = t >= 0 && t < Tn;
    const __nv_bfloat16* p = ok ? src + (((long long)b * Tn + t) * H + h) * HD + c : src;
    cp_async16(dst + r * C::kLDS + c, p, ok ? 16 : 0);
  }
}

// ldmatrix addresses in a padded [rows][LDS] tile.  A operand: rows
// [r0, r0 + 16), columns [16 c, 16 c + 16); ldmatrix.trans from the same
// address gives the B operand of a [k][n] tile (k rows from r0, the n-tile
// pair at columns 16 c).
template <int LDS>
__device__ __forceinline__ const __nv_bfloat16* a_frag(const __nv_bfloat16* t, int r0, int c,
                                                       int lane) {
  return t + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDS + 16 * c + 8 * (lane >> 4);
}

// B operand of the n-tile pair (2 np, 2 np + 1) from an [n][k] tile (n rows
// [16 np, 16 np + 16), k columns [16 kk, 16 kk + 16)); r[0], r[1] feed n-tile
// 2 np and r[2], r[3] n-tile 2 np + 1
template <int LDS>
__device__ __forceinline__ const __nv_bfloat16* b_frag(const __nv_bfloat16* t, int np, int kk,
                                                       int lane) {
  return t + (16 * np + (lane & 7) + 8 * (lane >> 4)) * LDS + 16 * kk + 8 * ((lane >> 3) & 1);
}

// two 16 x 8 accumulator tiles (columns 0-7 and 8-15) -> one bf16 A fragment
__device__ __forceinline__ void pack_a(unsigned a[4], const float lo[4], const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// a warp's 16 rows x hd accumulators -> its rows of a padded bf16 tile
template <int HD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const float acc[HD / 8][4],
                                           int r, int tig, float s0 = 1.f, float s1 = 1.f) {
  constexpr int kLDS = Tiles<HD>::kLDS;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = 8 * j + 2 * tig;
    *reinterpret_cast<__nv_bfloat162*>(dst + r * kLDS + c) =
        __floats2bfloat162_rn(acc[j][0] * s0, acc[j][1] * s0);
    *reinterpret_cast<__nv_bfloat162*>(dst + (r + 8) * kLDS + c) =
        __floats2bfloat162_rn(acc[j][2] * s1, acc[j][3] * s1);
  }
}

// 64 rows of a padded bf16 tile -> rows [r0, r0 + 64) of head h of a
// [B, T, H, hd] tensor, in 16-byte stores by NT threads
template <int HD, int NT = kThreads>
__device__ __forceinline__ void store_tile(__nv_bfloat16* __restrict__ dst,
                                           const __nv_bfloat16* src, int b, int r0, int Tn,
                                           int H, int h) {
  using C = Tiles<HD>;
  for (int i = threadIdx.x; i < kBr * C::kChunks; i += NT) {
    const int r = i / C::kChunks, c = (i % C::kChunks) * 8;
    const int t = r0 + r;
    if (t < Tn)
      *reinterpret_cast<uint4*>(dst + (((long long)b * Tn + t) * H + h) * HD + c) =
          *reinterpret_cast<const uint4*>(src + r * C::kLDS + c);
  }
}

// ---------------------------------------------------------------------------
// backward on the bf16 tensor cores (bf16 inputs)
// ---------------------------------------------------------------------------
//
// FlashAttention-2's backward on the forward's mma.sync fragments.  P =
// exp(S - lse) comes from the forward's f32 lse (no running max), and dS =
// P * (dP - di), times 1 - t^2 under the softcap; both stay f32 on the
// accumulator fragments, masked as the forward masks S (tiles wholly inside
// one segment, below the diagonal, with no window, skip the mask).
//
// dq at hd 128 (hd 256 runs wg::flash_wg_kernel below): a block owns 64 q
// rows of one q head (4 warps x 16 rows; Q fragments in registers, dO
// re-read by ldmatrix at each key tile) and walks its key range in
// double-buffered cp.async K/V tiles of 64 keys: S = Q K^T and dP = dO V^T
// (K and V as non-transposed B fragments), then dQ += dS K with dS packed
// to bf16 A fragments and K read through ldmatrix.trans.  The last q tiles,
// whose key ranges are longest, start first.
//
// dk/dv at hd 128: a block owns 64 keys of one kv head (4 warps x 16
// keys).  K and V stay in shared memory for the whole block and their A
// fragments are re-read at every q tile, which keeps the 128 f32 dK/dV
// accumulators a thread holds in registers.  It walks (q head of the group,
// q tile of its range) with double-buffered cp.async Q/dO tiles and their
// lse, di and segment ids in shared memory, and takes each tile in two
// halves of 32 queries, so that S^T and dP^T add only 32 registers: S^T = K
// Q^T and dP^T = V dO^T (Q and dO as non-transposed B fragments), then dV
// += P^T dO and dK += dS^T Q with P^T and dS^T packed to bf16 A fragments
// and dO and Q read through ldmatrix.trans.  The first key tiles, whose
// query ranges are longest, start first.  No atomics.
//
// dk/dv at hd 256 (flash_bwd_dkv_tc256_kernel): the same walk with 8 warps
// in two groups over the block's 64 keys (16 a warp in each group).  Group
// 0 computes S^T and P^T and accumulates dV; group 1 computes dP^T, reads
// P^T (1 - t^2) from shared memory, forms dS^T and accumulates dK.  Each
// thread holds 128 accumulators, as at hd 128.  Its 219 KB of shared memory
// (K, V, two stages of 64 q and dO rows) hold one block per SM, and one
// block per key tile walking every q head of the group left Gemma-2B's
// MQA on 8 rows of 1024 with 128 blocks for 132 SMs, each walking 8 heads
// one after another, the first key tile of a segment longest.  So a key
// tile takes a thread block cluster of S blocks (ops/flash_attention.py
// dkv_plan: S a power of two dividing the group, at most 8, picked so that
// a block walks at most 4 heads and the grid has about two blocks per SM):
// rank s walks heads [s group / S, (s + 1) group / S).  After the walk each
// block leaves its f32 dV and dK partials in place of its q / dO stages,
// and rank s sums rows [64 s / S, 64 (s + 1) / S) of both over the ranks in
// rank order through distributed shared memory, rounds once and stores: no
// scratch in device memory and no atomics, and S = 1 is the unsplit grid.
// The P^T hand-over takes one buffer per half tile and a named barrier
// (bar.arrive by group 0, bar.sync by group 1) in place of two block-wide
// barriers a half, so the groups drift by up to a half within a tile.
// Kept: the dV / dK split into two warp groups (one block of 8 warps, 128
// accumulators a thread; 64 keys x 256 x 2 f32 accumulators are half an
// SM's registers, so two such blocks cannot share an SM) and the
// double-buffered 64-row q / dO stages.  What bounds it now is shared
// memory: every warp of a group re-reads the same Q and dO fragments with
// ldmatrix, about 2.5 cycles of shared-memory bandwidth per mma.sync;
// wgmma, which reads B from shared memory once a warpgroup, is the step
// after this one.
//
// Rounding: P (for dV) and dS (for dK and dQ) are rounded to bf16 before
// those products (the tensor cores take bf16), where splash and the plain
// versions keep them in f32; lse and di stay f32.

template <int HD>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ segq,
    const int* __restrict__ segk, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    __nv_bfloat16* __restrict__ dq, int q_start, int Tq, int Tk, int Hq, int Hkv,
    float softcap, int window) {
  static_assert(HD == 128, "hd 256 runs wg::flash_wg_kernel");
  using C = Tiles<HD>;
  constexpr int kBc = C::kBc, kLDS = C::kLDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + C::kTileQ;
  __nv_bfloat16* sK = sdO + C::kTileQ;      // two stages
  __nv_bfloat16* sV = sK + 2 * C::kTileK;   // two stages
  __shared__ int seg_q[kBr], seg_k[2][kBc];
  __shared__ int s_first, s_last, s_lo;
  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kBr;  // local; longest key ranges first
  const int kh = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int* segqb = segq + (long long)b * Tq;
  const int* segkb = segk + (long long)b * Tk;

  float acc[HD / 8][4];  // n-tiles of d
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  tile_span<kBr>(segqb, i0, Tq, seg_q, &s_first, &s_last);
  const int first = s_first, last = s_last;
  const int rq = warp * 16 + g;  // this thread's rows: rq and rq + 8
  if (first <= last) {
    const int i_first = q_start + i0 + first;  // global positions from here on
    int lo = segment_start(segkb, i_first, &s_lo);
    if (window > 0) lo = max(lo, i_first - window + 1);
    const int hi = q_start + i0 + last + 1;
    const int ntiles = (hi - lo + kBc - 1) / kBc;
    const int q_uniform = __syncthreads_and(tid >= kBr || seg_q[tid] == seg_q[0]) ? seg_q[0]
                                                                                  : -3;
    const int sq[2] = {seg_q[rq], seg_q[rq + 8]};
    const int qi[2] = {q_start + i0 + rq, q_start + i0 + rq + 8};
    float lse_r[2], di_r[2];
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const long long at = ((long long)b * Hq + h) * Tq + min(i0 + rq + 8 * row, Tq - 1);
      lse_r[row] = lse[at];
      di_r[row] = di[at];
    }

    load_tile_async<HD, kBr>(sQ, q, b, i0, Tq, Hq, h);
    load_tile_async<HD, kBr>(sdO, dout, b, i0, Tq, Hq, h);
    load_tile_async<HD, kBc>(sK, k, b, lo, Tk, Hkv, kh);
    load_tile_async<HD, kBc>(sV, v, b, lo, Tk, Hkv, kh);
    asm volatile("cp.async.commit_group;\n" ::);
    if (tid < kBc) seg_k[0][tid] = lo + tid < Tk ? segkb[lo + tid] : -2;

    unsigned qf[HD / 16][4];
    for (int n = 0; n < ntiles; ++n) {
      const int buf = n & 1, j0 = lo + n * kBc;
      if (n + 1 < ntiles) {  // prefetch the next tile into the other stage
        const int j1 = j0 + kBc;
        load_tile_async<HD, kBc>(sK + (buf ^ 1) * C::kTileK, k, b, j1, Tk, Hkv, kh);
        load_tile_async<HD, kBc>(sV + (buf ^ 1) * C::kTileK, v, b, j1, Tk, Hkv, kh);
        if (tid < kBc) seg_k[buf ^ 1][tid] = j1 + tid < Tk ? segkb[j1 + tid] : -2;
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);  // this tile (and Q, dO) landed
      const bool full = __syncthreads_and(tid >= kBc || seg_k[buf][tid] == q_uniform) &&
                        q_uniform >= 0 && window <= 0 && j0 + kBc - 1 <= q_start + i0;
      if (n == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          ldmatrix_x4(qf[kk], a_frag<kLDS>(sQ, warp * 16, kk, lane));
      }
      const __nv_bfloat16* tK = sK + buf * C::kTileK;
      const __nv_bfloat16* tV = sV + buf * C::kTileK;

      // S = Q K^T and dP = dO V^T: n-tiles of 8 keys each
      float s[kBc / 8][4], dp[kBc / 8][4];
#pragma unroll
      for (int j = 0; j < kBc / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        unsigned da[4];
        ldmatrix_x4(da, a_frag<kLDS>(sdO, warp * 16, kk, lane));
#pragma unroll
        for (int np = 0; np < kBc / 16; ++np) {
          unsigned r[4];
          ldmatrix_x4(r, b_frag<kLDS>(tK, np, kk, lane));
          mma(s[2 * np], qf[kk], r[0], r[1]);
          mma(s[2 * np + 1], qf[kk], r[2], r[3]);
          ldmatrix_x4(r, b_frag<kLDS>(tV, np, kk, lane));
          mma(dp[2 * np], da, r[0], r[1]);
          mma(dp[2 * np + 1], da, r[2], r[3]);
        }
      }

      // dS on the fragments (rows: queries, columns: keys), into s
#pragma unroll
      for (int j = 0; j < kBc / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e >> 1, col = 8 * j + 2 * tig + (e & 1);
          float x = s[j][e], t = 0.f;
          if (softcap > 0.f) {
            t = tanhf(x / softcap);
            x = t * softcap;
          }
          const bool ok =
              full || allowed(sq[row], seg_k[buf][col], qi[row], j0 + col, window);
          float ds = ok ? exp2f((x - lse_r[row]) * kLog2e) * (dp[j][e] - di_r[row]) : 0.f;
          if (softcap > 0.f) ds *= 1.f - t * t;
          s[j][e] = ds;
        }
      }

      // dQ += dS K: dS as bf16 A fragments, K through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < kBc / 16; ++kk) {
        unsigned a[4];
        pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int c = 0; c < HD / 16; ++c) {
          unsigned r[4];
          ldmatrix_x4_trans(r, a_frag<kLDS>(tK, 16 * kk, c, lane));
          mma(acc[2 * c], a, r[0], r[1]);
          mma(acc[2 * c + 1], a, r[2], r[3]);
        }
      }
      __syncthreads();  // this stage's readers are done before it is refilled
    }
    asm volatile("cp.async.wait_all;\n" ::);
  }

  // dq through shared memory: each warp writes its own rows of sQ, which
  // only that warp read
  stage_rows<HD>(sQ, acc, rq, tig);
  __syncthreads();
  store_tile<HD>(dq, sQ, b, i0, Tq, Hq, h);
}

__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dkv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ segq,
    const int* __restrict__ segk, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int q_start, int Tq,
    int Tk, int Hq, int Hkv, float softcap, int window) {
  constexpr int HD = 128, kBc = kBr, kLDS = Tiles<HD>::kLDS, kTile = Tiles<HD>::kTileQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kTile;
  __nv_bfloat16* sQ = sV + kTile;       // two stages
  __nv_bfloat16* sdO = sQ + 2 * kTile;  // two stages
  __shared__ int seg_k[kBc], seg_q[2][kBr];
  __shared__ float lse_q[2][kBr], di_q[2][kBr];
  __shared__ int s_first, s_last, s_hi;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int j0 = blockIdx.z * kBc;  // the first key tiles, longest query ranges, first
  const int group = Hq / Hkv, h_lo = kh * group;  // the group's q heads
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int* segqb = segq + (long long)b * Tq;
  const int* segkb = segk + (long long)b * Tk;

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  tile_span<kBc>(segkb, j0, Tk, seg_k, &s_first, &s_last);
  const int first = s_first, last = s_last;
  const int rk = warp * 16 + g;  // this thread's keys: rk and rk + 8
  int lo = 0, hi = 0;  // the shard's queries that see these keys: local rows [lo, hi)
  if (first <= last) {
    const int j_last = j0 + last;
    lo = max(j0 + first, q_start) - q_start;  // causal: a query sees only keys at or before it
    hi = segment_end(segkb, j_last, Tk, &s_hi);
    if (window > 0) hi = min(hi, j_last + window);
    hi = min(hi, q_start + Tq) - q_start;
  }
  if (lo < hi) {
    const int ntiles = (hi - lo + kBr - 1) / kBr;
    const int total = group * ntiles;  // (q head, q tile) steps
    // one segment id over all 64 keys, or -3
    const int k_uniform = __syncthreads_and(tid >= kBc || seg_k[tid] == seg_k[0]) ? seg_k[0]
                                                                                  : -3;
    const int sk[2] = {seg_k[rk], seg_k[rk + 8]};
    const int kj[2] = {j0 + rk, j0 + rk + 8};

    // step n's Q and dO tiles by cp.async, its segment ids, lse and di by
    // plain loads, into stage `buf`
    auto stage = [&](int n, int buf) {
      const int h = h_lo + n / ntiles, i0 = lo + (n % ntiles) * kBr;  // local
      load_tile_async<HD, kBr>(sQ + buf * kTile, q, b, i0, Tq, Hq, h);
      load_tile_async<HD, kBr>(sdO + buf * kTile, dout, b, i0, Tq, Hq, h);
      if (tid < kBr) {
        const int t = i0 + tid;
        const long long at = ((long long)b * Hq + h) * Tq + t;
        seg_q[buf][tid] = t < Tq ? segqb[t] : -2;
        lse_q[buf][tid] = t < Tq ? lse[at] : 0.f;
        di_q[buf][tid] = t < Tq ? di[at] : 0.f;
      }
    };
    load_tile_async<HD, kBc>(sK, k, b, j0, Tk, Hkv, kh);
    load_tile_async<HD, kBc>(sV, v, b, j0, Tk, Hkv, kh);
    stage(0, 0);
    asm volatile("cp.async.commit_group;\n" ::);

    for (int n = 0; n < total; ++n) {
      const int buf = n & 1, i0 = lo + (n % ntiles) * kBr;
      if (n + 1 < total) stage(n + 1, buf ^ 1);  // prefetch into the other stage
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);  // this step (and K, V) landed
      const bool full = __syncthreads_and(tid >= kBr || seg_q[buf][tid] == k_uniform) &&
                        k_uniform >= 0 && window <= 0 && q_start + i0 >= j0 + kBc - 1;
      const __nv_bfloat16* tQ = sQ + buf * kTile;
      const __nv_bfloat16* tdO = sdO + buf * kTile;
      const int* seg_t = seg_q[buf];
      const float* lse_t = lse_q[buf];
      const float* di_t = di_q[buf];

      // the tile in two halves of 32 queries: S^T and dP^T of a half take
      // 32 registers beside the 128 of dK and dV
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        const int c0 = 32 * half;  // the half's first query in the tile

        // S^T = K Q^T and dP^T = V dO^T: rows are keys, 4 n-tiles of 8 queries
        float st[4][4], dpt[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          unsigned ka[4], va[4];
          ldmatrix_x4(ka, a_frag<kLDS>(sK, warp * 16, kk, lane));
          ldmatrix_x4(va, a_frag<kLDS>(sV, warp * 16, kk, lane));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            unsigned r[4];
            ldmatrix_x4(r, b_frag<kLDS>(tQ, 2 * half + np, kk, lane));
            mma(st[2 * np], ka, r[0], r[1]);
            mma(st[2 * np + 1], ka, r[2], r[3]);
            ldmatrix_x4(r, b_frag<kLDS>(tdO, 2 * half + np, kk, lane));
            mma(dpt[2 * np], va, r[0], r[1]);
            mma(dpt[2 * np + 1], va, r[2], r[3]);
          }
        }

        // P^T into st and dS^T into dpt, on the fragments
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e >> 1, col = c0 + 8 * j + 2 * tig + (e & 1);
            float x = st[j][e], t = 0.f;
            if (softcap > 0.f) {
              t = tanhf(x / softcap);
              x = t * softcap;
            }
            const bool ok =
                full || allowed(seg_t[col], sk[row], q_start + i0 + col, kj[row], window);
            const float p = ok ? exp2f((x - lse_t[col]) * kLog2e) : 0.f;
            float ds = p * (dpt[j][e] - di_t[col]);
            if (softcap > 0.f) ds *= 1.f - t * t;
            st[j][e] = p;
            dpt[j][e] = ds;
          }
        }

        // dV += P^T dO and dK += dS^T Q: bf16 A fragments, dO and Q through
        // ldmatrix.trans
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          unsigned pa[4], sa[4];
          pack_a(pa, st[2 * kk], st[2 * kk + 1]);
          pack_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
          for (int c = 0; c < HD / 16; ++c) {
            unsigned r[4];
            ldmatrix_x4_trans(r, a_frag<kLDS>(tdO, c0 + 16 * kk, c, lane));
            mma(dv_acc[2 * c], pa, r[0], r[1]);
            mma(dv_acc[2 * c + 1], pa, r[2], r[3]);
            ldmatrix_x4_trans(r, a_frag<kLDS>(tQ, c0 + 16 * kk, c, lane));
            mma(dk_acc[2 * c], sa, r[0], r[1]);
            mma(dk_acc[2 * c + 1], sa, r[2], r[3]);
          }
        }
      }
      __syncthreads();  // this stage's readers are done before it is refilled
    }
    asm volatile("cp.async.wait_all;\n" ::);
  }

  // dk and dv through shared memory (the Q stages: every reader passed
  // the loop's last barrier), then out in 16-byte stores
  stage_rows<HD>(sQ, dk_acc, rk, tig);
  stage_rows<HD>(sQ + kTile, dv_acc, rk, tig);
  __syncthreads();
  store_tile<HD>(dk, sQ, b, j0, Tk, Hkv, kh);
  store_tile<HD>(dv, sQ + kTile, b, j0, Tk, Hkv, kh);
}

constexpr int kDkv256Threads = 256;  // two groups of 4 warps
constexpr int kXLD = 32;             // row stride of the P^T hand-over tile (floats)
constexpr int kMaxCluster = 8;       // blocks of a key tile's cluster: the portable size
constexpr int kPartLD = 256 + 4;     // row stride of an f32 dK / dV partial (floats)
// K, V, Q x 2, dO x 2 (64 rows each), then P^T of both halves of a q tile
constexpr int kDkv256Smem = 6 * Tiles<256>::kTileQ * 2 + 2 * kBr * kXLD * 4;
static_assert(2 * kBr * kPartLD * 4 <= 4 * Tiles<256>::kTileQ * 2,
              "the f32 partials fit the Q and dO stages");

// named barriers of the P^T hand-over, one per half of a q tile (0 is
// __syncthreads'): group 0 arrives, group 1 waits
__device__ __forceinline__ void handover_arrive(int half) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(1 + half), "r"(kDkv256Threads) : "memory");
}
__device__ __forceinline__ void handover_wait(int half) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + half), "r"(kDkv256Threads) : "memory");
}

// One block per (kv head, cluster rank, row, key tile); the cluster's
// `ranks` blocks share the key tile and split the group's q heads.
__global__ void __launch_bounds__(kDkv256Threads, 1) flash_bwd_dkv_tc256_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ segq,
    const int* __restrict__ segk, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int q_start, int Tq,
    int Tk, int Hq, int Hkv, float softcap, int window) {
  constexpr int HD = 256, kNT = kDkv256Threads, kLDS = Tiles<HD>::kLDS;
  constexpr int kTile = Tiles<HD>::kTileQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kTile;
  __nv_bfloat16* sQ = sV + kTile;       // two stages
  __nv_bfloat16* sdO = sQ + 2 * kTile;  // two stages
  float* xP = reinterpret_cast<float*>(sdO + 2 * kTile);  // [2 halves][64 keys][32 queries]
  float* part = reinterpret_cast<float*>(sQ);  // dV then dK partials, after the walk
  __shared__ int seg_k[kBr], seg_q[2][kBr];
  __shared__ float lse_q[2][kBr], di_q[2][kBr];
  __shared__ int s_first, s_last, s_hi;
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = cluster.num_blocks(), rank = blockIdx.x % ranks;
  const int kh = blockIdx.x / ranks, b = blockIdx.y;
  const int j0 = blockIdx.z * kBr;  // the first key tiles, longest query ranges, first
  const int group = Hq / Hkv, heads = group / ranks;
  const int h_lo = kh * group + rank * heads;  // this rank's q heads of the group
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;  // 0: S^T, P^T and dV; 1: dP^T, dS^T and dK
  const int g = lane >> 2, tig = lane & 3;
  const int* segqb = segq + (long long)b * Tq;
  const int* segkb = segk + (long long)b * Tk;

  float acc[HD / 8][4];  // dV (group 0) or dK (group 1): 16 keys x 256 a warp
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  tile_span<kBr>(segkb, j0, Tk, seg_k, &s_first, &s_last);
  const int first = s_first, last = s_last;
  const int r0 = (warp & 3) * 16;  // the warp's first key in the tile
  const int rk = r0 + g;           // this thread's keys: rk and rk + 8
  int lo = 0, hi = 0;  // the shard's queries that see these keys: local rows [lo, hi)
  if (first <= last) {
    const int j_last = j0 + last;
    lo = max(j0 + first, q_start) - q_start;  // causal: a query sees only keys at or before it
    hi = segment_end(segkb, j_last, Tk, &s_hi);
    if (window > 0) hi = min(hi, j_last + window);
    hi = min(hi, q_start + Tq) - q_start;
  }
  if (lo < hi) {
    const int ntiles = (hi - lo + kBr - 1) / kBr;
    const int total = heads * ntiles;  // (q head, q tile) steps of this rank
    const int k_uniform = __syncthreads_and(tid >= kBr || seg_k[tid] == seg_k[0]) ? seg_k[0]
                                                                                  : -3;
    const int sk[2] = {seg_k[rk], seg_k[rk + 8]};
    const int kj[2] = {j0 + rk, j0 + rk + 8};

    auto stage = [&](int n, int buf) {
      const int h = h_lo + n / ntiles, i0 = lo + (n % ntiles) * kBr;  // local
      load_tile_async<HD, kBr, kNT>(sQ + buf * kTile, q, b, i0, Tq, Hq, h);
      load_tile_async<HD, kBr, kNT>(sdO + buf * kTile, dout, b, i0, Tq, Hq, h);
      if (tid < kBr) {
        const int t = i0 + tid;
        const long long at = ((long long)b * Hq + h) * Tq + t;
        seg_q[buf][tid] = t < Tq ? segqb[t] : -2;
        lse_q[buf][tid] = t < Tq ? lse[at] : 0.f;
        di_q[buf][tid] = t < Tq ? di[at] : 0.f;
      }
    };
    load_tile_async<HD, kBr, kNT>(sK, k, b, j0, Tk, Hkv, kh);
    load_tile_async<HD, kBr, kNT>(sV, v, b, j0, Tk, Hkv, kh);
    stage(0, 0);
    asm volatile("cp.async.commit_group;\n" ::);

    // the group's A operand (rows: keys): K for S^T, V for dP^T
    const __nv_bfloat16* tA = wg == 0 ? sK : sV;
    for (int n = 0; n < total; ++n) {
      const int buf = n & 1, i0 = lo + (n % ntiles) * kBr;
      if (n + 1 < total) stage(n + 1, buf ^ 1);  // prefetch into the other stage
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);  // this step (and K, V) landed
      const bool full = __syncthreads_and(tid >= kBr || seg_q[buf][tid] == k_uniform) &&
                        k_uniform >= 0 && window <= 0 && q_start + i0 >= j0 + kBr - 1;
      const __nv_bfloat16* tQ = sQ + buf * kTile;
      const __nv_bfloat16* tdO = sdO + buf * kTile;
      const __nv_bfloat16* tB = wg == 0 ? tQ : tdO;  // S^T's or dP^T's queries
      const __nv_bfloat16* tM = wg == 0 ? tdO : tQ;  // dV's dO or dK's Q
      const int* seg_t = seg_q[buf];
      const float* lse_t = lse_q[buf];
      const float* di_t = di_q[buf];

#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        const int c0 = 32 * half;  // the half's first query in the tile
        float* xh = xP + half * kBr * kXLD;

        // S^T = K Q^T (group 0) or dP^T = V dO^T (group 1): rows are keys,
        // 4 n-tiles of 8 queries
        float x[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          unsigned a[4];
          ldmatrix_x4(a, a_frag<kLDS>(tA, r0, kk, lane));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            unsigned r[4];
            ldmatrix_x4(r, b_frag<kLDS>(tB, 2 * half + np, kk, lane));
            mma(x[2 * np], a, r[0], r[1]);
            mma(x[2 * np + 1], a, r[2], r[3]);
          }
        }

        if (wg == 0) {  // P^T on the fragments; P^T (1 - t^2) handed to group 1
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = e >> 1, col = 8 * j + 2 * tig + (e & 1), qc = c0 + col;
              float s = x[j][e], t = 0.f;
              if (softcap > 0.f) {
                t = tanhf(s / softcap);
                s = t * softcap;
              }
              const bool ok =
                  full || allowed(seg_t[qc], sk[row], q_start + i0 + qc, kj[row], window);
              const float p = ok ? exp2f((s - lse_t[qc]) * kLog2e) : 0.f;
              x[j][e] = p;
              xh[(rk + 8 * row) * kXLD + col] = softcap > 0.f ? p * (1.f - t * t) : p;
            }
          }
          handover_arrive(half);
        } else {  // dS^T = P^T (1 - t^2) (dP^T - di)
          handover_wait(half);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = e >> 1, col = 8 * j + 2 * tig + (e & 1);
              x[j][e] = xh[(rk + 8 * row) * kXLD + col] * (x[j][e] - di_t[c0 + col]);
            }
          }
        }

        // dV += P^T dO (group 0) or dK += dS^T Q (group 1): bf16 A
        // fragments, dO or Q through ldmatrix.trans
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          unsigned a[4];
          pack_a(a, x[2 * kk], x[2 * kk + 1]);
#pragma unroll
          for (int c = 0; c < HD / 16; ++c) {
            unsigned r[4];
            ldmatrix_x4_trans(r, a_frag<kLDS>(tM, c0 + 16 * kk, c, lane));
            mma(acc[2 * c], a, r[0], r[1]);
            mma(acc[2 * c + 1], a, r[2], r[3]);
          }
        }
      }
      __syncthreads();  // this stage and the hand-over tiles read before they are refilled
    }
    asm volatile("cp.async.wait_all;\n" ::);
  }

  // the ranks' f32 partials (dV, then dK, in place of the Q and dO stages,
  // which every reader passed at the walk's last barrier) summed over the
  // cluster in rank order through distributed shared memory: rank s rounds
  // and stores rows [s 64 / ranks, (s + 1) 64 / ranks) of both
  __syncthreads();
  float* mine = part + wg * kBr * kPartLD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = 8 * j + 2 * tig;
    *reinterpret_cast<float2*>(mine + rk * kPartLD + c) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(mine + (rk + 8) * kPartLD + c) =
        make_float2(acc[j][2], acc[j][3]);
  }
  cluster.sync();
  const int rows = kBr / ranks, row0 = rank * rows;
  for (int i = tid; i < 2 * rows * (HD / 4); i += kNT) {
    const int which = i / (rows * (HD / 4)), rest = i - which * rows * (HD / 4);
    const int r = row0 + rest / (HD / 4), d = 4 * (rest % (HD / 4));
    const int t = j0 + r;
    float4 x[kMaxCluster];  // every rank's loaded first: one remote latency, not one a rank
#pragma unroll
    for (int rr = 0; rr < kMaxCluster; ++rr)
      if (rr < ranks)
        x[rr] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part + (which * kBr + r) * kPartLD + d, rr));
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int rr = 0; rr < kMaxCluster; ++rr) {
      if (rr < ranks) {
        sum.x += x[rr].x;
        sum.y += x[rr].y;
        sum.z += x[rr].z;
        sum.w += x[rr].w;
      }
    }
    if (t < Tk) {
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
          (which == 0 ? dv : dk) + (((long long)b * Tk + t) * Hkv + kh) * HD + d);
      dst[0] = __floats2bfloat162_rn(sum.x, sum.y);
      dst[1] = __floats2bfloat162_rn(sum.z, sum.w);
    }
  }
  cluster.sync();  // no block leaves while another reads its partials
}

}  // namespace tc

// ---------------------------------------------------------------------------
// the forward at head dim 128 and 256 and dq at 256 on wgmma, fed by TMA
// (bf16 inputs)
// ---------------------------------------------------------------------------
//
// wg::flash_wg_kernel<false, CAP, HD> replaces splash's forward
// (splash_attention_kernel.py:1137) for bf16 at head dim 128 and 256, and
// wg::flash_wg_kernel<true, CAP, 256> its dq kernel (:1635,
// _splash_attention_bwd_dq) at 256.  The head dim is a template parameter:
// a tile is HD / 64 panels, O a 64 x HD accumulator.
//
// Bound on this card, on Gemma-2B's train rows (8 q heads on one kv head,
// 8 rows of 1024, 6,692 tokens; chip_smoke.py flash_bounds): bytes, 0.0203
// ms for the forward and 0.0286 ms for dq; the attended pairs' products
// take less at 989 TFLOP/s.  The mma.sync kernels these replace took 6.7x
// and 7.9x that: they re-read Q (and dO) fragments from shared memory at
// every 32-key tile with ldmatrix, because 128 f32 accumulators a thread
// left no registers to hold them; they held one or two 4-warp blocks an
// SM; and each of a GQA group's q heads loaded the same K/V tiles.  At hd
// 128 the forward was still that mma.sync kernel (FlashAttention-2 on 4
// warps over 64 q rows, two blocks an SM, 64-key tiles double-buffered by
// cp.async, every q head of a group loading the same tiles: six times over
// at Qwen2.5-1.5B's 12 / 2 heads), at 7.6x its bound on 16 packed rows of
// 1024 (0.2137 against 0.0281 ms of bytes, an H100 at 700 W).
//
// Design (FlashAttention-3's shape).  A block of three warpgroups: two
// consumers and a producer (setmaxnreg: 240 registers a consumer thread, 24
// a producer thread), one an SM.  The forward's grid is persistent, one
// block an SM; dq's has a block a work item, whose longer and more uneven
// items the hardware's block scheduling balances better.  A work item is a
// pair of units of one (row, kv head); a unit is 64 q rows of one q head,
// and a consumer owns one unit of each item, with its Q (and for dq, dO)
// loaded once into shared memory by TMA.  The two units of an item are
// consecutive in (q tile, q head of the kv head's group) order, heads
// fastest: under GQA or MQA (even group) the same 64 rows of two q heads,
// whose key ranges and masks are the same, so each K/V tile load serves
// both; at group 1 (Gemma-7B) two consecutive 64-row tiles of the one head.
// The items of the last q tiles, whose key ranges are longest, go first,
// block i taking items i, i + gridDim.x, ...  An item walks the union of
// its units' key ranges (each from the segment start of its first valid
// query, or the window, to its last query); a consumer skips the tiles
// outside its own range, which for it would add exactly nothing.
//
// The producer: three warps (the scheduler) compute the next item's key
// ranges from the segment ids into one of two Info slots while the
// consumers work on the current one; one warp (the loader) brings each
// unit's Q once the consumer has read the last item's, and keeps TMA loads
// of 64-key K and V tiles in flight into a ring (K: 2 stages; V: 2 in the
// forward, 1 in dq, which holds dO as well) across items, writing each K
// tile's key segment ids beside it.  Every hand-over is an mbarrier pair
// (full and empty).  Operands sit in shared memory as HD / 64 64-column
// panels of 128-byte rows in the 128-byte swizzle that TMA writes and wgmma
// reads.  Shared memory: 196,608 bytes of tiles in the forward at hd 256
// (Q x 2, K x 2, V x 2), 98,304 at hd 128, 229,376 in dq (Q x 2, dO x 2,
// K x 2, V x 1).  At hd 128 a ring of 3 or 4 stages, which the halved
// tiles leave room for, timed the same as 2 on an H100 (the walk waits on
// its products and softmax, not on loads), so the ring stays at 2.
//
// Forward, per tile n: S_n = Q K^T (wgmma m64n64k16, Q and K from shared
// memory, K-major) and O += P_{n-1} V_{n-1} (m64nHDk16, P the bf16 A
// operand from registers, V read MN-major) are issued together, then the
// softcap, mask and online softmax of S_n run (a thread's rows skip the
// mask when the tile lies inside their segment, below the diagonal, with
// no window) and O is rescaled.  dq, per tile: S = Q K^T and dP = dO V^T
// (m64n64k16), dS = P (dP - di) (times 1 - t^2 under the softcap) on the
// f32 fragments, then dQ += dS K (m64n256k16, dS from registers, K read
// MN-major), left in flight under the next tile's S and dP.  The results
// go from registers to device memory (a quad writes 16 contiguous bytes),
// so a unit's Q slot is free for the next item as soon as its last S is.
// ptxas serializes every wgmma of a kernel when code it cannot prove
// warp-uniform, or a write to an operand register, sits between a wgmma
// and its wait: the softcap is a template parameter, the mask, the
// barrier waits and the lane-0 arrivals are branch-free, the role comes
// from lane 0 by a shuffle, and operands are pinned before each fence.  A
// cluster with TMA multicast of the K/V tile over the rest of the group
// was not built: the group's other items read the same tiles from L2.
//
// Kept from the mma.sync design: the key ranges from the segment ids, the
// skipping of unmasked tiles' mask, the order of a row's sums (tile by
// tile from the item's first key, which depends only on the item's
// units, so shards whose q_start is a multiple of 128 rows give the
// unsharded rows bit for bit), the rounding points (P and dS rounded to
// bf16 before their products, l summing the f32 P, lse and di f32), pad
// rows (out 0, lse -inf, dq 0), no atomics.

namespace wg {

constexpr int kRows = 64;                        // q rows of a unit, keys of a K/V tile
constexpr int kConsumers = 2;                    // consumer warpgroups (units) a block
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kPanel = kRows * 128;              // bytes of a 64-column panel of a tile
constexpr int kConsumerRegs = 240, kProducerRegs = 24;
static_assert(kConsumers * 128 * kConsumerRegs + 128 * kProducerRegs <= 384 * 168,
              "setmaxnreg moves registers within the block's allocation at launch");

// a work item's key ranges, published by the producer's scheduler warps:
// each unit's [lo, hi) in global key positions (empty: lo >= hi) and the
// segment ids of its 64 rows (-2 past Tq or past the last unit)
struct Info {
  int lo[kConsumers], hi[kConsumers];
  int seg_q[kConsumers * kRows];
};

// shared memory, from a 1024-byte aligned base: tiles, then mbarriers,
// then the K stages' key segment ids, two Info slots and the scheduler's
// scratch
template <bool DQ, int HD>
struct Layout {
  static constexpr int kPanels = HD / 64;         // 64-column panels of a tile
  static constexpr int kTile = kPanels * kPanel;  // bytes of a [64, HD] bf16 tile
  static constexpr int kKStages = 2, kVStages = DQ ? 1 : 2;
  static constexpr int kQ = 0;
  static constexpr int kdO = kQ + kConsumers * kTile;
  static constexpr int kK = kdO + (DQ ? kConsumers * kTile : 0);
  static constexpr int kV = kK + kKStages * kTile;
  static constexpr int kBars = kV + kVStages * kTile;
  // full and empty of each unit's Q (and dO), of each K and V stage, and
  // of each Info slot
  static constexpr int kNumBars = 2 * kConsumers + 2 * kKStages + 2 * kVStages + 4;
  static constexpr int kSegK = kBars + 8 * kNumBars;
  static constexpr int kInfo = kSegK + 4 * kKStages * kRows;
  static constexpr int kScan = kInfo + 2 * (int)sizeof(Info);  // first[2], last[2], flag
  static constexpr int kSmem = kScan + 4 * 8 + 1024;  // + the base's alignment
};
static_assert(Layout<true, 256>::kSmem <= 232448, "dq fits a block's shared memory");
static_assert(Layout<false, 128>::kSmem <= 232448, "the hd-128 forward fits");

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tc::smem_addr(bar)),
               "r"(count)
               : "memory");
}

// arrive, and expect `bytes` of TMA traffic before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   tc::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(tc::smem_addr(bar))
               : "memory");
}

// wait for the completion of the phase of parity `parity` (the spin loop
// inside one asm block: a loop the compiler sees between a wgmma and its
// wait makes ptxas serialize the products)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(tc::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// every warp of a consumer warpgroup arrives once on an empty barrier:
// lane 0 by a predicated instruction, not a branch (a branch while a wgmma
// is in flight makes ptxas serialize the products)
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::
          "r"(tc::smem_addr(bar)),
      "r"(threadIdx.x & 31)
      : "memory");
}

// TMA: one 64-column panel of 64 rows of one head of a [B, T, H, 256]
// tensor (coordinates: column, head, row, batch)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c, int h, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(tc::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(tc::smem_addr(bar)), "r"(c), "r"(h), "r"(t),
      "r"(b)
      : "memory");
}

// the scheduler warps' named barrier (0 is __syncthreads'): warps 1-3 of
// the producer warpgroup
constexpr int kSchedThreads = 96;
__device__ __forceinline__ void sched_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kSchedThreads) : "memory");
}

// the same barrier, returning whether any scheduler thread passed true
__device__ __forceinline__ bool sched_any(bool x) {
  unsigned r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 q, %1, 0;\nbar.red.or.pred p, 1, %2, q;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(r)
      : "r"((unsigned)x), "n"(kSchedThreads)
      : "memory");
  return r != 0;
}

// segment_start over the scheduler's threads (t in [0, 96)): the first
// index of the contiguous segment holding position i
__device__ int sched_segment_start(const int* __restrict__ segb, int i, int* flag, int t) {
  const int s = segb[i];
  if (t == 0) *flag = 0;
  sched_sync();
  for (int base = i - 1; base >= 0; base -= kSchedThreads) {
    const int j = base - t;
    const bool hit = j >= 0 && segb[j] != s;
    if (hit) atomicMax(flag, j + 1);
    if (sched_any(hit)) break;
  }
  sched_sync();
  const int start = *flag;
  sched_sync();  // read by all before the next reset
  return start;
}

// wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// `x` as a value the compiler cannot see through: a descriptor built from
// it is built where it is used, not hoisted with its 15 siblings into 30
// registers held through the walk
__device__ __forceinline__ unsigned opaque(unsigned x) {
  asm volatile("" : "+r"(x));
  return x;
}

// K-major operand (a tile's 64 rows x 256 columns; the columns are the
// product's K dimension), k-step kk of 16 columns: 8-row groups 1024
// bytes apart
__device__ __forceinline__ uint64_t desc_k(unsigned tile, int kk) {
  return desc(opaque(tile) + (kk >> 2) * kPanel + (kk & 3) * 32, 16, 1024);
}

// MN-major operand (a tile's rows are the product's K dimension, its 256
// columns N), k-step kk of 16 rows: 8-row groups 1024 bytes apart, the
// 64-column panels kPanel apart
__device__ __forceinline__ uint64_t desc_mn(unsigned tile, int kk) {
  return desc(opaque(tile) + kk * 2048, kPanel, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pin registers in place around asynchronous products: before a
// wgmma.fence, so that no write to an operand sinks past it (the compiler
// would then insert a fence of its own and serialize the products), and
// after a wait, so that no read of a result rises above it
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void reg_fence(unsigned (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define WG_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F16(d, i) WG_F4(d, i), WG_F4(d, i + 4), WG_F4(d, i + 8), WG_F4(d, i + 12)
#define WG_F32(d, i) WG_F16(d, i), WG_F16(d, i + 16)

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory, K-major
// (accumulate: false overwrites d)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b,
                                          bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_F32(d, 0)
      : "l"(a), "l"(b), "r"((int)accumulate));
}

// d[64 x 256] += A[64 x 16] B[16 x 256]: A bf16 from registers, B from
// shared memory MN-major
__device__ __forceinline__ void wgmma_n256(float (&d)[128], const unsigned (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG_F32(d, 0), WG_F32(d, 32), WG_F32(d, 64), WG_F32(d, 96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128]: as wgmma_n256, at hd 128
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_F32(d, 0), WG_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_F32
#undef WG_F16
#undef WG_F4

// O (or dQ) += A B over the whole head dim
__device__ __forceinline__ void wgmma_pv(float (&d)[128], const unsigned (&a)[4], uint64_t b) {
  wgmma_n256(d, a, b);
}
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const unsigned (&a)[4], uint64_t b) {
  wgmma_n128(d, a, b);
}

// the bf16 A operand of k-step kk (16 keys) from a 64 x 64 f32 accumulator
// (element 4 j + e: n-tile j of 8 columns; e: row g or g + 8, column pair)
__device__ __forceinline__ void a_from_acc(unsigned (&a)[4], const float (&s)[32], int kk) {
  a[0] = tc::pack_bf16(s[8 * kk], s[8 * kk + 1]);
  a[1] = tc::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = tc::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = tc::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// DQ false: the forward (out, lse); true: dq (reads lse and di, writes
// dq into `out`).  CAP: a softcap is set (its tanh stays out of the
// uncapped kernels).  Persistent: block i takes work items i, i +
// gridDim.x, ...; an item is a pair of units of one (row, kv head), the
// pairs of the last q tiles, whose key ranges are longest, first.
template <bool DQ, bool CAP, int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_wg_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const int* __restrict__ segq, const int* __restrict__ segk, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, const float* __restrict__ di, int B, int q_start, int Tq, int Tk,
    int Hq, int Hkv, float softcap, int window) {
  using L = Layout<DQ, HD>;
  constexpr int kTile = L::kTile, kPanels = L::kPanels;
  constexpr int KS = L::kKStages, VS = L::kVStages;
  extern __shared__ __align__(16) unsigned char smem_wg[];
  unsigned char* smem = smem_wg + ((1024 - (tc::smem_addr(smem_wg) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_empty = q_full + kConsumers;
  uint64_t* full_k = q_empty + kConsumers;
  uint64_t* empty_k = full_k + KS;
  uint64_t* full_v = empty_k + KS;
  uint64_t* empty_v = full_v + VS;
  uint64_t* info_full = empty_v + VS;
  uint64_t* info_empty = info_full + 2;
  int* seg_k = reinterpret_cast<int*>(smem + L::kSegK);  // [KS][64]
  Info* info = reinterpret_cast<Info*>(smem + L::kInfo);  // [2]
  int* scan = reinterpret_cast<int*>(smem + L::kScan);
  const int tid = threadIdx.x;
  const int group = Hq / Hkv, units = (Tq + kRows - 1) / kRows * group;
  const int pairs = (units + kConsumers - 1) / kConsumers, items = B * Hkv * pairs;
  // work item k of this block: row b, kv head kh, pair pr; false past the last
  auto item = [&](int k, int& b, int& kh, int& pr) {
    const int w = blockIdx.x + k * gridDim.x, rest = w % (B * Hkv);
    pr = pairs - 1 - w / (B * Hkv);
    b = rest / Hkv;
    kh = rest % Hkv;
    return w < items;
  };
  // unit u of pair pr: q head h, local rows [i0, i0 + 64); false past the last
  auto unit = [&](int kh, int pr, int u, int& h, int& i0) {
    const int n = kConsumers * pr + u;
    h = kh * group + n % group;
    i0 = n / group * kRows;
    return n < units;
  };

  if (tid == 0) {
    for (int u = 0; u < kConsumers; ++u) {
      mbar_init(q_full + u, 1);
      mbar_init(q_empty + u, 4);  // the unit's consumer warps
    }
    for (int s = 0; s < KS; ++s) {
      mbar_init(full_k + s, 32);  // the loader warp: segment ids, and the TMA bytes
      mbar_init(empty_k + s, 4 * kConsumers);
    }
    for (int s = 0; s < VS; ++s) {
      mbar_init(full_v + s, 1);
      mbar_init(empty_v + s, 4 * kConsumers);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(info_full + s, 1);
      mbar_init(info_empty + s, 4 * kConsumers + 1);  // consumer warps and the loader
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the warpgroup, from lane 0: provably the same across a warp, so that
  // the role branch is not a divergent path to ptxas
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (wgi == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int lane = tid & 31;
    if (tid % 128 < 32) {
      // the loader: each item's Q (and dO) once its unit's consumer has
      // read the last item's, then its K/V tiles into the ring
      int tile = 0, qloads[kConsumers] = {};
      for (int k = 0;; ++k) {
        int b, kh, pr;
        if (!item(k, b, kh, pr)) break;
        mbar_wait(info_full + (k & 1), (k >> 1) & 1);
        const Info& in = info[k & 1];
        const int lo_0 = in.lo[0], lo_1 = in.lo[1], hi_0 = in.hi[0], hi_1 = in.hi[1];
        __syncwarp();
        if (lane == 0) mbar_arrive(info_empty + (k & 1));
        const int lo = min(lo_0, lo_1), hi = max(hi_0, hi_1);
        const int ntiles = lo < hi ? (hi - lo + kRows - 1) / kRows : 0;
        if (lane == 0) {
#pragma unroll
          for (int u = 0; u < kConsumers; ++u) {
            int h, i0;
            if (!unit(kh, pr, u, h, i0) || (u == 0 ? lo_0 >= hi_0 : lo_1 >= hi_1)) continue;
            mbar_wait(q_empty + u, (qloads[u]++ & 1) ^ 1);
            mbar_expect_tx(q_full + u, (DQ ? 2 : 1) * kTile);
            for (int p = 0; p < kPanels; ++p) {
              tma_load(smem + L::kQ + u * kTile + p * kPanel, &tq, q_full + u, 64 * p, h, i0, b);
              if constexpr (DQ)
                tma_load(smem + L::kdO + u * kTile + p * kPanel, &tdo, q_full + u, 64 * p, h,
                         i0, b);
            }
          }
        }
        const int* segkb = segk + (long long)b * Tk;
        for (int n = 0; n < ntiles; ++n, ++tile) {
          const int j0 = lo + n * kRows, sk = tile % KS, sv = tile % VS;
          mbar_wait(empty_k + sk, ((tile / KS) & 1) ^ 1);
          for (int c = lane; c < kRows; c += 32)
            seg_k[sk * kRows + c] = j0 + c < Tk ? segkb[j0 + c] : -2;
          if (lane == 0) {
            mbar_expect_tx(full_k + sk, kTile);
            for (int p = 0; p < kPanels; ++p)
              tma_load(smem + L::kK + sk * kTile + p * kPanel, &tk, full_k + sk, 64 * p, kh, j0,
                       b);
          } else {
            mbar_arrive(full_k + sk);
          }
          mbar_wait(empty_v + sv, ((tile / VS) & 1) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(full_v + sv, kTile);
            for (int p = 0; p < kPanels; ++p)
              tma_load(smem + L::kV + sv * kTile + p * kPanel, &tv, full_v + sv, 64 * p, kh, j0,
                       b);
          }
        }
      }
    } else {
      // the scheduler: each item's key ranges into an Info slot, one
      // item ahead of the consumers
      const int t = tid % 128 - 32;
      for (int k = 0;; ++k) {
        int b, kh, pr;
        if (!item(k, b, kh, pr)) break;
        mbar_wait(info_empty + (k & 1), ((k >> 1) & 1) ^ 1);
        Info& in = info[k & 1];
        const int* segqb = segq + (long long)b * Tq;
        const int* segkb = segk + (long long)b * Tk;
        if (t < 4) scan[t] = t < 2 ? kRows : -1;  // first, last of each unit
        for (int r = t; r < kConsumers * kRows; r += kSchedThreads) {
          int h, i0;
          const bool exists = unit(kh, pr, r / kRows, h, i0);
          const int row = i0 + r % kRows;
          in.seg_q[r] = exists && row < Tq ? segqb[row] : -2;
        }
        sched_sync();
        for (int r = t; r < kConsumers * kRows; r += kSchedThreads) {
          if (in.seg_q[r] >= 0) {
            atomicMin(&scan[r / kRows], r % kRows);
            atomicMax(&scan[2 + r / kRows], r % kRows);
          }
        }
        sched_sync();
        int lo_0 = 0;
#pragma unroll
        for (int u = 0; u < kConsumers; ++u) {
          int h, i0, h0, i00;
          unit(kh, pr, u, h, i0);
          unit(kh, pr, 0, h0, i00);
          const int first = scan[u], last = scan[2 + u];
          int lo_u = INT_MAX, hi_u = INT_MIN;
          if (first <= last) {
            const int i_first = q_start + i0 + first;
            if (u > 0 && i0 == i00) {  // the same rows as unit 0
              lo_u = lo_0;
            } else {
              lo_u = sched_segment_start(segkb, i_first, &scan[4], t);
              if (window > 0) lo_u = max(lo_u, i_first - window + 1);
            }
            hi_u = q_start + i0 + last + 1;
          }
          if (u == 0) lo_0 = lo_u;
          if (t == 0) {
            in.lo[u] = lo_u;
            in.hi[u] = hi_u;
          }
        }
        sched_sync();  // the slot is written, and scan read before the next item resets it
        if (t == 0) mbar_arrive(info_full + (k & 1));
      }
    }
  } else {
    // consumer warpgroup wgi: unit wgi of each item, 16 of its rows a warp
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int w = wgi, lane = tid & 31, g = lane >> 2, tig = lane & 3;
    const int rq = (tid % 128 / 32) * 16 + g;  // this thread's rows: rq and rq + 8
    const unsigned sQ = tc::smem_addr(smem + L::kQ + w * kTile);
    const unsigned sdO = tc::smem_addr(smem + L::kdO + w * kTile);
    int tile = 0, qloads = 0;  // the ring's position; this unit's Q loads
    for (int k = 0;; ++k) {
      int b, kh, pr;
      if (!item(k, b, kh, pr)) break;
      mbar_wait(info_full + (k & 1), (k >> 1) & 1);
      const Info& in = info[k & 1];
      const int lo = min(in.lo[0], in.lo[1]), hi = max(in.hi[0], in.hi[1]);
      const int my_lo = in.lo[w], my_hi = in.hi[w];
      const int sq[2] = {in.seg_q[w * kRows + rq], in.seg_q[w * kRows + rq + 8]};
      release(info_empty + (k & 1));
      int h, i0;
      unit(kh, pr, w, h, i0);
      const int ntiles = lo < hi ? (hi - lo + kRows - 1) / kRows : 0;
      // the unit's tiles of the item's walk, [n0, n1); none without a valid row
      const int n0 = my_lo < my_hi ? (my_lo - lo) / kRows : 0;
      const int n1 = my_lo < my_hi ? (my_hi - lo + kRows - 1) / kRows : 0;
      const int qi0 = q_start + i0 + rq;  // this thread's first row, global
      // tile n of the item is ring position tile + n
      auto k_tile = [&](int n) { return tc::smem_addr(smem + L::kK + (tile + n) % KS * kTile); };
      auto v_tile = [&](int n) { return tc::smem_addr(smem + L::kV + (tile + n) % VS * kTile); };
      auto wait_k = [&](int n) { mbar_wait(full_k + (tile + n) % KS, ((tile + n) / KS) & 1); };
      auto wait_v = [&](int n) { mbar_wait(full_v + (tile + n) % VS, ((tile + n) / VS) & 1); };
      auto free_k = [&](int n) { release(empty_k + (tile + n) % KS); };
      auto free_v = [&](int n) { release(empty_v + (tile + n) % VS); };
      // a tile outside the unit's range: waited for and released unread
      auto skip = [&](int n) {
        wait_k(n);
        free_k(n);
        wait_v(n);
        free_v(n);
      };
      // S = Q K^T of tile n into s (issued and committed, not waited for)
      auto issue_s = [&](float (&s)[32], int n) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_n64(s, desc_k(sQ, kk), desc_k(k_tile(n), kk), kk > 0);
        wgmma_commit();
      };
      // may element i of a thread's S fragment of tile n be attended?  A
      // thread's two rows need no mask when the tile lies inside their
      // segment (segments are contiguous), below both, with no window.
      auto mask_of = [&](int n) {
        const int* sgk = seg_k + (tile + n) % KS * kRows;
        const int j0 = lo + n * kRows, first = sgk[0], last = sgk[kRows - 1];
        bool full = window <= 0;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          full &= (sq[r] >= 0) & (first == sq[r]) & (last == sq[r]) &
                  (j0 + kRows - 1 <= qi0 + 8 * r);
        return [=](int i) {
          const int row = (i >> 1) & 1, col = 8 * (i >> 2) + 2 * tig + (i & 1);
          return full | allowed(sq[row], sgk[col], qi0 + 8 * row, j0 + col, window);
        };
      };

      float acc[HD / 2];  // O or dQ: element 4 j + e at n-tile j of 8 columns
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // forward
      for (int n = 0; n < n0; ++n) skip(n);
      if (n0 < n1) {
        mbar_wait(q_full + w, qloads++ & 1);
        if constexpr (DQ) {
          float lse_r[2], di_r[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const long long at = ((long long)b * Hq + h) * Tq + min(i0 + rq + 8 * r, Tq - 1);
            lse_r[r] = lse[at];
            di_r[r] = di[at];
          }
          // per tile: S and dP, then dS, then dQ += dS K left in flight
          // under the next tile's S and dP
          unsigned a[4][4];
          for (int n = n0; n < n1; ++n) {
            float s[32], dp[32];
            wait_k(n);
            issue_s(s, n);
            wait_v(n);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk)
              wgmma_n64(dp, desc_k(sdO, kk), desc_k(v_tile(n), kk), kk > 0);
            wgmma_commit();
            wgmma_wait<0>();
            reg_fence(s);
            reg_fence(dp);
            reg_fence(acc);
            if (n > n0) free_k(n - 1);  // the previous dQ read its K
            free_v(n);
            const auto ok = mask_of(n);
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              const int row = (i >> 1) & 1;
              float x = s[i], t = 0.f;
              if constexpr (CAP) {
                t = tanhf(x / softcap);
                x = t * softcap;
              }
              float ds =
                  ok(i) ? exp2f((x - lse_r[row]) * tc::kLog2e) * (dp[i] - di_r[row]) : 0.f;
              if constexpr (CAP) ds *= 1.f - t * t;
              s[i] = ds;
            }
            // dQ += dS K: dS the bf16 A operand, K read MN-major
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) a_from_acc(a[kk], s, kk);
            reg_fence(a);
            reg_fence(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) wgmma_pv(acc, a[kk], desc_mn(k_tile(n), kk));
            wgmma_commit();
          }
          release(q_empty + w);  // Q and dO are read: the loader may bring the next item's
          wgmma_wait<0>();
          reg_fence(acc);
          free_k(n1 - 1);
        } else {
          // softcap, mask and the online softmax on tile n's S, P into p;
          // alpha: the factor for O
          auto softmax = [&](float (&s)[32], int n, unsigned (&p)[4][4], float (&alpha)[2]) {
            const auto ok = mask_of(n);
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              float x = s[i];
              if constexpr (CAP) x = tanhf(x / softcap) * softcap;
              x = ok(i) ? x : -INFINITY;
              s[i] = x;
              mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
            }
            float mb[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
              mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
              const float m_new = fmaxf(m[r], mx[r]);
              mb[r] = m_new == -INFINITY ? 0.f : m_new * tc::kLog2e;
              alpha[r] = exp2f(m[r] * tc::kLog2e - mb[r]);  // 0 while m is -inf
              m[r] = m_new;
              l[r] *= alpha[r];
            }
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              s[i] = exp2f(s[i] * tc::kLog2e - mb[(i >> 1) & 1]);
              l[(i >> 1) & 1] += s[i];
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) a_from_acc(p[kk], s, kk);
          };
          // per tile n: S_n and O += P_{n-1} V_{n-1} issued together, then
          // the softmax of S_n once both are done (run under the product,
          // it made ptxas serialize every wgmma: 0.092 against 0.0825 ms on
          // Gemma-2B's heads over 8 packed rows of 1024, same card)
          unsigned pa[4][4];
          float alpha[2];
          {
            float s[32];
            wait_k(n0);
            issue_s(s, n0);
            wgmma_wait<0>();
            reg_fence(s);
            softmax(s, n0, pa, alpha);  // O is 0: no rescale
            free_k(n0);
            reg_fence(acc);
            reg_fence(pa);
          }
          for (int n = n0 + 1; n < n1; ++n) {
            float s[32];
            wait_k(n);
            issue_s(s, n);
            wait_v(n - 1);
            wgmma_fence();  // each batch of products its own fence
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) wgmma_pv(acc, pa[kk], desc_mn(v_tile(n - 1), kk));
            wgmma_commit();
            wgmma_wait<0>();
            reg_fence(s);
            reg_fence(acc);
            free_v(n - 1);
            softmax(s, n, pa, alpha);
            free_k(n);
#pragma unroll
            for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
            reg_fence(acc);  // the next tile's fence orders them for its products
            reg_fence(pa);
          }
          release(q_empty + w);  // Q is read: the loader may bring the next item's
          wait_v(n1 - 1);
          reg_fence(acc);
          reg_fence(pa);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_pv(acc, pa[kk], desc_mn(v_tile(n1 - 1), kk));
          wgmma_commit();
          wgmma_wait<0>();
          reg_fence(acc);
          free_v(n1 - 1);
        }
      }
      for (int n = n1; n < ntiles; ++n) skip(n);
      tile += ntiles;

      // out (normalised, and lse) or dq, from registers: a quad writes 16
      // contiguous bytes of a row.  The item's coordinates are derived
      // again (from a k the compiler must treat as new), so that they hold
      // no registers through the walk.
      asm volatile("" : "+r"(k));
      item(k, b, kh, pr);
      const bool exists = unit(kh, pr, w, h, i0);
      float sc[2] = {1.f, 1.f};
      if constexpr (!DQ) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
          sc[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
          const int t = i0 + rq + 8 * r;  // local
          if (exists && tig == 0 && t < Tq)
            lse[((long long)b * Hq + h) * Tq + t] = l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = i0 + rq + 8 * r;  // local
        if (!exists || t >= Tq) continue;
        __nv_bfloat16* row = out + (((long long)b * Tq + t) * Hq + h) * HD + 2 * tig;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] * sc[r], acc[4 * j + 2 * r + 1] * sc[r]);
      }
    }
  }
}

}  // namespace wg

template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// head dim 128 or 256, whole GQA groups, and the shard's queries inside the
// key range
cudaError_t check_shape(int hd, int Hq, int Hkv, int q_start, int Tq, int Tk) {
  const bool heads = (hd == 128 || hd == 256) && Hkv > 0 && Hq % Hkv == 0;
  const bool rows = q_start >= 0 && Tq > 0 && q_start + Tq <= Tk;
  return heads && rows ? cudaSuccess : cudaErrorInvalidValue;
}

// the arguments every launch takes after its tensors
struct Rows {
  int B, q_start, Tq, Tk, Hq, Hkv;
  float softcap;
  int window;
};

template <typename T, int HD>
cudaError_t fwd(const void* q, const void* k, const void* v, const void* segq,
                const void* segk, void* out, void* lse, Rows r, cudaStream_t s) {
  constexpr int TILE = f32_tile<HD>(), kSmem = F32Tiles<HD, TILE>::kFwdSmem;
  auto kernel = flash_fwd_kernel<T, HD, TILE>;
  cudaError_t err = opt_in(kernel, kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((r.Tq + TILE - 1) / TILE, r.Hq, r.B), kThreads, kSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(segq), static_cast<const int*>(segk), static_cast<T*>(out),
      static_cast<float*>(lse), r.q_start, r.Tq, r.Tk, r.Hq, r.Hkv, r.softcap, r.window);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point query
// (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a [B, T, H, HD] bf16 tensor as TMA boxes of one 64-column panel of 64
// rows of one head, swizzled by 128 bytes (wgmma's layout); rows past T
// read as zeros and are not written
template <int HD>
cudaError_t head_map(CUtensorMap* map, const void* ptr, int B, int T, int H) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  constexpr cuuint64_t kRow = 2 * HD;  // bytes of one head's row
  const cuuint64_t dims[4] = {HD, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {kRow, kRow * H, kRow * H * T};  // bytes, dims 1-3
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)wg::kRows, 1}, unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the bf16 forward (DQ false: out, lse; hd 128 and 256) or dq (DQ true:
// reads dout, lse, di; `result` is dq; hd 256) on wgmma
template <bool DQ, int HD>
cudaError_t attn_wg(const void* q, const void* k, const void* v, const void* dout,
                    const void* segq, const void* segk, void* result, float* lse,
                    const float* di, Rows r, cudaStream_t s) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = head_map<HD>(&mq, q, r.B, r.Tq, r.Hq);
  if (err == cudaSuccess) err = head_map<HD>(&mk, k, r.B, r.Tk, r.Hkv);
  if (err == cudaSuccess) err = head_map<HD>(&mv, v, r.B, r.Tk, r.Hkv);
  if (err == cudaSuccess) err = head_map<HD>(&mdo, DQ ? dout : q, r.B, r.Tq, r.Hq);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  constexpr int kSmem = wg::Layout<DQ, HD>::kSmem;
  auto kernel = r.softcap > 0.f ? wg::flash_wg_kernel<DQ, true, HD>
                                : wg::flash_wg_kernel<DQ, false, HD>;
  if (err == cudaSuccess) err = opt_in(kernel, kSmem);
  if (err != cudaSuccess) return err;
  const int units = (r.Tq + wg::kRows - 1) / wg::kRows * (r.Hq / r.Hkv);
  const int items = (units + wg::kConsumers - 1) / wg::kConsumers * r.Hkv * r.B;
  // the forward persistent (its producer prefetches the next item's Q and
  // K/V under the current one's products); dq one block an item, whose
  // longer and more uneven items the hardware's block scheduling balances
  // better (Gemma-2B's heads over 8 packed rows of 1024, same card: 0.1164
  // against 0.1220 ms persistent; the forward 0.0825 against 0.0880 with a
  // block an item; at hd 128 a block an item was slower too, on an H100)
  kernel<<<DQ ? items : std::min(items, sms), wg::kThreads, kSmem, s>>>(
      mq, mk, mv, mdo, static_cast<const int*>(segq), static_cast<const int*>(segk),
      static_cast<__nv_bfloat16*>(result), lse, di, r.B, r.q_start, r.Tq, r.Tk, r.Hq, r.Hkv,
      r.softcap, r.window);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* segq,
                   const void* segk, const void* dout, const void* lse, const void* di,
                   void* dq, Rows r, cudaStream_t s) {
  constexpr int TILE = f32_tile<HD>(), kSmem = F32Tiles<HD, TILE>::kDqSmem;
  auto kernel = flash_bwd_dq_kernel<T, HD, TILE>;
  cudaError_t err = opt_in(kernel, kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((r.Tq + TILE - 1) / TILE, r.Hq, r.B), kThreads, kSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(segq), static_cast<const int*>(segk),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<T*>(dq), r.q_start, r.Tq, r.Tk, r.Hq,
      r.Hkv, r.softcap, r.window);
  return cudaGetLastError();
}

// dk/dv: one block per key tile over all Tk keys (tiles no query of the
// shard sees write zeros)
template <typename T, int HD>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* segq,
                    const void* segk, const void* dout, const void* lse, const void* di,
                    void* dk, void* dv, Rows r, cudaStream_t s) {
  constexpr int TILE = f32_tile<HD>(), kSmem = F32Tiles<HD, TILE>::kDkvSmem;
  auto kernel = flash_bwd_dkv_kernel<T, HD, TILE>;
  cudaError_t err = opt_in(kernel, kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((r.Tk + TILE - 1) / TILE, r.Hkv, r.B), kThreads, kSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(segq), static_cast<const int*>(segk),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<T*>(dk), static_cast<T*>(dv), r.q_start,
      r.Tq, r.Tk, r.Hq, r.Hkv, r.softcap, r.window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t bwd_dq_tc(const void* q, const void* k, const void* v, const void* segq,
                      const void* segk, const void* dout, const void* lse, const void* di,
                      void* dq, Rows r, cudaStream_t s) {
  constexpr int kSmem = tc::Tiles<HD>::kDqSmem;
  auto kernel = tc::flash_bwd_dq_tc_kernel<HD>;
  cudaError_t err = opt_in(kernel, kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(r.Hq, r.B, (r.Tq + tc::kBr - 1) / tc::kBr), tc::kThreads, kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(segq),
      static_cast<const int*>(segk), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<__nv_bfloat16*>(dq), r.q_start, r.Tq, r.Tk, r.Hq, r.Hkv, r.softcap,
      r.window);
  return cudaGetLastError();
}

// the bf16 dk/dv kernels: at hd 128 4 warps with dK and dV in each thread,
// one block per (kv head, row, key tile); at hd 256 two groups of 4 warps,
// `cluster` blocks per key tile (a thread block cluster splitting the
// group's q heads)
template <int HD>
cudaError_t bwd_dkv_tc(const void* q, const void* k, const void* v, const void* segq,
                       const void* segk, const void* dout, const void* lse, const void* di,
                       void* dk, void* dv, Rows r, int cluster, cudaStream_t s) {
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* dob = static_cast<const __nv_bfloat16*>(dout);
  const dim3 grid(r.Hkv * cluster, r.B, (r.Tk + tc::kBr - 1) / tc::kBr);
  if constexpr (HD == 128) {
    constexpr int kSmem = 6 * tc::Tiles<128>::kTileQ * 2;
    cudaError_t err = opt_in(tc::flash_bwd_dkv_tc_kernel, kSmem);
    if (err != cudaSuccess) return err;
    tc::flash_bwd_dkv_tc_kernel<<<grid, tc::kThreads, kSmem, s>>>(
        qb, kb, vb, static_cast<const int*>(segq), static_cast<const int*>(segk), dob,
        static_cast<const float*>(lse), static_cast<const float*>(di),
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), r.q_start, r.Tq,
        r.Tk, r.Hq, r.Hkv, r.softcap, r.window);
    return cudaGetLastError();
  } else {
    cudaError_t err = opt_in(tc::flash_bwd_dkv_tc256_kernel, tc::kDkv256Smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(tc::kDkv256Threads);
    cfg.dynamicSmemBytes = tc::kDkv256Smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, tc::flash_bwd_dkv_tc256_kernel, qb, kb, vb,
                             static_cast<const int*>(segq), static_cast<const int*>(segk), dob,
                             static_cast<const float*>(lse), static_cast<const float*>(di),
                             static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
                             r.q_start, r.Tq, r.Tk, r.Hq, r.Hkv, r.softcap, r.window);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
}

// the cluster size ops/flash_attention.py dkv_plan picks: a power of two
// up to tc::kMaxCluster dividing the group at hd 256 in bf16, 1 elsewhere
cudaError_t check_dkv_cluster(int bf16, int hd, int Hq, int Hkv, int cluster) {
  if (!(bf16 && hd == 256)) return cluster == 1 ? cudaSuccess : cudaErrorInvalidValue;
  const bool ok = cluster >= 1 && cluster <= tc::kMaxCluster && (cluster & (cluster - 1)) == 0 &&
                  (Hq / Hkv) % cluster == 0;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// bf16: 1 for bfloat16 inputs, 0 for float32.  hd: 128 or 256.  softcap <=
// 0 and window <= 0 are off.  q is the pre-scaled q_s of rows [q_start,
// q_start + Tq) of each packed row of Tk keys; segq [B, Tq] and segk
// [B, Tk] (one array for both, with q_start 0 and Tq = Tk, is the unsharded
// call).  Each entry picks its kernel by dtype and head dim: bfloat16 runs
// on the tensor cores (the forward wg::flash_wg_kernel at hd 128 and 256,
// dq tc::flash_bwd_dq_tc_kernel at hd 128 and wg::flash_wg_kernel at 256,
// dk/dv tc::flash_bwd_dkv_tc_kernel or tc::flash_bwd_dkv_tc256_kernel),
// float32 on the CUDA cores (flash_fwd_kernel, flash_bwd_dq_kernel,
// flash_bwd_dkv_kernel), which keeps f32 products exact.
extern "C" int flash_fwd(int device, int bf16, const void* q, const void* k, const void* v,
                         const void* segq, const void* segk, void* out, void* lse, int B,
                         int q_start, int Tq, int Tk, int Hq, int Hkv, int hd, float softcap,
                         int window, void* stream) {
  cudaError_t err = check_shape(hd, Hq, Hkv, q_start, Tq, Tk);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows r{B, q_start, Tq, Tk, Hq, Hkv, softcap, window};
  float* lse_f = static_cast<float*>(lse);
  if (hd == 128)
    return (int)(bf16 ? attn_wg<false, 128>(q, k, v, nullptr, segq, segk, out, lse_f, nullptr, r, s)
                      : fwd<float, 128>(q, k, v, segq, segk, out, lse, r, s));
  return (int)(bf16 ? attn_wg<false, 256>(q, k, v, nullptr, segq, segk, out, lse_f, nullptr, r, s)
                    : fwd<float, 256>(q, k, v, segq, segk, out, lse, r, s));
}

extern "C" int flash_bwd_dq(int device, int bf16, const void* q, const void* k, const void* v,
                            const void* segq, const void* segk, const void* dout,
                            const void* lse, const void* di, void* dq, int B, int q_start,
                            int Tq, int Tk, int Hq, int Hkv, int hd, float softcap, int window,
                            void* stream) {
  cudaError_t err = check_shape(hd, Hq, Hkv, q_start, Tq, Tk);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows r{B, q_start, Tq, Tk, Hq, Hkv, softcap, window};
  if (hd == 128)
    return (int)(bf16 ? bwd_dq_tc<128>(q, k, v, segq, segk, dout, lse, di, dq, r, s)
                      : bwd_dq<float, 128>(q, k, v, segq, segk, dout, lse, di, dq, r, s));
  return (int)(bf16 ? attn_wg<true, 256>(q, k, v, dout, segq, segk, dq,
                                     static_cast<float*>(const_cast<void*>(lse)),
                                     static_cast<const float*>(di), r, s)
                    : bwd_dq<float, 256>(q, k, v, segq, segk, dout, lse, di, dq, r, s));
}

extern "C" int flash_bwd_dkv(int device, int bf16, const void* q, const void* k, const void* v,
                             const void* segq, const void* segk, const void* dout,
                             const void* lse, const void* di, void* dk, void* dv, int cluster,
                             int B, int q_start, int Tq, int Tk, int Hq, int Hkv,
                             int hd, float softcap, int window, void* stream) {
  cudaError_t err = check_shape(hd, Hq, Hkv, q_start, Tq, Tk);
  if (err == cudaSuccess) err = check_dkv_cluster(bf16, hd, Hq, Hkv, cluster);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows r{B, q_start, Tq, Tk, Hq, Hkv, softcap, window};
  if (hd == 128)
    return (int)(bf16 ? bwd_dkv_tc<128>(q, k, v, segq, segk, dout, lse, di, dk, dv, r, 1, s)
                      : bwd_dkv<float, 128>(q, k, v, segq, segk, dout, lse, di, dk, dv, r, s));
  return (int)(bf16 ? bwd_dkv_tc<256>(q, k, v, segq, segk, dout, lse, di, dk, dv, r, cluster, s)
                    : bwd_dkv<float, 256>(q, k, v, segq, segk, dout, lse, di, dk, dv, r, s));
}
