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
// Layouts are the model's: q, dout, out, dq [B, T, Hq, hd]; k, v, dk, dv
// [B, T, Hkv, hd]; segment ids int32 [B, T]; lse and di f32 [B, Hq, T].
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
// on the tensor cores (namespace tc below: mma.sync m16n8k16, bf16 operands
// in padded shared memory read by ldmatrix, f32 accumulators in registers,
// double-buffered 16-byte cp.async tile pipelines): the forward
// (tc::flash_fwd_tc_kernel), dq (tc::flash_bwd_dq_tc_kernel) and dk/dv
// (tc::flash_bwd_dkv_tc_kernel at hd 128, tc::flash_bwd_dkv_tc256_kernel at
// hd 256).  The f32 kernels stay plain and right rather than fast: they run
// on the CUDA cores in f32, because the tensor cores would round the f32
// operands (TF32 at best).  Each such block stages tiles of q, k, v (and
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
// Head dim 256 doubles every per-thread head-dim slice.  The tensor-core
// forward and dq keep their 128 f32 accumulators a thread in registers,
// read Q's fragments from shared memory at each key tile instead of holding
// them, and take 32-key tiles (a forward block then fits twice on an SM).
// The dk/dv block at hd 256 has 8 warps in two groups over the same 64 keys:
// one computes S^T and P^T and accumulates dV, the other dP^T and dS^T (with
// P^T handed over through shared memory) and accumulates dK, so each thread
// holds 128 accumulators, not 256, and no product is done twice.
//
// Grids: forward and dq one block per (q tile, q head, row); dk/dv one
// block per (k tile, kv head, row), looping over the group's q heads and
// the q tiles that see its keys, so GQA and MQA need no atomics and every
// result is the same from run to run.
//
// Interface: plain C entry points bound with ctypes; each launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

// may query i (segment sq) attend key j (segment sk)?
__device__ __forceinline__ bool allowed(int sq, int sk, int i, int j, int window) {
  return sq >= 0 && sq == sk && j <= i && (window <= 0 || j > i - window);
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
    const int* __restrict__ seg, T* __restrict__ out, float* __restrict__ lse, int Tn,
    int Hq, int Hkv, float softcap, int window) {
  using C = F32Tiles<HD, TILE>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + C::kTileFloats;
  float* Vs = Ks + C::kTileFloats;
  float* Ps = Vs + C::kTileFloats;
  __shared__ int seg_q[TILE], seg_k[TILE];
  __shared__ int s_first, s_last, s_lo;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * TILE;
  const int kh = h / (Hq / Hkv);
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
  const int* segb = seg + (long long)b * Tn;

  float m[C::kRows], l[C::kRows], o[C::kRows][C::kDCols];
#pragma unroll
  for (int i = 0; i < C::kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < C::kDCols; ++j) o[i][j] = 0.f;
  }

  tile_span<TILE>(segb, i0, Tn, seg_q, &s_first, &s_last);
  const int first = s_first, last = s_last;
  if (first <= last) {
    const int i_first = i0 + first;
    int lo = segment_start(segb, i_first, &s_lo);
    if (window > 0) lo = max(lo, i_first - window + 1);
    const int hi = i0 + last + 1;
    load_tile<T, HD, TILE>(Qs, q, b, i0, Tn, Hq, h);
    for (int j0 = lo; j0 < hi; j0 += TILE) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, HD, TILE>(Ks, k, b, j0, Tn, Hkv, kh);
      load_tile<T, HD, TILE>(Vs, v, b, j0, Tn, Hkv, kh);
      if (threadIdx.x < TILE) {
        const int t = j0 + threadIdx.x;
        seg_k[threadIdx.x] = t < Tn ? segb[t] : -2;
      }
      __syncthreads();
      float s[C::kRows][C::kCols];
      tile_dot<HD, TILE>(Qs, Ks, tr, tc, s);
#pragma unroll
      for (int i = 0; i < C::kRows; ++i) {
        const int r = tr + 32 * i, qi = i0 + r, sq = seg_q[r];
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
    const int qi = i0 + tr + 32 * i;
#pragma unroll
    for (int j = 0; j < C::kDCols; ++j) o[i][j] = l[i] > 0.f ? o[i][j] / l[i] : 0.f;
    if (tc == 0 && qi < Tn)
      lse[((long long)b * Hq + h) * Tn + qi] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
  store_rows<T, HD, TILE>(out, o, b, i0, Tn, Hq, h, tr, tc);
}

// ---------------------------------------------------------------------------
// dq: sum over keys of dS k, dS = P * (dP - di) (times 1 - t^2 under softcap)
// ---------------------------------------------------------------------------

template <typename T, int HD, int TILE>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ seg, const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di, T* __restrict__ dq, int Tn, int Hq, int Hkv, float softcap,
    int window) {
  using C = F32Tiles<HD, TILE>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + C::kTileFloats;
  float* Ks = dOs + C::kTileFloats;
  float* Vs = Ks + C::kTileFloats;
  float* dSs = Vs + C::kTileFloats;
  __shared__ int seg_q[TILE], seg_k[TILE];
  __shared__ int s_first, s_last, s_lo;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * TILE;
  const int kh = h / (Hq / Hkv);
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
  const int* segb = seg + (long long)b * Tn;

  float acc[C::kRows][C::kDCols];
#pragma unroll
  for (int i = 0; i < C::kRows; ++i)
#pragma unroll
    for (int j = 0; j < C::kDCols; ++j) acc[i][j] = 0.f;

  tile_span<TILE>(segb, i0, Tn, seg_q, &s_first, &s_last);
  const int first = s_first, last = s_last;
  if (first <= last) {
    const int i_first = i0 + first;
    int lo = segment_start(segb, i_first, &s_lo);
    if (window > 0) lo = max(lo, i_first - window + 1);
    const int hi = i0 + last + 1;
    load_tile<T, HD, TILE>(Qs, q, b, i0, Tn, Hq, h);
    load_tile<T, HD, TILE>(dOs, dout, b, i0, Tn, Hq, h);
    float lse_r[C::kRows], di_r[C::kRows];
#pragma unroll
    for (int i = 0; i < C::kRows; ++i) {
      const int qi = min(i0 + tr + 32 * i, Tn - 1);
      lse_r[i] = lse[((long long)b * Hq + h) * Tn + qi];
      di_r[i] = di[((long long)b * Hq + h) * Tn + qi];
    }
    for (int j0 = lo; j0 < hi; j0 += TILE) {
      __syncthreads();
      load_tile<T, HD, TILE>(Ks, k, b, j0, Tn, Hkv, kh);
      load_tile<T, HD, TILE>(Vs, v, b, j0, Tn, Hkv, kh);
      if (threadIdx.x < TILE) {
        const int t = j0 + threadIdx.x;
        seg_k[threadIdx.x] = t < Tn ? segb[t] : -2;
      }
      __syncthreads();
      float s[C::kRows][C::kCols], dp[C::kRows][C::kCols];
      tile_dot<HD, TILE>(Qs, Ks, tr, tc, s);
      tile_dot<HD, TILE>(dOs, Vs, tr, tc, dp);
#pragma unroll
      for (int i = 0; i < C::kRows; ++i) {
        const int r = tr + 32 * i, qi = i0 + r, sq = seg_q[r];
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
  store_rows<T, HD, TILE>(dq, acc, b, i0, Tn, Hq, h, tr, tc);
}

// ---------------------------------------------------------------------------
// dk / dv: per key tile, summed over the group's q heads and the q tiles
// that see it
// ---------------------------------------------------------------------------

template <typename T, int HD, int TILE>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ seg, const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv, int Tn, int Hq,
    int Hkv, float softcap, int window) {
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
  const int* segb = seg + (long long)b * Tn;

  float dk_acc[C::kRows][C::kDCols], dv_acc[C::kRows][C::kDCols];
#pragma unroll
  for (int i = 0; i < C::kRows; ++i)
#pragma unroll
    for (int j = 0; j < C::kDCols; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  tile_span<TILE>(segb, j0, Tn, seg_k, &s_first, &s_last);
  const int first = s_first, last = s_last;
  if (first <= last) {
    const int j_last = j0 + last;
    const int lo = j0 + first;  // causal: a query sees only keys at or before it
    int hi = segment_end(segb, j_last, Tn, &s_hi);
    if (window > 0) hi = min(hi, j_last + window);
    load_tile<T, HD, TILE>(Ks, k, b, j0, Tn, Hkv, kh);
    load_tile<T, HD, TILE>(Vs, v, b, j0, Tn, Hkv, kh);
    for (int g = 0; g < group; ++g) {
      const int h = kh * group + g;
      const float* lse_h = lse + ((long long)b * Hq + h) * Tn;
      const float* di_h = di + ((long long)b * Hq + h) * Tn;
      for (int i0 = lo; i0 < hi; i0 += TILE) {
        __syncthreads();  // the previous q tile's readers are done
        load_tile<T, HD, TILE>(Qs, q, b, i0, Tn, Hq, h);
        load_tile<T, HD, TILE>(dOs, dout, b, i0, Tn, Hq, h);
        if (threadIdx.x < TILE) {
          const int t = i0 + threadIdx.x;
          seg_q[threadIdx.x] = t < Tn ? segb[t] : -2;
          lse_q[threadIdx.x] = t < Tn ? lse_h[t] : 0.f;
          di_q[threadIdx.x] = t < Tn ? di_h[t] : 0.f;
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
            const bool ok = allowed(seg_q[c], sk, i0 + c, kj, window);
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
  store_rows<T, HD, TILE>(dk, dk_acc, b, j0, Tn, Hkv, kh, tr, tc);
  store_rows<T, HD, TILE>(dv, dv_acc, b, j0, Tn, Hkv, kh, tr, tc);
}

// ---------------------------------------------------------------------------
// forward on the bf16 tensor cores (bf16 inputs)
// ---------------------------------------------------------------------------
//
// FlashAttention-2's pattern with mma.sync.m16n8k16 (bf16 in, f32 sums).
// A block owns 64 q rows of one q head; each of its 4 warps owns 16 rows.
// At hd 128 a warp keeps its Q fragments in registers (loaded once by
// ldmatrix); at hd 256, where the 128 output accumulators a thread holds
// leave no room for them, it re-reads them from shared memory at each key
// tile.  K and V tiles (64 keys at hd 128, 32 at hd 256) stay bf16 in
// shared memory, rows padded by 16 bytes so ldmatrix reads hit distinct
// banks, double-buffered and filled by 16-byte cp.async so the next tile's
// copy overlaps this tile's products.  S = Q K^T runs on the tensor cores;
// the softcap and the segment / causal / window mask act on the accumulator
// fragments (tiles wholly inside one segment and below the diagonal skip
// the mask); the online softmax takes row max and sum across each quad with
// shuffles.  P becomes bf16 A fragments in registers and O += P V reads V
// through ldmatrix.trans.  The output goes out through shared memory in
// 16-byte stores.  Key ranges come from the segment ids as in
// flash_fwd_kernel.
//
// P rounding: P is rounded to bf16 before the PV product (the tensor cores
// take bf16), where splash and flash_fwd_plain keep P in f32; l sums the
// unrounded f32 P, and lse is f32 as before.

namespace tc {

constexpr int kBr = 64;        // q rows per block (keys per dk/dv block)
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tiles {
  static constexpr int kLDS = HD + 8;              // bf16 row stride in shared memory
  static constexpr int kChunks = HD / 8;           // 16-byte chunks in a row
  static constexpr int kBc = HD <= 128 ? 64 : 32;  // keys per tile of the forward and dq
  static constexpr bool kQInRegs = HD <= 128;      // Q's A fragments held in registers
  static constexpr int kTileQ = kBr * kLDS;        // elements of a 64-row tile
  static constexpr int kTileK = kBc * kLDS;        // elements of a key tile
  static constexpr int kSmem = (kTileQ + 4 * kTileK) * 2;        // Q, K x 2, V x 2
  static constexpr int kDqSmem = (2 * kTileQ + 4 * kTileK) * 2;  // Q, dO, K x 2, V x 2
  // blocks an SM holds: the forward twice at both head dims; dq twice at
  // hd 128 (104,448 B), once at hd 256 (135,168 B)
  static constexpr int kDqMinBlocks = HD <= 128 ? 2 : 1;
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

template <int HD>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Tn, int Hq, int Hkv,
    float softcap, int window) {
  using C = Tiles<HD>;
  constexpr int kBc = C::kBc, kLDS = C::kLDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + C::kTileQ;       // two stages
  __nv_bfloat16* sV = sK + 2 * C::kTileK;   // two stages
  __shared__ int seg_q[kBr], seg_k[2][kBc];
  __shared__ int s_first, s_last, s_lo;
  const int b = blockIdx.z, h = blockIdx.y;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kBr;  // longest key ranges first
  const int kh = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int* segb = seg + (long long)b * Tn;

  float o[HD / 8][4];  // n-tiles of d
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  tile_span<kBr>(segb, i0, Tn, seg_q, &s_first, &s_last);
  const int first = s_first, last = s_last;
  const int rq = warp * 16 + g;  // this thread's rows: rq and rq + 8
  if (first <= last) {
    const int i_first = i0 + first;
    int lo = segment_start(segb, i_first, &s_lo);
    if (window > 0) lo = max(lo, i_first - window + 1);
    const int hi = i0 + last + 1;
    const int ntiles = (hi - lo + kBc - 1) / kBc;
    // one segment id over all 64 q rows, or -3
    const int q_uniform = __syncthreads_and(tid >= kBr || seg_q[tid] == seg_q[0]) ? seg_q[0]
                                                                                  : -3;
    const int sq[2] = {seg_q[rq], seg_q[rq + 8]};
    const int qi[2] = {i0 + rq, i0 + rq + 8};

    load_tile_async<HD, kBr>(sQ, q, b, i0, Tn, Hq, h);
    load_tile_async<HD, kBc>(sK, k, b, lo, Tn, Hkv, kh);
    load_tile_async<HD, kBc>(sV, v, b, lo, Tn, Hkv, kh);
    asm volatile("cp.async.commit_group;\n" ::);
    if (tid < kBc) seg_k[0][tid] = lo + tid < Tn ? segb[lo + tid] : -2;

    unsigned qf[C::kQInRegs ? HD / 16 : 1][4];
    for (int n = 0; n < ntiles; ++n) {
      const int buf = n & 1, j0 = lo + n * kBc;
      if (n + 1 < ntiles) {  // prefetch the next tile into the other stage
        const int j1 = j0 + kBc;
        load_tile_async<HD, kBc>(sK + (buf ^ 1) * C::kTileK, k, b, j1, Tn, Hkv, kh);
        load_tile_async<HD, kBc>(sV + (buf ^ 1) * C::kTileK, v, b, j1, Tn, Hkv, kh);
        if (tid < kBc) seg_k[buf ^ 1][tid] = j1 + tid < Tn ? segb[j1 + tid] : -2;
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);  // this tile (and Q) landed
      const bool full = __syncthreads_and(tid >= kBc || seg_k[buf][tid] == q_uniform) &&
                        q_uniform >= 0 && window <= 0 && j0 + kBc - 1 <= i0;
      if constexpr (C::kQInRegs) {
        if (n == 0) {
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            ldmatrix_x4(qf[kk], a_frag<kLDS>(sQ, warp * 16, kk, lane));
        }
      }
      const __nv_bfloat16* tK = sK + buf * C::kTileK;
      const __nv_bfloat16* tV = sV + buf * C::kTileK;

      // S = Q K^T: n-tiles of 8 keys
      float s[kBc / 8][4];
#pragma unroll
      for (int j = 0; j < kBc / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        unsigned qa[4];
        if constexpr (C::kQInRegs) {
          qa[0] = qf[kk][0], qa[1] = qf[kk][1], qa[2] = qf[kk][2], qa[3] = qf[kk][3];
        } else {
          ldmatrix_x4(qa, a_frag<kLDS>(sQ, warp * 16, kk, lane));
        }
#pragma unroll
        for (int np = 0; np < kBc / 16; ++np) {
          unsigned r[4];
          ldmatrix_x4(r, b_frag<kLDS>(tK, np, kk, lane));
          mma(s[2 * np], qa, r[0], r[1]);
          mma(s[2 * np + 1], qa, r[2], r[3]);
        }
      }

      // softcap and mask on the fragments; row max across the quad
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kBc / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e >> 1, col = 8 * j + 2 * tig + (e & 1);
          float x = s[j][e];
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          if (!full && !allowed(sq[row], seg_k[buf][col], qi[row], j0 + col, window))
            x = -INFINITY;
          s[j][e] = x;
          mx[row] = fmaxf(mx[row], x);
        }
      }
      float alpha[2], mb[2];
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
        mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
        const float m_new = fmaxf(m[row], mx[row]);
        mb[row] = m_new == -INFINITY ? 0.f : m_new * kLog2e;
        alpha[row] = exp2f(m[row] * kLog2e - mb[row]);  // 0 while m is -inf
        m[row] = m_new;
        l[row] *= alpha[row];
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < kBc / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] * kLog2e - mb[e >> 1]);
          s[j][e] = p;
          l[e >> 1] += p;
        }
      }

      // O += P V: P as bf16 A fragments, V through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < kBc / 16; ++kk) {
        unsigned a[4];
        pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          unsigned r[4];
          ldmatrix_x4_trans(r, a_frag<kLDS>(tV, 16 * kk, dp, lane));
          mma(o[2 * dp], a, r[0], r[1]);
          mma(o[2 * dp + 1], a, r[2], r[3]);
        }
      }
      __syncthreads();  // this stage's readers are done before it is refilled
    }
    asm volatile("cp.async.wait_all;\n" ::);
  }

  // normalise, lse, and the output through shared memory (each warp writes
  // the rows of sQ that only it read)
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    l[row] += __shfl_xor_sync(0xffffffffu, l[row], 1);
    l[row] += __shfl_xor_sync(0xffffffffu, l[row], 2);
    const int t = i0 + rq + 8 * row;
    if (tig == 0 && t < Tn)
      lse[((long long)b * Hq + h) * Tn + t] = l[row] > 0.f ? m[row] + logf(l[row]) : -INFINITY;
  }
  stage_rows<HD>(sQ, o, rq, tig, l[0] > 0.f ? 1.f / l[0] : 0.f, l[1] > 0.f ? 1.f / l[1] : 0.f);
  __syncthreads();
  store_tile<HD>(out, sQ, b, i0, Tn, Hq, h);
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
// dq: a block owns 64 q rows of one q head (4 warps x 16 rows; Q fragments
// in registers at hd 128 and re-read from shared memory at hd 256, dO
// re-read by ldmatrix at each key tile) and walks its key range in
// double-buffered cp.async K/V tiles (64 keys at hd 128, 32 at hd 256): S =
// Q K^T and dP = dO V^T (K and V as non-transposed B fragments), then dQ +=
// dS K with dS packed to bf16 A fragments and K read through
// ldmatrix.trans.  The last q tiles, whose key ranges are longest, start
// first.
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
// P^T (and the softcap's tanh) from shared memory, forms dS^T and
// accumulates dK.  Each thread holds 128 accumulators, as at hd 128.
//
// Rounding: P (for dV) and dS (for dK and dQ) are rounded to bf16 before
// those products (the tensor cores take bf16), where splash and the plain
// versions keep them in f32; lse and di stay f32.

template <int HD>
__global__ void __launch_bounds__(kThreads, Tiles<HD>::kDqMinBlocks) flash_bwd_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di, __nv_bfloat16* __restrict__ dq, int Tn, int Hq, int Hkv,
    float softcap, int window) {
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
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kBr;  // longest key ranges first
  const int kh = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int* segb = seg + (long long)b * Tn;

  float acc[HD / 8][4];  // n-tiles of d
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  tile_span<kBr>(segb, i0, Tn, seg_q, &s_first, &s_last);
  const int first = s_first, last = s_last;
  const int rq = warp * 16 + g;  // this thread's rows: rq and rq + 8
  if (first <= last) {
    const int i_first = i0 + first;
    int lo = segment_start(segb, i_first, &s_lo);
    if (window > 0) lo = max(lo, i_first - window + 1);
    const int hi = i0 + last + 1;
    const int ntiles = (hi - lo + kBc - 1) / kBc;
    const int q_uniform = __syncthreads_and(tid >= kBr || seg_q[tid] == seg_q[0]) ? seg_q[0]
                                                                                  : -3;
    const int sq[2] = {seg_q[rq], seg_q[rq + 8]};
    const int qi[2] = {i0 + rq, i0 + rq + 8};
    float lse_r[2], di_r[2];
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const long long at = ((long long)b * Hq + h) * Tn + min(qi[row], Tn - 1);
      lse_r[row] = lse[at];
      di_r[row] = di[at];
    }

    load_tile_async<HD, kBr>(sQ, q, b, i0, Tn, Hq, h);
    load_tile_async<HD, kBr>(sdO, dout, b, i0, Tn, Hq, h);
    load_tile_async<HD, kBc>(sK, k, b, lo, Tn, Hkv, kh);
    load_tile_async<HD, kBc>(sV, v, b, lo, Tn, Hkv, kh);
    asm volatile("cp.async.commit_group;\n" ::);
    if (tid < kBc) seg_k[0][tid] = lo + tid < Tn ? segb[lo + tid] : -2;

    unsigned qf[C::kQInRegs ? HD / 16 : 1][4];
    for (int n = 0; n < ntiles; ++n) {
      const int buf = n & 1, j0 = lo + n * kBc;
      if (n + 1 < ntiles) {  // prefetch the next tile into the other stage
        const int j1 = j0 + kBc;
        load_tile_async<HD, kBc>(sK + (buf ^ 1) * C::kTileK, k, b, j1, Tn, Hkv, kh);
        load_tile_async<HD, kBc>(sV + (buf ^ 1) * C::kTileK, v, b, j1, Tn, Hkv, kh);
        if (tid < kBc) seg_k[buf ^ 1][tid] = j1 + tid < Tn ? segb[j1 + tid] : -2;
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);  // this tile (and Q, dO) landed
      const bool full = __syncthreads_and(tid >= kBc || seg_k[buf][tid] == q_uniform) &&
                        q_uniform >= 0 && window <= 0 && j0 + kBc - 1 <= i0;
      if constexpr (C::kQInRegs) {
        if (n == 0) {
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            ldmatrix_x4(qf[kk], a_frag<kLDS>(sQ, warp * 16, kk, lane));
        }
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
        unsigned qa[4], da[4];
        if constexpr (C::kQInRegs) {
          qa[0] = qf[kk][0], qa[1] = qf[kk][1], qa[2] = qf[kk][2], qa[3] = qf[kk][3];
        } else {
          ldmatrix_x4(qa, a_frag<kLDS>(sQ, warp * 16, kk, lane));
        }
        ldmatrix_x4(da, a_frag<kLDS>(sdO, warp * 16, kk, lane));
#pragma unroll
        for (int np = 0; np < kBc / 16; ++np) {
          unsigned r[4];
          ldmatrix_x4(r, b_frag<kLDS>(tK, np, kk, lane));
          mma(s[2 * np], qa, r[0], r[1]);
          mma(s[2 * np + 1], qa, r[2], r[3]);
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
  store_tile<HD>(dq, sQ, b, i0, Tn, Hq, h);
}

__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dkv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Tn, int Hq, int Hkv, float softcap, int window) {
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
  const int* segb = seg + (long long)b * Tn;

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  tile_span<kBc>(segb, j0, Tn, seg_k, &s_first, &s_last);
  const int first = s_first, last = s_last;
  const int rk = warp * 16 + g;  // this thread's keys: rk and rk + 8
  if (first <= last) {
    const int j_last = j0 + last;
    const int lo = j0 + first;  // causal: a query sees only keys at or before it
    int hi = segment_end(segb, j_last, Tn, &s_hi);
    if (window > 0) hi = min(hi, j_last + window);
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
      const int h = h_lo + n / ntiles, i0 = lo + (n % ntiles) * kBr;
      load_tile_async<HD, kBr>(sQ + buf * kTile, q, b, i0, Tn, Hq, h);
      load_tile_async<HD, kBr>(sdO + buf * kTile, dout, b, i0, Tn, Hq, h);
      if (tid < kBr) {
        const int t = i0 + tid;
        const long long at = ((long long)b * Hq + h) * Tn + t;
        seg_q[buf][tid] = t < Tn ? segb[t] : -2;
        lse_q[buf][tid] = t < Tn ? lse[at] : 0.f;
        di_q[buf][tid] = t < Tn ? di[at] : 0.f;
      }
    };
    load_tile_async<HD, kBc>(sK, k, b, j0, Tn, Hkv, kh);
    load_tile_async<HD, kBc>(sV, v, b, j0, Tn, Hkv, kh);
    stage(0, 0);
    asm volatile("cp.async.commit_group;\n" ::);

    for (int n = 0; n < total; ++n) {
      const int buf = n & 1, i0 = lo + (n % ntiles) * kBr;
      if (n + 1 < total) stage(n + 1, buf ^ 1);  // prefetch into the other stage
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);  // this step (and K, V) landed
      const bool full = __syncthreads_and(tid >= kBr || seg_q[buf][tid] == k_uniform) &&
                        k_uniform >= 0 && window <= 0 && i0 >= j0 + kBc - 1;
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
            const bool ok = full || allowed(seg_t[col], sk[row], i0 + col, kj[row], window);
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
  store_tile<HD>(dk, sQ, b, j0, Tn, Hkv, kh);
  store_tile<HD>(dv, sQ + kTile, b, j0, Tn, Hkv, kh);
}

constexpr int kDkv256Threads = 256;  // two groups of 4 warps
constexpr int kXLD = 32;             // row stride of the P^T hand-over tile (floats)
// K, V, Q x 2, dO x 2 (64 rows each), then P^T and tanh of a half tile
constexpr int kDkv256Smem = 6 * Tiles<256>::kTileQ * 2 + 2 * kBr * kXLD * 4;

__global__ void __launch_bounds__(kDkv256Threads, 1) flash_bwd_dkv_tc256_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Tn, int Hq, int Hkv, float softcap, int window) {
  constexpr int HD = 256, kNT = kDkv256Threads, kLDS = Tiles<HD>::kLDS;
  constexpr int kTile = Tiles<HD>::kTileQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kTile;
  __nv_bfloat16* sQ = sV + kTile;       // two stages
  __nv_bfloat16* sdO = sQ + 2 * kTile;  // two stages
  float* xP = reinterpret_cast<float*>(sdO + 2 * kTile);  // [64 keys][32 queries] P^T
  float* xT = xP + kBr * kXLD;                            // tanh(S^T / softcap)
  __shared__ int seg_k[kBr], seg_q[2][kBr];
  __shared__ float lse_q[2][kBr], di_q[2][kBr];
  __shared__ int s_first, s_last, s_hi;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int j0 = blockIdx.z * kBr;  // the first key tiles, longest query ranges, first
  const int group = Hq / Hkv, h_lo = kh * group;  // the group's q heads
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;  // 0: S^T, P^T and dV; 1: dP^T, dS^T and dK
  const int g = lane >> 2, tig = lane & 3;
  const int* segb = seg + (long long)b * Tn;

  float acc[HD / 8][4];  // dV (group 0) or dK (group 1): 16 keys x 256 a warp
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  tile_span<kBr>(segb, j0, Tn, seg_k, &s_first, &s_last);
  const int first = s_first, last = s_last;
  const int r0 = (warp & 3) * 16;  // the warp's first key in the tile
  const int rk = r0 + g;           // this thread's keys: rk and rk + 8
  if (first <= last) {
    const int j_last = j0 + last;
    const int lo = j0 + first;  // causal: a query sees only keys at or before it
    int hi = segment_end(segb, j_last, Tn, &s_hi);
    if (window > 0) hi = min(hi, j_last + window);
    const int ntiles = (hi - lo + kBr - 1) / kBr;
    const int total = group * ntiles;  // (q head, q tile) steps
    const int k_uniform = __syncthreads_and(tid >= kBr || seg_k[tid] == seg_k[0]) ? seg_k[0]
                                                                                  : -3;
    const int sk[2] = {seg_k[rk], seg_k[rk + 8]};
    const int kj[2] = {j0 + rk, j0 + rk + 8};

    auto stage = [&](int n, int buf) {
      const int h = h_lo + n / ntiles, i0 = lo + (n % ntiles) * kBr;
      load_tile_async<HD, kBr, kNT>(sQ + buf * kTile, q, b, i0, Tn, Hq, h);
      load_tile_async<HD, kBr, kNT>(sdO + buf * kTile, dout, b, i0, Tn, Hq, h);
      if (tid < kBr) {
        const int t = i0 + tid;
        const long long at = ((long long)b * Hq + h) * Tn + t;
        seg_q[buf][tid] = t < Tn ? segb[t] : -2;
        lse_q[buf][tid] = t < Tn ? lse[at] : 0.f;
        di_q[buf][tid] = t < Tn ? di[at] : 0.f;
      }
    };
    load_tile_async<HD, kBr, kNT>(sK, k, b, j0, Tn, Hkv, kh);
    load_tile_async<HD, kBr, kNT>(sV, v, b, j0, Tn, Hkv, kh);
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
                        k_uniform >= 0 && window <= 0 && i0 >= j0 + kBr - 1;
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

        if (wg == 0) {  // P^T on the fragments, handed to group 1
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
              const bool ok = full || allowed(seg_t[qc], sk[row], i0 + qc, kj[row], window);
              const float p = ok ? exp2f((s - lse_t[qc]) * kLog2e) : 0.f;
              x[j][e] = p;
              xP[(rk + 8 * row) * kXLD + col] = p;
              xT[(rk + 8 * row) * kXLD + col] = t;
            }
          }
        }
        __syncthreads();  // P^T handed over
        if (wg == 1) {  // dS^T = P^T * (dP^T - di), times 1 - t^2 under the softcap
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = e >> 1, col = 8 * j + 2 * tig + (e & 1);
              const int at = (rk + 8 * row) * kXLD + col;
              float ds = xP[at] * (x[j][e] - di_t[c0 + col]);
              if (softcap > 0.f) ds *= 1.f - xT[at] * xT[at];
              x[j][e] = ds;
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
        __syncthreads();  // the hand-over tile (and, after the second half, this stage) read
      }
    }
    asm volatile("cp.async.wait_all;\n" ::);
  }

  // dv (group 0) and dk (group 1) through shared memory (the Q stages),
  // then out in 16-byte stores
  stage_rows<HD>(sQ + wg * kTile, acc, rk, tig);
  __syncthreads();
  store_tile<HD, kNT>(dv, sQ, b, j0, Tn, Hkv, kh);
  store_tile<HD, kNT>(dk, sQ + kTile, b, j0, Tn, Hkv, kh);
}

}  // namespace tc

template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

cudaError_t check_shape(int hd, int Hq, int Hkv) {
  return ((hd == 128 || hd == 256) && Hkv > 0 && Hq % Hkv == 0) ? cudaSuccess
                                                                : cudaErrorInvalidValue;
}

template <typename T, int HD>
cudaError_t fwd(const void* q, const void* k, const void* v, const void* seg, void* out,
                void* lse, int B, int Tn, int Hq, int Hkv, float softcap, int window,
                cudaStream_t s) {
  constexpr int TILE = f32_tile<HD>(), kSmem = F32Tiles<HD, TILE>::kFwdSmem;
  auto kernel = flash_fwd_kernel<T, HD, TILE>;
  cudaError_t err = opt_in(kernel, kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Tn + TILE - 1) / TILE, Hq, B), kThreads, kSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(seg), static_cast<T*>(out), static_cast<float*>(lse), Tn, Hq,
      Hkv, softcap, window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t fwd_tc(const void* q, const void* k, const void* v, const void* seg, void* out,
                   void* lse, int B, int Tn, int Hq, int Hkv, float softcap, int window,
                   cudaStream_t s) {
  constexpr int kSmem = tc::Tiles<HD>::kSmem;
  auto kernel = tc::flash_fwd_tc_kernel<HD>;
  cudaError_t err = opt_in(kernel, kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Tn + tc::kBr - 1) / tc::kBr, Hq, B), tc::kThreads, kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(seg),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Tn, Hq, Hkv, softcap, window);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* seg,
                   const void* dout, const void* lse, const void* di, void* dq, int B, int Tn,
                   int Hq, int Hkv, float softcap, int window, cudaStream_t s) {
  constexpr int TILE = f32_tile<HD>(), kSmem = F32Tiles<HD, TILE>::kDqSmem;
  auto kernel = flash_bwd_dq_kernel<T, HD, TILE>;
  cudaError_t err = opt_in(kernel, kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Tn + TILE - 1) / TILE, Hq, B), kThreads, kSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(seg), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<T*>(dq), Tn,
      Hq, Hkv, softcap, window);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* seg,
                    const void* dout, const void* lse, const void* di, void* dk, void* dv,
                    int B, int Tn, int Hq, int Hkv, float softcap, int window,
                    cudaStream_t s) {
  constexpr int TILE = f32_tile<HD>(), kSmem = F32Tiles<HD, TILE>::kDkvSmem;
  auto kernel = flash_bwd_dkv_kernel<T, HD, TILE>;
  cudaError_t err = opt_in(kernel, kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Tn + TILE - 1) / TILE, Hkv, B), kThreads, kSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(seg), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<T*>(dk),
      static_cast<T*>(dv), Tn, Hq, Hkv, softcap, window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t bwd_dq_tc(const void* q, const void* k, const void* v, const void* seg,
                      const void* dout, const void* lse, const void* di, void* dq, int B,
                      int Tn, int Hq, int Hkv, float softcap, int window, cudaStream_t s) {
  constexpr int kSmem = tc::Tiles<HD>::kDqSmem;
  auto kernel = tc::flash_bwd_dq_tc_kernel<HD>;
  cudaError_t err = opt_in(kernel, kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Hq, B, (Tn + tc::kBr - 1) / tc::kBr), tc::kThreads, kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(seg),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<__nv_bfloat16*>(dq), Tn, Hq, Hkv, softcap,
      window);
  return cudaGetLastError();
}

// the dk/dv kernel of a head dim: 4 warps with dK and dV in each thread at
// hd 128, two groups of 4 warps at hd 256
template <int HD>
cudaError_t bwd_dkv_tc(const void* q, const void* k, const void* v, const void* seg,
                       const void* dout, const void* lse, const void* di, void* dk, void* dv,
                       int B, int Tn, int Hq, int Hkv, float softcap, int window,
                       cudaStream_t s) {
  auto kernel = HD == 128 ? tc::flash_bwd_dkv_tc_kernel : tc::flash_bwd_dkv_tc256_kernel;
  const int threads = HD == 128 ? tc::kThreads : tc::kDkv256Threads;
  const int smem = HD == 128 ? 6 * tc::Tiles<128>::kTileQ * 2 : tc::kDkv256Smem;
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Hkv, B, (Tn + tc::kBr - 1) / tc::kBr), threads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(seg),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Tn, Hq, Hkv, softcap, window);
  return cudaGetLastError();
}

}  // namespace

// bf16: 1 for bfloat16 inputs, 0 for float32.  hd: 128 or 256.  softcap <=
// 0 and window <= 0 are off.  q is the pre-scaled q_s.  Each entry picks its
// kernel by dtype and head dim: bfloat16 runs on the tensor cores
// (tc::flash_fwd_tc_kernel, tc::flash_bwd_dq_tc_kernel, and
// tc::flash_bwd_dkv_tc_kernel or tc::flash_bwd_dkv_tc256_kernel), float32 on
// the CUDA cores (flash_fwd_kernel, flash_bwd_dq_kernel,
// flash_bwd_dkv_kernel), which keeps f32 products exact.
extern "C" int flash_fwd(int device, int bf16, const void* q, const void* k, const void* v,
                         const void* seg, void* out, void* lse, int B, int Tn, int Hq,
                         int Hkv, int hd, float softcap, int window, void* stream) {
  cudaError_t err = check_shape(hd, Hq, Hkv);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return (int)(bf16 ? fwd_tc<128>(q, k, v, seg, out, lse, B, Tn, Hq, Hkv, softcap, window, s)
                      : fwd<float, 128>(q, k, v, seg, out, lse, B, Tn, Hq, Hkv, softcap,
                                        window, s));
  return (int)(bf16 ? fwd_tc<256>(q, k, v, seg, out, lse, B, Tn, Hq, Hkv, softcap, window, s)
                    : fwd<float, 256>(q, k, v, seg, out, lse, B, Tn, Hq, Hkv, softcap, window,
                                      s));
}

extern "C" int flash_bwd_dq(int device, int bf16, const void* q, const void* k, const void* v,
                            const void* seg, const void* dout, const void* lse, const void* di,
                            void* dq, int B, int Tn, int Hq, int Hkv, int hd, float softcap,
                            int window, void* stream) {
  cudaError_t err = check_shape(hd, Hq, Hkv);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return (int)(bf16 ? bwd_dq_tc<128>(q, k, v, seg, dout, lse, di, dq, B, Tn, Hq, Hkv,
                                       softcap, window, s)
                      : bwd_dq<float, 128>(q, k, v, seg, dout, lse, di, dq, B, Tn, Hq, Hkv,
                                           softcap, window, s));
  return (int)(bf16 ? bwd_dq_tc<256>(q, k, v, seg, dout, lse, di, dq, B, Tn, Hq, Hkv, softcap,
                                     window, s)
                    : bwd_dq<float, 256>(q, k, v, seg, dout, lse, di, dq, B, Tn, Hq, Hkv,
                                         softcap, window, s));
}

extern "C" int flash_bwd_dkv(int device, int bf16, const void* q, const void* k, const void* v,
                             const void* seg, const void* dout, const void* lse,
                             const void* di, void* dk, void* dv, int B, int Tn, int Hq, int Hkv,
                             int hd, float softcap, int window, void* stream) {
  cudaError_t err = check_shape(hd, Hq, Hkv);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return (int)(bf16 ? bwd_dkv_tc<128>(q, k, v, seg, dout, lse, di, dk, dv, B, Tn, Hq, Hkv,
                                        softcap, window, s)
                      : bwd_dkv<float, 128>(q, k, v, seg, dout, lse, di, dk, dv, B, Tn, Hq,
                                            Hkv, softcap, window, s));
  return (int)(bf16 ? bwd_dkv_tc<256>(q, k, v, seg, dout, lse, di, dk, dv, B, Tn, Hq, Hkv,
                                      softcap, window, s)
                    : bwd_dkv<float, 256>(q, k, v, seg, dout, lse, di, dk, dv, B, Tn, Hq, Hkv,
                                          softcap, window, s));
}
