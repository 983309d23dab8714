// Segment-masked causal flash attention for Hopper (sm_90a): the forward,
// dq and dk/dv kernels of the training and logprob path.
//
// Replaces the TPU splash-attention kernel that areal_tpu/ops/attention.py
// builds (`_make_kernel`) and launches (`_splash_call`, `_sharded_splash`):
// jax's splash forward, its dq kernel and its dk/dv kernel.  Per (row, q
// head) the kernels compute softmax(q_s k^T) v over the keys j of the same
// segment with j <= i (buffer-index causality), j > i - window when a left
// window is set, and an optional logit softcap tanh(s / c) * c.  q arrives
// pre-scaled by 1/sqrt(hd) (q_s, scaled by the wrapper in q's dtype, as
// splash is fed).  Padding (segment id < 0) attends nothing: its output is
// 0 and its lse -inf, and no (query, key) pair touching it is visited, so
// it neither sends nor receives gradient.
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
// (tc::flash_bwd_dkv_tc_kernel).  The f32 kernels stay plain and right
// rather than fast: they run on the CUDA cores in f32, because the tensor
// cores would round the f32 operands (TF32 at best).  Each such block
// stages 64-row tiles of q, k, v (and dout) in shared memory as f32 and
// keeps a 2 x 8 score tile and 2 x 16 output slices per thread in
// registers.  What every kernel keeps from splash: the blockwise softmax
// (no [T, T] score matrix ever reaches device memory) and the skipping of
// masked tiles.  Segments are contiguous, so a q tile needs only the keys
// from the segment start of its first valid query to its last query (and a
// k tile only the queries from its first key to the segment end of its last
// key); each block finds that range from the segment ids, and the window
// narrows it further.
//
// Grids: forward and dq one block per (q tile, q head, row); dk/dv one
// block per (k tile, kv head, row), looping over the group's q heads and
// the q tiles that see its keys, so GQA needs no atomics and every result
// is the same from run to run.
//
// Interface: plain C entry points bound with ctypes; each launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHD = 128;       // head dim (the wrapper's gate)
constexpr int kTile = 64;      // rows of a q or k tile
constexpr int kThreads = 256;  // thread (tr, tc): tr = tid / 8, tc = tid % 8
constexpr int kRows = 2;       // tile rows per thread: tr + 32 * i
constexpr int kCols = 8;       // score columns per thread: tc + 8 * j
constexpr int kDCols = 16;     // head-dim columns per thread: tc + 8 * j
constexpr int kLD = kHD + 1;   // row stride of a [64, hd] f32 tile (no bank conflicts)
constexpr int kLDP = kTile + 1;  // row stride of a [64, 64] f32 tile

constexpr int kTileFloats = kTile * kLD;
constexpr int kSqFloats = kTile * kLDP;
constexpr int kFwdSmem = (3 * kTileFloats + kSqFloats) * 4;
constexpr int kDqSmem = (4 * kTileFloats + kSqFloats) * 4;
constexpr int kDkvSmem = (4 * kTileFloats + 2 * kSqFloats) * 4;

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

// rows [r0, r0 + 64) of head h of a [B, T, H, hd] tensor -> f32 tile
// (rows outside [0, T) read as zero)
template <typename T>
__device__ void load_tile(float* dst, const T* __restrict__ src, int b, int r0, int Tn,
                          int H, int h) {
  for (int idx = threadIdx.x; idx < kTile * kHD; idx += kThreads) {
    const int r = idx / kHD, d = idx - r * kHD;
    const int t = r0 + r;
    dst[r * kLD + d] =
        (t >= 0 && t < Tn) ? to_f(src[(((long long)b * Tn + t) * H + h) * kHD + d]) : 0.f;
  }
}

// segment ids of rows [r0, r0 + 64) (-2 past T: matches nothing) and the
// first / last tile row holding a valid (>= 0) id; first > last if none
__device__ void tile_span(const int* __restrict__ segb, int r0, int Tn, int* seg_tile,
                          int* s_first, int* s_last) {
  if (threadIdx.x == 0) {
    *s_first = kTile;
    *s_last = -1;
  }
  if (threadIdx.x < kTile) {
    const int t = r0 + threadIdx.x;
    seg_tile[threadIdx.x] = t < Tn ? segb[t] : -2;
  }
  __syncthreads();
  if (threadIdx.x < kTile && seg_tile[threadIdx.x] >= 0) {
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
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm, int tr, int tc,
                                         float acc[kRows][kCols]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kHD; ++d) {
    float a[kRows], bb[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) a[i] = A[(tr + 32 * i) * kLD + d];
#pragma unroll
    for (int j = 0; j < kCols; ++j) bb[j] = Bm[(tc + 8 * j) * kLD + d];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c P[tr + 32 i][c] * M[c][tc + 8 j]: a [64, 64] square
// tile times a [64, hd] tile
__device__ __forceinline__ void tile_pv(const float* P, const float* M, int tr, int tc,
                                        float acc[kRows][kDCols]) {
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    float p[kRows], m[kDCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) p[i] = P[(tr + 32 * i) * kLDP + c];
#pragma unroll
    for (int j = 0; j < kDCols; ++j) m[j] = M[c * kLD + tc + 8 * j];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kDCols; ++j) acc[i][j] = fmaf(p[i], m[j], acc[i][j]);
  }
}

// write a thread's [2, 16] slice of rows [r0, r0 + 64) of head h
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float acc[kRows][kDCols],
                                           int b, int r0, int Tn, int H, int h, int tr,
                                           int tc) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = r0 + tr + 32 * i;
    if (t >= Tn) continue;
    T* row = dst + (((long long)b * Tn + t) * H + h) * kHD;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) row[tc + 8 * j] = from_f<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// forward: out and lse
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ seg, T* __restrict__ out, float* __restrict__ lse, int Tn,
    int Hq, int Hkv, float softcap, int window) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTileFloats;
  float* Vs = Ks + kTileFloats;
  float* Ps = Vs + kTileFloats;
  __shared__ int seg_q[kTile], seg_k[kTile];
  __shared__ int s_first, s_last, s_lo;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kTile;
  const int kh = h / (Hq / Hkv);
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
  const int* segb = seg + (long long)b * Tn;

  float m[kRows], l[kRows], o[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) o[i][j] = 0.f;
  }

  tile_span(segb, i0, Tn, seg_q, &s_first, &s_last);
  const int first = s_first, last = s_last;
  if (first <= last) {
    const int i_first = i0 + first;
    int lo = segment_start(segb, i_first, &s_lo);
    if (window > 0) lo = max(lo, i_first - window + 1);
    const int hi = i0 + last + 1;
    load_tile(Qs, q, b, i0, Tn, Hq, h);
    for (int j0 = lo; j0 < hi; j0 += kTile) {
      __syncthreads();  // the previous tile's readers are done
      load_tile(Ks, k, b, j0, Tn, Hkv, kh);
      load_tile(Vs, v, b, j0, Tn, Hkv, kh);
      if (threadIdx.x < kTile) {
        const int t = j0 + threadIdx.x;
        seg_k[threadIdx.x] = t < Tn ? segb[t] : -2;
      }
      __syncthreads();
      float s[kRows][kCols];
      tile_dot(Qs, Ks, tr, tc, s);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = tr + 32 * i, qi = i0 + r, sq = seg_q[r];
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
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
        for (int j = 0; j < kCols; ++j) {
          const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
          Ps[r * kLDP + tc + 8 * j] = p;
          sum += p;
        }
        l[i] = l[i] * alpha + row8_sum(sum);
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < kDCols; ++j) o[i][j] *= alpha;
      }
      __syncthreads();
      tile_pv(Ps, Vs, tr, tc, o);
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = i0 + tr + 32 * i;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) o[i][j] = l[i] > 0.f ? o[i][j] / l[i] : 0.f;
    if (tc == 0 && qi < Tn)
      lse[((long long)b * Hq + h) * Tn + qi] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
  store_rows(out, o, b, i0, Tn, Hq, h, tr, tc);
}

// ---------------------------------------------------------------------------
// dq: sum over keys of dS k, dS = P * (dP - di) (times 1 - t^2 under softcap)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ seg, const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di, T* __restrict__ dq, int Tn, int Hq, int Hkv, float softcap,
    int window) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTileFloats;
  float* Ks = dOs + kTileFloats;
  float* Vs = Ks + kTileFloats;
  float* dSs = Vs + kTileFloats;
  __shared__ int seg_q[kTile], seg_k[kTile];
  __shared__ int s_first, s_last, s_lo;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kTile;
  const int kh = h / (Hq / Hkv);
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
  const int* segb = seg + (long long)b * Tn;

  float acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kDCols; ++j) acc[i][j] = 0.f;

  tile_span(segb, i0, Tn, seg_q, &s_first, &s_last);
  const int first = s_first, last = s_last;
  if (first <= last) {
    const int i_first = i0 + first;
    int lo = segment_start(segb, i_first, &s_lo);
    if (window > 0) lo = max(lo, i_first - window + 1);
    const int hi = i0 + last + 1;
    load_tile(Qs, q, b, i0, Tn, Hq, h);
    load_tile(dOs, dout, b, i0, Tn, Hq, h);
    float lse_r[kRows], di_r[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = min(i0 + tr + 32 * i, Tn - 1);
      lse_r[i] = lse[((long long)b * Hq + h) * Tn + qi];
      di_r[i] = di[((long long)b * Hq + h) * Tn + qi];
    }
    for (int j0 = lo; j0 < hi; j0 += kTile) {
      __syncthreads();
      load_tile(Ks, k, b, j0, Tn, Hkv, kh);
      load_tile(Vs, v, b, j0, Tn, Hkv, kh);
      if (threadIdx.x < kTile) {
        const int t = j0 + threadIdx.x;
        seg_k[threadIdx.x] = t < Tn ? segb[t] : -2;
      }
      __syncthreads();
      float s[kRows][kCols], dp[kRows][kCols];
      tile_dot(Qs, Ks, tr, tc, s);
      tile_dot(dOs, Vs, tr, tc, dp);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = tr + 32 * i, qi = i0 + r, sq = seg_q[r];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = tc + 8 * j;
          float t;
          const float x = capped(s[i][j], softcap, &t);
          const bool ok = allowed(sq, seg_k[c], qi, j0 + c, window);
          const float p = ok ? expf(x - lse_r[i]) : 0.f;
          float ds = p * (dp[i][j] - di_r[i]);
          if (softcap > 0.f) ds *= 1.f - t * t;
          dSs[r * kLDP + c] = ds;
        }
      }
      __syncthreads();
      tile_pv(dSs, Ks, tr, tc, acc);
    }
  }
  store_rows(dq, acc, b, i0, Tn, Hq, h, tr, tc);
}

// ---------------------------------------------------------------------------
// dk / dv: per key tile, summed over the group's q heads and the q tiles
// that see it
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ seg, const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv, int Tn, int Hq,
    int Hkv, float softcap, int window) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTileFloats;
  float* Qs = Vs + kTileFloats;
  float* dOs = Qs + kTileFloats;
  float* Ps = dOs + kTileFloats;
  float* dSs = Ps + kSqFloats;
  __shared__ int seg_q[kTile], seg_k[kTile];
  __shared__ float lse_q[kTile], di_q[kTile];
  __shared__ int s_first, s_last, s_hi;
  const int b = blockIdx.z, kh = blockIdx.y, j0 = blockIdx.x * kTile;
  const int group = Hq / Hkv;
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
  const int* segb = seg + (long long)b * Tn;

  float dk_acc[kRows][kDCols], dv_acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kDCols; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  tile_span(segb, j0, Tn, seg_k, &s_first, &s_last);
  const int first = s_first, last = s_last;
  if (first <= last) {
    const int j_last = j0 + last;
    const int lo = j0 + first;  // causal: a query sees only keys at or before it
    int hi = segment_end(segb, j_last, Tn, &s_hi);
    if (window > 0) hi = min(hi, j_last + window);
    load_tile(Ks, k, b, j0, Tn, Hkv, kh);
    load_tile(Vs, v, b, j0, Tn, Hkv, kh);
    for (int g = 0; g < group; ++g) {
      const int h = kh * group + g;
      const float* lse_h = lse + ((long long)b * Hq + h) * Tn;
      const float* di_h = di + ((long long)b * Hq + h) * Tn;
      for (int i0 = lo; i0 < hi; i0 += kTile) {
        __syncthreads();  // the previous q tile's readers are done
        load_tile(Qs, q, b, i0, Tn, Hq, h);
        load_tile(dOs, dout, b, i0, Tn, Hq, h);
        if (threadIdx.x < kTile) {
          const int t = i0 + threadIdx.x;
          seg_q[threadIdx.x] = t < Tn ? segb[t] : -2;
          lse_q[threadIdx.x] = t < Tn ? lse_h[t] : 0.f;
          di_q[threadIdx.x] = t < Tn ? di_h[t] : 0.f;
        }
        __syncthreads();
        float st[kRows][kCols], dpt[kRows][kCols];  // rows: keys, columns: queries
        tile_dot(Ks, Qs, tr, tc, st);
        tile_dot(Vs, dOs, tr, tc, dpt);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int r = tr + 32 * i, kj = j0 + r, sk = seg_k[r];
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const int c = tc + 8 * j;
            float t;
            const float x = capped(st[i][j], softcap, &t);
            const bool ok = allowed(seg_q[c], sk, i0 + c, kj, window);
            const float p = ok ? expf(x - lse_q[c]) : 0.f;
            float ds = p * (dpt[i][j] - di_q[c]);
            if (softcap > 0.f) ds *= 1.f - t * t;
            Ps[r * kLDP + c] = p;
            dSs[r * kLDP + c] = ds;
          }
        }
        __syncthreads();
        tile_pv(Ps, dOs, tr, tc, dv_acc);
        tile_pv(dSs, Qs, tr, tc, dk_acc);
      }
    }
  }
  store_rows(dk, dk_acc, b, j0, Tn, Hkv, kh, tr, tc);
  store_rows(dv, dv_acc, b, j0, Tn, Hkv, kh, tr, tc);
}

// ---------------------------------------------------------------------------
// forward on the bf16 tensor cores (bf16 inputs)
// ---------------------------------------------------------------------------
//
// FlashAttention-2's pattern with mma.sync.m16n8k16 (bf16 in, f32 sums).
// A block owns 64 q rows of one q head; each of its 4 warps owns 16 rows
// and keeps their Q fragments in registers (loaded once by ldmatrix).  K
// and V tiles of 64 keys x 128 stay bf16 in shared memory, rows padded to
// 272 bytes so ldmatrix reads hit distinct banks, double-buffered and
// filled by 16-byte cp.async so the next tile's copy overlaps this tile's
// products.  S = Q K^T runs on the tensor cores; the softcap and the
// segment / causal / window mask act on the accumulator fragments (tiles
// wholly inside one segment and below the diagonal skip the mask); the
// online softmax takes row max and sum across each quad with shuffles.  P
// becomes bf16 A fragments in registers and O += P V reads V through
// ldmatrix.trans.  The output goes out through shared memory in 16-byte
// stores.  Key ranges come from the segment ids as in flash_fwd_kernel.
//
// P rounding: P is rounded to bf16 before the PV product (the tensor cores
// take bf16), where splash and flash_fwd_plain keep P in f32; l sums the
// unrounded f32 P, and lse is f32 as before.

namespace tc {

constexpr int kBr = 64;           // q rows per block
constexpr int kBc = 64;           // keys per tile
constexpr int kThreads = 128;     // 4 warps x 16 q rows
constexpr int kLDS = kHD + 8;     // bf16 row stride in shared memory (272 bytes)
constexpr int kTileElems = kBr * kLDS;
constexpr int kSmem = 5 * kTileElems * 2;  // Q, K x 2, V x 2
constexpr int kBwdSmem = 6 * kTileElems * 2;  // dq: Q, dO, K x 2, V x 2; dk/dv: K, V, Q x 2, dO x 2
constexpr float kLog2e = 1.4426950408889634f;

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

// rows [r0, r0 + 64) of head h of a [B, T, H, 128] bf16 tensor -> padded
// shared tile, by cp.async (rows outside [0, T) become zeros)
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* __restrict__ src, int b,
                                                int r0, int Tn, int H, int h) {
  for (int i = threadIdx.x; i < kBr * (kHD / 8); i += kThreads) {
    const int r = i >> 4, c = (i & 15) * 8;
    const int t = r0 + r;
    const bool ok = t >= 0 && t < Tn;
    const __nv_bfloat16* p = ok ? src + (((long long)b * Tn + t) * H + h) * kHD + c : src;
    cp_async16(dst + r * kLDS + c, p, ok ? 16 : 0);
  }
}

// ldmatrix addresses in a padded [rows][kLDS] tile.  A operand: rows
// [r0, r0 + 16), columns [16 c, 16 c + 16); ldmatrix.trans from the same
// address gives the B operand of a [k][n] tile (k rows from r0, the n-tile
// pair at columns 16 c).
__device__ __forceinline__ const __nv_bfloat16* a_frag(const __nv_bfloat16* t, int r0, int c,
                                                       int lane) {
  return t + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLDS + 16 * c + 8 * (lane >> 4);
}

// B operand of the n-tile pair (2 np, 2 np + 1) from an [n][k] tile (n rows
// [16 np, 16 np + 16), k columns [16 kk, 16 kk + 16)); r[0], r[1] feed n-tile
// 2 np and r[2], r[3] n-tile 2 np + 1
__device__ __forceinline__ const __nv_bfloat16* b_frag(const __nv_bfloat16* t, int np, int kk,
                                                       int lane) {
  return t + (16 * np + (lane & 7) + 8 * (lane >> 4)) * kLDS + 16 * kk + 8 * ((lane >> 3) & 1);
}

// two 16 x 8 accumulator tiles (columns 0-7 and 8-15) -> one bf16 A fragment
__device__ __forceinline__ void pack_a(unsigned a[4], const float lo[4], const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

__global__ void __launch_bounds__(kThreads, 2) flash_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Tn, int Hq, int Hkv,
    float softcap, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kTileElems;      // two stages
  __nv_bfloat16* sV = sK + 2 * kTileElems;  // two stages
  __shared__ int seg_q[kBr], seg_k[2][kBc];
  __shared__ int s_first, s_last, s_lo;
  const int b = blockIdx.z, h = blockIdx.y;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kBr;  // longest key ranges first
  const int kh = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int* segb = seg + (long long)b * Tn;

  float o[kHD / 8][4];  // 16 n-tiles of d
#pragma unroll
  for (int j = 0; j < kHD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  tile_span(segb, i0, Tn, seg_q, &s_first, &s_last);
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

    load_tile_async(sQ, q, b, i0, Tn, Hq, h);
    load_tile_async(sK, k, b, lo, Tn, Hkv, kh);
    load_tile_async(sV, v, b, lo, Tn, Hkv, kh);
    asm volatile("cp.async.commit_group;\n" ::);
    if (tid < kBc) seg_k[0][tid] = lo + tid < Tn ? segb[lo + tid] : -2;

    unsigned qf[kHD / 16][4];
    for (int n = 0; n < ntiles; ++n) {
      const int buf = n & 1, j0 = lo + n * kBc;
      if (n + 1 < ntiles) {  // prefetch the next tile into the other stage
        const int j1 = j0 + kBc;
        load_tile_async(sK + (buf ^ 1) * kTileElems, k, b, j1, Tn, Hkv, kh);
        load_tile_async(sV + (buf ^ 1) * kTileElems, v, b, j1, Tn, Hkv, kh);
        if (tid < kBc) seg_k[buf ^ 1][tid] = j1 + tid < Tn ? segb[j1 + tid] : -2;
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);  // this tile (and Q) landed
      const bool full = __syncthreads_and(tid >= kBc || seg_k[buf][tid] == q_uniform) &&
                        q_uniform >= 0 && window <= 0 && j0 + kBc - 1 <= i0;
      if (n == 0) {
#pragma unroll
        for (int kk = 0; kk < kHD / 16; ++kk) ldmatrix_x4(qf[kk], a_frag(sQ, warp * 16, kk, lane));
      }
      const __nv_bfloat16* tK = sK + buf * kTileElems;
      const __nv_bfloat16* tV = sV + buf * kTileElems;

      // S = Q K^T: 8 n-tiles of 8 keys
      float s[kBc / 8][4];
#pragma unroll
      for (int j = 0; j < kBc / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHD / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < kBc / 16; ++np) {
          unsigned r[4];
          ldmatrix_x4(r, b_frag(tK, np, kk, lane));
          mma(s[2 * np], qf[kk], r[0], r[1]);
          mma(s[2 * np + 1], qf[kk], r[2], r[3]);
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
      for (int j = 0; j < kHD / 8; ++j) {
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
        for (int dp = 0; dp < kHD / 16; ++dp) {
          unsigned r[4];
          ldmatrix_x4_trans(r, a_frag(tV, 16 * kk, dp, lane));
          mma(o[2 * dp], a, r[0], r[1]);
          mma(o[2 * dp + 1], a, r[2], r[3]);
        }
      }
      __syncthreads();  // this stage's readers are done before it is refilled
    }
    asm volatile("cp.async.wait_all;\n" ::);
  }

  // normalise, lse, and the output through shared memory (sQ is free)
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    l[row] += __shfl_xor_sync(0xffffffffu, l[row], 1);
    l[row] += __shfl_xor_sync(0xffffffffu, l[row], 2);
    const int t = i0 + rq + 8 * row;
    if (tig == 0 && t < Tn)
      lse[((long long)b * Hq + h) * Tn + t] = l[row] > 0.f ? m[row] + logf(l[row]) : -INFINITY;
  }
  const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f, l[1] > 0.f ? 1.f / l[1] : 0.f};
#pragma unroll
  for (int j = 0; j < kHD / 8; ++j) {
    const int c = 8 * j + 2 * tig;
    *reinterpret_cast<__nv_bfloat162*>(sQ + rq * kLDS + c) =
        __floats2bfloat162_rn(o[j][0] * inv[0], o[j][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(sQ + (rq + 8) * kLDS + c) =
        __floats2bfloat162_rn(o[j][2] * inv[1], o[j][3] * inv[1]);
  }
  __syncthreads();
  for (int i = tid; i < kBr * (kHD / 8); i += kThreads) {
    const int r = i >> 4, c = (i & 15) * 8;
    const int t = i0 + r;
    if (t < Tn)
      *reinterpret_cast<uint4*>(out + (((long long)b * Tn + t) * Hq + h) * kHD + c) =
          *reinterpret_cast<const uint4*>(sQ + r * kLDS + c);
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
// dq: a block owns 64 q rows of one q head (4 warps x 16 rows; Q fragments
// in registers, dO re-read by ldmatrix at each key tile) and walks its key
// range in double-buffered cp.async K/V tiles: S = Q K^T and dP = dO V^T
// (K and V as non-transposed B fragments), then dQ += dS K with dS packed
// to bf16 A fragments and K read through ldmatrix.trans.  The last q tiles,
// whose key ranges are longest, start first.
//
// dk/dv: a block owns 64 keys of one kv head (4 warps x 16 keys).  K and V
// stay in shared memory for the whole block and their A fragments are
// re-read at every q tile, which keeps the 128 f32 dK/dV accumulators a
// thread holds in registers.  It walks (q head of the group, q tile of its
// range) with double-buffered cp.async Q/dO tiles and their lse, di and
// segment ids in shared memory, and takes each tile in two halves of 32
// queries, so that S^T and dP^T add only 32 registers: S^T = K Q^T and
// dP^T = V dO^T (Q and dO as non-transposed B fragments), then dV += P^T dO
// and dK += dS^T Q with P^T and dS^T packed to bf16 A fragments and dO and Q
// read through ldmatrix.trans.  The first key tiles, whose query ranges are
// longest, start first.  No atomics.
//
// Rounding: P (for dV) and dS (for dK and dQ) are rounded to bf16 before
// those products (the tensor cores take bf16), where splash and the plain
// versions keep them in f32; lse and di stay f32.

__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di, __nv_bfloat16* __restrict__ dq, int Tn, int Hq, int Hkv,
    float softcap, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + kTileElems;
  __nv_bfloat16* sK = sdO + kTileElems;     // two stages
  __nv_bfloat16* sV = sK + 2 * kTileElems;  // two stages
  __shared__ int seg_q[kBr], seg_k[2][kBc];
  __shared__ int s_first, s_last, s_lo;
  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kBr;  // longest key ranges first
  const int kh = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int* segb = seg + (long long)b * Tn;

  float acc[kHD / 8][4];  // 16 n-tiles of d
#pragma unroll
  for (int j = 0; j < kHD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  tile_span(segb, i0, Tn, seg_q, &s_first, &s_last);
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

    load_tile_async(sQ, q, b, i0, Tn, Hq, h);
    load_tile_async(sdO, dout, b, i0, Tn, Hq, h);
    load_tile_async(sK, k, b, lo, Tn, Hkv, kh);
    load_tile_async(sV, v, b, lo, Tn, Hkv, kh);
    asm volatile("cp.async.commit_group;\n" ::);
    if (tid < kBc) seg_k[0][tid] = lo + tid < Tn ? segb[lo + tid] : -2;

    unsigned qf[kHD / 16][4];
    for (int n = 0; n < ntiles; ++n) {
      const int buf = n & 1, j0 = lo + n * kBc;
      if (n + 1 < ntiles) {  // prefetch the next tile into the other stage
        const int j1 = j0 + kBc;
        load_tile_async(sK + (buf ^ 1) * kTileElems, k, b, j1, Tn, Hkv, kh);
        load_tile_async(sV + (buf ^ 1) * kTileElems, v, b, j1, Tn, Hkv, kh);
        if (tid < kBc) seg_k[buf ^ 1][tid] = j1 + tid < Tn ? segb[j1 + tid] : -2;
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);  // this tile (and Q, dO) landed
      const bool full = __syncthreads_and(tid >= kBc || seg_k[buf][tid] == q_uniform) &&
                        q_uniform >= 0 && window <= 0 && j0 + kBc - 1 <= i0;
      if (n == 0) {
#pragma unroll
        for (int kk = 0; kk < kHD / 16; ++kk) ldmatrix_x4(qf[kk], a_frag(sQ, warp * 16, kk, lane));
      }
      const __nv_bfloat16* tK = sK + buf * kTileElems;
      const __nv_bfloat16* tV = sV + buf * kTileElems;

      // S = Q K^T and dP = dO V^T: 8 n-tiles of 8 keys each
      float s[kBc / 8][4], dp[kBc / 8][4];
#pragma unroll
      for (int j = 0; j < kBc / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHD / 16; ++kk) {
        unsigned da[4];
        ldmatrix_x4(da, a_frag(sdO, warp * 16, kk, lane));
#pragma unroll
        for (int np = 0; np < kBc / 16; ++np) {
          unsigned r[4];
          ldmatrix_x4(r, b_frag(tK, np, kk, lane));
          mma(s[2 * np], qf[kk], r[0], r[1]);
          mma(s[2 * np + 1], qf[kk], r[2], r[3]);
          ldmatrix_x4(r, b_frag(tV, np, kk, lane));
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
        for (int c = 0; c < kHD / 16; ++c) {
          unsigned r[4];
          ldmatrix_x4_trans(r, a_frag(tK, 16 * kk, c, lane));
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
#pragma unroll
  for (int j = 0; j < kHD / 8; ++j) {
    const int c = 8 * j + 2 * tig;
    *reinterpret_cast<__nv_bfloat162*>(sQ + rq * kLDS + c) =
        __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(sQ + (rq + 8) * kLDS + c) =
        __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
  __syncthreads();
  for (int i = tid; i < kBr * (kHD / 8); i += kThreads) {
    const int r = i >> 4, c = (i & 15) * 8;
    const int t = i0 + r;
    if (t < Tn)
      *reinterpret_cast<uint4*>(dq + (((long long)b * Tn + t) * Hq + h) * kHD + c) =
          *reinterpret_cast<const uint4*>(sQ + r * kLDS + c);
  }
}

__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dkv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Tn, int Hq, int Hkv, float softcap, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kTileElems;
  __nv_bfloat16* sQ = sV + kTileElems;       // two stages
  __nv_bfloat16* sdO = sQ + 2 * kTileElems;  // two stages
  __shared__ int seg_k[kBc], seg_q[2][kBr];
  __shared__ float lse_q[2][kBr], di_q[2][kBr];
  __shared__ int s_first, s_last, s_hi;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int j0 = blockIdx.z * kBc;  // the first key tiles, longest query ranges, first
  const int group = Hq / Hkv, h_lo = kh * group;  // the group's q heads
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int* segb = seg + (long long)b * Tn;

  float dk_acc[kHD / 8][4], dv_acc[kHD / 8][4];
#pragma unroll
  for (int j = 0; j < kHD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  tile_span(segb, j0, Tn, seg_k, &s_first, &s_last);
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
      load_tile_async(sQ + buf * kTileElems, q, b, i0, Tn, Hq, h);
      load_tile_async(sdO + buf * kTileElems, dout, b, i0, Tn, Hq, h);
      if (tid < kBr) {
        const int t = i0 + tid;
        const long long at = ((long long)b * Hq + h) * Tn + t;
        seg_q[buf][tid] = t < Tn ? segb[t] : -2;
        lse_q[buf][tid] = t < Tn ? lse[at] : 0.f;
        di_q[buf][tid] = t < Tn ? di[at] : 0.f;
      }
    };
    load_tile_async(sK, k, b, j0, Tn, Hkv, kh);
    load_tile_async(sV, v, b, j0, Tn, Hkv, kh);
    stage(0, 0);
    asm volatile("cp.async.commit_group;\n" ::);

    for (int n = 0; n < total; ++n) {
      const int buf = n & 1, i0 = lo + (n % ntiles) * kBr;
      if (n + 1 < total) stage(n + 1, buf ^ 1);  // prefetch into the other stage
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);  // this step (and K, V) landed
      const bool full = __syncthreads_and(tid >= kBr || seg_q[buf][tid] == k_uniform) &&
                        k_uniform >= 0 && window <= 0 && i0 >= j0 + kBc - 1;
      const __nv_bfloat16* tQ = sQ + buf * kTileElems;
      const __nv_bfloat16* tdO = sdO + buf * kTileElems;
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
        for (int kk = 0; kk < kHD / 16; ++kk) {
          unsigned ka[4], va[4];
          ldmatrix_x4(ka, a_frag(sK, warp * 16, kk, lane));
          ldmatrix_x4(va, a_frag(sV, warp * 16, kk, lane));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            unsigned r[4];
            ldmatrix_x4(r, b_frag(tQ, 2 * half + np, kk, lane));
            mma(st[2 * np], ka, r[0], r[1]);
            mma(st[2 * np + 1], ka, r[2], r[3]);
            ldmatrix_x4(r, b_frag(tdO, 2 * half + np, kk, lane));
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
          for (int c = 0; c < kHD / 16; ++c) {
            unsigned r[4];
            ldmatrix_x4_trans(r, a_frag(tdO, c0 + 16 * kk, c, lane));
            mma(dv_acc[2 * c], pa, r[0], r[1]);
            mma(dv_acc[2 * c + 1], pa, r[2], r[3]);
            ldmatrix_x4_trans(r, a_frag(tQ, c0 + 16 * kk, c, lane));
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
  __nv_bfloat16* oK = sQ;
  __nv_bfloat16* oV = sQ + kTileElems;
#pragma unroll
  for (int j = 0; j < kHD / 8; ++j) {
    const int c = 8 * j + 2 * tig;
    *reinterpret_cast<__nv_bfloat162*>(oK + rk * kLDS + c) =
        __floats2bfloat162_rn(dk_acc[j][0], dk_acc[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(oK + (rk + 8) * kLDS + c) =
        __floats2bfloat162_rn(dk_acc[j][2], dk_acc[j][3]);
    *reinterpret_cast<__nv_bfloat162*>(oV + rk * kLDS + c) =
        __floats2bfloat162_rn(dv_acc[j][0], dv_acc[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(oV + (rk + 8) * kLDS + c) =
        __floats2bfloat162_rn(dv_acc[j][2], dv_acc[j][3]);
  }
  __syncthreads();
  for (int i = tid; i < kBc * (kHD / 8); i += kThreads) {
    const int r = i >> 4, c = (i & 15) * 8;
    const int t = j0 + r;
    if (t < Tn) {
      const long long at = (((long long)b * Tn + t) * Hkv + kh) * kHD + c;
      *reinterpret_cast<uint4*>(dk + at) = *reinterpret_cast<const uint4*>(oK + r * kLDS + c);
      *reinterpret_cast<uint4*>(dv + at) = *reinterpret_cast<const uint4*>(oV + r * kLDS + c);
    }
  }
}

}  // namespace tc

template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

cudaError_t check_shape(int hd, int Hq, int Hkv) {
  return (hd == kHD && Hkv > 0 && Hq % Hkv == 0) ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, const void* seg, void* out,
                void* lse, int B, int Tn, int Hq, int Hkv, float softcap, int window,
                cudaStream_t s) {
  auto kernel = flash_fwd_kernel<T>;
  cudaError_t err = opt_in(kernel, kFwdSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Tn + kTile - 1) / kTile, Hq, B), kThreads, kFwdSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(seg), static_cast<T*>(out), static_cast<float*>(lse), Tn, Hq,
      Hkv, softcap, window);
  return cudaGetLastError();
}

cudaError_t fwd_tc(const void* q, const void* k, const void* v, const void* seg, void* out,
                   void* lse, int B, int Tn, int Hq, int Hkv, float softcap, int window,
                   cudaStream_t s) {
  auto kernel = tc::flash_fwd_tc_kernel;
  cudaError_t err = opt_in(kernel, tc::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Tn + tc::kBr - 1) / tc::kBr, Hq, B), tc::kThreads, tc::kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(seg),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Tn, Hq, Hkv, softcap, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* seg,
                   const void* dout, const void* lse, const void* di, void* dq, int B, int Tn,
                   int Hq, int Hkv, float softcap, int window, cudaStream_t s) {
  auto kernel = flash_bwd_dq_kernel<T>;
  cudaError_t err = opt_in(kernel, kDqSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Tn + kTile - 1) / kTile, Hq, B), kThreads, kDqSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(seg), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<T*>(dq), Tn,
      Hq, Hkv, softcap, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* seg,
                    const void* dout, const void* lse, const void* di, void* dk, void* dv,
                    int B, int Tn, int Hq, int Hkv, float softcap, int window,
                    cudaStream_t s) {
  auto kernel = flash_bwd_dkv_kernel<T>;
  cudaError_t err = opt_in(kernel, kDkvSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Tn + kTile - 1) / kTile, Hkv, B), kThreads, kDkvSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(seg), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<T*>(dk),
      static_cast<T*>(dv), Tn, Hq, Hkv, softcap, window);
  return cudaGetLastError();
}

cudaError_t bwd_dq_tc(const void* q, const void* k, const void* v, const void* seg,
                      const void* dout, const void* lse, const void* di, void* dq, int B,
                      int Tn, int Hq, int Hkv, float softcap, int window, cudaStream_t s) {
  auto kernel = tc::flash_bwd_dq_tc_kernel;
  cudaError_t err = opt_in(kernel, tc::kBwdSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Hq, B, (Tn + tc::kBr - 1) / tc::kBr), tc::kThreads, tc::kBwdSmem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(seg),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<__nv_bfloat16*>(dq), Tn, Hq, Hkv, softcap,
      window);
  return cudaGetLastError();
}

cudaError_t bwd_dkv_tc(const void* q, const void* k, const void* v, const void* seg,
                       const void* dout, const void* lse, const void* di, void* dk, void* dv,
                       int B, int Tn, int Hq, int Hkv, float softcap, int window,
                       cudaStream_t s) {
  auto kernel = tc::flash_bwd_dkv_tc_kernel;
  cudaError_t err = opt_in(kernel, tc::kBwdSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Hkv, B, (Tn + tc::kBc - 1) / tc::kBc), tc::kThreads, tc::kBwdSmem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(seg),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Tn, Hq, Hkv, softcap, window);
  return cudaGetLastError();
}

}  // namespace

// bf16: 1 for bfloat16 inputs, 0 for float32.  softcap <= 0 and window <= 0
// are off.  q is the pre-scaled q_s.  Each entry picks its kernel by dtype:
// bfloat16 runs on the tensor cores (tc::flash_fwd_tc_kernel,
// tc::flash_bwd_dq_tc_kernel, tc::flash_bwd_dkv_tc_kernel), float32 on the
// CUDA cores (flash_fwd_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel),
// which keeps f32 products exact.
extern "C" int flash_fwd(int device, int bf16, const void* q, const void* k, const void* v,
                         const void* seg, void* out, void* lse, int B, int Tn, int Hq,
                         int Hkv, int hd, float softcap, int window, void* stream) {
  cudaError_t err = check_shape(hd, Hq, Hkv);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? fwd_tc(q, k, v, seg, out, lse, B, Tn, Hq, Hkv, softcap, window, s)
                    : fwd<float>(q, k, v, seg, out, lse, B, Tn, Hq, Hkv, softcap, window, s));
}

extern "C" int flash_bwd_dq(int device, int bf16, const void* q, const void* k, const void* v,
                            const void* seg, const void* dout, const void* lse, const void* di,
                            void* dq, int B, int Tn, int Hq, int Hkv, int hd, float softcap,
                            int window, void* stream) {
  cudaError_t err = check_shape(hd, Hq, Hkv);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? bwd_dq_tc(q, k, v, seg, dout, lse, di, dq, B, Tn, Hq, Hkv, softcap,
                                window, s)
                    : bwd_dq<float>(q, k, v, seg, dout, lse, di, dq, B, Tn, Hq, Hkv, softcap,
                                    window, s));
}

extern "C" int flash_bwd_dkv(int device, int bf16, const void* q, const void* k, const void* v,
                             const void* seg, const void* dout, const void* lse,
                             const void* di, void* dk, void* dv, int B, int Tn, int Hq, int Hkv,
                             int hd, float softcap, int window, void* stream) {
  cudaError_t err = check_shape(hd, Hq, Hkv);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? bwd_dkv_tc(q, k, v, seg, dout, lse, di, dk, dv, B, Tn, Hq, Hkv, softcap,
                                 window, s)
                    : bwd_dkv<float>(q, k, v, seg, dout, lse, di, dk, dv, B, Tn, Hq, Hkv,
                                     softcap, window, s));
}
