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
//
// What bounds it on this card: operations.  Attention over a packed row
// does ~4 hd flops per attended (q, k) pair forward (8 and 6 for dk/dv and
// dq) against ~2 hd bytes of q/k/v per token, far above the ~300 flops per
// byte where the H100's arithmetic becomes the limit.
//
// What the design does about it, for now.  This first kernel is plain and
// right rather than fast: it runs on the CUDA cores in f32 (no tensor
// cores, no wgmma or TMA), so it is bounded by the f32 FMA rate and by
// shared-memory traffic, not by the bf16 tensor-core peak.  Each block
// stages 64-row tiles of q, k, v (and dout) in shared memory as f32 and
// keeps a 2 x 8 score tile and 2 x 16 output slices per thread in
// registers.  What it keeps from splash: the blockwise online softmax (no
// [T, T] score matrix ever reaches device memory) and the skipping of
// masked tiles.  Segments are contiguous, so a q tile needs only the keys
// from the segment start of its first valid query to its last query (and a
// k tile only the queries from its first key to the segment end of its
// last key); each block finds that range from the segment ids, and the
// window narrows it further.
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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
  for (int base = i - 1; base >= 0; base -= kThreads) {
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
  for (int base = i + 1; base < Tn; base += kThreads) {
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

}  // namespace

// bf16: 1 for bfloat16 inputs, 0 for float32.  softcap <= 0 and window <= 0
// are off.  q is the pre-scaled q_s.
extern "C" int flash_fwd(int device, int bf16, const void* q, const void* k, const void* v,
                         const void* seg, void* out, void* lse, int B, int Tn, int Hq,
                         int Hkv, int hd, float softcap, int window, void* stream) {
  cudaError_t err = check_shape(hd, Hq, Hkv);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? fwd<__nv_bfloat16>(q, k, v, seg, out, lse, B, Tn, Hq, Hkv, softcap,
                                         window, s)
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
  return (int)(bf16 ? bwd_dq<__nv_bfloat16>(q, k, v, seg, dout, lse, di, dq, B, Tn, Hq, Hkv,
                                            softcap, window, s)
                    : bwd_dq<float>(q, k, v, seg, dout, lse, di, dq, B, Tn, Hq, Hkv, softcap,
                                    window, s));
}

extern "C" int flash_bwd_dkv(int device, int bf16, const void* q, const void* k, const void* v,
                             const void* seg, const void* dout, const void* lse,
                             const void* di, void* dk, void* dv, int B, int Tn, int Hq,
                             int Hkv, int hd, float softcap, int window, void* stream) {
  cudaError_t err = check_shape(hd, Hq, Hkv);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? bwd_dkv<__nv_bfloat16>(q, k, v, seg, dout, lse, di, dk, dv, B, Tn, Hq,
                                             Hkv, softcap, window, s)
                    : bwd_dkv<float>(q, k, v, seg, dout, lse, di, dk, dv, B, Tn, Hq, Hkv,
                                     softcap, window, s));
}
