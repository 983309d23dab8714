// Ragged paged-decode attention for Hopper (sm_90a), with the K/V append
// fused in: split-K over fixed chunks of key positions.
//
// Replaces the TPU kernel `_kernel` in areal_tpu/ops/ragged_decode.py
// (pallas_call in `_ragged_call`, public `ragged_paged_attention`).  One
// call is one layer's decode (T = 1) or verify (T = D + 1) attention for
// the whole slot grid.  For each slot it reads the slot's physical cache
// row from the page table, appends the new K/V in place at `widx` (index M
// drops the write), reads only the pages the slot's span covers, and keeps
// `naive_attention`'s op order: scores rounded to the compute type, then
// f32, times 1/sqrt(hd), optional softcap, mask to MASK_VALUE; the softmax
// max and sum over all K columns; probabilities exp(s - m) / l rounded to
// the compute type; PV with f32 sums, rounded once.  Columns past the
// copied pages count as zero K/V: score 0 where the mask admits them (they
// add exp(0 - m) to l), no PV contribution, as in the TPU kernel's
// zero-filled scratch.
//
// What bounds it on this card: bytes, and below them latency.  Per slot and
// kv head it reads the occupied pages of K and V once (span x hd x 2 x
// itemsize) and does ~4 x R x hd flops per column, R = T x group query
// rows: ~6 flops per byte at T = 1 and ~50 at a verify's T = 8, both below
// the bf16 tensor cores' ~300.  At these sizes (a few MB a call) the bound
// is a few microseconds, so launches, dependent loads and barriers are
// what a design has to keep short.
//
// Three variants, picked by (dtype, T, R, hd) alone (ragged_decode_launch;
// ops/ragged_decode.py variant mirrors it):
//
// dec::ragged_dec: bf16 q and cache, R <= 16 (every family's decode, T = 1,
// and the verifies of 8 and 16 rows), hd 64, 128 or 256.  One launch, no
// scratch.  What held the decode back before it: three dependent launches
// with an f32 score matrix [B, Hkv, R, K] and partial outputs in device
// memory, one wave of 16-byte copies per 64-key block, V loaded only by
// the second launch, and a grid over every chunk of the window K whatever
// a slot's span (0.0273 ms of device time at the serving shape against a
// bound of 0.0028, an H100 at 700 W).  Design: the key axis is cut into
// fixed chunks of kChunk positions; a thread block cluster takes one (kv
// head, slot), and chunk c belongs to block c % ranks, ranks a function of
// K and Hkv alone (ranks_for), so a key position's block never depends on
// the batch or the span.  A block streams the K and V rows of its copied
// chunks (copied_end): thread 0 keeps TMA loads of 64-key tiles, 64-column
// panels in the 128-byte swizzle, in flight into a ring of kNS slots, each
// with its mbarrier (a K tile brings its mask columns by a bulk copy), so
// V lands while the scores are computed and the next chunk's loads start
// as a slot frees; the ring holds one chunk's K and V, which keeps a block
// small enough that four share an SM at hd 128 (see kNS); the threads
// zero the rows past the copied span and write this call's new rows into
// the landed tile (write-then-read).  The window's chunks past the span are
// only counted from the mask.  One walk: per chunk, warp w takes its 16
// keys: S = Q K^T on mma.sync.m16n8k16 (the kv head's R query rows one m16
// tile; K read from the swizzled tile by ldmatrix), each score finished
// (bf16, scale, softcap, mask), the running (max, sum) of each row over the
// warp's keys, p = exp(s - max) rounded to bf16 as the A operand straight
// from the accumulators, and the warp's partial O = O alpha + P V over
// every head-dim column.  The four warps' partials fold in warp order
// (with the columns past the span, which add to the sums only), the
// cluster's ranks in rank order through distributed shared memory, and
// each block sums a slice of the outputs, divides by the global sum and
// rounds once.
// This departs from naive_attention's rounding points, as FlashAttention's
// decoding does: p is rounded to bf16 as exp(s - m_warp) against a running
// maximum, not as round(exp(s - m) / l) against the global statistics, and
// the rescales and the division by l are f32.  Keeping those points needs
// the global statistics before any P V: a second pass over K and a cluster
// barrier in the middle; a version of this kernel built that way took
// longer at every decode shape on an H100.  The result stays within
// chip_smoke.py's BF16_ATOL / BF16_RTOL (2e-2) of the plain version.  Kept: the fixed chunk boundaries and the
// warp- and rank-order folds, which make a row's bits independent of the
// batch and of reruns, and the append by the block that owns the position.
//
// tc::ragged_tc: a verify (T > 1) with bf16 q and cache, of kMinRows (17)
// to kMaxRows (64) query rows a kv head and hd <= 256: one launch on the
// bf16 tensor cores.  The key axis is cut into the same chunks and a
// cluster of up to kMaxCluster blocks takes one (kv head, slot); block
// `rank` owns the consecutive chunks [rank x cpb, (rank + 1) x cpb), cpb =
// ceil(chunks / kMaxCluster), so the split depends on K alone.  A block
// holds the R query rows (padded to 16) in shared memory and walks its
// chunks twice, the chunk's K (and V) rows arriving by 16-byte cp.async
// into a two-slot ring:
//   pass 1: S = Q K^T on mma.sync.m16n8k16 (bf16 in, f32 sums; Q through
//     ldmatrix, K as non-transposed B fragments), the score finished per
//     element, and each row's running (max, sum of exp(s - max)) over the
//     block's columns; the cluster folds the blocks' statistics in rank
//     order through distributed shared memory.
//   pass 2: S again from the same keys (still in the ring when a block has
//     at most two chunks, otherwise re-read from L2), p = round(exp(s - m) /
//     l) stored to shared memory as bf16, and the block's partial P V on
//     mma.sync with V read through ldmatrix.trans.  The partials meet in
//     shared memory and each block sums a slice of the outputs over the
//     cluster's ranks in rank order, rounds once and stores.
// The products of bf16 values are exact in f32, so against the CUDA-core
// passes below only the order of the f32 sums moves, not a rounding point.
// It lost to the passes at 16 rows or fewer (a 16-row tile of mma costs
// the same at 8 rows as at 16, and its chain of loads, cluster barriers and
// remote reads took 1.1-3.4x the passes' time at T = 1): dec above takes
// those rows with one m16 tile, K and V requested at once, and one pass's
// worth of barriers.
//
// The CUDA-core passes: f32 or mixed q / cache (the tensor cores would round
// f32 operands) and bf16 verifies past 64 rows.  A chunk's K or V rows
// arrive by 16-byte cp.async in the cache's own dtype (rows padded by 16
// bytes) and are widened to f32 in registers; a block whose chunk lies
// wholly past the slot's copied span reads no K/V.  Three launches, one
// block per (chunk, kv head, slot) each, with f32 scratch the wrapper
// allocates:
//   (a) ragged_scores: append, scores of the chunk into scratch [B, Hkv,
//       R, K], and the chunk's (max, sum of exp(s - max)) per row;
//   (b) ragged_pv: per row the global (m, l) folded from the chunk
//       statistics in chunk order, p = round(exp(s - m) / l) for the
//       chunk's copied columns, and the chunk's partial PV in f32;
//   (c) ragged_combine: per output element the partials summed in chunk
//       order, rounded once and stored.
// Every variant uses fixed key positions and no atomics in a sum: a slot's
// output does not depend on which slots share the batch, and reruns are
// bit-equal.  They sum in other orders, so in bf16 a row on one variant may
// differ in the last bit from the same row on another.
//
// Fused append, write-then-read: the block that owns a write position
// stores k_new / v_new there; a block copying a written position takes its
// row from k_new / v_new (dec, tc) or patches its copy with it (CUDA cores;
// V is read only by pass (b), after pass (a) ended).  Positions in [K, M)
// are written by one block (dec: rank 0; tc and the passes: the block of
// the last chunk) and never read.
//
// Interface: a plain C entry point bound with ctypes; it launches on the
// caller's stream and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -2.3819763e38f;
constexpr int kThreads = 128;
constexpr int kChunk = 64;   // key positions per chunk
constexpr int kRowBlock = 8;  // query rows a thread sums at once

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the value of x once stored in T (round to nearest even for bf16)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// eight consecutive elements of a shared-memory row (16-byte aligned) as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float out[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float out[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// one score after the dot product: compute-type rounding, scale, softcap, mask
template <typename QT>
__device__ __forceinline__ float finish_score(float dot, float scale, float softcap, bool keep) {
  float s = round_to<QT>(dot) * scale;
  if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
  return keep ? s : kMaskValue;
}

// the end of the columns a slot copies: the span [0, len + T) rounded up to
// whole pages, or K when the span reaches past the last full page
__device__ __forceinline__ int copied_end(int length, int T, int K, int page) {
  const int span = min(length + T, K);
  const int n_full = K / page;
  const int npages = min((span + page - 1) / page, n_full);
  return span > n_full * page ? K : npages * page;
}

struct Args {
  const void* q;      // [B, T, Hq, hd] compute type
  const void* k_new;  // [B, T, Hkv, hd] cache type
  const void* v_new;
  void* ck;  // [S, M, Hkv, hd], appended in place
  void* cv;
  const int* rows;      // [B] physical cache row per slot
  const int* lengths;   // [B] cache fill per slot
  const int* widx;      // [B, T] write positions, M = drop
  const uint8_t* mask;  // [B, T, K] attended positions
  void* out;            // [B, T, Hq, hd] compute type
  float* scores;        // [B, Hkv, R, K]
  float* cmax;          // [B, Hkv, R, nchunks]
  float* csum;          // [B, Hkv, R, nchunks]
  float* partial;       // [B, Hkv, nchunks, R, hd]
  int T, Hq, Hkv, hd, M, K, page, nchunks;
  int cpb;  // tensor cores: chunks per block of a cluster
  float scale, softcap;
};

// padded shared-memory row of one cached key or value, in elements
template <typename KT> __host__ __device__ __forceinline__ int row_stride(int hd) {
  return hd + 16 / (int)sizeof(KT);
}

// async copy of cached rows [c0, c0 + n) of one (row, kv head) into smem
template <typename KT>
__device__ __forceinline__ void copy_rows(KT* dst, const KT* src_row, long long pos_stride,
                                          int c0, int n, int hd) {
  const int per_row = hd * (int)sizeof(KT) / 16;
  const int ld = row_stride<KT>(hd);
  for (int i = threadIdx.x; i < n * per_row; i += blockDim.x) {
    const int r = i / per_row, v = i - r * per_row;
    cp_async16(reinterpret_cast<char*>(dst + r * ld) + 16 * v,
               reinterpret_cast<const char*>(src_row + (c0 + r) * pos_stride) + 16 * v);
  }
  cp_async_commit();
}

// (a) append, scores and per-chunk statistics
template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) ragged_scores(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int T = a.T, hd = a.hd, K = a.K, group = a.Hq / a.Hkv, R = T * group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = row_stride<KT>(hd);
  KT* kc = reinterpret_cast<KT*>(smem);                          // [kChunk, ld]
  float* qs = reinterpret_cast<float*>(smem + kChunk * ld * sizeof(KT));  // [R, hd]
  float* sc = qs + R * hd;                                       // [R, kChunk]

  const long long pos_stride = (long long)a.Hkv * hd;
  KT* ck_row = static_cast<KT*>(a.ck) + (long long)a.rows[b] * a.M * pos_stride + h * hd;
  KT* cv_row = static_cast<KT*>(a.cv) + (long long)a.rows[b] * a.M * pos_stride + h * hd;
  const int start = c * kChunk, cols = min(kChunk, K - start);
  const int end = copied_end(a.lengths[b], T, K, a.page);
  const int ncopy = max(0, min(end - start, cols));

  // 1. the chunk's copied keys, in flight while the rest is set up
  if (ncopy > 0) copy_rows(kc, ck_row, pos_stride, start, ncopy, hd);

  // 2. fused append of this chunk's positions (the last chunk's block also
  //    stores those in [K, M), which nothing reads)
  const KT* kn = static_cast<const KT*>(a.k_new);
  const KT* vn = static_cast<const KT*>(a.v_new);
  const bool last = c == a.nchunks - 1;
  for (int t = 0; t < T; ++t) {
    const int wi = a.widx[b * T + t];
    if (wi < 0 || wi >= a.M) continue;
    if (!((wi >= start && wi < start + cols) || (last && wi >= K))) continue;
    const long long src = ((long long)(b * T + t) * a.Hkv + h) * hd;
    for (int d = tid; d < hd; d += blockDim.x) {
      ck_row[wi * pos_stride + d] = kn[src + d];
      cv_row[wi * pos_stride + d] = vn[src + d];
    }
  }

  // 3. the kv head's query rows as f32
  const QT* q = static_cast<const QT*>(a.q);
  for (int i = tid; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const int t = r / group, g = r - t * group;
    qs[i] = to_f(q[((long long)(b * T + t) * a.Hq + h * group + g) * hd + d]);
  }
  cp_async_wait_all();
  __syncthreads();
  // write-then-read: an appended key replaces what the copy read
  for (int t = 0; t < T; ++t) {
    const int wi = a.widx[b * T + t];
    if (wi < start || wi >= start + ncopy) continue;
    const long long src = ((long long)(b * T + t) * a.Hkv + h) * hd;
    for (int d = tid; d < hd; d += blockDim.x) kc[(wi - start) * ld + d] = kn[src + d];
  }
  __syncthreads();

  // 4. scores: thread (column j, row half rh) takes rows rh, rh + 2, ...
  const int j = tid & (kChunk - 1), rh = tid / kChunk;
  const int col = start + j;
  const uint8_t* mrow = a.mask + (long long)b * T * K;
  float* srow = a.scores + ((long long)(b * a.Hkv + h) * R) * K;
  for (int r0 = rh; r0 < R; r0 += 2 * kRowBlock) {
    float acc[kRowBlock];
#pragma unroll
    for (int i = 0; i < kRowBlock; ++i) acc[i] = 0.f;
    if (j < ncopy) {
      for (int d0 = 0; d0 < hd; d0 += 8) {
        float kf[8];
        load8(kc + j * ld + d0, kf);
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = round_to<QT>(kf[e]);
#pragma unroll
        for (int i = 0; i < kRowBlock; ++i) {
          const int r = r0 + 2 * i;
          if (r < R) {
            const float* qr = qs + r * hd + d0;
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[i] = fmaf(qr[e], kf[e], acc[i]);
          }
        }
      }
    }
    if (j < cols) {
#pragma unroll
      for (int i = 0; i < kRowBlock; ++i) {
        const int r = r0 + 2 * i;
        if (r < R) {
          const bool keep = mrow[(r / group) * K + col];
          const float s = finish_score<QT>(acc[i], a.scale, a.softcap, keep);
          sc[r * kChunk + j] = s;
          srow[(long long)r * K + col] = s;
        }
      }
    }
  }
  __syncthreads();

  // 5. the chunk's (max, sum of exp(s - max)) per row, a warp per row
  for (int r = warp; r < R; r += blockDim.x / 32) {
    const float v0 = lane < cols ? sc[r * kChunk + lane] : -INFINITY;
    const float v1 = lane + 32 < cols ? sc[r * kChunk + lane + 32] : -INFINITY;
    const float mx = warp_max(fmaxf(v0, v1));
    float e = lane < cols ? expf(v0 - mx) : 0.f;
    if (lane + 32 < cols) e += expf(v1 - mx);
    const float sum = warp_sum(e);
    if (lane == 0) {
      const long long i = ((long long)(b * a.Hkv + h) * R + r) * a.nchunks + c;
      a.cmax[i] = mx;
      a.csum[i] = sum;
    }
  }
}

// (b) global statistics, probabilities and the chunk's partial PV
template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) ragged_pv(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int T = a.T, hd = a.hd, K = a.K, R = T * (a.Hq / a.Hkv);
  const int tid = threadIdx.x;
  const int start = c * kChunk, cols = min(kChunk, K - start);
  const int ncopy = min(copied_end(a.lengths[b], T, K, a.page) - start, cols);
  if (ncopy <= 0) return;  // past the copied span: zero V, no contribution
  const int ld = row_stride<KT>(hd);
  KT* vc = reinterpret_cast<KT*>(smem);                                   // [kChunk, ld]
  float* ps = reinterpret_cast<float*>(smem + kChunk * ld * sizeof(KT));  // [R, kChunk]
  float* rm = ps + R * kChunk;                                            // [R]
  float* rl = rm + R;                                                     // [R]

  const long long pos_stride = (long long)a.Hkv * hd;
  const KT* cv_row =
      static_cast<const KT*>(a.cv) + (long long)a.rows[b] * a.M * pos_stride + h * hd;
  copy_rows(vc, cv_row, pos_stride, start, ncopy, hd);

  // the row's max over all K columns and its sum, folded in chunk order: a
  // warp per row, lanes load 32 chunks' statistics at a time, the sum
  // takes their terms in chunk order through shuffles
  const long long bh = (long long)(b * a.Hkv + h) * R;
  const int lane = tid & 31;
  for (int r = tid >> 5; r < R; r += blockDim.x >> 5) {
    const float* cm = a.cmax + (bh + r) * a.nchunks;
    const float* cs = a.csum + (bh + r) * a.nchunks;
    float m = -INFINITY;
    for (int i = lane; i < a.nchunks; i += 32) m = fmaxf(m, cm[i]);
    m = warp_max(m);
    float l = 0.f;
    for (int base = 0; base < a.nchunks; base += 32) {
      const int i = base + lane;
      const float term = i < a.nchunks ? cs[i] * expf(cm[i] - m) : 0.f;
      const int n = min(32, a.nchunks - base);
      for (int j = 0; j < n; ++j) l += __shfl_sync(0xffffffffu, term, j);
    }
    if (lane == 0) {
      rm[r] = m;
      rl[r] = l;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * ncopy; i += blockDim.x) {
    const int r = i / ncopy, j = i - r * ncopy;
    const float s = a.scores[(bh + r) * K + start + j];
    ps[r * kChunk + j] = round_to<QT>(expf(s - rm[r]) / rl[r]);
  }
  cp_async_wait_all();
  __syncthreads();

  // partial PV: work item (d, block of kRowBlock rows)
  const int nrb = (R + kRowBlock - 1) / kRowBlock;
  float* part = a.partial + ((long long)(b * a.Hkv + h) * a.nchunks + c) * R * hd;
  for (int w = tid; w < hd * nrb; w += blockDim.x) {
    const int d = w % hd, r0 = (w / hd) * kRowBlock;
    float acc[kRowBlock];
#pragma unroll
    for (int i = 0; i < kRowBlock; ++i) acc[i] = 0.f;
    for (int jj = 0; jj < ncopy; ++jj) {
      const float v = round_to<QT>(to_f(vc[jj * ld + d]));
#pragma unroll
      for (int i = 0; i < kRowBlock; ++i)
        if (r0 + i < R) acc[i] = fmaf(ps[(r0 + i) * kChunk + jj], v, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kRowBlock; ++i)
      if (r0 + i < R) part[(long long)(r0 + i) * hd + d] = acc[i];
  }
}

// (c) partials summed in chunk order, rounded once: a thread per output
// element of one (slot, kv head)
template <typename QT>
__global__ void __launch_bounds__(kThreads) ragged_combine(Args a) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int T = a.T, hd = a.hd, group = a.Hq / a.Hkv, R = T * group;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * hd) return;
  const int nused = (copied_end(a.lengths[b], T, a.K, a.page) + kChunk - 1) / kChunk;
  const float* part = a.partial + (long long)(b * a.Hkv + h) * a.nchunks * R * hd + i;
  float acc = 0.f;
#pragma unroll 4
  for (int c = 0; c < nused; ++c) acc += part[(long long)c * R * hd];
  const int r = i / hd, d = i - r * hd;
  const int t = r / group, g = r - t * group;
  static_cast<QT*>(a.out)[((long long)(b * T + t) * a.Hq + h * group + g) * hd + d] =
      from_f<QT>(acc);
}

// ---------------------------------------------------------------------------
// bf16 q and cache: one launch on the tensor cores (see the note above)
// ---------------------------------------------------------------------------

namespace tc {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;     // 8 warps
constexpr int kMinRows = 17;      // query rows of a kv head (T x group): fewer take
constexpr int kMaxRows = 64;      // dec::ragged_dec, more do not fit; padded to 16
constexpr int kMaxCluster = 8;    // blocks per (kv head, slot): the portable cluster size
constexpr int kLDP = kChunk + 8;  // bf16 row stride of the probability tile

// the head dim padded to the kernel's instantiation
__host__ __device__ constexpr int padded_hd(int hd) {
  return hd <= 16 ? 16 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
}

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// byte offsets of a block's dynamic shared memory
struct Smem {
  int q, ring, p, mask, widx, stats, total;
};
__host__ __device__ inline Smem smem_layout(int hdp, int rows_p, int T) {
  Smem s;
  const int ld = hdp + 8;
  s.q = 0;                                    // [rows_p][ld] bf16 query rows
  s.ring = s.q + rows_p * ld * 2;             // 2 slots x (K, V) x [kChunk][ld] bf16
  s.p = s.ring + 4 * kChunk * ld * 2;         // [rows_p][kLDP] bf16 probabilities
  s.mask = s.p + rows_p * kLDP * 2;           // 2 slots x [T][kChunk] mask bytes
  s.widx = s.mask + align16(2 * T * kChunk);  // [T] write positions
  s.stats = s.widx + align16(4 * T);          // f32 (max, sum): 4 key quarters, block, global
  s.total = s.stats + 4 * 12 * rows_p;
  return s;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16z(void* dst, const void* src, int src_bytes) {
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

// ldmatrix addresses in a padded [rows][LD] tile: the A operand of rows
// [r0, r0 + 16) and columns [16 c, 16 c + 16) (ldmatrix.trans from the same
// address gives the B operand of a [k][n] tile, the n-tile pair at columns
// 16 c); and the B operand of the n-tile pair (2 np, 2 np + 1) from an
// [n][k] tile, k columns [16 kk, 16 kk + 16)
template <int LD>
__device__ __forceinline__ const bf16* a_frag(const bf16* t, int r0, int c, int lane) {
  return t + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 16 * c + 8 * (lane >> 4);
}
template <int LD>
__device__ __forceinline__ const bf16* b_frag(const bf16* t, int np, int kk, int lane) {
  return t + (16 * np + (lane & 7) + 8 * (lane >> 4)) * LD + 16 * kk + 8 * ((lane >> 3) & 1);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One block per (rank, kv head, slot); the cluster spans the ranks.  Warp
// w computes S for key quarter w % 4 (16 keys) of m-tiles w / 4 and w / 4 +
// 2, and P V for the head-dim column pairs w, w + 8, ... (16 columns each)
// of every m-tile.
template <int HDP>
__global__ void __launch_bounds__(kThreads) ragged_tc(Args a) {
  constexpr int kLD = HDP + 8;
  constexpr int kTile = kChunk * kLD;          // elements of one K or V chunk
  constexpr int kPieces = HDP / 8;             // 16-byte pieces of a padded row
  constexpr int kPairs = HDP / 16;             // head-dim column pairs
  constexpr int kPairsPerWarp = (kPairs + 7) / 8;
  constexpr int kLDO = HDP + 4;                // f32 row stride of the partial output
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x, ranks = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  const int T = a.T, hd = a.hd, K = a.K, group = a.Hq / a.Hkv, R = T * group;
  const int rows_p = (R + 15) & ~15, Mt = rows_p / 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3, kq = warp & 3;
  const Smem L = smem_layout(HDP, rows_p, T);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L.q);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);  // slot s: K at 2 s kTile, V after
  bf16* sP = reinterpret_cast<bf16*>(smem + L.p);
  uint8_t* sM = smem + L.mask;
  int* sW = reinterpret_cast<int*>(smem + L.widx);
  float* qm = reinterpret_cast<float*>(smem + L.stats);  // [4][rows_p] per key quarter
  float* ql = qm + 4 * rows_p;
  float* bm = ql + 4 * rows_p;  // [rows_p] the block's, read by the cluster
  float* bl = bm + rows_p;
  float* gm = bl + rows_p;      // [rows_p] over all K columns
  float* gl = gm + rows_p;
  float* sO = reinterpret_cast<float*>(smem + L.ring);  // [rows_p][kLDO], after pass 2

  const long long pos_stride = (long long)a.Hkv * hd;
  bf16* ck_row = static_cast<bf16*>(a.ck) + (long long)a.rows[b] * a.M * pos_stride + h * hd;
  bf16* cv_row = static_cast<bf16*>(a.cv) + (long long)a.rows[b] * a.M * pos_stride + h * hd;
  const bf16* kn = static_cast<const bf16*>(a.k_new);
  const bf16* vn = static_cast<const bf16*>(a.v_new);
  const int end = copied_end(a.lengths[b], T, K, a.page);
  const int c_lo = rank * a.cpb, c_hi = min(c_lo + a.cpb, a.nchunks);
  const int nmine = c_hi - c_lo;                        // >= 1
  const int c_keys = (end + kChunk - 1) / kChunk;       // chunks holding copied columns
  const int nkeys = max(0, min(c_hi, c_keys) - c_lo);   // this block's
  const int used = min(ranks, (c_keys + a.cpb - 1) / a.cpb);  // ranks holding any
  const bool resident = nmine <= 2;  // both passes' chunks fit the ring at once

  // 1. write positions, the fused append of this block's positions (the
  //    last rank also stores those in [K, M), which nothing reads), and the
  //    query rows by cp.async (rows past R and columns past hd as zeros)
  if (tid < T) sW[tid] = a.widx[b * T + tid];
  for (int t = 0; t < T; ++t) {
    const int wi = a.widx[b * T + t];
    if (wi < 0 || wi >= a.M) continue;
    const bool mine = wi >= c_lo * kChunk && wi < min(c_hi * kChunk, K);
    if (!(mine || (rank == ranks - 1 && wi >= K))) continue;
    const long long src = ((long long)(b * T + t) * a.Hkv + h) * hd;
    for (int d = tid; d < hd; d += kThreads) {
      ck_row[wi * pos_stride + d] = kn[src + d];
      cv_row[wi * pos_stride + d] = vn[src + d];
    }
  }
  const int live = hd / 8;  // pieces of a row holding data
  const bf16* q = static_cast<const bf16*>(a.q);
  for (int i = tid; i < rows_p * kPieces; i += kThreads) {
    const int r = i / kPieces, c = i - r * kPieces;
    const bool ok = r < R && c < live;
    const bf16* src = q;
    if (ok) {
      const int t = r / group, gg = r - t * group;
      src = q + ((long long)(b * T + t) * a.Hq + h * group + gg) * hd + 8 * c;
    }
    cp_async16z(sQ + r * kLD + 8 * c, src, ok ? 16 : 0);
  }
  __syncthreads();  // sW
  int w_lo = a.M, w_hi = -1;  // the range of this slot's write positions
  for (int t = 0; t < T; ++t) {
    w_lo = min(w_lo, sW[t]);
    w_hi = max(w_hi, sW[t]);
  }

  // chunk c into ring slot `slot`: its copied K (and V) rows, a written
  // position's row from k_new / v_new, zeros past the copied columns, and
  // its mask columns
  const bool mask_vec = (K & 15) == 0 && (reinterpret_cast<uintptr_t>(a.mask) & 15) == 0;
  auto load_chunk = [&](int c, int slot, bool with_v) {
    const int start = c * kChunk, cols = min(kChunk, K - start);
    if (c < c_keys) {
      const int ncopy = min(end - start, cols);
      bf16* dK = ring + slot * 2 * kTile;
      for (int i = tid; i < kChunk * kPieces; i += kThreads) {
        const int j = i / kPieces, c8 = i - j * kPieces;
        const bool ok = j < ncopy && c8 < live;
        const bf16 *sk = kn, *sv = vn;
        if (ok) {
          const int pos = start + j;
          int tw = -1;
          if (pos >= w_lo && pos <= w_hi)
            for (int t = T - 1; t >= 0 && tw < 0; --t) tw = sW[t] == pos ? t : -1;
          if (tw >= 0) {
            const long long src = ((long long)(b * T + tw) * a.Hkv + h) * hd + 8 * c8;
            sk = kn + src;
            sv = vn + src;
          } else {
            sk = ck_row + pos * pos_stride + 8 * c8;
            sv = cv_row + pos * pos_stride + 8 * c8;
          }
        }
        cp_async16z(dK + j * kLD + 8 * c8, sk, ok ? 16 : 0);
        if (with_v) cp_async16z(dK + kTile + j * kLD + 8 * c8, sv, ok ? 16 : 0);
      }
    }
    uint8_t* dM = sM + slot * T * kChunk;
    const uint8_t* mrow = a.mask + (long long)b * T * K + start;
    if (mask_vec) {
      const int n16 = cols / 16;
      for (int i = tid; i < T * n16; i += kThreads) {
        const int t = i / n16, p = i - t * n16;
        cp_async16z(dM + t * kChunk + 16 * p, mrow + (long long)t * K + 16 * p, 16);
      }
    } else {
      for (int i = tid; i < T * cols; i += kThreads) {
        const int t = i / cols, j = i - t * cols;
        dM[t * kChunk + j] = mrow[(long long)t * K + j];
      }
    }
  };

  // S of chunk c (in ring slot `slot`) for this warp's items, finished:
  // s[i][n][e] of m-tile warp / 4 + 2 i, keys 16 kq + 8 n + 2 tig + (e & 1),
  // rows g + 8 (e >> 1); -inf past K and on pad rows
  auto scores = [&](int c, int slot, float s[2][2][4]) {
    const int start = c * kChunk, cols = min(kChunk, K - start);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n) s[i][n][0] = s[i][n][1] = s[i][n][2] = s[i][n][3] = 0.f;
    if (c < c_keys) {  // else every key is zero: every dot 0
      const bf16* tK = ring + slot * 2 * kTile;
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        unsigned kb[4];
        ldmatrix_x4(kb, b_frag<kLD>(tK, kq, kk, lane));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int mt = (warp >> 2) + 2 * i;
          if (mt < Mt) {
            unsigned qa[4];
            ldmatrix_x4(qa, a_frag<kLD>(sQ, 16 * mt, kk, lane));
            mma(s[i][0], qa, kb[0], kb[1]);
            mma(s[i][1], qa, kb[2], kb[3]);
          }
        }
      }
    }
    const uint8_t* tM = sM + slot * T * kChunk;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mt = (warp >> 2) + 2 * i;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * mt + g + 8 * half;
        const int t = r < R ? r / group : 0;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 16 * kq + 8 * n + 2 * tig + e;
            float& x = s[i][n][2 * half + e];
            x = col < cols && r < R
                    ? finish_score<bf16>(x, a.scale, a.softcap, tM[t * kChunk + col])
                    : -INFINITY;
          }
      }
    }
  };

  // the chunk loop of one pass: double-buffered loads unless the block's
  // chunks stayed resident from pass 1
  auto walk = [&](int n, bool load, bool with_v, auto&& body) {
    if (n == 0) return;
    if (load) {
      load_chunk(c_lo, 0, with_v);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    for (int i = 0; i < n; ++i) {
      if (load) {
        if (i + 1 < n) load_chunk(c_lo + i + 1, (i + 1) & 1, with_v);
        asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_group 1;\n" ::);  // chunk i (and Q) landed
      }
      __syncthreads();
      body(c_lo + i, i & 1);
      __syncthreads();  // the slot's readers are done before it is refilled
    }
  };

  // 2. pass 1: each row's running (max, sum of exp(s - max)) over the
  //    warp's key quarter of the block's chunks
  float rm[2][2], rl[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) rm[i][0] = rm[i][1] = -INFINITY, rl[i][0] = rl[i][1] = 0.f;
  walk(nmine, true, resident, [&](int c, int slot) {
    float s[2][2][4];
    scores(c, slot, s);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if ((warp >> 2) + 2 * i >= Mt) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* x0 = &s[i][0][2 * half];
        const float* x1 = &s[i][1][2 * half];
        const float mnew = fmaxf(rm[i][half],
                                 quad_max(fmaxf(fmaxf(x0[0], x0[1]), fmaxf(x1[0], x1[1]))));
        const float mref = mnew == -INFINITY ? 0.f : mnew;
        const float sum = quad_sum(expf(x0[0] - mref) + expf(x0[1] - mref) +
                                   expf(x1[0] - mref) + expf(x1[1] - mref));
        rl[i][half] = rl[i][half] * expf(rm[i][half] - mref) + sum;
        rm[i][half] = mnew;
      }
    }
  });
  asm volatile("cp.async.wait_all;\n" ::);
  if (tig == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mt = (warp >> 2) + 2 * i;
      if (mt >= Mt) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * mt + g + 8 * half;
        qm[kq * rows_p + r] = rm[i][half];
        ql[kq * rows_p + r] = rl[i][half];
      }
    }
  }
  __syncthreads();
  // the block's statistics, the key quarters folded in order; then the
  // cluster's, the ranks folded in order
  if (tid < R) {
    float m = -INFINITY;
    for (int k = 0; k < 4; ++k) m = fmaxf(m, qm[k * rows_p + tid]);
    float l = 0.f;
    for (int k = 0; k < 4; ++k) l += ql[k * rows_p + tid] * expf(qm[k * rows_p + tid] - m);
    bm[tid] = m;
    bl[tid] = l;
  }
  cluster.sync();
  if (tid < R) {  // every rank's pair loaded first: one remote latency, not one a rank
    float mr[kMaxCluster], lr[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      mr[r] = r < ranks ? *cluster.map_shared_rank(bm + tid, r) : -INFINITY;
      lr[r] = r < ranks ? *cluster.map_shared_rank(bl + tid, r) : 0.f;
    }
    float m = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) m = fmaxf(m, mr[r]);
    float l = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < ranks) l += lr[r] * expf(mr[r] - m);
    gm[tid] = m;
    gl[tid] = l;
  }
  __syncthreads();

  // 3. pass 2: probabilities and the block's partial P V
  float o[kPairsPerWarp][4][2][4];
#pragma unroll
  for (int p = 0; p < kPairsPerWarp; ++p)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n) o[p][mt][n][0] = o[p][mt][n][1] = o[p][mt][n][2] =
                                      o[p][mt][n][3] = 0.f;
  walk(nkeys, !resident, true, [&](int c, int slot) {
    float s[2][2][4];
    scores(c, slot, s);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mt = (warp >> 2) + 2 * i;
      if (mt >= Mt) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * mt + g + 8 * half;
        const float m = gm[r], l = gl[r];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float* x = &s[i][n][2 * half];
          const float p0 = x[0] == -INFINITY ? 0.f : round_to<bf16>(expf(x[0] - m) / l);
          const float p1 = x[1] == -INFINITY ? 0.f : round_to<bf16>(expf(x[1] - m) / l);
          *reinterpret_cast<__nv_bfloat162*>(sP + r * kLDP + 16 * kq + 8 * n + 2 * tig) =
              __floats2bfloat162_rn(p0, p1);
        }
      }
    }
    __syncthreads();  // the chunk's P
    const bf16* tV = ring + slot * 2 * kTile + kTile;
#pragma unroll
    for (int p = 0; p < kPairsPerWarp; ++p) {
      const int pair = warp + 8 * p;
      if (pair >= kPairs || 16 * pair >= hd) continue;
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        unsigned vb[4];
        ldmatrix_x4_trans(vb, a_frag<kLD>(tV, 16 * kk, pair, lane));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt < Mt) {
            unsigned pa[4];
            ldmatrix_x4(pa, a_frag<kLDP>(sP, 16 * mt, kk, lane));
            mma(o[p][mt][0], pa, vb[0], vb[1]);
            mma(o[p][mt][1], pa, vb[2], vb[3]);
          }
        }
      }
    }
  });

  // 4. the partials through distributed shared memory: every rank holding
  //    copied columns leaves its partial in place of its ring; each block
  //    sums a slice of the outputs over those ranks in rank order, rounds
  //    once and stores
  if (nkeys > 0) {
#pragma unroll
    for (int p = 0; p < kPairsPerWarp; ++p) {
      const int pair = warp + 8 * p;
      if (pair >= kPairs) continue;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt >= Mt) continue;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int r = 16 * mt + g, col = 16 * pair + 8 * n + 2 * tig;
          *reinterpret_cast<float2*>(sO + r * kLDO + col) = make_float2(o[p][mt][n][0],
                                                                        o[p][mt][n][1]);
          *reinterpret_cast<float2*>(sO + (r + 8) * kLDO + col) =
              make_float2(o[p][mt][n][2], o[p][mt][n][3]);
        }
      }
    }
  }
  cluster.sync();
  bf16* out = static_cast<bf16*>(a.out);
  const int nvec = R * hd / 4;
  for (int v = rank * kThreads + tid; v < nvec; v += ranks * kThreads) {
    const int r = 4 * v / hd, d = 4 * v - r * hd;
    float4 x[kMaxCluster];
#pragma unroll
    for (int rr = 0; rr < kMaxCluster; ++rr)
      if (rr < used)
        x[rr] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(sO + r * kLDO + d, rr));
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int rr = 0; rr < kMaxCluster; ++rr) {
      if (rr < used) {
        acc.x += x[rr].x;
        acc.y += x[rr].y;
        acc.z += x[rr].z;
        acc.w += x[rr].w;
      }
    }
    const int t = r / group, gg = r - t * group;
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        out + ((long long)(b * T + t) * a.Hq + h * group + gg) * hd + d);
    dst[0] = __floats2bfloat162_rn(acc.x, acc.y);
    dst[1] = __floats2bfloat162_rn(acc.z, acc.w);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

template <int HDP>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  const int R = a.T * (a.Hq / a.Hkv);
  const int smem = smem_layout(HDP, (R + 15) & ~15, a.T).total;
  cudaError_t err =
      cudaFuncSetAttribute(ragged_tc<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned ranks = (a.nchunks + a.cpb - 1) / a.cpb;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, a.Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ragged_tc<HDP>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t launch_any(Args& a, int B, cudaStream_t s) {
  const int R = a.T * (a.Hq / a.Hkv);
  if (R < kMinRows || R > kMaxRows || a.hd > 256) return cudaErrorInvalidValue;
  a.cpb = (a.nchunks + kMaxCluster - 1) / kMaxCluster;
  switch (padded_hd(a.hd)) {
    case 16: return launch<16>(a, B, s);
    case 64: return launch<64>(a, B, s);
    case 128: return launch<128>(a, B, s);
    default: return launch<256>(a, B, s);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// bf16 q and cache, at most 16 query rows a kv head: decode and the short
// verifies in one launch (see the note above)
// ---------------------------------------------------------------------------

namespace dec {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps; warp w takes keys [16 w, 16 w + 16) of a chunk
constexpr int kMaxRows = 16;   // query rows of a kv head (T x group): one m16 tile
constexpr int kMaxRanks = 8;   // blocks of a (kv head, slot): the portable cluster size
constexpr int kMinChunks = 2;  // of the key window a block takes, before kMaxRanks caps it
constexpr int kPanel = kChunk * 128;  // bytes of a 64-column panel of a chunk tile
// ring slots: one chunk's K and V tiles.  Four (two chunks in flight a
// block) timed slower on an H100 wherever the grid has many blocks: the
// larger block leaves room for fewer of them on an SM, and those are what
// keep loads in flight.
constexpr int kNS = 2;

// the head dims it takes: whole 64-column panels, at most four
__host__ __device__ constexpr bool takes_hd(int hd) { return hd == 64 || hd == 128 || hd == 256; }

// blocks of each (kv head, slot)'s cluster: a function of the key window
// and the kv heads alone, so that a key position's block never depends on
// the batch: at least max(kMinChunks, Hkv) chunks a block (many kv heads
// already make many clusters), at most kMaxRanks blocks
__host__ __device__ inline int ranks_for(int nchunks, int Hkv) {
  const int per = Hkv > kMinChunks ? Hkv : kMinChunks;
  const int r = (nchunks + per - 1) / per;
  return r < kMaxRanks ? r : kMaxRanks;
}

// byte offsets of a block's dynamic shared memory, from a 1024-byte aligned
// base (the 128-byte swizzle's)
struct Smem {
  int ring, q, mask, bars, widx, stats, count, total;
};
__host__ __device__ inline Smem smem_layout(int hd, int T) {
  Smem s;
  const int ns = kNS;
  s.ring = 0;                                   // ns x (hd / 64) swizzled panels
  s.q = s.ring + ns * (hd / 64) * kPanel;       // [16][hd + 8] bf16 query rows
  s.mask = s.q + kMaxRows * (hd + 8) * 2;       // ns x [T][kChunk] mask bytes of a K tile
  s.bars = s.mask + ns * tc::align16(T * kChunk);  // ns mbarriers, one a ring slot
  s.widx = s.bars + 8 * ns;                     // [T] write positions
  s.stats = s.widx + tc::align16(4 * T);        // f32 statistics (see the kernel)
  s.count = s.stats + 4 * (14 + kMaxRanks) * kMaxRows;  // [T] x 2 columns past the span
  s.total = s.count + 8 * T + 1024;             // + the base's alignment
  return s;
}

// 16-byte piece `chunk` of row `row` of a tile of 64-column panels, each 64
// rows of 128 bytes in the 128-byte swizzle that TMA writes
__device__ __forceinline__ unsigned char* swz(unsigned char* tile, int row, int chunk) {
  return tile + (chunk >> 3) * kPanel + row * 128 + (((chunk & 7) ^ (row & 7)) << 4);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tc::smem_addr(bar)),
               "r"(count)
               : "memory");
}

// arrive, and expect `bytes` of bulk-copy traffic before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   tc::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(tc::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// TMA: one 64-column panel of 64 cache rows of one kv head (coordinates:
// column, kv head, cache row of S x M)
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c, int h, int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(tc::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(tc::smem_addr(bar)), "r"(c), "r"(h), "r"(row)
      : "memory");
}

// a bulk copy of `bytes` (a multiple of 16) contiguous bytes
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(tc::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(tc::smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// (m, l) <- the softmax statistics of both column sets
__device__ __forceinline__ void fold(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  l = (m == -INFINITY ? 0.f : l * expf(m - mn)) + (m2 == -INFINITY ? 0.f : l2 * expf(m2 - mn));
  m = mn;
}

// exp(m - m_to), 0 for an empty set
__device__ __forceinline__ float rescale(float m, float m_to) {
  return m == -INFINITY ? 0.f : expf(m - m_to);
}

// One block per (rank, kv head, slot); the cluster spans the ranks.  Chunk
// c of the key window belongs to rank c % ranks.  tmk / tmv: the caches as
// [S x M, Hkv, hd] for TMA.
template <int HD>
__global__ void __launch_bounds__(kThreads) ragged_dec(const __grid_constant__ CUtensorMap tmk,
                                                       const __grid_constant__ CUtensorMap tmv,
                                                       Args a) {
  constexpr int kLDQ = HD + 8;              // bf16 row stride of the query rows
  constexpr int kTileB = HD / 64 * kPanel;  // bytes of one K or V chunk tile
  constexpr int kPieces = HD / 8;           // 16-byte pieces of a row
  static_assert(kNS % 2 == 0, "a chunk's K and V tiles take two slots");
  constexpr int kPairs = HD / 16;  // head-dim column pairs of P V
  constexpr int kLDO = HD + 4;     // f32 row stride of the partial outputs
  static_assert(kMaxRows * kLDO * 4 <= kNS * kTileB, "the block's partial fits the ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x, ranks = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  const int T = a.T, K = a.K, group = a.Hq / a.Hkv, R = T * group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const Smem L = smem_layout(HD, T);
  const int mstride = tc::align16(T * kChunk);
  unsigned char* ring = smem + L.ring;
  bf16* sQ = reinterpret_cast<bf16*>(smem + L.q);
  uint8_t* sM = smem + L.mask;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);  // [kNS]
  int* sW = reinterpret_cast<int*>(smem + L.widx);
  float* wm = reinterpret_cast<float*>(smem + L.stats);  // [4][16] each warp's (max, sum)
  float* wl = wm + 4 * kMaxRows;
  float* wf = wl + 4 * kMaxRows;  // [4][16] a warp's partial's factor into the block's
  float* bm = wf + 4 * kMaxRows;  // [16] the block's, read by the cluster
  float* bl = bm + kMaxRows;
  float* gf = bl + kMaxRows;  // [kMaxRanks][16] a rank's factor into the output
  int* n_adm = reinterpret_cast<int*>(smem + L.count);  // [T] past the copied span
  int* n_msk = n_adm + T;
  float* bo = reinterpret_cast<float*>(ring);  // [16][kLDO] the block's partial, after the walk

  const long long pos_stride = (long long)a.Hkv * HD;
  const int row0 = a.rows[b] * a.M;  // the slot's first cache row of [S x M]
  bf16* ck_row = static_cast<bf16*>(a.ck) + row0 * pos_stride + h * HD;
  bf16* cv_row = static_cast<bf16*>(a.cv) + row0 * pos_stride + h * HD;
  const bf16* kn = static_cast<const bf16*>(a.k_new);
  const bf16* vn = static_cast<const bf16*>(a.v_new);
  const int end = copied_end(a.lengths[b], T, K, a.page);
  const int c_keys = (end + kChunk - 1) / kChunk;  // chunks holding copied columns
  // this block's chunks rank + i ranks: i < nk copied, nk <= i < n_own past the span
  const int nk = c_keys > rank ? (c_keys - rank + ranks - 1) / ranks : 0;
  const int n_own = (a.nchunks - rank + ranks - 1) / ranks;
  const bool mask_vec = (K & 15) == 0 && (reinterpret_cast<uintptr_t>(a.mask) & 15) == 0;

  // 1. the barriers and the first tiles' requests (thread 0), then the
  //    write positions, counters, the fused append of this block's
  //    positions (rank 0 also stores those in [K, M), which nothing reads),
  //    and the query rows by cp.async (rows past R zeros)
  if (tid == 0) {
    for (int s = 0; s < kNS; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // tile u: chunk rank + (u / 2) ranks, its K (even u, with its mask
  // columns) or V (odd u), in ring slot u % kNS; thread 0 requests it by TMA
  auto issue = [&](int u) {
    if (tid != 0 || u >= 2 * nk) return;
    const int start = (rank + (u >> 1) * ranks) * kChunk, cols = min(kChunk, K - start);
    const int slot = u % kNS;
    const bool is_v = u & 1, with_mask = !is_v && mask_vec;
    // the slot was last read and written through generic accesses: order
    // them before the bulk copies that overwrite it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(full + slot, kTileB + (with_mask ? T * cols : 0));
    for (int p = 0; p < HD / 64; ++p)
      tma_rows(ring + slot * kTileB + p * kPanel, is_v ? &tmv : &tmk, full + slot, 64 * p, h,
               row0 + start);
    if (with_mask)
      for (int t = 0; t < T; ++t)
        bulk_copy(sM + slot * mstride + t * kChunk, a.mask + ((long long)b * T + t) * K + start,
                  cols, full + slot);
  };
  for (int u = 0; u < kNS; ++u) issue(u);
  if (tid < T) {
    sW[tid] = a.widx[b * T + tid];
    n_adm[tid] = n_msk[tid] = 0;
  }
  for (int t = 0; t < T; ++t) {
    const int wi = a.widx[b * T + t];
    if (wi < 0 || wi >= a.M) continue;
    if (wi < K ? (wi / kChunk) % ranks != rank : rank != 0) continue;
    const long long src = ((long long)(b * T + t) * a.Hkv + h) * HD;
    for (int d = tid; d < HD; d += kThreads) {
      ck_row[wi * pos_stride + d] = kn[src + d];
      cv_row[wi * pos_stride + d] = vn[src + d];
    }
  }
  const bf16* q = static_cast<const bf16*>(a.q);
  for (int i = tid; i < kMaxRows * kPieces; i += kThreads) {
    const int r = i / kPieces, c = i - r * kPieces;
    const bf16* src = q;
    if (r < R) {
      const int t = r / group, gg = r - t * group;
      src = q + ((long long)(b * T + t) * a.Hq + h * group + gg) * HD + 8 * c;
    }
    tc::cp_async16z(sQ + r * kLDQ + 8 * c, src, r < R ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  __syncthreads();  // the barriers, sW, the counters

  // tile u landed; then each thread patches it: rows past the copied span
  // zero, and a position written by this call from k_new / v_new
  auto take = [&](int u) {
    const int slot = u % kNS;
    mbar_wait(full + slot, (u / kNS) & 1);
    const int start = (rank + (u >> 1) * ranks) * kChunk, cols = min(kChunk, K - start);
    const int ncopy = min(end - start, cols);
    const bool is_v = u & 1;
    unsigned char* tile = ring + slot * kTileB;
    for (int x = ncopy * kPieces + tid; x < kChunk * kPieces; x += kThreads)
      *reinterpret_cast<uint4*>(swz(tile, x / kPieces, x % kPieces)) = make_uint4(0, 0, 0, 0);
    const bf16* from_new = is_v ? vn : kn;
    for (int t = 0; t < T; ++t) {
      const int j = sW[t] - start;
      if (j < 0 || j >= ncopy) continue;
      bool last = true;  // the last row t writing the position wins, as in the append
      for (int t2 = t + 1; t2 < T; ++t2) last &= sW[t2] != sW[t];
      if (!last) continue;
      const bf16* src = from_new + ((long long)(b * T + t) * a.Hkv + h) * HD;
      for (int c = tid; c < kPieces; c += kThreads)
        *reinterpret_cast<uint4*>(swz(tile, j, c)) = *reinterpret_cast<const uint4*>(src + 8 * c);
    }
    if (!is_v && !mask_vec) {
      uint8_t* dM = sM + slot * mstride;
      const uint8_t* mrow = a.mask + (long long)b * T * K + start;
      for (int x = tid; x < T * cols; x += kThreads) {
        const int t = x / cols, jj = x - t * cols;
        dM[t * kChunk + jj] = mrow[(long long)t * K + jj];
      }
    }
    __syncthreads();
  };

  // 2. the columns past the copied span (zero K/V: score 0 where admitted,
  //    MASK_VALUE where not), counted per mask row while the tiles load
  const int n_tail = max(0, n_own - nk);
  if (mask_vec) {
    constexpr int kP = kChunk / 16;
    for (int x = tid; x < n_tail * T * kP; x += kThreads) {
      const int i = nk + x / (T * kP), t = x / kP % T, p = x % kP;
      const int col = (rank + i * ranks) * kChunk + 16 * p;
      if (col >= K) continue;
      const uint4 m4 = *reinterpret_cast<const uint4*>(a.mask + ((long long)b * T + t) * K + col);
      const int n = __popc(m4.x) + __popc(m4.y) + __popc(m4.z) + __popc(m4.w);
      atomicAdd(n_adm + t, n);
      atomicAdd(n_msk + t, 16 - n);
    }
  } else {
    for (int x = tid; x < n_tail * T * kChunk; x += kThreads) {
      const int i = nk + x / (T * kChunk), t = x / kChunk % T, j = x % kChunk;
      const int col = (rank + i * ranks) * kChunk + j;
      if (col >= K) continue;
      atomicAdd(a.mask[((long long)b * T + t) * K + col] ? n_adm + t : n_msk + t, 1);
    }
  }

  // 3. one walk over the block's copied chunks.  Per chunk each warp takes
  //    its 16 keys: S on mma.sync (Q fragments by ldmatrix, K as the B
  //    operand from the swizzled tile), each score finished (bf16, scale,
  //    softcap, mask), the running (max, sum) of each row over the warp's
  //    keys, p = exp(s - max) rounded to bf16 as the A operand in
  //    registers, and the warp's partial O = O alpha + P V over every head
  //    dim column (V through ldmatrix.trans).
  float rm[2] = {-INFINITY, -INFINITY}, rl[2] = {0.f, 0.f};
  float o[kPairs][2][4];
#pragma unroll
  for (int p = 0; p < kPairs; ++p)
#pragma unroll
    for (int n = 0; n < 2; ++n) o[p][n][0] = o[p][n][1] = o[p][n][2] = o[p][n][3] = 0.f;
  // the B operand of the warp's keys: lane's row of a tile and piece of a k-step
  const int krow = 16 * warp + (lane & 7) + 8 * (lane >> 4), kpc = (lane >> 3) & 1;
  const int vrow = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1), vpc = lane >> 4;
  asm volatile("cp.async.wait_all;\n" ::);  // Q, published by the first take's barrier
  for (int i = 0; i < nk; ++i) {
    const int uk = 2 * i;
    take(uk);
    const int start = (rank + i * ranks) * kChunk, cols = min(kChunk, K - start);
    unsigned char* tK = ring + (uk % kNS) * kTileB;
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      unsigned qa[4], kb[4];
      tc::ldmatrix_x4(qa, tc::a_frag<kLDQ>(sQ, 0, kk, lane));
      tc::ldmatrix_x4(kb, swz(tK, krow, 2 * kk + kpc));
      tc::mma(s[0], qa, kb[0], kb[1]);
      tc::mma(s[1], qa, kb[2], kb[3]);
    }
    const uint8_t* tM = sM + (uk % kNS) * mstride;
    float alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = g + 8 * half;
      const int t = r < R ? r / group : 0;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 16 * warp + 8 * n + 2 * tig + e;
          float& x = s[n][2 * half + e];
          x = col < cols && r < R
                  ? finish_score<bf16>(x, a.scale, a.softcap, tM[t * kChunk + col])
                  : -INFINITY;
          mx = fmaxf(mx, x);
        }
      const float mnew = fmaxf(rm[half], tc::quad_max(mx));
      const float mref = mnew == -INFINITY ? 0.f : mnew;
      alpha[half] = expf(rm[half] - mref);  // 0 while rm is -inf
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * half + e];
          x = expf(x - mref);
          sum += x;
        }
      rl[half] = rl[half] * alpha[half] + tc::quad_sum(sum);
      rm[half] = mnew;
    }
    unsigned pa[4];  // P of the warp's 16 keys, the A operand of one k-step
    pa[0] = pack_bf16(s[0][0], s[0][1]);
    pa[1] = pack_bf16(s[0][2], s[0][3]);
    pa[2] = pack_bf16(s[1][0], s[1][1]);
    pa[3] = pack_bf16(s[1][2], s[1][3]);
    take(uk + 1);  // V; its barrier also ends every warp's reads of the K tile
    issue(uk + kNS);
    unsigned char* tV = ring + ((uk + 1) % kNS) * kTileB;
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        o[p][n][0] *= alpha[0];
        o[p][n][1] *= alpha[0];
        o[p][n][2] *= alpha[1];
        o[p][n][3] *= alpha[1];
      }
      unsigned vb[4];
      tc::ldmatrix_x4_trans(vb, swz(tV, vrow, 2 * p + vpc));
      tc::mma(o[p][0], pa, vb[0], vb[1]);
      tc::mma(o[p][1], pa, vb[2], vb[3]);
    }
    __syncthreads();  // every warp read the V tile
    issue(uk + 1 + kNS);
  }

  // 4. the partials: the warps' folded into the block's in warp order (with
  //    the columns past the copied span, which add to the sums only); then
  //    the cluster's, the ranks in rank order through distributed shared
  //    memory, each block summing a slice of the outputs, dividing by the
  //    global sum and rounding once
  if (tig == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      wm[warp * kMaxRows + g + 8 * half] = rm[half];
      wl[warp * kMaxRows + g + 8 * half] = rl[half];
    }
  }
  __syncthreads();
  if (tid < R) {
    float m = -INFINITY, l = 0.f;
    for (int w = 0; w < 4; ++w) fold(m, l, wm[w * kMaxRows + tid], wl[w * kMaxRows + tid]);
    const int t = tid / group, na = n_adm[t], nm = n_msk[t];
    if (na > 0) {  // each admitted column adds exp(0 - m), a masked one exp(MASK - m)
      fold(m, l, 0.f, (float)na + (float)nm * expf(kMaskValue));
    } else if (nm > 0) {
      fold(m, l, kMaskValue, (float)nm);
    }
    for (int w = 0; w < 4; ++w) wf[w * kMaxRows + tid] = rescale(wm[w * kMaxRows + tid], m);
    bm[tid] = m;
    bl[tid] = l;
  } else if (tid < kMaxRows) {  // pad rows: nothing to add
    for (int w = 0; w < 4; ++w) wf[w * kMaxRows + tid] = 0.f;
  }
  __syncthreads();  // the factors; the ring is free
  // the block's partial in place of the ring: the warps add theirs in turn
  for (int w = 0; w < 4; ++w) {
    if (warp == w) {
      const float f0 = wf[w * kMaxRows + g], f1 = wf[w * kMaxRows + g + 8];
#pragma unroll
      for (int p = 0; p < kPairs; ++p)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float2* lo = reinterpret_cast<float2*>(bo + g * kLDO + 16 * p + 8 * n + 2 * tig);
          float2* hi = reinterpret_cast<float2*>(bo + (g + 8) * kLDO + 16 * p + 8 * n + 2 * tig);
          const float2 a0 = w == 0 ? make_float2(0.f, 0.f) : *lo;
          const float2 a1 = w == 0 ? make_float2(0.f, 0.f) : *hi;
          *lo = make_float2(a0.x + o[p][n][0] * f0, a0.y + o[p][n][1] * f0);
          *hi = make_float2(a1.x + o[p][n][2] * f1, a1.y + o[p][n][3] * f1);
        }
    }
    __syncthreads();
  }
  cluster.sync();
  if (tid < R) {  // every rank's pair loaded first: one remote latency, not one a rank
    float mr[kMaxRanks], lr[kMaxRanks];
#pragma unroll
    for (int r = 0; r < kMaxRanks; ++r) {
      mr[r] = r < ranks ? *cluster.map_shared_rank(bm + tid, r) : -INFINITY;
      lr[r] = r < ranks ? *cluster.map_shared_rank(bl + tid, r) : 0.f;
    }
    float m = -INFINITY, l = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxRanks; ++r) fold(m, l, mr[r], lr[r]);
#pragma unroll
    for (int r = 0; r < kMaxRanks; ++r) gf[r * kMaxRows + tid] = rescale(mr[r], m) / l;
  }
  __syncthreads();
  const int used = min(ranks, c_keys);  // the ranks holding copied columns
  bf16* out = static_cast<bf16*>(a.out);
  const int nvec = R * HD / 4;
  for (int v = rank * kThreads + tid; v < nvec; v += ranks * kThreads) {
    const int r = 4 * v / HD, d = 4 * v - r * HD;
    float4 x[kMaxRanks];
#pragma unroll
    for (int rr = 0; rr < kMaxRanks; ++rr)
      if (rr < used)
        x[rr] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(bo + r * kLDO + d, rr));
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int rr = 0; rr < kMaxRanks; ++rr) {
      if (rr < used) {
        const float f = gf[rr * kMaxRows + r];
        acc.x += x[rr].x * f;
        acc.y += x[rr].y * f;
        acc.z += x[rr].z * f;
        acc.w += x[rr].w * f;
      }
    }
    const int t = r / group, gg = r - t * group;
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        out + ((long long)(b * T + t) * a.Hq + h * group + gg) * HD + d);
    dst[0] = __floats2bfloat162_rn(acc.x, acc.y);
    dst[1] = __floats2bfloat162_rn(acc.z, acc.w);
  }
  cluster.sync();  // no block leaves while another reads its partial
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

// a [S x M, Hkv, hd] bf16 cache as TMA boxes of one 64-column panel of 64
// rows of one kv head, swizzled by 128 bytes; rows past S x M read as zeros
cudaError_t cache_map(CUtensorMap* map, const void* ptr, long long rows, int Hkv, int hd) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)Hkv, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {2ull * hd, 2ull * hd * Hkv};  // bytes, dims 1-2
  const cuuint32_t box[3] = {64, 1, (cuuint32_t)kChunk}, unit[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch(const Args& a, int S, int B, cudaStream_t s) {
  CUtensorMap mk, mv;
  cudaError_t err = cache_map(&mk, a.ck, (long long)S * a.M, a.Hkv, HD);
  if (err == cudaSuccess) err = cache_map(&mv, a.cv, (long long)S * a.M, a.Hkv, HD);
  const int smem = smem_layout(HD, a.T).total;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ragged_dec<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned ranks = ranks_for(a.nchunks, a.Hkv);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, a.Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ragged_dec<HD>, mk, mv, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t launch_any(const Args& a, int S, int B, cudaStream_t s) {
  if (a.T * (a.Hq / a.Hkv) > kMaxRows || !takes_hd(a.hd)) return cudaErrorInvalidValue;
  switch (a.hd) {
    case 64: return launch<64>(a, S, B, s);
    case 128: return launch<128>(a, S, B, s);
    default: return launch<256>(a, S, B, s);
  }
}

}  // namespace dec

template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename QT, typename KT>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  const int R = a.T * (a.Hq / a.Hkv);
  const int tile = kChunk * row_stride<KT>(a.hd) * (int)sizeof(KT);
  const int smem_a = tile + 4 * R * (a.hd + kChunk);
  const int smem_b = tile + 4 * R * (kChunk + 2);
  cudaError_t err = opt_in(ragged_scores<QT, KT>, smem_a);
  if (err == cudaSuccess) err = opt_in(ragged_pv<QT, KT>, smem_b);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.nchunks, a.Hkv, B);
  ragged_scores<QT, KT><<<grid, kThreads, smem_a, s>>>(a);
  ragged_pv<QT, KT><<<grid, kThreads, smem_b, s>>>(a);
  const int out_blocks = (R * a.hd + kThreads - 1) / kThreads;
  ragged_combine<QT><<<dim3(out_blocks, a.Hkv, B), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q_bf16 / kv_bf16: 1 for bfloat16, 0 for float32.  softcap <= 0 is off.
// The variant follows from (dtype, T, rows, hd) alone (ops/ragged_decode.py
// variant): both bfloat16, hd 64, 128 or 256 (dec::takes_hd) and at most
// dec::kMaxRows query rows per kv head (T x group): dec::ragged_dec; both
// bfloat16, hd <= 256 and tc::kMinRows to tc::kMaxRows at T > 1:
// tc::ragged_tc; neither takes scratch.  S is the caches' row count (the
// TMA maps' extent).  Otherwise
// the CUDA-core passes with scratch: f32,
// scratch_floats(...) elements (ops/ragged_decode.py), laid out as scores,
// chunk maxima, chunk sums, partial outputs.
extern "C" int ragged_decode_launch(int device, int q_bf16, int kv_bf16, const void* q,
                                    const void* k_new, const void* v_new, void* ck, void* cv,
                                    const void* rows, const void* lengths, const void* widx,
                                    const void* mask, void* out, void* scratch, int B, int T,
                                    int Hq, int Hkv, int hd, int M, int S, int K, int page,
                                    float scale, float softcap, void* stream) {
  if (hd % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0 || K <= 0 || page <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.q = q; a.k_new = k_new; a.v_new = v_new; a.ck = ck; a.cv = cv;
  a.rows = static_cast<const int*>(rows);
  a.lengths = static_cast<const int*>(lengths);
  a.widx = static_cast<const int*>(widx);
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = out;
  a.T = T; a.Hq = Hq; a.Hkv = Hkv; a.hd = hd; a.M = M; a.K = K; a.page = page;
  a.nchunks = (K + kChunk - 1) / kChunk;
  a.scale = scale; a.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = T * (Hq / Hkv);
  if (q_bf16 && kv_bf16 && dec::takes_hd(hd) && R <= dec::kMaxRows)
    return (int)dec::launch_any(a, S, B, s);
  if (q_bf16 && kv_bf16 && hd <= 256 && T > 1 && R >= tc::kMinRows && R <= tc::kMaxRows)
    return (int)tc::launch_any(a, B, s);
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const long long rows_all = (long long)B * Hkv * T * (Hq / Hkv);
  a.scores = static_cast<float*>(scratch);
  a.cmax = a.scores + rows_all * K;
  a.csum = a.cmax + rows_all * a.nchunks;
  a.partial = a.csum + rows_all * a.nchunks;
  if (q_bf16 && kv_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(a, B, s);
  else if (q_bf16)
    err = launch<__nv_bfloat16, float>(a, B, s);
  else if (kv_bf16)
    err = launch<float, __nv_bfloat16>(a, B, s);
  else
    err = launch<float, float>(a, B, s);
  return (int)err;
}
