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
// What bounds it on this card: bytes.  Per slot and kv head it reads the
// occupied pages of K and V once (span x hd x 2 x itemsize) and does
// ~4 x T x group x hd flops per column: ~6 flops per byte at T = 1, below
// even the f32 CUDA cores' ~20, far below the tensor cores' ~300.
//
// What the design does about it: parallelism and wide, early loads.  The
// key axis is cut into fixed chunks of kChunk positions, and every pass
// runs one block per (chunk, kv head, slot): a few hundred blocks at the
// serving shape instead of one per (slot, kv head).  A chunk's K or V rows
// arrive by 16-byte cp.async into shared memory in the cache's own dtype
// (rows padded by 16 bytes, so a warp's row-wise reads hit distinct
// banks), issued before the block's other work, and are widened to f32 in
// registers.  A block whose chunk lies wholly past the slot's copied span
// reads no K/V.  The op order needs the global max and sum before any
// probability is rounded, so the softmax takes two passes and the partial
// outputs a third, with f32 scratch the wrapper allocates:
//   (a) ragged_scores: append, scores of the chunk into scratch [B, Hkv,
//       R, K] (R = T x group query rows per kv head), and the chunk's
//       (max, sum of exp(s - max)) per row;
//   (b) ragged_pv: per row the global (m, l) folded from the chunk
//       statistics in chunk order, p = round(exp(s - m) / l) for the
//       chunk's copied columns, and the chunk's partial PV in f32;
//   (c) ragged_combine: per output element the partials summed in chunk
//       order, rounded once and stored.
// Chunk boundaries are fixed key positions, independent of B, T and the
// card, and nothing is combined by atomics: a slot's output does not
// depend on which slots share the batch nor on T, and reruns are bit-equal.
//
// Fused append, write-then-read: the block whose chunk holds a write
// position stores k_new / v_new there and uses the new key in place of
// what its copy read; V is read only by pass (b), after pass (a) ended.
// Positions in [K, M) are written by the last chunk's block and never read.
//
// Interface: a plain C entry point bound with ctypes; it launches the three
// kernels on the caller's stream and returns cudaGetLastError().

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
// scratch: f32, ragged_scratch_floats(...) elements (ops/ragged_decode.py),
// laid out as scores, chunk maxima, chunk sums, partial outputs.
extern "C" int ragged_decode_launch(int device, int q_bf16, int kv_bf16, const void* q,
                                    const void* k_new, const void* v_new, void* ck, void* cv,
                                    const void* rows, const void* lengths, const void* widx,
                                    const void* mask, void* out, void* scratch, int B, int T,
                                    int Hq, int Hkv, int hd, int M, int K, int page,
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
  const long long rows_all = (long long)B * Hkv * T * (Hq / Hkv);
  a.scores = static_cast<float*>(scratch);
  a.cmax = a.scores + rows_all * K;
  a.csum = a.cmax + rows_all * a.nchunks;
  a.partial = a.csum + rows_all * a.nchunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
