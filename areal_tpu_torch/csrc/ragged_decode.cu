// Ragged paged-decode attention for Hopper (sm_90a), with the K/V append
// fused in.
//
// Replaces the TPU kernel `_kernel` in areal_tpu/ops/ragged_decode.py
// (pallas_call in `_ragged_call`, public `ragged_paged_attention`).  One
// launch is one layer's decode (T = 1) or verify (T = D + 1) attention for
// the whole slot grid.  For each slot the kernel reads the slot's physical
// cache row from the page table, appends the new K/V in place at `widx`
// (index M drops the write), reads only the pages the slot's span covers,
// and applies `naive_attention`'s op order: scores rounded to the compute
// type, then f32, times 1/sqrt(hd), optional softcap, mask to MASK_VALUE,
// softmax (max, exp, sum, divide), probabilities rounded to the compute
// type, then PV with an f32 sum.  Columns past the copied pages count as
// zero K/V (score 0 where the mask admits them, no PV contribution), as in
// the TPU kernel's zero-filled scratch.
//
// What bounds it on this card: bytes.  Per slot and kv head it reads the
// occupied pages of K and V once (span x hd x 2 x itemsize) and does
// ~4 x T x group x hd flops per column, far below the ~300 flops/byte the
// H100 needs before its arithmetic is the limit.
//
// What the design does about it.  The TPU kernel stages two [K, Hkv, hd]
// scratch buffers in VMEM (2 MB at K = 2048), which does not fit the
// 227 KB a Hopper block may use, so it is not carried over.  Instead one
// block per (slot, kv head) streams the occupied K pages straight from
// device memory (a warp per column, lanes across hd), keeps only the f32
// score rows [T x group, K] in shared memory (48 KB at T = 1, group 6,
// K = 2048), runs the softmax there, and streams the V pages once for PV
// (a thread per output element of hd, f32 sums in registers).  Each cache
// byte of the span is read once from device memory.  B x Hkv blocks leave
// most SMs idle at small batch; splitting K across blocks (flash-decoding)
// is later work.
//
// Interface: a plain C entry point bound with ctypes; it launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -2.3819763e38f;
constexpr int kThreads = 128;
constexpr int kMaxPerLane = 8;  // head_dim <= 256
constexpr int kRowBlock = 8;    // PV rows summed per pass over the V pages

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

// one score after the dot product: compute-type rounding, scale, softcap, mask
template <typename QT>
__device__ __forceinline__ float finish_score(float dot, float scale, float softcap, bool keep) {
  float s = round_to<QT>(dot) * scale;
  if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
  return keep ? s : kMaskValue;
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) ragged_decode_kernel(
    const QT* __restrict__ q,           // [B, T, Hq, hd]
    const KT* __restrict__ k_new,       // [B, T, Hkv, hd]
    const KT* __restrict__ v_new,       // [B, T, Hkv, hd]
    KT* ck,                             // [S, M, Hkv, hd], appended in place
    KT* cv,                             // [S, M, Hkv, hd], appended in place
    const int* __restrict__ rows,       // [B] physical cache row per slot
    const int* __restrict__ lengths,    // [B] cache fill per slot
    const int* __restrict__ widx,       // [B, T] write positions, M = drop
    const uint8_t* __restrict__ mask,   // [B, T, K] attended positions
    QT* __restrict__ out,               // [B, T, Hq, hd]
    int T, int Hq, int Hkv, int hd, int M, int K, int page,
    float scale, float softcap) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int group = Hq / Hkv, R = T * group;  // query rows of this kv head
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  float* qs = smem;           // [R, hd] queries as f32
  float* sc = smem + R * hd;  // [R, K] scores, then probabilities

  const long long pos_stride = (long long)Hkv * hd;  // one cache position
  const long long row = rows[b];
  KT* ck_row = ck + row * M * pos_stride + (long long)h * hd;
  KT* cv_row = cv + row * M * pos_stride + (long long)h * hd;

  // columns [0, end) hold the slot's copied pages; the rest count as zero
  const int span = min(lengths[b] + T, K);
  const int n_full = K / page;
  const int npages = min((span + page - 1) / page, n_full);
  const int end = span > n_full * page ? K : npages * page;

  // 1. fused append, written before anything is read (write-then-read)
  for (int t = 0; t < T; ++t) {
    const int wi = widx[b * T + t];
    if (wi < 0 || wi >= M) continue;
    const long long src = ((long long)(b * T + t) * Hkv + h) * hd;
    for (int d = tid; d < hd; d += blockDim.x) {
      ck_row[wi * pos_stride + d] = k_new[src + d];
      cv_row[wi * pos_stride + d] = v_new[src + d];
    }
  }
  for (int i = tid; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const int t = r / group, g = r - t * group;
    qs[i] = to_f(q[((long long)(b * T + t) * Hq + h * group + g) * hd + d]);
  }
  __syncthreads();

  // 2. scores: a warp per column, lanes across hd
  const uint8_t* mrow = mask + (long long)b * T * K;
  for (int c = warp; c < K; c += nwarps) {
    if (c >= end) {
      for (int r = lane; r < R; r += 32)
        sc[r * K + c] = finish_score<QT>(0.f, scale, softcap, mrow[(r / group) * K + c]);
      continue;
    }
    const KT* kc = ck_row + (long long)c * pos_stride;
    float kreg[kMaxPerLane];
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int d = lane + 32 * j;
      kreg[j] = d < hd ? round_to<QT>(to_f(kc[d])) : 0.f;
    }
    for (int r = 0; r < R; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) acc += qs[r * hd + d] * kreg[j];
      }
      acc = warp_sum(acc);
      if (lane == 0)
        sc[r * K + c] = finish_score<QT>(acc, scale, softcap, mrow[(r / group) * K + c]);
    }
  }
  __syncthreads();

  // 3. softmax over all K columns, a warp per row
  for (int r = warp; r < R; r += nwarps) {
    float* s = sc + (long long)r * K;
    float mx = -INFINITY;
    for (int c = lane; c < K; c += 32) mx = fmaxf(mx, s[c]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < K; c += 32) {
      const float e = expf(s[c] - mx);
      s[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < K; c += 32) s[c] = round_to<QT>(s[c] / sum);
  }
  __syncthreads();

  // 4. PV over the copied columns (the rest are zero V): a thread per
  //    output element, up to kRowBlock query rows per pass over V
  for (int d = tid; d < hd; d += blockDim.x) {
    const KT* vc = cv_row + d;
    for (int r0 = 0; r0 < R; r0 += kRowBlock) {
      float acc[kRowBlock];
#pragma unroll
      for (int i = 0; i < kRowBlock; ++i) acc[i] = 0.f;
#pragma unroll 4
      for (int c = 0; c < end; ++c) {
        const float v = round_to<QT>(to_f(vc[(long long)c * pos_stride]));
#pragma unroll
        for (int i = 0; i < kRowBlock; ++i)
          if (r0 + i < R) acc[i] += sc[(r0 + i) * K + c] * v;
      }
#pragma unroll
      for (int i = 0; i < kRowBlock; ++i) {
        const int r = r0 + i;
        if (r < R) {
          const int t = r / group, g = r - t * group;
          out[((long long)(b * T + t) * Hq + h * group + g) * hd + d] = from_f<QT>(acc[i]);
        }
      }
    }
  }
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, void* ck, void* cv,
                   const void* rows, const void* lengths, const void* widx, const void* mask,
                   void* out, int B, int T, int Hq, int Hkv, int hd, int M, int K, int page,
                   float scale, float softcap, int smem_bytes, cudaStream_t stream) {
  auto kernel = ragged_decode_kernel<QT, KT>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(B, Hkv), kThreads, smem_bytes, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_new), static_cast<const KT*>(v_new),
      static_cast<KT*>(ck), static_cast<KT*>(cv), static_cast<const int*>(rows),
      static_cast<const int*>(lengths), static_cast<const int*>(widx),
      static_cast<const uint8_t*>(mask), static_cast<QT*>(out), T, Hq, Hkv, hd, M, K, page,
      scale, softcap);
  return cudaGetLastError();
}

}  // namespace

// q_bf16 / kv_bf16: 1 for bfloat16, 0 for float32.  softcap <= 0 is off.
// smem_bytes = 4 * T * (Hq / Hkv) * (hd + K), computed by the wrapper.
extern "C" int ragged_decode_launch(int device, int q_bf16, int kv_bf16, const void* q,
                                    const void* k_new, const void* v_new, void* ck, void* cv,
                                    const void* rows, const void* lengths, const void* widx,
                                    const void* mask, void* out, int B, int T, int Hq, int Hkv,
                                    int hd, int M, int K, int page, float scale, float softcap,
                                    int smem_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(q, k_new, v_new, ck, cv, rows, lengths, widx,
                                               mask, out, B, T, Hq, Hkv, hd, M, K, page, scale,
                                               softcap, smem_bytes, s);
  else if (q_bf16)
    err = launch<__nv_bfloat16, float>(q, k_new, v_new, ck, cv, rows, lengths, widx, mask, out,
                                       B, T, Hq, Hkv, hd, M, K, page, scale, softcap,
                                       smem_bytes, s);
  else if (kv_bf16)
    err = launch<float, __nv_bfloat16>(q, k_new, v_new, ck, cv, rows, lengths, widx, mask, out,
                                       B, T, Hq, Hkv, hd, M, K, page, scale, softcap,
                                       smem_bytes, s);
  else
    err = launch<float, float>(q, k_new, v_new, ck, cv, rows, lengths, widx, mask, out, B, T,
                               Hq, Hkv, hd, M, K, page, scale, softcap, smem_bytes, s);
  return (int)err;
}
