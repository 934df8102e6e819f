// Hand-written Hopper (sm_90a) attention kernels for the port's model stack.
//
// flash_attention_kernel replaces the TPU kernel
//   src/repro/kernels/flash_attention.py : flash_attention (_kernel)
// decode_attention_kernel replaces the TPU kernel
//   src/repro/kernels/decode_attention.py : decode_attention (_kernel)
//
// Both compute what the TPU kernels and the plain versions
// (kernels/ref.py: flash_attention_ref, decode_attention_ref) compute:
// float32 logits, softmax state and P @ V whatever the input type; masked
// logits set to NEG_INF = -1e30 (not -inf), so a row with no valid key
// averages V uniformly, as the reference does; GQA by reading kv head
// h / (H / Hkv), never a repeated copy of K/V; the output cast to the
// input type (float32, or bfloat16 rounded to nearest even).
//
// What bounds them on an H100:
//  * prefill attention at the served shapes (B 8, S 512, 32 heads of 80,
//    causal) does ~10.7 GFLOP on ~84 MB, ~128 FLOP/byte, below the
//    card's ~295 FLOP/byte bf16 ridge: at the roofline bytes bound it
//    (~0.025 ms). This first kernel runs its products on the CUDA cores
//    in float32 (67 TFLOP/s, no tensor cores), so operations and
//    shared-memory reads bound it instead; wgmma tiles, TMA and warp
//    specialisation are work for a later change.
//  * decode attention reads every cache row once and does 4 FLOP per
//    element: bytes bound it (K + V of the batch over 3.35 TB/s).
//
// What the design does about it:
//  * flash: one block of 256 threads per (64 query rows, head, batch
//    row). Q, and one 64-key tile of K and V at a time, are staged in
//    shared memory as float32 (a row stride of D + 4 floats keeps the
//    16-byte reads of neighbouring rows on distinct banks). Thread
//    (ty, tx) of the 16 x 16 grid owns query rows ty + 16 i and keys
//    tx + 16 j (i, j < 4) of the score tile, and rows ty + 16 i, columns
//    tx + 16 c of the output accumulator, all in registers. A row's
//    maximum and sum reduce across the 16 lanes that share it by warp
//    shuffles; P goes through shared memory to the P @ V product. Tiles
//    that the causal or window mask empties for every row of the block
//    are skipped (no row is then fully masked, so the result is the same).
//    Any sequence length works: rows past the end are zero and never
//    written, keys past the end get weight exactly 0.
//  * decode: one block of 128 threads per (kv head, batch row) serves
//    that head's rep = H / Hkv query heads, so each cache row is read
//    once. Cache tiles of 64 slots are staged in shared memory; one warp
//    per query head updates the online softmax; the accumulator lives in
//    shared memory, one float per (query head, column), owned by one
//    thread. The validity mask comes from kv_pos / q_pos / window.
//  * head_dim: any multiple of 8 up to 256 (StableLM-3B's is 80); rows
//    move 16 bytes at a time. The flash kernel's register accumulator
//    is sized by a template bucket of ceil(D / 16) columns per thread.
//
// Arithmetic: inner products accumulate with explicit __fmaf_rn (the
// library is built with -fmad=false, which only stops the compiler from
// fusing on its own); expf / tanhf are the accurate versions (never
// --use_fast_math); the final division is IEEE (-prec-div=true).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // ref.NEG_INF: the masked logit
constexpr int kBlockQ = 64;         // flash: query rows per block
constexpr int kBlockKV = 64;        // flash: keys per tile
constexpr int kThreads = 256;       // flash: a 16 x 16 thread grid
constexpr int kRows = 4;            // flash: rows per thread, ty + 16 i
constexpr int kCols = 4;            // flash: keys per thread, tx + 16 j
constexpr int kLdP = kBlockKV + 4;  // flash: row stride of the P tile
constexpr int kDecThreads = 128;    // decode: threads per block
constexpr int kDecSlots = 64;       // decode: cache slots per tile
constexpr int kMaxHeadDim = 256;
constexpr unsigned kFull = 0xffffffffu;

// Eight consecutive elements (16 bytes of bf16, 32 of float32) as floats.
__device__ __forceinline__ void load8(const float* src, float* dst) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }

__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// Stage `rows` rows of D elements into shared memory as float32, row r
// at dst + r * ld. Global row r of the tile sits at base + (row0 + r) *
// row_stride; rows at and past n_valid are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base,
                                          int64_t row_stride, int row0,
                                          int n_valid, int rows, int D) {
  const int chunks = D / 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    float v[8];
    if (r < n_valid) {
      load8(base + static_cast<int64_t>(row0 + r) * row_stride + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    float4* o = reinterpret_cast<float4*>(dst + r * ld + c);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}

// Scale, soft-cap and mask one logit as the reference does (scale, then
// tanh cap, then NEG_INF where masked); -inf past the end of the keys so
// its weight is exactly 0.
__device__ __forceinline__ float logit(float dot, float scale, float softcap,
                                       bool in_range, bool valid) {
  if (!in_range) return __int_as_float(0xff800000);  // -inf
  float x = dot * scale;
  if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
  return valid ? x : kNegInf;
}

__host__ __device__ constexpr int padded_ld(int D) { return D + 4; }

size_t flash_smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(kBlockQ + 2 * kBlockKV) *
                              padded_ld(D) + kBlockQ * kLdP);
}

size_t decode_smem_bytes(int rep, int D) {
  const size_t ld = padded_ld(D);
  return sizeof(float) * (rep * ld + 2 * kDecSlots * ld + rep * kDecSlots +
                          static_cast<size_t>(rep) * D + 3 * rep);
}

// ------------------------------------------------------------ prefill --
// grid (ceil(Sq / 64), H, B), block 256. q (B, Sq, H, D); k, v (B, Skv,
// Hkv, D); out (B, Sq, H, D). Query i sits at position Skv - Sq + i.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Skv, int H, int Hkv, int D, float scale,
                       int causal, int window, float softcap) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  const int ld = padded_ld(D);
  float* k_s = q_s + kBlockQ * ld;
  float* v_s = k_s + kBlockKV * ld;
  float* p_s = v_s + kBlockKV * ld;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBlockQ;
  const int q_offset = Skv - Sq;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
  const T* q_b = q + (static_cast<int64_t>(b) * Sq * H + h) * D;
  const T* k_b = k + (static_cast<int64_t>(b) * Skv * Hkv + hk) * D;
  const T* v_b = v + (static_cast<int64_t>(b) * Skv * Hkv + hk) * D;

  load_tile(q_s, ld, q_b, q_stride, q0, min(kBlockQ, Sq - q0), kBlockQ, D);

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // Keys any row of this block can see. With Sq <= Skv every row has a
  // valid key (itself, at least), so skipping tiles outside this range
  // changes nothing; with Sq > Skv leading rows see no key and average V
  // over every tile, so nothing is skipped.
  int kv_begin = 0, kv_end = Skv;
  if (q_offset >= 0) {
    const int pos_lo = q0 + q_offset;
    const int pos_hi = min(q0 + kBlockQ, Sq) - 1 + q_offset;
    if (causal) kv_end = min(Skv, pos_hi + 1);
    if (window > 0) kv_begin = max(0, pos_lo - window + 1);
  }

  for (int j0 = kv_begin / kBlockKV * kBlockKV; j0 < kv_end;
       j0 += kBlockKV) {
    __syncthreads();  // the previous tile is consumed (Q is staged)
    const int n_valid = min(kBlockKV, Skv - j0);
    load_tile(k_s, ld, k_b, kv_stride, j0, n_valid, kBlockKV, D);
    load_tile(v_s, ld, v_b, kv_stride, j0, n_valid, kBlockKV, D);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * ld + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int pos = q0 + ty + 16 * i + q_offset;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int key = j0 + tx + 16 * j;
        const bool valid = (!causal || key <= pos) &&
                           (window <= 0 || key > pos - window);
        s[i][j] = logit(s[i][j], scale, softcap, key < Skv, valid);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float corr = expf(m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - mx);
        p_s[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        rs += __shfl_xor_sync(kFull, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // a P row is written and read by the same 16 lanes

    for (int j = 0; j < n_valid; ++j) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = p_s[(ty + 16 * i) * kLdP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float vv = v_s[j * ld + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            acc[i][c] = __fmaf_rn(p[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<int64_t>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(o + d, acc[i][c] / den);
    }
  }
}

// ------------------------------------------------------------- decode --
// grid (Hkv, B), block 128. q (B, H, D); k_cache, v_cache (B, C, Hkv, D);
// kv_pos (B, C); q_pos (B,); out (B, H, D). Query heads hk * rep ..
// hk * rep + rep - 1 read kv head hk.
template <typename T>
__global__ void __launch_bounds__(kDecThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const int32_t* __restrict__ kv_pos,
                        const int32_t* __restrict__ q_pos,
                        T* __restrict__ out, int C, int H, int Hkv, int D,
                        float scale, int window, float softcap) {
  extern __shared__ float4 smem4[];
  const int rep = H / Hkv;
  const int ld = padded_ld(D);
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + rep * ld;
  float* v_s = k_s + kDecSlots * ld;
  float* p_s = v_s + kDecSlots * ld;      // rep x kDecSlots
  float* acc_s = p_s + rep * kDecSlots;   // rep x D
  float* m_s = acc_s + rep * D;
  float* l_s = m_s + rep;
  float* corr_s = l_s + rep;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
  const T* k_b = kc + (static_cast<int64_t>(b) * C * Hkv + hk) * D;
  const T* v_b = vc + (static_cast<int64_t>(b) * C * Hkv + hk) * D;
  const int32_t* pos_b = kv_pos + static_cast<int64_t>(b) * C;
  const int qp = q_pos[b];

  load_tile(q_s, ld, q + (static_cast<int64_t>(b) * H + hk * rep) * D, D, 0,
            rep, rep, D);
  for (int idx = threadIdx.x; idx < rep * D; idx += blockDim.x)
    acc_s[idx] = 0.f;
  for (int r = threadIdx.x; r < rep; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  for (int j0 = 0; j0 < C; j0 += kDecSlots) {
    __syncthreads();  // the previous tile is consumed (q, state staged)
    const int n_valid = min(kDecSlots, C - j0);
    load_tile(k_s, ld, k_b, kv_stride, j0, n_valid, kDecSlots, D);
    load_tile(v_s, ld, v_b, kv_stride, j0, n_valid, kDecSlots, D);
    __syncthreads();

    for (int idx = threadIdx.x; idx < rep * kDecSlots; idx += blockDim.x) {
      const int r = idx / kDecSlots;
      const int j = idx - r * kDecSlots;
      float dot = 0.f;
      bool valid = false;
      if (j < n_valid) {
        for (int d = 0; d < D; d += 4)
          dot = dot4(*reinterpret_cast<const float4*>(q_s + r * ld + d),
                     *reinterpret_cast<const float4*>(k_s + j * ld + d), dot);
        const int kp = pos_b[j0 + j];
        valid = kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
      }
      p_s[idx] = logit(dot, scale, softcap, j < n_valid, valid);
    }
    __syncthreads();

    for (int r = warp; r < rep; r += kDecThreads / 32) {
      float mx = m_s[r];
      for (int j = lane; j < kDecSlots; j += 32)
        mx = fmaxf(mx, p_s[r * kDecSlots + j]);
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      float sum = 0.f;
      for (int j = lane; j < kDecSlots; j += 32) {
        const float p = expf(p_s[r * kDecSlots + j] - mx);
        p_s[r * kDecSlots + j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      if (lane == 0) {
        const float corr = expf(m_s[r] - mx);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = mx;
      }
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < rep * D; idx += blockDim.x) {
      const int r = idx / D;
      const int d = idx - r * D;
      const float* p = p_s + r * kDecSlots;
      float a = acc_s[idx] * corr_s[r];
      for (int j = 0; j < n_valid; ++j)
        a = __fmaf_rn(p[j], v_s[j * ld + d], a);
      acc_s[idx] = a;
    }
  }
  __syncthreads();

  T* o = out + (static_cast<int64_t>(b) * H + hk * rep) * D;
  for (int idx = threadIdx.x; idx < rep * D; idx += blockDim.x)
    store(o + idx, acc_s[idx] / fmaxf(l_s[idx / D], 1e-30f));
}

// Opt in to more than 48 KB of dynamic shared memory, once per kernel
// and size.
template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t bytes, size_t* reserved) {
  if (bytes <= 48 * 1024 || bytes <= *reserved) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e == cudaSuccess) *reserved = bytes;
  return e;
}

template <typename T, int NC>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 int B, int Sq, int Skv, int H, int Hkv, int D, float scale,
                 int causal, int window, float softcap, cudaStream_t stream) {
  static size_t reserved = 0;
  const size_t bytes = flash_smem_bytes(D);
  const cudaError_t e =
      reserve_smem(flash_attention_kernel<T, NC>, bytes, &reserved);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_kernel<T, NC><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, Hkv, D,
      scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_flash_d(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int Hkv, int D, float scale,
                   int causal, int window, float softcap,
                   cudaStream_t stream) {
  if (D <= 32)
    return launch_flash<T, 2>(q, k, v, out, B, Sq, Skv, H, Hkv, D, scale,
                              causal, window, softcap, stream);
  if (D <= 64)
    return launch_flash<T, 4>(q, k, v, out, B, Sq, Skv, H, Hkv, D, scale,
                              causal, window, softcap, stream);
  if (D <= 80)
    return launch_flash<T, 5>(q, k, v, out, B, Sq, Skv, H, Hkv, D, scale,
                              causal, window, softcap, stream);
  if (D <= 128)
    return launch_flash<T, 8>(q, k, v, out, B, Sq, Skv, H, Hkv, D, scale,
                              causal, window, softcap, stream);
  return launch_flash<T, 16>(q, k, v, out, B, Sq, Skv, H, Hkv, D, scale,
                             causal, window, softcap, stream);
}

template <typename T>
int launch_decode(const void* q, const void* kc, const void* vc,
                  const int32_t* kv_pos, const int32_t* q_pos, void* out,
                  int B, int C, int H, int Hkv, int D, float scale,
                  int window, float softcap, cudaStream_t stream) {
  static size_t reserved = 0;
  const size_t bytes = decode_smem_bytes(H / Hkv, D);
  const cudaError_t e =
      reserve_smem(decode_attention_kernel<T>, bytes, &reserved);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(Hkv, B);
  decode_attention_kernel<T><<<grid, kDecThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), kv_pos, q_pos, static_cast<T*>(out), C, H,
      Hkv, D, scale, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int S, int H, int Hkv, int D) {
  return B < 0 || S < 1 || Hkv < 1 || H % Hkv != 0 || D % 8 != 0 || D < 8 ||
         D > kMaxHeadDim;
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype 0 is float32, 1 bfloat16.
// Each launcher enqueues on the caller's stream, never synchronises, and
// returns cudaGetLastError().
extern "C" {

int laimr_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int dtype, int B, int Sq, int Skv,
                          int H, int Hkv, int D, float scale, int causal,
                          int window, float softcap, void* stream) {
  if (bad_shape(B, Sq, H, Hkv, D) || Skv < 1 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_flash_d<float>(q, k, v, out, B, Sq, Skv, H, Hkv, D, scale,
                                 causal, window, softcap, st);
  if (dtype == 1)
    return launch_flash_d<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, Hkv, D,
                                         scale, causal, window, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int laimr_decode_attention(const void* q, const void* k_cache,
                           const void* v_cache, const int32_t* kv_pos,
                           const int32_t* q_pos, void* out, int dtype, int B,
                           int C, int H, int Hkv, int D, float scale,
                           int window, float softcap, void* stream) {
  if (bad_shape(B, C, H, Hkv, D) || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_decode<float>(q, k_cache, v_cache, kv_pos, q_pos, out, B,
                                C, H, Hkv, D, scale, window, softcap, st);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(q, k_cache, v_cache, kv_pos, q_pos,
                                        out, B, C, H, Hkv, D, scale, window,
                                        softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* laimr_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
