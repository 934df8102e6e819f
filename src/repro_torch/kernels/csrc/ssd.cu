// Hand-written Hopper (sm_90a) Mamba-2 SSD scan for the port's model stack.
//
// ssd_scan_kernel replaces the TPU kernel
//   src/repro/kernels/ssd_scan.py : ssd_scan (_kernel)
//
// It computes what the TPU kernel and the plain version
// (kernels/ref.py: ssd_scan_ref, a sequential float32 recurrence) compute,
// by the TPU kernel's chunked algorithm (arXiv:2405.21060 §6): split the
// sequence into chunks of Q = 64 steps and, for each (batch row, head),
//
//   seg      = cumsum(dt * a)                      (in-chunk log-decay)
//   y_diag   = ((C B^T) . L) (dt * x),  L[i][j] = exp(seg_i - seg_j), i >= j
//   y_off    = exp(seg) . (C H_prev^T)
//   H        = exp(seg_last) H_prev + sum_j exp(seg_last - seg_j) dt_j x_j b_j^T
//   y        = y_diag + y_off + d_skip * x
//
// with H, the (P x N) state, carried from chunk to chunk. Everything is
// float32 whatever the input type (x, b, c float32 or bfloat16); y is cast
// to x's type, the final state stays float32. Head h reads group
// h / (H / G) of b and c.
//
// What bounds it on an H100: at the served prefill shape (B 8, L 2048,
// H 32, P 64, G 1, N 128, bf16) the function moves ~153 MB (x and y 67 MB
// each, dt, b, c, the final state) and the chunked algorithm does ~30
// GFLOP: bytes bound it (~0.046 ms at 3.35 TB/s; the operations take
// ~0.030 ms at the bf16 tensor-core rate). This first kernel runs its
// products on the CUDA cores in float32 (67 TFLOP/s, no tensor cores), so
// operations bound it instead, at ~0.45 ms at best; wgmma tiles, TMA and a
// split of the grid for small batches are work for a later change.
//
// What the design does about it:
//  * One block of 256 threads per (head, batch row) walks the chunks in
//    order. The P x N float32 state (32 KB at P 64, N 128) stays in shared
//    memory from the first chunk to the last; it is read from h0 (or zero)
//    once and written to h_final once.
//  * Each chunk stages x, b and c as float32 tiles in shared memory (row
//    strides padded so that the 16-byte reads of neighbouring rows fall on
//    distinct banks), and warp 0 turns dt into seg by a shuffle scan.
//    Three register-tiled passes follow, separated by two barriers:
//      1. C B^T and C H_prev^T together (both read the C rows), a 4 x 4
//         tile of each per thread; out of them the masked, decayed,
//         dt-weighted Q x Q matrix M and exp(seg) . C H_prev^T go to
//         shared memory;
//      2. y = M x + that + d_skip x, a 4 x 4 tile per thread, written out;
//      3. the state update, an 8 x 4 tile of H per thread (run in the
//         same interval as 2: neither writes what the other reads).
//  * The decay mask: exp(seg_i - seg_j) is formed only where i >= j. Above
//    the diagonal seg_i - seg_j > 0 can be hundreds and exp would be inf
//    (and inf * 0 is NaN). exp(seg) and exp(seg_last - seg_j) never exceed
//    1 and may underflow to 0, which is their value; nothing forms
//    exp(-seg) or divides by a decay.
//  * Any L: rows of the last chunk at and past L are zero, with dt = 0, so
//    they add nothing to the state; seg_last is read at the last valid row;
//    nothing is written past L.
//  * Any P <= 64 and N <= 128 (the tiles are sized for those and
//    zero-padded).
//
// Arithmetic: products accumulate with explicit __fmaf_rn (the library is
// built with -fmad=false, which only stops the compiler from fusing on its
// own); expf is the accurate version (never --use_fast_math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;          // chunk length
constexpr int kThreads = 256;   // a 16 x 16 grid, or 8 warps
constexpr int kPMax = 64;       // head dim the tiles hold
constexpr int kNMax = 128;      // state dim the tiles hold
constexpr int kLdX = kPMax + 4;  // row strides (floats) of the tiles
constexpr int kLdBC = kNMax + 4;
constexpr int kLdH = kNMax + 4;
constexpr int kLdM = kQ + 16;    // 16 mod 32: the two rows a warp stores
constexpr int kLdY = kPMax + 16; // in one pass land on distinct banks
constexpr unsigned kFull = 0xffffffffu;

// shared-memory carve-up, in floats
constexpr int kOffX = 0;
constexpr int kOffB = kOffX + kQ * kLdX;
constexpr int kOffC = kOffB + kQ * kLdBC;
constexpr int kOffH = kOffC + kQ * kLdBC;
constexpr int kOffM = kOffH + kPMax * kLdH;
constexpr int kOffY = kOffM + kQ * kLdM;
constexpr int kOffSeg = kOffY + kQ * kLdY;
constexpr int kOffDt = kOffSeg + kQ;
constexpr int kOffW = kOffDt + kQ;
constexpr int kSmemFloats = kOffW + kQ;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Stage rows [row0, row0 + valid) of a (rows, cols) slice into a kQ x
// kCols float32 tile with row stride ld; everything else of the tile's
// kCols columns is zero. Global row r sits at base + r * row_stride.
template <int kCols, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base,
                                          int64_t row_stride, int row0,
                                          int valid, int cols) {
  static_assert((kQ * kCols) % kThreads == 0, "tile / thread count");
#pragma unroll 8
  for (int k = 0; k < kQ * kCols / kThreads; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    const int r = idx / kCols;
    const int col = idx - r * kCols;
    float v = 0.f;
    if (r < valid && col < cols)
      v = to_float(base[static_cast<int64_t>(row0 + r) * row_stride + col]);
    dst[r * ld + col] = v;
  }
}

// grid (H, B), block 256. x (B, L, H, P); dt (B, L, H); a, d_skip (H,);
// b, c (B, L, G, N); h0 (B, H, P, N) or null; y (B, L, H, P);
// h_final (B, H, P, N).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ b,
                const T* __restrict__ c, const float* __restrict__ d_skip,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ h_final, int L, int H, int P, int G,
                int N) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* x_s = smem + kOffX;
  float* b_s = smem + kOffB;
  float* c_s = smem + kOffC;
  float* h_s = smem + kOffH;
  float* m_s = smem + kOffM;
  float* yo_s = smem + kOffY;
  float* seg_s = smem + kOffSeg;
  float* dt_s = smem + kOffDt;
  float* w_s = smem + kOffW;

  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n4 = (N + 3) / 4 * 4;
  const float a_h = a[h];
  const float d_h = d_skip[h];
  const int64_t x_row = static_cast<int64_t>(H) * P;
  const int64_t bc_row = static_cast<int64_t>(G) * N;
  const T* x_b = x + (static_cast<int64_t>(bi) * L * H + h) * P;
  T* y_b = y + (static_cast<int64_t>(bi) * L * H + h) * P;
  const float* dt_b = dt + static_cast<int64_t>(bi) * L * H + h;
  const T* b_b = b + (static_cast<int64_t>(bi) * L * G + g) * N;
  const T* c_b = c + (static_cast<int64_t>(bi) * L * G + g) * N;
  const int64_t state = (static_cast<int64_t>(bi) * H + h) * P * N;

  // the state: h0, or zeros; rows >= P and columns >= N stay zero
  for (int idx = tid; idx < kPMax * kLdH; idx += kThreads) {
    const int p = idx / kLdH;
    const int n = idx - p * kLdH;
    h_s[idx] = (h0 != nullptr && p < P && n < N)
                   ? h0[state + static_cast<int64_t>(p) * N + n]
                   : 0.f;
  }

  for (int c0 = 0; c0 < L; c0 += kQ) {
    const int valid = min(kQ, L - c0);
    __syncthreads();  // the last chunk's passes 2 and 3 are done with the tiles

    // ---- stage the chunk; warp 0 scans dt * a into seg ------------------
    if (warp == 0) {
      const int r0 = 2 * lane, r1 = 2 * lane + 1;
      const float dt0 = r0 < valid ? dt_b[static_cast<int64_t>(c0 + r0) * H]
                                   : 0.f;
      const float dt1 = r1 < valid ? dt_b[static_cast<int64_t>(c0 + r1) * H]
                                   : 0.f;
      const float v0 = dt0 * a_h, v1 = dt1 * a_h;
      float s = v0 + v1;  // inclusive scan of the pair sums
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float t = __shfl_up_sync(kFull, s, off);
        if (lane >= off) s += t;
      }
      float excl = __shfl_up_sync(kFull, s, 1);
      if (lane == 0) excl = 0.f;
      const float s0 = excl + v0;
      seg_s[r0] = s0;
      seg_s[r1] = s0 + v1;
      dt_s[r0] = dt0;
      dt_s[r1] = dt1;
    }
    load_tile<kPMax>(x_s, kLdX, x_b, x_row, c0, valid, P);
    load_tile<kNMax>(b_s, kLdBC, b_b, bc_row, c0, valid, N);
    load_tile<kNMax>(c_s, kLdBC, c_b, bc_row, c0, valid, N);
    __syncthreads();

    // ---- pass 1: C B^T and C H_prev^T; rows ty + 16 r, cols tx + 16 q --
    {
      float cb[4][4], ch[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) cb[r][q] = ch[r][q] = 0.f;
      for (int n = 0; n < n4; n += 4) {
        float4 cv[4], bv[4], hv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = ld4(c_s + (ty + 16 * r) * kLdBC + n);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          bv[q] = ld4(b_s + (tx + 16 * q) * kLdBC + n);
          hv[q] = ld4(h_s + (tx + 16 * q) * kLdH + n);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            cb[r][q] = dot4(cv[r], bv[q], cb[r][q]);
            ch[r][q] = dot4(cv[r], hv[q], ch[r][q]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        const float seg_i = seg_s[i];
        const float decay_i = expf(seg_i);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = tx + 16 * q;
          // M[i][j] = (C B^T)[i][j] exp(seg_i - seg_j) dt_j, only for i >= j
          m_s[i * kLdM + j] =
              j <= i ? cb[r][q] * expf(seg_i - seg_s[j]) * dt_s[j] : 0.f;
          yo_s[i * kLdY + j] = decay_i * ch[r][q];  // j is the column p here
        }
      }
      if (tid < kQ)  // the state weights exp(seg_last - seg_j) dt_j
        w_s[tid] = expf(seg_s[valid - 1] - seg_s[tid]) * dt_s[tid];
    }
    __syncthreads();

    // ---- pass 2: y = M x + y_off + d x; rows ty + 16 r, cols 4 tx + e --
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
      // M is zero above the diagonal: stop after this thread's last row
      const int j_end = min(valid, (ty + 48) / 4 * 4 + 4);
      for (int j = 0; j < j_end; j += 4) {
        float4 mv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) mv[r] = ld4(m_s + (ty + 16 * r) * kLdM + j);
#pragma unroll
        for (int k = 0; k < 4; ++k) xv[k] = ld4(x_s + (j + k) * kLdX + 4 * tx);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float m[4] = {mv[r].x, mv[r].y, mv[r].z, mv[r].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[r][0] = __fmaf_rn(m[k], xv[k].x, acc[r][0]);
            acc[r][1] = __fmaf_rn(m[k], xv[k].y, acc[r][1]);
            acc[r][2] = __fmaf_rn(m[k], xv[k].z, acc[r][2]);
            acc[r][3] = __fmaf_rn(m[k], xv[k].w, acc[r][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i >= valid) continue;
        T* out = y_b + static_cast<int64_t>(c0 + i) * x_row;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 4 * tx + e;
          if (p < P)
            store(out + p, (acc[r][e] + yo_s[i * kLdY + p]) +
                               x_s[i * kLdX + p] * d_h);
        }
      }
    }

    // ---- pass 3: H = exp(seg_last) H + sum_j w_j x_j b_j^T; rows 8 warp
    //      + k, cols 4 lane + e ------------------------------------------
    {
      float st[8][4];
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[k][e] = 0.f;
      for (int j = 0; j < valid; ++j) {
        const float wj = w_s[j];
        float4 bv = ld4(b_s + j * kLdBC + 4 * lane);
        bv.x *= wj;
        bv.y *= wj;
        bv.z *= wj;
        bv.w *= wj;
        const float4 x0 = ld4(x_s + j * kLdX + 8 * warp);
        const float4 x1 = ld4(x_s + j * kLdX + 8 * warp + 4);
        const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          st[k][0] = __fmaf_rn(xs[k], bv.x, st[k][0]);
          st[k][1] = __fmaf_rn(xs[k], bv.y, st[k][1]);
          st[k][2] = __fmaf_rn(xs[k], bv.z, st[k][2]);
          st[k][3] = __fmaf_rn(xs[k], bv.w, st[k][3]);
        }
      }
      const float decay_last = expf(seg_s[valid - 1]);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float4* hp = reinterpret_cast<float4*>(h_s + (8 * warp + k) * kLdH +
                                               4 * lane);
        float4 hv = *hp;
        hv.x = decay_last * hv.x + st[k][0];
        hv.y = decay_last * hv.y + st[k][1];
        hv.z = decay_last * hv.z + st[k][2];
        hv.w = decay_last * hv.w + st[k][3];
        *hp = hv;
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int p = idx / N;
    h_final[state + idx] = h_s[p * kLdH + (idx - p * N)];
  }
}

template <typename T>
int launch_ssd(const void* x, const float* dt, const float* a, const void* b,
               const void* c, const float* d_skip, const float* h0, void* y,
               float* h_final, int B, int L, int H, int P, int G, int N,
               cudaStream_t stream) {
  // more than 48 KB of dynamic shared memory needs an opt-in, once
  static bool reserved = false;
  if (!reserved) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    reserved = true;
  }
  const dim3 grid(H, B);
  ssd_scan_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b),
      static_cast<const T*>(c), d_skip, h0, static_cast<T*>(y), h_final, L,
      H, P, G, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype 0 is float32, 1 bfloat16
// (of x, b, c and y; dt, a, d_skip, h0 and h_final are float32). h0 may
// be null: the scan then starts from zeros. The launcher enqueues on the
// caller's stream, never synchronises, and returns cudaGetLastError().
extern "C" {

int laimr_ssd_scan(const void* x, const float* dt, const float* a,
                   const void* b, const void* c, const float* d_skip,
                   const float* h0, void* y, float* h_final, int dtype,
                   int B, int L, int H, int P, int G, int N, void* stream) {
  if (B < 0 || B > 65535 || L < 1 || H < 1 || G < 1 || H % G != 0 ||
      P < 1 || P > kPMax || N < 1 || N > kNMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_ssd<float>(x, dt, a, b, c, d_skip, h0, y, h_final, B, L, H,
                             P, G, N, st);
  if (dtype == 1)
    return launch_ssd<__nv_bfloat16>(x, dt, a, b, c, d_skip, h0, y, h_final,
                                     B, L, H, P, G, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* laimr_ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
