// Hand-written Hopper (sm_90a) Mamba-2 SSD scan for the port's model stack.
//
// ssd_scan_kernel replaces the TPU kernel
//   src/repro/kernels/ssd_scan.py:85 ssd_scan (pallas_call at :101)
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
// with H, the (P x N) state, carried from chunk to chunk in float32. y is
// cast to x's type, the final state stays float32. Head h reads group
// h / (H / G) of b and c. The input dtype picks the body.
//
// What bounds it on an H100: at the served prefill shape (B 8, L 2048,
// H 32, P 64, G 1, N 128, bf16) the function moves ~153 MB (x and y 67 MB
// each, dt, b, c, the final state): bytes bound it at ~0.046 ms (3.35
// TB/s). Its four chunk products are ~30 GFLOP, ~52 with the hi/lo splits
// below: ~0.05 ms at the bf16 tensor-core rate, but ~0.45 ms at best on
// the CUDA cores in float32. Each block walks its chunks in order, so the
// chunk's chain of products, loads and barriers is what a block waits on;
// at one long prompt (B 1, L 32768) 32 (head) blocks would hold 32 of 132
// SMs for 512 chunks each.
//
// The bf16 body (the served dtype), and what it does about that:
//  * Tensor cores for all four products, float32 accumulators, bf16
//    operands. C, B and x are exact in bf16. M = (C B^T) exp(seg_i -
//    seg_j) dt_j, H_prev and x w dt are float32, and each is split into
//    bf16 hi (the value truncated) + lo (the rest, rounded), two products
//    each: every weight then errs by ~2^-17, not the 2^-9 of one part. A
//    plain emulation of this arithmetic (tests/test_torch_kernels.py,
//    TestSSDBf16Precision) misses MODEL_BF16_TOL with any of the three
//    left as one bf16 part and stays inside it with all three split.
//  * Two warpgroups. The y warpgroup (warps 0-3, 16 chunk rows each)
//    computes S = C B^T, forms M on S's accumulator fragments (the mask
//    and exp(seg_i - seg_j) only where i >= j, so no inf or NaN arises;
//    dt_j there too), and M x with M's hi and lo parts as A fragments
//    straight from registers. The state warpgroup (warps 4-7) holds H in
//    its accumulators from h0 (or zero) to h_final, read once and written
//    once; per chunk it first computes y_off^T = H_prev C^T with H_prev's
//    hi/lo parts as A fragments from those accumulators (no copy of H in
//    shared memory), scales it by exp(seg_i) and hands it over through
//    shared memory (named barrier 1), then updates H += (x w dt)^T B. The
//    y warpgroup adds y_off and d_skip x, stages y in shared memory and
//    writes it in 16-byte pieces.
//  * Instructions: every product is wgmma m64n64k16, since every operand
//    tile has 64 rows (P below 64 is zero-padded to the tile): S from
//    shared memory (C and B K-major), M x and y_off^T with A from
//    registers (x MN-major, C K-major), the state update with A = (x w
//    dt)^T from registers (ldmatrix.trans of x, weighted and split) and B
//    MN-major (two n64 halves of N).
//  * Memory and overlap: x, b and c stay bf16 in shared memory, two
//    stages, and chunk k + 1 is requested before chunk k computes. They
//    arrive as TMA boxes of 64 rows x 64 columns with the 128-byte
//    swizzle (rows past L and columns past N or P read as zero), one
//    thread issuing, completing on the stage's mbarrier, so no warp
//    stalls on the copy (a thread-issued cp.async version spent more time
//    issuing than computing); dt goes by cp.async. Shapes TMA cannot take
//    (N or P not a multiple of 8, a misaligned base) stage the same
//    layout by threads. Shared memory: 113.5 KB; the registers (ptxas
//    lines in chip_smoke.py's build phase) hold one block of 256 threads
//    per SM.
//  * grid (H, B). State rows are independent in p, so slicing P across
//    blocks would be exact, but a block's time is its chain of chunks,
//    not the number of busy SMs: 16-row slices at B 1 (4 x 32 blocks)
//    measured no faster than one slice, so the body keeps whole heads.
//  * Any L (a ragged last chunk, L = 1: its rows past L are zero with
//    dt = 0, and seg_last is read at the last valid row), P <= 64 and
//    N <= 128 (zero-padded to the tile and to the mma depth), G dividing
//    H; nothing is written past L or past P.
//
// The float32 body (the parity dtype) runs on the CUDA cores: one block of
// 256 threads per (head, batch row) with the P x N state in shared memory
// and three register-tiled passes per chunk (C B^T with C H_prev^T, then
// y, with the state update beside it), products with explicit __fmaf_rn
// (the library is built with -fmad=false) and the accurate expf. The bf16
// body takes its decays as ex2.approx (2^-22 relative) of log2-scaled
// seg, far inside the bf16 bound. Hand PTX (wgmma, ldmatrix, TMA,
// mbarrier, cp.async); no CUTLASS headers, no library call.
//
// Beside it, the three launches of a Mamba-2 layer's decode mixer between
// in_proj and out_proj (the served decode step; each note is at its
// kernel): ssd_conv_step_kernel (the conv step and dt), ssd_step_kernel
// (the state update, B and C read by group) and ssd_gated_norm_kernel.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kQ = 64;          // chunk length
constexpr int kThreads = 256;   // a 16 x 16 grid, or 2 warpgroups
constexpr int kPMax = 64;       // head dim the tiles hold
constexpr int kNMax = 128;      // state dim the tiles hold
constexpr int kLdX = kPMax + 4;  // row strides (floats) of the tiles
constexpr int kLdBC = kNMax + 4;
constexpr int kLdH = kNMax + 4;
constexpr int kLdM = kQ + 16;    // 16 mod 32: the two rows a warp stores
constexpr int kLdY = kPMax + 16; // in one pass land on distinct banks
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

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

// x rounded to T and back: a cast to the model dtype, as PyTorch's .to()
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, float>::value) return x;
  else return __bfloat162float(__float2bfloat16_rn(x));
}

// PyTorch's SiLU on the card: x / (1 + exp(-x)), IEEE division
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.f, expf(-x)));
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

// The float32 body, on the CUDA cores. grid (H, B), block 256. x (B, L,
// H, P); dt (B, L, H); a, d_skip (H,); b, c (B, L, G, N); h0 (B, H, P, N)
// or null; y (B, L, H, P); h_final (B, H, P, N).
template <typename T>
__device__ __forceinline__ void
ssd_cuda_core(const T* __restrict__ x, const float* __restrict__ dt,
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


// ---- PTX: ldmatrix, wgmma, TMA, cp.async, named barriers -------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices, transposed; lanes 8 m .. 8 m + 7 give the row
// addresses of matrix m, register m receives its transpose (row lane / 4,
// columns 2 (lane % 4) and + 1).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// 4 bytes, or (src_bytes 0) a zero, into shared memory.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Arrive once and expect `bytes` more from TMA before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed. A phase that
// never completes (a lost copy) traps after ~2^26 polls, seconds, so the
// launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units), layout 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

#define LAIMR_D32                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])
#define LAIMR_D32_REGS                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
  "%28, %29, %30, %31}, "

// D (64 x 64, float32) {+}= A (64 x 16, bf16, shared memory) B (16 x 64,
// bf16, shared memory); both operands K-major.
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LAIMR_D32_REGS
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : LAIMR_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, float32) += A (64 x 16, bf16, registers) B (16 x 64, bf16,
// shared memory), B K-major (kTrans 0) or MN-major (kTrans 1).
template <int kTrans>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LAIMR_D32_REGS
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : LAIMR_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(kTrans));
}

// 2^x by the SFU (ex2.approx.ftz: 2^-22 relative; 2^0 = 1 exactly).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Barrier 1 between the two warpgroups: the state warpgroup arrives when
// y_off is in shared memory, the y warpgroup waits there before reading
// it.
__device__ __forceinline__ void bar_arrive_h() {
  asm volatile("bar.arrive 1, %0;\n" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_sync_h() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// Barrier 2: the y warpgroup alone (its y tile is complete).
__device__ __forceinline__ void bar_sync_y() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kThreads / 2) : "memory");
}
// ------------------------------------------------------------------------

// hi: v truncated to bf16; lo: v - hi (exact in float32) rounded to bf16.
// Two values a register, the first in the low half, as an mma fragment.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t* hi,
                                       uint32_t* lo) {
  const uint32_t b0 = __float_as_uint(v0);
  const uint32_t b1 = __float_as_uint(v1);
  *hi = __byte_perm(b0, b1, 0x7632);
  const __nv_bfloat162 l2 =
      __floats2bfloat162_rn(v0 - __uint_as_float(b0 & 0xffff0000u),
                            v1 - __uint_as_float(b1 & 0xffff0000u));
  *lo = *reinterpret_cast<const uint32_t*>(&l2);
}

// The two bf16 values of a fragment register, as float32.
__device__ __forceinline__ float low_bf16(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float high_bf16(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* d_skip;
  const float* h0;
  void* y;
  float* h_final;
  int L, H, P, G, N;
  int tma;    // 1: b and c tiles arrive as TMA boxes (maps below)
  int tma_x;  // 1: so does x
  // a state wider than the tiles, scanned a slice of N per launch (the
  // bf16 body): 1 writes y's float32 partial sum (before its rounding)
  // to y_part as well, 2 adds y_part's to y before the rounding; 0 neither
  float* y_part;
  int part;
};

// The bf16 body's TMA maps over b, c and x: boxes of 64 rows x 64 columns.
struct BCMaps {
  CUtensorMap b, c, x;
};

constexpr int kBox = kQ * 128;  // a 64-row x 64-column bf16 box: 8 KB

// Byte offset of (row r, column col, a multiple of 8) in a b, c or x tile:
// boxes of 64 columns, rows of 128 bytes, the 16-byte pieces of row r
// permuted by r % 8 (TMA's 128-byte swizzle, so the eight rows an
// ldmatrix reads fall on distinct banks).
__device__ __forceinline__ int bc_off(int r, int col) {
  return (col >> 6) * kBox + r * 128 + ((((col >> 3) & 7) ^ (r & 7)) << 4);
}

// wgmma descriptors of tiles laid out by bc_off (rows 128 bytes apart,
// 8-row groups 1024, 128-byte swizzle): K-major, the 16-column k-step kk
// starts 32 bytes further along the row of box kk / 4; MN-major, the
// 16-row k-step kk of the columns of box `box`.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return smem_desc(tile + (kk >> 2) * kBox + (kk & 3) * 32, 16, 1024);
}

__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int box,
                                                 int kk) {
  return smem_desc(tile + box * kBox + kk * 16 * 128, kBox, 1024);
}

// Byte offsets of the bf16 body's shared memory from a 1024-aligned base.
struct MmaSmem {
  static constexpr int ld_y = kPMax + 8;  // bf16 stride of y rows
  static constexpr int ld_o = kPMax + 4;  // float stride of y_off rows
  // two stages of: b and c (two boxes each), x (one box), all bf16 and
  // laid out by bc_off
  static constexpr int b = 0;
  static constexpr int c = 2 * kBox;
  static constexpr int x = 4 * kBox;
  static constexpr int stage = 5 * kBox;
  // y_off = exp(seg_i) C H_prev^T, float32
  static constexpr int yoff = 2 * stage;
  static constexpr int y = yoff + kQ * ld_o * 4;  // y, rows of ld_y
  static constexpr int dt = y + kQ * ld_y * 2;  // two stages
  static constexpr int scan = dt + 2 * kQ * 4;  // per warp: seg, dt, w
  static constexpr int bars = scan + (kThreads / 32) * 3 * kQ * 4;
  static constexpr int bytes = bars + 2 * 8;  // an mbarrier per stage
  static_assert(stage % 1024 == 0, "boxes stay 1024-aligned");
};

// Stage rows [c0, c0 + valid) x columns [0, cols) of a bf16 slice into a
// kQ-row tile of `width` columns (a multiple of 8) laid out by bc_off,
// zero elsewhere; global row r at src + r * row_stride. Aligned 16-byte
// pieces go by cp.async, the rest (a ragged edge, a misaligned row) by
// plain loads and stores.
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int64_t row_stride, int c0,
                                           int valid, int cols, int width) {
  const int pieces = width / 8;
  for (int idx = threadIdx.x; idx < kQ * pieces; idx += kThreads) {
    const int r = idx / pieces;
    const int col = (idx - r * pieces) * 8;
    __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(
        reinterpret_cast<unsigned char*>(dst) + bc_off(r, col));
    const __nv_bfloat16* s =
        src + static_cast<int64_t>(c0 + r) * row_stride + col;
    if (r < valid && col + 8 <= cols &&
        (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      cp_async16(d, s);
    } else {
      uint32_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (r < valid)
        for (int e = 0; e < 8 && col + e < cols; ++e)
          v[e] = reinterpret_cast<const uint16_t*>(s)[e];
      *reinterpret_cast<uint4*>(d) =
          make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16,
                     v[4] | v[5] << 16, v[6] | v[7] << 16);
    }
  }
}

// The bf16 body, on the tensor cores. grid (H, B), block 256. Warps 0-3
// (the y warpgroup) own chunk rows 16 w .. 16 w + 15: C B^T, M and M x,
// then y. Warps 4-7 (the state warpgroup) own H, float32 in their
// accumulators: state rows 16 sp + {gq, gq + 8} and all 16 of N's 8-wide
// column tiles; per chunk they first hand y_off = exp(seg_i) C H_prev^T
// to the y warpgroup through shared memory (H_prev as A fragments
// straight from the accumulators), then update H.
// kPart: a.part may be set (a slice of a wider state's N); the body
// without it is compiled apart, so the launches of a state the tiles hold
// run the code they ran before slices existed.
template <bool kPart>
__device__ __forceinline__ void ssd_mma(const SsdArgs& a, const BCMaps& maps) {
  using S = MmaSmem;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char mma_raw[];
  const uint32_t raw = smem_addr(mma_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the boxes' alignment
  unsigned char* mma_smem = mma_raw + (base - raw);
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;  // fragment row
  const int tq = lane % 4;  // fragment column pair
  const int np = (a.N + 15) / 16 * 16;  // N padded to the mma depth
  const float a_h = a.a[h];
  const float d_h = a.d_skip[h];
  const int64_t x_row = static_cast<int64_t>(a.H) * a.P;
  const int64_t bc_row = static_cast<int64_t>(a.G) * a.N;
  const int64_t xy_off = (static_cast<int64_t>(bi) * a.L * a.H + h) * a.P;
  const bf16* x_b = static_cast<const bf16*>(a.x) + xy_off;
  bf16* y_b = static_cast<bf16*>(a.y) + xy_off;
  const float* dt_b = a.dt + static_cast<int64_t>(bi) * a.L * a.H + h;
  const int64_t bc_start = (static_cast<int64_t>(bi) * a.L * a.G + g) * a.N;
  const bf16* b_b = static_cast<const bf16*>(a.b) + bc_start;
  const bf16* c_b = static_cast<const bf16*>(a.c) + bc_start;
  const int64_t state = (static_cast<int64_t>(bi) * a.H + h) * a.P * a.N;
  const int n_chunks = (a.L + kQ - 1) / kQ;
  const uint32_t bar0 = base + S::bars;  // stage s completes on bar0 + 8 s
  float* yoff = reinterpret_cast<float*>(mma_smem + S::yoff);
  float* scan = reinterpret_cast<float*>(mma_smem + S::scan) + warp * 3 * kQ;

  // Chunk k into stage k % 2: with a.tma one thread asks TMA for the boxes
  // of b and c, and of x with a.tma_x (rows past L and columns past N or P
  // arrive as zeros), completing on the stage's mbarrier, so no warp waits
  // on the copy; else every thread stages 16-byte pieces. dt, and x
  // without a.tma_x, go by cp.async, one group.
  auto stage_chunk = [&](int k) {
    unsigned char* st = mma_smem + (k % 2) * S::stage;
    const int c0 = k * kQ;
    const int valid = min(kQ, a.L - c0);
    if (a.tma) {
      if (tid == 0) {
        const uint32_t bar = bar0 + 8 * (k % 2);
        const int boxes = np > 64 ? 2 : 1;
        const uint32_t dst = base + (k % 2) * S::stage;
        mbar_expect_tx(bar, (2 * boxes + a.tma_x) * kBox);
        if (a.tma_x) tma_load_4d(dst + S::x, &maps.x, bar, 0, h, c0, bi);
        for (int bx = 0; bx < boxes; ++bx) {
          tma_load_4d(dst + S::b + bx * kBox, &maps.b, bar, 64 * bx, g, c0,
                      bi);
          tma_load_4d(dst + S::c + bx * kBox, &maps.c, bar, 64 * bx, g, c0,
                      bi);
        }
      }
    } else {
      stage_bf16(reinterpret_cast<bf16*>(st + S::b), b_b, bc_row, c0, valid,
                 a.N, np);
      stage_bf16(reinterpret_cast<bf16*>(st + S::c), c_b, bc_row, c0, valid,
                 a.N, np);
    }
    if (!a.tma_x)
      stage_bf16(reinterpret_cast<bf16*>(st + S::x), x_b, x_row, c0, valid,
                 a.P, kPMax);
    if (tid < kQ) {
      float* dts = reinterpret_cast<float*>(mma_smem + S::dt) + (k % 2) * kQ;
      const bool in = tid < valid;
      cp_async4(dts + tid, in ? dt_b + static_cast<int64_t>(c0 + tid) * a.H
                              : dt_b,
                in ? 4 : 0);
    }
    cp_async_commit();
  };
  if (a.tma && tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    mbar_fence_init();
  }
  __syncthreads();  // the mbarriers are initialised before anyone waits
  stage_chunk(0);

  const bool y_warp = warp < 4;
  const int sp = warp & 3;  // a state warp's 16-row tile of H
  float hacc[16][4];        // the state warps' share of H, float32
  if (!y_warp) {
    // the state: h0, or zeros; rows >= P and columns >= N stay zero
#pragma unroll
    for (int t = 0; t < 16; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 16 * sp + gq + 8 * (e / 2);
        const int n = 8 * t + 2 * tq + (e & 1);
        hacc[t][e] = a.h0 != nullptr && p < a.P && n < a.N
                         ? a.h0[state + static_cast<int64_t>(p) * a.N + n]
                         : 0.f;
      }
  }

  for (int k = 0; k < n_chunks; ++k) {
    const int c0 = k * kQ;
    const int valid = min(kQ, a.L - c0);
    cp_async_wait_all();
    if (a.tma) mbar_wait(bar0 + 8 * (k % 2), (k / 2) & 1);
    // what threads staged is visible to wgmma's proxy too
    if (!(a.tma && a.tma_x)) fence_proxy_async();
    // chunk k has landed, nobody reads the other stage or y_off any more
    __syncthreads();
    if (k + 1 < n_chunks) stage_chunk(k + 1);
    const uint32_t st = base + (k % 2) * S::stage;
    const unsigned char* x_t = mma_smem + (k % 2) * S::stage + S::x;

    // every warp scans dt * a into its own seg, kept in log2 units (no
    // block barrier for it)
    {
      const float* dts =
          reinterpret_cast<const float*>(mma_smem + S::dt) + (k % 2) * kQ;
      const int r0 = 2 * lane, r1 = 2 * lane + 1;
      const float dt0 = dts[r0], dt1 = dts[r1];
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
      const float s1 = s0 + v1;
      const float l0 = s0 * kLog2e, l1 = s1 * kLog2e;
      const float last =
          __shfl_sync(kFull, (valid - 1) & 1 ? l1 : l0, (valid - 1) / 2);
      scan[r0] = l0;
      scan[r1] = l1;
      scan[kQ + r0] = dt0;
      scan[kQ + r1] = dt1;
      // the state weights exp(seg_last - seg_j) dt_j
      scan[2 * kQ + r0] = exp2_ftz(last - l0) * dt0;
      scan[2 * kQ + r1] = exp2_ftz(last - l1) * dt1;
      __syncwarp();
    }

    if (y_warp) {
      // ---- S = C B^T over N: one wgmma m64n64k16 per 16 columns of N, C
      //      and B K-major ---------------------------------------------
      const int i0 = 16 * warp;
      float sacc[8][4], o[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[t][e] = o[t][e] = 0.f;
      fence_regs<32>(&sacc[0][0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kNMax / 16; ++kk) {
        if (16 * kk >= np) break;
        wgmma_ss(&sacc[0][0], kmajor_desc(st + S::c, kk),
                 kmajor_desc(st + S::b, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(&sacc[0][0]);

      // ---- M = S[i][j] exp(seg_i - seg_j) dt_j for i >= j, on the
      //      accumulators, then split into hi + lo A fragments -----------
      const float seg_r[2] = {scan[i0 + gq], scan[i0 + gq + 8]};
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int j0 = 8 * t + 2 * tq;
        const float2 seg_j = *reinterpret_cast<const float2*>(scan + j0);
        const float2 dt_j = *reinterpret_cast<const float2*>(scan + kQ + j0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + gq + 8 * (e / 2);
          const int j = j0 + (e & 1);
          sacc[t][e] =
              j <= i ? sacc[t][e] *
                           exp2_ftz(seg_r[e / 2] - (e & 1 ? seg_j.y : seg_j.x)) *
                           (e & 1 ? dt_j.y : dt_j.x)
                     : 0.f;
        }
      }
      uint32_t mhi[4][4], mlo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        split2(sacc[2 * kk][0], sacc[2 * kk][1], &mhi[kk][0], &mlo[kk][0]);
        split2(sacc[2 * kk][2], sacc[2 * kk][3], &mhi[kk][1], &mlo[kk][1]);
        split2(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1], &mhi[kk][2],
               &mlo[kk][2]);
        split2(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3], &mhi[kk][3],
               &mlo[kk][3]);
      }

      // ---- M x: M from registers, x MN-major in its box ---------------
      fence_regs<32>(&o[0][0]);
      fence_regs<16>(&mhi[0][0]);
      fence_regs<16>(&mlo[0][0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<1>(&o[0][0], mhi[kk], mnmajor_desc(st + S::x, 0, kk));
        wgmma_rs<1>(&o[0][0], mlo[kk], mnmajor_desc(st + S::x, 0, kk));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(&o[0][0]);

      // ---- y = M x + y_off + d_skip x into shared memory, then rows <
      //      valid, columns < P out in 16-byte pieces --------------------
      bar_sync_h();  // the state warpgroup has written y_off
      bf16* y_s = reinterpret_cast<bf16*>(mma_smem + S::y);
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = i0 + gq + 8 * r;
          const int p = 8 * t + 2 * tq;
          const float2 yo =
              *reinterpret_cast<const float2*>(yoff + i * S::ld_o + p);
          const float2 xv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  x_t + bc_off(i, p & ~7) + 2 * (p & 7)));
          float v0 = o[t][2 * r] + yo.x + xv.x * d_h;
          float v1 = o[t][2 * r + 1] + yo.y + xv.y * d_h;
          if (kPart && i < valid && p < a.P) {
            float* yp = a.y_part + xy_off
                        + static_cast<int64_t>(c0 + i) * x_row + p;
            const bool two = p + 1 < a.P;
            if (a.part == 1) {
              yp[0] = v0;
              if (two) yp[1] = v1;
            } else {
              v0 += yp[0];
              if (two) v1 += yp[1];
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(y_s + i * S::ld_y + p) =
              __floats2bfloat162_rn(v0, v1);
        }
      bar_sync_y();
      for (int idx = tid; idx < kQ * kPMax / 8; idx += kThreads / 2) {
        const int i = idx / (kPMax / 8);
        const int p = (idx - i * (kPMax / 8)) * 8;
        if (i >= valid || p >= a.P) continue;
        const bf16* src = y_s + i * S::ld_y + p;
        bf16* out = y_b + static_cast<int64_t>(c0 + i) * x_row + p;
        if (p + 8 <= a.P && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
          *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && p + e < a.P; ++e) out[e] = src[e];
        }
      }
    } else {
      // ---- y_off^T = H_prev C^T, scaled by exp(seg_i): H_prev (this
      //      warpgroup's 64 rows) as A from registers, C K-major in its
      //      boxes -------------------------------------------------------
      {
        float yo[8][4];
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) yo[t][e] = 0.f;
        // the accumulator layout of two column tiles is the A fragment of
        // one 16-deep step
        uint32_t ahi[8][4], alo[8][4];
#pragma unroll
        for (int s2 = 0; s2 < 8; ++s2) {
          split2(hacc[2 * s2][0], hacc[2 * s2][1], &ahi[s2][0], &alo[s2][0]);
          split2(hacc[2 * s2][2], hacc[2 * s2][3], &ahi[s2][1], &alo[s2][1]);
          split2(hacc[2 * s2 + 1][0], hacc[2 * s2 + 1][1], &ahi[s2][2],
                 &alo[s2][2]);
          split2(hacc[2 * s2 + 1][2], hacc[2 * s2 + 1][3], &ahi[s2][3],
                 &alo[s2][3]);
        }
        fence_regs<32>(&yo[0][0]);
        fence_regs<32>(&ahi[0][0]);
        fence_regs<32>(&alo[0][0]);
        wgmma_fence();
#pragma unroll
        for (int s2 = 0; s2 < 8; ++s2) {
          if (16 * s2 >= np) break;
          wgmma_rs<0>(&yo[0][0], ahi[s2], kmajor_desc(st + S::c, s2));
          wgmma_rs<0>(&yo[0][0], alo[s2], kmajor_desc(st + S::c, s2));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<32>(&yo[0][0]);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int i = 8 * t + 2 * tq;
          const float2 seg_i = *reinterpret_cast<const float2*>(scan + i);
          const float e0 = exp2_ftz(seg_i.x), e1 = exp2_ftz(seg_i.y);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int p = 16 * sp + gq + 8 * r;
            yoff[i * S::ld_o + p] = yo[t][2 * r] * e0;
            yoff[(i + 1) * S::ld_o + p] = yo[t][2 * r + 1] * e1;
          }
        }
      }
      bar_arrive_h();  // y_off is written

      // ---- H = exp(seg_last) H + sum_j (x_j w_j) b_j^T ------------------
      const float decay = exp2_ftz(scan[valid - 1]);
#pragma unroll
      for (int t = 0; t < 16; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[t][e] *= decay;
      // x^T as A fragments (state rows x chunk rows), weighted, split
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk >= valid) break;  // rows past L are zero
        uint32_t af[4];
        ldsm_x4_trans(af, st + S::x + bc_off(16 * kk + lane % 8 +
                                                 8 * (lane / 16),
                                             16 * sp + 8 * ((lane / 8) % 2)));
        const float* w = scan + 2 * kQ + 16 * kk + 2 * tq;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split2(low_bf16(af[q]) * w[8 * (q / 2)],
                 high_bf16(af[q]) * w[8 * (q / 2) + 1], &ahi[kk][q],
                 &alo[kk][q]);
      }
      // B MN-major in its boxes, H in the accumulators
      fence_regs<64>(&hacc[0][0]);
      fence_regs<16>(&ahi[0][0]);
      fence_regs<16>(&alo[0][0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk >= valid) break;
#pragma unroll
        for (int box = 0; box < 2; ++box) {
          if (64 * box >= np) break;
          wgmma_rs<1>(&hacc[8 * box][0], ahi[kk],
                      mnmajor_desc(st + S::b, box, kk));
          wgmma_rs<1>(&hacc[8 * box][0], alo[kk],
                      mnmajor_desc(st + S::b, box, kk));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<64>(&hacc[0][0]);
    }
  }

  if (!y_warp) {
#pragma unroll
    for (int t = 0; t < 16; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 16 * sp + gq + 8 * (e / 2);
        const int n = 8 * t + 2 * tq + (e & 1);
        if (p < a.P && n < a.N)
          a.h_final[state + static_cast<int64_t>(p) * a.N + n] = hacc[t][e];
      }
  }
}

// One __global__: the input dtype picks the body, kPart the bf16 body's
// slice mode.
template <typename T, bool kPart = false>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const SsdArgs a, const __grid_constant__ BCMaps maps) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    ssd_mma<kPart>(a, maps);
  } else {
    ssd_cuda_core<T>(static_cast<const T*>(a.x), a.dt, a.a,
                     static_cast<const T*>(a.b), static_cast<const T*>(a.c),
                     a.d_skip, a.h0, static_cast<T*>(a.y), a.h_final, a.L,
                     a.H, a.P, a.G, a.N);
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time (the library
// links the runtime only).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a contiguous bf16 (B, L, heads, cols) tensor (b and c:
// heads G, cols N; x: H, P), dims innermost first, with boxes of 64
// columns (128-byte swizzle) x 64 rows of one head. Columns past `cols`
// and rows past L read as 0.
cudaError_t box_map(CUtensorMap* map, const void* ptr, int B, int L,
                    int heads, int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(cols) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * L};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(kQ), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, bool kPart = false>
int launch_ssd(SsdArgs a, int B, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  // + 1024: the bf16 body aligns its base for the swizzled boxes
  const size_t smem =
      kBf16 ? static_cast<size_t>(MmaSmem::bytes) + 1024 : kSmemBytes;
  BCMaps maps{};
  if (kBf16) {
    // TMA needs 16-byte aligned rows; other shapes stage by threads
    const auto aligned = [](const void* p) {
      return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
    };
    a.tma = a.N % 8 == 0 && aligned(a.b) && aligned(a.c);
    a.tma_x = a.tma && a.P % 8 == 0 && aligned(a.x);
    cudaError_t e = cudaSuccess;
    if (a.tma) e = box_map(&maps.b, a.b, B, a.L, a.G, a.N);
    if (a.tma && e == cudaSuccess) e = box_map(&maps.c, a.c, B, a.L, a.G, a.N);
    if (a.tma_x && e == cudaSuccess)
      e = box_map(&maps.x, a.x, B, a.L, a.H, a.P);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // more than 48 KB of dynamic shared memory needs an opt-in, once
  static bool reserved = false;
  if (!reserved) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T, kPart>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    reserved = true;
  }
  const dim3 grid(a.H, B);
  ssd_scan_kernel<T, kPart><<<grid, kThreads, smem, stream>>>(a, maps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The decode mixer of a Mamba-2 layer, three launches a layer inside the
// replayed step. The plain versions are kernels/ref.py: ssd_conv_step_ref,
// ssd_state_step_ref (over ssd_step_ref) and ssd_gated_norm_ref; they
// replace no TPU kernel (the reference's decode step is plain jnp) but the
// ~33 eager passes a layer of that step. T is the model dtype (float32 or
// bfloat16) of the in_proj output, the conv buffer and taps and the norm's
// output; the conv output, dt, the state and y are float32.

// ---------------------------------------------------------------------------
// ssd_conv_step_kernel: the depthwise causal conv's one-token step and dt.
// One thread per (row, conv channel): the channel's W - 1 buffered inputs
// and its new input (the in_proj output's x | B | C, read in place),
//
//   acc = e_0 w_0 + e_1 w_1 + ... + e_{W-1} w_{W-1}   (float32, tap order)
//   out = silu(acc + bias)                              (float32)
//
// each product and sum rounded on its own, then the channel's buffer
// shifted by one in place (a channel's buffer is its own thread's: no
// race). Past the channels, one thread per (row, head):
// dt = softplus(dt_raw + dt_bias) in float32 (PyTorch's: x above 20 is
// kept, else log1p(exp(x))). What bounds it: bytes, ~10 per channel
// (2.6 MB at B 64 x 2,304 channels: ~1 us at 3.35 TB/s), far under a
// launch.
constexpr int kConvThreads = 256;
constexpr int kConvMaxW = 8;

// u (B, C) at row stride u_sb; dt_raw (B, H) at row stride dt_sb; buf
// (B, W - 1, C), w (W, C), bias (C,) contiguous; dt_bias (H,); out (B, C)
// and dt (B, H) contiguous float32. grid (ceil((C + H) / 256), B).
template <typename T>
__global__ void __launch_bounds__(kConvThreads)
ssd_conv_step_kernel(const T* __restrict__ u, const T* __restrict__ dt_raw,
                     T* __restrict__ buf, const T* __restrict__ w,
                     const T* __restrict__ bias,
                     const float* __restrict__ dt_bias,
                     float* __restrict__ out, float* __restrict__ dt,
                     int u_sb, int dt_sb, int C, int H, int W) {
  const int row = blockIdx.y;
  const int i = blockIdx.x * kConvThreads + threadIdx.x;
  if (i < C) {
    T* br = buf + static_cast<int64_t>(row) * (W - 1) * C + i;
    const T un = u[static_cast<int64_t>(row) * u_sb + i];
    T e[kConvMaxW];
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kConvMaxW; ++k) {
      if (k < W) {
        e[k] = k < W - 1 ? br[static_cast<int64_t>(k) * C] : un;
        const float p = __fmul_rn(to_float(e[k]),
                                  to_float(w[static_cast<int64_t>(k) * C + i]));
        acc = k == 0 ? p : __fadd_rn(acc, p);
      }
    }
#pragma unroll
    for (int k = 0; k + 1 < kConvMaxW; ++k)
      if (k + 1 < W) br[static_cast<int64_t>(k) * C] = e[k + 1];
    out[static_cast<int64_t>(row) * C + i] =
        silu(__fadd_rn(acc, to_float(bias[i])));
  } else if (i < C + H) {
    const int hd = i - C;
    const float v = __fadd_rn(
        to_float(dt_raw[static_cast<int64_t>(row) * dt_sb + hd]), dt_bias[hd]);
    dt[static_cast<int64_t>(row) * H + hd] = v > 20.f ? v : log1pf(expf(v));
  }
}

// ---------------------------------------------------------------------------
// ssd_step_kernel: one decode token's SSM recurrence, the plain version
// kernels/ref.py: ssd_step_ref (ssd_state_step_ref when B and C come by
// group and a from a_log). Per (batch row, head), with the (P x N) state
// h in float32, updated in place:
//
//   decay = exp(dt * a)                          (a = -exp(a_log) inline)
//   h     = h * decay + (dt * x) b^T
//   y     = h c + d_skip * x                     (P values, float32)
//
// What bounds it: bytes. The state is read once and written once (8
// bytes a state element against 5 FLOP: ~0.6 FLOP a byte); x, b, c, y
// are ~1% beside it. At mamba2_370m's served step (B 64, H 32, P 64,
// N 128) a layer's state is 67 MB, more than the 50 MB L2, so nothing of
// it is found there by the next layer or the next step.
//
// Design: one block of 256 threads per (row, head) and slice of at most
// kStepPBlock = 64 state rows, B x H x ceil(P / 64) blocks (one slice up
// to P 64; Falcon-H1's P 128 takes two). Warp w owns rows [w R, (w + 1)
// R) of its slice, R = ceil(rows / 8) <= 8; lane l owns the float4
// columns l, l + 32, ..., kC4 of them (kC4 = 1 up to N 128, 2 up to N
// 256; lanes past N / 4 idle), with its b and c values in registers.
// Every lane issues its R x kC4 16-byte state loads before it computes,
// so each SM keeps tens of KB in flight, and they stream (__ldcs /
// __stcs, evict-first). The update keeps the plain version's rounding
// (h * decay, dt * x, (dt x) * b, their sum, each rounded: no
// contraction; expf as PyTorch's exp), so the new h equals the plain
// version's bit for bit. y sums over N per lane (fmaf, float4 by float4)
// and then over the lanes by 5 xor shuffles: only its order differs. At
// P <= 64 and N <= 128 (kC4 1, one slice) this is the single-slice body
// that Mamba2-370m and Nemotron-H have run since it was written.
constexpr int kStepThreads = 256;
constexpr int kStepWarps = kStepThreads / 32;
constexpr int kStepPBlock = 64;                       // rows a block holds
constexpr int kStepRows = kStepPBlock / kStepWarps;   // rows a warp holds
constexpr int kStepPMax = 2 * kStepPBlock;            // P the launcher takes
constexpr int kStepNMax = 256;                        // N the launcher takes

// h (B, H, P, N); dt (B, H); a, d_skip (H,), a holding a_log when a_log
// is set; x (B, H, P) at element strides (x_sb, x_sh, x_sp), any layout
// (the decode step's is a view of its conv output); head hd of row r
// reads b and c at r * bc_sb + (hd / rep) * N (its group's N values);
// y (B, H, P). N % 4 == 0, N <= 128 kC4, bc_sb % 4 == 0; block
// (bh * n_pb + slice), n_pb = ceil(P / kStepPBlock).
template <int kC4>
__global__ void __launch_bounds__(kStepThreads)
ssd_step_kernel(float* __restrict__ h, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ x,
                const float* __restrict__ b, const float* __restrict__ c,
                const float* __restrict__ d_skip, float* __restrict__ y,
                int x_sb, int x_sh, int x_sp, int bc_sb, int rep, int a_log,
                int H, int P, int N) {
  const int n_pb = (P + kStepPBlock - 1) / kStepPBlock;
  const int bh = blockIdx.x / n_pb;       // batch row * H + head
  const int pb = (blockIdx.x - bh * n_pb) * kStepPBlock;
  const int row = bh / H;
  const int head = bh % H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p_end = min(P, pb + kStepPBlock);
  const int rows = (p_end - pb + kStepWarps - 1) / kStepWarps;
  const int p0 = pb + warp * rows;
  const int n4 = N >> 2;
  const float dtv = dt[bh];
  const float a_h = a_log ? -expf(a[head]) : a[head];
  const float decay = expf(__fmul_rn(dtv, a_h));
  const float* xr = x + static_cast<int64_t>(row) * x_sb
                    + static_cast<int64_t>(head) * x_sh;
  float4* hr =
      reinterpret_cast<float4*>(h) + static_cast<int64_t>(bh) * P * n4;
  const int64_t bc = static_cast<int64_t>(row) * (bc_sb >> 2)
                     + static_cast<int64_t>(head / rep) * n4 + lane;
  bool on[kC4];
  float4 bv[kC4], cv[kC4];
#pragma unroll
  for (int k = 0; k < kC4; ++k) {
    on[k] = lane + 32 * k < n4;
    bv[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    cv[k] = bv[k];
    if (on[k]) {
      bv[k] = __ldg(reinterpret_cast<const float4*>(b) + bc + 32 * k);
      cv[k] = __ldg(reinterpret_cast<const float4*>(c) + bc + 32 * k);
    }
  }
  float4 hv[kStepRows][kC4];
  float xv[kStepRows];
#pragma unroll
  for (int j = 0; j < kStepRows; ++j) {
    const int p = p0 + j;
    xv[j] = 0.f;
#pragma unroll
    for (int k = 0; k < kC4; ++k) hv[j][k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < rows && p < p_end) {
      xv[j] = __ldg(xr + static_cast<int64_t>(p) * x_sp);
#pragma unroll
      for (int k = 0; k < kC4; ++k)
        if (on[k]) hv[j][k] = __ldcs(hr + p * n4 + lane + 32 * k);
    }
  }
  float s[kStepRows];
#pragma unroll
  for (int j = 0; j < kStepRows; ++j) {
    const int p = p0 + j;
    s[j] = 0.f;
    if (j < rows && p < p_end) {
      const float dx = __fmul_rn(dtv, xv[j]);
#pragma unroll
      for (int k = 0; k < kC4; ++k) {
        if (!on[k]) continue;
        float4 v = hv[j][k];
        v.x = __fadd_rn(__fmul_rn(v.x, decay), __fmul_rn(dx, bv[k].x));
        v.y = __fadd_rn(__fmul_rn(v.y, decay), __fmul_rn(dx, bv[k].y));
        v.z = __fadd_rn(__fmul_rn(v.z, decay), __fmul_rn(dx, bv[k].z));
        v.w = __fadd_rn(__fmul_rn(v.w, decay), __fmul_rn(dx, bv[k].w));
        __stcs(hr + p * n4 + lane + 32 * k, v);
        s[j] = dot4(v, cv[k], s[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kStepRows; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s[j] = __fadd_rn(s[j], __shfl_xor_sync(kFull, s[j], off));
  }
  const float d = d_skip[head];
#pragma unroll
  for (int j = 0; j < kStepRows; ++j) {
    const int p = p0 + j;
    if (lane == j && j < rows && p < p_end)
      y[static_cast<int64_t>(bh) * P + p] =
          __fadd_rn(s[j], __fmul_rn(xv[j], d));
  }
}

// ---------------------------------------------------------------------------
// ssd_gated_norm_kernel: the gated RMSNorm between the state step and
// out_proj, in the dtype steps of models/ssm.py: _gate_out, with y first
// cast to T as the decode step casts it. One block per (norm group, row)
// over the group's D / groups columns; z is the in_proj output's, read in
// place. Two passes over the columns (the second recomputes the value; the
// row stays in L1): the sum of squares, reduced over the block, then
//
//   gate_first 0:  out = T( T(y r (1 + scale)) * T(silu(z)) )   groups 1
//   gate_first 1:  out = T( y silu(z) r (1 + scale) )
//
// with r = rsqrt(mean(v^2) + eps) over the group's values v (T(y), or
// T(y) silu(z)). Each product and sum rounded on its own; only the order
// of the sum of squares differs from the plain version's. What bounds it:
// a launch (B 64 x 2,048 columns read 0.8 MB).
constexpr int kNormThreads = 256;

// y (B, D) float32 contiguous; z (B, D) at row stride z_sb; scale (D,)
// float32; out (B, D) contiguous. grid (groups, B), Dg = D / groups.
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
ssd_gated_norm_kernel(const float* __restrict__ y, const T* __restrict__ z,
                      const float* __restrict__ scale, T* __restrict__ out,
                      int z_sb, int D, int Dg, int gate_first, float eps) {
  __shared__ float part[kNormThreads / 32];
  const int row = blockIdx.y;
  const int c0 = blockIdx.x * Dg;
  const float* yr = y + static_cast<int64_t>(row) * D + c0;
  const T* zr = z + static_cast<int64_t>(row) * z_sb + c0;
  T* outr = out + static_cast<int64_t>(row) * D + c0;
  float ss = 0.f;
  for (int i = threadIdx.x; i < Dg; i += kNormThreads) {
    float v = round_to<T>(yr[i]);
    if (gate_first) v = __fmul_rn(v, silu(to_float(zr[i])));
    ss = __fadd_rn(ss, __fmul_rn(v, v));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(kFull, ss, off));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  ss = part[0];
#pragma unroll
  for (int k = 1; k < kNormThreads / 32; ++k) ss = __fadd_rn(ss, part[k]);
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(Dg)),
                                   eps));
  for (int i = threadIdx.x; i < Dg; i += kNormThreads) {
    const float zf = to_float(zr[i]);
    float v = round_to<T>(yr[i]);
    if (gate_first) v = __fmul_rn(v, silu(zf));
    v = __fmul_rn(__fmul_rn(v, r), __fadd_rn(1.f, scale[c0 + i]));
    if (!gate_first) v = __fmul_rn(round_to<T>(v), round_to<T>(silu(zf)));
    store(outr + i, v);
  }
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
  const SsdArgs args{x, dt, a, b, c, d_skip, h0, y, h_final, L, H, P, G, N,
                     0, 0, nullptr, 0};
  if (dtype == 0) return launch_ssd<float>(args, B, st);
  if (dtype == 1) return launch_ssd<__nv_bfloat16>(args, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 scan of one slice of a wider state's N, with y's float32
// partial sum in y_part (B, L, H, P): part 1 writes it (beside y), part 2
// adds it to y before y's rounding, so a state scanned in two slices
// rounds y once.
int laimr_ssd_scan_part(const void* x, const float* dt, const float* a,
                        const void* b, const void* c, const float* d_skip,
                        const float* h0, void* y, float* h_final,
                        float* y_part, int part, int B, int L, int H, int P,
                        int G, int N, void* stream) {
  if (B < 0 || B > 65535 || L < 1 || H < 1 || G < 1 || H % G != 0 ||
      P < 1 || P > kPMax || N < 1 || N > kNMax || part < 1 || part > 2 ||
      y_part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const SsdArgs args{x, dt, a, b, c, d_skip, h0, y, h_final, L, H, P, G, N,
                     0, 0, y_part, part};
  return launch_ssd<__nv_bfloat16, true>(args, B,
                                         static_cast<cudaStream_t>(stream));
}

// One decode token's state update (ssd_step_kernel): h (B, H, P, N)
// float32 in place, y (B, H, P) float32; x at element strides (x_sb,
// x_sh, x_sp); head hd of row r reads b and c at r * bc_sb + (hd / rep) *
// N; a holds a_log when a_log is set. The wrapper checks shapes, the
// contiguity and 16-byte alignment of h, b and c.
int laimr_ssd_step(float* h, const float* dt, const float* a, const float* x,
                   const float* b, const float* c, const float* d_skip,
                   float* y, int x_sb, int x_sh, int x_sp, int bc_sb, int rep,
                   int a_log, int B, int H, int P, int N, void* stream) {
  const int n_pb = (P + kStepPBlock - 1) / kStepPBlock;
  if (B < 0 || H < 1 || P < 1 || P > kStepPMax || N < 4 || N > kStepNMax ||
      N % 4 != 0 || x_sb < 0 || x_sh < 0 || x_sp < 0 || bc_sb < 0 ||
      bc_sb % 4 != 0 || rep < 1 || H % rep != 0 ||
      static_cast<int64_t>(B) * H * n_pb > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 128)
    ssd_step_kernel<1><<<B * H * n_pb, kStepThreads, 0, st>>>(
        h, dt, a, x, b, c, d_skip, y, x_sb, x_sh, x_sp, bc_sb, rep, a_log, H,
        P, N);
  else
    ssd_step_kernel<2><<<B * H * n_pb, kStepThreads, 0, st>>>(
        h, dt, a, x, b, c, d_skip, y, x_sb, x_sh, x_sp, bc_sb, rep, a_log, H,
        P, N);
  return static_cast<int>(cudaGetLastError());
}

// The conv step and dt (ssd_conv_step_kernel); dtype 0 float32, 1
// bfloat16 (of u, dt_raw, buf, w and bias).
int laimr_ssd_conv_step(const void* u, const void* dt_raw, void* buf,
                        const void* w, const void* bias, const float* dt_bias,
                        float* out, float* dt, int dtype, int u_sb,
                        int dt_sb, int B, int C, int H, int W, void* stream) {
  if (B < 0 || B > 65535 || C < 1 || H < 1 || W < 2 || W > kConvMaxW ||
      u_sb < 0 || dt_sb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const dim3 grid((C + H + kConvThreads - 1) / kConvThreads, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    ssd_conv_step_kernel<float><<<grid, kConvThreads, 0, st>>>(
        static_cast<const float*>(u), static_cast<const float*>(dt_raw),
        static_cast<float*>(buf), static_cast<const float*>(w),
        static_cast<const float*>(bias), dt_bias, out, dt, u_sb, dt_sb, C, H,
        W);
  else if (dtype == 1)
    ssd_conv_step_kernel<__nv_bfloat16><<<grid, kConvThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(u),
        static_cast<const __nv_bfloat16*>(dt_raw),
        static_cast<__nv_bfloat16*>(buf),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(bias), dt_bias, out, dt, u_sb,
        dt_sb, C, H, W);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The gated RMSNorm (ssd_gated_norm_kernel); dtype as above (of z and
// out).
int laimr_ssd_gated_norm(const float* y, const void* z, const float* scale,
                         void* out, int dtype, int z_sb, int B, int D,
                         int groups, int gate_first, float eps,
                         void* stream) {
  if (B < 0 || B > 65535 || D < 1 || groups < 1 || D % groups != 0 ||
      z_sb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const dim3 grid(groups, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    ssd_gated_norm_kernel<float><<<grid, kNormThreads, 0, st>>>(
        y, static_cast<const float*>(z), scale, static_cast<float*>(out),
        z_sb, D, D / groups, gate_first, eps);
  else if (dtype == 1)
    ssd_gated_norm_kernel<__nv_bfloat16><<<grid, kNormThreads, 0, st>>>(
        y, static_cast<const __nv_bfloat16*>(z), scale,
        static_cast<__nv_bfloat16*>(out), z_sb, D, D / groups, gate_first,
        eps);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of dtype's body, in bytes.
int laimr_ssd_smem_bytes(int dtype) {
  return dtype == 0 ? static_cast<int>(kSmemBytes) : 1024 + MmaSmem::bytes;
}

const char* laimr_ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
