// Hand-written Hopper (sm_90a) attention kernels for the port's model stack.
//
// flash_attention_kernel replaces the TPU kernel
//   src/repro/kernels/flash_attention.py : flash_attention (_kernel)
// decode_attention_kernel replaces the TPU kernel
//   src/repro/kernels/decode_attention.py : decode_attention (_kernel)
//
// Both compute what the TPU kernels and the plain versions
// (kernels/ref.py: flash_attention_ref, decode_attention_ref) compute:
// float32 logits, softmax state and accumulators whatever the input type;
// masked logits set to NEG_INF = -1e30 (not -inf), so a row with no valid
// key averages V uniformly, as the reference does; keys past the end weigh
// exactly 0; GQA by reading kv head h / (H / Hkv), never a repeated copy
// of K/V; the output cast to the input type (float32, or bfloat16 rounded
// to nearest even).
//
// What bounds them on an H100:
//  * prefill attention at the served shapes (B 8, S 512, 32 heads of 80,
//    causal, bf16) does ~10.8 GFLOP on ~84 MB, ~128 FLOP/byte, below the
//    card's ~295 FLOP/byte bf16 ridge: at the roofline bytes bound it
//    (~0.025 ms), and only the tensor cores (989 TFLOP/s bf16) keep the
//    products under that; on the CUDA cores in float32 (67 TFLOP/s) they
//    alone take >= 0.16 ms.
//  * decode attention reads every cache row once and does 4 FLOP per
//    element: bytes bound it (K + V of the batch over 3.35 TB/s), so it
//    needs many cache rows in flight at once, not tensor cores (one query
//    row per head gives a tensor core nothing to do).
//
// What the design does about it:
//  * flash, bfloat16 (the served dtype): FlashAttention-3 style on the
//    tensor cores. One block per (64 WG query rows, head, batch row): WG
//    consumer warpgroups (two at head_dim <= 80, else one) of 64 rows
//    each share every K/V tile; grid (H, B, q-blocks) with the q-block
//    index reversed, so the heaviest causal blocks start first. Thread 0
//    also issues every TMA load: Q once, K/V tiles of 64 keys into a ring
//    of three stages completing on mbarriers, each stage refilled as soon
//    as the block is done with it (a producer warp would cost a block per
//    SM in registers). Tiles arrive in bf16, never widened, as boxes of 64
//    head_dim columns (128-byte swizzle) plus 16-column chunks for the rest
//    (32-byte swizzle; head_dim 80 is one of each), since a TMA box row
//    is one request. S = Q K^T is one wgmma m64n64k16 chain over the
//    16-column k-steps (both operands K-major in shared memory), float32
//    accumulators in registers. Scale, soft cap and mask act on the
//    accumulator fragments (the mask only on tiles a causal diagonal, a
//    window edge or the end of the keys crosses, the scale folded into
//    the exponent's FFMA elsewhere; tiles the mask empties for every row
//    of a warpgroup are skipped); the online max reduces over the four
//    lanes of a quad. P is split in registers into bf16 hi (p truncated)
//    and lo (p - hi, rounded), each wgmma's A operand straight from
//    registers (the S accumulator layout is the A fragment layout): each
//    weight then errs by ~2^-17, not the 2^-9 of one bf16 part, which
//    misses the bf16 model bound at the served shape (4e-3 before the
//    output's rounding, in a plain emulation). The row sums add the
//    float32 weights. V is the B operand, MN-major (transposed) from the
//    same boxes: O += P_hi V + P_lo V is two m64n64k16 per box plus two
//    m64n16k16 per chunk. Any head_dim that is a multiple of 8: columns
//    past head_dim are TMA's zero fill or zeroed once, exact in both
//    products. Rows past Sq and keys past Skv are TMA's zero fill; keys
//    past the end get weight exactly 0 and rows past the end are never
//    written. The TMA descriptors are 4-D maps over (D, heads, S, B),
//    encoded on the host per call (cuTensorMapEncodeTiled through
//    cudaGetDriverEntryPoint: the library links no -lcuda) and passed as a
//    __grid_constant__ parameter, so the box coordinates carry the batch
//    row and the kv head. There is no fallback: an encode or launch error
//    is returned to the caller.
//  * flash, float32 (the parity dtype: the 2e-5 sweeps and the full-width
//    float32 model check; the TPU kernel computes in float32 too): the
//    CUDA-core body. One block of 256 threads per (64 query rows, head,
//    batch row); Q and one 64-key tile of K and V at a time staged in
//    shared memory as float32 (a row stride of D + 4 floats keeps the
//    16-byte reads of neighbouring rows on distinct banks); thread (ty, tx)
//    of the 16 x 16 grid owns query rows ty + 16 i and keys tx + 16 j of
//    the score tile, and rows ty + 16 i, columns tx + 16 c of the output
//    accumulator, all in registers; P goes through shared memory. Which
//    body runs is fixed by the input dtype, never by a failure.
//  * decode (both dtypes): split-KV (flash-decoding). grid (splits, Hkv,
//    B); the split count comes from the wrapper
//    (decode_attention.split_plan): enough blocks for two waves of the
//    card's SMs. A block serves one kv head's rep = H / Hkv query heads
//    over one split of the cache, so each cache row is read once. Its
//    tiles of slots (and their kv_pos) are staged in the input dtype by
//    cp.async into a two-stage ring, so the next tile's bytes are in
//    flight during this tile's math. Dot products: two threads per (query
//    head, slot), each over alternate 16-byte vectors of the row, joined by
//    a shuffle; P V: threads over (query head, 8 columns, slot residue mod
//    sp), the sp partial accumulators summed in a fixed order at the end.
//    Each split writes its float32 (m, l, acc) to scratch; the last block
//    of a (batch row, kv head) to finish (a __threadfence and an atomicAdd
//    ticket per pair, reset to 0 by that block) merges the splits in split
//    order, so the result does not depend on arrival order. One launch per
//    call. A row with no valid slot stays uniform over all C slots (every
//    split has m = -1e30 and weighs by its l); a split with no valid slot
//    beside valid ones weighs 0.
//  * head_dim: any multiple of 8 up to 256 (StableLM-3B's is 80).
//
// Arithmetic: the CUDA-core inner products accumulate with explicit
// __fmaf_rn (the library is built with -fmad=false, which only stops the
// compiler from fusing on its own); expf / tanhf are the accurate versions
// (never --use_fast_math); divisions are IEEE (-prec-div=true). The bf16
// flash body takes its softmax weights as ex2.approx (2^-22 relative) of
// log2(e)-scaled logits, far inside the bf16 bound.
// Hand PTX (wgmma, TMA, mbarrier, cp.async); no CUTLASS headers.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;   // ref.NEG_INF: the masked logit
constexpr int kBlockQ = 64;         // flash: query rows per block or warpgroup
constexpr int kBlockKV = 64;        // flash: keys per tile
constexpr int kThreads = 256;       // flash, float32: a 16 x 16 thread grid
constexpr int kRows = 4;            // flash, float32: rows per thread
constexpr int kCols = 4;            // flash, float32: keys per thread
constexpr int kLdP = kBlockKV + 4;  // flash, float32: row stride of P
constexpr int kStages = 3;          // flash, bf16: K/V ring depth
constexpr int kChunk = 16;          // flash, bf16: head_dim columns a chunk
constexpr int kChunkBytes = 64 * 32;  // flash, bf16: 64 rows x 32 bytes
constexpr int kDecThreads = 128;    // decode: threads per block
constexpr int kDecStages = 2;       // decode: cp.async ring depth
constexpr int kMaxHeadDim = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

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

// The arguments every attention launch shares.
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int Sq, Skv, H, Hkv, D;
  float scale;
  int causal, window;
  float softcap;
};

// Keys [begin, end) that any of the `rows` query rows from q0 can see. With Sq <= Skv every row has a valid key (itself, at least), so
// skipping keys outside this range changes nothing; with Sq > Skv leading
// rows see no key and average V over every key, so nothing is skipped.
__device__ __forceinline__ void visible_keys(int q0, int rows, int Sq,
                                             int Skv, int causal, int window,
                                             int* begin, int* end) {
  const int q_offset = Skv - Sq;
  *begin = 0;
  *end = Skv;
  if (q_offset >= 0) {
    const int pos_lo = q0 + q_offset;
    const int pos_hi = min(q0 + rows, Sq) - 1 + q_offset;
    if (causal) *end = min(Skv, pos_hi + 1);
    if (window > 0) *begin = max(0, pos_lo - window + 1);
  }
}

// ------------------------------------------------ prefill, float32 --
// The CUDA-core body (float32 inputs). grid (ceil(Sq / 64), H, B),
// block 256. q (B, Sq, H, D); k, v (B, Skv, Hkv, D); out (B, Sq, H, D).
// Query i sits at position Skv - Sq + i.
template <typename T, int NC>
__device__ __forceinline__ void flash_cuda_core(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv, int H,
    int Hkv, int D, float scale, int causal, int window, float softcap) {
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

  int kv_begin, kv_end;
  visible_keys(q0, kBlockQ, Sq, Skv, causal, window, &kv_begin, &kv_end);

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


// ------------------------------------------- Hopper PTX: TMA, wgmma --
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// 2^x by the SFU (ex2.approx.ftz: 2^-22 relative; 2^0 = 1 exactly, -inf
// and -1e30 give 0): the bf16 body's softmax weights.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
// byte offsets (16-byte units), layout (1: 128-byte swizzle, 3: 32-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(layout) << 62;
}

// D (64 x 64, float32) {+}= A (64 x 16, bf16, shared memory) B (16 x 64,
// bf16, shared memory); both operands K-major.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, float32) += A (64 x 16, bf16, registers) B (16 x 64, bf16,
// shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 16, float32) += A (64 x 16, bf16, registers) B (16 x 16, bf16,
// shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The layout of a Q, K or V tile of 64 rows in shared memory: NCH / 4
// boxes of 64 head_dim columns (64 rows x 128 bytes, the 128-byte
// swizzle), then NCH % 4 chunks of 16 columns (64 rows x 32 bytes, the
// 32-byte swizzle), each one TMA box. A region whose first column is at or
// past head_dim is never loaded and stays zero.
template <int NCH>
struct TileLayout {
  static constexpr int boxes = NCH / 4;
  static constexpr int regions = boxes + NCH % 4;
  static constexpr int bytes = NCH * kChunkBytes;
  __device__ static constexpr int offset(int r) {
    return r < boxes ? r * 4 * kChunkBytes
                     : boxes * 4 * kChunkBytes + (r - boxes) * kChunkBytes;
  }
  __device__ static constexpr int column(int r) {
    return r < boxes ? 64 * r : 64 * boxes + kChunk * (r - boxes);
  }
  __device__ static constexpr int region_bytes(int r) {
    return r < boxes ? 4 * kChunkBytes : kChunkBytes;
  }
};

// Byte offsets of the bf16 body's shared memory from a 1024-aligned base:
// WG Q tiles, kStages K tiles, kStages V tiles, then the full and Q
// mbarriers.
template <int NCH, int WG>
struct WgSmem {
  static constexpr int tile = TileLayout<NCH>::bytes;
  static constexpr int q = 0;
  static constexpr int k = WG * tile;
  static constexpr int v = k + kStages * tile;
  static constexpr int bars = v + kStages * tile;
  static constexpr int bytes = bars + 8 * (kStages + 1);
};

// The descriptor of the 16-deep k-step `kk` (16 head_dim columns) of a
// K-major tile (Q as A, K as B), from the tile's box and chunk
// descriptors: inside a 128-byte box the step starts 32 bytes further
// along the row (rows 128 bytes apart, 8-row groups 1024), a chunk is one
// step (rows 32 bytes apart, 8-row groups 256). Offsets add to the start
// address field (16-byte units), which never carries out at these sizes.
template <int NCH>
__device__ __forceinline__ uint64_t kstep_desc(uint64_t box, uint64_t chunk,
                                               int kk) {
  using T = TileLayout<NCH>;
  if (kk < 4 * T::boxes) return box + ((T::offset(kk / 4) + (kk % 4) * 32) >> 4);
  return chunk + ((T::offset(T::boxes + kk - 4 * T::boxes) -
                   T::offset(T::boxes)) >> 4);
}

// A K-major tile's box and chunk descriptors at k-step 0.
template <int NCH>
__device__ __forceinline__ void kmajor_descs(uint32_t tile, uint64_t* box,
                                             uint64_t* chunk) {
  *box = smem_desc(tile, 16, 1024, 1);
  *chunk = smem_desc(tile + TileLayout<NCH>::offset(TileLayout<NCH>::boxes),
                     16, 256, 3);
}

// --------------------------------------------------- prefill, bf16 --
// grid (H, B, ceil(Sq / (64 WG))), block 128 WG: WG consumer warpgroups of
// 64 query rows each share every K/V tile; thread 0 also issues the TMA
// loads. NCH = chunks of 16 columns the accumulators span (>= D / 16).
template <int NCH, int WG>
__device__ __forceinline__ void flash_wgmma(const FlashArgs& a,
                                            const CUtensorMap* maps) {
  using L = WgSmem<NCH, WG>;
  using T = TileLayout<NCH>;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  const uint32_t raw = smem_addr(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gen = wg_smem + (base - raw);
  const uint32_t bar_full = base + L::bars;
  const uint32_t bar_q = bar_full + 8 * kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * WG * kBlockQ;  // heaviest
  const int hk = h / (a.H / a.Hkv);                            // first
  const int q_offset = a.Skv - a.Sq;
  int kv_begin, kv_end;
  visible_keys(q0, WG * kBlockQ, a.Sq, a.Skv, a.causal, a.window, &kv_begin,
               &kv_end);
  const int t_begin = kv_begin / kBlockKV;
  const int n_tiles = (kv_end + kBlockKV - 1) / kBlockKV - t_begin;
  const int tid = threadIdx.x;
  const int n_wg = min(WG, (a.Sq - q0 + kBlockQ - 1) / kBlockQ);  // with rows
  int tile_bytes = 0;  // what TMA writes into a tile
#pragma unroll
  for (int r = 0; r < T::regions; ++r)
    if (T::column(r) < a.D) tile_bytes += T::region_bytes(r);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(bar_full + 8 * s, 1);
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tile_bytes < T::bytes) {
    // regions past the head_dim are never loaded: zero them once in every
    // tile (exact in both products), visible to wgmma's proxy
    for (int t = 0; t < WG + 2 * kStages; ++t)
#pragma unroll
      for (int r = 0; r < T::regions; ++r) {
        if (T::column(r) < a.D) continue;
        for (int i = tid * 16; i < T::region_bytes(r); i += 128 * WG * 16)
          *reinterpret_cast<uint4*>(gen + t * L::tile + T::offset(r) + i) =
              make_uint4(0, 0, 0, 0);
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // TMA loads, issued by thread 0; maps[2 op + (region is a chunk)] for
  // op = Q, K, V
  auto load_kv = [&](int t) {
    const int st = t % kStages;
    const int j0 = (t_begin + t) * kBlockKV;
    const uint32_t full = bar_full + 8 * st;
    mbar_expect_tx(full, 2 * tile_bytes);
#pragma unroll
    for (int r = 0; r < T::regions; ++r) {
      if (T::column(r) >= a.D) continue;
      const uint32_t at = st * L::tile + T::offset(r);
      const int chunk = r >= T::boxes;
      tma_load_4d(base + L::k + at, &maps[2 + chunk], full, T::column(r), hk,
                  j0, b);
      tma_load_4d(base + L::v + at, &maps[4 + chunk], full, T::column(r), hk,
                  j0, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, n_wg * tile_bytes);
    for (int w = 0; w < n_wg; ++w)
#pragma unroll
      for (int r = 0; r < T::regions; ++r)
        if (T::column(r) < a.D)
          tma_load_4d(base + L::q + w * L::tile + T::offset(r),
                      &maps[r >= T::boxes], bar_q, T::column(r), h,
                      q0 + w * kBlockQ, b);
    for (int t = 0; t < min(kStages, n_tiles); ++t) load_kv(t);
  }

  // warpgroup wg: query rows qw .. qw + 63, the keys [wb, we); this thread
  // holds rows r0 and r0 + 8, columns 8 i + cq and 8 i + cq + 1 of every
  // 8-column group i
  const int wg = tid / 128;
  const int warp = tid % 128 / 32;
  const int lane = tid % 32;
  const int qw = q0 + wg * kBlockQ;
  const bool rows_here = wg < n_wg;
  int wb, we;
  visible_keys(qw, kBlockQ, a.Sq, a.Skv, a.causal, a.window, &wb, &we);
  const int r0 = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int pos0 = qw + r0 + q_offset;  // query positions of the two rows
  const int pos_lo = qw + q_offset;
  const int pos_hi = min(qw + kBlockQ, a.Sq) - 1 + q_offset;
  const bool capped = a.softcap > 0.f;
  const float sl2 = a.scale * kLog2e;
  const float cap_l2 = a.softcap * kLog2e;
  // the keys each of the two rows may see: key_lo <= key <= key_hi
  int key_lo[2], key_hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = pos0 + 8 * r;
    key_lo[r] = a.window > 0 ? pos - a.window + 1 : INT_MIN;
    key_hi[r] = a.causal ? pos : INT_MAX;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float o[NCH * 8];
  float s[32];
#pragma unroll
  for (int i = 0; i < NCH * 8; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  uint64_t q_box, q_chunk;
  kmajor_descs<NCH>(base + L::q + wg * L::tile, &q_box, &q_chunk);

  // S = Q K(t)^T into s, one k-step per 16 columns; committed, not waited
  auto issue_s = [&](int t) {
    uint64_t k_box, k_chunk;
    kmajor_descs<NCH>(base + L::k + (t % kStages) * L::tile, &k_box,
                      &k_chunk);
#pragma unroll
    for (int kk = 0; kk < NCH; ++kk)
      wgmma_ss_n64(s, kstep_desc<NCH>(q_box, q_chunk, kk),
                   kstep_desc<NCH>(k_box, k_chunk, kk), kk > 0);
    wgmma_commit();
  };
  // O += P_hi V(t) + P_lo V(t): per 16 keys, one n64 product per box
  // (MN-major: keys 128 bytes apart, 8-key groups 1024 apart) and one n16
  // per chunk (keys 32 bytes apart, 8-key groups 256 apart); committed,
  // not waited
  auto issue_pv = [&](int t, const uint32_t* hi, const uint32_t* lo) {
    const uint32_t v_st = base + L::v + (t % kStages) * L::tile;
    const uint64_t v_box = smem_desc(v_st, 4 * kChunkBytes, 1024, 1);
    const uint64_t v_chunk =
        smem_desc(v_st + T::offset(T::boxes), kChunkBytes, 256, 3);
#pragma unroll
    for (int kk = 0; kk < kBlockKV / 16; ++kk) {
#pragma unroll
      for (int g = 0; g < T::boxes; ++g) {
        const uint64_t dv = v_box + ((T::offset(g) + kk * 16 * 128) >> 4);
        wgmma_rs_n64(o + 32 * g, hi + 4 * kk, dv);
        wgmma_rs_n64(o + 32 * g, lo + 4 * kk, dv);
      }
#pragma unroll
      for (int c = 0; c < T::regions - T::boxes; ++c) {
        const uint64_t dv = v_chunk + ((c * kChunkBytes + kk * 16 * 32) >> 4);
        wgmma_rs_n16(o + 32 * T::boxes + 8 * c, hi + 4 * kk, dv);
        wgmma_rs_n16(o + 32 * T::boxes + 8 * c, lo + 4 * kk, dv);
      }
    }
    wgmma_commit();
  };
  // The online softmax of tile t's logits in s: the new row maxima and
  // sums, corr = exp(m_old - m_new) for O, and P = hi + lo in bf16 packed
  // as wgmma's A fragments (hi[4 kk .. 4 kk + 3] are keys 16 kk .. 16 kk
  // + 15, the pairs s[2 i], s[2 i + 1] of row i % 2). hi is p truncated to
  // bf16 (one byte permute for the pair), lo = p - hi (exact in float32)
  // rounded to bf16; the row sums add the float32 weights.
  auto softmax = [&](int t, uint32_t* hi, uint32_t* lo, float* corr) {
    const int j0 = (t_begin + t) * kBlockKV;
    // logits in log2 units; s[4 i + e] is row r0 + 8 (e / 2), column
    // 8 i + cq + e % 2
    const bool edge = q_offset < 0 || j0 + kBlockKV > a.Skv ||
                      (a.causal && j0 + kBlockKV - 1 > pos_lo) ||
                      (a.window > 0 && j0 <= pos_hi - a.window);
    const bool fold = !capped && !edge;  // no mask: scale inside the exp
    if (capped) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = tanhf(s[i] * a.scale / a.softcap) * cap_l2;
    } else if (!fold) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= sl2;
    }
    if (edge) {
      // a tile the causal diagonal, a window edge or the end of the keys
      // crosses
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = (i >> 1) & 1;
        const int key = j0 + 8 * (i >> 2) + cq + (i & 1);
        const float x = key >= key_lo[row] && key <= key_hi[row] ? s[i]
                                                                  : kNegInf;
        s[i] = key < a.Skv ? x : __int_as_float(0xff800000);
      }
    }
    float mx[2] = {s[0], s[2]};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    // p = 2^(s c1 - mx): c1 = sl2 when s is still unscaled
    const float c1 = fold ? sl2 : 1.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      mx[r] = fmaxf(m[r], mx[r] * c1);
      corr[r] = exp2_ftz(m[r] - mx[r]);
      m[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int row = i & 1;
      const float p0 = exp2_ftz(__fmaf_rn(s[2 * i], c1, -mx[row]));
      const float p1 = exp2_ftz(__fmaf_rn(s[2 * i + 1], c1, -mx[row]));
      const uint32_t b0 = __float_as_uint(p0);
      const uint32_t b1 = __float_as_uint(p1);
      hi[i] = __byte_perm(b0, b1, 0x7632);
      const __nv_bfloat162 l2 =
          __floats2bfloat162_rn(p0 - __uint_as_float(b0 & 0xffff0000u),
                                p1 - __uint_as_float(b1 & 0xffff0000u));
      lo[i] = *reinterpret_cast<const uint32_t*>(&l2);
      rs[row] += p0 + p1;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
  };
  mbar_wait(bar_q, 0);
  uint32_t hi[16], lo[16];
  float corr[2];
  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(bar_full + 8 * (t % kStages), (t / kStages) & 1);
    const int j0 = (t_begin + t) * kBlockKV;
    if (rows_here && j0 < we && j0 + kBlockKV > wb) {
      fence_regs<32>(s);
      wgmma_fence();
      issue_s(t);
      wgmma_wait_all();
      fence_regs<32>(s);
      softmax(t, hi, lo, corr);
      if (corr[0] != 1.f || corr[1] != 1.f) {
#pragma unroll
        for (int i = 0; i < NCH * 8; ++i) o[i] *= corr[(i >> 1) & 1];
      }
      fence_regs<NCH * 8>(o);
      fence_regs<16>(hi);
      fence_regs<16>(lo);
      wgmma_fence();
      issue_pv(t, hi, lo);
      wgmma_wait_all();
      fence_regs<NCH * 8>(o);
    }
    if (t + kStages < n_tiles) {
      __syncthreads();  // every warpgroup is done with this stage
      if (tid == 0) load_kv(t + kStages);
    }
  }

  // epilogue: the row sums over the quad, then o / l in bf16 pairs
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int i = 0; i < NCH * 4; ++i) {
    const int row = i & 1;
    const int col = 8 * (i >> 1) + cq;
    const int qrow = qw + r0 + 8 * row;
    if (qrow < a.Sq && col < a.D) {
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(o[2 * i] / l[row],
                                                      o[2 * i + 1] / l[row]);
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((static_cast<int64_t>(b) * a.Sq + qrow) * a.H + h) * a.D +
          col) = v2;
    }
  }
}

// One __global__ per function: the input dtype picks the body.
template <typename T_, int NC_>
struct FlashCfg {
  using T = T_;
  static constexpr int NC = NC_;
  static constexpr bool tensor_cores = std::is_same<T_, __nv_bfloat16>::value;
  // consumer warpgroups per block of the bf16 body (two share each K/V
  // tile while their registers let two blocks share an SM)
  static constexpr int wg = NC_ <= 5 ? 2 : 1;
  static constexpr int threads = tensor_cores ? 128 * wg : kThreads;
  static constexpr int min_blocks =
      !tensor_cores ? 1 : NC_ <= 8 ? 2 : 1;
};

// The bf16 body's TMA maps: Q, K, V, each as 64-column boxes and as
// 16-column chunks (see chunk_maps).
struct TileMaps {
  CUtensorMap map[6];
};

template <typename Cfg>
__global__ void __launch_bounds__(Cfg::threads, Cfg::min_blocks)
flash_attention_kernel(const FlashArgs a,
                       const __grid_constant__ TileMaps maps) {
  if constexpr (Cfg::tensor_cores) {
    flash_wgmma<Cfg::NC, Cfg::wg>(a, maps.map);
  } else {
    using T = typename Cfg::T;
    flash_cuda_core<T, Cfg::NC>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.out), a.Sq, a.Skv,
        a.H, a.Hkv, a.D, a.scale, a.causal, a.window, a.softcap);
  }
}

// ------------------------------------------------------------- decode --
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* kv_pos;
  const int32_t* q_pos;
  void* out;
  float* part;   // splits > 1: (B, H, splits, D) acc, then m and l
  int* tickets;  // splits > 1: (B, Hkv) arrival counters, all 0 between calls
  int C, H, Hkv, D;
  int split_len;  // cache slots per split (a multiple of the tile)
  int sp;         // slot residues the P V threads split a tile by
  float scale;
  int window;
  float softcap;
};

// Cache slots per staged tile: two stages of K and V stay under ~128 KB
// at head_dim 256.
template <typename T>
struct DecCfg {
  static constexpr int slots = sizeof(T) == 2 ? 64 : 32;
};

size_t decode_smem_bytes(int rep, int D, int esize, int slots, int sp) {
  const size_t kv = static_cast<size_t>(2 * kDecStages) * slots * D * esize;
  const size_t pos = static_cast<size_t>(kDecStages) * slots * sizeof(int32_t);
  const size_t floats = static_cast<size_t>(rep) * D + rep * slots +
                        static_cast<size_t>(sp) * rep * D + 3 * rep;
  return kv + pos + sizeof(float) * floats;
}

// grid (splits, Hkv, B), block 128. q (B, H, D); k_cache, v_cache (B, C,
// Hkv, D); kv_pos (B, C); q_pos (B,); out (B, H, D). Query heads
// hk * rep .. hk * rep + rep - 1 read kv head hk; split s covers slots
// [s * split_len, min(C, (s + 1) * split_len)).
template <typename T>
__global__ void __launch_bounds__(kDecThreads)
decode_attention_kernel(const DecodeArgs a) {
  constexpr int TS = DecCfg<T>::slots;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  extern __shared__ float4 dec_smem4[];
  const int D = a.D;
  const int rep = a.H / a.Hkv;
  T* k_s = reinterpret_cast<T*>(dec_smem4);    // [stages][TS][D]
  T* v_s = k_s + kDecStages * TS * D;           // [stages][TS][D]
  int32_t* pos_s =
      reinterpret_cast<int32_t*>(v_s + kDecStages * TS * D);  // [stages][TS]
  float* q_s = reinterpret_cast<float*>(pos_s + kDecStages * TS);  // [rep][D]
  float* p_s = q_s + rep * D;                   // [rep][TS]
  float* acc_s = p_s + rep * TS;                // [sp][rep][D]
  float* m_s = acc_s + a.sp * rep * D;
  float* l_s = m_s + rep;
  float* corr_s = l_s + rep;
  __shared__ int last_block;

  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int s_begin = split * a.split_len;
  const int s_end = min(a.C, s_begin + a.split_len);
  const int n_tiles = (s_end - s_begin + TS - 1) / TS;
  const int64_t kv_stride = static_cast<int64_t>(a.Hkv) * D;
  const T* k_b = static_cast<const T*>(a.k) +
                 (static_cast<int64_t>(b) * a.C * a.Hkv + hk) * D;
  const T* v_b = static_cast<const T*>(a.v) +
                 (static_cast<int64_t>(b) * a.C * a.Hkv + hk) * D;
  const int32_t* pos_b = a.kv_pos + static_cast<int64_t>(b) * a.C;
  const int qp = a.q_pos[b];

  // stage tile t (slots past the split's end are never copied or read)
  auto issue = [&](int t) {
    const int j0 = s_begin + t * TS;
    const int n = min(TS, s_end - j0);
    const int st = t % kDecStages;
    const int chunks = D / VEC;
    for (int idx = tid; idx < n * chunks; idx += kDecThreads) {
      const int r = idx / chunks;
      const int c = (idx - r * chunks) * VEC;
      const int64_t g = static_cast<int64_t>(j0 + r) * kv_stride + c;
      cp_async16(k_s + (st * TS + r) * D + c, k_b + g);
      cp_async16(v_s + (st * TS + r) * D + c, v_b + g);
    }
    for (int j = tid; j < n; j += kDecThreads)
      cp_async4(pos_s + st * TS + j, pos_b + j0 + j);
  };

  for (int t = 0; t < kDecStages - 1; ++t) {
    if (t < n_tiles) issue(t);
    cp_async_commit();
  }
  load_tile(q_s, D, static_cast<const T*>(a.q) +
                        (static_cast<int64_t>(b) * a.H + hk * rep) * D,
            D, 0, rep, rep, D);
  for (int idx = tid; idx < a.sp * rep * D; idx += kDecThreads)
    acc_s[idx] = 0.f;
  for (int r = tid; r < rep; r += kDecThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int chunks8 = D / 8;
  const int dv_n = D / 8;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + kDecStages - 1 < n_tiles) issue(t + kDecStages - 1);
    cp_async_commit();
    cp_async_wait<kDecStages - 1>();  // tile t has landed
    __syncthreads();
    const int st = t % kDecStages;
    const int n = min(TS, s_end - (s_begin + t * TS));
    const T* kt = k_s + st * TS * D;
    const T* vt = v_s + st * TS * D;

    // logits: two threads per (query head, slot), alternate 8-column
    // vectors each
    for (int base = 0; base < rep * TS * 2; base += kDecThreads) {
      const int item = base + tid;
      const bool act = item < rep * TS * 2;
      const int r = item / (2 * TS);
      const int j = (item / 2) % TS;
      float dot = 0.f;
      if (act && j < n) {
        const float* qr = q_s + r * D;
        const T* kr = kt + j * D;
        for (int c = item & 1; c < chunks8; c += 2) {
          float kv[8];
          load8(kr + 8 * c, kv);
          const float4 qa = *reinterpret_cast<const float4*>(qr + 8 * c);
          const float4 qb = *reinterpret_cast<const float4*>(qr + 8 * c + 4);
          dot = dot4(qa, make_float4(kv[0], kv[1], kv[2], kv[3]), dot);
          dot = dot4(qb, make_float4(kv[4], kv[5], kv[6], kv[7]), dot);
        }
      }
      dot += __shfl_xor_sync(kFull, dot, 1);
      if (act && (item & 1) == 0) {
        bool valid = false;
        if (j < n) {
          const int kp = pos_s[st * TS + j];
          valid = kp >= 0 && kp <= qp && (a.window <= 0 || kp > qp - a.window);
        }
        p_s[r * TS + j] = logit(dot, a.scale, a.softcap, j < n, valid);
      }
    }
    __syncthreads();

    // online softmax, one warp per query head
    for (int r = warp; r < rep; r += kDecThreads / 32) {
      float mx = m_s[r];
      for (int j = lane; j < TS; j += 32) mx = fmaxf(mx, p_s[r * TS + j]);
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      float sum = 0.f;
      for (int j = lane; j < TS; j += 32) {
        const float p = expf(p_s[r * TS + j] - mx);
        p_s[r * TS + j] = p;
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

    // acc = acc * corr + P V: thread (query head, 8 columns, slot residue)
    for (int item = tid; item < a.sp * rep * dv_n; item += kDecThreads) {
      const int dv = item % dv_n;
      const int r = (item / dv_n) % rep;
      const int sp = item / (dv_n * rep);
      float* acc = acc_s + (sp * rep + r) * D + 8 * dv;
      const float corr = corr_s[r];
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = acc[e] * corr;
      const float* p = p_s + r * TS;
      for (int j = sp; j < n; j += a.sp) {
        float vv[8];
        load8(vt + j * D + 8 * dv, vv);
        const float pj = p[j];
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = __fmaf_rn(pj, vv[e], x[e]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = x[e];
    }
    __syncthreads();  // this stage is consumed before a later tile lands in it
  }

  // this split's state: (m, l, acc summed over the slot residues in order)
  T* out = static_cast<T*>(a.out);
  for (int idx = tid; idx < rep * D; idx += kDecThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    float o = 0.f;
    for (int sp = 0; sp < a.sp; ++sp) o += acc_s[(sp * rep + r) * D + d];
    const int64_t bh = static_cast<int64_t>(b) * a.H + hk * rep + r;
    if (splits == 1)
      store(out + bh * D + d, o / fmaxf(l_s[r], 1e-30f));
    else
      a.part[(bh * splits + split) * D + d] = o;
  }
  if (splits == 1) return;
  const int64_t n_part = static_cast<int64_t>(gridDim.z) * a.H * splits;
  float* part_m = a.part + n_part * D;
  float* part_l = part_m + n_part;
  for (int r = tid; r < rep; r += kDecThreads) {
    const int64_t at = (static_cast<int64_t>(b) * a.H + hk * rep + r) *
                       splits + split;
    part_m[at] = m_s[r];
    part_l[at] = l_s[r];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_block = atomicAdd(a.tickets + b * a.Hkv + hk, 1) == splits - 1;
  __syncthreads();
  if (!last_block) return;

  // the last split of this (batch row, kv head) to finish merges them all,
  // in split order
  __threadfence();
  for (int idx = tid; idx < rep * D; idx += kDecThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int64_t bh = static_cast<int64_t>(b) * a.H + hk * rep + r;
    float mx = kNegInf;
    for (int s = 0; s < splits; ++s)
      mx = fmaxf(mx, __ldcg(part_m + bh * splits + s));
    float l = 0.f, o = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = expf(__ldcg(part_m + bh * splits + s) - mx);
      l = __fmaf_rn(__ldcg(part_l + bh * splits + s), w, l);
      o = __fmaf_rn(__ldcg(a.part + (bh * splits + s) * D + d), w, o);
    }
    store(out + bh * D + d, o / fmaxf(l, 1e-30f));
  }
  if (tid == 0) a.tickets[b * a.Hkv + hk] = 0;
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

// 4-D maps over a contiguous bf16 (B, S, heads, D) tensor, dims innermost
// first (D, heads, S, B): maps[0] has boxes of 64 columns (128-byte
// swizzle), maps[1] of 16 columns (32-byte swizzle), each `rows` rows of
// one head. Columns past D and rows past S read as 0.
cudaError_t chunk_maps(CUtensorMap* maps, const void* ptr, int B, int S,
                       int heads, int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 2; ++i) {
    const cuuint32_t box[4] = {i == 0 ? 64u : static_cast<cuuint32_t>(kChunk),
                               1, static_cast<cuuint32_t>(rows), 1};
    const CUresult r = encode(
        &maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        i == 0 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <typename T, int NC>
int launch_flash(const FlashArgs& a, int B, cudaStream_t stream) {
  using Cfg = FlashCfg<T, NC>;
  static size_t reserved = 0;
  TileMaps maps{};
  size_t bytes;
  dim3 grid;
  if constexpr (Cfg::tensor_cores) {
    bytes = WgSmem<NC, Cfg::wg>::bytes + 1024;  // + aligning the base
    grid = dim3(a.H, B, (a.Sq + Cfg::wg * kBlockQ - 1) / (Cfg::wg * kBlockQ));
    cudaError_t e = chunk_maps(&maps.map[0], a.q, B, a.Sq, a.H, a.D, kBlockQ);
    if (e == cudaSuccess)
      e = chunk_maps(&maps.map[2], a.k, B, a.Skv, a.Hkv, a.D, kBlockKV);
    if (e == cudaSuccess)
      e = chunk_maps(&maps.map[4], a.v, B, a.Skv, a.Hkv, a.D, kBlockKV);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    bytes = flash_smem_bytes(a.D);
    grid = dim3((a.Sq + kBlockQ - 1) / kBlockQ, a.H, B);
  }
  const cudaError_t e =
      reserve_smem(flash_attention_kernel<Cfg>, bytes, &reserved);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_attention_kernel<Cfg><<<grid, Cfg::threads, bytes, stream>>>(a,
                                                                    maps);
  return static_cast<int>(cudaGetLastError());
}

// The accumulator width NC (16-column chunks, or columns per thread of
// the float32 body) in buckets of head_dim.
template <typename T>
int launch_flash_d(const FlashArgs& a, int B, cudaStream_t stream) {
  if (a.D <= 32) return launch_flash<T, 2>(a, B, stream);
  if (a.D <= 64) return launch_flash<T, 4>(a, B, stream);
  if (a.D <= 80) return launch_flash<T, 5>(a, B, stream);
  if (a.D <= 128) return launch_flash<T, 8>(a, B, stream);
  return launch_flash<T, 16>(a, B, stream);
}

template <typename T>
int launch_decode(const DecodeArgs& a, int B, int splits,
                  cudaStream_t stream) {
  static size_t reserved = 0;
  const size_t bytes = decode_smem_bytes(a.H / a.Hkv, a.D, sizeof(T),
                                         DecCfg<T>::slots, a.sp);
  const cudaError_t e =
      reserve_smem(decode_attention_kernel<T>, bytes, &reserved);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(splits, a.Hkv, B);
  decode_attention_kernel<T><<<grid, kDecThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int S, int H, int Hkv, int D) {
  return B < 0 || S < 1 || Hkv < 1 || H % Hkv != 0 || D % 8 != 0 || D < 8 ||
         D > kMaxHeadDim;
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype 0 is float32, 1 bfloat16.
// Each launcher enqueues on the caller's stream, never synchronises, and
// returns cudaGetLastError() (or the error that stopped the launch).
extern "C" {

int laimr_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int dtype, int B, int Sq, int Skv,
                          int H, int Hkv, int D, float scale, int causal,
                          int window, float softcap, void* stream) {
  if (bad_shape(B, Sq, H, Hkv, D) || Skv < 1 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FlashArgs a{q, k, v, out, Sq, Skv, H, Hkv, D, scale, causal, window,
                    softcap};
  if (dtype == 0) return launch_flash_d<float>(a, B, st);
  if (dtype == 1) return launch_flash_d<__nv_bfloat16>(a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// part: float32 scratch of B * H * splits * (D + 2) (unused when splits
// is 1); tickets: B * Hkv int32, all 0, left 0.
int laimr_decode_attention(const void* q, const void* k_cache,
                           const void* v_cache, const int32_t* kv_pos,
                           const int32_t* q_pos, void* out, float* part,
                           int* tickets, int dtype, int B, int C, int H,
                           int Hkv, int D, int splits, int split_len,
                           float scale, int window, float softcap,
                           void* stream) {
  if (bad_shape(B, C, H, Hkv, D) || window < 0 || splits < 1 ||
      split_len < 1 || static_cast<int64_t>(splits - 1) * split_len >= C ||
      static_cast<int64_t>(splits) * split_len < C ||
      (splits > 1 && (part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rep_dv = (H / Hkv) * (D / 8);
  DecodeArgs a{q, k_cache, v_cache, kv_pos, q_pos, out, part, tickets, C, H,
               Hkv, D, split_len, 1, scale, window, softcap};
  if (dtype == 0) {
    a.sp = std::max(1, std::min(DecCfg<float>::slots, kDecThreads / rep_dv));
    return launch_decode<float>(a, B, splits, st);
  }
  if (dtype == 1) {
    a.sp = std::max(
        1, std::min(DecCfg<__nv_bfloat16>::slots, kDecThreads / rep_dv));
    return launch_decode<__nv_bfloat16>(a, B, splits, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}


const char* laimr_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
