// Hand-written Hopper (sm_90a) grouped expert GEMM of a dropless mixture
// of experts: moe_gemm_kernel.
//
// It replaces no TPU kernel: the reference's mixture
// (src/repro/models/layers.py : moe) runs batched einsums over every
// expert's capacity rows, and Nemotron-H's dropless router has no
// counterpart there. It computes what the plain version
// (kernels/ref.py: moe_gemm_ref) computes: every routed (token, expert)
// row of one layer times its expert's weights, out[r] = act(a[rows[r]] @
// w[e(r)]), the rows sorted by expert, with float32 sums whatever the
// input type, act ("relu2": the ReLU squared) applied to the float32 sum,
// then one rounding to the output type.
//
// What bounds it on an H100 (NVIDIA-Nemotron-3-Nano: d 2688, expert width
// 1856, 128 experts, top 6):
//  * a decode step's 32 tokens route 192 rows onto ~100 experts, ~2 rows
//    each: the work is reading the touched experts' weights (2 x 10 MB a
//    layer each), ~1 FLOP a byte, so bytes bound it (touched weights over
//    3.35 TB/s), and an expert no row chose must never be read;
//  * a prefill of 32 x 128 tokens routes 24,576 rows, ~190 an expert:
//    ~490 GFLOP a layer on ~2.6 GB, above the card's bf16 ridge, so only
//    the tensor cores (989 TFLOP/s) keep it near its bound.
//
// What the design does about it:
//  * the grid is static, planned on the device (moe_gemm.plan): a tile is
//    64 sorted rows of one expert (an expert's rows cut into
//    ceil(count / 64) tiles), at most ceil(P / 64) + E tiles for P rows;
//    grid (max tiles, column blocks), and a block whose tile lies past the
//    plan's count returns at once. No count reaches the host, so the
//    launch sits in a CUDA graph. A tile streams its expert's weight
//    columns once over the K loop and touches no other expert's; the
//    blocks of one expert's tiles are neighbours in the grid (the tile
//    index runs fastest), so an expert with several tiles finds its
//    weight boxes in L2.
//  * bfloat16 (the served dtype), on the tensor cores: one warpgroup a
//    block, float32 accumulators in registers, a ring of four stages of
//    64 k. Weights arrive by TMA as 64 x 64 boxes of a 3-D map over (N,
//    K, E) (128-byte swizzle, zero fill past K and N), completing on an
//    mbarrier, and are wgmma's B operand MN-major; a tile's rows are
//    gathered by cp.async (16 bytes a copy, zero fill past K; rows past
//    the expert's end are never read, their results never written) into
//    the same swizzled K-major layout, wgmma's A operand. Products are
//    m64n64k16 chains, 64 columns a box: decode takes 64 columns a block
//    (enough blocks to keep the copies in flight), prefill 128 (each
//    gathered row reused over two boxes). The epilogue applies the
//    activation to the float32 sum and stores pairs in the output type.
//  * float32 (the parity dtype): a CUDA-core body, 256 threads a 64 x 64
//    tile, 16 k a step staged in shared memory, each thread 4 x 4 sums
//    in k order (__fmaf_rn). Which body runs is fixed by the input dtype.
//
// Hand PTX (wgmma, TMA, mbarrier, cp.async); no CUTLASS headers.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockM = 64;         // sorted rows a tile
constexpr int kBlockK = 64;         // k a stage: one 128-byte bf16 row
constexpr int kStages = 4;          // bf16: ring depth
constexpr int kBox = 64 * 128;      // bf16: a 64 x 64 box, bytes
constexpr int kSimtThreads = 256;   // float32: a 16 x 16 thread grid
constexpr int kSimtK = 16;          // float32: k a step

struct MoeArgs {
  const void* a;               // (T, K)
  const int64_t* rows;         // (P,): the row of a each sorted row reads;
                               // null: sorted row r reads a[r]
  const void* w;               // (E, K, N); the bf16 body reads the map
  void* out;                   // (P, N)
  const int32_t* tile_expert;  // (max tiles,)
  const int32_t* tile_row0;    // (max tiles,): the tile's first sorted row
  const int32_t* ends;         // (E,): one past each expert's last row
  const int32_t* n_tiles;      // (1,): tiles in use
  int K, N;
  int act;                     // 0 none, 1 relu2
};

__device__ __forceinline__ float activate(float x, int act) {
  if (act == 1) {
    x = fmaxf(x, 0.f);
    x = x * x;
  }
  return x;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
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

// One box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// 16 bytes from global to shared memory; `bytes` of them read, the rest
// zero (0: all zero).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of products are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units), layout (1: 128-byte swizzle).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(layout) << 62;
}

// D (64 x 64, float32) += A (64 x 16, bf16, shared memory, K-major) B
// (16 x 64, bf16, shared memory, MN-major).
__device__ __forceinline__ void wgmma_ss_n64_bt(float* d, uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// --------------------------------------------------------- bf16 body --
// Shared memory of a stage, from a 1024-aligned base: the A tile (64 rows
// x 128 bytes, the 128-byte swizzle: 16-byte chunk c of row r at chunk c
// ^ (r % 8)), then NB weight boxes (64 k rows x 128 bytes each, as TMA
// swizzles them); the stages' mbarriers after the last stage.
template <int NB>
struct Stage {
  static constexpr int bytes = kBox * (1 + NB);
  static constexpr int smem = kStages * bytes + 8 * kStages + 1024;
};

// grid (max tiles, ceil(N / BN)), block 128: one warpgroup; thread 0
// also issues the TMA loads.
template <int BN, typename OutT>
__device__ __forceinline__ void moe_wgmma(const MoeArgs& a,
                                          const CUtensorMap* map) {
  constexpr int NB = BN / 64;
  using S = Stage<NB>;
  extern __shared__ __align__(128) unsigned char moe_smem[];
  const int tile = blockIdx.x;
  if (tile >= *a.n_tiles) return;
  const uint32_t raw = smem_addr(moe_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar_full = base + kStages * S::bytes;

  const int e = a.tile_expert[tile];
  const int row0 = a.tile_row0[tile];
  const int n_rows = min(kBlockM, a.ends[e] - row0);
  const int n0 = blockIdx.y * BN;
  const int nk = (a.K + kBlockK - 1) / kBlockK;
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(bar_full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // this thread copies 16-byte chunk c of tile rows tid / 8 + 16 j
  const int c = tid % 8;
  const __nv_bfloat16* src[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = tid / 8 + 16 * j;
    src[j] = nullptr;
    if (r < n_rows) {
      const int64_t row = a.rows != nullptr ? a.rows[row0 + r] : row0 + r;
      src[j] = static_cast<const __nv_bfloat16*>(a.a) + row * a.K;
    }
  }
  __syncthreads();

  auto load = [&](int kt) {
    const int st = kt % kStages;
    const uint32_t sa = base + st * S::bytes;
    const int col = kt * kBlockK + 8 * c;
    const bool in_k = col < a.K;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tid / 8 + 16 * j;
      if (src[j] != nullptr)
        cp_async16(sa + r * 128 + ((c ^ (r & 7)) << 4),
                   src[j] + (in_k ? col : 0), in_k ? 16 : 0);
    }
    cp_async_commit();
    if (tid == 0) {
      // a box wholly past N loads the block's first one again: every
      // box is multiplied (no branch around wgmma), none past N stored
      const uint32_t full = bar_full + 8 * st;
      mbar_expect_tx(full, NB * kBox);
#pragma unroll
      for (int b = 0; b < NB; ++b)
        tma_load_3d(sa + kBox * (1 + b), map, full,
                    n0 + 64 * b < a.N ? n0 + 64 * b : n0, kt * kBlockK, e);
    }
  };

  float acc[NB * 32];  // box b's accumulators: acc[32 b ..]
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) acc[i] = 0.f;

  // k-step kt's rows are cp.async group kt (kt < kStages) or kt + 1 (an
  // empty group at kt = 0 keeps one group an iteration)
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < nk) load(s);
    else cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kStages;
    const uint32_t sa = base + st * S::bytes;
    cp_async_wait<kStages - 2>();  // this thread's rows of k-step kt
    // the rows' generic-proxy writes, visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    mbar_wait(bar_full + 8 * st, (kt / kStages) & 1);
    fence_regs<NB * 32>(acc);
    wgmma_fence();
    // k-step kk: A 32 bytes further along its swizzled rows (8-row groups
    // 1024 apart); B 16 k rows (2048 bytes) further (MN-major: k rows
    // 128 bytes apart, 8-row groups 1024)
    const uint64_t da = smem_desc(sa, 16, 1024, 1);
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const uint64_t db = smem_desc(sa + kBox * (1 + b), kBox, 1024, 1);
        wgmma_ss_n64_bt(acc + 32 * b, da + ((32 * kk) >> 4),
                        db + ((2048 * kk) >> 4));
      }
    }
    wgmma_commit();
    // k-step kt runs on while k-step kt - 1's stage is refilled
    wgmma_wait<1>();
    fence_regs<NB * 32>(acc);
    __syncthreads();  // every warp is done with k-step kt - 1
    if (kt >= 1 && kt - 1 + kStages < nk) load(kt - 1 + kStages);
    else cp_async_commit();
  }
  wgmma_wait<0>();
  fence_regs<NB * 32>(acc);

  // epilogue: this thread holds rows r0 and r0 + 8, columns 8 i + cq and
  // 8 i + cq + 1 of every 8-column group i of each box
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  OutT* out = static_cast<OutT*>(a.out);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = n0 + 64 * b + 8 * i + cq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r < n_rows && col < a.N)
          store2(out + static_cast<int64_t>(row0 + r) * a.N + col,
                 activate(acc[32 * b + 4 * i + 2 * h], a.act),
                 activate(acc[32 * b + 4 * i + 2 * h + 1], a.act));
      }
    }
  }
}

// ------------------------------------------------------ float32 body --
// grid (max tiles, ceil(N / 64)), block 256: thread (ty, tx) of the
// 16 x 16 grid sums rows ty + 16 i and columns tx + 16 j of the tile.
template <typename OutT>
__device__ __forceinline__ void moe_simt(const MoeArgs& a) {
  __shared__ float as[kSimtK][kBlockM + 4];
  __shared__ float bs[kSimtK][64];
  const int tile = blockIdx.x;
  if (tile >= *a.n_tiles) return;
  const int e = a.tile_expert[tile];
  const int row0 = a.tile_row0[tile];
  const int n_rows = min(kBlockM, a.ends[e] - row0);
  const int n0 = blockIdx.y * 64;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const float* src[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = ty + 16 * j;
    src[j] = nullptr;
    if (r < n_rows) {
      const int64_t row = a.rows != nullptr ? a.rows[row0 + r] : row0 + r;
      src[j] = static_cast<const float*>(a.a) + row * a.K;
    }
  }
  const float* w = static_cast<const float*>(a.w) +
                   static_cast<int64_t>(e) * a.K * a.N;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < a.K; k0 += kSimtK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx;
      as[tx][ty + 16 * j] = src[j] != nullptr && k < a.K ? src[j][k] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = tid + kSimtThreads * j;
      const int k = k0 + idx / 64;
      const int col = n0 + idx % 64;
      bs[idx / 64][idx % 64] =
          k < a.K && col < a.N ? w[static_cast<int64_t>(k) * a.N + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSimtK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  OutT* out = static_cast<OutT*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (r < n_rows && col < a.N)
        store1(out + static_cast<int64_t>(row0 + r) * a.N + col,
               activate(acc[i][j], a.act));
    }
  }
}

// One __global__: the input dtype picks the body.
template <typename In, typename Out_, int BN_>
struct MoeCfg {
  using Out = Out_;
  static constexpr bool tensor_cores = std::is_same<In, __nv_bfloat16>::value;
  static constexpr int BN = tensor_cores ? BN_ : 64;
  static constexpr int threads = tensor_cores ? 128 : kSimtThreads;
};

template <typename Cfg>
__global__ void __launch_bounds__(Cfg::threads)
moe_gemm_kernel(const MoeArgs a, const __grid_constant__ CUtensorMap map) {
  if constexpr (Cfg::tensor_cores) {
    moe_wgmma<Cfg::BN, typename Cfg::Out>(a, &map);
  } else {
    moe_simt<typename Cfg::Out>(a);
  }
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

// A 3-D map over a contiguous bf16 (E, K, N) weight stack, dims innermost
// first (N, K, E): boxes of 64 columns x 64 k rows of one expert (128-byte
// swizzle). Columns past N and rows past K read as 0.
cudaError_t expert_map(CUtensorMap* map, const void* w, int E, int K, int N) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t row = static_cast<cuuint64_t>(N) * 2;
  const cuuint64_t strides[2] = {row, row * K};
  const cuuint32_t box[3] = {64, kBlockK, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename In, typename Out, int BN>
int launch(const MoeArgs& a, int E, int max_tiles, cudaStream_t stream) {
  using Cfg = MoeCfg<In, Out, BN>;
  static size_t reserved = 0;
  CUtensorMap map{};
  size_t bytes = 0;
  if constexpr (Cfg::tensor_cores) {
    bytes = Stage<Cfg::BN / 64>::smem;
    const cudaError_t e = expert_map(&map, a.w, E, a.K, a.N);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const cudaError_t e = reserve_smem(moe_gemm_kernel<Cfg>, bytes, &reserved);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(max_tiles, (a.N + Cfg::BN - 1) / Cfg::BN);
  moe_gemm_kernel<Cfg><<<grid, Cfg::threads, bytes, stream>>>(a, map);
  return static_cast<int>(cudaGetLastError());
}

template <typename In, typename Out>
int launch_bn(const MoeArgs& a, int E, int max_tiles, int wide,
              cudaStream_t stream) {
  return wide ? launch<In, Out, 128>(a, E, max_tiles, stream)
              : launch<In, Out, 64>(a, E, max_tiles, stream);
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype and out_dtype: 0 float32,
// 1 bfloat16 (float32 input: float32 output only); act 0 none, 1 relu2; wide: 128 output columns a block (the
// bf16 body; else 64). The launcher enqueues on the caller's stream,
// never synchronises, and returns cudaGetLastError() (or the error that
// stopped the launch).
extern "C" {

int laimr_moe_gemm(const void* a, const int64_t* rows, const void* w,
                   void* out, const int32_t* tile_expert,
                   const int32_t* tile_row0, const int32_t* ends,
                   const int32_t* n_tiles, int dtype, int out_dtype, int act,
                   int E, int K, int N, int max_tiles, int wide,
                   void* stream) {
  if (E < 1 || K < 8 || N < 8 || K % 8 != 0 || N % 8 != 0 || max_tiles < 0 ||
      act < 0 || act > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (max_tiles == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const MoeArgs args{a, rows, w, out, tile_expert, tile_row0, ends, n_tiles,
                     K, N, act};
  if (dtype == 1 && out_dtype == 1)
    return launch_bn<__nv_bfloat16, __nv_bfloat16>(args, E, max_tiles, wide,
                                                   st);
  if (dtype == 1 && out_dtype == 0)
    return launch_bn<__nv_bfloat16, float>(args, E, max_tiles, wide, st);
  if (dtype == 0 && out_dtype == 0)
    return launch<float, float, 64>(args, E, max_tiles, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* laimr_moe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
