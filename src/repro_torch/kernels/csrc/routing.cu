// Hand-written Hopper (sm_90a) kernels for the LA-IMR windowed routing path.
//
// routing_score_kernel replaces the TPU kernel
//   src/repro/kernels/routing_score.py : routing_score (_kernel)
// routing_guard_kernel replaces the TPU kernel
//   src/repro/kernels/routing_decide.py : routing_guard (_guard_kernel)
// routing_topk_kernel and routing_attain_kernel replace
//   src/repro/kernels/routing_decide.py : routing_topk (_topk_kernel) and
//   routing_attain (_attain_kernel).
// routing_score_kernel, routing_topk_kernel and routing_attain_kernel share
// one body, whose note is above it; routing_guard's note is above that
// kernel.
//
// What bounds them on an H100: bytes and launch latency. A window of R
// decisions over I candidates reads R (or R*I) rates, seven f32 columns
// of I entries, and two entries of one (I, T=65) Erlang-wait table row
// per (request, candidate); it does ~40 flops per pair and writes 9 bytes
// per request. At the main path's I = 2..4 the whole table is a few KB,
// so a launch is a few microseconds of launch overhead around almost no
// work; at fleet scale (R = 4096, I = 1024) the (R, I) rate and SLO rows
// are 33.5 MB streamed from HBM, and scoring each pair (two IEEE
// divisions, an accurate logf and expf, two dependent table gathers) is
// about as long in instructions as the stream takes.
//
// Shared by all four kernels:
//  * the TPU kernel's hat-function contraction over all T grid points is
//    rewritten as the two entries that bracket rho: every other hat
//    weight is exactly 0 and adding zeros is exact, so the two-term sum
//    equals the full sum bit for bit;
//  * routing_guard scores only each row's home and upstream columns, O(R)
//    work where the TPU kernel scored all I candidates of every row: each
//    g[r, i] is independent, so the outputs are the same.
//
// Arithmetic follows the TPU kernels: pow as exp(gamma * log(x)), float32
// constants, no fused multiply-add (built with -fmad=false; the explicit
// __f*_rn intrinsics pin the rounding of each step regardless), and the
// accurate expf/logf/erff (never --use_fast_math). Every kernel computes g
// with the same pieces (proc_time, grid_pos, grid_j, grid_wait) in the
// same order, so g is the same bits in all of them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;       // argmin key mask (routing_score.py BIG)
constexpr float kUnstable = 1e9f;   // router.BIG: unstable-pool sentinel
constexpr float kNear = 1.00001f;   // float32(1 + 1e-5): the near band
constexpr float kEps = 1e-9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;   // "no column" in the argmin reductions
constexpr int kMaxK = 8;            // routing_decide.K_MAX
constexpr float kAttainBand = 1e-6f;
constexpr float kSqrt2 = 1.41421356237309515f;  // float32(sqrt(2))

// the row kernels (routing_score.row_plan mirrors these)
constexpr int kNarrowThreads = 256;   // a block of rows of I <= 32
constexpr int kWideThreads = 512;     // a block of wider rows, a warp each
constexpr int kTile = 1024;           // candidates whose columns are staged
constexpr int kSmemMax = 227 * 1024;  // dynamic shared bytes a block may have
constexpr int kBatch = 2;             // candidates a lane scores at once
constexpr int kMaxDevices = 64;       // launch state kept per device

// routing_guard (routing_decide.GUARD_STAGE_MAX mirrors kGuardStageMax)
constexpr int kGuardThreads = 128;
constexpr int kGuardRow = 8;          // (R, I) rate rows read whole up to I 8
constexpr int kGuardStageMax = 32;    // candidates a block stages, at most
constexpr int kGuardSmemMax = 48 * 1024;

// ---- PTX: cp.async ---------------------------------------------------------
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// ---------------------------------------------------------------------------

struct Cols {
  const float* alpha;
  const float* beta;
  const float* gamma;
  const float* mu;
  const float* n;
  const float* rtt;
};

// Processing time alpha + beta * (lam / n1)^gamma at rate lam, the power
// as exp(gamma * log(x)); n1 = max(n, 1); alpha where lam <= 0. kSelect
// computes the power whatever lam and selects, with no branch, so the
// candidates of a batch interleave (the row kernels); otherwise it
// branches (routing_guard). The operations, and so the bits, are the same.
template <bool kSelect>
__device__ __forceinline__ float proc_time(float lam, float n1, float alpha,
                                           float beta, float gamma) {
  const float lam_tilde = __fdiv_rn(lam, n1);
  if (kSelect || lam_tilde > 0.0f) {
    const float e = expf(__fmul_rn(gamma, logf(fmaxf(lam_tilde, 1e-20f))));
    const float proc = __fadd_rn(alpha, __fmul_rn(beta, e));
    return lam_tilde > 0.0f ? proc : alpha;
  }
  return alpha;
}

// rho's position on the table's t-point grid over [0, 1], and the grid
// point j at or below it.
__device__ __forceinline__ float grid_pos(float rho, int t) {
  return __fmul_rn(fminf(fmaxf(rho, 0.0f), 1.0f), static_cast<float>(t - 1));
}

__device__ __forceinline__ int grid_j(float pos, int t) {
  const int j = static_cast<int>(floorf(pos));
  return j > t - 1 ? t - 1 : j;
}

// The Erlang wait at pos from its two bracketing table entries q0 =
// row[j] and q1 = row[j + 1] (not read, and unused, when j + 1 == t).
__device__ __forceinline__ float grid_wait(float pos, int j, int t, float q0,
                                           float q1) {
  const float w0 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(
                                   pos, static_cast<float>(j)))));
  float q = __fmul_rn(w0, q0);
  if (j + 1 < t) {
    const float w1 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(
                                     pos, static_cast<float>(j + 1)))));
    q = __fadd_rn(q, __fmul_rn(w1, q1));
  }
  return q;
}

// A float from shared memory (kShared) or, read-only, from device memory.
template <bool kShared>
__device__ __forceinline__ float ld(const float* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// Predicted latency g of candidate i at rate lam, and its rho, from the
// columns and table in device memory, or staged in shared memory
// (routing_guard).
template <bool kShared>
__device__ __forceinline__ float score(const Cols& c,
                                       const float* __restrict__ table,
                                       int t, int i, float lam, float* rho) {
  const float n = ld<kShared>(c.n + i);
  const float proc =
      proc_time<false>(lam, fmaxf(n, 1.0f), ld<kShared>(c.alpha + i),
                       ld<kShared>(c.beta + i), ld<kShared>(c.gamma + i));
  const float r =
      __fdiv_rn(lam, fmaxf(__fmul_rn(n, ld<kShared>(c.mu + i)), 1e-12f));
  const float pos = grid_pos(r, t);
  const int j = grid_j(pos, t);
  const float* row = table + static_cast<size_t>(i) * t;
  const float q1 = j + 1 < t ? ld<kShared>(row + j + 1) : 0.0f;
  *rho = r;
  return __fadd_rn(__fadd_rn(proc, ld<kShared>(c.rtt + i)),
                   grid_wait(pos, j, t, ld<kShared>(row + j), q1));
}

// Delivery-weighted SLO-attainment probability of one candidate:
// avail * Phi((ln slo - ln g) / (sigma * sqrt2)), or avail * (g <= slo)
// when sigma <= 0 (a step).
__device__ __forceinline__ float attain_p(float g, float slo, float sigma,
                                          float avail) {
  float phi;
  if (sigma > 0.0f) {
    const float z = __fdiv_rn(
        __fsub_rn(logf(fmaxf(slo, 1e-20f)), logf(fmaxf(g, 1e-20f))),
        __fmul_rn(fmaxf(sigma, 1e-20f), kSqrt2));
    phi = __fmul_rn(0.5f, __fadd_rn(1.0f, erff(fminf(fmaxf(z, -10.0f),
                                                     10.0f))));
  } else {
    phi = g <= slo ? 1.0f : 0.0f;
  }
  return __fmul_rn(avail, phi);
}

// Argmin of (key, column) over each segment of `lanes` adjacent lanes (a
// power of two up to 32; 1 reduces nothing), ties to the lowest column
// (the first occurrence, as jnp.argmin); g rides along with the winner.
// Every lane of the warp must call it.
__device__ __forceinline__ void seg_argmin(float& key, int& col, float& g,
                                           int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    const float ok = __shfl_xor_sync(kFull, key, off, lanes);
    const int oc = __shfl_xor_sync(kFull, col, off, lanes);
    const float og = __shfl_xor_sync(kFull, g, off, lanes);
    if (ok < key || (ok == key && oc < col)) {
      key = ok;
      col = oc;
      g = og;
    }
  }
}

// Argmax of p over each segment, ties to the lower g, then the lower
// column: the lowest (g, column) among the columns that attain the max.
__device__ __forceinline__ void seg_argmax_p(float& p, float& g, int& col,
                                             int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    const float op = __shfl_xor_sync(kFull, p, off, lanes);
    const float og = __shfl_xor_sync(kFull, g, off, lanes);
    const int oc = __shfl_xor_sync(kFull, col, off, lanes);
    if (op > p || (op == p && (og < g || (og == g && oc < col)))) {
      p = op;
      g = og;
      col = oc;
    }
  }
}

__device__ __forceinline__ float seg_min(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, off, lanes));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ bool seg_any(bool v, int lanes) {
  int x = v ? 1 : 0;
  for (int off = lanes >> 1; off > 0; off >>= 1)
    x |= __shfl_xor_sync(kFull, x, off, lanes);
  return x != 0;
}

// ---------------------------------------------------------------------------
// routing_score_kernel / routing_topk_kernel / routing_attain_kernel:
// route_best's decision; for routing_topk the k - 1 redundant-dispatch
// columns after it; for routing_attain (reliable) the attainment-argmax
// primary and the same duplicates. One body, decide_rows, with a mode.
//
// What held the first design back (one warp per row, every pass
// rescoring): at fleet scale it was 9.5x (score), 17x (topk) and 14x
// (attain) its byte bound, because each pass scored every pair again (2
// passes for score, 1 + k for topk, 2 + (k - 1) for attain, whose first
// two passes also evaluated the attainment probability, two logf, a
// division and an erff, for every feasible pair), each score a chain of a
// rate load, arithmetic and two dependent gathers walked one candidate at
// a time, and 7 (attain 8) column loads per pair repeated by every row;
// at I = 2..4, 28 of a warp's 32 lanes idled.
//
// What this design does:
//  * lanes fit I. A row of I <= 32 candidates gets L lanes, the power of
//    two >= I, one candidate a lane, in blocks of 256 threads: a warp
//    decides 8 to 16 rows at the main path's I = 2..4. A wider row gets a
//    warp, 16 rows a block of 512, and each lane holds groups of four
//    adjacent candidates (lane s: columns 128 q + 4 s .. 128 q + 4 s + 3
//    of group q), ceil(I / 128) groups, a count known only at run time.
//    The L lanes of a row reduce with width-L shuffles. The wrapper's
//    plan (routing_score.row_plan) is checked against I before launch;
//  * each pair is scored once: pass 1 writes g to the row's cache, at the
//    column's place, and a flag byte per group (bits 0-3 feasible, 4-7
//    eligible for a duplicate); the primary's pass and each duplicate
//    pass read only these, never the rows again. A lane reads back only
//    what it wrote, so the cache needs no barrier (attain's wide rows
//    excepted, below). It lives in shared memory, or, where 16 rows of it
//    do not fit there (I > 2944; attain I > 1408), in a device scratch
//    that the wrapper keeps per device and stream;
//  * attain: pass 1 also evaluates each feasible pair's attainment
//    probability p once, caches it beside g, and reduces the row's
//    maximum with the lowest (g, column) that attains it. That pair is in
//    the 1e-6 band, so pass 2 starts from it and reads p only for feasible
//    pairs below it. Two things keep p's cost near the pairs that need
//    it. In a warp of lanes that each held their own pairs, one feasible
//    lane made the whole warp evaluate p, so in wide rows the row's 32
//    lanes take a group's feasible pairs in turn, through a list of 128
//    ints a row in shared memory (a __syncwarp on each side). And p =
//    avail * Phi <= max(avail, 0), so a pair whose bound is below the
//    row's running maximum less the band can be neither the maximum nor
//    in the band: its p is not evaluated and caches as -BIG. p keeps
//    attain_p's operations in their order, so every decision keeps the
//    first design's bits. attain scores one candidate at a time (two
//    spilled in the wide body);
//  * duplicates come out in ascending (g, column) order over feasible &
//    g <= slo - margin & column != primary: pass j takes the segment
//    argmin above the (g, column) pair pass j - 1 chose, which is the
//    stable ascending-g sort of the eligible set (ref._dup_order);
//  * loads: the block stages the candidate columns in shared memory by
//    cp.async (attain: sigma and avail too), a tile of up to 1024
//    candidates at a time (once a launch when a row fits in one tile),
//    and forms max(n, 1) and max(n mu, 1e-12) there; cost, which only
//    near-band candidates need, is read from device memory (staging it
//    too made the fleet's block 4 KB larger and the kernel a third
//    slower). A group's rates and SLOs load as one 16-byte vector each
//    where the rows are aligned and I % 4 == 0 (scalar loads otherwise),
//    and the table gathers of kBatch = 2 candidates start before their
//    exp/log. Warps, not registers, hide the latency: two 512-thread
//    blocks an SM hold 32 warps at the 64 registers a thread this leaves
//    (attain's wide block, with p's cache, is 180,224 B at I 1024, one an
//    SM; without the cache two fit and pass 2 re-evaluates p, which read
//    4-10% faster at the fleet shape on an H100, but that body spilled);
//  * blocks are persistent (no more than fit on the card at once) and
//    walk row groups.
// What bounds it now: instructions and latency, not bytes. A pair's two
// IEEE divisions each sit in a slow-path region of their own that the
// scheduler cannot cross, beside the accurate logf and expf and the
// table's addressing; taking out the row loads, the table gathers or
// exp/log each left most of the time in place. attain adds two logf, a
// division and an erff for each pair whose p it evaluates, and its wide
// body's one block an SM.
// ---------------------------------------------------------------------------

enum class Mode { kScore, kTopk, kAttain };

// the staged column planes, tile floats each: the law's six columns (n
// and mu as max(n, 1) and max(n mu, 1e-12)), a shared (I,) SLO row, and
// for attain sigma and avail
enum Plane { kAlpha, kBeta, kGamma, kN1, kNMu, kRtt, kSlo, kSigma, kAvail };

__host__ __device__ constexpr int planes_of(Mode m) {
  return m == Mode::kAttain ? 9 : 7;
}

// floats a row caches a column: g, and for attain p beside it
__host__ __device__ constexpr int cache_floats(Mode m) {
  return m == Mode::kAttain ? 2 : 1;
}

// One launch of a row kernel.
struct Decide {
  const float* lam;       // (R,) shared rate: rs 1, cs 0; (R, I): rs I, cs 1
  int lam_rs, lam_cs;
  Cols c;
  const float* cost;      // (I,) score, topk
  const float* sigma;     // (I,) attain
  const float* avail;     // (I,) attain
  const float* slo;       // (I,) shared: rs 0; (R, I): rs I
  int slo_rs;
  const float* table;     // (I, T)
  int R, I, T, k;
  float margin;
  int lanes;              // lanes per row
  int rows;               // rows per block
  int groups;             // candidate groups a lane (1 for I <= 32)
  int lam_vec, slo_vec;   // the rows load as float4
  float* scratch;         // the g cache and flags when not in shared memory
  int32_t* idx;           // (R,) or (R, k)
  float* g;               // (R,) or (R, k)
  uint8_t* ok;            // (R,)
};

// What pass 1 folds over a lane's columns.
struct RowAcc {
  float gmin = kBig;       // feasible g minimum (score, topk)
  float geff_min = kBig;   // g, the sentinel where rho >= 1 (topk, attain)
  bool any = false;        // a feasible column
  float pmax = -1.0f;      // attain: the feasible attainment maximum (-1
  float gbest = kBig;      // when none) and the lowest (g, column) that
  int cbest = kNone;       // attains it
};

// The row's column held in slot e of lane s's group q, G adjacent
// candidates a group.
template <int G>
__device__ __forceinline__ int slot_col(int q, int s, int e, int lanes) {
  return (q * lanes + s) * G + e;
}

// Stage candidates [base, base + tile) of the columns into the shared
// planes; entries past I stay unset and are never used.
template <Mode M>
__device__ __forceinline__ void stage_columns(const Decide& a, float* sm,
                                              int tile, int base) {
  const int n = min(tile, a.I - base);
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    const int i = base + x;
    cp_async4(sm + kAlpha * tile + x, a.c.alpha + i);
    cp_async4(sm + kBeta * tile + x, a.c.beta + i);
    cp_async4(sm + kGamma * tile + x, a.c.gamma + i);
    cp_async4(sm + kN1 * tile + x, a.c.n + i);
    cp_async4(sm + kNMu * tile + x, a.c.mu + i);
    cp_async4(sm + kRtt * tile + x, a.c.rtt + i);
    if (a.slo_rs == 0) cp_async4(sm + kSlo * tile + x, a.slo + i);
    if constexpr (M == Mode::kAttain) {
      cp_async4(sm + kSigma * tile + x, a.sigma + i);
      cp_async4(sm + kAvail * tile + x, a.avail + i);
    }
  }
  cp_async_wait_all();
  // the column-only parts of the law, once per candidate, by the thread
  // whose copies they are
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    const float nn = sm[kN1 * tile + x];
    sm[kNMu * tile + x] = fmaxf(__fmul_rn(nn, sm[kNMu * tile + x]), 1e-12f);
    sm[kN1 * tile + x] = fmaxf(nn, 1.0f);
  }
  __syncthreads();
}

// H adjacent floats from p: one 16- or 8-byte read when H is 4 or 2 (the
// wide layout keeps such runs aligned).
template <int H>
__device__ __forceinline__ void run_vals(const float* p, float (&v)[H]) {
  if constexpr (H == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (H == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int u = 0; u < H; ++u) v[u] = p[u];
  }
}

// A group's G values of one rate or SLO row from column x on (0 past I):
// one 16-byte load when vec says the row allows it (I % 4 == 0, so a
// group is valid as a whole).
template <int G>
__device__ __forceinline__ void row_vals(const float* row, int vec, int x,
                                         int I, float (&v)[G]) {
  if constexpr (G == 4) {
    if (vec) {
      const float4 q = x < I
          ? __ldg(reinterpret_cast<const float4*>(row + x))
          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
      return;
    }
  }
#pragma unroll
  for (int u = 0; u < G; ++u) v[u] = x + u < I ? __ldg(row + x + u) : 0.0f;
}

// Score the H candidates from column x on (tile-local column xl; rates
// lam, SLOs slo): write g to the cache, set their flag bits from bit e
// (feasible) and e + 4 (eligible), and fold the row's reductions into
// acc: the feasible g minimum and any feasible (every mode), the minimum
// of g with the sentinel where rho >= 1 over every column (topk, attain),
// and each feasible pair's attainment probability (attain).
template <int H, Mode M, bool kSlotP>
__device__ __forceinline__ void score_slots(
    const Decide& a, const float* sm, int tile, int x, int xl, int e,
    const float (&lam)[H], const float (&slo)[H], float* cache,
    float* pcache, unsigned& bits, RowAcc& acc) {
  bool valid[H];
  float nmu[H], rho[H], pos[H], q0[H], q1[H];
  int j[H];
  run_vals<H>(sm + kNMu * tile + xl, nmu);
#pragma unroll
  for (int u = 0; u < H; ++u) {
    valid[u] = x + u < a.I;
    rho[u] = __fdiv_rn(lam[u], nmu[u]);
    pos[u] = grid_pos(rho[u], a.T);
    j[u] = grid_j(pos[u], a.T);
    const float* p = a.table + static_cast<size_t>(x + u) * a.T + j[u];
    q0[u] = valid[u] ? __ldg(p) : 0.0f;
    q1[u] = valid[u] && j[u] + 1 < a.T ? __ldg(p + 1) : 0.0f;
  }
  float g[H], n1[H], alpha[H], beta[H], gamma[H], rtt[H];
  run_vals<H>(sm + kN1 * tile + xl, n1);
  run_vals<H>(sm + kAlpha * tile + xl, alpha);
  run_vals<H>(sm + kBeta * tile + xl, beta);
  run_vals<H>(sm + kGamma * tile + xl, gamma);
  run_vals<H>(sm + kRtt * tile + xl, rtt);
#pragma unroll
  for (int u = 0; u < H; ++u) {
    const float proc =
        proc_time<true>(lam[u], n1[u], alpha[u], beta[u], gamma[u]);
    g[u] = __fadd_rn(__fadd_rn(proc, rtt[u]),
                     grid_wait(pos[u], j[u], a.T, q0[u], q1[u]));
    const bool f = valid[u] && rho[u] < 1.0f && g[u] <= slo[u];
    if (f) {
      acc.gmin = fminf(acc.gmin, g[u]);
      acc.any = true;
      bits |= 1u << (e + u);
    }
    if constexpr (M != Mode::kScore) {
      if (valid[u])
        acc.geff_min = fminf(acc.geff_min, rho[u] < 1.0f ? g[u] : kUnstable);
      if (f && g[u] <= __fsub_rn(slo[u], a.margin)) bits |= 16u << (e + u);
    }
  }
  if constexpr (H == 2) {
    *reinterpret_cast<float2*>(cache + x) = make_float2(g[0], g[1]);
  } else {
#pragma unroll
    for (int u = 0; u < H; ++u) cache[x + u] = g[u];
  }
  if constexpr (kSlotP) {
    // after the batch's g, so that its gathers' state is dead; the lane's
    // columns come in ascending order, so ties keep the first
#pragma unroll
    for (int u = 0; u < H; ++u) {
      if ((bits >> (e + u)) & 1u) {
        const float p = attain_p(g[u], slo[u], sm[kSigma * tile + xl + u],
                                 sm[kAvail * tile + xl + u]);
        pcache[x + u] = p;
        if (p > acc.pmax || (p == acc.pmax && g[u] < acc.gbest)) {
          acc.pmax = p;
          acc.gbest = g[u];
          acc.cbest = x + u;
        }
      }
    }
  }
}

// Pass 1 for group q of lane s, whose columns are staged in the tile from
// column base on: load its rates and SLOs, score it kBatch candidates at
// a time, and write its flag byte.
template <int G, Mode M>
__device__ __forceinline__ void score_group(
    const Decide& a, const float* sm, int tile, int base, int q, int s,
    const float* lam_row, const float* slo_row, float lam_one, float* cache,
    float* pcache, uint8_t* flags, RowAcc& acc) {
  // attain scores one candidate at a time (two spilled in the wide body)
  constexpr int H = M == Mode::kAttain ? 1 : (G < kBatch ? G : kBatch);
  // attain: a lane evaluates p for its own feasible columns in narrow rows;
  // wide rows share the group's among the row's lanes (attain_group)
  constexpr bool kSlotP = M == Mode::kAttain && G == 1;
  const int x = slot_col<G>(q, s, 0, a.lanes);
  float lam[G], slo[G];
  if (a.lam_cs == 0) {
#pragma unroll
    for (int u = 0; u < G; ++u) lam[u] = lam_one;
  } else {
    row_vals<G>(lam_row, a.lam_vec, x, a.I, lam);
  }
  if (a.slo_rs == 0) {
    run_vals<G>(sm + kSlo * tile + x - base, slo);
  } else {
    row_vals<G>(slo_row, a.slo_vec, x, a.I, slo);
  }
  unsigned bits = 0u;
#pragma unroll
  for (int h = 0; h < G; h += H) {
    float lh[H], sh[H];
#pragma unroll
    for (int u = 0; u < H; ++u) {
      lh[u] = lam[h + u];
      sh[u] = slo[h + u];
    }
    score_slots<H, M, kSlotP>(a, sm, tile, x + h, x + h - base, h, lh, sh,
                              cache, pcache, bits, acc);
  }
  flags[q * a.lanes + s] = static_cast<uint8_t>(bits);
}

// Pass 2 of score / topk over the lane's cache: the cheapest candidate
// inside the near band, lowest column on ties; every other column keys at
// BIG, so a row with nothing near yields its lowest column.
template <int G>
__device__ __forceinline__ void primary_pass(const Decide& a, int s,
                                             int groups, const float* cache,
                                             const uint8_t* flags,
                                             float edge, float& key,
                                             int& col, float& g) {
#pragma unroll 1
  for (int q = 0; q < groups; ++q) {
    const unsigned feas = flags[q * a.lanes + s];
    const int x = slot_col<G>(q, s, 0, a.lanes);
    float v[G];
    run_vals<G>(cache + x, v);
#pragma unroll
    for (int e = 0; e < G; ++e) {
      const int i = x + e;
      if (i < a.I) {
        float k = kBig;
        if (((feas >> e) & 1u) && v[e] <= edge) k = __ldg(a.cost + i);
        if (k < key || (k == key && i < col)) {
          key = k;
          col = i;
          g = v[e];
        }
      }
    }
  }
}

// Attain, wide rows, right after pass 1 of group q (whose columns are in
// the staged tile from column base on): each feasible pair's p, cached
// beside its g and folded into acc, but only where it can reach the band:
// p = avail * Phi <= max(avail, 0), so a pair whose bound is below the
// row's running maximum less the band (cut) is neither the maximum nor in
// the band, and its p is not evaluated (cached as -BIG). The row's 32
// lanes take the remaining pairs in turn, through the row's list in
// shared memory in ascending column order, so a warp evaluates p about as
// often as pairs need it, not whenever one of its lanes holds one.
__device__ __forceinline__ void attain_group(
    const Decide& a, const float* sm, int tile, int base, int q, int s,
    const float* slo_row, const float* cache, float* pcache,
    const uint8_t* flags, int* list, float cut, RowAcc& acc) {
  const unsigned feas = flags[q * 32 + s] & 15u;
  const int x = slot_col<4>(q, s, 0, 32);
  unsigned m = 0u;   // the lane's pairs that need p
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if ((feas >> e) & 1u) {
      if (fmaxf(sm[kAvail * tile + x + e - base], 0.0f) >= cut)
        m |= 1u << e;
      else
        pcache[x + e] = -kBig;
    }
  }
  const int cnt = __popc(m);
  int pre = cnt;   // inclusive prefix of the counts over the row's lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, pre, off);
    if (s >= off) pre += o;
  }
  const int total = __shfl_sync(kFull, pre, 31);
  pre -= cnt;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if ((m >> e) & 1u) list[pre++] = x + e;
  __syncwarp();   // the list, and the g other lanes cached
  for (int t = s; t < total; t += 32) {
    const int i = list[t];
    const int xl = i - base;
    const float g = cache[i];
    const float slo =
        a.slo_rs == 0 ? sm[kSlo * tile + xl] : __ldg(slo_row + i);
    const float p =
        attain_p(g, slo, sm[kSigma * tile + xl], sm[kAvail * tile + xl]);
    pcache[i] = p;
    // a lane's columns come in ascending order: ties keep the first
    if (p > acc.pmax || (p == acc.pmax && g < acc.gbest)) {
      acc.pmax = p;
      acc.gbest = g;
      acc.cbest = i;
    }
  }
  __syncwarp();   // the list is the next group's
}

// Pass 2 of attain over the lane's cache: the lowest (g, column) among
// the feasible columns whose p is at least floor_p, starting from (key,
// col), the lowest pair that attains pmax, so only feasible columns below
// it read their p.
template <int G>
__device__ __forceinline__ void attain_pass(const Decide& a, int s,
                                            int groups, const float* cache,
                                            const float* pcache,
                                            const uint8_t* flags,
                                            float floor_p, float& key,
                                            int& col) {
#pragma unroll 1
  for (int q = 0; q < groups; ++q) {
    const unsigned feas = flags[q * a.lanes + s] & 15u;
    if (feas == 0u) continue;
    const int x = slot_col<G>(q, s, 0, a.lanes);
    float v[G];
    run_vals<G>(cache + x, v);
#pragma unroll
    for (int e = 0; e < G; ++e) {
      const int i = x + e;
      if (((feas >> e) & 1u) && (v[e] < key || (v[e] == key && i < col)) &&
          pcache[i] >= floor_p) {
        key = v[e];
        col = i;
      }
    }
  }
}

// One duplicate pass over the lane's cache: the lowest (g, column) among
// the eligible columns other than the primary and above (last_g, last_i).
template <int G>
__device__ __forceinline__ void dup_pass(int s, int lanes, int groups,
                                         const float* cache,
                                         const uint8_t* flags, int primary,
                                         float last_g, int last_i,
                                         float& key, int& col) {
#pragma unroll 1
  for (int q = 0; q < groups; ++q) {
    const unsigned elig = flags[q * lanes + s] >> 4;
    if (elig == 0u) continue;
    const int x = slot_col<G>(q, s, 0, lanes);
    float v[G];
    run_vals<G>(cache + x, v);
#pragma unroll
    for (int e = 0; e < G; ++e) {
      const int i = x + e;
      if (((elig >> e) & 1u) && i != primary &&
          (v[e] > last_g || (v[e] == last_g && i > last_i)) &&
          (v[e] < key || (v[e] == key && i < col))) {
        key = v[e];
        col = i;
      }
    }
  }
}

// G = 1: rows of I <= 32, a candidate a lane; G = 4: wider rows, a warp a
// row, groups of four adjacent candidates a lane.
template <int G, Mode M>
__device__ __forceinline__ void decide_rows(const Decide& a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int lanes = a.lanes;
  const int shift = __ffs(lanes) - 1;
  const int s = threadIdx.x & (lanes - 1);
  const int w = threadIdx.x >> shift;            // the block's row
  const int groups = G == 1 ? 1 : a.groups;
  const int len = groups * lanes * G;            // the row cache's floats
  const int tile = min(len, kTile);              // candidates staged
  const int per_tile = tile / (lanes * G);       // groups a tile
  const int tiles = (groups + per_tile - 1) / per_tile;
  const int flag_len = groups * lanes;           // flag bytes a row
  const int planes = planes_of(M) * tile;        // staged floats
  const int clen = len * cache_floats(M);        // a row's cached floats
  // attain's wide rows: a group's feasible columns (attain_group)
  constexpr bool kList = M == Mode::kAttain && G == 4;
  const int list_len = kList ? lanes * G : 0;
  int* list = reinterpret_cast<int*>(sm + planes) + w * list_len;
  // the row's cache (g, then attain's p) and flags: after the planes and
  // lists in shared memory, or a slot per resident row of the scratch (the
  // caches of every slot, then the flags of every slot), set in the row
  // loop (hoisted, the fleet shape ran 8% slower); narrow rows always fit
  float* rows_sm = sm + planes + a.rows * list_len;
  float* cache = rows_sm + w * clen;
  uint8_t* flags = reinterpret_cast<uint8_t*>(rows_sm + a.rows * clen) +
                   w * flag_len;
  if (tiles == 1) stage_columns<M>(a, sm, tile, 0);

  for (int r0 = blockIdx.x * a.rows; r0 < a.R; r0 += gridDim.x * a.rows) {
    const int r = r0 + w;
    const int rl = min(r, a.R - 1);  // rows past R redo R - 1, write nothing
    if (G == 4 && a.scratch != nullptr) {
      const size_t slots = static_cast<size_t>(gridDim.x) * a.rows;
      const size_t slot = static_cast<size_t>(blockIdx.x) * a.rows + w;
      cache = a.scratch + slot * clen;
      flags = reinterpret_cast<uint8_t*>(a.scratch + slots * clen) +
              slot * flag_len;
    }
    const float* lam_row = a.lam + static_cast<size_t>(rl) * a.lam_rs;
    const float* slo_row = a.slo + static_cast<size_t>(rl) * a.slo_rs;
    const float lam_one = a.lam_cs == 0 ? __ldg(lam_row) : 0.0f;

    // pass 1: score once into the cache
    RowAcc acc;
    float row_pmax = -1.0f;   // attain, wide rows: the maximum so far
    for (int t = 0; t < tiles; ++t) {
      if (tiles > 1) {
        __syncthreads();   // every warp is done with the previous tile
        stage_columns<M>(a, sm, tile, t * tile);
      }
      const int end = min(groups, (t + 1) * per_tile);
#pragma unroll 1
      for (int q = t * per_tile; q < end; ++q) {
        score_group<G, M>(a, sm, tile, t * tile, q, s, lam_row, slo_row,
                          lam_one, cache, cache + len, flags, acc);
        if constexpr (kList) {
          attain_group(a, sm, tile, t * tile, q, s, slo_row, cache,
                       cache + len, flags, list,
                       __fsub_rn(row_pmax, kAttainBand), acc);
          row_pmax = warp_max(acc.pmax);
        }
      }
    }
    const bool any = seg_any(acc.any, lanes);

    // pass 2: the primary from the cache
    float key = kBig, g = 0.0f;
    int col = kNone;
    if constexpr (M == Mode::kAttain) {
      seg_argmax_p(acc.pmax, acc.gbest, acc.cbest, lanes);
      key = acc.gbest;
      col = acc.cbest;
      if (any)
        attain_pass<G>(a, s, groups, cache, cache + len, flags,
                       __fsub_rn(acc.pmax, kAttainBand), key, col);
      g = key;
      seg_argmin(key, col, g, lanes);
      // nothing in the band (only where p < -1): the lowest column
      if (col == kNone) {
        col = 0;
        if (s == 0) g = cache[0];
      }
    } else {
      const float gmin = seg_min(acc.gmin, lanes);
      const float edge = __fadd_rn(__fmul_rn(gmin, kNear), kEps);
      primary_pass<G>(a, s, groups, cache, flags, edge, key, col, g);
      seg_argmin(key, col, g, lanes);
    }
    const bool out = s == 0 && r < a.R;
    if constexpr (M == Mode::kScore) {
      if (out) {
        a.idx[r] = col;
        a.g[r] = g;
        a.ok[r] = any ? 1 : 0;
      }
    } else {
      // column 0: the primary and its g on a feasible row, -1 and the
      // row's g_eff minimum otherwise; then the duplicates, -1 and g 0
      // where none is left
      const float geff_min = seg_min(acc.geff_min, lanes);
      int32_t* idx_row = a.idx + static_cast<size_t>(r) * a.k;
      float* g_row = a.g + static_cast<size_t>(r) * a.k;
      if (out) {
        idx_row[0] = any ? col : -1;
        g_row[0] = any ? g : geff_min;
        a.ok[r] = any ? 1 : 0;
      }
      const int primary = col;
      float last_g = -kBig;
      int last_i = -1;
      bool left = any;   // the same on every lane of the row
      for (int j = 1; j < a.k; ++j) {
        float dk = kBig;
        int di = kNone;
        if (left)
          dup_pass<G>(s, lanes, groups, cache, flags, primary, last_g,
                      last_i, dk, di);
        float dg = dk;
        seg_argmin(dk, di, dg, lanes);
        const bool has = di != kNone;
        if (out) {
          idx_row[j] = has ? di : -1;
          g_row[j] = has ? dg : 0.0f;
        }
        left = has;
        last_g = dg;
        last_i = di;
      }
    }
  }
}

// Two 512-thread blocks an SM: 64 registers a thread.
template <int G>
__global__ void __launch_bounds__(kWideThreads, 2)
    routing_score_kernel(const Decide a) {
  decide_rows<G, Mode::kScore>(a);
}

// ---------------------------------------------------------------------------
// routing_guard_kernel: Algorithm 1's guard, one thread per request row:
// score home, strip its RTT (except from the 1e9 sentinel), offload to
// the upstream column when the rest exceeds tau.
//
// What held the first design back: its time was a chain of dependent
// global round trips, not bytes. A row loaded home, then its rate and six
// columns at home, then rho and the two table entries, and where the
// guard fired the same chain again for the upstream column: three round
// trips on a held row, five on an offloaded one, so R 4096 cost about
// what R 256 did.
//
// What this design does:
//  * a row's loads go out together: home, up, tau and its rates; an (R,
//    I) rate row of I <= 8 is read whole (16-byte vectors where aligned)
//    and the home and upstream rates are selected in registers;
//  * where the block can hold them (I <= 32 and I (T + 6) floats within
//    48 KB; 9,088 bytes at T 65 and I 32), the (I, T) table and the six
//    columns are staged in shared memory by cp.async while the row loads
//    are in flight, so the column reads and the table gathers are
//    shared-memory reads; wider candidate sets read them from device
//    memory;
//  * the upstream column is scored in the same instruction stream as
//    home, its loads in flight beside home's, and selected afterwards
//    (score() is deterministic, so the selected g is the same bits); a
//    row at the top tier (up = -1) scores home twice and reads nothing
//    at -1.
// What bounds it now: the launch itself. On an H100 at the main path's
// R 256 it reads about a microsecond above a one-element fill_ timed the
// same way, as the first design did: one global round trip (two where
// the columns are not staged, three at I > 8) and the block's start and
// end.
// ---------------------------------------------------------------------------

// One launch of routing_guard_kernel.
struct Guard {
  const float* lam;      // (R,) shared rate: rs 1, cs 0; (R, I): rs I, cs 1
  int lam_rs, lam_cs;
  Cols c;
  const float* tau;      // (R,)
  const int32_t* home;   // (R,)
  const int32_t* up;     // (R,), -1 at the top tier
  const float* table;    // (I, T)
  int R, I, T;
  int lam_vec;           // an (R, I) row of I <= kGuardRow loads as float4
  int32_t* idx;
  float* g;
  uint8_t* off;
};

// v[h] for h in [0, kGuardRow), by selects: v stays in registers.
__device__ __forceinline__ float pick(const float (&v)[kGuardRow], int h) {
  float out = v[0];
#pragma unroll
  for (int x = 1; x < kGuardRow; ++x) out = h == x ? v[x] : out;
  return out;
}

// kStaged: the block stages the table (I * T floats) and then the six
// columns (I floats each) in shared memory.
template <bool kStaged>
__global__ void __launch_bounds__(kGuardThreads)
    routing_guard_kernel(const Guard a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int rl = min(r, a.R - 1);  // threads past R load row R - 1
  const int h = __ldg(a.home + rl);
  const int u = __ldg(a.up + rl);
  const float tau = __ldg(a.tau + rl);
  const int uu = u >= 0 ? u : h;   // the upstream column scored
  const float* lam_row = a.lam + static_cast<size_t>(rl) * a.lam_rs;
  float lam_h, lam_u;
  if (a.lam_cs == 0) {
    lam_h = lam_u = __ldg(lam_row);
  } else if (a.I <= kGuardRow) {
    float v[kGuardRow];
    if (a.lam_vec) {
      const float4 q0 = __ldg(reinterpret_cast<const float4*>(lam_row));
      const float4 q1 = a.I > 4
          ? __ldg(reinterpret_cast<const float4*>(lam_row) + 1)
          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[0] = q0.x; v[1] = q0.y; v[2] = q0.z; v[3] = q0.w;
      v[4] = q1.x; v[5] = q1.y; v[6] = q1.z; v[7] = q1.w;
    } else {
#pragma unroll
      for (int x = 0; x < kGuardRow; ++x)
        v[x] = x < a.I ? __ldg(lam_row + x) : 0.0f;
    }
    lam_h = pick(v, h);
    lam_u = pick(v, uu);
  } else {
    lam_h = __ldg(lam_row + h);
    lam_u = __ldg(lam_row + uu);
  }
  Cols c = a.c;
  const float* table = a.table;
  if constexpr (kStaged) {
    const int cells = a.I * a.T;
    for (int x = threadIdx.x; x < cells; x += blockDim.x)
      cp_async4(sm + x, a.table + x);
    float* cs = sm + cells;
    for (int x = threadIdx.x; x < a.I; x += blockDim.x) {
      cp_async4(cs + 0 * a.I + x, a.c.alpha + x);
      cp_async4(cs + 1 * a.I + x, a.c.beta + x);
      cp_async4(cs + 2 * a.I + x, a.c.gamma + x);
      cp_async4(cs + 3 * a.I + x, a.c.mu + x);
      cp_async4(cs + 4 * a.I + x, a.c.n + x);
      cp_async4(cs + 5 * a.I + x, a.c.rtt + x);
    }
    cp_async_wait_all();
    __syncthreads();
    c = Cols{cs, cs + a.I, cs + 2 * a.I, cs + 3 * a.I, cs + 4 * a.I,
             cs + 5 * a.I};
    table = sm;
  }
  if (r >= a.R) return;
  float rho_h, rho_u;
  float g_home = score<kStaged>(c, table, a.T, h, lam_h, &rho_h);
  float g_up = score<kStaged>(c, table, a.T, uu, lam_u, &rho_u);
  if (!(rho_h < 1.0f)) g_home = kUnstable;
  if (!(rho_u < 1.0f)) g_up = kUnstable;
  // controllable latency: strip the home RTT except from the sentinel,
  // which must stay above any tau
  const float g_inst =
      g_home < kUnstable ? __fsub_rn(g_home, ld<kStaged>(c.rtt + h)) : g_home;
  const bool off = g_inst > tau && u >= 0;
  a.idx[r] = off ? u : h;
  a.g[r] = off ? g_up : g_home;
  a.off[r] = off ? 1 : 0;
}

template <int G>
__global__ void __launch_bounds__(kWideThreads, 2)
    routing_topk_kernel(const Decide a) {
  decide_rows<G, Mode::kTopk>(a);
}

template <int G>
__global__ void __launch_bounds__(kWideThreads, 2)
    routing_attain_kernel(const Decide a) {
  decide_rows<G, Mode::kAttain>(a);
}

// What one row-kernel body holds on a device: the dynamic shared bytes it
// is opted in to, and the blocks an SM holds at the shared bytes of its
// last launch. Kept per process and device.
struct BodyState {
  int opt_in = 48 * 1024;   // the default limit needs no opt-in
  int smem = -1;
  int held = 0;
  int sms = 0;
};

// Launch one body: no more blocks than fit on the card at once (each
// walks row groups).
template <int G, Mode M>
int launch_rows(const Decide& a, int smem, cudaStream_t stream) {
  void (*kernel)(const Decide) =
      M == Mode::kScore  ? routing_score_kernel<G>
      : M == Mode::kTopk ? routing_topk_kernel<G>
                         : routing_attain_kernel<G>;
  static BodyState state[kMaxDevices];
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidValue);
  BodyState& st = state[dev];
  if (st.sms == 0) {
    rc = static_cast<int>(cudaDeviceGetAttribute(
        &st.sms, cudaDevAttrMultiProcessorCount, dev));
    if (rc != 0) return rc;
  }
  if (smem > st.opt_in) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (rc != 0) return rc;
    st.opt_in = smem;
  }
  const int threads = a.rows * a.lanes;
  if (smem != st.smem) {
    int held = 0;
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &held, kernel, threads, smem));
    if (rc != 0) return rc;
    st.held = held > 0 ? held : 1;
    st.smem = smem;
  }
  const int groups = (a.R + a.rows - 1) / a.rows;
  const int most = st.held * st.sms;
  const int grid = groups < most ? groups : most;
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Check the wrapper's plan (routing_score.row_plan: lanes, rows per
// block, shared bytes, and a scratch exactly when the cache is not in
// shared memory) against I and the mode's planes, then launch the body it
// names.
template <Mode M>
int launch_plan(Decide a, int smem, cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const bool wide = a.I > 32;
  int lanes = 1;
  while (lanes < a.I && lanes < 32) lanes <<= 1;
  const int group = wide ? 4 : 1;
  a.groups = wide ? (a.I + 127) / 128 : 1;
  const int len = a.groups * lanes * group;
  const int tile = len < kTile ? len : kTile;
  const int list = M == Mode::kAttain && wide ? a.rows * lanes * group * 4
                                              : 0;
  const int planes = planes_of(M) * tile * 4 + list;
  const int cache = a.rows * (len * 4 * cache_floats(M) + a.groups * lanes);
  const bool shared = planes + cache <= kSmemMax;
  if (a.lanes != lanes ||
      a.rows * lanes != (wide ? kWideThreads : kNarrowThreads) ||
      smem != planes + (shared ? cache : 0) ||
      shared != (a.scratch == nullptr))
    return bad;
  a.lam_vec = a.lam_cs == 1 && a.I % 4 == 0 && a.lam_rs % 4 == 0 &&
              (reinterpret_cast<uintptr_t>(a.lam) & 15) == 0;
  a.slo_vec = a.slo_rs != 0 && a.I % 4 == 0 && a.slo_rs % 4 == 0 &&
              (reinterpret_cast<uintptr_t>(a.slo) & 15) == 0;
  return wide ? launch_rows<4, M>(a, smem, stream)
              : launch_rows<1, M>(a, smem, stream);
}

// Stage the candidates where the block can hold them, else read them
// from device memory.
int launch_guard(Guard a, cudaStream_t stream) {
  const long long bytes = static_cast<long long>(a.I) * (a.T + 6) * 4;
  const bool staged = a.I <= kGuardStageMax && bytes <= kGuardSmemMax;
  a.lam_vec = a.lam_cs == 1 && a.I <= kGuardRow && a.I % 4 == 0 &&
              a.lam_rs % 4 == 0 &&
              (reinterpret_cast<uintptr_t>(a.lam) & 15) == 0;
  const int grid = (a.R + kGuardThreads - 1) / kGuardThreads;
  if (staged) {
    routing_guard_kernel<true><<<grid, kGuardThreads,
                                 static_cast<int>(bytes), stream>>>(a);
  } else {
    routing_guard_kernel<false><<<grid, kGuardThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Each launcher enqueues on the
// caller's stream, never synchronises, and returns cudaGetLastError() (or
// the first error of its setup). The three row kernels take the wrapper's
// plan (lanes per row, rows per block, shared bytes) and, for a row whose
// g cache does not fit in shared memory, its scratch.
extern "C" {

int laimr_routing_score(const float* lam, int lam_rs, int lam_cs,
                        const float* alpha, const float* beta,
                        const float* gamma, const float* mu, const float* n,
                        const float* rtt, const float* slo, int slo_rs,
                        const float* cost, const float* table, int R, int I,
                        int T, int lanes, int rows_per_block, int smem_bytes,
                        float* scratch, int32_t* idx, float* g, uint8_t* ok,
                        void* stream) {
  if (R <= 0) return 0;
  const Decide a{lam, lam_rs, lam_cs, Cols{alpha, beta, gamma, mu, n, rtt},
                 cost, nullptr, nullptr, slo, slo_rs, table, R, I, T, 1,
                 0.0f, lanes, rows_per_block, 1, 0, 0, scratch, idx, g, ok};
  return launch_plan<Mode::kScore>(a, smem_bytes,
                                   static_cast<cudaStream_t>(stream));
}

int laimr_routing_guard(const float* lam, int lam_rs, int lam_cs,
                        const float* alpha, const float* beta,
                        const float* gamma, const float* mu, const float* n,
                        const float* rtt, const float* tau,
                        const int32_t* home, const int32_t* up,
                        const float* table, int R, int I, int T, int32_t* idx,
                        float* g, uint8_t* off, void* stream) {
  if (R <= 0) return 0;
  const Guard a{lam, lam_rs, lam_cs, Cols{alpha, beta, gamma, mu, n, rtt},
                tau, home, up, table, R, I, T, 0, idx, g, off};
  return launch_guard(a, static_cast<cudaStream_t>(stream));
}

int laimr_routing_topk(const float* lam, int lam_rs, int lam_cs,
                       const float* alpha, const float* beta,
                       const float* gamma, const float* mu, const float* n,
                       const float* rtt, const float* slo, int slo_rs,
                       const float* cost, const float* table, int R, int I,
                       int T, int k, float margin, int lanes,
                       int rows_per_block, int smem_bytes, float* scratch,
                       int32_t* idx, float* g, uint8_t* ok, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return 0;
  const Decide a{lam, lam_rs, lam_cs, Cols{alpha, beta, gamma, mu, n, rtt},
                 cost, nullptr, nullptr, slo, slo_rs, table, R, I, T, k,
                 margin, lanes, rows_per_block, 1, 0, 0, scratch, idx, g,
                 ok};
  return launch_plan<Mode::kTopk>(a, smem_bytes,
                                  static_cast<cudaStream_t>(stream));
}

int laimr_routing_attain(const float* lam, int lam_rs, int lam_cs,
                         const float* alpha, const float* beta,
                         const float* gamma, const float* mu, const float* n,
                         const float* rtt, const float* slo, int slo_rs,
                         const float* sigma, const float* avail,
                         const float* table, int R, int I, int T, int k,
                         float margin, int lanes, int rows_per_block,
                         int smem_bytes, float* scratch, int32_t* idx,
                         float* g, uint8_t* ok, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return 0;
  const Decide a{lam, lam_rs, lam_cs, Cols{alpha, beta, gamma, mu, n, rtt},
                 nullptr, sigma, avail, slo, slo_rs, table, R, I, T, k,
                 margin, lanes, rows_per_block, 1, 0, 0, scratch, idx, g,
                 ok};
  return launch_plan<Mode::kAttain>(a, smem_bytes,
                                    static_cast<cudaStream_t>(stream));
}

const char* laimr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
