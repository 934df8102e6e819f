// Hand-written Hopper (sm_90a) kernels for the LA-IMR windowed routing path.
//
// routing_score_kernel replaces the TPU kernel
//   src/repro/kernels/routing_score.py : routing_score (_kernel)
// routing_guard_kernel replaces the TPU kernel
//   src/repro/kernels/routing_decide.py : routing_guard (_guard_kernel)
// routing_topk_kernel and routing_attain_kernel replace
//   src/repro/kernels/routing_decide.py : routing_topk (_topk_kernel) and
//   routing_attain (_attain_kernel).
// routing_score_kernel and routing_topk_kernel share one body, whose note
// is above it; routing_attain's note is above that kernel.
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
//  * the (I, T) table is read through L1/L2 and never staged in shared
//    memory: at I = 1024, T = 65 it is 266 KB, more than the 227 KB a
//    block can hold, and a pair touches only two of its entries;
//  * the TPU kernel's hat-function contraction over all T grid points is
//    rewritten as the two entries that bracket rho: every other hat
//    weight is exactly 0 and adding zeros is exact, so the two-term sum
//    equals the full sum bit for bit;
//  * routing_guard scores only each row's home column (and its upstream
//    column when the guard fires), O(R) work where the TPU kernel scored
//    all I candidates of every row: each g[r, i] is independent, so the
//    outputs are the same.
//
// Arithmetic follows the TPU kernels: pow as exp(gamma * log(x)), float32
// constants, no fused multiply-add (built with -fmad=false; the explicit
// __f*_rn intrinsics pin the rounding of each step regardless), and the
// accurate expf/logf (never --use_fast_math). Every kernel computes g with
// the same pieces (proc_time, grid_pos, grid_j, grid_wait) in the same
// order, so g is the same bits in all of them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;       // argmin key mask (routing_score.py BIG)
constexpr float kUnstable = 1e9f;   // router.BIG: unstable-pool sentinel
constexpr float kNear = 1.00001f;   // float32(1 + 1e-5): the near band
constexpr float kEps = 1e-9f;
constexpr int kWarpsPerBlock = 8;   // routing_attain: one warp per row
constexpr int kGuardThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;   // "no column" in the argmin reductions
constexpr int kMaxK = 8;            // routing_decide.K_MAX
constexpr float kAttainBand = 1e-6f;
constexpr float kSqrt2 = 1.41421356237309515f;  // float32(sqrt(2))

// routing_score / routing_topk (routing_score.row_plan mirrors these)
constexpr int kNarrowThreads = 256;   // a block of rows of I <= 32
constexpr int kWideThreads = 512;     // a block of wider rows, a warp each
constexpr int kTile = 1024;           // candidates whose columns are staged
constexpr int kSmemMax = 227 * 1024;  // dynamic shared bytes a block may have
constexpr int kBatch = 2;             // candidates a lane scores at once
constexpr int kMaxDevices = 64;       // launch state kept per device
// the staged column planes, tile floats each
enum Plane { kAlpha, kBeta, kGamma, kN1, kNMu, kRtt, kSlo, kPlanes };

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
// branches (routing_guard, routing_attain). The operations, and so the
// bits, are the same.
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

// Predicted latency g of candidate i at rate lam, and its rho, from the
// columns in device memory (routing_guard, routing_attain).
__device__ __forceinline__ float score(const Cols& c,
                                       const float* __restrict__ table,
                                       int t, int i, float lam, float* rho) {
  const float n = __ldg(c.n + i);
  const float proc =
      proc_time<false>(lam, fmaxf(n, 1.0f), __ldg(c.alpha + i),
                       __ldg(c.beta + i), __ldg(c.gamma + i));
  const float r = __fdiv_rn(lam, fmaxf(__fmul_rn(n, __ldg(c.mu + i)), 1e-12f));
  const float pos = grid_pos(r, t);
  const int j = grid_j(pos, t);
  const float* row = table + static_cast<size_t>(i) * t;
  const float q1 = j + 1 < t ? __ldg(row + j + 1) : 0.0f;
  *rho = r;
  return __fadd_rn(__fadd_rn(proc, __ldg(c.rtt + i)),
                   grid_wait(pos, j, t, __ldg(row + j), q1));
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

__device__ __forceinline__ float seg_min(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, off, lanes));
  return v;
}

__device__ __forceinline__ bool seg_any(bool v, int lanes) {
  int x = v ? 1 : 0;
  for (int off = lanes >> 1; off > 0; off >>= 1)
    x |= __shfl_xor_sync(kFull, x, off, lanes);
  return x != 0;
}

__device__ __forceinline__ void warp_argmin(float& key, int& col, float& g) {
  seg_argmin(key, col, g, 32);
}

__device__ __forceinline__ float warp_min(float v) { return seg_min(v, 32); }

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// ---------------------------------------------------------------------------
// routing_score_kernel / routing_topk_kernel: route_best's decision, and
// for routing_topk the k - 1 redundant-dispatch columns after it.
//
// What held the first design back (one warp per row, every pass
// rescoring): at fleet scale it was 9.5x (score) and 17x (topk) its
// byte bound, because each pass scored every pair again (2 passes for
// score, 1 + k for topk), each score a chain of a rate load, arithmetic
// and two dependent gathers walked one candidate at a time, and 7
// column loads per pair repeated by every row; at I = 2..4, 28 of a
// warp's 32 lanes idled.
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
//    eligible for a duplicate); the near-band pass and each duplicate
//    pass read only these, never the inputs. A lane reads back only what
//    it wrote, so the cache needs no barrier. It lives in shared memory,
//    or, where 16 rows of it do not fit there (I > 2944), in a device
//    scratch that the wrapper keeps per device and stream;
//  * duplicates come out in ascending (g, column) order over feasible &
//    g <= slo - margin & column != primary: pass j takes the segment
//    argmin above the (g, column) pair pass j - 1 chose, which is the
//    stable ascending-g sort of the eligible set (ref._dup_order);
//  * loads: the block stages the candidate columns in shared memory by
//    cp.async, a tile of up to 1024 candidates at a time (once a launch
//    when a row fits in one tile), and forms max(n, 1) and max(n mu,
//    1e-12) there; cost, which only near-band candidates need, is read
//    from device memory (staging it too made the fleet's block 4 KB
//    larger and the kernel a third slower). A group's
//    rates and SLOs load as one 16-byte vector each where the rows are
//    aligned and I % 4 == 0 (scalar loads otherwise), and the table
//    gathers of kBatch = 2 candidates start before their exp/log. Warps,
//    not registers, hide the latency: two 512-thread blocks an SM hold 32
//    warps at the 64 registers a thread this leaves;
//  * blocks are persistent (no more than fit on the card at once) and
//    walk row groups.
// What bounds it now: instructions and latency, not bytes. A pair's two IEEE
// divisions each sit in a slow-path region of their own that the
// scheduler cannot cross, beside the accurate logf and expf and the
// table's addressing; taking out the row loads, the table gathers or
// exp/log each left most of the time in place.
// ---------------------------------------------------------------------------

// One launch of routing_score_kernel / routing_topk_kernel.
struct Decide {
  const float* lam;       // (R,) shared rate: rs 1, cs 0; (R, I): rs I, cs 1
  int lam_rs, lam_cs;
  Cols c;
  const float* cost;      // (I,)
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

// The row's column held in slot e of lane s's group q, G adjacent
// candidates a group.
template <int G>
__device__ __forceinline__ int slot_col(int q, int s, int e, int lanes) {
  return (q * lanes + s) * G + e;
}

// Stage candidates [base, base + tile) of the columns into the shared
// planes; entries past I stay unset and are never used.
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
// (feasible) and e + 4 (eligible), and fold the row's reductions
// (feasible g minimum, any feasible, and for topk the minimum of g with
// the sentinel where rho >= 1, over every column).
template <int H, bool TOPK>
__device__ __forceinline__ void score_slots(
    const Decide& a, const float* sm, int tile, int x, int xl, int e,
    const float (&lam)[H], const float (&slo)[H], float* cache,
    unsigned& bits, float& gmin, float& geff_min, bool& any) {
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
      gmin = fminf(gmin, g[u]);
      any = true;
      bits |= 1u << (e + u);
    }
    if constexpr (TOPK) {
      if (valid[u])
        geff_min = fminf(geff_min, rho[u] < 1.0f ? g[u] : kUnstable);
      if (f && g[u] <= __fsub_rn(slo[u], a.margin)) bits |= 16u << (e + u);
    }
  }
  if constexpr (H == 2) {
    *reinterpret_cast<float2*>(cache + x) = make_float2(g[0], g[1]);
  } else {
#pragma unroll
    for (int u = 0; u < H; ++u) cache[x + u] = g[u];
  }
}

// Pass 1 for group q of lane s, whose columns are staged in the tile from
// column base on: load its rates and SLOs, score it kBatch candidates at
// a time, and write its flag byte.
template <int G, bool TOPK>
__device__ __forceinline__ void score_group(
    const Decide& a, const float* sm, int tile, int base, int q, int s,
    const float* lam_row, const float* slo_row, float lam_one, float* cache,
    uint8_t* flags, float& gmin, float& geff_min, bool& any) {
  constexpr int H = G < kBatch ? G : kBatch;
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
    score_slots<H, TOPK>(a, sm, tile, x + h, x + h - base, h, lh, sh, cache,
                         bits, gmin, geff_min, any);
  }
  flags[q * a.lanes + s] = static_cast<uint8_t>(bits);
}

// Pass 2 over the lane's cache: the cheapest candidate inside the near
// band, lowest column on ties; every other column keys at BIG, so a row
// with nothing near yields its lowest column.
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
template <int G, bool TOPK>
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
  // the row's cache and flags: after the planes in shared memory, or a
  // slot per resident row of the scratch (g of every slot, then the flags
  // of every slot), set in the row loop (hoisted, the fleet shape ran 8%
  // slower); narrow rows always fit
  float* cache = sm + kPlanes * tile + w * len;
  uint8_t* flags = reinterpret_cast<uint8_t*>(sm + kPlanes * tile +
                                              a.rows * len) + w * flag_len;
  if (tiles == 1) stage_columns(a, sm, tile, 0);

  for (int r0 = blockIdx.x * a.rows; r0 < a.R; r0 += gridDim.x * a.rows) {
    const int r = r0 + w;
    const int rl = min(r, a.R - 1);  // rows past R redo R - 1, write nothing
    if (G == 4 && a.scratch != nullptr) {
      const size_t slots = static_cast<size_t>(gridDim.x) * a.rows;
      const size_t slot = static_cast<size_t>(blockIdx.x) * a.rows + w;
      cache = a.scratch + slot * len;
      flags = reinterpret_cast<uint8_t*>(a.scratch + slots * len) +
              slot * flag_len;
    }
    const float* lam_row = a.lam + static_cast<size_t>(rl) * a.lam_rs;
    const float* slo_row = a.slo + static_cast<size_t>(rl) * a.slo_rs;
    const float lam_one = a.lam_cs == 0 ? __ldg(lam_row) : 0.0f;

    // pass 1: score once into the cache
    float gmin = kBig, geff_min = kBig;
    bool any = false;
    for (int t = 0; t < tiles; ++t) {
      if (tiles > 1) {
        __syncthreads();   // every warp is done with the previous tile
        stage_columns(a, sm, tile, t * tile);
      }
      const int end = min(groups, (t + 1) * per_tile);
#pragma unroll 1
      for (int q = t * per_tile; q < end; ++q)
        score_group<G, TOPK>(a, sm, tile, t * tile, q, s, lam_row, slo_row,
                             lam_one, cache, flags, gmin, geff_min, any);
    }
    gmin = seg_min(gmin, lanes);
    any = seg_any(any, lanes);
    const float edge = __fadd_rn(__fmul_rn(gmin, kNear), kEps);

    // pass 2: route_best's primary from the cache
    float key = kBig, g = 0.0f;
    int col = kNone;
    primary_pass<G>(a, s, groups, cache, flags, edge, key, col, g);
    seg_argmin(key, col, g, lanes);
    const bool out = s == 0 && r < a.R;
    if constexpr (!TOPK) {
      if (out) {
        a.idx[r] = col;
        a.g[r] = g;
        a.ok[r] = any ? 1 : 0;
      }
    } else {
      // column 0: the primary and its g on a feasible row, -1 and the
      // row's g_eff minimum otherwise; then the duplicates, -1 and g 0
      // where none is left
      geff_min = seg_min(geff_min, lanes);
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
  decide_rows<G, false>(a);
}

// One thread per request row: score home, apply the Algorithm-1 guard,
// score upstream only when the guard fires.
__global__ void routing_guard_kernel(
    const float* __restrict__ lam, int lam_rs, int lam_cs, Cols c,
    const float* __restrict__ tau, const int32_t* __restrict__ home,
    const int32_t* __restrict__ up, const float* __restrict__ table,
    int R, int T, int32_t* __restrict__ idx_out, float* __restrict__ g_out,
    uint8_t* __restrict__ off_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int h = __ldg(home + r);
  const int u = __ldg(up + r);
  const float* lam_row = lam + static_cast<size_t>(r) * lam_rs;
  float rho;
  float g_home = score(c, table, T, h,
                       __ldg(lam_row + static_cast<size_t>(h) * lam_cs), &rho);
  if (!(rho < 1.0f)) g_home = kUnstable;
  // controllable latency: strip the home RTT except from the sentinel,
  // which must stay above any tau
  const float g_inst = g_home < kUnstable
                           ? __fsub_rn(g_home, __ldg(c.rtt + h)) : g_home;
  const bool off = g_inst > __ldg(tau + r) && u >= 0;
  float g_sel = g_home;
  if (off) {
    g_sel = score(c, table, T, u,
                  __ldg(lam_row + static_cast<size_t>(u) * lam_cs), &rho);
    if (!(rho < 1.0f)) g_sel = kUnstable;
  }
  idx_out[r] = off ? u : h;
  g_out[r] = g_sel;
  off_out[r] = off ? 1 : 0;
}

template <int G>
__global__ void __launch_bounds__(kWideThreads, 2)
    routing_topk_kernel(const Decide a) {
  decide_rows<G, true>(a);
}

// ---------------------------------------------------------------------------
// routing_attain_kernel: a primary plus k - 1 redundant-dispatch columns
// per request row (reliable), in the first design: one warp per row.
//
// What bounds it on an H100: the same bytes and launch latency as
// routing_score. A window reads the (R, I) rates and SLO rows, eight f32
// columns of I entries, two Erlang-table entries per (request,
// candidate), and writes 8k + 1 bytes per request. Scoring a pair is ~30
// flops plus one logf and one expf; attain adds two logf and one erff
// (~25 more flops) per pair. At the main path's I = 2..4 and k = 2 a
// launch is launch latency around a few KB; at fleet scale (R = 4096,
// I = 1024) the rows are an L2-resident stream rescored once per pass.
//
// What the design does about it:
//  * one warp per request row, lanes striding over the candidates: pass 1
//    reduces the feasible attainment maximum, the feasible flag, and the
//    row minimum of g with the 1e9 sentinel where rho >= 1 (column 0 of
//    an infeasible row, taken over every column, lane-excluded ones
//    included); pass 2 takes the primary with the warp argmin;
//  * each duplicate column is one more warp argmin over the eligible set
//    (feasible, g <= slo - margin, not the primary). Duplicates come out
//    in ascending (g, column) order, so pass j only has to look above
//    the (g, column) pair pass j - 1 chose: no list of chosen columns,
//    no shared memory, and the result is the stable ascending-g sort of
//    the eligible set that the TPU kernel's masked argmin produces;
//  * each pass rescores the row instead of keeping g: score() is
//    deterministic, so every pass sees the same bits. k is capped at
//    kMaxK passes. (routing_score / routing_topk above keep g instead.)
// The Pallas kernels built the whole (block, I) score matrix in VMEM and
// one-hot-gathered from it; nothing of that layout carries over.
// ---------------------------------------------------------------------------

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

// One request row's rates (stride lam_cs between candidates: 0 for a
// shared rate) and SLO row.
struct RowIn {
  const float* lam;
  int lam_cs;
  const float* slo;
};

__device__ __forceinline__ RowIn row_in(const float* lam, int lam_rs,
                                        int lam_cs, const float* slo,
                                        int slo_rs, int r) {
  return RowIn{lam + static_cast<size_t>(r) * lam_rs, lam_cs,
               slo + static_cast<size_t>(r) * slo_rs};
}

__device__ __forceinline__ float score_at(const Cols& c, const float* table,
                                          int T, const RowIn& in, int i,
                                          float* rho) {
  return score(c, table, T, i,
               __ldg(in.lam + static_cast<size_t>(i) * in.lam_cs), rho);
}

// Columns 1..k-1 of one row and its column 0: duplicates in ascending
// (g, column) order over feasible & g <= slo - margin & column !=
// primary; -1 and g 0 where none is left. Column 0 holds the primary
// and its g on a feasible row, -1 and the row's g_eff minimum otherwise.
__device__ __forceinline__ void finish_row(
    const Cols& c, const float* table, int T, int I, const RowIn& in,
    float margin, int k, int lane, bool any, int primary, float g_primary,
    float geff_min, int32_t* idx_row, float* g_row) {
  if (lane == 0) {
    idx_row[0] = any ? primary : -1;
    g_row[0] = any ? g_primary : geff_min;
  }
  float last_g = -kBig;   // the (g, column) pair the previous pass chose
  int last_i = -1;
  bool left = any;        // an infeasible row has no eligible column
  for (int j = 1; j < k; ++j) {
    float best_key = kBig;
    int best_i = kNone;
    float best_g = 0.0f;
    if (left) {
      for (int i = lane; i < I; i += 32) {
        float rho;
        const float g = score_at(c, table, T, in, i, &rho);
        const float slo = __ldg(in.slo + i);
        const bool elig = rho < 1.0f && g <= slo &&
                          g <= __fsub_rn(slo, margin) && i != primary &&
                          (g > last_g || (g == last_g && i > last_i));
        if (elig && (g < best_key || (g == best_key && i < best_i))) {
          best_key = g;
          best_i = i;
          best_g = g;
        }
      }
      warp_argmin(best_key, best_i, best_g);
    }
    const bool has = best_i != kNone;
    if (lane == 0) {
      idx_row[j] = has ? best_i : -1;
      g_row[j] = has ? best_g : 0.0f;
    }
    left = has;
    last_g = best_g;
    last_i = best_i;
  }
}

// One warp per request row: attainment-argmax primary + k - 1 duplicates.
__global__ void routing_attain_kernel(
    const float* __restrict__ lam, int lam_rs, int lam_cs, Cols c,
    const float* __restrict__ slo, int slo_rs,
    const float* __restrict__ sigma, const float* __restrict__ avail,
    const float* __restrict__ table, int R, int I, int T, int k,
    float margin, int32_t* __restrict__ idx_out, float* __restrict__ g_out,
    uint8_t* __restrict__ ok_out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;
  const RowIn in = row_in(lam, lam_rs, lam_cs, slo, slo_rs, r);

  // pass 1: feasible attainment maximum (-1 when nothing is feasible),
  // any, row minimum of g_eff
  float pmax = -1.0f;
  float geff_min = kBig;
  bool any = false;
  for (int i = lane; i < I; i += 32) {
    float rho;
    const float g = score_at(c, table, T, in, i, &rho);
    const float s = __ldg(in.slo + i);
    geff_min = fminf(geff_min, rho < 1.0f ? g : kUnstable);
    if (rho < 1.0f && g <= s) {
      pmax = fmaxf(pmax, attain_p(g, s, __ldg(sigma + i), __ldg(avail + i)));
      any = true;
    }
  }
  pmax = warp_max(pmax);
  geff_min = warp_min(geff_min);
  any = __any_sync(kFull, any);
  const float floor_p = __fsub_rn(pmax, kAttainBand);

  // pass 2: lowest g inside the attainment band, lowest index on ties
  float best_key = kBig;
  int best_i = kNone;
  float best_g = 0.0f;
  for (int i = lane; i < I; i += 32) {
    float rho;
    const float g = score_at(c, table, T, in, i, &rho);
    const float s = __ldg(in.slo + i);
    const bool nearp =
        rho < 1.0f && g <= s &&
        attain_p(g, s, __ldg(sigma + i), __ldg(avail + i)) >= floor_p;
    const float key = nearp ? g : kBig;
    if (key < best_key || (key == best_key && i < best_i)) {
      best_key = key;
      best_i = i;
      best_g = g;
    }
  }
  warp_argmin(best_key, best_i, best_g);
  finish_row(c, table, T, I, in, margin, k, lane, any, best_i, best_g,
             geff_min, idx_out + static_cast<size_t>(r) * k,
             g_out + static_cast<size_t>(r) * k);
  if (lane == 0) ok_out[r] = any ? 1 : 0;
}

// What one body of routing_score_kernel / routing_topk_kernel holds on a
// device: the dynamic shared bytes it is opted in to, and the blocks an
// SM holds at the shared bytes of its last launch. Kept per process and
// device.
struct BodyState {
  int opt_in = 48 * 1024;   // the default limit needs no opt-in
  int smem = -1;
  int held = 0;
  int sms = 0;
};

// Launch one body: no more blocks than fit on the card at once (each
// walks row groups).
template <int G, bool TOPK>
int launch_rows(const Decide& a, int smem, cudaStream_t stream) {
  void (*kernel)(const Decide) =
      TOPK ? routing_topk_kernel<G> : routing_score_kernel<G>;
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
// shared memory) against I, then launch the body it names.
template <bool TOPK>
int launch_plan(Decide a, int smem, cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const bool wide = a.I > 32;
  int lanes = 1;
  while (lanes < a.I && lanes < 32) lanes <<= 1;
  const int group = wide ? 4 : 1;
  a.groups = wide ? (a.I + 127) / 128 : 1;
  const int len = a.groups * lanes * group;
  const int tile = len < kTile ? len : kTile;
  const int planes = kPlanes * tile * 4;
  const int cache = a.rows * (len * 4 + a.groups * lanes);
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
  return wide ? launch_rows<4, TOPK>(a, smem, stream)
              : launch_rows<1, TOPK>(a, smem, stream);
}

}  // namespace

// Plain C interface, loaded with ctypes. Each launcher enqueues on the
// caller's stream, never synchronises, and returns cudaGetLastError() (or
// the first error of its setup). routing_score and routing_topk take the
// wrapper's plan (lanes per row, rows per block, shared bytes) and, for a
// row whose g cache does not fit in shared memory, its scratch.
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
                 cost, slo, slo_rs, table, R, I, T, 1, 0.0f, lanes,
                 rows_per_block, 1, 0, 0, scratch, idx, g, ok};
  return launch_plan<false>(a, smem_bytes, static_cast<cudaStream_t>(stream));
}

int laimr_routing_guard(const float* lam, int lam_rs, int lam_cs,
                        const float* alpha, const float* beta,
                        const float* gamma, const float* mu, const float* n,
                        const float* rtt, const float* tau,
                        const int32_t* home, const int32_t* up,
                        const float* table, int R, int T, int32_t* idx,
                        float* g, uint8_t* off, void* stream) {
  if (R <= 0) return 0;
  const Cols c{alpha, beta, gamma, mu, n, rtt};
  const dim3 block(kGuardThreads);
  const dim3 grid((R + kGuardThreads - 1) / kGuardThreads);
  routing_guard_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      lam, lam_rs, lam_cs, c, tau, home, up, table, R, T, idx, g, off);
  return static_cast<int>(cudaGetLastError());
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
                 cost, slo, slo_rs, table, R, I, T, k, margin, lanes,
                 rows_per_block, 1, 0, 0, scratch, idx, g, ok};
  return launch_plan<true>(a, smem_bytes, static_cast<cudaStream_t>(stream));
}

int laimr_routing_attain(const float* lam, int lam_rs, int lam_cs,
                         const float* alpha, const float* beta,
                         const float* gamma, const float* mu, const float* n,
                         const float* rtt, const float* slo, int slo_rs,
                         const float* sigma, const float* avail,
                         const float* table, int R, int I, int T, int k,
                         float margin, int32_t* idx, float* g, uint8_t* ok,
                         void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return 0;
  const Cols c{alpha, beta, gamma, mu, n, rtt};
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((R + kWarpsPerBlock - 1) / kWarpsPerBlock);
  routing_attain_kernel<<<grid, block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      lam, lam_rs, lam_cs, c, slo, slo_rs, sigma, avail, table, R, I, T, k,
      margin, idx, g, ok);
  return static_cast<int>(cudaGetLastError());
}

const char* laimr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
