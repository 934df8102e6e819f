// Hand-written Hopper (sm_90a) kernels for the LA-IMR windowed routing path.
//
// routing_score_kernel replaces the TPU kernel
//   src/repro/kernels/routing_score.py : routing_score (_kernel)
// routing_guard_kernel replaces the TPU kernel
//   src/repro/kernels/routing_decide.py : routing_guard (_guard_kernel)
// routing_topk_kernel and routing_attain_kernel replace
//   src/repro/kernels/routing_decide.py : routing_topk (_topk_kernel) and
//   routing_attain (_attain_kernel); their note is above the kernels.
//
// What bounds them on an H100: bytes and launch latency. A window of R
// decisions over I candidates reads R (or R*I) rates, seven f32 columns
// of I entries, and two entries of one (I, T=65) Erlang-wait table row
// per (request, candidate); it does ~40 flops per pair and writes 9 bytes
// per request. At the main path's I = 2..4 the whole table is a few KB,
// so a launch is a few microseconds of launch overhead around almost no
// work; at fleet scale (R = 4096, I = 1024) it is an L2-resident stream.
//
// What the design does about it:
//  * one warp per request row (routing_score): lanes stride over the
//    candidates, so column reads are coalesced, and two warp-shuffle
//    reductions (feasible latency minimum, then the cost argmin with
//    lowest-index ties, as jnp.argmin) decide the row with no shared
//    memory and no second launch;
//  * the (I, T) table is read through L1/L2 and never staged in shared
//    memory: at I = 1024, T = 65 it is 266 KB, more than the 227 KB a
//    block can hold, and a row touches only two of its entries;
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
// accurate expf/logf (never --use_fast_math).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;       // argmin key mask (routing_score.py BIG)
constexpr float kUnstable = 1e9f;   // router.BIG: unstable-pool sentinel
constexpr float kNear = 1.00001f;   // float32(1 + 1e-5): the near band
constexpr float kEps = 1e-9f;
constexpr int kWarpsPerBlock = 8;
constexpr int kGuardThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;   // "no column" in the argmin reductions
constexpr int kMaxK = 8;            // routing_decide.K_MAX
constexpr float kAttainBand = 1e-6f;
constexpr float kSqrt2 = 1.41421356237309515f;  // float32(sqrt(2))

struct Cols {
  const float* alpha;
  const float* beta;
  const float* gamma;
  const float* mu;
  const float* n;
  const float* rtt;
};

// Predicted latency g of candidate i at rate lam, and its rho.
__device__ __forceinline__ float score(const Cols& c,
                                       const float* __restrict__ table,
                                       int t, int i, float lam, float* rho) {
  const float n = __ldg(c.n + i);
  const float alpha = __ldg(c.alpha + i);
  const float lam_tilde = __fdiv_rn(lam, fmaxf(n, 1.0f));
  float proc = alpha;
  if (lam_tilde > 0.0f) {
    const float e = expf(__fmul_rn(__ldg(c.gamma + i),
                                   logf(fmaxf(lam_tilde, 1e-20f))));
    proc = __fadd_rn(alpha, __fmul_rn(__ldg(c.beta + i), e));
  }
  const float r = __fdiv_rn(lam, fmaxf(__fmul_rn(n, __ldg(c.mu + i)), 1e-12f));
  const float pos = __fmul_rn(fminf(fmaxf(r, 0.0f), 1.0f),
                              static_cast<float>(t - 1));
  int j = static_cast<int>(floorf(pos));
  if (j > t - 1) j = t - 1;
  const float* row = table + static_cast<size_t>(i) * t;
  const float w0 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(
                                   pos, static_cast<float>(j)))));
  float q = __fmul_rn(w0, __ldg(row + j));
  if (j + 1 < t) {
    const float w1 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(
                                     pos, static_cast<float>(j + 1)))));
    q = __fadd_rn(q, __fmul_rn(w1, __ldg(row + j + 1)));
  }
  *rho = r;
  return __fadd_rn(__fadd_rn(proc, __ldg(c.rtt + i)), q);
}

// Warp-wide argmin of (key, column), ties to the lowest column (the
// first occurrence, as jnp.argmin); g rides along with the winner.
__device__ __forceinline__ void warp_argmin(float& key, int& col, float& g) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ok = __shfl_xor_sync(kFull, key, off);
    const int oc = __shfl_xor_sync(kFull, col, off);
    const float og = __shfl_xor_sync(kFull, g, off);
    if (ok < key || (ok == key && oc < col)) {
      key = ok;
      col = oc;
      g = og;
    }
  }
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// One warp decides one request row.
__global__ void routing_score_kernel(
    const float* __restrict__ lam, int lam_rs, int lam_cs, Cols c,
    const float* __restrict__ slo, int slo_rs,
    const float* __restrict__ cost, const float* __restrict__ table,
    int R, int I, int T, int32_t* __restrict__ idx_out,
    float* __restrict__ g_out, uint8_t* __restrict__ ok_out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // the whole warp leaves together
  const float* lam_row = lam + static_cast<size_t>(r) * lam_rs;
  const float* slo_row = slo + static_cast<size_t>(r) * slo_rs;

  // pass 1: the feasible latency minimum (BIG when nothing is feasible)
  float gmin = kBig;
  bool any = false;
  for (int i = lane; i < I; i += 32) {
    float rho;
    const float g = score(c, table, T, i,
                          __ldg(lam_row + static_cast<size_t>(i) * lam_cs),
                          &rho);
    if (rho < 1.0f && g <= __ldg(slo_row + i)) {
      gmin = fminf(gmin, g);
      any = true;
    }
  }
  gmin = warp_min(gmin);
  any = __any_sync(kFull, any);
  const float edge = __fadd_rn(__fmul_rn(gmin, kNear), kEps);

  // pass 2: cheapest candidate inside the near band, lowest index on
  // ties; a row with no feasible candidate keys every column at BIG and
  // so yields idx 0
  float best_key = kBig;
  int best_i = kNone;
  float best_g = 0.0f;
  for (int i = lane; i < I; i += 32) {
    float rho;
    const float g = score(c, table, T, i,
                          __ldg(lam_row + static_cast<size_t>(i) * lam_cs),
                          &rho);
    const bool near = rho < 1.0f && g <= __ldg(slo_row + i) && g <= edge;
    const float key = near ? __ldg(cost + i) : kBig;
    if (key < best_key || (key == best_key && i < best_i)) {
      best_key = key;
      best_i = i;
      best_g = g;
    }
  }
  warp_argmin(best_key, best_i, best_g);
  if (lane == 0) {
    idx_out[r] = best_i;
    g_out[r] = best_g;
    ok_out[r] = any ? 1 : 0;
  }
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

// ---------------------------------------------------------------------------
// routing_topk_kernel / routing_attain_kernel: a primary plus k - 1
// redundant-dispatch columns per request row (safetail, reliable).
//
// What bounds them on an H100: the same bytes and launch latency as
// routing_score. A window reads the (R, I) rates and SLO rows, eight f32
// columns of I entries (seven for topk), two Erlang-table entries per
// (request, candidate), and writes 8k + 1 bytes per request. Scoring a
// pair is ~30 flops plus one logf and one expf; attain adds two logf and
// one erff (~25 more flops) per pair. At the main path's I = 2..4 and
// k = 2 a launch is launch latency around a few KB; at fleet scale
// (R = 4096, I = 1024) the rows are an L2-resident stream rescored once
// per pass.
//
// What the design does about it:
//  * one warp per request row, lanes striding over the candidates, as in
//    routing_score: pass 1 reduces the feasible g minimum (topk) or the
//    feasible attainment maximum (attain), the feasible flag, and the
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
//    deterministic, so every pass sees the same bits, and at the main
//    path's sizes the rescoring is free. k is capped at kMaxK passes.
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

// One warp per request row: route_best primary + k - 1 duplicates.
__global__ void routing_topk_kernel(
    const float* __restrict__ lam, int lam_rs, int lam_cs, Cols c,
    const float* __restrict__ slo, int slo_rs,
    const float* __restrict__ cost, const float* __restrict__ table,
    int R, int I, int T, int k, float margin,
    int32_t* __restrict__ idx_out, float* __restrict__ g_out,
    uint8_t* __restrict__ ok_out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // the whole warp leaves together
  const RowIn in = row_in(lam, lam_rs, lam_cs, slo, slo_rs, r);

  // pass 1: feasible latency minimum, any, row minimum of g_eff
  float gmin = kBig;
  float geff_min = kBig;
  bool any = false;
  for (int i = lane; i < I; i += 32) {
    float rho;
    const float g = score_at(c, table, T, in, i, &rho);
    geff_min = fminf(geff_min, rho < 1.0f ? g : kUnstable);
    if (rho < 1.0f && g <= __ldg(in.slo + i)) {
      gmin = fminf(gmin, g);
      any = true;
    }
  }
  gmin = warp_min(gmin);
  geff_min = warp_min(geff_min);
  any = __any_sync(kFull, any);
  const float edge = __fadd_rn(__fmul_rn(gmin, kNear), kEps);

  // pass 2: route_best's primary, the cheapest candidate inside the near
  // band (idx 0 on a row with nothing feasible, as in routing_score)
  float best_key = kBig;
  int best_i = kNone;
  float best_g = 0.0f;
  for (int i = lane; i < I; i += 32) {
    float rho;
    const float g = score_at(c, table, T, in, i, &rho);
    const bool near = rho < 1.0f && g <= __ldg(in.slo + i) && g <= edge;
    const float key = near ? __ldg(cost + i) : kBig;
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

}  // namespace

// Plain C interface, loaded with ctypes. Each launcher enqueues on the
// caller's stream, never synchronises, and returns cudaGetLastError().
extern "C" {

int laimr_routing_score(const float* lam, int lam_rs, int lam_cs,
                        const float* alpha, const float* beta,
                        const float* gamma, const float* mu, const float* n,
                        const float* rtt, const float* slo, int slo_rs,
                        const float* cost, const float* table, int R, int I,
                        int T, int32_t* idx, float* g, uint8_t* ok,
                        void* stream) {
  if (R <= 0) return 0;
  const Cols c{alpha, beta, gamma, mu, n, rtt};
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((R + kWarpsPerBlock - 1) / kWarpsPerBlock);
  routing_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      lam, lam_rs, lam_cs, c, slo, slo_rs, cost, table, R, I, T, idx, g, ok);
  return static_cast<int>(cudaGetLastError());
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
                       int T, int k, float margin, int32_t* idx, float* g,
                       uint8_t* ok, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return 0;
  const Cols c{alpha, beta, gamma, mu, n, rtt};
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((R + kWarpsPerBlock - 1) / kWarpsPerBlock);
  routing_topk_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      lam, lam_rs, lam_cs, c, slo, slo_rs, cost, table, R, I, T, k, margin,
      idx, g, ok);
  return static_cast<int>(cudaGetLastError());
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
