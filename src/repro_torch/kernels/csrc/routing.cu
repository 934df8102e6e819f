// Hand-written Hopper (sm_90a) kernels for the LA-IMR windowed routing path.
//
// routing_score_kernel replaces the TPU kernel
//   src/repro/kernels/routing_score.py : routing_score (_kernel)
// routing_guard_kernel replaces the TPU kernel
//   src/repro/kernels/routing_decide.py : routing_guard (_guard_kernel)
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
  for (int off = 16; off > 0; off >>= 1)
    gmin = fminf(gmin, __shfl_xor_sync(kFull, gmin, off));
  any = __any_sync(kFull, any);
  const float edge = __fadd_rn(__fmul_rn(gmin, kNear), kEps);

  // pass 2: cheapest candidate inside the near band, lowest index on
  // ties; a row with no feasible candidate keys every column at BIG and
  // so yields idx 0
  float best_key = kBig;
  int best_i = 0x7fffffff;
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
  for (int off = 16; off > 0; off >>= 1) {
    const float ok = __shfl_xor_sync(kFull, best_key, off);
    const int oi = __shfl_xor_sync(kFull, best_i, off);
    const float og = __shfl_xor_sync(kFull, best_g, off);
    if (ok < best_key || (ok == best_key && oi < best_i)) {
      best_key = ok;
      best_i = oi;
      best_g = og;
    }
  }
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

const char* laimr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
