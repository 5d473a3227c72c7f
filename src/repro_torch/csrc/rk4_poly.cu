// Fused RK4 polynomial-ODE integrator for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rk4/rk4.py::_rk4_kernel
// (line 38, launched by rk4_poly_solve_pallas).  Same contract as
// kernels/rk4/ref.py:
//
//   dY/dt = Theta . Phi(Y, u),  Phi_l = prod_o Xaug[term_idx[l, o]],
//   Xaug = [1, Y, u],  zero-order-hold u over each step,
//
// theta [B, n, L], y0 [B, n], us [B, T, m], term_idx [L, O] int32
// -> ys [B, T+1, n] with y0 in row 0; fp32 throughout.
//
// What bounds it.  At the refit shape (B = 64, T = 24, n = 3, L = 35, O = 3,
// m = 1) the work is about 1.7 MFLOP against 53 KB moved: 0.026 us of f32
// operations, 0.016 us of memory.  Neither can be approached.  Each
// instance walks a chain of 4*T dependent right-hand sides (96 here), so the
// floor is the chain's latency: 4*T x the latency of one right-hand side
// (a round of shuffles for Phi, a 5-level shuffle reduction, a few FMAs;
// about 200 clocks, so about 10 us at 96 steps).
//
// What the design does about it: one warp per instance, so that every
// right-hand side is spread over 32 lanes and nothing of the chain touches
// local or shared memory.
//   * Lane j < 1+n+m holds Xaug[j] as a scalar (1, a state, or an input).
//   * Lane j owns the terms l = j, j+32, ...  The first GR <= 2 groups of
//     32 terms keep their term_idx rows and their n Theta coefficients in
//     registers, loaded once; any further groups (L > 64) are read from
//     device memory (L1) each right-hand side, so L is not limited.  Every
//     library of the JAX package's 8 systems has L <= 35.
//   * Phi_l is the product of O __shfl_sync reads of Xaug, in the plain
//     version's factor order.
//   * The n sums over l are butterfly __shfl_xor_sync reductions,
//     interleaved across the n outputs; afterwards lane 1+i keeps k_i.
//   * The RK4 combination runs on the state lanes in scalars, and the same
//     lanes write the rows of ys.  Input lanes read the next step's u ahead
//     of the chain; m == 0 never reads `us`.
// Every per-lane array is indexed by compile-time constants only: the
// kernel is instantiated for n = 1..4 exactly, with no guards in the loops
// over the outputs, and for n <= 16 with warp-uniform guards, so nothing
// lives in a stack frame (ptxas: 0 bytes for every instantiation).  Blocks
// of kWarps warps: B = 64 puts 64 warps on 16 SMs, one per scheduler; a
// fleet of 2048 instances is 512 blocks, about four a SM.  The ragged
// batch edge is masked per warp.
//
// Measured (chip_smoke.py phase 7, NVIDIA H100 80GB HBM3, 700.00 W):
// 0.023 ms at the refit shape, 0.030 ms at T = 32, 0.045 ms at T = 50,
// 0.035 ms for 2048 instances at T = 32, about 2.3x the estimated chain
// floor.  The one-thread-per-instance design before it took 0.963 ms at
// the refit shape on the same card.  Times in PERF.md.

//
// The wide path.  Past one warp's reach (n > 16 or 1+n+m > 32: the JAX
// package's F8Crusader(n_aircraft=k) for k >= 6 stacks k airframes into
// n = 3k states, with L = C(n+m+3, 3) terms at order 3: 1,540 at k = 6,
// 7,770 at k = 11) one BLOCK integrates one instance:
//   * Xaug = [1, Y, u] and the four stages' k live in shared memory;
//   * the block's threads compute Phi_l for strided l into shared memory,
//     in chunks of at most kWideChunk terms when Phi (and Theta) do not
//     fit;
//   * warp w reduces the rows i = w, w + 16, ... of Theta . Phi, its lanes
//     reading Theta[i, l] at consecutive l (coalesced), then a shuffle
//     reduction;
//   * Theta is staged once in shared memory when it fits beside Phi
//     (n L <= about 56,000 floats: k = 6's 27,720 does), else it is read
//     from device memory on every right-hand side, where after the first
//     step it sits in L2 (1.0 MB at k = 11);
//   * the RK4 combination runs on the state threads, in the plain
//     version's order.
// Three block barriers a right-hand side: the chain is much longer than
// the warp path's, and at k = 11 every right-hand side re-reads Theta from
// L2, kAcc loads in flight a lane.  A slow path that is right; its times
// are in PERF.md.
//
// The adjoint (rk4_adjoint_kernel, the backward of the warp path).  It
// replaces no TPU kernel: the JAX package's custom_vjp replays the plain
// version under autodiff, as the port's backward did.  On the card that
// replay was about 3,500 small launches a solve (cat, gather, products,
// einsum and their reverses, each dispatched by the host), two thirds of
// a refit step's host time.  This kernel is the exact discrete adjoint of
// the forward's steps, fp32, in one launch.  Per step t = T-1 .. 0, with
// a the cotangent of y_{t+1}:
//   * the stage states Xaug(z1..z4) are recomputed from the saved ys[t] by
//     the forward's own poly_rhs, so they are the forward's;
//   * the stage cotangents are dt/6 a, dt/3 a, dt/3 a, dt/6 a, and the
//     products vjp(f) run at z4, z3, z2, z1 in turn, feeding dt gz4 into
//     k3's cotangent, dt/2 gz3 into k2's and dt/2 gz2 into k1's;
//   * each product adds lam_i Phi_l to g_theta[i, l], and with c_l =
//     sum_i Theta[i, l] lam_i adds c_l prod_{o' != o} Xaug[idx[l, o']] to
//     the cotangent of Xaug[idx[l, o]]: its states go into a, its inputs
//     into g_us[t] (zero-order hold);
//   * a += g_ys[t]; after step 0, a is g_y0.
// What bounds it: the same chain as the forward's, longer: 3 right-hand
// sides and 4 products a step, each a round of shuffles and a 5-level
// reduction (1.75x the forward's chain by count, 4.4x its time in PERF.md:
// a product's scatter into channels is longer than a sum); the work
// (kernels/work.py, rk4_adjoint_flops) is again far below the card's
// rates.  Design: the
// forward's warp an instance and its per-lane terms.  Lane j owns the
// terms l = j, j+32 (their Theta and their g_theta accumulators sit in
// registers; g_theta is written once at the end, no atomics); the factors
// come by __shfl_sync; the cotangent of each state and input channel is a
// butterfly __shfl_xor_sync reduction, so every lane holds all of them
// and the next stage's cotangent needs no broadcast, and the sums' order
// is fixed: the gradient is the same from run to run.  Instantiated for
// the forward's (OC, GR) and for n = 1..4 with n + m <= 7 exactly, else
// with warp-uniform guards up to the warp path's limits; the small
// instantiations reduce all kSmallChannels channels unguarded, since a
// guard between the shuffles keeps them from pipelining (0.155 ms with
// it at the refit shape).  The wide path's backward replays the plain
// version (kernels/rk4/ops.py).
//
// Its times at the refit's shapes, beside those of the replay it replaced,
// are in PERF.md's kernel table (row 2b).

#include <cuda_runtime.h>

#define RK4_MAX_N 16     // the warp path's limits; past them, the wide path
#define RK4_MAX_AUG 32   // 1 + n + m: one lane each

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// Per-lane registers of one instance: GR term groups of Theta and
// term_idx, OC = 3 or 4 factors each.  A library of order O < OC runs with
// its missing factors pointing at Xaug[0] = 1 (a product by 1 is exact);
// factors past the fourth are read from memory.
template <int OC, int GR, int NP>
struct Terms {
  float coef[GR][NP];
  int idx[GR][OC];
};

// Is output i one of the n?  NP < RK4_MAX_N means n == NP exactly, and the
// loops over the outputs carry no guard.
template <int NP>
__device__ __forceinline__ bool live(int i, int n) {
  return NP < RK4_MAX_N || i < n;
}

// One right-hand side: returns k_i on lane 1+i (0 elsewhere).
template <int OC, int GR, int NP>
__device__ __forceinline__ float poly_rhs(
    float aug, const Terms<OC, GR, NP>& r, const float* __restrict__ th,
    const int* __restrict__ term_idx, int lane, int n, int L, int O, int G) {
  float part[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) part[i] = 0.0f;
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    float phi = __shfl_sync(kFull, aug, r.idx[g][0]);
#pragma unroll
    for (int o = 1; o < OC; ++o) phi *= __shfl_sync(kFull, aug, r.idx[g][o]);
    if (O > OC) {
      const int l = lane + 32 * g;
      const int* ix = term_idx + (size_t)(l < L ? l : 0) * O;
      for (int o = OC; o < O; ++o)
        phi *= __shfl_sync(kFull, aug, l < L ? __ldg(ix + o) : 0);
    }
#pragma unroll
    for (int i = 0; i < NP; ++i)
      if (live<NP>(i, n)) part[i] = fmaf(r.coef[g][i], phi, part[i]);
  }
  for (int g = GR; g < G; ++g) {             // groups past the registers
    const int l = lane + 32 * g;
    const bool ok = l < L;
    const int* ix = term_idx + (size_t)(ok ? l : 0) * O;
    float phi = __shfl_sync(kFull, aug, ok ? __ldg(ix) : 0);
    for (int o = 1; o < O; ++o)
      phi *= __shfl_sync(kFull, aug, ok ? __ldg(ix + o) : 0);
    if (ok) {
#pragma unroll
      for (int i = 0; i < NP; ++i)
        if (live<NP>(i, n))
          part[i] = fmaf(__ldg(th + (size_t)i * L + l), phi, part[i]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < NP; ++i)
      if (live<NP>(i, n)) part[i] += __shfl_xor_sync(kFull, part[i], off);
  }
  float mine = 0.0f;
#pragma unroll
  for (int i = 0; i < NP; ++i)
    if (live<NP>(i, n) && lane == 1 + i) mine = part[i];
  return mine;
}

template <int OC, int GR, int NP>
__global__ void __launch_bounds__(kThreads, 1)
rk4_poly_kernel(const float* __restrict__ theta, const float* __restrict__ y0,
                const float* __restrict__ us,
                const int* __restrict__ term_idx, float* __restrict__ ys,
                int B, int n, int m, int L, int O, int T, float half_dt,
                float dt, float dt_sixth) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;                        // whole warps: no block sync
  const int G = (L + 31) / 32;
  const float* th = theta + (size_t)b * n * L;

  Terms<OC, GR, NP> r;
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    const int l = lane + 32 * g;
    const bool ok = l < L;
#pragma unroll
    for (int o = 0; o < OC; ++o)
      r.idx[g][o] = (ok && o < O) ? __ldg(term_idx + (size_t)l * O + o) : 0;
#pragma unroll
    for (int i = 0; i < NP; ++i)
      r.coef[g][i] =
          (ok && live<NP>(i, n)) ? __ldg(th + (size_t)i * L + l) : 0.0f;
  }

  const bool is_state = lane >= 1 && lane <= n;
  const bool is_input = lane > n && lane <= n + m;
  const int si = lane - 1, ui = lane - 1 - n;
  float y = is_state ? y0[(size_t)b * n + si] : 0.0f;
  float* out = ys + (size_t)b * (T + 1) * n;
  if (is_state) out[si] = y;
  const float* ub = us + (size_t)b * T * m;   // read only by input lanes
  float u_next = (is_input && T > 0) ? __ldg(ub + ui) : 0.0f;
  for (int t = 0; t < T; ++t) {
    const float u = u_next;
    if (is_input && t + 1 < T) u_next = __ldg(ub + (size_t)(t + 1) * m + ui);
    const float fixed = lane == 0 ? 1.0f : (is_input ? u : 0.0f);
    const float k1 = poly_rhs<OC, GR, NP>(is_state ? y : fixed, r, th,
                                          term_idx, lane, n, L, O, G);
    const float k2 = poly_rhs<OC, GR, NP>(is_state ? y + half_dt * k1 : fixed,
                                          r, th, term_idx, lane, n, L, O, G);
    const float k3 = poly_rhs<OC, GR, NP>(is_state ? y + half_dt * k2 : fixed,
                                          r, th, term_idx, lane, n, L, O, G);
    const float k4 = poly_rhs<OC, GR, NP>(is_state ? y + dt * k3 : fixed, r,
                                          th, term_idx, lane, n, L, O, G);
    y = y + dt_sixth * (k1 + 2.0f * k2 + 2.0f * k3 + k4);
    if (is_state) out[(size_t)(t + 1) * n + si] = y;
  }
}

template <int OC, int GR, int NP>
int launch(const float* theta, const float* y0, const float* us,
           const int* term_idx, float* ys, int B, int n, int m, int L, int O,
           int T, double dt, cudaStream_t stream) {
  const int grid = (B + kWarps - 1) / kWarps;
  rk4_poly_kernel<OC, GR, NP><<<grid, kThreads, 0, stream>>>(
      theta, y0, us, term_idx, ys, B, n, m, L, O, T, (float)(0.5 * dt),
      (float)dt, (float)(dt / 6.0));
  return (int)cudaGetLastError();
}

template <int OC, int GR>
int launch_n(const float* theta, const float* y0, const float* us,
             const int* term_idx, float* ys, int B, int n, int m, int L,
             int O, int T, double dt, cudaStream_t stream) {
#define RK4_LAUNCH(NP)                                                       \
  launch<OC, GR, NP>(theta, y0, us, term_idx, ys, B, n, m, L, O, T, dt, \
                     stream)
  switch (n) {
    case 1: return RK4_LAUNCH(1);
    case 2: return RK4_LAUNCH(2);
    case 3: return RK4_LAUNCH(3);
    case 4: return RK4_LAUNCH(4);
    default: return RK4_LAUNCH(RK4_MAX_N);
  }
#undef RK4_LAUNCH
}

template <int OC>
int launch_groups(const float* theta, const float* y0, const float* us,
                  const int* term_idx, float* ys, int B, int n, int m, int L,
                  int O, int T, double dt, cudaStream_t stream) {
  return L <= 32 ? launch_n<OC, 1>(theta, y0, us, term_idx, ys, B, n, m, L,
                                   O, T, dt, stream)
                 : launch_n<OC, 2>(theta, y0, us, term_idx, ys, B, n, m, L,
                                   O, T, dt, stream);
}

// ------------------------------------------------------------------------
// The adjoint of the warp path (see "The adjoint" at the top).
constexpr int kSmallChannels = 7;   // n + m <= 7: registered systems' reach

struct AdjointArgs {
  const float* theta;     // [B, n, L]
  const float* us;        // [B, T, m]; read only by input lanes
  const int* term_idx;    // [L, O]
  const float* ys;        // [B, T+1, n]: the forward's output
  const float* g_ys;      // [B, T+1, n]
  float* g_theta;         // [B, n, L] or null
  float* g_y0;            // [B, n] or null
  float* g_us;            // [B, T, m] or null
  int B, n, m, L, O, T;
  float half_dt, dt, dt_sixth;
};

// Add v to this lane's share of the cotangent of Xaug[j]; channel j >= 1
// sits in ch[j - 1], and the constant (j == 0) takes no gradient.
template <int NA>
__device__ __forceinline__ void to_channel(float (&ch)[NA], int j, float v) {
#pragma unroll
  for (int k = 0; k < NA; ++k) ch[k] += j == k + 1 ? v : 0.0f;
}

// The product of the factors o1 <= o < o2 of term l, skipping factor
// `skip`, read from term_idx (orders past the registers, and term groups
// past them).
__device__ __forceinline__ float factors(float x, const int* ix, bool ok,
                                         int o1, int o2, int skip) {
  float p = 1.0f;
  for (int o = o1; o < o2; ++o)
    if (o != skip) p *= __shfl_sync(kFull, x, ok ? __ldg(ix + o) : 0);
  return p;
}

// One vector-Jacobian product of the right-hand side at Xaug (this lane's
// entry x) with cotangent lam (all n on every lane): adds lam_i Phi_l to
// the lane's own terms' gradients (gth in registers, gth_mem past them),
// and leaves in ch, on every lane, the cotangent of Xaug's channels 1..n+m
// summed over all terms:  sum_l c_l dPhi_l/dXaug_j,  c_l = sum_i
// Theta[i, l] lam_i.
template <int OC, int GR, int NP, int NA>
__device__ __forceinline__ void poly_vjp(
    float x, const float (&lam)[NP], const Terms<OC, GR, NP>& r,
    float (&gth)[GR][NP], float* __restrict__ gth_mem,
    const float* __restrict__ th, const int* __restrict__ term_idx, int lane,
    int n, int na, int L, int O, int G, float (&ch)[NA]) {
#pragma unroll
  for (int k = 0; k < NA; ++k) ch[k] = 0.0f;
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    const int l = lane + 32 * g;
    const bool ok = l < L;
    const int* ix = term_idx + (size_t)(ok ? l : 0) * O;
    float f[OC];
#pragma unroll
    for (int o = 0; o < OC; ++o) f[o] = __shfl_sync(kFull, x, r.idx[g][o]);
    float phi = f[0];
#pragma unroll
    for (int o = 1; o < OC; ++o) phi *= f[o];
    const float ext = O > OC ? factors(x, ix, ok, OC, O, -1) : 1.0f;
    float c = 0.0f;
#pragma unroll
    for (int i = 0; i < NP; ++i)
      if (live<NP>(i, n)) {
        gth[g][i] = fmaf(lam[i], phi * ext, gth[g][i]);
        c = fmaf(r.coef[g][i], lam[i], c);
      }
#pragma unroll
    for (int o = 0; o < OC; ++o) {
      float rest = ext;
#pragma unroll
      for (int p = 0; p < OC; ++p)
        if (p != o) rest *= f[p];
      to_channel(ch, r.idx[g][o], c * rest);
    }
    for (int o = OC; o < O; ++o)
      to_channel(ch, ok ? __ldg(ix + o) : 0,
                 c * phi * factors(x, ix, ok, OC, O, o));
  }
  for (int g = GR; g < G; ++g) {             // groups past the registers
    const int l = lane + 32 * g;
    const bool ok = l < L;
    const int* ix = term_idx + (size_t)(ok ? l : 0) * O;
    const float phi = factors(x, ix, ok, 0, O, -1);
    float c = 0.0f;
    if (ok) {
#pragma unroll
      for (int i = 0; i < NP; ++i)
        if (live<NP>(i, n)) {
          if (gth_mem) gth_mem[(size_t)i * L + l] += lam[i] * phi;
          c = fmaf(__ldg(th + (size_t)i * L + l), lam[i], c);
        }
    }
    for (int o = 0; o < O; ++o)
      to_channel(ch, ok ? __ldg(ix + o) : 0, c * factors(x, ix, ok, 0, O, o));
  }
  // the small instantiations reduce every channel, unused ones too: with
  // no branch between them the shuffles pipeline
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < NA; ++k)
      if (NA == kSmallChannels || k < na)
        ch[k] += __shfl_xor_sync(kFull, ch[k], off);
  }
}

// After a stage's product: the state channels join y's cotangent a, and
// an input lane takes its own channel into gu (other lanes' gu is unused).
template <int NP, int NA>
__device__ __forceinline__ void take(const float (&ch)[NA], float (&a)[NP],
                                     float& gu, int lane, int n) {
#pragma unroll
  for (int k = 0; k < NA; ++k) gu += k == lane - 1 ? ch[k] : 0.0f;
#pragma unroll
  for (int i = 0; i < NP; ++i)
    if (live<NP>(i, n)) a[i] += ch[i];
}

// One warp an instance, as the forward.  The cotangent a of the state,
// the stage cotangents and the channel sums are held on every lane, so no
// lane waits on a broadcast; the stage states are recomputed by the
// forward's own code from the saved ys.
template <int OC, int GR, int NP, int NA>
__global__ void __launch_bounds__(kThreads, 1)
rk4_adjoint_kernel(const AdjointArgs p) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= p.B) return;                      // whole warps: no block sync
  const int n = p.n, m = p.m, L = p.L, O = p.O, T = p.T;
  const int G = (L + 31) / 32;
  const int* __restrict__ term_idx = p.term_idx;
  const float* __restrict__ th = p.theta + (size_t)b * n * L;

  Terms<OC, GR, NP> r;
  float gth[GR][NP];
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    const int l = lane + 32 * g;
    const bool ok = l < L;
#pragma unroll
    for (int o = 0; o < OC; ++o)
      r.idx[g][o] = (ok && o < O) ? __ldg(term_idx + (size_t)l * O + o) : 0;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      r.coef[g][i] =
          (ok && live<NP>(i, n)) ? __ldg(th + (size_t)i * L + l) : 0.0f;
      gth[g][i] = 0.0f;
    }
  }
  // past the registers each (i, l) is one lane's: accumulate in place
  float* gth_mem = p.g_theta ? p.g_theta + (size_t)b * n * L : nullptr;
  if (gth_mem)
    for (int l = lane + 32 * GR; l < L; l += 32)
      for (int i = 0; i < n; ++i) gth_mem[(size_t)i * L + l] = 0.0f;

  const bool is_state = lane >= 1 && lane <= n;
  const bool is_input = lane > n && lane <= n + m;
  const int si = lane - 1, ui = lane - 1 - n;
  const float* yb = p.ys + (size_t)b * (T + 1) * n;
  const float* gb = p.g_ys + (size_t)b * (T + 1) * n;
  const float* ub = p.us + (size_t)b * T * m;   // read only by input lanes

  float a[NP];                               // cotangent of y_{t+1}
#pragma unroll
  for (int i = 0; i < NP; ++i)
    a[i] = live<NP>(i, n) ? __ldg(gb + (size_t)T * n + i) : 0.0f;
  // step t's entries of Xaug, read a step ahead of the chain
  float y_next = (is_state && T > 0) ? __ldg(yb + (size_t)(T - 1) * n + si)
                                     : 0.0f;
  float u_next = (is_input && T > 0) ? __ldg(ub + (size_t)(T - 1) * m + ui)
                                     : 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    const float y = y_next, u = u_next;
    if (t > 0) {
      if (is_state) y_next = __ldg(yb + (size_t)(t - 1) * n + si);
      if (is_input) u_next = __ldg(ub + (size_t)(t - 1) * m + ui);
    }
    float g_t[NP];                           // g_ys[t], added last
#pragma unroll
    for (int i = 0; i < NP; ++i)
      g_t[i] = live<NP>(i, n) ? __ldg(gb + (size_t)t * n + i) : 0.0f;

    // the forward's stages, by the forward's code
    const float fixed = lane == 0 ? 1.0f : (is_input ? u : 0.0f);
    const float x1 = is_state ? y : fixed;
    const float k1 =
        poly_rhs<OC, GR, NP>(x1, r, th, term_idx, lane, n, L, O, G);
    const float x2 = is_state ? y + p.half_dt * k1 : fixed;
    const float k2 =
        poly_rhs<OC, GR, NP>(x2, r, th, term_idx, lane, n, L, O, G);
    const float x3 = is_state ? y + p.half_dt * k2 : fixed;
    const float k3 =
        poly_rhs<OC, GR, NP>(x3, r, th, term_idx, lane, n, L, O, G);
    const float x4 = is_state ? y + p.dt * k3 : fixed;

    // y_{t+1} = y + dt/6 (k1 + 2 k2 + 2 k3 + k4): k4's cotangent is s,
    // k3's 2 s + dt gz4, k2's 2 s + dt/2 gz3, k1's s + dt/2 gz2, and y's
    // a + gz4 + gz3 + gz2 + gz1 + g_ys[t]
    float s[NP], lam[NP], ch[NA];
#pragma unroll
    for (int i = 0; i < NP; ++i) s[i] = p.dt_sixth * a[i];
    float gu = 0.0f;                         // this input lane's channel
    poly_vjp<OC, GR, NP, NA>(x4, s, r, gth, gth_mem, th, term_idx, lane, n,
                             n + m, L, O, G, ch);
    take(ch, a, gu, lane, n);
#pragma unroll
    for (int i = 0; i < NP; ++i) lam[i] = fmaf(p.dt, ch[i], 2.0f * s[i]);
    poly_vjp<OC, GR, NP, NA>(x3, lam, r, gth, gth_mem, th, term_idx, lane, n,
                             n + m, L, O, G, ch);
    take(ch, a, gu, lane, n);
#pragma unroll
    for (int i = 0; i < NP; ++i) lam[i] = fmaf(p.half_dt, ch[i], 2.0f * s[i]);
    poly_vjp<OC, GR, NP, NA>(x2, lam, r, gth, gth_mem, th, term_idx, lane, n,
                             n + m, L, O, G, ch);
    take(ch, a, gu, lane, n);
#pragma unroll
    for (int i = 0; i < NP; ++i) lam[i] = fmaf(p.half_dt, ch[i], s[i]);
    poly_vjp<OC, GR, NP, NA>(x1, lam, r, gth, gth_mem, th, term_idx, lane, n,
                             n + m, L, O, G, ch);
    take(ch, a, gu, lane, n);
#pragma unroll
    for (int i = 0; i < NP; ++i) a[i] += g_t[i];
    if (p.g_us && is_input)
      p.g_us[(size_t)b * T * m + (size_t)t * m + ui] = gu;
  }

  if (p.g_y0 && is_state) {
    float v = 0.0f;
#pragma unroll
    for (int i = 0; i < NP; ++i) v = i == si ? a[i] : v;
    p.g_y0[(size_t)b * n + si] = v;
  }
  if (gth_mem) {
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      const int l = lane + 32 * g;
      if (l < L) {
#pragma unroll
        for (int i = 0; i < NP; ++i)
          if (live<NP>(i, n)) gth_mem[(size_t)i * L + l] = gth[g][i];
      }
    }
  }
}

template <int OC, int GR, int NP, int NA>
int launch_adjoint(const AdjointArgs& p, cudaStream_t stream) {
  rk4_adjoint_kernel<OC, GR, NP, NA>
      <<<(p.B + kWarps - 1) / kWarps, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// n and the channels exact up to n = 4 and n + m = kSmallChannels (every
// registered system); past them, warp-uniform guards up to the warp
// path's limits.
template <int OC, int GR>
int adjoint_n(const AdjointArgs& p, cudaStream_t stream) {
  if (p.n + p.m <= kSmallChannels) {
    switch (p.n) {
      case 1: return launch_adjoint<OC, GR, 1, kSmallChannels>(p, stream);
      case 2: return launch_adjoint<OC, GR, 2, kSmallChannels>(p, stream);
      case 3: return launch_adjoint<OC, GR, 3, kSmallChannels>(p, stream);
      case 4: return launch_adjoint<OC, GR, 4, kSmallChannels>(p, stream);
      default: break;
    }
  }
  return launch_adjoint<OC, GR, RK4_MAX_N, RK4_MAX_AUG - 1>(p, stream);
}

template <int OC>
int adjoint_groups(const AdjointArgs& p, cudaStream_t stream) {
  return p.L <= 32 ? adjoint_n<OC, 1>(p, stream) : adjoint_n<OC, 2>(p, stream);
}

// ------------------------------------------------------------------------
// The wide path: one block of kWideThreads per instance.
constexpr int kWideWarps = 16;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideChunk = 8192;           // Phi terms a pass, when chunked
constexpr int kAcc = 8;                    // accumulators a lane (pow2)
constexpr int kMaxSmemBytes = 227 * 1024;  // Hopper's opt-in limit a block

// Floats of shared memory: Xaug [1+n+m], k [4][n], Phi [chunk], and Theta
// [n, L] when it is staged.
__host__ __device__ inline int wide_floats(int n, int m, int chunk,
                                           bool stage) {
  return 1 + n + m + 4 * n + chunk + (stage ? n * chunk : 0);
}

// k_s = Theta . Phi(Xaug) into k (shared), the whole block.
__device__ __forceinline__ void wide_rhs(
    const float* __restrict__ aug, float* __restrict__ k,
    float* __restrict__ phi, const float* th, const int* __restrict__ term_idx,
    int n, int L, int O, int chunk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int l0 = 0; l0 < L; l0 += chunk) {
    const int lc = min(chunk, L - l0);
    for (int l = threadIdx.x; l < lc; l += kWideThreads) {
      const int* ix = term_idx + (size_t)(l0 + l) * O;
      float p = aug[__ldg(ix)];
      for (int o = 1; o < O; ++o) p *= aug[__ldg(ix + o)];
      phi[l] = p;
    }
    __syncthreads();
    for (int i = warp; i < n; i += kWideWarps) {
      const float* row = th + (size_t)i * L + l0;
      // kAcc independent loads of Theta in flight a lane: with Theta in
      // L2, the reduction is bound by how many loads are outstanding
      float acc[kAcc];
#pragma unroll
      for (int a = 0; a < kAcc; ++a) acc[a] = 0.0f;
      int l = lane;
      for (; l + 32 * (kAcc - 1) < lc; l += 32 * kAcc) {
#pragma unroll
        for (int a = 0; a < kAcc; ++a)
          acc[a] = fmaf(row[l + 32 * a], phi[l + 32 * a], acc[a]);
      }
      for (; l < lc; l += 32) acc[0] = fmaf(row[l], phi[l], acc[0]);
#pragma unroll
      for (int w = kAcc / 2; w > 0; w >>= 1)
#pragma unroll
        for (int a = 0; a < w; ++a) acc[a] += acc[a + w];
      float sum = acc[0];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      if (lane == 0) k[i] = l0 == 0 ? sum : k[i] + sum;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kWideThreads, 1)
rk4_poly_wide_kernel(const float* __restrict__ theta,
                     const float* __restrict__ y0,
                     const float* __restrict__ us,
                     const int* __restrict__ term_idx, float* __restrict__ ys,
                     int n, int m, int L, int O, int T, int chunk, int stage,
                     float half_dt, float dt, float dt_sixth) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  float* aug = smem;                           // [1 + n + m]
  float* ks = aug + 1 + n + m;                 // [4][n]
  float* phi = ks + 4 * n;                     // [chunk]
  const float* th = theta + (size_t)b * n * L;
  if (stage) {                                 // Theta once, on chip
    float* s_th = phi + chunk;
    for (int i = threadIdx.x; i < n * L; i += kWideThreads) s_th[i] = th[i];
    th = s_th;
  }
  const int tid = threadIdx.x;
  // thread i < n keeps y_i in a register; thread n + j owns u_j
  float y = tid < n ? y0[(size_t)b * n + tid] : 0.0f;
  float* out = ys + (size_t)b * (T + 1) * n;
  if (tid < n) out[tid] = y;
  const float* ub = us + (size_t)b * T * m;
  if (tid == 0) aug[0] = 1.0f;
  for (int t = 0; t < T; ++t) {
    if (tid >= n && tid < n + m) aug[1 + tid] = __ldg(ub + (size_t)t * m +
                                                      (tid - n));
    if (tid < n) aug[1 + tid] = y;
    __syncthreads();
    wide_rhs(aug, ks, phi, th, term_idx, n, L, O, chunk);
    if (tid < n) aug[1 + tid] = y + half_dt * ks[tid];
    __syncthreads();
    wide_rhs(aug, ks + n, phi, th, term_idx, n, L, O, chunk);
    if (tid < n) aug[1 + tid] = y + half_dt * ks[n + tid];
    __syncthreads();
    wide_rhs(aug, ks + 2 * n, phi, th, term_idx, n, L, O, chunk);
    if (tid < n) aug[1 + tid] = y + dt * ks[2 * n + tid];
    __syncthreads();
    wide_rhs(aug, ks + 3 * n, phi, th, term_idx, n, L, O, chunk);
    if (tid < n) {
      y = y + dt_sixth * (ks[tid] + 2.0f * ks[n + tid] +
                          2.0f * ks[2 * n + tid] + ks[3 * n + tid]);
      out[(size_t)(t + 1) * n + tid] = y;
    }
    // the next step's writes of aug follow wide_rhs's closing barrier and
    // touch no value a thread still reads
  }
}

int launch_wide(const float* theta, const float* y0, const float* us,
                const int* term_idx, float* ys, int B, int n, int m, int L,
                int O, int T, double dt, cudaStream_t stream) {
  if (n > kWideThreads || n + m > kWideThreads)
    return (int)cudaErrorInvalidValue;    // a thread per state and input
  const bool stage =
      (size_t)wide_floats(n, m, L, true) * 4 <= (size_t)kMaxSmemBytes;
  const int chunk = stage ? L : (L < kWideChunk ? L : kWideChunk);
  const int bytes = wide_floats(n, m, chunk, stage) * 4;
  if (bytes > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  static bool opted = false;
  if (bytes > 48 * 1024 && !opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        rk4_poly_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmemBytes);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  rk4_poly_wide_kernel<<<B, kWideThreads, bytes, stream>>>(
      theta, y0, us, term_idx, ys, n, m, L, O, T, chunk, stage ? 1 : 0,
      (float)(0.5 * dt), (float)dt, (float)(dt / 6.0));
  return (int)cudaGetLastError();
}

}  // namespace

// The warp path's limits; rk4_poly_launch takes wider shapes through the
// wide path.
extern "C" int rk4_poly_max_n() { return RK4_MAX_N; }
extern "C" int rk4_poly_max_aug() { return RK4_MAX_AUG; }

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rk4_poly_launch(const float* theta, const float* y0,
                               const float* us, const int* term_idx,
                               float* ys, int B, int n, int m, int L, int O,
                               int T, double dt, void* stream) {
  if (B < 1 || n < 1 || m < 0 || L < 1 || O < 1 || T < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > RK4_MAX_N || 1 + n + m > RK4_MAX_AUG)
    return launch_wide(theta, y0, us, term_idx, ys, B, n, m, L, O, T, dt, st);
  return O <= 3 ? launch_groups<3>(theta, y0, us, term_idx, ys, B, n, m, L, O,
                                   T, dt, st)
                : launch_groups<4>(theta, y0, us, term_idx, ys, B, n, m, L, O,
                                   T, dt, st);
}

// The adjoint of rk4_poly_launch on the warp path's shapes (the wide ones
// return cudaErrorInvalidValue: their backward is not a kernel).  Each
// gradient pointer may be null, and is then not written; returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int rk4_adjoint_launch(const float* theta, const float* us,
                                  const int* term_idx, const float* ys,
                                  const float* g_ys, float* g_theta,
                                  float* g_y0, float* g_us, int B, int n,
                                  int m, int L, int O, int T, double dt,
                                  void* stream) {
  if (B < 1 || n < 1 || m < 0 || L < 1 || O < 1 || T < 0 ||
      n > RK4_MAX_N || 1 + n + m > RK4_MAX_AUG)
    return (int)cudaErrorInvalidValue;
  const AdjointArgs p{theta, us, term_idx, ys, g_ys, g_theta, g_y0, g_us,
                      B, n, m, L, O, T, (float)(0.5 * dt), (float)dt,
                      (float)(dt / 6.0)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return O <= 3 ? adjoint_groups<3>(p, st) : adjoint_groups<4>(p, st);
}
