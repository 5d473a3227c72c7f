// Fused RK4 polynomial-ODE integrator for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rk4/rk4.py::_rk4_kernel
// (launched by rk4_poly_solve_pallas).  Same contract as kernels/rk4/ref.py:
//
//   dY/dt = Theta . Phi(Y, u),  Phi_l = prod_o Xaug[term_idx[l, o]],
//   Xaug = [1, Y, u],  zero-order-hold u over each step,
//
// theta [B, n, L], y0 [B, n], us [B, T, m], term_idx [L, O] int32
// -> ys [B, T+1, n] with y0 in row 0; fp32 throughout.
//
// One thread per instance; the T-step loop runs inside the thread.  The
// block's Theta rows (n*L floats per instance) are staged in shared memory,
// coefficient-major ([n*L][block]) so that the threads of a warp read
// consecutive words, and term_idx is staged beside them.  Phi is evaluated
// by direct indexing into the thread's own Xaug: the TPU kernel's one-hot
// gather-as-matmul (rk4.py:8-11, :44-51) worked around a missing lane gather
// and has no place here.  m == 0 needs no dummy input channel: the kernel
// never reads `us` then.  The ragged batch edge is masked in the kernel.
//
// Bound on this card, at the refit shape (B = 64 instances, T = 24, n = 3,
// L = 35, O = 3, m = 1): about 2 MFLOP and 53 KB moved, i.e. 0.03 us of
// fp32 work and 0.016 us of memory traffic.  Neither is the limit: each
// thread walks a chain of 4*T dependent right-hand-side evaluations, so the
// kernel is latency-bound; keeping Theta on chip for the whole chain is what
// the design does about it.

#include <cuda_runtime.h>

#define RK4_MAX_N 16
#define RK4_MAX_AUG 32   // 1 + n + m

namespace {

__device__ __forceinline__ void poly_rhs(const float* __restrict__ y,
                                         float* __restrict__ aug,
                                         const float* __restrict__ s_theta,
                                         const int* __restrict__ s_idx,
                                         float* __restrict__ out,
                                         int n, int L, int O, int stride) {
  for (int i = 0; i < n; ++i) aug[1 + i] = y[i];
  for (int i = 0; i < n; ++i) out[i] = 0.0f;
  for (int l = 0; l < L; ++l) {
    const int* idx = s_idx + l * O;
    float phi = aug[idx[0]];
    for (int o = 1; o < O; ++o) phi *= aug[idx[o]];
    for (int i = 0; i < n; ++i)
      out[i] = fmaf(s_theta[(i * L + l) * stride], phi, out[i]);
  }
}

__global__ void rk4_poly_kernel(const float* __restrict__ theta,
                                const float* __restrict__ y0,
                                const float* __restrict__ us,
                                const int* __restrict__ term_idx,
                                float* __restrict__ ys,
                                int B, int n, int m, int L, int O, int T,
                                float half_dt, float dt, float dt_sixth) {
  extern __shared__ float smem[];
  const int nb = blockDim.x;
  const int nL = n * L;
  float* s_theta = smem;                                     // [nL][nb]
  int* s_idx = reinterpret_cast<int*>(s_theta + (size_t)nL * nb);  // [L*O]

  const int base = blockIdx.x * nb;
  const int count = min(nb, B - base);
  const float* theta_blk = theta + (size_t)base * nL;
  for (int e = threadIdx.x; e < count * nL; e += nb) {
    const int inst = e / nL;
    s_theta[(e - inst * nL) * nb + inst] = theta_blk[e];
  }
  for (int e = threadIdx.x; e < L * O; e += nb) s_idx[e] = term_idx[e];
  __syncthreads();

  const int lane = threadIdx.x;
  const int bi = base + lane;
  if (bi >= B) return;
  const float* my_theta = s_theta + lane;

  float y[RK4_MAX_N], k1[RK4_MAX_N], k2[RK4_MAX_N], k3[RK4_MAX_N],
      k4[RK4_MAX_N], tmp[RK4_MAX_N], aug[RK4_MAX_AUG];
  aug[0] = 1.0f;
  float* out = ys + (size_t)bi * (T + 1) * n;
  for (int i = 0; i < n; ++i) {
    y[i] = y0[(size_t)bi * n + i];
    out[i] = y[i];
  }
  for (int t = 0; t < T; ++t) {
    const float* u = us + ((size_t)bi * T + t) * m;
    for (int q = 0; q < m; ++q) aug[1 + n + q] = u[q];
    poly_rhs(y, aug, my_theta, s_idx, k1, n, L, O, nb);
    for (int i = 0; i < n; ++i) tmp[i] = y[i] + half_dt * k1[i];
    poly_rhs(tmp, aug, my_theta, s_idx, k2, n, L, O, nb);
    for (int i = 0; i < n; ++i) tmp[i] = y[i] + half_dt * k2[i];
    poly_rhs(tmp, aug, my_theta, s_idx, k3, n, L, O, nb);
    for (int i = 0; i < n; ++i) tmp[i] = y[i] + dt * k3[i];
    poly_rhs(tmp, aug, my_theta, s_idx, k4, n, L, O, nb);
    for (int i = 0; i < n; ++i) {
      y[i] = y[i] + dt_sixth * (k1[i] + 2.0f * k2[i] + 2.0f * k3[i] + k4[i]);
      out[(size_t)(t + 1) * n + i] = y[i];
    }
  }
}

}  // namespace

extern "C" int rk4_poly_max_n() { return RK4_MAX_N; }
extern "C" int rk4_poly_max_aug() { return RK4_MAX_AUG; }

extern "C" int rk4_poly_smem_bytes(int n, int L, int O, int nb) {
  return (n * L * nb) * (int)sizeof(float) + L * O * (int)sizeof(int);
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rk4_poly_launch(const float* theta, const float* y0,
                               const float* us, const int* term_idx,
                               float* ys, int B, int n, int m, int L, int O,
                               int T, double dt, int nb, void* stream) {
  const int smem = rk4_poly_smem_bytes(n, L, O, nb);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rk4_poly_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (B + nb - 1) / nb;
  rk4_poly_kernel<<<grid, nb, smem, (cudaStream_t)stream>>>(
      theta, y0, us, term_idx, ys, B, n, m, L, O, T, (float)(0.5 * dt),
      (float)dt, (float)(dt / 6.0));
  return (int)cudaGetLastError();
}
