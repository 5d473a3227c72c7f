// Fused GRU sequence scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gru/gru.py::_gru_kernel
// (launched by gru_scan_pallas).  Same math as kernels/gru/ref.py, gate
// layout [z | r | c] along the last weight axis:
//
//   z = sigmoid(x Wx_z + b_z + h Wh_z)     r = sigmoid(x Wx_r + b_r + h Wh_r)
//   c = tanh(x Wx_c + b_c + (r*h) Wh_c)     h = (1 - z) h + z c
//
// Layout: xs [F, B, T, D], h0 [F, B, H], wx [F, D, 3H], wh [F, H, 3H],
// b [F, 3H] -> hs [F, B, T, H], hT [F, B, H]; fp32 throughout.  F is the
// fleet axis of per-slot weights (F = 1 for shared weights).
//
// Grid (F, ceil(B / bt)); block (H, bt): thread (j, i) owns hidden unit j of
// sequence i of the tile.  The block copies its slot's Wx, Wh and b into
// shared memory once and keeps them there for all T steps; h and r*h live in
// shared memory, and the input projection x_t Wx + b is computed in the
// kernel body each step (the TPU kernel hoists it into one MXU matmul; here
// D is 4, so it is 3*D FMAs per thread per step).  Three barriers per step:
// after staging x_t, between the z/r pass and the candidate pass (everyone
// must see r*h), and before h is overwritten.  The ragged batch edge is
// masked in the kernel: threads past B compute on zeros and store nothing.
//
// Bound on this card, at the main-path shape (F=8 slots x B=8 windows, T=24,
// D=4, H=32): about 10.6 MFLOP and 0.35 MB moved, so the roofline bound is
// about 0.16 us (fp32 at 67 TFLOP/s; 0.10 us for the bytes at 3.35 TB/s).
// Neither is the real limit: that is the chain of T=24 dependent steps, each
// an H-long dot product read from shared memory plus three barriers.  The
// kernel keeps every operand on chip across that chain, so device memory is
// touched once per input and output.
//
// Accuracy: fp32 FMA with expf/tanhf (no --use_fast_math), so the kernel
// holds 1e-5 against the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void gru_scan_kernel(const float* __restrict__ xs,
                                const float* __restrict__ h0,
                                const float* __restrict__ wx,
                                const float* __restrict__ wh,
                                const float* __restrict__ b,
                                float* __restrict__ hs,
                                float* __restrict__ hT,
                                int B, int T, int D, int H) {
  extern __shared__ float smem[];
  const int H3 = 3 * H;
  const int bt = blockDim.y;
  float* s_wx = smem;                // [D, 3H]
  float* s_wh = s_wx + D * H3;       // [H, 3H]
  float* s_b = s_wh + H * H3;        // [3H]
  float* s_h = s_b + H3;             // [bt, H]
  float* s_rh = s_h + bt * H;        // [bt, H]
  float* s_x = s_rh + bt * H;        // [bt, D]

  const int f = blockIdx.x;
  const int j = threadIdx.x;
  const int i = threadIdx.y;
  const int seq = blockIdx.y * bt + i;
  const bool valid = seq < B;
  const int tid = i * H + j;
  const int nthreads = bt * H;

  const float* wx_f = wx + (size_t)f * D * H3;
  const float* wh_f = wh + (size_t)f * H * H3;
  const float* b_f = b + (size_t)f * H3;
  for (int k = tid; k < D * H3; k += nthreads) s_wx[k] = wx_f[k];
  for (int k = tid; k < H * H3; k += nthreads) s_wh[k] = wh_f[k];
  for (int k = tid; k < H3; k += nthreads) s_b[k] = b_f[k];

  const size_t row = (size_t)f * B + seq;     // flat sequence index
  float h = valid ? h0[row * H + j] : 0.0f;
  float* my_h = s_h + i * H;
  float* my_rh = s_rh + i * H;
  float* my_x = s_x + i * D;
  my_h[j] = h;

  for (int t = 0; t < T; ++t) {
    for (int d = j; d < D; d += H)
      my_x[d] = valid ? xs[(row * T + t) * D + d] : 0.0f;
    __syncthreads();

    float xz = 0.0f, xr = 0.0f, xc = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float x = my_x[d];
      const float* w = s_wx + d * H3;
      xz = fmaf(x, w[j], xz);
      xr = fmaf(x, w[H + j], xr);
      xc = fmaf(x, w[2 * H + j], xc);
    }
    xz += s_b[j];
    xr += s_b[H + j];
    xc += s_b[2 * H + j];

    float hz = 0.0f, hr = 0.0f;
    for (int k = 0; k < H; ++k) {
      const float hk = my_h[k];
      const float* w = s_wh + k * H3;
      hz = fmaf(hk, w[j], hz);
      hr = fmaf(hk, w[H + j], hr);
    }
    const float z = sigmoid_f(xz + hz);
    const float r = sigmoid_f(xr + hr);
    my_rh[j] = r * h;
    __syncthreads();

    float hc = 0.0f;
    for (int k = 0; k < H; ++k)
      hc = fmaf(my_rh[k], s_wh[k * H3 + 2 * H + j], hc);
    const float c = tanhf(xc + hc);
    h = (1.0f - z) * h + z * c;
    __syncthreads();             // every read of s_h / s_x for step t is done

    my_h[j] = h;
    if (valid) hs[(row * T + t) * H + j] = h;
  }
  if (valid) hT[row * H + j] = h;
}

}  // namespace

extern "C" int gru_scan_smem_bytes(int D, int H, int bt) {
  return (D * 3 * H + H * 3 * H + 3 * H + 2 * bt * H + bt * D) *
         (int)sizeof(float);
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int gru_scan_launch(const float* xs, const float* h0,
                               const float* wx, const float* wh,
                               const float* b, float* hs, float* hT,
                               int F, int B, int T, int D, int H, int bt,
                               void* stream) {
  const int smem = gru_scan_smem_bytes(D, H, bt);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gru_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(F, (B + bt - 1) / bt);
  dim3 block(H, bt);
  gru_scan_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      xs, h0, wx, wh, b, hs, hT, B, T, D, H);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
