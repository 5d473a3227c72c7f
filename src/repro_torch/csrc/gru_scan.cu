// Fused GRU sequence scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gru/gru.py::_gru_kernel
// (line 27, launched by gru_scan_pallas).  Same math as kernels/gru/ref.py,
// gate layout [z | r | c] along the last weight axis:
//
//   z = sigmoid(x Wx_z + b_z + h Wh_z)     r = sigmoid(x Wx_r + b_r + h Wh_r)
//   c = tanh(x Wx_c + b_c + (r*h) Wh_c)     h = (1 - z) h + z c
//
// Layout: xs [F, B, T, D], h0 [F, B, H], wx [F, D, 3H], wh [F, H, 3H],
// b [F, 3H] -> hs [F, B, T, H], hT [F, B, H]; fp32 throughout.  F is the
// fleet axis of per-slot weights (F = 1 for shared weights).
//
// What bounds it.  At the online tick's shape (F=8 slots x B=8 windows,
// T=24, D=4, H=32) the work is 10.6 MFLOP against 0.35 MB moved: 0.16 us
// of f32 operations at 67 TFLOP/s, 0.10 us of bytes at 3.35 TB/s.  At the
// offline fleet's (F=16 x B=32, H=64) it is 321 MFLOP against 4.45 MB:
// 4.8 us of operations, 1.3 us of bytes; at F-8 training's (F=1 x B=64,
// H=96) 88 MFLOP, 1.3 us of operations.  Neither is the limit.  Each
// sequence is a chain of T dependent steps, and a step is itself a short
// chain: the z and r dot products over h, two sigmoids, the candidate's
// dot product over r*h (which needs every unit's r), a tanh and the update.
// So the floor is T x one step's latency, and a step's FMAs (3H^2 / 32W a
// lane) are issued by the sequence's own W warps alone.
//
// Design: one block per sequence, W = ceil(H/32) warps (1..5), lane j of
// warp q owning hidden unit 32q + j, and everything that does not depend
// on h kept off the chain.
//   * Wh on chip.  H <= 64 (W <= 2): each lane keeps its three Wh columns
//     (3H floats) in registers, loaded once.  64 < H (W = 3..5): Wh sits
//     once in the block's shared memory, row-major as in global memory,
//     staged by cp.async before the chain; lanes read consecutive columns
//     of a row, so no bank conflicts.  The width this exists for is F-8
//     training's hidden 96 (examples/train_f8_crusader.py:42).  Wh must
//     fit the block's 227 KB, so H <= 136 at D = 4, the widths the
//     block-per-slot design took (gru_scan_max_hidden(D)).
//   * Prologue, per chunk of up to 32 steps: each warp stages the chunk's x
//     [TC, D] in its shared memory and computes xp = x Wx + b for every
//     step of the chunk (the TPU kernel's hoisted input projection) into a
//     per-lane slice of shared memory; with D <= 4, Wx sits in registers
//     too.  No global load and no input product remain inside the chain.
//   * h and r*h are exchanged through two shared buffers, written one float
//     a lane and read back as float4 broadcasts, with a barrier after each
//     write: two a step, __syncwarp at W = 1, else __syncthreads (the
//     block is the sequence).  Each dot product runs over four
//     accumulators (k mod 4).
//   * hs is stored coalesced, 128 bytes a warp a step, and nothing waits
//     on the store.
// Every register array is indexed by unrolled loops only, so no
// instantiation has a stack frame.
// Accuracy: fp32 FMA with expf/tanhf (no --use_fast_math), so the kernel
// holds 1e-5 against the plain PyTorch version.
//
// The wide path.  Past gru_scan_max_hidden(D) (160 at most; 136 at
// D = 4, 108 at D = 16) Wh no longer fits a block's shared memory beside
// the prologue, and one block per sequence instead runs
// min(1024, 32 ceil(H/32)) threads, each owning the units j = tid,
// tid + blockDim, ...:
//   * Wh is read from device memory on every step, row-major as stored, so
//     the threads of a warp read consecutive columns of a row (coalesced);
//     3H^2 floats a step (786 KB at H = 256), which stay in L2;
//   * h, r*h and z live in shared memory [3][H]; two block barriers a step,
//     as on the fast paths;
//   * x W_x + b is computed for the thread's unit at each step.
// A right and simple path; its times are in PERF.md.
//
// Measured (chip_smoke.py phase 7, NVIDIA H100 80GB HBM3, 700.00 W):
// about 0.010 ms at the tick's shape, 0.018 ms at the fleet's and 0.034 ms
// at F-8 training's, against about 0.034, 0.061 and 0.069 ms for the
// block-per-slot design before it (a thread per unit, Wh in shared memory,
// three block barriers a step).  Times in PERF.md.

#include <cuda_runtime.h>

#define GRU_MAX_W 5

namespace {

constexpr int kMaxChunk = 32;              // steps per prologue
constexpr int kMaxSmemBytes = 227 * 1024;  // Hopper's opt-in limit a block

// 1 / (1 + e^-x); __frcp_rn is the correctly rounded reciprocal, the same
// value as the IEEE division 1.0f / y in fewer instructions.
__device__ __forceinline__ float sigmoid_f(float x) {
  return __frcp_rn(1.0f + expf(-x));
}

__device__ __forceinline__ float sum4(const float (&a)[4]) {
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// Floats of x's rows in shared memory: D rounded up to a float4, at least
// one.
__host__ __device__ inline int x_pitch(int D) {
  return D <= 4 ? 4 : (D + 3) & ~3;
}

// Rows of Wh in shared memory: H rounded up to a float4 of h, the rows
// past H zero.
__host__ __device__ inline int wh_rows(int H) { return (H + 3) & ~3; }

// Floats of a block's shared memory: h and r*h [32 W] each, Wh
// [wh_rows(H), 3H] when W > 2, and per warp xp [TC, 3, 32] and x [TC, XP].
__host__ __device__ inline int smem_floats(int W, int TC, int D, int H) {
  return 64 * W + (W > 2 ? wh_rows(H) * 3 * H : 0) +
         W * TC * (96 + x_pitch(D));
}

// Steps a prologue: up to kMaxChunk, as many as fit a block's shared
// memory; 0 if not one does.
int chunk_steps(int T, int D, int H) {
  const int W = (H + 31) / 32;
  int TC = T < 1 ? 1 : (T < kMaxChunk ? T : kMaxChunk);
  while (TC > 0 && smem_floats(W, TC, D, H) * 4 > kMaxSmemBytes) --TC;
  return TC;
}

// The W warps of the block's sequence wait for each other's shared stores.
template <int W>
__device__ __forceinline__ void seq_sync() {
  if constexpr (W == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// acc[g][i] += sum over k = 4 k4 + i of v[k] Wh[k, (G0+g) H + the lane's
// unit].  Registers (W <= 2): w[g][k] for k < 32 W.  Shared memory
// (W > 2): s_wc points at the lane's unit in row 0, rows 3H apart, and
// the rows past H are zero.
template <int W, int G0, int NG, int NR>
__device__ __forceinline__ void dot_pass(float (&acc)[NG][4], const float* v,
                                         int H, const float (&w)[3][NR],
                                         const float* s_wc) {
  const float4* v4 = reinterpret_cast<const float4*>(v);
  if constexpr (W <= 2) {
#pragma unroll
    for (int k4 = 0; k4 < 8 * W; ++k4) {
      const float4 hv = v4[k4];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        acc[g][0] = fmaf(hv.x, w[G0 + g][4 * k4 + 0], acc[g][0]);
        acc[g][1] = fmaf(hv.y, w[G0 + g][4 * k4 + 1], acc[g][1]);
        acc[g][2] = fmaf(hv.z, w[G0 + g][4 * k4 + 2], acc[g][2]);
        acc[g][3] = fmaf(hv.w, w[G0 + g][4 * k4 + 3], acc[g][3]);
      }
      // at W = 2, a fence every 16 values of v: hoisting all 64 loads
      // would take 64 registers beside Wh's 192, and ptxas would spill
      if (W == 2 && k4 % 4 == 3) __syncwarp();
    }
  } else {
    const int H3 = 3 * H;
#pragma unroll 4
    for (int k4 = 0; k4 < wh_rows(H) / 4; ++k4) {
      const float4 hv = v4[k4];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float* p = s_wc + 4 * k4 * H3 + (G0 + g) * H;
        acc[g][0] = fmaf(hv.x, p[0], acc[g][0]);
        acc[g][1] = fmaf(hv.y, p[H3], acc[g][1]);
        acc[g][2] = fmaf(hv.z, p[2 * H3], acc[g][2]);
        acc[g][3] = fmaf(hv.w, p[3 * H3], acc[g][3]);
      }
    }
  }
}

// One block per sequence, W warps of one unit a lane; Wh in registers
// (W <= 2) or in shared memory (W > 2).
template <int W>
__global__ void __launch_bounds__(32 * W, 1)
gru_scan_kernel(const float* __restrict__ xs, const float* __restrict__ h0,
                const float* __restrict__ wx, const float* __restrict__ wh,
                const float* __restrict__ b, float* __restrict__ hs,
                float* __restrict__ hT, int B, int T, int D, int H, int TC) {
  constexpr bool kRegs = W <= 2;       // Wh in registers
  constexpr int kNR = kRegs ? 32 * W : 1;
  extern __shared__ __align__(16) float smem[];
  const int H3 = 3 * H, XP = x_pitch(D);
  const int lane = threadIdx.x & 31;
  const int q = threadIdx.x >> 5;      // the warp, 0..W-1
  const size_t row = blockIdx.x;       // flat sequence index f * B + seq
  const int f = blockIdx.x / B;
  const float* wx_f = wx + (size_t)f * D * H3;
  const float* wh_f = wh + (size_t)f * H * H3;
  const float* b_f = b + (size_t)f * H3;

  float* s_h = smem;                                     // [32 W]
  float* s_rh = s_h + 32 * W;                            // [32 W]
  float* s_wh = s_rh + 32 * W;                           // [wh_rows(H), 3H]
  float* s_xp = s_wh + (kRegs ? 0 : wh_rows(H) * H3) +
                q * TC * (96 + XP);                      // [TC, 3, 32]
  float* s_x = s_xp + TC * 96;                           // [TC, XP]

  if constexpr (!kRegs) {              // Wh, all copies in flight at once
    for (int i = threadIdx.x; i < H * H3; i += 32 * W)
      cp_async4(s_wh + i, wh_f + i);
    for (int i = H * H3 + threadIdx.x; i < wh_rows(H) * H3; i += 32 * W)
      s_wh[i] = 0.0f;
  }
  const int j = 32 * q + lane;         // the lane's unit
  const bool valid = j < H;
  const int unit = valid ? j : H - 1;  // clamped, for loads
  float h = valid ? h0[row * H + unit] : 0.0f;
  s_h[j] = h;

  float w[3][kNR];                     // registers: the lane's Wh columns
  if constexpr (kRegs) {
    const float* p = wh_f + unit;
#pragma unroll
    for (int k = 0; k < 32 * W; ++k) {
      const bool ok = k < H;
      w[0][k] = ok ? __ldg(p) : 0.0f;
      w[1][k] = ok ? __ldg(p + H) : 0.0f;
      w[2][k] = ok ? __ldg(p + 2 * H) : 0.0f;
      if (k + 1 < H) p += H3;          // stay inside wh
    }
  } else {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  const float* s_wc = s_wh + unit;

  const float* x_row = xs + row * T * D;
  float* out = hs + row * T * H;
  seq_sync<W>();

  for (int t0 = 0; t0 < T; t0 += TC) {
    const int n = min(TC, T - t0);
    // prologue: the chunk's x (rows padded with zeros to XP), then xp = x
    // Wx + b for each of its steps, for the lane's own unit (b and Wx's
    // first four rows loaded here, so that they hold no register in the
    // chain)
    float bias[3], wxr[4][3];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      bias[g] = __ldg(b_f + g * H + unit);
#pragma unroll
      for (int d = 0; d < 4; ++d)
        wxr[d][g] = d < D ? __ldg(wx_f + (size_t)d * H3 + g * H + unit)
                          : 0.0f;
    }
    for (int t = lane; t < n; t += 32) {
      const float* src = x_row + (size_t)(t0 + t) * D;
      for (int d0 = 0; d0 < XP; d0 += 4) {
        float4 v;
        v.x = d0 < D ? __ldg(src + d0) : 0.0f;
        v.y = d0 + 1 < D ? __ldg(src + d0 + 1) : 0.0f;
        v.z = d0 + 2 < D ? __ldg(src + d0 + 2) : 0.0f;
        v.w = d0 + 3 < D ? __ldg(src + d0 + 3) : 0.0f;
        *reinterpret_cast<float4*>(s_x + t * XP + d0) = v;
      }
    }
    __syncwarp();
    if (D <= 4) {                      // the served case: Wx in registers
#pragma unroll 4
      for (int tt = 0; tt < n; ++tt) {
        const float4 x0 = *reinterpret_cast<const float4*>(s_x + tt * 4);
#pragma unroll
        for (int g = 0; g < 3; ++g)
          s_xp[(tt * 3 + g) * 32 + lane] =
              fmaf(x0.x, wxr[0][g],
                   fmaf(x0.y, wxr[1][g],
                        fmaf(x0.z, wxr[2][g],
                             fmaf(x0.w, wxr[3][g], bias[g]))));
      }
    } else {                           // Wx read through L1
      for (int tt = 0; tt < n; ++tt) {
        const float* xt = s_x + tt * XP;
        float a[3] = {bias[0], bias[1], bias[2]};
        for (int d = 0; d < D; ++d) {
          const float x = xt[d];
          const float* wd = wx_f + (size_t)d * H3 + unit;
#pragma unroll
          for (int g = 0; g < 3; ++g)
            a[g] = fmaf(x, __ldg(wd + g * H), a[g]);
        }
#pragma unroll
        for (int g = 0; g < 3; ++g) s_xp[(tt * 3 + g) * 32 + lane] = a[g];
      }
    }

    // the chain: only h-dependent work from here to the chunk's end
    for (int tt = 0; tt < n; ++tt, out += H) {
      const float* xp = s_xp + tt * 96 + lane;
      float zr[2][4] = {};
      dot_pass<W, 0, 2>(zr, s_h, H, w, s_wc);
      const float z = sigmoid_f(xp[0] + sum4(zr[0]));
      const float r = sigmoid_f(xp[32] + sum4(zr[1]));
      s_rh[j] = r * h;
      seq_sync<W>();
      float cc[1][4] = {};
      dot_pass<W, 2, 1>(cc, s_rh, H, w, s_wc);
      const float c = tanhf(xp[64] + sum4(cc[0]));
      h = valid ? (1.0f - z) * h + z * c : 0.0f;
      s_h[j] = h;
      if (valid) out[unit] = h;
      seq_sync<W>();
    }
  }
  if (valid) hT[row * H + unit] = h;
}

// ------------------------------------------------------------------------
// The wide path: any H, Wh read through L2.
constexpr int kWideMaxThreads = 1024;

// Floats between the wide path's three shared buffers (16-byte aligned).
__host__ __device__ inline int wide_pitch(int H) { return (H + 3) & ~3; }

// acc[g][0..3] += sum over k < H of v[k] w[g H + k H3] for the NG
// columns g (v in shared memory, 16-byte aligned; w the thread's unit in
// row 0 of a gate block of Wh, in device memory).  With Wh in L2 a step
// is bound by the loads outstanding, so 8 rows of every column are loaded
// before any is used: 8 NG loads in flight a thread.
template <int NG>
__device__ __forceinline__ void wide_dot(float (&acc)[NG][4], const float* v,
                                         const float* __restrict__ w, int H,
                                         int H3) {
  int k = 0;
  for (; k + 7 < H; k += 8) {
    const float4 h0 = *reinterpret_cast<const float4*>(v + k);
    const float4 h1 = *reinterpret_cast<const float4*>(v + k + 4);
    float wk[NG][8];
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int r = 0; r < 8; ++r)
        wk[g][r] = __ldg(w + g * H + (size_t)(k + r) * H3);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      acc[g][0] = fmaf(h0.x, wk[g][0], acc[g][0]);
      acc[g][1] = fmaf(h0.y, wk[g][1], acc[g][1]);
      acc[g][2] = fmaf(h0.z, wk[g][2], acc[g][2]);
      acc[g][3] = fmaf(h0.w, wk[g][3], acc[g][3]);
      acc[g][0] = fmaf(h1.x, wk[g][4], acc[g][0]);
      acc[g][1] = fmaf(h1.y, wk[g][5], acc[g][1]);
      acc[g][2] = fmaf(h1.z, wk[g][6], acc[g][2]);
      acc[g][3] = fmaf(h1.w, wk[g][7], acc[g][3]);
    }
  }
  for (; k < H; ++k)
#pragma unroll
    for (int g = 0; g < NG; ++g)
      acc[g][0] = fmaf(v[k], __ldg(w + g * H + (size_t)k * H3), acc[g][0]);
}

__global__ void __launch_bounds__(kWideMaxThreads, 1)
gru_scan_wide_kernel(const float* __restrict__ xs,
                     const float* __restrict__ h0,
                     const float* __restrict__ wx,
                     const float* __restrict__ wh,
                     const float* __restrict__ b, float* __restrict__ hs,
                     float* __restrict__ hT, int B, int T, int D, int H) {
  extern __shared__ __align__(16) float smem[];
  const int H3 = 3 * H, HP = wide_pitch(H);
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t row = blockIdx.x;       // flat sequence index f * B + seq
  const int f = blockIdx.x / B;
  const float* wx_f = wx + (size_t)f * D * H3;
  const float* wh_f = wh + (size_t)f * H * H3;
  const float* b_f = b + (size_t)f * H3;
  float* s_h = smem;                   // [H]
  float* s_rh = s_h + HP;              // [H]
  float* s_z = s_rh + HP;              // [H]
  for (int j = tid; j < H; j += nt) s_h[j] = h0[row * H + j];
  __syncthreads();
  const float* x_row = xs + row * T * D;
  float* out = hs + row * T * H;
  for (int t = 0; t < T; ++t, out += H) {
    const float* xt = x_row + (size_t)t * D;
    // z and r from h; r*h for the candidate
    for (int j = tid; j < H; j += nt) {
      float az = __ldg(b_f + j), ar = __ldg(b_f + H + j);
      for (int d = 0; d < D; ++d) {
        const float x = __ldg(xt + d);
        az = fmaf(x, __ldg(wx_f + (size_t)d * H3 + j), az);
        ar = fmaf(x, __ldg(wx_f + (size_t)d * H3 + H + j), ar);
      }
      float zr[2][4] = {};
      wide_dot<2>(zr, s_h, wh_f + j, H, H3);
      const float z = sigmoid_f(az + sum4(zr[0]));
      const float r = sigmoid_f(ar + sum4(zr[1]));
      s_z[j] = z;
      s_rh[j] = r * s_h[j];
    }
    __syncthreads();
    // the candidate and the update; a thread reads and writes only its own
    // units' h here, so the writes need no barrier before them
    for (int j = tid; j < H; j += nt) {
      float ac = __ldg(b_f + 2 * H + j);
      for (int d = 0; d < D; ++d)
        ac = fmaf(__ldg(xt + d), __ldg(wx_f + (size_t)d * H3 + 2 * H + j),
                  ac);
      float cc[1][4] = {};
      wide_dot<1>(cc, s_rh, wh_f + 2 * H + j, H, H3);
      const float c = tanhf(ac + sum4(cc[0]));
      const float z = s_z[j];
      const float hn = (1.0f - z) * s_h[j] + z * c;
      s_h[j] = hn;
      out[j] = hn;
    }
    __syncthreads();
  }
  for (int j = tid; j < H; j += nt) hT[row * H + j] = s_h[j];
}

int launch_wide(const float* xs, const float* h0, const float* wx,
                const float* wh, const float* b, float* hs, float* hT, int F,
                int B, int T, int D, int H, cudaStream_t stream) {
  const int bytes = 3 * wide_pitch(H) * 4;
  if (bytes > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  static bool opted = false;
  if (bytes > 48 * 1024 && !opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        gru_scan_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmemBytes);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  const int warps = (H + 31) / 32;
  const int threads = warps * 32 < kWideMaxThreads ? warps * 32
                                                   : kWideMaxThreads;
  gru_scan_wide_kernel<<<F * B, threads, bytes, stream>>>(
      xs, h0, wx, wh, b, hs, hT, B, T, D, H);
  return (int)cudaGetLastError();
}

typedef void (*GruKernel)(const float*, const float*, const float*,
                          const float*, const float*, float*, float*, int,
                          int, int, int, int);

GruKernel pick(int W) {
  switch (W) {
    case 1: return gru_scan_kernel<1>;
    case 2: return gru_scan_kernel<2>;
    case 3: return gru_scan_kernel<3>;
    case 4: return gru_scan_kernel<4>;
    case 5: return gru_scan_kernel<5>;
    default: return nullptr;
  }
}

}  // namespace

// The widest hidden size of the fast paths at input width D: W <= 5
// warps, and above H = 64 Wh and one step's prologue in a block's shared
// memory.  Wider H goes to the wide path.
extern "C" int gru_scan_max_hidden(int D) {
  int H = 32 * GRU_MAX_W;
  while (H > 0 && chunk_steps(1, D, H) < 1) --H;
  return H;
}

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take (H past
// about 19,000, where the wide path's [3][H] buffers outgrow shared
// memory).
extern "C" int gru_scan_launch(const float* xs, const float* h0,
                               const float* wx, const float* wh,
                               const float* b, float* hs, float* hT,
                               int F, int B, int T, int D, int H,
                               void* stream) {
  if (F < 1 || B < 1 || T < 0 || D < 0 || H < 1 ||
      (long)F * B > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  if (H > gru_scan_max_hidden(D))
    return launch_wide(xs, h0, wx, wh, b, hs, hT, F, B, T, D, H,
                       (cudaStream_t)stream);
  const int W = (H + 31) / 32;
  const int TC = chunk_steps(T, D, H);
  if (TC < 1) return (int)cudaErrorInvalidValue;
  const int bytes = smem_floats(W, TC, D, H) * 4;
  GruKernel kernel = pick(W);
  static bool opted[GRU_MAX_W + 1] = {};   // one opt-in per instantiation
  if (bytes > 48 * 1024 && !opted[W]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (err != cudaSuccess) return (int)err;
    opted[W] = true;
  }
  kernel<<<F * B, 32 * W, bytes, (cudaStream_t)stream>>>(
      xs, h0, wx, wh, b, hs, hT, B, T, D, H, TC);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
