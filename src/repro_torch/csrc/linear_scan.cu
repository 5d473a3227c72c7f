// Chunked linear recurrence with data-dependent decay for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/linear_scan/linear_scan.py::_ls_kernel (line 28,
// launched by linear_scan_pallas).  Same contract as
// kernels/linear_scan/ref.py::linear_scan_chunked, modes "ssd" (read after
// the update, causal mask s <= t) and "rwkv6" (read before it, s < t, plus
// the bonus diagonal sum_k q u k):
//
//   cw = cumsum(w) over the chunk,  cw_read = cw - w (rwkv6) or cw (ssd)
//   P[t,s] = sum_k q[t,k] k[s,k] exp(cw_read[t,k] - cw[s,k])   (masked)
//   o      = P v + (q * exp(cw_read)) S
//   S      = exp(cw_end) S + (k * exp(cw_end - cw))^T v
//
// Layout: q, k [BH, T, K] and v [BH, T, V] in float or bf16 (template
// parameter; upcast to f32 on load), w [BH, T, K] f32 log decay, u [H, K]
// f32 or null (weight 1), s0 [BH, K, V] f32 or null (zeros) -> o [BH, T, V]
// f32, sf [BH, K, V] f32.  All arithmetic is f32, as in the TPU kernel.
// Limits: C, K, V <= 64.
//
// Where the TPU carried the state: its grid walked the chunks of one
// sequence in order and kept S in a VMEM scratch between grid steps.  CUDA
// blocks run in no order, so here a block loops over the chunks itself and
// keeps S [K, V] in shared memory for the whole sequence.
//
// The [C, C, K] decay tile of the TPU kernel (1 MB at C = K = 64) is never
// built: each P[t, s] is summed over k straight into a [C, C] tile, keeping
// the pairwise exp(difference) form, whose argument is never positive and
// so cannot overflow (exp(cw) and exp(-cw) factored apart would).  The
// bonus diagonal is written into P[t, t], so P v adds it.  Exponentials are
// exp2f of log2-scaled decays.  The ragged last chunk is masked here: rows
// past T read as k = 0, w = 0 (what the JAX zero padding does) and are
// never stored; the wrapper makes no padded copies.
//
// What bounds it.  Per chunk of one sequence at C = K = V = 64 the work is
// about 0.9 M multiply-adds and 0.13 M exponentials (P alone is 2016 pairs
// x 64), against 40 KB of input: far above the card's f32 ridge, so the
// bound is f32 operations.  Next come the exponentials (16 per clock per
// SM) and shared-memory bandwidth in the FMA loops, which the design eases
// with 128-bit shared loads along k and 4x4 register tiles for the state
// update.  Occupancy: at the serving prefill B = 1, H = 40 gives
// only 40 sequences for 132 SMs.  So R blocks share one sequence
// (gridDim.x = BH * R; the wrapper picks R = SMs / BH, at most 8): block r
// owns rows t = r, r + R, ... of each chunk -- the same causal share of P
// for every r -- and computes only their P rows and outputs.  Each of the
// R blocks repeats the state update (K x V x C multiply-adds a chunk),
// which is the price of carrying S without a second pass.  No wgmma, no
// TMA: a first version.  Measured on an H100 SXM (80 GB, 700 W) at the
// serving prefill shape (B=1, H=40, T=2048, bf16): 0.755 ms, about 20x the
// f32-operation bound.  With one 8-warp block per SM, the sync-separated
// shared-memory loops wait on latency rather than on exponentials or FMAs;
// more warps per SM, a second pass in place of the repeated state update,
// and tensor-core products are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 64;
// elements of a [kMaxDim, kMaxDim] tile each thread stages
constexpr int kPerThread = kMaxDim * kMaxDim / kThreads;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared-memory layout, offsets in floats.  Rows along K are padded to kp
// (a multiple of 4 for float4 loads, with an odd number of 16-byte words so
// that neighbouring rows fall in different banks); K and V round up to 4.
struct Layout {
  int k4, v4, kp, rc;
  int k, cw, q, cwr, v, s, u, p, total;
};

__host__ __device__ inline Layout make_layout(int K, int V, int C, int R) {
  Layout L;
  L.k4 = (K + 3) / 4 * 4;
  L.v4 = (V + 3) / 4 * 4;
  L.kp = (L.k4 % 8 == 0) ? L.k4 + 4 : L.k4;
  L.rc = (C + R - 1) / R;            // rows a block owns in a chunk
  L.k = 0;                           // [C][kp]  k, then k * 2^(cw_end - cw)
  L.cw = L.k + C * L.kp;             // [C][kp]  w, then cumsum (log2 units)
  L.q = L.cw + C * L.kp;             // [rc][kp] q, then q * 2^cw_read
  L.cwr = L.q + L.rc * L.kp;         // [rc][kp] w, then cw_read
  L.v = L.cwr + L.rc * L.kp;         // [C][v4]
  L.s = L.v + C * L.v4;              // [k4][v4] carried state
  L.u = L.s + L.k4 * L.v4;           // [k4]     bonus
  L.p = L.u + L.k4;                  // [rc][C]  P rows of this block
  L.total = L.p + L.rc * C;
  return L;
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

template <typename T, bool kRwkv>
__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, const float* __restrict__ s0,
                   float* __restrict__ o, float* __restrict__ sf, int H,
                   int T_len, int K, int V, int C, int R) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = make_layout(K, V, C, R);
  float* s_k = smem + L.k;
  float* s_cw = smem + L.cw;
  float* s_q = smem + L.q;
  float* s_cwr = smem + L.cwr;
  float* s_v = smem + L.v;
  float* s_S = smem + L.s;
  float* s_u = smem + L.u;
  float* s_P = smem + L.p;
  const int k4 = L.k4, v4 = L.v4, kp = L.kp, rc = L.rc;
  const int bh = blockIdx.x / R;
  const int r = blockIdx.x % R;
  const int tid = threadIdx.x;
  const size_t base_k = (size_t)bh * T_len * K;
  const size_t base_v = (size_t)bh * T_len * V;

  for (int i = tid; i < k4; i += kThreads)
    s_u[i] = i < K ? (u ? u[(bh % H) * K + i] : 1.0f) : 0.0f;
  for (int e = tid; e < k4 * v4; e += kThreads) {
    const int kk = e / v4, vv = e % v4;
    s_S[e] = (s0 && kk < K && vv < V)
                 ? s0[((size_t)bh * K + kk) * V + vv] : 0.0f;
  }

  const int n_chunks = (T_len + C - 1) / C;
  for (int n = 0; n < n_chunks; ++n) {
    const int t0 = n * C;
    const int cn = min(C, T_len - t0);        // valid rows of this chunk

    // 1. stage the chunk: k, w, v for every row, q and w for this block's
    //    rows; padding (rows >= cn, columns >= K or V) reads as zero.  Each
    //    thread starts all its loads of a tile before it stores any, so
    //    they are in flight together (one block of 8 warps per SM cannot
    //    hide device-memory latency one load at a time).
    {
      float ka[kPerThread], wa[kPerThread], va[kPerThread];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int e = tid + j * kThreads;
        const int s = e / k4, kk = e % k4;
        const bool ok = s < cn && kk < K;          // s < cn implies e < C*k4
        const size_t g = base_k + (size_t)(t0 + s) * K + kk;
        ka[j] = ok ? to_f32(k[g]) : 0.0f;
        wa[j] = ok ? w[g] * kLog2e : 0.0f;
        const int sv = e / v4, vv = e % v4;
        va[j] = (sv < cn && vv < V)
                    ? to_f32(v[base_v + (size_t)(t0 + sv) * V + vv]) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int e = tid + j * kThreads;
        if (e < C * k4) {
          s_k[(e / k4) * kp + e % k4] = ka[j];
          s_cw[(e / k4) * kp + e % k4] = wa[j];
        }
        if (e < C * v4) s_v[e] = va[j];
      }
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int e = tid + j * kThreads;
        const int i = e / k4, kk = e % k4, t = r + i * R;
        const bool ok = i < rc && t < cn && kk < K;
        const size_t g = base_k + (size_t)(t0 + t) * K + kk;
        ka[j] = ok ? to_f32(q[g]) : 0.0f;
        wa[j] = ok ? w[g] * kLog2e : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int e = tid + j * kThreads;
        if (e < rc * k4) {
          s_q[(e / k4) * kp + e % k4] = ka[j];
          s_cwr[(e / k4) * kp + e % k4] = wa[j];
        }
      }
    }
    __syncthreads();

    // 2. inclusive cumsum of w down each column: one warp per column, lane
    //    l holds rows l and l + 32 (C <= 64).
    {
      const int lane = tid & 31, warp = tid >> 5;
      for (int kk = warp; kk < K; kk += kThreads / 32) {
        float a = lane < C ? s_cw[lane * kp + kk] : 0.0f;
        float b = lane + 32 < C ? s_cw[(lane + 32) * kp + kk] : 0.0f;
        for (int off = 1; off < 32; off <<= 1) {
          const float x = __shfl_up_sync(0xffffffffu, a, off);
          const float y = __shfl_up_sync(0xffffffffu, b, off);
          if (lane >= off) {
            a += x;
            b += y;
          }
        }
        b += __shfl_sync(0xffffffffu, a, 31);
        if (lane < C) s_cw[lane * kp + kk] = a;
        if (lane + 32 < C) s_cw[(lane + 32) * kp + kk] = b;
      }
    }
    __syncthreads();

    // 3. cw_read of this block's rows: rwkv6 reads before the update.
    for (int e = tid; e < rc * k4; e += kThreads) {
      const int i = e / k4, kk = e % k4, t = r + i * R;
      const float c = t < C ? s_cw[t * kp + kk] : 0.0f;
      s_cwr[i * kp + kk] = kRwkv ? c - s_cwr[i * kp + kk] : c;
    }
    __syncthreads();

    // 4. P rows of this block, summed over k in float4 steps; the rwkv6
    //    diagonal holds the bonus sum_k q u k.  Entries past the mask are
    //    never read, so never written.
    for (int e = tid; e < rc * C; e += kThreads) {
      const int i = e / C, s = e % C, t = r + i * R;
      if (t >= cn || s > t) continue;
      const float4* qa = reinterpret_cast<const float4*>(s_q + i * kp);
      const float4* kb = reinterpret_cast<const float4*>(s_k + s * kp);
      float acc = 0.0f;
      if (kRwkv && s == t) {
        const float4* ua = reinterpret_cast<const float4*>(s_u);
        for (int j = 0; j < k4 / 4; ++j) {
          const float4 a = qa[j], b = kb[j], c = ua[j];
          acc = fmaf(a.x * b.x, c.x, acc);
          acc = fmaf(a.y * b.y, c.y, acc);
          acc = fmaf(a.z * b.z, c.z, acc);
          acc = fmaf(a.w * b.w, c.w, acc);
        }
      } else {
        const float4* ca = reinterpret_cast<const float4*>(s_cwr + i * kp);
        const float4* cb = reinterpret_cast<const float4*>(s_cw + s * kp);
        for (int j = 0; j < k4 / 4; ++j) {
          const float4 a = qa[j], b = kb[j], c = ca[j], d = cb[j];
          acc = fmaf(a.x * b.x, exp2f(c.x - d.x), acc);
          acc = fmaf(a.y * b.y, exp2f(c.y - d.y), acc);
          acc = fmaf(a.z * b.z, exp2f(c.z - d.z), acc);
          acc = fmaf(a.w * b.w, exp2f(c.w - d.w), acc);
        }
      }
      s_P[i * C + s] = acc;
    }
    __syncthreads();

    // 5. q_read = q * 2^cw_read (this block's rows) and, in place of k,
    //    kd = k * 2^(cw_end - cw) (every row; P no longer needs k).
    for (int e = tid; e < rc * k4; e += kThreads) {
      const int i = e / k4, kk = e % k4;
      s_q[i * kp + kk] *= exp2f(s_cwr[i * kp + kk]);
    }
    for (int e = tid; e < C * k4; e += kThreads) {
      const int s = e / k4, kk = e % k4;
      s_k[s * kp + kk] *= exp2f(s_cw[(C - 1) * kp + kk] - s_cw[s * kp + kk]);
    }
    __syncthreads();

    // 6. outputs of this block's rows, 4 columns a thread:
    //    o[t] = sum_{s <= t} P[t,s] v[s] + q_read[t] S_in.
    for (int e = tid; e < rc * (v4 / 4); e += kThreads) {
      const int i = e / (v4 / 4), v0 = (e % (v4 / 4)) * 4, t = r + i * R;
      if (t >= cn) continue;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float* pr = s_P + i * C;
      for (int s = 0; s <= t; ++s)
        fma4(acc, pr[s], *reinterpret_cast<const float4*>(s_v + s * v4 + v0));
      const float* qr = s_q + i * kp;
      for (int kk = 0; kk < K; ++kk)
        fma4(acc, qr[kk],
             *reinterpret_cast<const float4*>(s_S + kk * v4 + v0));
      float* dst = o + base_v + (size_t)(t0 + t) * V + v0;
      const float vals[4] = {acc.x, acc.y, acc.z, acc.w};
      for (int j = 0; j < 4 && v0 + j < V; ++j) dst[j] = vals[j];
    }
    __syncthreads();

    // 7. state update, a 4x4 tile of S a thread:
    //    S = 2^cw_end S + kd^T v.  Padded rows of kd and v are zero.
    for (int e = tid; e < (k4 / 4) * (v4 / 4); e += kThreads) {
      const int k0 = (e / (v4 / 4)) * 4, v0 = (e % (v4 / 4)) * 4;
      float4 acc[4];
      for (int j = 0; j < 4; ++j) {
        const float a = exp2f(s_cw[(C - 1) * kp + k0 + j]);
        const float4 s = *reinterpret_cast<const float4*>(
            s_S + (k0 + j) * v4 + v0);
        acc[j] = make_float4(a * s.x, a * s.y, a * s.z, a * s.w);
      }
      for (int s = 0; s < cn; ++s) {
        const float4 kd = *reinterpret_cast<const float4*>(s_k + s * kp + k0);
        const float4 vs = *reinterpret_cast<const float4*>(s_v + s * v4 + v0);
        fma4(acc[0], kd.x, vs);
        fma4(acc[1], kd.y, vs);
        fma4(acc[2], kd.z, vs);
        fma4(acc[3], kd.w, vs);
      }
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(s_S + (k0 + j) * v4 + v0) = acc[j];
    }
    __syncthreads();
  }

  if (r == 0) {
    for (int e = tid; e < K * V; e += kThreads)
      sf[(size_t)bh * K * V + e] = s_S[(e / V) * v4 + e % V];
  }
}

template <typename T, bool kRwkv>
int launch(const void* q, const void* k, const void* v, const float* w,
           const float* u, const float* s0, float* o, float* sf, int BH,
           int H, int T_len, int K, int V, int C, int R, cudaStream_t stream) {
  static bool opted_in = false;      // one opt-in per instantiation
  const int smem = make_layout(K, V, C, R).total * (int)sizeof(float);
  auto kernel = linear_scan_kernel<T, kRwkv>;
  if (smem > 48 * 1024 && !opted_in) {
    int dev = 0, max_optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_optin);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  kernel<<<BH * R, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, o, sf, H, T_len, K, V, C, R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int linear_scan_smem_bytes(int K, int V, int C, int R) {
  return make_layout(K, V, C, R).total * (int)sizeof(float);
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int linear_scan_launch(const void* q, const void* k, const void* v,
                                  const float* w, const float* u,
                                  const float* s0, float* o, float* sf,
                                  int BH, int H, int T, int K, int V, int C,
                                  int R, int rwkv6, int bf16, void* stream) {
  if (C < 1 || C > kMaxDim || K < 1 || K > kMaxDim || V < 1 ||
      V > kMaxDim || R < 1 || R > C || H < 1 || BH < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return rwkv6 ? launch<__nv_bfloat16, true>(q, k, v, w, u, s0, o, sf, BH,
                                               H, T, K, V, C, R, st)
                 : launch<__nv_bfloat16, false>(q, k, v, w, u, s0, o, sf, BH,
                                                H, T, K, V, C, R, st);
  }
  return rwkv6 ? launch<float, true>(q, k, v, w, u, s0, o, sf, BH, H, T, K,
                                     V, C, R, st)
               : launch<float, false>(q, k, v, w, u, s0, o, sf, BH, H, T, K,
                                      V, C, R, st);
}
