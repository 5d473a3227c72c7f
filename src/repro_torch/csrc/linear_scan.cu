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
//   o      = P v + (q * exp(cw_read)) S_in
//   S      = exp(cw_end) S + (k * exp(cw_end - cw))^T v
//
// Layout: q, k [BH, T, K] and v [BH, T, V] in float or bf16 (template
// parameter; upcast to f32 on load), w [BH, T, K] f32 log decay, u [H, K]
// f32 or null (weight 1), s0 [BH, K, V] f32 or null (zeros) -> o [BH, T, V]
// f32, sf [BH, K, V] f32.  Scratch from the wrapper: dS [BH, N, K, V] and
// aend [BH, N, K] f32, N = ceil(T / C).  Limits: C, K, V <= 64.  The plain
// PyTorch version of this exact formulation is
// ref.py::linear_scan_subchunked.
//
// What bounds it.  At the serving prefill (B*H = 40, T = 2048, C = K = V =
// 64) the subchunk form below issues 4.92 G TF32 operations on the tensor
// cores (its four products in 3xTF32 form, 0.0099 ms at 495 TFLOP/s) and
// 0.19 GFLOP of f32 work outside them (0.0029 ms at 67 TFLOP/s), against
// 74 MB of inputs and outputs (0.022 ms at 3.35 TB/s): the bytes bound it.
// The 42 M exponentials a call take 0.010 ms at 16 a clock per SM.
//
// What the design does about it.  The TPU kernel walked the chunks of a
// sequence in order with S in VMEM.  Only the [K, V] recurrence across
// chunks is sequential, so a call is three launches:
//   A. chunk_state, a block per (sequence, chunk), all in parallel: the
//      chunk's decay aend = exp(cw_end) and contribution dS = kd^T v,
//      kd = k exp(cw_end - cw);
//   B. state_scan, a thread per (sequence, k, v): S_n = aend_n S_{n-1} +
//      dS_n, writing in place of dS_n the state S_{n-1} chunk n reads, and
//      the final state;
//   C. chunk_output, a block per (sequence, chunk), all in parallel:
//      o = P v + q_read S_in.
// At the serving prefill A and C have 1,280 blocks for 132 SMs, two
// resident on each (C holds 98.8 KB of shared memory).
//
// Fewer exponentials: each chunk is cut into 8-row subchunks.  Pairs inside
// one keep the pairwise form exp(cw_read[t] - cw[s]) (8 x 36 pairs a chunk
// of 64).  A pair of query subchunk I and an earlier key subchunk J factors
// through two pivots, p_I = cw_read[8 I] and c_J = cw[8 J + 7]:
//   exp(cw_read[t] - cw[s]) = exp(cw_read[t] - p_I) exp(p_I - c_J)
//                             exp(c_J - cw[s]),
// each exponent <= 0 because w <= 0 and t >= 8 I > 8 J + 7 >= s, so no
// factor can overflow (one that underflows bounds a product that is even
// smaller).  Those blocks of P are then products of the pre-scaled
// qs = q exp(cw_read - p_I) and kj = k exp(c_J - cw), with exp(p_I - c_J)
// folded into the query side, and q_read = qs exp(p_I).  Exponentials a
// chunk: 18 K on the diagonal blocks and 10 K for the pivots and scalings,
// against 129 K for the pairwise form everywhere.
//
// Tensor cores where they keep f32 accuracy: the three products (dS =
// kd^T v, the off-diagonal blocks of P, o = P v + q_read S_in) run as
// mma.sync m16n8k8 TF32 products in 3xTF32 form: each f32 operand is split
// into a TF32 head and an f32 remainder, and hi*hi + hi*lo + lo*hi keeps
// about 2^-21 of each product, well inside the 2e-4 tolerance against the
// f32 plain version, where one TF32 rounding of the decayed operands would
// not be.  A bf16 v is exact in TF32, so P v and kd^T v take two products,
// not three.  The diagonal pairs stay on CUDA cores.  Staging: f32 tiles
// (w, the carried state, f32 q/k/v) arrive by cp.async (16-byte copies
// where rows are 16-byte aligned, 4-byte otherwise, rows past T
// zero-filled); bf16 q/k/v by 16-byte loads, all of a thread's in flight
// before any is converted.  Row strides of the shared tiles keep fragment
// loads free of bank conflicts.
//
// Measured (chip_smoke.py phase 7, NVIDIA H100 80GB HBM3, 700.00 W):
// 0.177 ms at B*H = 40, T = 2048, bf16, 8.0x its bound (the bytes), most
// of it the chunk-output launch; 0.070 ms at T = 659, 0.363 ms at
// T = 4096.  The design before it (a block walking its sequence's chunks)
// took 0.755 ms at T = 2048 on the same card.  What holds it now: the
// chunk-output pass's phases wait on latency and barriers with 16 warps a
// SM, and the three launches read k, v and w twice.  Times in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 64;
constexpr int kTile = 16;                      // rows of a tensor-core tile
constexpr int kSub = 8;                        // subchunk rows (pivots)
constexpr int kMaxSub = kMaxDim / kSub;        // subchunks per chunk
constexpr int kMaxPairs = kMaxSub * (kMaxSub - 1) / 2;
constexpr int kSubPairs = kSub * (kSub + 1) / 2;   // pairs s <= t in one
constexpr int kScanRows = kMaxDim * kMaxDim / kThreads;  // cumsum rows a thread
// elements of a [kMaxDim, kMaxDim] tile each thread stages
constexpr int kPerThread = kMaxDim * kMaxDim / kThreads;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// 2^x on the SFU (one instruction, relative error about 2^-22; results
// below 2^-126 flush to 0).  Every exponent here is <= 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// x = hi + lo: hi is x cut to TF32 (its low 13 mantissa bits cleared),
// lo = x - hi exactly in f32.  The tensor core reads lo as TF32 too, which
// costs at most 2^-11 of lo, about 2^-21 of x: 3xTF32 products keep about
// f32 accuracy.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b, one m16n8k8 TF32 tensor-core product with f32 accumulation.
// Fragments (g = lane / 4, c = lane % 4): a = A[g][c], A[g+8][c],
// A[g][c+4], A[g+8][c+4]; b = B[c][g], B[c+4][g]; d = D[g][2c], D[g][2c+1],
// D[g+8][2c], D[g+8][2c+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B for an A fragment split into hi/lo and B given as two f32
// values; B is split too unless it is exact in TF32 (bf16 inputs).
template <bool kExactB>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float y0,
                                     float y1) {
  if (kExactB) {
    const uint32_t b0 = __float_as_uint(y0), b1 = __float_as_uint(y1);
    mma_tf32(d, al, b0, b1);
    mma_tf32(d, ah, b0, b1);
  } else {
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(y0, bh0, bl0);
    split_tf32(y1, bh1, bl1);
    mma_tf32(d, al, bh0, bh1);
    mma_tf32(d, ah, bl0, bl1);
    mma_tf32(d, ah, bh0, bh1);
  }
}

// Columns col and col + 1 of a row of width V: one 8-byte store where both
// exist and V is even (every row then starts 8-byte aligned).
__device__ __forceinline__ void store_pair(float* row, int col, int V,
                                           float a, float b) {
  if ((V & 1) == 0 && col + 1 < V) {
    *reinterpret_cast<float2*>(row + col) = make_float2(a, b);
  } else {
    if (col < V) row[col] = a;
    if (col + 1 < V) row[col + 1] = b;
  }
}

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// Stage rows [0, rows) x cols [0, cols4) of dst (row stride ld) from src
// (row stride src_ld): rows < valid and cols < cols are read, the rest are
// zero.  f32 goes by cp.async (the caller waits); bf16 through registers.
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      int src_ld, int valid, int rows,
                                      int cols, int cols4) {
  const bool vec = cols == cols4 && (src_ld & 3) == 0 &&
                   (reinterpret_cast<size_t>(src) & 15) == 0;
  if (vec) {
    const int q4 = cols4 / 4;
    for (int e = threadIdx.x; e < rows * q4; e += kThreads) {
      const int r = e / q4, c = (e - r * q4) * 4;
      const bool ok = r < valid;
      cp_async16(dst + r * ld + c, ok ? src + (size_t)r * src_ld + c : src,
                 ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols4; e += kThreads) {
      const int r = e / cols4, c = e - r * cols4;
      const bool ok = r < valid && c < cols;
      cp_async4(dst + r * ld + c, ok ? src + (size_t)r * src_ld + c : src,
                ok);
    }
  }
}

__device__ __forceinline__ void stage(float* dst, int ld,
                                      const __nv_bfloat16* src, int src_ld,
                                      int valid, int rows, int cols,
                                      int cols4) {
  const bool vec = cols == cols4 && (cols & 7) == 0 && (src_ld & 7) == 0 &&
                   (reinterpret_cast<size_t>(src) & 15) == 0;
  if (vec) {                        // 8 values a load, all loads in flight
    constexpr int kVec = kPerThread / 8;
    const int q8 = cols4 / 8;
    uint4 r[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int row = e / q8, c = (e - row * q8) * 8;
      r[j] = row < valid ? *reinterpret_cast<const uint4*>(
                               src + (size_t)row * src_ld + c)
                         : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int row = e / q8, c = (e - row * q8) * 8;
      if (row >= rows) continue;
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r[j]);
      const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
      const float2 x = __bfloat1622float2(h[2]), y = __bfloat1622float2(h[3]);
      float* d = dst + row * ld + c;
      *reinterpret_cast<float4*>(d) = make_float4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<float4*>(d + 4) = make_float4(x.x, x.y, y.x, y.y);
    }
    return;
  }
  float r[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int row = e / cols4, c = e - row * cols4;
    r[j] = (row < valid && c < cols)
               ? __bfloat162float(src[(size_t)row * src_ld + c]) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int row = e / cols4, c = e - row * cols4;
    if (row < rows) dst[row * ld + c] = r[j];
  }
}

// Row strides that keep tensor-core fragment loads free of bank conflicts:
// a row read along its length by lanes (g, c) at (row g, column c) wants a
// stride of 4 (mod 8) words in units of 4 (pad4); one read at (row c,
// column g) wants 8 (mod 16) in units of 8 (pad8).
__host__ __device__ inline int pad4(int n4) {
  return (n4 % 8 == 0) ? n4 + 4 : n4;
}
__host__ __device__ inline int pad8(int n8) {
  return (n8 % 16 == 0) ? n8 + 8 : n8;
}
__host__ __device__ inline int up(int n, int m) { return (n + m - 1) / m * m; }

// Shared-memory layout of chunk_output, offsets in floats.
struct OutLayout {
  int cp, k8, v8, kq, vq, pq;
  int q, k, cw, p, v, s, f, pe, u, total;
};

__host__ __device__ inline OutLayout out_layout(int K, int V, int C) {
  OutLayout L;
  L.cp = up(C, kTile);                // chunk rows, padded to whole tiles
  L.k8 = up(K, 8);
  L.v8 = up(V, 8);
  L.kq = pad4(L.k8);
  L.vq = pad8(L.v8);
  L.pq = pad4(L.cp);
  const int cw = (L.cp + 1) * L.kq, pt = L.cp * L.pq;
  const int f = kMaxPairs * L.k8;
  L.q = 0;                            // [cp][kq]   q, then qs
  L.k = L.q + L.cp * L.kq;            // [cp][kq]   k, then kj
  L.cw = L.k + L.cp * L.kq;           // [cp+1][kq] row 0 = 0, then cw;
  L.p = L.cw;                         // [cp][pq]   P once cw is spent
  L.v = L.cw + (cw > pt ? cw : pt);   // [cp][vq]
  L.s = L.v + L.cp * L.vq;            // [k8][vq]   S_in
  L.f = L.s + L.k8 * L.vq;            // [pairs][k8] 2^(p_I - c_J); first
                                      //   the cumsum's scratch
  L.pe = L.f + (f > kThreads ? f : kThreads);  // [nsub][k8] 2^p_I
  L.u = L.pe + kMaxSub * L.k8;        // [k8]       bonus
  L.total = L.u + L.k8;
  return L;
}

// Shared-memory layout of chunk_state, offsets in floats.
struct StateLayout {
  int cp, k16, v8, kdq, cwq, vq;
  int k, cw, v, tmp, total;
};

__host__ __device__ inline StateLayout state_layout(int K, int V, int C) {
  StateLayout L;
  L.cp = up(C, kTile);
  L.k16 = up(K, 16);                  // rows of the kd^T v tiles
  L.v8 = up(V, 8);
  L.kdq = pad8(L.k16);
  L.cwq = pad4(L.k16);
  L.vq = pad8(L.v8);
  L.k = 0;                            // [cp][kdq]  k, then kd
  L.cw = L.k + L.cp * L.kdq;          // [cp+1][cwq]
  L.v = L.cw + (L.cp + 1) * L.cwq;    // [cp][vq]
  L.tmp = L.v + L.cp * L.vq;          // cumsum scratch
  L.total = L.tmp + kThreads;
  return L;
}

// Inclusive cumsum of w (log2 units) down each column of the cw tile, in
// place: rows 1..cp of `cwb` hold w on entry and cw after; row 0 is set to
// 0, so that row t is the exclusive sum (cw - w) of chunk row t.  One thread
// per (column, block of kScanRows rows), its rows summed in registers; the
// blocks' totals meet in `tmp` (kThreads floats).  The caller syncs after.
constexpr int kScanParts = kMaxDim / kScanRows;
static_assert(kThreads == kScanParts * kMaxDim, "a thread per column part");
__device__ __forceinline__ void column_cumsum(float* cwb, int ld, int K,
                                              int cp, float* tmp) {
  const int col = threadIdx.x % kMaxDim, part = threadIdx.x / kMaxDim;
  for (int kk = threadIdx.x; kk < ld; kk += kThreads) cwb[kk] = 0.0f;
  const bool on = col < K && part * kScanRows < cp;
  float* base = cwb + (1 + part * kScanRows) * ld + col;
  float x[kScanRows];
  float run = 0.0f;
#pragma unroll
  for (int i = 0; i < kScanRows; ++i)
    x[i] = on ? base[i * ld] * kLog2e : 0.0f;
#pragma unroll
  for (int i = 0; i < kScanRows; ++i) {
    run += x[i];
    x[i] = run;
  }
  tmp[part * kMaxDim + col] = run;
  __syncthreads();
  float off = 0.0f;
  for (int j = 0; j < part; ++j) off += tmp[j * kMaxDim + col];
  if (on) {
#pragma unroll
    for (int i = 0; i < kScanRows; ++i) base[i * ld] = x[i] + off;
  }
}

// the (I, J) subchunk pair of pair index p, J < I: (1,0) (2,0) (2,1) ...
__device__ __forceinline__ int pair_query(int& p) {
  int I = 1;
  while (p >= I) {
    p -= I;
    ++I;
  }
  return I;
}

// ---------------------------------------------------------------------------
// A. per-chunk decay and state contribution
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ w, float* __restrict__ dS,
                   float* __restrict__ aend, int T_len, int K, int V, int C,
                   int N) {
  constexpr bool kExactV = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float smem[];
  const StateLayout L = state_layout(K, V, C);
  float* s_k = smem + L.k;
  float* s_cwb = smem + L.cw;
  float* s_v = smem + L.v;
  const int cp = L.cp, kdq = L.kdq, cwq = L.cwq, vq = L.vq;
  const int bh = blockIdx.x / N, n = blockIdx.x % N;
  const int t0 = n * C, cn = min(C, T_len - t0);
  const size_t rk = ((size_t)bh * T_len + t0) * K;
  const size_t rv = ((size_t)bh * T_len + t0) * V;

  stage(s_cwb + cwq, cwq, w + rk, K, cn, cp, K, L.k16);
  stage(s_k, kdq, k + rk, K, cn, cp, K, L.k16);
  stage(s_v, vq, v + rv, V, cn, cp, V, L.v8);
  cp_async_wait_all();
  __syncthreads();
  column_cumsum(s_cwb, cwq, K, cp, smem + L.tmp);
  __syncthreads();

  // kd = k * 2^(cw_end - cw) in place; aend = 2^cw_end
  const float* cw_end = s_cwb + cp * cwq;
  for (int e = threadIdx.x; e < cp * L.k16; e += kThreads) {
    const int s = e / L.k16, kk = e - s * L.k16;
    s_k[s * kdq + kk] *= fast_exp2(cw_end[kk] - s_cwb[(s + 1) * cwq + kk]);
  }
  for (int kk = threadIdx.x; kk < K; kk += kThreads)
    aend[((size_t)bh * N + n) * K + kk] = fast_exp2(cw_end[kk]);
  __syncthreads();

  // dS = kd^T v on tensor cores (3xTF32): a warp owns 16 rows of k and up
  // to 4 tiles of 8 columns of v
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int nt8 = L.v8 / 8, ngroups = (nt8 + 3) / 4;
  float* out = dS + ((size_t)bh * N + n) * K * V;
  for (int item = threadIdx.x >> 5; item < (L.k16 / 16) * ngroups;
       item += kWarps) {
    const int k0 = (item / ngroups) * 16, nb = (item % ngroups) * 4;
    float acc[4][4] = {};
    for (int s0 = 0; s0 < cp; s0 += 8) {
      const float* r0 = s_k + (s0 + c) * kdq + k0 + g;
      const float* r1 = r0 + 4 * kdq;
      const float x[4] = {r0[0], r0[8], r1[0], r1[8]};
      uint32_t ah[4], al[4];
      split4(x, ah, al);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (nb + j >= nt8) break;
        const float* b = s_v + (s0 + c) * vq + (nb + j) * 8 + g;
        mma3<kExactV>(acc[j], ah, al, b[0], b[4 * vq]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = (nb + j) * 8 + 2 * c;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = k0 + g + 8 * h;
        if (row < K)
          store_pair(out + (size_t)row * V, col, V, acc[j][2 * h],
                     acc[j][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B. the recurrence across chunks, one thread per (sequence, k, v):
//    dS_n is replaced by the state chunk n reads, S_{n-1}.
constexpr int kScanAhead = 16;

__global__ void __launch_bounds__(kThreads)
state_scan_kernel(float* __restrict__ dS, const float* __restrict__ aend,
                  const float* __restrict__ s0, float* __restrict__ sf,
                  int K, int V, int N, int blocks_per_seq) {
  const int bh = blockIdx.x / blocks_per_seq;
  const int e = (blockIdx.x % blocks_per_seq) * kThreads + threadIdx.x;
  const int KV = K * V;
  if (e >= KV) return;
  const int kk = e / V;
  float S = s0 ? s0[(size_t)bh * KV + e] : 0.0f;
  float* d = dS + (size_t)bh * N * KV + e;
  const float* a = aend + (size_t)bh * N * K + kk;
  for (int n0 = 0; n0 < N; n0 += kScanAhead) {
    float dv[kScanAhead], av[kScanAhead];
#pragma unroll
    for (int j = 0; j < kScanAhead; ++j) {
      const bool ok = n0 + j < N;
      dv[j] = ok ? d[(size_t)(n0 + j) * KV] : 0.0f;
      av[j] = ok ? a[(size_t)(n0 + j) * K] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kScanAhead; ++j) {
      if (n0 + j < N) {
        d[(size_t)(n0 + j) * KV] = S;
        S = av[j] * S + dv[j];
      }
    }
  }
  sf[(size_t)bh * KV + e] = S;
}

// ---------------------------------------------------------------------------
// C. outputs of one chunk from the state it reads
template <typename T, bool kRwkv>
__global__ void __launch_bounds__(kThreads, 2)
chunk_output_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u,
                    const float* __restrict__ s_in, float* __restrict__ o,
                    int H, int T_len, int K, int V, int C, int N) {
  constexpr bool kExactV = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float smem[];
  const OutLayout L = out_layout(K, V, C);
  float* s_q = smem + L.q;
  float* s_k = smem + L.k;
  float* s_cwb = smem + L.cw;
  float* s_p = smem + L.p;        // over cw, from step 5 on
  float* s_v = smem + L.v;
  float* s_S = smem + L.s;
  float* s_f = smem + L.f;
  float* s_pe = smem + L.pe;
  float* s_u = smem + L.u;
  const int kq = L.kq, k8 = L.k8, vq = L.vq, pq = L.pq, cp = L.cp;
  const int nsub = cp / kSub, npairs = nsub * (nsub - 1) / 2;
  const int ndiag = nsub * kSubPairs, ntiles = cp / kTile;
  // cw of chunk row t is row t+1 of s_cwb; cw_read is row t (rwkv6: the
  // exclusive sum) or row t+1 (ssd)
  const float* s_cw = s_cwb + kq;
  const float* s_cwr = kRwkv ? s_cwb : s_cw;
  const int bh = blockIdx.x / N, n = blockIdx.x % N;
  const int t0 = n * C, cn = min(C, T_len - t0);
  const size_t rk = ((size_t)bh * T_len + t0) * K;
  const size_t rv = ((size_t)bh * T_len + t0) * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;

  // 1. stage the chunk and the state it reads
  stage(s_cwb + kq, kq, w + rk, K, cn, cp, K, k8);
  stage(s_S, vq, s_in + ((size_t)bh * N + n) * K * V, V, K, k8, V, L.v8);
  stage(s_q, kq, q + rk, K, cn, cp, K, k8);
  stage(s_k, kq, k + rk, K, cn, cp, K, k8);
  stage(s_v, vq, v + rv, V, cn, cp, V, L.v8);
  for (int i = threadIdx.x; i < k8; i += kThreads)
    s_u[i] = i < K ? (u ? u[(bh % H) * K + i] : 1.0f) : 0.0f;
  cp_async_wait_all();
  __syncthreads();

  // 2. cumulative decay
  column_cumsum(s_cwb, kq, K, cp, s_f);     // f is free until step 3
  __syncthreads();

  // 3. the pairs s <= t inside each 8-row subchunk in the pairwise form
  //    (the rwkv6 diagonal holds the bonus sum_k q u k), kept in registers
  //    until cw is spent; the pivot factors 2^(p_I - c_J) and 2^p_I.
  float dval[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = threadIdx.x + r * kThreads;
    if (e >= ndiag) continue;
    const int blk = e / kSubPairs, p = e - blk * kSubPairs;
    int tt = 0;
    while ((tt + 1) * (tt + 2) / 2 <= p) ++tt;
    const int t = blk * kSub + tt, s = blk * kSub + p - tt * (tt + 1) / 2;
    const float* qa = s_q + t * kq;
    const float* kb = s_k + s * kq;
    float acc = 0.0f;
    if (kRwkv && s == t) {
      for (int j = 0; j < k8; j += 4) {
        const float4 a = ld4(qa + j), b = ld4(kb + j), d = ld4(s_u + j);
        acc = fmaf(a.x * b.x, d.x, acc);
        acc = fmaf(a.y * b.y, d.y, acc);
        acc = fmaf(a.z * b.z, d.z, acc);
        acc = fmaf(a.w * b.w, d.w, acc);
      }
    } else {
      const float* ca = s_cwr + t * kq;
      const float* cb = s_cw + s * kq;
      for (int j = 0; j < k8; j += 4) {
        const float4 a = ld4(qa + j), b = ld4(kb + j);
        const float4 x = ld4(ca + j), y = ld4(cb + j);
        acc = fmaf(a.x * b.x, fast_exp2(x.x - y.x), acc);
        acc = fmaf(a.y * b.y, fast_exp2(x.y - y.y), acc);
        acc = fmaf(a.z * b.z, fast_exp2(x.z - y.z), acc);
        acc = fmaf(a.w * b.w, fast_exp2(x.w - y.w), acc);
      }
    }
    dval[r] = acc;
  }
  for (int pair = warp; pair < npairs; pair += kWarps) {   // a warp a row
    int J = pair;
    const int I = pair_query(J);
    const float* pI = s_cwr + I * kSub * kq;
    const float* cJ = s_cw + (J * kSub + kSub - 1) * kq;
    for (int kk = lane; kk < k8; kk += 32)
      s_f[pair * k8 + kk] = fast_exp2(pI[kk] - cJ[kk]);
  }
  for (int I = warp; I < nsub; I += kWarps)
    for (int kk = lane; kk < k8; kk += 32)
      s_pe[I * k8 + kk] = fast_exp2(s_cwr[I * kSub * kq + kk]);
  __syncthreads();

  // 4. pre-scale in place: qs = q 2^(cw_read - p_I), kj = k 2^(c_J - cw)
  for (int t = warp; t < cp; t += kWarps) {                // a warp a row
    const int I = t / kSub;
    const float* pI = s_cwr + I * kSub * kq;
    const float* cJ = s_cw + (I * kSub + kSub - 1) * kq;
    for (int kk = lane; kk < k8; kk += 32) {
      s_q[t * kq + kk] *= fast_exp2(s_cwr[t * kq + kk] - pI[kk]);
      s_k[t * kq + kk] *= fast_exp2(cJ[kk] - s_cw[t * kq + kk]);
    }
  }
  __syncthreads();

  // 5. P, over the spent cw: the pairs of step 3, zeros above the diagonal
  //    of each 16-row tile, and every block of a query subchunk I and an
  //    earlier key subchunk J on tensor cores (3xTF32), a warp per 16 x 8
  //    tile: P[t, s] = sum_k (qs[t] 2^(p_I - c_J))[k] kj[s, k].
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = threadIdx.x + r * kThreads;
    if (e >= ndiag) continue;
    const int blk = e / kSubPairs, p = e - blk * kSubPairs;
    int tt = 0;
    while ((tt + 1) * (tt + 2) / 2 <= p) ++tt;
    const int t = blk * kSub + tt, s = blk * kSub + p - tt * (tt + 1) / 2;
    s_p[t * pq + s] = dval[r];
  }
  for (int e = threadIdx.x; e < nsub * kSub * kSub; e += kThreads) {
    const int blk = e / (kSub * kSub), tt = (e / kSub) % kSub, ss = e % kSub;
    if (ss > tt) s_p[(blk * kSub + tt) * pq + blk * kSub + ss] = 0.0f;
  }
  for (int e = threadIdx.x; e < ntiles * kSub * kSub; e += kThreads) {
    const int m = e / (kSub * kSub), tt = (e / kSub) % kSub, ss = e % kSub;
    s_p[(m * kTile + tt) * pq + m * kTile + kSub + ss] = 0.0f;
  }
  // tile m and key subchunk J <= 2m, item = m^2 + J
  for (int item = warp; item < ntiles * ntiles; item += kWarps) {
    int m = 0;
    while ((m + 1) * (m + 1) <= item) ++m;
    const int J = item - m * m, ta = m * kTile, sa = J * kSub;
    const bool top = J < 2 * m;       // rows of subchunk 2m; 2m+1 always
    const float* ft = s_f + (top ? m * (2 * m - 1) + J : 0) * k8;
    const float* fb = s_f + ((2 * m + 1) * m + J) * k8;
    float acc[4] = {};
    for (int k0 = 0; k0 < k8; k0 += 8) {
      const float* r0 = s_q + (ta + g) * kq + k0 + c;
      const float* r1 = r0 + 8 * kq;
      const float x[4] = {top ? r0[0] * ft[k0 + c] : 0.0f,
                          r1[0] * fb[k0 + c],
                          top ? r0[4] * ft[k0 + c + 4] : 0.0f,
                          r1[4] * fb[k0 + c + 4]};
      uint32_t ah[4], al[4];
      split4(x, ah, al);
      const float* b = s_k + (sa + g) * kq + k0 + c;
      mma3<false>(acc, ah, al, b[0], b[4]);
    }
    float* d = s_p + (ta + g) * pq + sa + 2 * c;
    if (top) {
      d[0] = acc[0];
      d[1] = acc[1];
    }
    d[8 * pq] = acc[2];
    d[8 * pq + 1] = acc[3];
  }
  __syncthreads();

  // 6. outputs on tensor cores (3xTF32; P v takes 2 products when v is
  //    bf16, exact in TF32): o = P v + q_read S_in with q_read = qs 2^p_I.
  //    A warp owns 16 rows and up to 4 tiles of 8 columns.
  const int nt8 = L.v8 / 8, ngroups = (nt8 + 3) / 4;
  for (int item = warp; item < ntiles * ngroups; item += kWarps) {
    const int mi = item / ngroups, nb = (item % ngroups) * 4;
    const int ta = mi * kTile;
    if (ta >= cn) continue;
    float acc[4][4] = {};
    for (int s0 = 0; s0 < ta + kTile; s0 += 8) {     // P is 0 past t
      const float* r0 = s_p + (ta + g) * pq + s0 + c;
      const float* r1 = r0 + 8 * pq;
      const float x[4] = {r0[0], r1[0], r0[4], r1[4]};
      uint32_t ah[4], al[4];
      split4(x, ah, al);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (nb + j >= nt8) break;
        const float* b = s_v + (s0 + c) * vq + (nb + j) * 8 + g;
        mma3<kExactV>(acc[j], ah, al, b[0], b[4 * vq]);
      }
    }
    const float* pt = s_pe + 2 * mi * k8;          // subchunk 2 mi
    const float* pb = pt + k8;                     // subchunk 2 mi + 1
    for (int k0 = 0; k0 < k8; k0 += 8) {
      const float* r0 = s_q + (ta + g) * kq + k0 + c;
      const float* r1 = r0 + 8 * kq;
      const float x[4] = {r0[0] * pt[k0 + c], r1[0] * pb[k0 + c],
                          r0[4] * pt[k0 + c + 4], r1[4] * pb[k0 + c + 4]};
      uint32_t ah[4], al[4];
      split4(x, ah, al);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (nb + j >= nt8) break;
        const float* b = s_S + (k0 + c) * vq + (nb + j) * 8 + g;
        mma3<false>(acc[j], ah, al, b[0], b[4 * vq]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = (nb + j) * 8 + 2 * c;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = ta + g + 8 * h;
        if (t < cn)
          store_pair(o + rv + (size_t)t * V, col, V, acc[j][2 * h],
                     acc[j][2 * h + 1]);
      }
    }
  }
}

// One opt-in per kernel instantiation to the card's shared-memory limit.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, bool& done) {
  if (bytes <= 48 * 1024 || done) return cudaSuccess;
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_optin);
  if (err == cudaSuccess) done = true;
  return err;
}

template <typename T, bool kRwkv>
int launch(const void* q, const void* k, const void* v, const float* w,
           const float* u, const float* s0, float* o, float* sf, float* dS,
           float* aend, int BH, int H, int T_len, int K, int V, int C,
           cudaStream_t stream) {
  static bool state_opted = false, out_opted = false;
  const int N = (T_len + C - 1) / C;
  const int state_bytes = state_layout(K, V, C).total * (int)sizeof(float);
  const int out_bytes = out_layout(K, V, C).total * (int)sizeof(float);
  auto state_kernel = chunk_state_kernel<T>;
  auto out_kernel = chunk_output_kernel<T, kRwkv>;
  cudaError_t err = opt_in(state_kernel, state_bytes, state_opted);
  if (err == cudaSuccess) err = opt_in(out_kernel, out_bytes, out_opted);
  if (err != cudaSuccess) return (int)err;

  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  state_kernel<<<BH * N, kThreads, state_bytes, stream>>>(kt, vt, w, dS,
                                                          aend, T_len, K, V,
                                                          C, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per_seq = (K * V + kThreads - 1) / kThreads;
  state_scan_kernel<<<BH * per_seq, kThreads, 0, stream>>>(dS, aend, s0, sf,
                                                           K, V, N, per_seq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  out_kernel<<<BH * N, kThreads, out_bytes, stream>>>(qt, kt, vt, w, u, dS, o,
                                                      H, T_len, K, V, C, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int linear_scan_smem_bytes(int K, int V, int C) {
  const int a = state_layout(K, V, C).total, b = out_layout(K, V, C).total;
  return (a > b ? a : b) * (int)sizeof(float);
}

// Returns the first CUDA error of the three launches (0 = all launched).
extern "C" int linear_scan_launch(const void* q, const void* k, const void* v,
                                  const float* w, const float* u,
                                  const float* s0, float* o, float* sf,
                                  float* dS, float* aend, int BH, int H,
                                  int T, int K, int V, int C, int rwkv6,
                                  int bf16, void* stream) {
  if (C < 1 || C > kMaxDim || K < 1 || K > kMaxDim || V < 1 ||
      V > kMaxDim || H < 1 || BH < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return rwkv6 ? launch<__nv_bfloat16, true>(q, k, v, w, u, s0, o, sf, dS,
                                               aend, BH, H, T, K, V, C, st)
                 : launch<__nv_bfloat16, false>(q, k, v, w, u, s0, o, sf, dS,
                                                aend, BH, H, T, K, V, C, st);
  }
  return rwkv6 ? launch<float, true>(q, k, v, w, u, s0, o, sf, dS, aend, BH,
                                     H, T, K, V, C, st)
               : launch<float, false>(q, k, v, w, u, s0, o, sf, dS, aend, BH,
                                      H, T, K, V, C, st);
}
