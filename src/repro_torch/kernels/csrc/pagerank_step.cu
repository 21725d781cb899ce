// PageRank steps for Hopper (sm_90a): the fused step on the pre-padded
// dense layout (K1), and below it the unpadded step (K4).
//
// K1 replaces the TPU kernel src/repro/kernels/pagerank_step.py::_fused_kernel
// (reached through pagerank_step_fused).  It computes, for a (Np, Mp) H
// stored as float32, bfloat16, float16 or int8 (with per-row float32
// scales s):
//
//     yp[r] = d * (s[r] * sum_c H[r, c] * xp[c]) + t      (s = 1 without scales)
//     leak  = sum_r yp[r] * dangp[r]
//
// Bound.  One step is a matrix-vector product: 2 operations per element of
// H against 1 to 4 bytes of H, so it is bound by the bytes of H read from
// device memory.  At Np = Mp = 5120 that is about 105 MB in float32, 52 MB
// in bfloat16 / float16 and 26 MB in int8 per step; at the data-sheet rate
// of 3.35 TB/s (H100 SXM) that is 31 us, 16 us and 8 us.  The int8 layout
// fits in the 50 MB L2 (data sheet) and the bf16 / f16 layouts nearly do,
// so back-to-back steps over the same H may run above the device-memory
// bound for those tiers.
//
// Design.  One pass over H with the affine epilogue and the dangling leak
// fused into it:
//   * A CTA of 4 warps owns 8 consecutive rows; each warp owns 2 of them
//     and walks the whole Mp axis itself (the TPU kernel's in-order grid
//     axis becomes a loop inside the warp).  Each lane reads 16 bytes of
//     each of its 2 rows per step of the loop, so a warp's loads are
//     coalesced 512-byte rows, and every xp value it reads (through the
//     read-only cache; xp is 20 KB at Mp = 5120) feeds 2 rows.  The loop
//     is unrolled 4 deep to keep loads in flight; small CTAs (640 at
//     Np = 5120) spread the rows evenly over the 132 SMs.
//   * H is upcast in registers with the conversion intrinsics and every
//     product is accumulated in float32, then reduced across the warp.
//   * The epilogue follows the TPU kernel's order: acc = s * acc (int8
//     only), then y = d * acc + t, rounded step by step (no contraction to
//     fma), so it matches the plain version's arithmetic.
//   * The leak: blocks run in no order, so each CTA writes the partial sum
//     of y * dang over its rows (in a fixed order) to a scratch buffer, and
//     a second one-block kernel sums the partials in a fixed order.  No
//     atomics: a repeated solve is bit-identical.
//   * t is read through a device pointer, so the caller keeps it on the
//     device across iterations with no host sync.
// The padded tail (zero rows of H, zero dang) gets y = t, as on the TPU.
//
// The unpadded step (K4), beside it in this file.
//
// Replaces the TPU kernel src/repro/kernels/pagerank_step.py::_kernel
// (reached through pagerank_step, behind ops.pagerank_iteration).  For an
// (N, M) H of any shape, stored as float32, bfloat16, float16 or int8, it
// computes y = d * (H @ x) + t into y (N,) float32, with no leak output.
// The TPU wrapper pads H to its tiles on every call; here nothing is
// padded: a copy of H per call would move more bytes than the step itself
// (100 MB at N = 5000 in float32).
//
// Bound.  The bytes of H, once (N * M * 1..4 bytes), as for K1: 100 MB,
// 30 us at N = M = 5000 in float32 (data-sheet 3.35 TB/s).
//
// Design.  The row layout of the streaming matvec (K2, csrc/
// streaming_matvec.cu) at one query, with K1's affine epilogue and t read
// through a device pointer; the loads come from the shared vec4.cuh:
//   * A CTA of 2 warps owns 8 rows; a warp covers 4 rows x 32 columns per
//     step (lane = row group lane >> 3, column group lane & 7).  When M is
//     a multiple of 4 and H and x are aligned to 4 elements, each lane
//     loads 4 consecutive elements of H per step (16, 8 or 4 bytes by
//     type) and a float4 of x that the 4 row groups share; otherwise each
//     lane loads one element per step.  Rows past N are masked.
//   * Each lane sums its columns in increasing order, the 8 lanes of a row
//     in a fixed butterfly (no atomics: repeats are bit-identical); then
//     y = d * acc + t, rounded step by step as the plain version.

#include "vec4.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kReduceThreads = 256;

// One 16-byte vector of H, upcast to float32.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[N]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&v)[N]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Vec<__half> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __half* p, float (&v)[N]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __half2* h = reinterpret_cast<const __half2*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(const int8_t* p, float (&v)[N]) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    const int8_t* b = reinterpret_cast<const int8_t*>(&q);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = static_cast<float>(b[i]);
  }
};

template <typename T, bool kScales>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const T* __restrict__ H, const float* __restrict__ x,
                  const float* __restrict__ dang,
                  const float* __restrict__ t_ptr,
                  const float* __restrict__ scales, float* __restrict__ y,
                  float* __restrict__ partials, int Mp, float d) {
  constexpr int V = Vec<T>::N;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;

  float acc[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = 0.f;

  const T* base = H + static_cast<size_t>(row0) * Mp;
#pragma unroll 4
  for (int c = lane * V; c < Mp; c += 32 * V) {
    float xv[V];
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(x + c + k));
      xv[k] = q.x;
      xv[k + 1] = q.y;
      xv[k + 2] = q.z;
      xv[k + 3] = q.w;
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float hv[V];
      Vec<T>::load(base + static_cast<size_t>(r) * Mp + c, hv);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[r] = fmaf(hv[k], xv[k], acc[r]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  }

  __shared__ float warp_leak[kWarps];
  if (lane == 0) {
    const float t = __ldg(t_ptr);
    float leak = 0.f;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + r;
      float a = acc[r];
      if (kScales) a = __fmul_rn(__ldg(scales + row), a);
      const float yr = __fadd_rn(__fmul_rn(d, a), t);
      y[row] = yr;
      leak = __fadd_rn(leak, __fmul_rn(yr, __ldg(dang + row)));
    }
    warp_leak[warp] = leak;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, warp_leak[w]);
    partials[blockIdx.x] = s;
  }
}

// Sums the per-CTA partials in a fixed order: a strided pass per thread,
// then a tree over shared memory.
__global__ void __launch_bounds__(kReduceThreads)
leak_reduce_kernel(const float* __restrict__ partials, int n,
                   float* __restrict__ leak) {
  __shared__ float s[kReduceThreads];
  float a = 0.f;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) a += partials[i];
  s[threadIdx.x] = a;
  __syncthreads();
  for (int off = kReduceThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) s[threadIdx.x] += s[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) *leak = s[0];
}

template <typename T>
void launch_step(const void* H, const float* x, const float* dang,
                 const float* t, const float* scales, float* y,
                 float* partials, int Np, int Mp, float d,
                 cudaStream_t stream) {
  const dim3 grid(Np / kRowsPerBlock);
  const T* h = static_cast<const T*>(H);
  if (scales != nullptr) {
    fused_step_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        h, x, dang, t, scales, y, partials, Mp, d);
  } else {
    fused_step_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        h, x, dang, t, nullptr, y, partials, Mp, d);
  }
}

constexpr int kStepThreads = 64;  // K4: 2 warps, 8 rows per CTA
constexpr int kStepRows = kStepThreads / 32 * 4;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kStepThreads)
step_kernel(const T* __restrict__ H, const float* __restrict__ x,
            const float* __restrict__ t_ptr, float* __restrict__ y, int N,
            int M, float d) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cg = lane & 7;  // column group
  const int row = blockIdx.x * kStepRows + warp * 4 + (lane >> 3);
  const bool ok = row < N;
  const T* h = H + static_cast<size_t>(ok ? row : 0) * M;
  float acc = 0.f;
  if (kVec) {
#pragma unroll 4
    for (int c = cg * 4; c < M; c += 32) {
      const float4 w = Vec4<T>::up(Vec4<T>::load(h + c));
      const float4 xv = __ldg(reinterpret_cast<const float4*>(x + c));
      acc = fmaf(w.x, xv.x, acc);
      acc = fmaf(w.y, xv.y, acc);
      acc = fmaf(w.z, xv.z, acc);
      acc = fmaf(w.w, xv.w, acc);
    }
  } else {
#pragma unroll 4
    for (int c = cg; c < M; c += 8)
      acc = fmaf(Scalar<T>::load(h + c), __ldg(x + c), acc);
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (cg == 0 && ok) y[row] = __fadd_rn(__fmul_rn(d, acc), __ldg(t_ptr));
}

template <typename T>
cudaError_t launch_unpadded(const void* H, const float* x, const float* t,
                            float* y, int N, int M, float d, bool vec,
                            cudaStream_t stream) {
  const dim3 grid((N + kStepRows - 1) / kStepRows);
  const T* h = static_cast<const T*>(H);
  if (vec) {
    step_kernel<T, true><<<grid, kStepThreads, 0, stream>>>(h, x, t, y, N,
                                                            M, d);
  } else {
    step_kernel<T, false><<<grid, kStepThreads, 0, stream>>>(h, x, t, y, N,
                                                             M, d);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows one CTA owns: Np must be a multiple of it.
int pagerank_step_fused_rows_per_block() { return kRowsPerBlock; }

// Storage type codes: 0 float32, 1 bfloat16, 2 float16, 3 int8.
// ``scales`` may be null.  ``partials`` holds Np / rows_per_block floats.
// Returns the cudaError_t of the two launches (0 on success).
int pagerank_step_fused_launch(int dtype, const void* H, const void* x,
                               const void* dang, const void* t,
                               const void* scales, void* y, void* partials,
                               void* leak, int Np, int Mp, float d,
                               void* stream) {
  if (Np <= 0 || Mp <= 0 || Np % kRowsPerBlock != 0 || Mp % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(dang);
  const float* tf = static_cast<const float*>(t);
  const float* sf = static_cast<const float*>(scales);
  float* yf = static_cast<float*>(y);
  float* pf = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch_step<float>(H, xf, df, tf, sf, yf, pf, Np, Mp, d, s);
      break;
    case 1:
      launch_step<__nv_bfloat16>(H, xf, df, tf, sf, yf, pf, Np, Mp, d, s);
      break;
    case 2:
      launch_step<__half>(H, xf, df, tf, sf, yf, pf, Np, Mp, d, s);
      break;
    case 3:
      launch_step<int8_t>(H, xf, df, tf, sf, yf, pf, Np, Mp, d, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  leak_reduce_kernel<<<1, kReduceThreads, 0, s>>>(
      pf, Np / kRowsPerBlock, static_cast<float*>(leak));
  return static_cast<int>(cudaGetLastError());
}

// The unpadded step (K4): y = d * (H @ x) + t for H (N, M) row-major, x
// (M,) float32, t one float32 on the device, y (N,) float32.  ``vec``
// selects the 4-element loads: M a multiple of 4, H aligned to 4
// elements and x to 16 bytes.  Returns the cudaError_t of the launch.
int pagerank_step_launch(int dtype, const void* H, const void* x,
                         const void* t, void* y, int N, int M, float d,
                         int vec, void* stream) {
  if (N <= 0 || M <= 0 || (vec && M % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* tf = static_cast<const float*>(t);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch_unpadded<float>(H, xf, tf, yf, N, M, d, vec, s));
    case 1:
      return static_cast<int>(
          launch_unpadded<__nv_bfloat16>(H, xf, tf, yf, N, M, d, vec, s));
    case 2:
      return static_cast<int>(
          launch_unpadded<__half>(H, xf, tf, yf, N, M, d, vec, s));
    case 3:
      return static_cast<int>(
          launch_unpadded<int8_t>(H, xf, tf, yf, N, M, d, vec, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
