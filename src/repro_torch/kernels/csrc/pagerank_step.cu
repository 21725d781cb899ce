// PageRank steps for Hopper (sm_90a) on one row-streaming core: the fused
// step on the pre-padded dense layout (K1) and the unpadded step (K4).
//
// K1 replaces the TPU kernel src/repro/kernels/pagerank_step.py::_fused_kernel
// (reached through pagerank_step_fused).  For an (Np, Mp) H stored as
// float32, bfloat16, float16 or int8 (with per-row float32 scales s):
//
//     yp[r] = d * (s[r] * sum_c H[r, c] * xp[c]) + t      (s = 1 without scales)
//     leak  = sum_r yp[r] * dangp[r]
//
// The padded tail (zero rows of H, zero dang) gets y = t, as on the TPU.
//
// K4 replaces the TPU kernel src/repro/kernels/pagerank_step.py::_kernel
// (reached through pagerank_step, behind ops.pagerank_iteration).  For an
// (N, M) H of any shape and alignment, in the same storage types, it writes
// y = d * (H @ x) + t, with no leak.  The TPU wrapper pads H to its tiles on
// every call; here nothing is padded: a copy of H per call would move more
// bytes than the step itself.
//
// Bound.  Both are matrix-vector products: 2 operations per element of H
// against 1 to 4 bytes of it, so they are bound by the bytes of H read from
// device memory.  At the main paths' shapes (K1: 5120 x 5120, K4: 5000 x
// 5000) that is about 105 / 100 MB in float32, 52 / 50 MB in bfloat16 and
// float16 and 26 MB in int8; at the data-sheet 3.35 TB/s (H100 SXM), 31 /
// 30 us, 16 / 15 us and 8 us.  The float32 FMAs at 67 TFLOP/s take under
// 1 us.  To stream at that rate an SM needs some 16-32 kB of H in flight
// (the rate times a device-memory latency under load).
//
// Design: one core (stream_rows) under both kernels.
//   * A warp owns R consecutive rows; a CTA owns kRowsPerCta = 8 rows (8 / R
//     warps), so the grid is one wave of equal warps (640 CTAs at Np = 5120,
//     625 at N = 5000) and no warp waits on another.
//   * Every load of H is 16 bytes a lane at every storage type (4 float32,
//     8 bfloat16 / float16, 16 int8 elements), so a warp reads 512
//     contiguous bytes of each of its R rows per step.  A ring of D steps
//     of R loads each stays in flight in registers: a lane consumes one
//     step and at once issues the load D steps ahead, so 16 * R * D bytes a
//     lane are always in flight, whatever the storage type.  H is loaded
//     with L1::no_allocate (it is read once) and a 256-byte L2 fetch.
//   * x is read through L1 (it stays there: H does not allocate in L1), one
//     load of V floats per step that feeds all R rows, so the x bytes a lane
//     reads are at most the H bytes (bf16 / f16 at R = 2, int8 at R = 4)
//     and half of them at float32 (R = 2).
//   * H is upcast by vec4.cuh's Vec4 (int8 without the conversion unit, by
//     a byte permute); every product is accumulated in float32.
//   * K4 takes any shape: when the row pitch is a multiple of 16 bytes and
//     H and x are 16-byte aligned (every main-path call), the rows of a warp
//     share the ring and x's vector loads; otherwise each row peels its own
//     head and tail with scalar loads around a 16-byte-aligned vector body,
//     and reads x in vectors where that body meets an aligned x, else a
//     float at a time.  Rows past N are masked.
//   * Summation order is fixed: each lane sums its columns in increasing
//     order, then the 32 lanes by a fixed butterfly; no atomics in any sum,
//     so two calls give the same bits.
//   * The epilogues follow the plain versions' order, rounded step by step
//     (no contraction to fma): K4 y = d * acc + t; K1 acc = s * acc (int8
//     only), then y = d * acc + t, and the CTA's leak partial (its rows in
//     order).  t is read through a device pointer, so callers keep it on
//     the device with no host sync.
//   * K1's leak: CTAs run in no order, so each writes its partial and a
//     one-block kernel sums the partials in a fixed order.  That kernel is
//     launched as a programmatic dependent launch: every K1 CTA triggers it
//     at its start, so it is resident and waits (griddepcontrol.wait) for
//     K1's last store instead of paying a launch after K1 ends.

#include <type_traits>

#include "vec4.cuh"

namespace {

constexpr int kRowsPerCta = 8;
constexpr int kReduceThreads = 256;

// A configuration of the core: R rows per warp and a ring D steps deep.
template <int R_, int D_>
struct Cfg {
  static constexpr int R = R_;
  static constexpr int D = D_;
  static constexpr int W = kRowsPerCta / R_;  // warps per CTA
  static_assert(kRowsPerCta % R_ == 0, "R must divide kRowsPerCta");
};

// The configuration each storage type takes, K1 and K4 alike
// (scripts/step_tile_sweep.py times the candidates).
template <typename T>
struct Chosen {
  using C = Cfg<2, 4>;
};
template <>
struct Chosen<int8_t> {
  using C = Cfg<4, 2>;
};

// 16 bytes of H, read once: no L1 allocation, a 256-byte L2 fetch.
__device__ __forceinline__ uint4 load16(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// 16 bytes of H: V elements, upcast to float32 by vec4.cuh's Vec4<T>.
template <typename T>
struct Lanes {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));
  __device__ __forceinline__ static void up(uint4 q, float (&v)[V]) {
    const auto* raw = reinterpret_cast<const typename Vec4<T>::Raw*>(&q);
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 f = Vec4<T>::up(raw[i]);
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  }
};

// The core.  Adds to acc[r] this lane's share of sum_c H[r, c] * x[c] over
// c < M for the R rows at h + r * pitch (rows past ``rows`` re-read the
// last valid row and their sums are discarded by the caller).  M is a
// multiple of V and every row is 16-byte aligned; x is 16-byte aligned
// when kXVec (one load of V floats feeds the R rows), any alignment
// otherwise (V scalar loads).  A lane's columns are lane * V + k * 32 * V,
// summed in increasing k: the order is fixed.
template <typename T, int R, int D, bool kXVec>
__device__ __forceinline__ void stream_rows(const T* __restrict__ h,
                                            size_t pitch, int rows,
                                            const float* __restrict__ x,
                                            int M, int lane,
                                            float (&acc)[R]) {
  constexpr int V = Lanes<T>::V;
  constexpr int kStep = 32 * V;
  const T* row[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    row[r] = h + static_cast<size_t>(min(r, rows - 1)) * pitch;
  const int steps = (M + kStep - 1) / kStep;
  uint4 buf[D][R];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const int c = j * kStep + lane * V;
    if (c < M) {
#pragma unroll
      for (int r = 0; r < R; ++r) buf[j][r] = load16(row[r] + c);
    }
  }
  for (int k = 0; k < steps; k += D) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int c = (k + j) * kStep + lane * V;
      if (c < M) {
        float xv[V];
        if (kXVec) {
#pragma unroll
          for (int e = 0; e < V; e += 4) {
            const float4 q = __ldg(reinterpret_cast<const float4*>(x + c + e));
            xv[e] = q.x;
            xv[e + 1] = q.y;
            xv[e + 2] = q.z;
            xv[e + 3] = q.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) xv[e] = __ldg(x + c + e);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float hv[V];
          Lanes<T>::up(buf[j][r], hv);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[r] = fmaf(hv[e], xv[e], acc[r]);
        }
        const int n = c + D * kStep;
        if (n < M) {
#pragma unroll
          for (int r = 0; r < R; ++r) buf[j][r] = load16(row[r] + n);
        }
      }
    }
  }
}

// One row of any alignment: a head of scalar loads up to the first 16-byte
// boundary, the 16-byte body on the core (R = 1; x in vectors where the
// body's first x is 16-byte aligned, else a float at a time), and a tail of
// scalar loads; this lane's share, in the order head, body, tail.
template <typename T, int D>
__device__ __forceinline__ float peeled_row(const T* __restrict__ h,
                                            const float* __restrict__ x,
                                            int M, int lane) {
  constexpr int V = Lanes<T>::V;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(h) & 15) /
                  static_cast<int>(sizeof(T));
  const int head = min(M, (V - mis) % V);
  const int body = (M - head) / V * V;
  float acc[1] = {0.f};
  if (lane < head)
    acc[0] = fmaf(Scalar<T>::load(h + lane), __ldg(x + lane), 0.f);
  if ((reinterpret_cast<uintptr_t>(x + head) & 15) == 0)
    stream_rows<T, 1, D, true>(h + head, 0, 1, x + head, body, lane, acc);
  else
    stream_rows<T, 1, D, false>(h + head, 0, 1, x + head, body, lane, acc);
  const int tail = head + body;
  if (lane < M - tail)
    acc[0] = fmaf(Scalar<T>::load(h + tail + lane), __ldg(x + tail + lane),
                  acc[0]);
  return acc[0];
}

template <int R>
__device__ __forceinline__ void warp_sum(float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  }
}

// acc[r] for r = i, without indexing the register array at run time.
template <int R>
__device__ __forceinline__ float pick(const float (&acc)[R], int i) {
  float v = acc[0];
#pragma unroll
  for (int r = 1; r < R; ++r) v = i == r ? acc[r] : v;
  return v;
}

// K1.  Np is a multiple of kRowsPerCta, Mp of 16; H and x 16-byte aligned.
template <typename T, class C, bool kScales>
__global__ void __launch_bounds__(C::W * 32)
fused_step_kernel(const T* __restrict__ H, const float* __restrict__ x,
                  const float* __restrict__ dang,
                  const float* __restrict__ t_ptr,
                  const float* __restrict__ scales, float* __restrict__ y,
                  float* __restrict__ partials, int Mp, float d) {
  // let the leak reduce be scheduled now; it waits for this grid's stores
  asm volatile("griddepcontrol.launch_dependents;");
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRowsPerCta + warp * C::R;
  float acc[C::R];
#pragma unroll
  for (int r = 0; r < C::R; ++r) acc[r] = 0.f;
  stream_rows<T, C::R, C::D, true>(H + static_cast<size_t>(row0) * Mp, Mp,
                                   C::R, x, Mp, lane, acc);
  warp_sum(acc);

  const float t = __ldg(t_ptr);
  float yr[C::R];
#pragma unroll
  for (int r = 0; r < C::R; ++r) {
    float a = acc[r];
    if (kScales) a = __fmul_rn(__ldg(scales + row0 + r), a);
    yr[r] = __fadd_rn(__fmul_rn(d, a), t);
  }
  if (lane < C::R) y[row0 + lane] = pick(yr, lane);

  __shared__ float warp_leak[C::W];
  if (lane == 0) {
    float leak = 0.f;
#pragma unroll
    for (int r = 0; r < C::R; ++r)
      leak = __fadd_rn(leak, __fmul_rn(yr[r], __ldg(dang + row0 + r)));
    warp_leak[warp] = leak;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < C::W; ++w) s = __fadd_rn(s, warp_leak[w]);
    partials[blockIdx.x] = s;
  }
}

// Sums the per-CTA partials in a fixed order: a strided pass per thread,
// then a tree over shared memory.  Launched as K1's programmatic
// dependent, it first waits until K1 has finished and its stores are
// visible (a no-op after an ordinary launch).
__global__ void __launch_bounds__(kReduceThreads)
leak_reduce_kernel(const float* __restrict__ partials, int n,
                   float* __restrict__ leak) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __shared__ float s[kReduceThreads];
  float a = 0.f;
  for (int i = threadIdx.x; i < n; i += kReduceThreads)
    a += __ldcg(partials + i);
  s[threadIdx.x] = a;
  __syncthreads();
  for (int off = kReduceThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) s[threadIdx.x] += s[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) *leak = s[0];
}

// K4.  Any N, M; kShared: the row pitch is a multiple of 16 bytes and H and
// x are 16-byte aligned.
template <typename T, class C, bool kShared>
__global__ void __launch_bounds__(C::W * 32)
step_kernel(const T* __restrict__ H, const float* __restrict__ x,
            const float* __restrict__ t_ptr, float* __restrict__ y, int N,
            int M, float d) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRowsPerCta + warp * C::R;
  if (row0 >= N) return;
  const int rows = min(C::R, N - row0);
  const T* h = H + static_cast<size_t>(row0) * M;
  float acc[C::R];
#pragma unroll
  for (int r = 0; r < C::R; ++r) acc[r] = 0.f;
  if (kShared) {
    stream_rows<T, C::R, C::D, true>(h, M, rows, x, M, lane, acc);
  } else {
#pragma unroll
    for (int r = 0; r < C::R; ++r) {
      if (r < rows)
        acc[r] = peeled_row<T, C::D * C::R>(
            h + static_cast<size_t>(r) * M, x, M, lane);
    }
  }
  warp_sum(acc);
  if (lane < rows)
    y[row0 + lane] = __fadd_rn(__fmul_rn(d, pick(acc, lane)), __ldg(t_ptr));
}

// K1, then its leak reduce as a programmatic dependent launch.
template <typename T, class C>
cudaError_t launch_fused(const void* H, const float* x, const float* dang,
                         const float* t, const float* scales, float* y,
                         float* partials, float* leak, int Np, int Mp,
                         float d, cudaStream_t stream) {
  const dim3 grid(Np / kRowsPerCta);
  const T* h = static_cast<const T*>(H);
  if (scales != nullptr) {
    fused_step_kernel<T, C, true><<<grid, C::W * 32, 0, stream>>>(
        h, x, dang, t, scales, y, partials, Mp, d);
  } else {
    fused_step_kernel<T, C, false><<<grid, C::W * 32, 0, stream>>>(
        h, x, dang, t, nullptr, y, partials, Mp, d);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(kReduceThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, leak_reduce_kernel,
                            static_cast<const float*>(partials),
                            Np / kRowsPerCta, leak);
}

template <typename T, class C>
cudaError_t launch_unpadded(const void* H, const float* x, const float* t,
                            float* y, int N, int M, float d,
                            cudaStream_t stream) {
  const dim3 grid((N + kRowsPerCta - 1) / kRowsPerCta);
  const T* h = static_cast<const T*>(H);
  const bool shared =
      (static_cast<size_t>(M) * sizeof(T)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(H) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (shared) {
    step_kernel<T, C, true><<<grid, C::W * 32, 0, stream>>>(h, x, t, y, N, M,
                                                            d);
  } else {
    step_kernel<T, C, false><<<grid, C::W * 32, 0, stream>>>(h, x, t, y, N,
                                                             M, d);
  }
  return cudaGetLastError();
}

// Calls f.template operator()<T>() for storage type code ``dtype``.
template <class F>
cudaError_t by_type(int dtype, F&& f) {
  switch (dtype) {
    case 0:
      return f(static_cast<float*>(nullptr));
    case 1:
      return f(static_cast<__nv_bfloat16*>(nullptr));
    case 2:
      return f(static_cast<__half*>(nullptr));
    case 3:
      return f(static_cast<int8_t*>(nullptr));
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Rows one CTA owns: Np must be a multiple of it.
int pagerank_step_fused_rows_per_block() { return kRowsPerCta; }

// The configuration storage type ``dtype`` takes (K1 and K4 alike):
// out[0..1] = R, D.  Returns 0, or cudaErrorInvalidValue.
int pagerank_step_config(int dtype, int* out) {
  return static_cast<int>(by_type(dtype, [&](auto* tag) {
    using C = typename Chosen<std::remove_pointer_t<decltype(tag)>>::C;
    out[0] = C::R;
    out[1] = C::D;
    return cudaSuccess;
  }));
}

// Storage type codes: 0 float32, 1 bfloat16, 2 float16, 3 int8.
// ``scales`` may be null.  ``partials`` holds Np / rows_per_block floats.
// Returns the cudaError_t of the two launches (0 on success).
int pagerank_step_fused_launch(int dtype, const void* H, const void* x,
                               const void* dang, const void* t,
                               const void* scales, void* y, void* partials,
                               void* leak, int Np, int Mp, float d,
                               void* stream) {
  if (Np <= 0 || Mp <= 0 || Np % kRowsPerCta != 0 || Mp % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_type(dtype, [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return launch_fused<T, typename Chosen<T>::C>(
        H, static_cast<const float*>(x), static_cast<const float*>(dang),
        static_cast<const float*>(t), static_cast<const float*>(scales),
        static_cast<float*>(y), static_cast<float*>(partials),
        static_cast<float*>(leak), Np, Mp, d,
        static_cast<cudaStream_t>(stream));
  }));
}

// The unpadded step (K4): y = d * (H @ x) + t for H (N, M) row-major, x
// (M,) float32, t one float32 on the device, y (N,) float32; any shape and
// element alignment.  Returns the cudaError_t of the launch.
int pagerank_step_launch(int dtype, const void* H, const void* x,
                         const void* t, void* y, int N, int M, float d,
                         void* stream) {
  if (N <= 0 || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_type(dtype, [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return launch_unpadded<T, typename Chosen<T>::C>(
        H, static_cast<const float*>(x), static_cast<const float*>(t),
        static_cast<float*>(y), N, M, d, static_cast<cudaStream_t>(stream));
  }));
}

}  // extern "C"
