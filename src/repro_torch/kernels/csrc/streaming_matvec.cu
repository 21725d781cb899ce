// Weight-streaming batched matrix-vector product for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/streaming_matvec.py::_kernel
// (reached through streaming_matvec).  For W (N, M) stored as float32,
// bfloat16, float16 or int8 and X (B, M) float32 it computes
//
//     Y[b, i] = sum_j X[b, j] * float(W[i, j])          Y: (B, N) float32
//
// accumulating in float32.  int8 row scales are applied by the callers, as
// on the TPU.  In batched personalized PageRank W is the padded transition
// matrix and the B queries share every sweep over it.
//
// Bound.  Per launch the card must read W once (N * M * 1..4 bytes) and X,
// write Y, and do 2 * B * N * M float32 operations.  At N = M = 5120 W is
// 105 MB in float32 (31 us at the data-sheet 3.35 TB/s), 52 MB in bf16 /
// f16 and 26 MB in int8.  The operations take 6.3 us at B = 8 and 50 us at
// B = 64 at the data-sheet 67 TFLOP/s float32 outside the tensor cores, so
// the kernel is bound by the bytes of W at small B and by float32
// operations at B = 64.
//
// Design.  The TPU kernel accumulates into a resident output block along
// an in-order grid axis over M; here each CTA owns a set of rows of W and
// walks the whole M axis itself:
//   * The queries are padded to QP, the next power of two of B (at most
//     64), a compile-time tile.  Each lane keeps QP partial sums for each
//     of its rows in registers.
//   * A warp covers 4 row groups x 32 columns per step: 8 lanes per row
//     group, each reading 4 consecutive elements of W (one 16-, 8- or
//     4-byte load by storage type, so a row's 8 lanes read whole 32-byte
//     sectors), kept as raw bits until used, then upcast (int8 with byte
//     permutes and a float subtraction, the others with the conversion
//     intrinsics) and used for all QP queries.  W streams once per launch
//     for all queries: with B <= 64 a launch makes one pass over W (at
//     B = 8 and at B = 64 alike); a larger B is split into groups of 64
//     queries along the grid's y axis, one pass each.
//   * X sits in shared memory in tiles of 256, 128 or 64 columns (by QP)
//     for all QP queries; the 8 lanes of a row group read 128 contiguous
//     bytes of a query.  Shared memory hands a lane one float for every
//     4 FMA slots, so from QP = 16 on, where the FMAs set the pace, each
//     lane owns 2 rows (its row group is rows r and r + 4) and every float
//     of X it reads feeds both.
//   * Two X tiles are kept: while one is summed, the CTA fills the other
//     with 16-byte cp.async copies and each lane has the next tile's W
//     loads in flight, so neither latency stalls the sums.
//   * A CTA is 2 warps: 8 rows (as K1) up to QP = 8, 16 rows above.  Each
//     CTA reads all of X from L2 once; 16-row CTAs at small QP halve those
//     re-reads but were slower on the card (PERF.md), so small batches
//     keep 640 CTAs at N = 5120.
//   * No atomics: every lane sums its columns in increasing order, then the
//     8 lanes of a row are summed with a fixed butterfly, so a repeated
//     call gives the same bits.  The column order of a lane does not depend
//     on QP, so a query's result is the same whatever else shares its
//     batch.
// N is any size (rows past N are masked); M must be a multiple of 4, W
// aligned to 4 elements and X to 16 bytes (the wrapper pads M otherwise;
// every layout of the engine already is).

#include "vec4.cuh"

namespace {

constexpr int kMaxQueries = 64;
// a warp covers 4 row groups x 32 columns per step: lane = (row group
// lane >> 3, column group lane & 7), each lane 4 consecutive columns of
// each of its rows
constexpr int kStep = 32;
constexpr int kThreads = 64;  // 2 warps per CTA

template <int QP>
struct Shape {
  // rows per lane: 2 from QP = 16 on (rows r and r + 4 of its warp), so
  // each float of X read from shared memory feeds both
  static constexpr int kRowsPerLane = QP >= 16 ? 2 : 1;
  static constexpr int kRowsPerWarp = 4 * kRowsPerLane;
  static constexpr int kRows = kThreads / 32 * kRowsPerWarp;  // per CTA
  // columns of X per shared-memory tile, and 32-column steps per tile
  static constexpr int kTile = QP <= 8 ? 256 : (QP <= 32 ? 128 : 64);
  static constexpr int kSteps = kTile / kStep;
  // two tiles of X: one being read, one being filled
  static constexpr int kSmemBytes = 2 * QP * kTile * 4;
};

// 16-byte asynchronous copy global -> shared; zero-fills when !pred.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool pred) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one group (the newest) is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <typename T, int QP>
__global__ void __launch_bounds__(kThreads)
streaming_matvec_kernel(const T* __restrict__ W, const float* __restrict__ X,
                        float* __restrict__ Y, int N, int M, int B) {
  using S = Shape<QP>;
  using Raw = typename Vec4<T>::Raw;
  constexpr int RL = S::kRowsPerLane;
  constexpr int kVecs = S::kTile / 4;  // float4 per query per tile
  static_assert(QP * kVecs % kThreads == 0, "uneven X staging");
  extern __shared__ __align__(16) float xs[];  // [2][QP][kTile]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = (lane & 7) * 4;  // this lane's columns within a step
  // this lane's rows: row0, row0 + 4, ...
  const int row0 =
      blockIdx.x * S::kRows + warp * S::kRowsPerWarp + (lane >> 3);
  bool row_ok[RL];
  const T* w_row[RL];
#pragma unroll
  for (int r = 0; r < RL; ++r) {
    row_ok[r] = row0 + 4 * r < N;
    w_row[r] = W + static_cast<size_t>(row_ok[r] ? row0 + 4 * r : 0) * M;
  }
  const int q0 = blockIdx.y * QP;
  const int n_tiles = (M + S::kTile - 1) / S::kTile;

  // X[q0 : q0 + QP, tile] -> xs[buf], zero past B and past M
  auto stage = [&](int tile, int buf) {
    const int c0 = tile * S::kTile;
    float* dst = xs + buf * QP * S::kTile;
#pragma unroll
    for (int j = 0; j < QP * kVecs / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int b = i / kVecs;
      const int k = (i % kVecs) * 4;
      const bool ok = q0 + b < B && c0 + k < M;
      cp_async16(dst + b * S::kTile + k,
                 ok ? X + static_cast<size_t>(q0 + b) * M + c0 + k : X, ok);
    }
  };
  // this lane's W values of one tile (raw bits), zero past N and past M
  auto load_w = [&](Raw (&w)[RL][S::kSteps], int tile) {
#pragma unroll
    for (int r = 0; r < RL; ++r) {
#pragma unroll
      for (int s = 0; s < S::kSteps; ++s) {
        const int c = tile * S::kTile + s * kStep + col;
        if (row_ok[r] && c < M) {
          w[r][s] = Vec4<T>::load(w_row[r] + c);
        } else {
          w[r][s] = Raw{};
        }
      }
    }
  };

  float acc[RL][QP];
#pragma unroll
  for (int r = 0; r < RL; ++r)
#pragma unroll
    for (int b = 0; b < QP; ++b) acc[r][b] = 0.f;

  Raw w[RL][S::kSteps], w_next[RL][S::kSteps];
  stage(0, 0);
  cp_async_commit();
  load_w(w, 0);
  for (int t = 0; t < n_tiles; ++t) {
    // the next tile's X and W are in flight while this one is summed
    if (t + 1 < n_tiles) {
      stage(t + 1, (t + 1) & 1);
      load_w(w_next, t + 1);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const float* xt = xs + (t & 1) * QP * S::kTile + col;
#pragma unroll
    for (int s = 0; s < S::kSteps; ++s) {
      float4 wv[RL];
#pragma unroll
      for (int r = 0; r < RL; ++r) wv[r] = Vec4<T>::up(w[r][s]);
#pragma unroll
      for (int b = 0; b < QP; ++b) {
        // the 8 column groups read 128 contiguous bytes, which the 4 row
        // groups of the warp share; each float feeds RL rows
        const float4 x =
            *reinterpret_cast<const float4*>(xt + b * S::kTile + s * kStep);
#pragma unroll
        for (int r = 0; r < RL; ++r) {
          float a = acc[r][b];
          a = fmaf(wv[r].x, x.x, a);
          a = fmaf(wv[r].y, x.y, a);
          a = fmaf(wv[r].z, x.z, a);
          a = fmaf(wv[r].w, x.w, a);
          acc[r][b] = a;
        }
      }
    }
    // the buffer just read is refilled by the next iteration's stage
    __syncthreads();
    if (t + 1 < n_tiles) {
#pragma unroll
      for (int r = 0; r < RL; ++r)
#pragma unroll
        for (int s = 0; s < S::kSteps; ++s) w[r][s] = w_next[r][s];
    }
  }

  // fixed butterfly over the 8 lanes of a row: each ends with the same sum
#pragma unroll
  for (int r = 0; r < RL; ++r) {
#pragma unroll
    for (int b = 0; b < QP; ++b) {
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        acc[r][b] += __shfl_xor_sync(0xffffffffu, acc[r][b], off);
    }
  }
  // column group (b mod 8) writes query b
#pragma unroll
  for (int r = 0; r < RL; ++r) {
#pragma unroll
    for (int b = 0; b < QP; ++b) {
      if ((lane & 7) == (b & 7) && row_ok[r] && q0 + b < B)
        Y[static_cast<size_t>(q0 + b) * N + row0 + 4 * r] = acc[r][b];
    }
  }
}

template <typename T, int QP>
cudaError_t launch_qp(const void* W, const float* X, float* Y, int N, int M,
                      int B, cudaStream_t stream) {
  using S = Shape<QP>;
  if (S::kSmemBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        streaming_matvec_kernel<T, QP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + S::kRows - 1) / S::kRows, (B + QP - 1) / QP);
  streaming_matvec_kernel<T, QP><<<grid, kThreads, S::kSmemBytes, stream>>>(
      static_cast<const T*>(W), X, Y, N, M, B);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* W, const float* X, float* Y, int N,
                         int M, int B, cudaStream_t s) {
  if (B <= 1) return launch_qp<T, 1>(W, X, Y, N, M, B, s);
  if (B <= 2) return launch_qp<T, 2>(W, X, Y, N, M, B, s);
  if (B <= 4) return launch_qp<T, 4>(W, X, Y, N, M, B, s);
  if (B <= 8) return launch_qp<T, 8>(W, X, Y, N, M, B, s);
  if (B <= 16) return launch_qp<T, 16>(W, X, Y, N, M, B, s);
  if (B <= 32) return launch_qp<T, 32>(W, X, Y, N, M, B, s);
  return launch_qp<T, kMaxQueries>(W, X, Y, N, M, B, s);
}

}  // namespace

extern "C" {

// Storage type codes: 0 float32, 1 bfloat16, 2 float16, 3 int8.
// W: (N, M) row-major, M a multiple of 4, aligned to 4 elements;
// X: (B, M) float32 row-major, 16-byte aligned; Y: (B, N) float32,
// written whole.
// B > 64 takes one pass over W per group of 64 queries.  Returns the
// cudaError_t of the launch (0 on success).
int streaming_matvec_launch(int dtype, const void* W, const void* X, void* Y,
                            int N, int M, int B, void* stream) {
  if (N <= 0 || M <= 0 || B <= 0 || M % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(X);
  float* yf = static_cast<float*>(Y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_typed<float>(W, xf, yf, N, M, B, s));
    case 1:
      return static_cast<int>(
          launch_typed<__nv_bfloat16>(W, xf, yf, N, M, B, s));
    case 2:
      return static_cast<int>(launch_typed<__half>(W, xf, yf, N, M, B, s));
    case 3:
      return static_cast<int>(launch_typed<int8_t>(W, xf, yf, N, M, B, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
