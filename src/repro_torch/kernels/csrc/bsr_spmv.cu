// Block-sparse-row SpMV for Hopper (sm_90a), batched over queries.
//
// Replaces the TPU kernel src/repro/kernels/bsr_spmv.py::_kernel (reached
// through bsr_spmv).  For blocks (nb_r, mb, bs, bs) stored as float32,
// bfloat16, float16 or int8, block_cols (nb_r, mb) int32 and X (B, Mp)
// float32 (Mp = nb_c * bs, one query per row) it computes
//
//     Y[q, br * bs + i] = sum_slot sum_j blocks[br, slot, i, j]
//                                    * X[q, block_cols[br, slot] * bs + j]
//
// into Y (B, nb_r * bs) float32, accumulating in float32.  B = 1 is the TPU
// kernel's own function; a batch serves the bsr tier's personalized
// PageRank and landmark push with one launch per iteration or sweep.
// int8 row scales are applied by the callers, as on the TPU.
//
// Layout of X.  Queries are rows (B, Mp), as in the streaming matvec: the
// 8 lanes that cover 32 columns of a block read 128 contiguous bytes of a
// query's x block, a single coalesced request, and every query's block is
// a contiguous run that a 16-byte load can take.  With queries as columns
// (Mp, B) the 4 consecutive columns a lane owns would sit B floats apart.
//
// Bound.  A launch must read every stored block once (nb_r * mb * bs^2 *
// 1..4 bytes), block_cols and X, and write Y; it does 2 * B * nb_r * mb *
// bs^2 float32 operations.  On the 5000-protein network at bs = 128 the
// layout is 40 x 40 blocks, as many bytes as the dense 5120^2 layout
// (105 MB in f32, 31 us at the data-sheet 3.35 TB/s), so at small B it is
// bound by the bytes of the blocks, at B = 64 by float32 operations
// (50 us at the data-sheet 67 TFLOP/s outside the tensor cores).
//
// Design (a simple kernel, right first; its times are in PERF.md):
//   * The TPU walks its (block-row, slot) grid in order and accumulates
//     into a resident output block.  Here a CTA of 2 warps owns 8 rows of
//     one block row (16 from 16 queries on) and walks the mb slots itself,
//     in slot order: at bs = 128 that is 16 CTAs per block row, 640 on the
//     40 block rows of the paper's network, so the 132 SMs all get work.
//   * The TPU scalar-prefetches block_cols to steer the gather of x; here
//     every lane reads the slot's block column from global memory (one
//     address for the whole CTA, an L1 hit after the first).
//   * A warp covers 4 rows x 32 columns per step: lane = (row group
//     lane >> 3, column group lane & 7), each lane 4 consecutive columns
//     (one 16-, 8- or 4-byte load of the block by type, upcast in
//     registers; int8 with byte permutes), used for every query of the
//     batch.  The 4 row groups read the same x addresses, so a float4 of X
//     costs one L1 wavefront for 4 rows.  Steps are loaded 4 at a time
//     before they are summed, to keep loads in flight.
//   * Padded slots are accumulated, not skipped: their blocks are zero and
//     point at block column 0, so a NaN in x block 0 propagates as on the
//     TPU.
//   * Queries are padded to QP, the next power of two of B (at most 64), a
//     compile-time tile of register sums; a larger B is split into groups
//     of 64 along the grid's y axis, each a pass over the blocks.
//   * No atomics: every lane sums its columns in slot and column order,
//     then the 8 lanes of a row are summed with a fixed butterfly, so a
//     repeated call gives the same bits, and a query's result does not
//     depend on what else shares its batch.
// bs must be a multiple of 4, blocks aligned to 4 elements and X to
// 16 bytes (the wrapper checks; every layout of the engine is).

#include "vec4.cuh"

namespace {

constexpr int kMaxQueries = 64;
constexpr int kStep = 32;      // columns a warp covers per step
constexpr int kThreads = 64;   // 2 warps per CTA
constexpr int kDepth = 4;      // steps loaded before they are summed

template <int QP>
struct Shape {
  // rows per lane: 2 from QP = 16 on (rows r and r + 4 of its warp), so
  // each float of X feeds both
  static constexpr int kRowsPerLane = QP >= 16 ? 2 : 1;
  static constexpr int kRowsPerWarp = 4 * kRowsPerLane;
  static constexpr int kRows = kThreads / 32 * kRowsPerWarp;  // per CTA
};

template <typename T, int QP>
__global__ void __launch_bounds__(kThreads)
bsr_spmv_kernel(const T* __restrict__ blocks, const int* __restrict__ cols,
                const float* __restrict__ X, float* __restrict__ Y, int mb,
                int bs, int Mp, int Np, int B, int ctas_per_brow) {
  using S = Shape<QP>;
  using Raw = typename Vec4<T>::Raw;
  constexpr int RL = S::kRowsPerLane;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = (lane & 7) * 4;  // this lane's columns within a step
  const int br = blockIdx.x / ctas_per_brow;
  // this lane's rows within the block row: r0, r0 + 4, ...
  const int r0 = (blockIdx.x % ctas_per_brow) * S::kRows +
                 warp * S::kRowsPerWarp + (lane >> 3);
  bool row_ok[RL];
  int row[RL];
#pragma unroll
  for (int r = 0; r < RL; ++r) {
    row[r] = r0 + 4 * r;
    row_ok[r] = row[r] < bs;
  }
  const int q0 = blockIdx.y * QP;
  const int nq = min(QP, B - q0);
  const int* brow_cols = cols + static_cast<size_t>(br) * mb;
  const T* brow_blocks = blocks + static_cast<size_t>(br) * mb * bs * bs;
  const float* xq = X + static_cast<size_t>(q0) * Mp;
  const int n_steps = (bs + kStep - 1) / kStep;  // per block
  const int n_total = mb * n_steps;              // over the block row

  float acc[RL][QP];
#pragma unroll
  for (int r = 0; r < RL; ++r)
#pragma unroll
    for (int b = 0; b < QP; ++b) acc[r][b] = 0.f;

  for (int t0 = 0; t0 < n_total; t0 += kDepth) {
    // load kDepth steps of this lane's block values (raw bits) ...
    Raw w[kDepth][RL];
    int xoff[kDepth];
    bool live[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int t = t0 + u;
      const int slot = t / n_steps;
      const int c = (t - slot * n_steps) * kStep + col;
      live[u] = t < n_total && c < bs;
      xoff[u] = live[u] ? __ldg(brow_cols + slot) * bs + c : 0;
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        w[u][r] = (live[u] && row_ok[r])
                      ? Vec4<T>::load(brow_blocks +
                                      (static_cast<size_t>(slot) * bs +
                                       row[r]) * bs + c)
                      : Raw{};
      }
    }
    // ... then sum them, in step order, for every query
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      if (!live[u]) continue;
      float4 wv[RL];
#pragma unroll
      for (int r = 0; r < RL; ++r) wv[r] = Vec4<T>::up(w[u][r]);
#pragma unroll
      for (int b = 0; b < QP; ++b) {
        if (b >= nq) break;
        const float4 x = __ldg(reinterpret_cast<const float4*>(
            xq + static_cast<size_t>(b) * Mp + xoff[u]));
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
      if ((lane & 7) == (b & 7) && row_ok[r] && b < nq)
        Y[static_cast<size_t>(q0 + b) * Np + static_cast<size_t>(br) * bs +
          row[r]] = acc[r][b];
    }
  }
}

template <typename T, int QP>
cudaError_t launch_qp(const void* blocks, const int* cols, const float* X,
                      float* Y, int nb_r, int mb, int bs, int Mp, int B,
                      cudaStream_t stream) {
  using S = Shape<QP>;
  const int ctas_per_brow = (bs + S::kRows - 1) / S::kRows;
  const dim3 grid(nb_r * ctas_per_brow, (B + QP - 1) / QP);
  bsr_spmv_kernel<T, QP><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(blocks), cols, X, Y, mb, bs, Mp, nb_r * bs, B,
      ctas_per_brow);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* blocks, const int* cols, const float* X,
                         float* Y, int nb_r, int mb, int bs, int Mp, int B,
                         cudaStream_t s) {
#define REPRO_BSR_QP(QP) \
  launch_qp<T, QP>(blocks, cols, X, Y, nb_r, mb, bs, Mp, B, s)
  if (B <= 1) return REPRO_BSR_QP(1);
  if (B <= 2) return REPRO_BSR_QP(2);
  if (B <= 4) return REPRO_BSR_QP(4);
  if (B <= 8) return REPRO_BSR_QP(8);
  if (B <= 16) return REPRO_BSR_QP(16);
  if (B <= 32) return REPRO_BSR_QP(32);
  return REPRO_BSR_QP(kMaxQueries);
#undef REPRO_BSR_QP
}

}  // namespace

extern "C" {

// Storage type codes: 0 float32, 1 bfloat16, 2 float16, 3 int8.
// blocks: (nb_r, mb, bs, bs) row-major, aligned to 4 elements, bs a
// multiple of 4; cols: (nb_r, mb) int32, every entry < Mp / bs;
// X: (B, Mp) float32 row-major, 16-byte aligned, Mp a multiple of bs;
// Y: (B, nb_r * bs) float32, written whole.  Returns the cudaError_t of
// the launch (0 on success).
int bsr_spmv_launch(int dtype, const void* blocks, const void* cols,
                    const void* X, void* Y, int nb_r, int mb, int bs, int Mp,
                    int B, void* stream) {
  if (nb_r <= 0 || mb <= 0 || bs <= 0 || bs % 4 != 0 || Mp <= 0 ||
      Mp % bs != 0 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* c = static_cast<const int*>(cols);
  const float* xf = static_cast<const float*>(X);
  float* yf = static_cast<float*>(Y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch_typed<float>(blocks, c, xf, yf, nb_r, mb, bs, Mp, B, s));
    case 1:
      return static_cast<int>(launch_typed<__nv_bfloat16>(
          blocks, c, xf, yf, nb_r, mb, bs, Mp, B, s));
    case 2:
      return static_cast<int>(
          launch_typed<__half>(blocks, c, xf, yf, nb_r, mb, bs, Mp, B, s));
    case 3:
      return static_cast<int>(
          launch_typed<int8_t>(blocks, c, xf, yf, nb_r, mb, bs, Mp, B, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
