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
// kernel's own function (the bsr tier's run, run_tol and push sweeps); a
// batch serves its personalized PageRank (B = 8 in the serve mix) and the
// landmark hub build (B = 64) with one launch per iteration or sweep.
// int8 row scales are applied by the callers, as on the TPU.
//
// Bound.  A launch must read every stored block once (nb_r * mb * bs^2 *
// 1..4 bytes), block_cols and X, and write Y; it does 2 * B * nb_r * mb *
// bs^2 float32 operations.  On the 5000-protein network at bs = 128 the
// layout is 40 x 40 blocks, 1557 of them not padding (102 MB in f32, 31 us
// at the data-sheet 3.35 TB/s).  B = 1 and B = 8 are bound by the bytes of
// the blocks (their operations take 1 and 6 us at the data-sheet 67
// TFLOP/s outside the tensor cores); B = 64 by float32 operations (49 us).
// What holds each B above its bound on the card (PERF.md has the times):
// at B <= 8 the wait for each slot's copies, since a CTA walks the 40
// slots of its block row one after another (bf16 and int8, with a half
// and a quarter of the bytes, gain far less than that over f32); at
// B = 64 the instructions each warp executes, with 3 CTAs of 4 warps per SM
// (set by registers and shared memory) to hide the latencies; there the
// reduced types are a few per cent slower than f32, since every block
// value a warp multiplies is upcast in its inner loop (upcasting once per
// CTA into a float32 copy in shared memory was slower still).
//
// Design.  The TPU walks its (block row, slot) grid in order and
// accumulates into a resident output block.  Here a CTA owns a tile of RC
// rows of one block row and QC queries, and walks the block row's slots
// itself, in slot order:
//   * Staging.  For each slot the CTA copies the slot's x block for its
//     queries (QC x bs floats) and its rows of the slot's block (RC x bs at
//     the storage type) into shared memory with 16-, 8- or 4-byte cp.async,
//     in a ring of ST stages: the next ST - 1 slots are in flight while one
//     is summed.  The slot's block column (one address for the CTA) is
//     loaded a slot ahead.  A block wider than 128 columns is staged 128
//     columns at a time, in column order.  The copies' shared addresses and
//     row offsets do not change from slot to slot, so each copy costs a
//     few instructions (recomputed per copy, they were about a third of a
//     warp's instructions at B = 64, and a quarter of its time).
//   * The batch is predicated, not branched on: queries past B are
//     zero-filled by the copy (source size 0) and summed like the others,
//     so the query loop has a compile-time trip count; only the store is
//     masked, and a warp whose queries all lie past B skips its sums.
//   * Register tile.  A warp covers 4 row groups x 32 columns per step:
//     lane = (row group lane >> 3, column group lane & 7), each lane 4
//     consecutive columns of RL rows (r, r + 4, ...) for QW queries, RL x
//     QW sums in registers.  One float4 of X read from shared memory feeds
//     4 RL FMAs, and the 4 row groups read the same 128 bytes of it; the
//     WQ warps that split the queries read the same block values.  Those
//     are kept as raw bits in shared memory and upcast where they are used
//     (int8 with byte permutes); a block row's pitch is padded so the 2 or
//     4 rows one load of bf16 / int8 touches fall on different banks.
//   * Tile per batch size (QP = the next power of two of B, at most 64),
//     chosen on the card among candidates that scripts/k3_tile_sweep.py
//     builds from this source and times (PERF.md):
//         QP   RL QW WR WQ ST   RC QC  warps  CTAs at 40 block rows
//         1     1  1  2  1  4    8  1    2    640
//         2     1  2  2  1  4    8  2    2    640
//         4     1  4  2  1  4    8  4    2    640
//         8     2  4  2  2  4   16  8    4    320
//         16    4  4  1  4  4   16 16    4    320
//         32    4  8  1  4  3   16 32    4    320
//         64    8  8  1  4  2   32 32    4    320 (2 query groups)
//     Small batches take small row tiles, so more CTAs wait on their
//     copies at once; from 16 queries on, 4 warps split the queries and
//     share each block value; at 64 the 8 x 8 tile (256 FMAs per 16 loads
//     from shared memory) still fits 3 CTAs per SM.  More queries than QC
//     are split into groups along the grid's y axis, each a pass over the
//     blocks.
//   * Padded slots are accumulated, not skipped: their blocks are zero and
//     point at block column 0, so a NaN in x block 0 propagates as on the
//     TPU.
//   * Summation order, the same in every tile: a lane sums each of its
//     products in slot order, then 32-column step order, then the 4
//     columns of its group in order, one fmaf each (the tile only changes
//     which independent sums sit side by side); then the 8 lanes of a row
//     are summed with a fixed butterfly (xor 1, 2, 4).  No atomics: a
//     repeated call gives the same bits, and a query's result does not
//     depend on what else shares its batch, nor on the tile its batch size
//     picks.  It is the order of the kernel this one replaced, whose bits
//     it gives.
//   * No tensor cores yet.  One TF32 product keeps about 3 decimal digits,
//     outside the rtol 1e-5 / atol 1e-9 this kernel is held to against its
//     plain version; a 3 x TF32 split would change the summation order
//     that batch independence rests on.  At B = 64 the CUDA cores' float32
//     bound (49 us) is still 2.6 x under this kernel's time.
// bs must be a multiple of 4, blocks aligned to 4 elements and X to
// 16 bytes (the wrapper checks; every layout of the engine is).

#include "vec4.cuh"

namespace {

constexpr int kStep = 32;   // columns a warp covers per step
constexpr int kTile = 128;  // columns of a block per staged unit
constexpr int kSteps = kTile / kStep;

// asynchronous copy of N bytes global -> shared (dst: a shared-space
// address); zero-fills when !pred, reading nothing
template <int N>
__device__ __forceinline__ void cp_async(unsigned dst, const void* gmem,
                                         bool pred) {
  const int n = pred ? N : 0;
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst),
                 "l"(gmem), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     dst),
                 "l"(gmem), "n"(N), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N groups (the newest) are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A CTA's tile: RL rows x QW queries per lane, WR x WQ warps across rows x
// queries, ST stages.
template <int RL_, int QW_, int WR_, int WQ_, int ST_>
struct Tile {
  static constexpr int RL = RL_, QW = QW_, WR = WR_, WQ = WQ_, ST = ST_;
  static constexpr int kWarps = WR * WQ;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 4 * RL * WR;  // RC: rows of a block row
  static constexpr int kQueries = QW * WQ;   // QC: queries per CTA
};

// Shared-memory layout of one stage: X [QC][xp] float32, then the block
// rows [RC][wp] at the storage type.  xp is the staged width rounded up
// to whole steps; wp is at least xp, with wp * sizeof(T) equal
// to 32 * sizeof(T) modulo 128 bytes, so the rows that one load of 8-byte
// (bf16, f16) or 4-byte (int8) vectors touches use different banks.
struct Layout {
  int xp, wp, stage_bytes;
};

template <typename T>
Layout layout_for(int bs, int rows, int queries) {
  Layout l;
  l.xp = ((bs < kTile ? bs : kTile) + kStep - 1) / kStep * kStep;
  const int period = 128 / static_cast<int>(sizeof(T));  // elements
  l.wp = l.xp + (((kStep - l.xp) % period) + period) % period;
  const int bytes = 4 * queries * l.xp + static_cast<int>(sizeof(T)) *
                                             rows * l.wp;
  l.stage_bytes = (bytes + 15) / 16 * 16;
  return l;
}

// The launch bounds state the minimum of 1 CTA per SM: with the thread
// count alone, ptxas held the 64-query tile to 128 registers, and bf16 and
// f16 spilled (about 8 % slower on the card).
template <typename T, typename S>
__global__ void __launch_bounds__(S::kThreads, 1)
bsr_spmv_kernel(const T* __restrict__ blocks, const int* __restrict__ cols,
                const float* __restrict__ X, float* __restrict__ Y, int mb,
                int bs, int Mp, int Np, int B, int ctas_per_brow, int xp,
                int wp, int stage_bytes) {
  using Raw = typename Vec4<T>::Raw;
  constexpr int RL = S::RL, QW = S::QW, WR = S::WR, ST = S::ST;
  constexpr int kW = S::kWarps;
  constexpr int RC = S::kRows;
  constexpr int QC = S::kQueries;
  constexpr int kVecBytes = static_cast<int>(sizeof(Raw));
  constexpr unsigned kTBytes = sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = (lane & 7) * 4;  // this lane's columns within a step
  const int wr = warp % WR;        // the warp's row tile
  const int wq = warp / WR;        // the warp's query tile
  const int br = blockIdx.x / ctas_per_brow;
  const int row_cta = (blockIdx.x % ctas_per_brow) * RC;  // in the block row
  // this lane's rows within the CTA's tile: rl, rl + 4, ...
  const int rl = wr * 4 * RL + (lane >> 3);
  const int q0 = blockIdx.y * QC;
  const int nq = min(QC, B - q0);
  const bool warp_live = wq * QW < nq;
  const int* brow_cols = cols + static_cast<size_t>(br) * mb;
  // The copies: warp w copies rows w, w + kW, ..., a lane one 4-element
  // vector of each (columns cv .. cv + 3); xsrc / wsrc are this lane's
  // vector of X row q0 and of block row row_cta in slot 0, and a row past
  // the batch or the block reads row 0 instead (the copy reads nothing
  // there and zero-fills).
  constexpr int kXCopies = (QC + kW - 1) / kW;
  constexpr int kWCopies = (RC + kW - 1) / kW;
  const int cv = 4 * lane;
  const float* xsrc = X + static_cast<size_t>(q0) * Mp + cv;
  const T* wsrc =
      blocks + (static_cast<size_t>(br) * mb * bs + row_cta) * bs + cv;
  const unsigned smem_sa =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));

  // Copy a unit (128 columns of one slot from column s_c0, block column
  // bcol) into stage buffer buf.  Units are staged in slot order, then
  // column order; s_slot / s_c0 name the next one.
  int s_slot = 0, s_c0 = 0;
  auto stage_next = [&](int bcol, int buf) {
    const bool lane_ok = cv < min(kTile, bs - s_c0);
    const unsigned xs = smem_sa + buf * stage_bytes + 4 * (warp * xp + cv);
    const unsigned ws = smem_sa + buf * stage_bytes + 4 * QC * xp +
                        kTBytes * (warp * wp + cv);
    const float* xg = xsrc + static_cast<size_t>(bcol) * bs + s_c0;
    const T* wg = wsrc + static_cast<size_t>(s_slot) * bs * bs + s_c0;
    if (lane_ok) {
#pragma unroll
      for (int j = 0; j < kXCopies; ++j) {
        const int q = warp + j * kW;
        if (QC % kW == 0 || q < QC)
          cp_async<16>(xs + 4 * j * kW * xp,
                       xg + static_cast<size_t>(q < nq ? q : 0) * Mp,
                       q < nq);
      }
#pragma unroll
      for (int j = 0; j < kWCopies; ++j) {
        const int r = warp + j * kW;
        const bool ok = row_cta + r < bs;
        if (RC % kW == 0 || r < RC)
          cp_async<kVecBytes>(ws + kTBytes * j * kW * wp,
                              wg + static_cast<size_t>(ok ? r : 0) * bs, ok);
      }
    }
    s_c0 += kTile;
    if (s_c0 >= bs) {
      s_c0 = 0;
      ++s_slot;
    }
  };

  float acc[RL][QW];
#pragma unroll
  for (int r = 0; r < RL; ++r)
#pragma unroll
    for (int b = 0; b < QW; ++b) acc[r][b] = 0.f;

  // the ring: the first ST - 1 units in flight before the first sum
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (s_slot < mb) stage_next(__ldg(brow_cols + s_slot), i);
    cp_async_commit();
  }
  // the block column of the next unit to stage, loaded a unit ahead
  int bcol_next = s_slot < mb ? __ldg(brow_cols + s_slot) : 0;

  int buf = 0;  // the stage buffer of the unit being summed
  for (int slot = 0; slot < mb; ++slot) {
    for (int c0 = 0; c0 < bs; c0 += kTile) {
      cp_async_wait<ST - 2>();
      __syncthreads();  // this unit is in; every warp is done with the last
      if (s_slot < mb) stage_next(bcol_next, buf == 0 ? ST - 1 : buf - 1);
      cp_async_commit();
      if (s_slot < mb) bcol_next = __ldg(brow_cols + s_slot);
      if (warp_live) {
        const int kw = min(kTile, bs - c0);
        const unsigned char* base = smem + buf * stage_bytes;
        const float* xs =
            reinterpret_cast<const float*>(base) + wq * QW * xp + col;
        const T* ws = reinterpret_cast<const T*>(base + 4 * QC * xp) +
                      rl * wp + col;
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          if (s * kStep + col >= kw) break;  // a ragged tile's dead columns
          float4 wv[RL];
#pragma unroll
          for (int r = 0; r < RL; ++r)
            wv[r] = Vec4<T>::up(
                *reinterpret_cast<const Raw*>(ws + 4 * r * wp + s * kStep));
#pragma unroll
          for (int b = 0; b < QW; ++b) {
            const float4 x =
                *reinterpret_cast<const float4*>(xs + b * xp + s * kStep);
            // each sum takes its 4 columns in order; the RL rows'
            // sums are independent and interleaved
#pragma unroll
            for (int r = 0; r < RL; ++r)
              acc[r][b] = fmaf(wv[r].x, x.x, acc[r][b]);
#pragma unroll
            for (int r = 0; r < RL; ++r)
              acc[r][b] = fmaf(wv[r].y, x.y, acc[r][b]);
#pragma unroll
            for (int r = 0; r < RL; ++r)
              acc[r][b] = fmaf(wv[r].z, x.z, acc[r][b]);
#pragma unroll
            for (int r = 0; r < RL; ++r)
              acc[r][b] = fmaf(wv[r].w, x.w, acc[r][b]);
          }
        }
      }
      buf = buf + 1 == ST ? 0 : buf + 1;
    }
  }
  cp_async_wait<0>();
  if (!warp_live) return;

  // fixed butterfly over the 8 lanes of a row: each ends with the same sum
#pragma unroll
  for (int r = 0; r < RL; ++r) {
#pragma unroll
    for (int b = 0; b < QW; ++b) {
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        acc[r][b] += __shfl_xor_sync(0xffffffffu, acc[r][b], off);
    }
  }
  // column group (b mod 8) writes query b
  const size_t y0 = static_cast<size_t>(br) * bs + row_cta + rl;
#pragma unroll
  for (int r = 0; r < RL; ++r) {
#pragma unroll
    for (int b = 0; b < QW; ++b) {
      const int q = wq * QW + b;
      if ((lane & 7) == (b & 7) && row_cta + rl + 4 * r < bs && q < nq)
        Y[static_cast<size_t>(q0 + q) * Np + y0 + 4 * r] = acc[r][b];
    }
  }
}

template <typename T, typename S>
cudaError_t launch_tile(const void* blocks, const int* cols, const float* X,
                        float* Y, int nb_r, int mb, int bs, int Mp, int B,
                        cudaStream_t stream) {
  const Layout l = layout_for<T>(bs, S::kRows, S::kQueries);
  const int smem = S::ST * l.stage_bytes;
  auto kernel = bsr_spmv_kernel<T, S>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int ctas_per_brow = (bs + S::kRows - 1) / S::kRows;
  const dim3 grid(nb_r * ctas_per_brow,
                  (B + S::kQueries - 1) / S::kQueries);
  kernel<<<grid, S::kThreads, smem, stream>>>(
      static_cast<const T*>(blocks), cols, X, Y, mb, bs, Mp, nb_r * bs, B,
      ctas_per_brow, l.xp, l.wp, l.stage_bytes);
  return cudaGetLastError();
}

// The tile of each batch size (the table in the note above), as F<Tile>.
template <typename F>
auto with_tile(int B, F&& f) {
  if (B <= 1) return f(Tile<1, 1, 2, 1, 4>{});
  if (B <= 2) return f(Tile<1, 2, 2, 1, 4>{});
  if (B <= 4) return f(Tile<1, 4, 2, 1, 4>{});
  if (B <= 8) return f(Tile<2, 4, 2, 2, 4>{});
  if (B <= 16) return f(Tile<4, 4, 1, 4, 4>{});
  if (B <= 32) return f(Tile<4, 8, 1, 4, 3>{});
  return f(Tile<8, 8, 1, 4, 2>{});
}

template <typename T>
cudaError_t launch_typed(const void* blocks, const int* cols, const float* X,
                         float* Y, int nb_r, int mb, int bs, int Mp, int B,
                         cudaStream_t s) {
  return with_tile(B, [&](auto tile) {
    return launch_tile<T, decltype(tile)>(blocks, cols, X, Y, nb_r, mb, bs,
                                          Mp, B, s);
  });
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

// The tile the launch of a batch of B queries takes: RL, QW, WR, WQ, ST,
// then the rows and queries per CTA and its threads, into out[0 .. 7].
// For reports; returns 0.
int bsr_spmv_tile(int B, int* out) {
  return with_tile(B, [&](auto tile) {
    using S = decltype(tile);
    const int v[] = {S::RL,    S::QW,       S::WR,       S::WQ,
                     S::ST,    S::kRows,    S::kQueries, S::kThreads};
    for (int i = 0; i < 8; ++i) out[i] = v[i];
    return 0;
  });
}

}  // extern "C"
