// Weight-streaming batched matrix-vector product for Hopper (sm_90a), on
// the tensor cores with a split-TF32 product.
//
// Replaces the TPU kernel src/repro/kernels/streaming_matvec.py::_kernel
// (reached through streaming_matvec).  For W (N, M) stored as float32,
// bfloat16, float16 or int8 and X (B, M) float32 it computes
//
//     Y[b, i] = sum_j X[b, j] * float(W[i, j])          Y: (B, N) float32
//
// to float32 accuracy.  int8 row scales are applied by the callers, as on
// the TPU.  In batched personalized PageRank W is the padded transition
// matrix and the B queries share every sweep over it.
//
// Bound.  Per launch the card must read W once (N * M * 1..4 bytes) and X,
// and write Y.  At N = M = 5120 W is 105 MB in float32 (31 us at the
// data-sheet 3.35 TB/s), 52 MB in bf16 / f16 and 26 MB in int8.  The
// products run on the TF32 tensor cores (495 TFLOP/s dense, data sheet),
// 3 of them per float32 term and 2 per term of the reduced types (below):
// at B = 64 that is 20 us for float32 W and 14 us for the others, so by
// the data sheet every batch size is bound by the bytes of W.  On the card
// mma.sync takes TF32 products at about a quarter of that rate, so B = 64
// is held by the tensor cores' issue of mma.sync (PERF.md).
//
// Why tensor cores, and why split.  The CUDA cores' float32 rate (67
// TFLOP/s) puts the B = 64 product at 50 us at best; the FFMA kernel this
// one replaced took 210 us there.  One TF32 product keeps about 3 decimal
// digits, outside the rtol 1e-5 this kernel is held to against its plain
// version.  So each float32 operand is split into a TF32 "big" part
// (cvt.rna) and the remainder ("small", which the tensor core truncates to
// TF32):
//     x * w ~= xs * wb + xb * ws + xb * wb          (xs * ws is dropped)
// bf16, f16 and int8 values are exact in TF32, so there only X is split:
//     x * w  = xs * w + xb * w                       (up to xs's truncation)
// The tensor core's adds inside a chained accumulator lose accuracy over a
// long chain (about 6e-5 relative after 640 chained k-steps on the card;
// tests/test_torch_split.py models it), so the mma accumulator restarts
// from zero after every kRestart k-steps of 8 columns and is added into a
// float32 register sum with a plain FADD (about 1e-6 relative; PERF.md has
// the card's figures).
//
// Design.  Y^T = W X^T as m16n8k8 TF32 mma.sync tiles: 16 rows of W on the
// mma's M side, 8 queries on its N side (queries padded with zeros to a
// multiple of 8: QP = 8, 16, 32 or 64 per CTA, more along the grid's y).
//   * A CTA owns kRows = 16 * MT * WR rows of W and one of kSplits = 8
//     column ranges: the 8 CTAs of a row block form a thread block cluster
//     and each sums its range of 32-column groups.  The row block's outputs
//     are cut into 8 slices; the CTA that owns a slice adds the 8 partial
//     sums in rank order, read from the others' shared memory (distributed
//     shared memory) between two cluster barriers.  Splitting the columns
//     gives enough CTAs at N = 5120 (40 or 80 row blocks x 8, all resident
//     at once) while each reads its row block's share of X from L2 once.
//   * W streams through a cp.async ring of ST stages of KG 32-column groups
//     each (4-element copies: 16, 8 or 4 bytes by type, so any M that is a
//     multiple of 4 works).  The copies' shared addresses and source rows
//     are computed once per thread; rows past N and columns past the CTA's
//     range are zero-filled.  Stage rows of 128 bytes have their
//     16-byte chunks permuted by row (an XOR swizzle) so that the fragment
//     loads are free of bank conflicts; shorter rows need none.
//   * X goes to registers a stage ahead, is split once per CTA into a
//     double-buffered Xb | Xs tile in shared memory (row pitch padded so the
//     16-byte fragment loads are free of bank conflicts), and read from
//     there as fragments.  A warp splits (float32) or upcasts its W
//     fragments once per group and multiplies each by its queries (WQ warps
//     split a CTA's queries and share its W rows), issuing each product for
//     all its (m-tile, n-tile) pairs before the next, so that consecutive
//     mma instructions feed independent accumulators.
//   * Column order.  Inside a group, k-step s takes columns 8t + 2s
//     (k = t) and 8t + 2s + 1 (k = t + 4), t = 0..3, so a lane's 8 columns
//     of a row are contiguous; the same permutation is applied to W and X.
//     Per (row, query): for each group in order, the 3 (or 2) products of
//     each k-step in the order xs*wb, xb*ws, xb*wb (xs*w, xb*w), chained
//     from zero through kRestart = 4 k-steps and then added into the running
//     sum with one FADD; the 8 range partials are added in rank order.
//     None of it depends on B, QP or the tile (only kSplits and kRestart,
//     which every configuration shares), so a query's result is the same
//     bits alone or in a batch of any size, and no atomics are used, so a
//     repeated call gives the same bits.  A NaN in one query's X reaches
//     only that query's outputs.
// N is any size; M must be a multiple of 4, W aligned to 4 elements and X
// to 16 bytes (the wrapper pads M otherwise; every layout of the engine
// already is).

#include <cooperative_groups.h>

#include <type_traits>

#include "vec4.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxQueries = 64;
constexpr int kGroup = 32;  // columns per group: 4 k-steps of 8

// The summation order, which every configuration shares, so that a query's
// bits depend on neither the storage type's tile nor the batch size: the
// columns are split into kSplits ranges (the cluster size), and the mma
// accumulator restarts after every kRestart k-steps.  The library is built
// with these values; scripts/k2_tile_sweep.py --probe builds the source
// with others (K2_SPLITS, K2_RESTART; a restart of 0 chains the
// accumulator through a CTA's range) to measure the split's error.
#ifndef K2_SPLITS
#define K2_SPLITS 8
#endif
#ifndef K2_RESTART
#define K2_RESTART 4
#endif
constexpr int kSplits = K2_SPLITS, kRestart = K2_RESTART;
static_assert(kRestart == 0 || kGroup / 8 % kRestart == 0,
              "the restart divides a group");
constexpr int kRestartEvery = kRestart > 0 ? kRestart : 1;  // a divisor

// A launch's tile: MT m-tiles of 16 rows per warp, WR x WQ warps (WR
// across rows, WQ splitting the queries), ST ring stages of KG groups
// each, PF 1 to have each copy of W bring 256 bytes into L2 (the rest of
// the row's segment is the next stage's).
template <int MT_, int WR_, int WQ_, int ST_, int KG_, int PF_>
struct Cfg {
  static constexpr int MT = MT_, WR = WR_, WQ = WQ_, ST = ST_, KG = KG_;
  static constexpr int PF = PF_;
  static constexpr int kThreads = 32 * WR * WQ;
  static constexpr int kRows = 16 * MT * WR;
  static constexpr int kChunks = 8 * KG;  // 4-element chunks of a stage row
  static_assert(kThreads % kChunks == 0 &&
                    kRows % (kThreads / kChunks) == 0,
                "uneven W copies");
};

// The configuration of each storage type and batch size (QP queries per
// CTA), the fastest or within noise of it in scripts/k2_tile_sweep.py on
// the card (PERF.md): up to 16 queries 128-row CTAs of 4 warps with 16-kB
// stages (KG groups fill a 128-byte stage row; 3 stages, 2 for int8; the
// 256-byte L2 fetch for float32, which streams W there), at 32 the same
// with KG = 1, at 64 64-row CTAs of 2 x 2 warps (each warp 32 of the
// queries), so that 3 CTAs fit on an SM.
template <typename T, int QP>
struct Chosen {
  static constexpr int kKG = 4 / static_cast<int>(sizeof(T));
  using type = std::conditional_t<
      QP <= 16,
      Cfg<2, 4, 1, kKG == 4 ? 2 : 3, kKG, kKG == 1>,
      std::conditional_t<QP == 32, Cfg<2, 4, 1, 3, 1, 0>,
                         Cfg<2, 2, 2, 3, 1, 0>>>;
};

// Shared memory of one launch: the W ring (ST stages of kRows rows of KG
// groups, rows unpadded: 32, 64 or 128 bytes), then two split X tiles (per
// query: for each group Xb[32] | Xs[32], then 4 floats of padding); at the
// end the partial sums (QP x kRows, pitch kRows + 4) reuse the space.
template <typename T, int QP, typename C>
struct Layout {
  static constexpr int kRowBytes =
      C::KG * kGroup * static_cast<int>(sizeof(T));
  static_assert(kRowBytes == 32 || kRowBytes == 64 || kRowBytes == 128,
                "a stage row of 32, 64 or 128 bytes");
  static constexpr int kStage = C::kRows * kRowBytes;
  static constexpr int kRing = C::ST * kStage;
  static constexpr int kXPitch = 2 * C::KG * kGroup + 4;  // floats
  static constexpr int kXTile = QP * kXPitch;             // floats
  static constexpr int kPPitch = C::kRows + 4;
  static constexpr int kMain = kRing + 2 * kXTile * 4;
  static constexpr int kPartial = QP * kPPitch * 4;
  static constexpr int kBytes = kMain > kPartial ? kMain : kPartial;
  // The 16-byte chunk c of stage row r sits at chunk c ^ swizzle(r).  A
  // lane reads 32, 16 or 8 bytes of a group per row (float32, 2-byte,
  // int8), and the rows g = 0..7 of a fragment load must then spread over
  // the 8 chunks of a 128-byte row: by g (float32), by g & 1 (2-byte, 2
  // groups per row) or by g & 3 (int8, 4 groups per row).  The shorter
  // rows (64-byte 2-byte, 32-byte int8) already fill 128 bytes with 2 or
  // 4 rows.  kPeriod: the rows after which the swizzle repeats.
  static constexpr int kPeriod =
      kRowBytes < 128 ? 1 : (sizeof(T) == 4 ? 8 : (sizeof(T) == 2 ? 2 : 4));
  __device__ __forceinline__ static int swizzle(int r) {
    if constexpr (kRowBytes < 128) return 0;
    if constexpr (sizeof(T) == 4) return r & 7;
    if constexpr (sizeof(T) == 2) return (r & 1) << 2;
    return (r & 3) << 1;
  }
  // byte offset of byte b of stage row r
  __device__ __forceinline__ static int offset(int r, int b) {
    return r * kRowBytes + ((((b >> 4) ^ swizzle(r)) << 4) | (b & 15));
  }
};

// asynchronous copy of N bytes global -> shared (dst: a shared-space
// address); zero-fills when !pred, reading nothing; PF: the copy brings
// the 256 bytes around it into L2
template <int N, int PF>
__device__ __forceinline__ void cp_async(unsigned dst, const void* gmem,
                                         bool pred) {
  const int n = pred ? N : 0;
  if constexpr (N == 16 && PF) {
    asm volatile(
        "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(
            dst),
        "l"(gmem), "r"(n));
  } else if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst),
                 "l"(gmem), "r"(n));
  } else if constexpr (PF) {
    asm volatile(
        "cp.async.ca.shared.global.L2::256B [%0], [%1], %2, %3;\n" ::"r"(
            dst),
        "l"(gmem), "n"(N), "r"(n));
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

// x rounded to TF32, to nearest with ties away from zero (low 13 bits 0)
__device__ __forceinline__ unsigned tf32_big(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// c += a * b: a 16 x 8 tile of W (rows x k), b 8 x 8 of X (k x queries)
__device__ __forceinline__ void mma_tf32(float (&c)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A lane's 8 W values of one group and row (columns 8 tig .. 8 tig + 7,
// from byte b of stage row r), read from shared memory and upcast exactly,
// in two halves of 4 (2 k-steps each).  float32 reads each half when it is
// used (one 16-byte load); the narrower types read the whole group at once
// (one 16- or 8-byte load, kept raw) and upcast each half from it.
template <typename T, typename L>
struct WFrag {
  static_assert(sizeof(T) == 2, "2-byte storage");
  uint4 raw;
  __device__ __forceinline__ void load(const unsigned char* base, int r,
                                       int b) {
    raw = *reinterpret_cast<const uint4*>(base + L::offset(r, b));
  }
  __device__ __forceinline__ float4 half(int h) const {
    return Vec4<T>::up(h == 0 ? make_uint2(raw.x, raw.y)
                              : make_uint2(raw.z, raw.w));
  }
};

template <typename L>
struct WFrag<float, L> {
  const unsigned char* p0;
  const unsigned char* p1;
  __device__ __forceinline__ void load(const unsigned char* base, int r,
                                       int b) {
    p0 = base + L::offset(r, b);
    p1 = base + L::offset(r, b + 16);
  }
  __device__ __forceinline__ float4 half(int h) const {
    return *reinterpret_cast<const float4*>(h == 0 ? p0 : p1);
  }
};

template <typename L>
struct WFrag<int8_t, L> {
  uint2 raw;
  __device__ __forceinline__ void load(const unsigned char* base, int r,
                                       int b) {
    raw = *reinterpret_cast<const uint2*>(base + L::offset(r, b));
  }
  __device__ __forceinline__ float4 half(int h) const {
    return Vec4<int8_t>::up(h == 0 ? raw.x : raw.y);
  }
};

template <typename T, int QP, typename C>
__global__ void __launch_bounds__(C::kThreads, 1)
streaming_matvec_kernel(const T* __restrict__ W, const float* __restrict__ X,
                        float* __restrict__ Y, int N, int M, int B) {
  using L = Layout<T, QP, C>;
  constexpr int MT = C::MT, ST = C::ST, KG = C::KG, S = kSplits;
  constexpr int NT = QP / 8 / C::WQ;  // a warp's n-tiles of 8 queries
  static_assert(NT * 8 * C::WQ == QP, "the warps split the queries");
  constexpr int kT = C::kThreads, RC = C::kRows;
  constexpr bool kSplitW = sizeof(T) == 4;
  constexpr int kTBytes = static_cast<int>(sizeof(T));
  constexpr int kXPitch = L::kXPitch;
  extern __shared__ __align__(16) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma group, thread in group
  const int wrow = warp % C::WR;             // the warp's rows
  const int wq0 = warp / C::WR * NT * 8;     // and its first query
  const int row0 = static_cast<int>(blockIdx.x / S) * RC;
  const int q0 = blockIdx.y * QP;
  // this CTA's groups [gbeg, gend) and columns [gbeg * 32, cend)
  const int n_groups = (M + kGroup - 1) / kGroup;
  const int gbeg = rank * n_groups / S;
  const int gend = (rank + 1) * n_groups / S;
  const int cend = min(M, gend * kGroup);
  const int n_stages = (gend - gbeg + KG - 1) / KG;

  // The copies of a stage: thread tid copies 4-element chunk
  // tid % kChunks of W rows tid / kChunks + i * kRowStep, and float4
  // tid % kChunks of X rows (queries) likewise; a row past N or B, or
  // columns past cend, are zero-filled (a W row past N reads row 0).  The
  // row step is a multiple of the swizzle's period, so a thread's chunk
  // lands at the same swizzled place in each of its rows.
  constexpr int kChunks = C::kChunks;
  constexpr int kRowStep = kT / kChunks;
  constexpr int kWCopies = RC / kRowStep;
  static_assert(kWCopies <= 32, "a thread's row flags fit 32 bits");
  static_assert(kRowStep % L::kPeriod == 0, "the copies keep their swizzle");
  const int cc = (tid % kChunks) * 4;  // the chunk's column in a stage
  const int cr = tid / kChunks;
  const size_t row_step = static_cast<size_t>(kRowStep) * M;
  const T* wsrc = W + static_cast<size_t>(row0 + cr) * M + cc;
  unsigned row_ok = 0;
#pragma unroll
  for (int i = 0; i < kWCopies; ++i)
    row_ok |= static_cast<unsigned>(row0 + cr + i * kRowStep < N) << i;
  const unsigned smem_sa =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned wdst = smem_sa + L::offset(cr, cc * kTBytes);

  auto issue_w = [&](int t) {
    if (t < n_stages) {
      const int c0 = (gbeg + t * KG) * kGroup;
      const bool col_ok = c0 + cc < cend;
      const unsigned dst = wdst + (t % ST) * L::kStage;
#pragma unroll
      for (int i = 0; i < kWCopies; ++i) {
        const bool ok = col_ok && ((row_ok >> i) & 1u);
        cp_async<4 * kTBytes, C::PF>(dst + i * kRowStep * L::kRowBytes,
                                     ok ? wsrc + i * row_step + c0 : W, ok);
      }
    }
    cp_async_commit();
  };

  // X: a stage ahead in registers, then split once per CTA
  constexpr int kXVecs = QP * kChunks;
  constexpr int kXLoads = (kXVecs + kT - 1) / kT;
  float* xsplit = reinterpret_cast<float*>(smem + L::kRing);
  float4 xr[kXLoads];
  auto load_x = [&](int t) {
    const int c = (gbeg + t * KG) * kGroup + cc;
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int q = cr + i * kRowStep;
      xr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if ((kXVecs % kT == 0 || q < QP) && q0 + q < B && c < cend)
        xr[i] = __ldg(reinterpret_cast<const float4*>(
            X + static_cast<size_t>(q0 + q) * M + c));
    }
  };
  // column cc of a stage: group cc / 32, column cc % 32 in it
  const int xoff = (cc / kGroup) * 2 * kGroup + cc % kGroup;
  auto split_x = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int q = cr + i * kRowStep;
      if (kXVecs % kT == 0 || q < QP) {
        const float4 x = xr[i];
        const unsigned b[4] = {tf32_big(x.x), tf32_big(x.y), tf32_big(x.z),
                               tf32_big(x.w)};
        float* dst = xsplit + buf * L::kXTile + q * kXPitch + xoff;
        *reinterpret_cast<uint4*>(dst) = make_uint4(b[0], b[1], b[2], b[3]);
        *reinterpret_cast<float4*>(dst + kGroup) = make_float4(
            x.x - __uint_as_float(b[0]), x.y - __uint_as_float(b[1]),
            x.z - __uint_as_float(b[2]), x.w - __uint_as_float(b[3]));
      }
    }
  };

  // acc: the float32 running sums; c: the mma accumulators, added into
  // acc and restarted from zero after every kRestart k-steps
  float acc[MT][NT][4], c[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = c[mt][j][e] = 0.f;

  // One group (kg of stage t): this warp's MT x 16 rows by its 8 NT
  // queries, in two halves of 2 k-steps.  Each product is issued for every
  // (m-tile, n-tile) pair before the next, so consecutive mma instructions
  // feed independent accumulators; per (row, query) the order stays xs*wb,
  // xb*ws, xb*wb of k-step 0, then of k-step 1, ...
  auto compute = [&](int t, int kg) {
    const unsigned char* ws = smem + (t % ST) * L::kStage;
    const int b0 = (kg * kGroup + 8 * tig) * kTBytes;
    WFrag<T, L> wf[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wf[mt][h].load(ws, (wrow * MT + mt) * 16 + 8 * h + g, b0);
    const float* xs = xsplit + (t & 1) * L::kXTile + (wq0 + g) * kXPitch +
                      kg * 2 * kGroup + 8 * tig;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // wb: the values (their TF32 big parts for float32), wsm: the
      // float32 remainders; [mt][h][e]: row g + 8h of m-tile mt, column
      // 8 tig + 4 half + e.  xb, xsm: X's parts, [j][e]: query g of
      // n-tile j, the same columns.
      unsigned wb[MT][2][4], wsm[MT][2][4], xb[NT][4], xsm[NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v4 = wf[mt][h].half(half);
          const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (kSplitW) {
              wb[mt][h][e] = tf32_big(v[e]);
              wsm[mt][h][e] =
                  __float_as_uint(v[e] - __uint_as_float(wb[mt][h][e]));
            } else {
              wb[mt][h][e] = __float_as_uint(v[e]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* xq = xs + j * 8 * kXPitch + 4 * half;
        const uint4 b4 = *reinterpret_cast<const uint4*>(xq);
        const uint4 s4 = *reinterpret_cast<const uint4*>(xq + kGroup);
        xb[j][0] = b4.x, xb[j][1] = b4.y, xb[j][2] = b4.z, xb[j][3] = b4.w;
        xsm[j][0] = s4.x, xsm[j][1] = s4.y, xsm[j][2] = s4.z;
        xsm[j][3] = s4.w;
      }
      // one product for every (m-tile, n-tile) pair; a: rows g, g + 8 at
      // k = tig (column 8 tig + 2s) and at k = tig + 4 (column
      // 8 tig + 2s + 1); b: the same columns
      auto mma_all = [&](const unsigned(&a)[MT][2][4],
                         const unsigned(&b)[NT][4], int s2) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_tf32(c[mt][j], a[mt][0][2 * s2], a[mt][1][2 * s2],
                     a[mt][0][2 * s2 + 1], a[mt][1][2 * s2 + 1],
                     b[j][2 * s2], b[j][2 * s2 + 1]);
        }
      };
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        mma_all(wb, xsm, s2);
        if constexpr (kSplitW) mma_all(wsm, xb, s2);
        mma_all(wb, xb, s2);
        const int s = 2 * half + s2;  // the k-step in the group
        if (kRestart > 0 && (s + 1) % kRestartEvery == 0) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                acc[mt][j][e] += c[mt][j][e];
                c[mt][j][e] = 0.f;
              }
        }
      }
    }
  };

  // The ring: stages 0 .. ST - 2 in flight, stage 0's X split and stage
  // 1's X in registers before the first sum.  Iteration t waits for stage
  // t, then (after one barrier: every warp is done with stage t - 1 and
  // split tile t - 1) refills stage t - 1's slot, splits stage t + 1's X,
  // loads stage t + 2's, and sums stage t.
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) issue_w(t);
  if (n_stages > 0) {
    load_x(0);
    split_x(0);
  }
  if (n_stages > 1) load_x(1);
  for (int t = 0; t < n_stages; ++t) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    issue_w(t + ST - 1);
    if (t + 1 < n_stages) split_x((t + 1) & 1);
    if (t + 2 < n_stages) load_x(t + 2);
#pragma unroll
    for (int kg = 0; kg < KG; ++kg)
      if (KG == 1 || gbeg + t * KG + kg < gend) compute(t, kg);
  }
  cp_async_wait<0>();
  __syncthreads();

  // partial sums -> shared memory, P[query][row]
  float* P = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = (wrow * MT + mt) * 16 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int q = wq0 + 8 * j + 2 * tig;
      P[q * L::kPPitch + r] = acc[mt][j][0] + c[mt][j][0];
      P[(q + 1) * L::kPPitch + r] = acc[mt][j][1] + c[mt][j][1];
      P[q * L::kPPitch + r + 8] = acc[mt][j][2] + c[mt][j][2];
      P[(q + 1) * L::kPPitch + r + 8] = acc[mt][j][3] + c[mt][j][3];
    }
  }
  cluster.sync();
  // The row block's QP x kRows outputs are cut into S slices (query-major);
  // CTA rank o writes slice o, the sum of the S partials in rank order,
  // each thread 4 consecutive rows of a query with 16-byte remote loads.
  constexpr int kSlice = QP * RC / S;
  static_assert(kSlice * S == QP * RC && kSlice % 4 == 0 && RC % 4 == 0,
                "whole slices of float4s");
  const int nq = min(QP, B - q0);
  for (int e = rank * kSlice + 4 * tid; e < (rank + 1) * kSlice;
       e += 4 * kT) {
    const int q = e / RC, r = e % RC;
    if (q < nq && row0 + r < N) {
      const int idx = q * L::kPPitch + r;
      float4 part[S];
#pragma unroll
      for (int s = 0; s < S; ++s)
        part[s] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(P, s) + idx);
      float4 sum = part[0];
#pragma unroll
      for (int s = 1; s < S; ++s) {
        sum.x += part[s].x;
        sum.y += part[s].y;
        sum.z += part[s].z;
        sum.w += part[s].w;
      }
      const float v[4] = {sum.x, sum.y, sum.z, sum.w};
      float* y = Y + static_cast<size_t>(q0 + q) * N + row0 + r;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (row0 + r + k < N) y[k] = v[k];
    }
  }
  // no CTA leaves while another may still read its partials
  cluster.sync();
}

template <typename T, int QP, typename C>
cudaError_t launch(const void* W, const float* X, float* Y, int N, int M,
                   int B, cudaStream_t stream) {
  using L = Layout<T, QP, C>;
  auto kernel = streaming_matvec_kernel<T, QP, C>;
  if (L::kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + C::kRows - 1) / C::kRows) * kSplits,
                     (B + QP - 1) / QP);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(W), X, Y, N, M, B);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The queries per CTA of a batch of B (the next of 8, 16, 32, 64), as F<QP>.
template <typename F>
auto with_qp(int B, F&& f) {
  if (B <= 8) return f(std::integral_constant<int, 8>{});
  if (B <= 16) return f(std::integral_constant<int, 16>{});
  if (B <= 32) return f(std::integral_constant<int, 32>{});
  return f(std::integral_constant<int, kMaxQueries>{});
}

template <typename T>
cudaError_t launch_typed(const void* W, const float* X, float* Y, int N,
                         int M, int B, cudaStream_t s) {
  return with_qp(B, [&](auto qp) {
    constexpr int QP = decltype(qp)::value;
    return launch<T, QP, typename Chosen<T, QP>::type>(W, X, Y, N, M, B, s);
  });
}

// The storage type of code dtype (0 float32, 1 bfloat16, 2 float16,
// 3 int8), as F<T>; cudaErrorInvalidValue for any other code.
template <typename F>
cudaError_t with_type(int dtype, F&& f) {
  switch (dtype) {
    case 0:
      return f(float{});
    case 1:
      return f(__nv_bfloat16{});
    case 2:
      return f(__half{});
    case 3:
      return f(int8_t{});
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Storage type codes: 0 float32, 1 bfloat16, 2 float16, 3 int8.
// W: (N, M) row-major, M a multiple of 4, aligned to 4 elements;
// X: (B, M) float32 row-major, 16-byte aligned; Y: (B, N) float32,
// written whole.  B > 64 takes one pass over W per group of 64 queries.
// Returns the cudaError_t of the launch (0 on success).
int streaming_matvec_launch(int dtype, const void* W, const void* X, void* Y,
                            int N, int M, int B, void* stream) {
  if (N <= 0 || M <= 0 || B <= 0 || M % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_type(dtype, [&](auto t) {
    return launch_typed<decltype(t)>(W, static_cast<const float*>(X),
                                     static_cast<float*>(Y), N, M, B,
                                     static_cast<cudaStream_t>(stream));
  }));
}

// The configuration a batch of B queries with storage type code dtype
// takes: QP, then its tile MT, WR, WQ, ST, KG, PF, then the summation
// order kSplits, kRestart, then the rows per CTA and its threads, into
// out[0 .. 10].  For reports; returns the cudaError_t of an unknown code,
// else 0.
int streaming_matvec_config(int dtype, int B, int* out) {
  return static_cast<int>(with_type(dtype, [&](auto t) {
    return with_qp(B, [&](auto qp) {
      constexpr int QP = decltype(qp)::value;
      using C = typename Chosen<decltype(t), QP>::type;
      const int v[] = {QP,    C::MT,   C::WR,    C::WQ,    C::ST,      C::KG,
                       C::PF, kSplits, kRestart, C::kRows, C::kThreads};
      for (int i = 0; i < 11; ++i) out[i] = v[i];
      return cudaSuccess;
    });
  }));
}

}  // extern "C"
