// One PageRank step on the split-ELL layout of the engine's ``ell`` tier,
// for Hopper (sm_90a), in two launches.
//
// It replaces no TPU kernel: the JAX package's ``ell`` tier computes this
// step with jnp gathers and one ``segment_sum`` and reaches no Pallas call.
// It was added because the port's eager version of that step (gathers of
// int64 copies of the indices, products and row sums written to device
// memory, an atomic ``index_add_`` over the overflow tail, then the leak
// and the damping as further ops) moved some 2 GB a step and gave other
// bits on every repeat.  For the layout ``(data, idx, ov_r, ov_c, ov_v)``
// (float32, bfloat16, float16 or int8 values with per-row float32 scales
// s, int32 indices) and a rank vector x with leak = sum(x * dang):
//
//     y[i]   = s[i] * (sum_{j < cnt[i]} data[i, j] * x[idx[i, j]]
//                      + sum_{e in overflow row i} ov_v[e] * x[ov_c[e]])
//     new[i] = d * (y[i] + leak / N) + (1 - d) / N
//     leak'  = sum_i new[i] * dang[i]
//
// The layout may be a block of the rows of a larger H (the engine's
// ``ell_split_sharded`` tier, one block per card): its n rows carry column
// indices into the whole vector x of N entries, and dang is the block's.
// Then leak' is the block's part of the next leak, and the leak read in
// may be given as the parts of every block, summed here in their order.
// On one card N = n and the leak is one number.
//
// Bound.  Each real entry is read once (its value and its int32 index;
// the ELL block's padded slots are never read), and so are the row counts
// and the rest of the metadata, the dangling mask and x, and the new vector
// is written once: at the graph500_22 cell's shapes (646,374 rows, 9.4 M
// ELL entries, 22.0 M overflow entries in 64,267 rows, float32) 262 MB,
// 78 us at the data-sheet 3.35 TB/s.  Each entry also gathers one float of
// x (2.6 MB, held in the L2) at a random index: a 32-byte L2 sector for
// every 4 bytes used, 31.4 M of them a step.  On an H100 SXM (700 W) the
// step takes about 290 us; with the gathers confined to a 4 kB window it
// takes about 180 us, so the gathers and the streams' latency, more than
// the bytes, bound it.
//
// Design:
//   * Pass 1 (overflow_kernel) walks the overflow tail, which is in
//     row-major order, in fixed chunks of kChunk entries, one block each,
//     so a hub row of 64,678 entries and 64,267 short rows spread evenly
//     over the SMs.  A thread owns kPer consecutive entries (16-byte loads
//     at every storage type, all its gathers in flight at once), finds the
//     compact row of its first entry by a binary search between the
//     chunk's first and last rows (``chunk_row``), and sums each row's run
//     of entries in order.  A run that crosses into the next threads is
//     finished by the thread it starts in, adding their leading sums from
//     shared memory in thread order.  Each (compact row r, chunk c) pair
//     gets one float32 partial at slot r + c: rows and chunks are both in
//     order, so no two pairs share a slot.  No atomics.
//   * Pass 2 (rows_kernel) owns kRowsPerBlock rows a block, kGroup lanes a
//     row.  A row reads only its cnt[i] = min(indeg, k0) real entries (a
//     layout carried in without counts reads all k0 slots: the padded ones
//     hold value 0 at index 0).  It is a programmatic dependent launch of
//     pass 1: its blocks start while pass 1's last blocks run, sum the ELL
//     entries of their rows, and only then wait for pass 1's partials.  A
//     row adds its partials in chunk order (the block maps its overflow
//     rows from ``block_ov`` and ``ov_rows``), applies the int8 scale and
//     the damping, and writes the new rank.  The block's partial of
//     new * dang goes to device memory; the last block to finish (an
//     integer ticket) sums the partials in index order into the next
//     step's leak, on the device, and resets the ticket.  The host reads
//     no scalar between steps.
//   * Values are upcast in the load (vec4.cuh); indices are read as int32
//     in place; nothing but the partials and the new vector is written.
//     What is read once bypasses the L1, which keeps lines of x.
//     Every sum runs in a fixed order (a lane in increasing entry order,
//     then a butterfly over the group; partials in chunk order; the leak
//     in block order), so two calls give the same bits.

#include <type_traits>

#include "vec4.cuh"

namespace {

constexpr int kChunk = 1024;             // overflow entries of one block
constexpr int kOvThreads = 128;
constexpr int kPer = kChunk / kOvThreads;  // entries of one thread
constexpr int kGroup = 16;               // lanes of one row in pass 2
constexpr int kRowThreads = 256;
constexpr int kGroups = kRowThreads / kGroup;
constexpr int kRowsPerBlock = 128;
constexpr int kUnroll = 4;               // ELL loads in flight per lane
static_assert(kPer % 4 == 0, "a thread's entries load in fours");

constexpr unsigned char kStarts = 1;  // the thread's first entry starts a run
constexpr unsigned char kCloses = 2;  // a run that came in ends in the thread

// Loads of what a step reads once (the layout's entries, indices and
// counts): the read-only path with no L1 allocation, so the L1 keeps lines
// of x for the gathers.
__device__ __forceinline__ unsigned once(const unsigned* p) {
  unsigned v;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ int once(const int* p) {
  return static_cast<int>(once(reinterpret_cast<const unsigned*>(p)));
}
__device__ __forceinline__ unsigned short once(const unsigned short* p) {
  unsigned short v;
  asm("ld.global.nc.L1::no_allocate.b16 %0, [%1];" : "=h"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint2 once(const uint2* p) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.v2.b32 {%0, %1}, [%2];"
      : "=r"(v.x), "=r"(v.y)
      : "l"(p));
  return v;
}
__device__ __forceinline__ uint4 once(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.b32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}
__device__ __forceinline__ int4 once(const int4* p) {
  const uint4 v = once(reinterpret_cast<const uint4*>(p));
  return make_int4(v.x, v.y, v.z, v.w);
}
__device__ __forceinline__ float4 once(const float4* p) {
  const uint4 v = once(reinterpret_cast<const uint4*>(p));
  return make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                     __uint_as_float(v.z), __uint_as_float(v.w));
}

// One stored value, read once and upcast to float32.
__device__ __forceinline__ float once_value(const float* p) {
  return __uint_as_float(once(reinterpret_cast<const unsigned*>(p)));
}
__device__ __forceinline__ float once_value(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(once(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float once_value(const __half* p) {
  return __half2float(
      __ushort_as_half(once(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float once_value(const int8_t* p) {
  int v;
  asm("ld.global.nc.L1::no_allocate.s8 %0, [%1];" : "=r"(v) : "l"(p));
  return static_cast<float>(v);
}

// p[k] = ov_v[k] * x[ov_c[k]] for the m <= kPer entries at v / c (16-byte
// aligned when m == kPer), 0 past m.
template <typename T>
__device__ __forceinline__ void products(const T* __restrict__ v,
                                         const int* __restrict__ c,
                                         const float* __restrict__ x, int m,
                                         float (&p)[kPer]) {
  if (m == kPer) {
    int col[kPer];
    float val[kPer];
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const int4 ci = once(reinterpret_cast<const int4*>(c) + q);
      const float4 vv = Vec4<T>::up(
          once(reinterpret_cast<const typename Vec4<T>::Raw*>(v + 4 * q)));
      col[4 * q] = ci.x;
      col[4 * q + 1] = ci.y;
      col[4 * q + 2] = ci.z;
      col[4 * q + 3] = ci.w;
      val[4 * q] = vv.x;
      val[4 * q + 1] = vv.y;
      val[4 * q + 2] = vv.z;
      val[4 * q + 3] = vv.w;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      p[k] = __fmul_rn(val[k], __ldg(x + col[k]));
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      p[k] = k < m ? __fmul_rn(once_value(v + k), __ldg(x + once(c + k)))
                   : 0.f;
  }
}

// Pass 1: the (compact row, chunk) partials of the overflow tail.
template <typename T>
__global__ void __launch_bounds__(kOvThreads)
overflow_kernel(const T* __restrict__ ov_v, const int* __restrict__ ov_c,
                const int* __restrict__ ov_ptr,
                const int* __restrict__ chunk_row,
                const float* __restrict__ x, float* __restrict__ part,
                int E) {
  // let pass 2 be scheduled now: it sums its ELL entries, then waits for
  // this grid's partials
  asm volatile("griddepcontrol.launch_dependents;");
  __shared__ float lead[kOvThreads];
  __shared__ unsigned char flag[kOvThreads];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int a = b * kChunk + t * kPer;
  const int m = min(kPer, min(E, (b + 1) * kChunk) - a);
  float led = 0.f;
  float tail = 0.f;
  int tail_row = -1;
  unsigned char f = kStarts;  // a thread with no entries stops every walk
  if (m > 0) {
    float p[kPer];
    products(ov_v + a, ov_c + a, x, m, p);
    // the compact row of entry a: the last r with ov_ptr[r] <= a
    int lo = __ldg(chunk_row + b);
    int hi = __ldg(chunk_row + b + 1);
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (__ldg(ov_ptr + mid) <= a) lo = mid; else hi = mid - 1;
    }
    int r = lo;
    int next = __ldg(ov_ptr + r + 1);
    const bool starts = t == 0 || __ldg(ov_ptr + r) == a;
    f = starts ? kStarts : 0;
    bool first = true;  // the run being summed is the thread's first
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k < m) {
        if (a + k == next) {  // row r ends before entry a + k
          if (first && !starts) {
            led = acc;
            f |= kCloses;
          } else {
            part[r + b] = acc;
          }
          first = false;
          acc = 0.f;
          ++r;
          next = __ldg(ov_ptr + r + 1);
        }
        acc = __fadd_rn(acc, p[k]);
      }
    }
    if (first && !starts) {
      led = acc;
    } else {
      tail = acc;
      tail_row = r;
    }
  }
  lead[t] = led;
  flag[t] = f;
  __syncthreads();
  if (tail_row >= 0) {
    // the run open at this thread's end: add the leading sums of the
    // threads it crosses into, in order
    float s = tail;
    for (int v = t + 1; v < kOvThreads && !(flag[v] & kStarts); ++v) {
      s = __fadd_rn(s, lead[v]);
      if (flag[v] & kCloses) break;
    }
    part[tail_row + b] = s;
  }
}

// A sum over the kGroup lanes of a row (every lane gets it); ``mask``
// holds the group's lanes.
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off, kGroup);
  return v;
}

// Pass 2: the rows, the damping and the next step's leak.
template <typename T, bool kScales>
__global__ void __launch_bounds__(kRowThreads)
rows_kernel(const T* __restrict__ data, const int* __restrict__ idx,
            const int* __restrict__ counts, int n, int k0,
            const int* __restrict__ ov_ptr, const int* __restrict__ ov_rows,
            const int* __restrict__ block_ov, const float* __restrict__ part,
            const float* __restrict__ scales,
            const float* __restrict__ dang, const float* __restrict__ x,
            const float* __restrict__ leak_in, int leak_parts,
            int n_total, float* __restrict__ y,
            float* __restrict__ block_leak, unsigned* __restrict__ ticket,
            float* __restrict__ leak_out, float d, float tel) {
  __shared__ int ovj[kRowsPerBlock];
  __shared__ float ell_sum[kRowsPerBlock];
  __shared__ float red[kRowThreads];
  __shared__ bool last;
  const int t = threadIdx.x;
  const int g = t / kGroup;
  const int lane = t % kGroup;
  const unsigned mask = (0xffffffffu >> (32 - kGroup))
                        << ((t & 31) & ~(kGroup - 1));
  const int i0 = blockIdx.x * kRowsPerBlock;
  for (int r = t; r < kRowsPerBlock; r += kRowThreads) ovj[r] = -1;
  __syncthreads();
  const int j1 = __ldg(block_ov + blockIdx.x + 1);
  for (int j = __ldg(block_ov + blockIdx.x) + t; j < j1; j += kRowThreads)
    ovj[__ldg(ov_rows + j) - i0] = j;
  __syncthreads();

  // the ELL entries of the block's rows, one row a group and round
  for (int rr = g; rr < kRowsPerBlock; rr += kGroups) {
    const int i = i0 + rr;
    if (i >= n) break;  // the same for the whole group
    const int c = counts != nullptr ? once(counts + i) : k0;
    const T* row = data + static_cast<size_t>(i) * k0;
    const int* ix = idx + static_cast<size_t>(i) * k0;
    float a = 0.f;
    for (int j0 = lane; j0 < c; j0 += kUnroll * kGroup) {
      float v[kUnroll];
      int col[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kGroup;
        v[u] = j < c ? once_value(row + j) : 0.f;
        col[u] = j < c ? once(ix + j) : -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (col[u] >= 0) a = fmaf(v[u], __ldg(x + col[u]), a);
    }
    a = group_sum(a, mask);
    if (lane == 0) ell_sum[rr] = a;
  }

  // the overflow partials are pass 1's: wait until it has finished and its
  // stores are visible (at once after an ordinary launch)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __syncwarp(mask);
  // the leak: its parts in order (one on one card), over the whole vector
  float lk = __ldg(leak_in);
  for (int k = 1; k < leak_parts; ++k) lk = __fadd_rn(lk, __ldg(leak_in + k));
  const float l = __fdiv_rn(lk, static_cast<float>(n_total));
  float leak = 0.f;
  for (int rr = g; rr < kRowsPerBlock; rr += kGroups) {
    const int i = i0 + rr;
    if (i >= n) break;
    float a = ell_sum[rr];
    const int oj = ovj[rr];
    if (oj >= 0) {
      const int c0 = __ldg(ov_ptr + oj) / kChunk;
      const int c1 = (__ldg(ov_ptr + oj + 1) - 1) / kChunk;
      float s = 0.f;
      for (int cc = c0 + lane; cc <= c1; cc += kGroup)
        s = __fadd_rn(s, __ldcg(part + oj + cc));
      a = __fadd_rn(a, group_sum(s, mask));
    }
    if (kScales) a = __fmul_rn(__ldg(scales + i), a);
    const float out = __fadd_rn(__fmul_rn(d, __fadd_rn(a, l)), tel);
    if (lane == 0) {
      y[i] = out;
      leak = __fadd_rn(leak, __fmul_rn(out, __ldg(dang + i)));
    }
  }

  // the block's leak partial, its groups in order
  if (lane == 0) red[g] = leak;
  __syncthreads();
  if (t == 0) {
    float s = 0.f;
    for (int k = 0; k < kGroups; ++k) s = __fadd_rn(s, red[k]);
    block_leak[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every partial is visible; sum them in a fixed order
  float a = 0.f;
  for (int k = t; k < static_cast<int>(gridDim.x); k += kRowThreads)
    a = __fadd_rn(a, __ldcg(block_leak + k));
  red[t] = a;
  __syncthreads();
  for (int off = kRowThreads / 2; off > 0; off >>= 1) {
    if (t < off) red[t] = __fadd_rn(red[t], red[t + off]);
    __syncthreads();
  }
  if (t == 0) {
    *leak_out = red[0];
    *ticket = 0u;
  }
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

// Overflow entries one pass-1 block owns: ``chunk_row`` has one entry per
// chunk and one more, pass 1's partials R + chunks - 1 slots.
int ell_step_chunk() { return kChunk; }

// Overflow entries one pass-1 thread owns: each row's run of them is summed
// in order, then the runs of a chunk in thread order.
int ell_step_run() { return kPer; }

// Rows one pass-2 block owns: ``block_ov`` has one entry per block and one
// more.
int ell_step_rows_per_block() { return kRowsPerBlock; }

// Pass 1 over E > 0 overflow entries.  Storage type codes: 0 float32,
// 1 bfloat16, 2 float16, 3 int8; ov_v and ov_c 16-byte aligned.  Returns
// the cudaError_t of the launch.
int ell_overflow_launch(int dtype, const void* ov_v, const void* ov_c,
                        const void* ov_ptr, const void* chunk_row,
                        const void* x, void* part, int E, void* stream) {
  if (E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_type(dtype, [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    overflow_kernel<T><<<(E + kChunk - 1) / kChunk, kOvThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(ov_v), static_cast<const int*>(ov_c),
        static_cast<const int*>(ov_ptr), static_cast<const int*>(chunk_row),
        static_cast<const float*>(x), static_cast<float*>(part), E);
    return cudaGetLastError();
  }));
}

// Pass 2 over n > 0 rows of width k0, of a vector x of n_total >= n
// entries.  ``counts`` may be null (all k0 slots are read), ``scales`` is
// null unless the layout is int8.  ``leak_in`` holds leak_parts >= 1
// floats, summed in order.  ``block_leak`` holds one float per block,
// ``ticket`` is zero between launches.  Returns the cudaError_t of the
// launch.
int ell_rows_launch(int dtype, const void* data, const void* idx,
                    const void* counts, int n, int k0, const void* ov_ptr,
                    const void* ov_rows, const void* block_ov,
                    const void* part, const void* scales, const void* dang,
                    const void* x, const void* leak_in, int leak_parts,
                    int n_total, void* y, void* block_leak, void* ticket,
                    void* leak_out, float d, float tel, void* stream) {
  if (n <= 0 || k0 < 0 || leak_parts < 1 || n_total < n)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_type(dtype, [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    // a programmatic dependent launch: its blocks may start once every
    // pass-1 block has started
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((n + kRowsPerBlock - 1) / kRowsPerBlock);
    cfg.blockDim = dim3(kRowThreads);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    auto launch = [&](auto kernel) {
      return cudaLaunchKernelEx(
          &cfg, kernel, static_cast<const T*>(data),
          static_cast<const int*>(idx), static_cast<const int*>(counts), n,
          k0, static_cast<const int*>(ov_ptr),
          static_cast<const int*>(ov_rows),
          static_cast<const int*>(block_ov), static_cast<const float*>(part),
          static_cast<const float*>(scales), static_cast<const float*>(dang),
          static_cast<const float*>(x), static_cast<const float*>(leak_in),
          leak_parts, n_total, static_cast<float*>(y),
          static_cast<float*>(block_leak),
          static_cast<unsigned*>(ticket), static_cast<float*>(leak_out), d,
          tel);
    };
    return scales != nullptr ? launch(rows_kernel<T, true>)
                             : launch(rows_kernel<T, false>);
  }));
}

}  // extern "C"
