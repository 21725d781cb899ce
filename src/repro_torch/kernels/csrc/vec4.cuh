// Loads of a matrix stored as float32, bfloat16, float16 or int8, upcast to
// float32: shared by the streaming matvec (K2), the BSR SpMV (K3) and the
// PageRank steps (K1 and K4: the int8 upcast and the scalar loads).
//
//   Vec4<T>:   four consecutive elements, loaded as raw storage bits (one
//              16-, 8- or 4-byte load by type) and upcast only where they
//              are used, so a prefetch does not wait on its load.  The
//              pointer must be aligned to 4 elements.
//   Scalar<T>: one element, any alignment.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ static float4 up(Raw q) { return q; }
};

template <>
struct Vec4<__nv_bfloat16> {
  using Raw = uint2;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ static float4 up(Raw q) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

template <>
struct Vec4<__half> {
  using Raw = uint2;
  __device__ __forceinline__ static Raw load(const __half* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ static float4 up(Raw q) {
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&q.x));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&q.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

// int8 upcast without the conversion unit: flip the sign bit of each byte
// (v + 128, an unsigned byte u), place u in the low mantissa bits of 2^23
// (a byte permute), and subtract 2^23 + 128.  Exact for every byte.
template <>
struct Vec4<int8_t> {
  using Raw = unsigned;
  __device__ __forceinline__ static Raw load(const int8_t* p) {
    return __ldg(reinterpret_cast<const unsigned*>(p));
  }
  __device__ __forceinline__ static float byte(unsigned u, unsigned sel) {
    return __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.f;
  }
  __device__ __forceinline__ static float4 up(Raw q) {
    const unsigned u = q ^ 0x80808080u;
    return make_float4(byte(u, 0x7650), byte(u, 0x7651), byte(u, 0x7652),
                       byte(u, 0x7653));
  }
};

template <typename T>
struct Scalar;

template <>
struct Scalar<float> {
  __device__ __forceinline__ static float load(const float* p) {
    return __ldg(p);
  }
};

template <>
struct Scalar<__nv_bfloat16> {
  __device__ __forceinline__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
};

template <>
struct Scalar<__half> {
  __device__ __forceinline__ static float load(const __half* p) {
    return __half2float(__ldg(p));
  }
};

template <>
struct Scalar<int8_t> {
  __device__ __forceinline__ static float load(const int8_t* p) {
    return static_cast<float>(
        __ldg(reinterpret_cast<const signed char*>(p)));
  }
};
