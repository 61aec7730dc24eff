// Storage and accumulation types of the port's matvec kernels.
//
// Each kernel is a template on its storage type T (float, double or
// __nv_bfloat16). It loads T, sums in AccOf<T>::type (T itself, but float
// for bfloat16) and rounds once, at the store. The bfloat16 conversions go
// through the intrinsics of cuda_bf16.h only (__bfloat162float on load,
// __float2bfloat16, round to nearest even, on store); for float and double
// both helpers are the identity, so those builds compile as before.

#pragma once

#include <cuda_bf16.h>

template <typename T>
struct AccOf {
  using type = T;
};
template <>
struct AccOf<__nv_bfloat16> {
  using type = float;
};

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_acc(typename AccOf<T>::type v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
