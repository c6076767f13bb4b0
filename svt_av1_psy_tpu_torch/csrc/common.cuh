// Shared device helpers of the port's kernels: block-wide reductions with a
// fixed summation order (so a kernel gives the same bits on every run) and
// argmin combiners that break ties toward the lowest index, as jnp.argmin.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SVT_NT 256   // threads per block for every kernel of the port

__device__ __forceinline__ double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long warp_sum_ll(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_max_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// Every thread of the block must call these (they synchronise).
// `red` holds at least SVT_NT / 32 entries of the value type.
__device__ double block_sum_d(double v, double* red) {
  v = warp_sum_d(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
    red[0] = s;
  }
  __syncthreads();
  return red[0];
}

__device__ long long block_sum_ll(long long v, long long* red) {
  v = warp_sum_ll(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long s = 0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
    red[0] = s;
  }
  __syncthreads();
  return red[0];
}

__device__ int block_max_i(int v, int* red) {
  v = warp_max_i(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = red[0];
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i) s = max(s, red[i]);
    red[0] = s;
  }
  __syncthreads();
  return red[0];
}

// (value, index) argmin over the block; ties go to the lowest index.
template <typename T>
__device__ __forceinline__ void argmin_merge(T& v, int& i, T v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

template <typename T>
__device__ void block_argmin(T& v, int& i, T* redv, int* redi) {
  for (int o = 16; o > 0; o >>= 1) {
    T v2 = __shfl_down_sync(0xffffffffu, v, o);
    int i2 = __shfl_down_sync(0xffffffffu, i, o);
    argmin_merge(v, i, v2, i2);
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) { redv[threadIdx.x >> 5] = v; redi[threadIdx.x >> 5] = i; }
  __syncthreads();
  if (threadIdx.x == 0) {
    T bv = redv[0]; int bi = redi[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) argmin_merge(bv, bi, redv[w], redi[w]);
    redv[0] = bv; redi[0] = bi;
  }
  __syncthreads();
  v = redv[0]; i = redi[0];
}

// jax.lax.dynamic_slice clamps its start into [0, dim - size].
__device__ __forceinline__ int clamp_start(int s, int dim, int size) {
  return min(max(s, 0), dim - size);
}
