// Shared helpers of the port's kernels: the error-string entry every
// library exports, and a block-wide float sum.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define WAVECAP_EXPORT extern "C" __attribute__((visibility("default")))

WAVECAP_EXPORT const char* wavecap_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Sum of one float per thread over the block; every thread gets the
// total.  ``scratch`` holds 32 floats of shared memory.  blockDim.x must
// be a multiple of 32.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    const int n_warps = blockDim.x >> 5;
    v = lane < n_warps ? scratch[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    __syncthreads();  // scratch may be reused by the caller
    return v;
}
