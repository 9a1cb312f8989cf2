// Shared declarations of the port's CUDA kernels. Every entry point has a
// plain C interface (loaded with ctypes by _native.py), launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#define SVT_API extern "C" __attribute__((visibility("default")))

namespace svt {

// int16 border sentinel of the reference's integer SGM and extraction
// (sgm_pallas.py / extract_pallas.py _BIG_INT): survives +P1/+P2.
constexpr int kBigInt = 16000;
// out-of-image marker of the float maps (extract_pallas.py _BIG)
constexpr float kBigFloat = 1e9f;

}  // namespace svt
