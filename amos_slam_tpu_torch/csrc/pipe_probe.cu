// Issue-rate probe of the instructions the FAST kernels reduce with, CUDA
// C++ for sm_90a; a measurement, not a kernel of the package's path.
//
// Each thread runs 8 + 8 cross-dependent chains of one operation, 16 per
// iteration of a loop that is not unrolled, with many blocks per SM, so the
// issue rate of the operation bounds the time. The timing tool
// (amos_slam_tpu_torch/tools/time_fast_kernel.py --pipe-probe) turns the
// time into lanes per clock per SM and reads the compiled SASS of each
// probe<OP> to show how many instructions one call of the operation takes.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

enum Op {
  kF32MinMax = 0,  // fminf / fmaxf
  kF32Add = 1,
  kI32MinMax = 2,  // min / max of int
  kVimin3 = 3,     // __vimin3_s32 (DPX)
  kVimax3 = 4,     // __vimax3_s32 (DPX)
  kVimax3Relu = 5, // __vimax3_s32_relu (DPX)
  kVimaxRelu = 6,  // __vimax_s32_relu (DPX)
  kNumOps = 7,
};

template <int OP>
__global__ void probe(int* out, int iters, int s) {
  using T = typename std::conditional<(OP <= kF32Add), float, int>::type;
  T a[8], b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = (T)(threadIdx.x * s + i);
    b[i] = (T)(threadIdx.x * s - 3 * i);
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if constexpr (OP == kF32MinMax) {
        a[i] = fminf(a[i], b[(i + 1) & 7]);
        b[i] = fmaxf(b[i], a[(i + 3) & 7]);
      } else if constexpr (OP == kF32Add) {
        a[i] = a[i] + b[(i + 1) & 7];
        b[i] = b[i] + a[(i + 3) & 7];
      } else if constexpr (OP == kI32MinMax) {
        a[i] = min(a[i], b[(i + 1) & 7]);
        b[i] = max(b[i], a[(i + 3) & 7]);
      } else if constexpr (OP == kVimin3) {
        a[i] = __vimin3_s32(a[i], b[(i + 1) & 7], b[(i + 5) & 7]);
        b[i] = __vimin3_s32(b[i], a[(i + 3) & 7], a[(i + 6) & 7]);
      } else if constexpr (OP == kVimax3) {
        a[i] = __vimax3_s32(a[i], b[(i + 1) & 7], b[(i + 5) & 7]);
        b[i] = __vimax3_s32(b[i], a[(i + 3) & 7], a[(i + 6) & 7]);
      } else if constexpr (OP == kVimax3Relu) {
        a[i] = __vimax3_s32_relu(a[i], b[(i + 1) & 7], b[(i + 5) & 7]);
        b[i] = __vimax3_s32_relu(b[i], a[(i + 3) & 7], a[(i + 6) & 7]);
      } else {
        a[i] = __vimax_s32_relu(a[i], b[(i + 1) & 7]);
        b[i] = __vimax_s32_relu(b[i], a[(i + 3) & 7]);
      }
    }
  }
  T r = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) r += a[i] + b[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = (int)r;
}

template <int OP>
void launch(int* out, int blocks, int iters, cudaStream_t stream) {
  probe<OP><<<blocks, 256, 0, stream>>>(out, iters, 3);
}

}  // namespace

// Operations by index (see Op); blocks of 256 threads; out holds blocks x
// 256 ints. Returns cudaGetLastError() after the launch.
extern "C" int pipe_probe_ops(void) { return kNumOps; }

extern "C" int pipe_probe(int* out, int blocks, int iters, int op, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (op) {
    case kF32MinMax: launch<kF32MinMax>(out, blocks, iters, st); break;
    case kF32Add: launch<kF32Add>(out, blocks, iters, st); break;
    case kI32MinMax: launch<kI32MinMax>(out, blocks, iters, st); break;
    case kVimin3: launch<kVimin3>(out, blocks, iters, st); break;
    case kVimax3: launch<kVimax3>(out, blocks, iters, st); break;
    case kVimax3Relu: launch<kVimax3Relu>(out, blocks, iters, st); break;
    case kVimaxRelu: launch<kVimaxRelu>(out, blocks, iters, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
