// FAST-9 corner margin + 3x3 non-max suppression, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel amos_slam_tpu/ops/pallas/fast_pallas.py:
// _band_compute (:35), _kernel (:71), _kernel_batched (:90), _impl_single
// (:110), _impl_batched (:128), public entry fast_margin_nms (:174).
//
// Function. in (B, H, W) f32 -> out (B, H, W) f32, per image
//   out = nms3x3(fast_margin(img))
// with the XLA semantics of amos_slam_tpu/ops/fast.py: the 16 circle reads
// wrap around both axes (jnp.roll), and the 3x3 NMS sees pixels outside the
// image as -inf (reduce_window "SAME"). Every operation is a subtraction,
// min or max, so the result is bit-exact against the plain PyTorch version
// (amos_slam_tpu_torch/ops/fast.py). This is not the Pallas kernel's own
// contract, which zero-fills its row halo and so differs in a 5-px frame
// (tests/test_fast_pallas_interpret.py); that frame lies inside
// ORBConfig.border = 19 and is masked by keypoint selection either way.
//
// Design. One block of 256 threads per (image, 32 x 64 output tile):
//   1. stage the tile plus a 4-px halo (circle radius 3 + NMS radius 1) in
//      shared memory, with wrapped row/column indices;
//   2. compute the margin over the tile plus a 1-px ring into shared memory
//      (-inf for ring pixels outside the image);
//   3. NMS from shared memory and write the tile.
// The arc minimum over 9 consecutive differences is built from pairwise
// minima (2, 4, 8, then +1), 4 min per arc start instead of 8, and the dark
// polarity is -(min over starts of the max over the arc) of the same
// differences, so no negation is materialised.
//
// Bound on this card. Bytes: one f32 read and one f32 write per pixel,
// 8 B/px; at (8, 480, 640) that is 19.7 MB, 5.9 us at 3.35 TB/s.
// Operations: 188 f32 sub/min/max/neg/select per pixel (OPS_PER_PIXEL in
// ops/kernels/fast_margin_nms.py), 462 Mop at (8, 480, 640), 6.9 us at the
// 67 TFLOP/s f32 rate: the kernel is compute-bound. The tile re-reads its
// halo (40 x 72 staged for 32 x 64 written) from L2, not from device memory.
// About 60% of the stacked pyramid's pixels are zero padding beyond each
// level's extent; skipping them is left to a later change.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kHalo = 4;
constexpr int kInH = kTileH + 2 * kHalo;   // 40
constexpr int kInW = kTileW + 2 * kHalo;   // 72
constexpr int kMH = kTileH + 2;            // 34
constexpr int kMW = kTileW + 2;            // 66
constexpr int kThreads = 256;

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// FAST-9 margin of the pixel at s[r][c] (the circle lies within +-3).
__device__ __forceinline__ float margin_at(float (*s)[kInW], int r, int c) {
  const int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const float ctr = s[r][c];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = s[r + dy[k]][c + dx[k]] - ctr;

  // bright: max_s min_{j<9} d[s+j]; dark: max_s min_j (-d) = -(min_s max_j d)
  float lo2[16], hi2[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo2[k] = fminf(d[k], d[(k + 1) & 15]);
    hi2[k] = fmaxf(d[k], d[(k + 1) & 15]);
  }
  float lo4[16], hi4[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo4[k] = fminf(lo2[k], lo2[(k + 2) & 15]);
    hi4[k] = fmaxf(hi2[k], hi2[(k + 2) & 15]);
  }
  float bright = -INFINITY, dark_neg = INFINITY;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    bright = fmaxf(bright, fminf(fminf(lo4[k], lo4[(k + 4) & 15]), d[(k + 8) & 15]));
    dark_neg = fminf(dark_neg, fmaxf(fmaxf(hi4[k], hi4[(k + 4) & 15]), d[(k + 8) & 15]));
  }
  return fmaxf(fmaxf(bright, -dark_neg), 0.0f);
}

__global__ void __launch_bounds__(kThreads)
fast_margin_nms_kernel(const float* __restrict__ in, float* __restrict__ out,
                       int H, int W) {
  __shared__ float s_in[kInH][kInW];
  __shared__ float s_m[kMH][kMW];

  const size_t plane = (size_t)H * W;
  const float* img = in + blockIdx.z * plane;
  float* dst = out + blockIdx.z * plane;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;

  for (int i = threadIdx.x; i < kInH * kInW; i += kThreads) {
    const int r = i / kInW, c = i % kInW;
    const int y = wrap(y0 - kHalo + r, H), x = wrap(x0 - kHalo + c, W);
    s_in[r][c] = img[(size_t)y * W + x];
  }
  __syncthreads();

  // s_m[r][c] is image pixel (y0 - 1 + r, x0 - 1 + c), centred on
  // s_in[r + 3][c + 3].
  for (int i = threadIdx.x; i < kMH * kMW; i += kThreads) {
    const int r = i / kMW, c = i % kMW;
    const int y = y0 - 1 + r, x = x0 - 1 + c;
    float m = -INFINITY;
    if (y >= 0 && y < H && x >= 0 && x < W) m = margin_at(s_in, r + 3, c + 3);
    s_m[r][c] = m;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int r = i / kTileW, c = i % kTileW;
    const int y = y0 + r, x = x0 + c;
    if (y >= H || x >= W) continue;
    const float ctr = s_m[r + 1][c + 1];
    float nb = fmaxf(fmaxf(s_m[r][c], s_m[r][c + 1]), s_m[r][c + 2]);
    nb = fmaxf(nb, fmaxf(s_m[r + 1][c], s_m[r + 1][c + 2]));
    nb = fmaxf(nb, fmaxf(fmaxf(s_m[r + 2][c], s_m[r + 2][c + 1]), s_m[r + 2][c + 2]));
    dst[(size_t)y * W + x] = ctr >= nb ? ctr : 0.0f;
  }
}

}  // namespace

// in, out: (B, H, W) f32 contiguous device buffers; stream: a cudaStream_t.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fast_margin_nms_f32(const float* in, float* out, int B, int H,
                                   int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  fast_margin_nms_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(in, out, H, W);
  return (int)cudaGetLastError();
}
