// FAST-9 corner margin + 3x3 non-max suppression, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel amos_slam_tpu/ops/pallas/fast_pallas.py:
// _band_compute (:35), _kernel (:71), _kernel_batched (:90), _impl_single
// (:110), _impl_batched (:128), public entry fast_margin_nms (:174).
//
// Function. in (B, H, W) f32 and the extents (h_b, w_b) of each image ->
// out (B, H, W) f32 with
//   out[b, y, x] = nms3x3(fast_margin(in[b]))[y, x]   if y < h_b and x < w_b
//                = 0                                   otherwise,
// with the XLA semantics of amos_slam_tpu/ops/fast.py over the whole H x W
// canvas: the 16 circle reads wrap around both axes (jnp.roll), and the 3x3
// NMS sees pixels outside H x W as -inf (reduce_window "SAME"). Without
// extents, (h_b, w_b) = (H, W). This is not the Pallas kernel's own
// contract, which zero-fills its row halo and so differs in a 5-px frame
// (tests/test_fast_pallas_interpret.py); that frame lies inside
// ORBConfig.border = 19 and is masked by keypoint selection either way.
//
// Exactness. The plain version takes d_k = fl(I_k - c) and reduces with
// min and max. fl(a - c) is non-decreasing in a, so it commutes with min and
// max: max_s min_arc fl(I - c) = fl(max_s min_arc I - c), and the dark
// polarity max_s min_arc fl(c - I) = fl(c - min_s max_arc I). The kernel
// reduces the raw circle values and subtracts the centre twice, not 16
// times; the result is bit-exact against the plain PyTorch version
// (amos_slam_tpu_torch/ops/fast.py) for finite inputs.
//
// Bound on this card, at the main path's pyramid (8, 480, 640) with the
// level extents of ORBConfig.level_sizes (950,532 of 2,457,600 pixels):
// bytes = each pixel inside an extent read once (3.8 MB) + the whole
// canvas written once (9.8 MB) = 13.6 MB, 4.07 us at 3.35 TB/s.
// Operations = OPS_PER_PIXEL (105, ops/kernels/fast_margin_nms.py) x
// 950,532 = 99.8 Mop: 1.5 us at the published 67 TFLOP/s, which counts an
// FMA as two. Bytes bound it under the published rates. In practice the
// arithmetic does: 102 of the 105 operations are f32 min/max, which an H100
// SM issues at 64 lanes per clock, half its f32 add rate (measured with
// amos_slam_tpu_torch/tools/time_fast_kernel.py --pipe-probe), so the ~1.04 M margins that the
// active tiles compute take ~6 us at 1.98 GHz, and a back-to-back launch
// of ~1,000 blocks costs ~2.6 us by itself.
//
// Design.
//   * Work only where it is read. The host lists the (image, 32 x 64 tile)
//     pairs once per (extents, canvas) in a device table: first the tiles
//     that intersect their image's extent ("active"), then the rest ("zero
//     tiles"). One block per table entry, active blocks first, so they are
//     dispatched first: 512 active and 688 zero tiles on the main path.
//   * An active block stages the tile plus a 4-px halo (circle radius 3 +
//     NMS radius 1) in shared memory, computes margins over the tile plus
//     a 1-px ring (-inf outside H x W; skipped beyond the extent's own
//     1-px ring, which no output reads), then the NMS, and writes 0 outside
//     the extent. A zero block loads nothing and writes 0 with 16-byte
//     stores.
//   * Staging without division: 16-byte loads, row and column indices
//     wrapped by compare and add. x0 - 4 is a multiple of 4, so with
//     W % 4 == 0 a staged row is 18 aligned float4s, wrapped or not; other
//     widths take a scalar path through wrapped index tables. (cp.async,
//     in one stage or in two overlapped with the margins, measured no
//     faster than these loads.)
//   * One wave. __launch_bounds__(256, 4) keeps registers at <= 64 per
//     thread and a block holds 21 KB of shared memory, so >= 4 blocks share
//     an SM: >= 528 resident blocks for the 512 active tiles.
//   * Fewer min/max. The centre is subtracted after the reduction (see
//     Exactness), the arcs are reduced in pairs (margin_at), and the NMS is
//     separable: each thread takes 4 x 2 output pixels, a max of 3 along
//     rows, then along columns, and writes each row as one float4.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Ablation switches, all 0 in the package's build: the timing tool
// (amos_slam_tpu_torch/tools/time_fast_kernel.py --variant NAME=-D...=1)
// builds variants that skip a phase, to time what each phase costs. Their
// output is wrong by design and is not checked.
#ifndef FMN_ABLATE_MARGIN  // margin := the centre value
#define FMN_ABLATE_MARGIN 0
#endif
#ifndef FMN_ABLATE_STAGE   // no loads: s_in holds whatever shared memory held
#define FMN_ABLATE_STAGE 0
#endif
#ifndef FMN_ABLATE_ZERO    // zero tiles write nothing
#define FMN_ABLATE_ZERO 0
#endif

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kHalo = 4;
constexpr int kInH = kTileH + 2 * kHalo;   // 40
constexpr int kInW = kTileW + 2 * kHalo;   // 72
constexpr int kInW4 = kInW / 4;            // 18 float4 per staged row
constexpr int kMH = kTileH + 2;            // 34
constexpr int kMW = kTileW + 2;            // 66
constexpr int kMStride = 68;               // 16-byte aligned margin rows
constexpr int kThreads = 256;
constexpr int kMinBlocksPerSM = 4;
constexpr int kQuads = kTileW / 4;         // 16 float4 per output row

static_assert(kThreads == kQuads * (kTileH / 2), "NMS takes 4 x 2 px per thread");
static_assert(kThreads >= 64 + kInW, "scalar staging: one thread per row/column index");

// v mod n by compare and add, no division (v lies within a tile of [0, n)).
__device__ __forceinline__ int wrap(int v, int n) {
  while (v < 0) v += n;
  while (v >= n) v -= n;
  return v;
}

// FAST-9 margin of the pixel at s[r][c] (the circle lies within +-3).
//
// bright = max over the 16 arc starts k of min(v[k..k+8]). Arcs k and k+1
// (k even) share v[k+1..k+8], so by distributivity
//   max(min9[k], min9[k+1]) = min(min(v[k+1..k+8]), max(v[k], v[k+9])),
// and the 8-minima at odd starts come from pairs, then quads: 8 + 8 + 8
// for the 8-minima, 16 for the pairs of arcs, 7 for the max over them, 47
// min/max in all instead of 79. The dark polarity is the same with min and
// max exchanged.
__device__ __forceinline__ float margin_at(float (*s)[kInW], int r, int c) {
  const int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  float v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = s[r + dy[k]][c + dx[k]];
  const float ctr = s[r][c];

  // lo[i], hi[i]: min and max of v[j..j+7], j = 2i + 1 (odd starts)
  float lo[8], hi[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j = 2 * i + 1;
    lo[i] = fminf(v[j], v[(j + 1) & 15]);
    hi[i] = fmaxf(v[j], v[(j + 1) & 15]);
  }
  float lo4[8], hi4[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    lo4[i] = fminf(lo[i], lo[(i + 1) & 7]);
    hi4[i] = fmaxf(hi[i], hi[(i + 1) & 7]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    lo[i] = fminf(lo4[i], lo4[(i + 2) & 7]);
    hi[i] = fmaxf(hi4[i], hi4[(i + 2) & 7]);
  }
  float bright = -INFINITY, dark = INFINITY;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = 2 * i;  // arcs k and k+1
    bright = fmaxf(bright, fminf(lo[i], fmaxf(v[k], v[(k + 9) & 15])));
    dark = fminf(dark, fmaxf(hi[i], fminf(v[k], v[(k + 9) & 15])));
  }
  return fmaxf(fmaxf(bright - ctr, ctr - dark), 0.0f);
}

struct TileOrigin {
  int b, y0, x0;
};

// Tile index b * ty * tx + iy * tx + ix -> image and top-left pixel.
__device__ __forceinline__ TileOrigin tile_origin(int tile, int tiles_y, int tiles_x) {
  const int per_image = tiles_y * tiles_x;
  const int b = tile / per_image;
  const int tyx = tile - b * per_image;
  const int ty = tyx / tiles_x;
  return {b, ty * kTileH, (tyx - ty * tiles_x) * kTileW};
}

// Write 0 over one tile (clipped to H x W), 16 bytes per store when vec.
__device__ __forceinline__ void zero_tile(float* out, TileOrigin o, int H, int W, int vec) {
  float* dst = out + (size_t)o.b * H * W;
  for (int i = threadIdx.x; i < kTileH * kQuads; i += kThreads) {
    const int y = o.y0 + i / kQuads, x = o.x0 + 4 * (i % kQuads);
    if (y >= H) continue;
    float* p = dst + (size_t)y * W + x;
    if (vec) {
      if (x < W) *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int j = 0; j < 4 && x + j < W; ++j) p[j] = 0.f;
    }
  }
}

// One block per entry of tiles: the first n_active are active tiles, the
// rest zero tiles.
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
fast_margin_nms_kernel(const float* __restrict__ in, float* __restrict__ out,
                       const int* __restrict__ extents, const int* __restrict__ tiles,
                       int n_active, int H, int W, int tiles_y, int tiles_x, int vec) {
  __shared__ __align__(16) float s_in[kInH][kInW];
  __shared__ __align__(16) float s_m[kMH][kMStride];
  __shared__ int s_row[kInH];
  __shared__ int s_col[kInW];

  const int t = threadIdx.x;
  if ((int)blockIdx.x >= n_active) {
#if !FMN_ABLATE_ZERO
    zero_tile(out, tile_origin(tiles[blockIdx.x], tiles_y, tiles_x), H, W, vec);
#endif
    return;
  }

  const TileOrigin o = tile_origin(tiles[blockIdx.x], tiles_y, tiles_x);
  const int b = o.b, y0 = o.y0, x0 = o.x0;
  const size_t plane = (size_t)H * W;
  float* dst = out + b * plane;

  const int hb = extents ? extents[2 * b] : H;
  const int wb = extents ? extents[2 * b + 1] : W;
  const float* img = in + b * plane;

  // 1. stage the tile plus its halo, wrapped over H x W by compare and add.
  // With W % 4 == 0 every staged float4 (x0 - 4 + 4q, a multiple of 4) is
  // an aligned float4 of the image after the wrap as well.
#if !FMN_ABLATE_STAGE
  if (vec) {
    for (int i = t; i < kInH * kInW4; i += kThreads) {
      const int r = i / kInW4, q = i - r * kInW4;
      const int y = wrap(y0 - kHalo + r, H), x = wrap(x0 - kHalo + 4 * q, W);
      *reinterpret_cast<float4*>(&s_in[r][4 * q]) =
          __ldg(reinterpret_cast<const float4*>(img + (size_t)y * W + x));
    }
  } else {
    if (t < kInH) {
      s_row[t] = wrap(y0 - kHalo + t, H) * W;
    } else if (t >= 64 && t < 64 + kInW) {
      s_col[t - 64] = wrap(x0 - kHalo + t - 64, W);
    }
    __syncthreads();
    for (int i = t; i < kInH * kInW; i += kThreads) {
      const int r = i / kInW, c = i - r * kInW;
      s_in[r][c] = img[s_row[r] + s_col[c]];
    }
  }
#endif
  __syncthreads();

  // 2. margins over the tile plus a 1-px ring: s_m[r][c] is pixel
  // (y0 - 1 + r, x0 - 1 + c), centred on s_in[r + 3][c + 3]. Pixels beyond
  // the extent's ring are read by no output and left at -inf.
  const int y_end = min(H, hb + 1), x_end = min(W, wb + 1);
  for (int i = t; i < kMH * kMW; i += kThreads) {
    const int r = i / kMW, c = i - r * kMW;
    const int y = y0 - 1 + r, x = x0 - 1 + c;
    float m = -INFINITY;
    if (y >= 0 && y < y_end && x >= 0 && x < x_end)
      m = FMN_ABLATE_MARGIN ? s_in[r + 3][c + 3] : margin_at(s_in, r + 3, c + 3);
    s_m[r][c] = m;
  }
  __syncthreads();

  // 3. NMS: output columns c0..c0+3 of rows r0, r0+1 from margin rows
  // r0..r0+3 and columns c0..c0+5.
  const int c0 = 4 * (t % kQuads), r0 = 2 * (t / kQuads);
  float hmax[4][4], ctr[2][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&s_m[r0 + k][c0]);
    const float2 e = *reinterpret_cast<const float2*>(&s_m[r0 + k][c0 + 4]);
    const float v[6] = {a.x, a.y, a.z, a.w, e.x, e.y};
#pragma unroll
    for (int j = 0; j < 4; ++j) hmax[k][j] = fmaxf(v[j], fmaxf(v[j + 1], v[j + 2]));
    if (k == 1 || k == 2) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ctr[k - 1][j] = v[j + 1];
    }
  }
  const int x = x0 + c0;
#pragma unroll
  for (int j2 = 0; j2 < 2; ++j2) {
    const int y = y0 + r0 + j2;
    if (y >= H) continue;
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float mid = fmaxf(hmax[1][j], hmax[2][j]);
      const float mx = fmaxf(mid, hmax[j2 == 0 ? 0 : 3][j]);
      const float c = ctr[j2][j];
      o[j] = (y < hb && x + j < wb && c >= mx) ? c : 0.0f;
    }
    float* p = dst + (size_t)y * W + x;
    if (vec) {
      if (x < W) *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (x + j < W) p[j] = o[j];
    }
  }
}

}  // namespace

// in, out: (B, H, W) f32 contiguous device buffers. extents: (B, 2) int32
// device buffer of (h_b, w_b) with 1 <= h_b <= H, 1 <= w_b <= W, or null for
// the whole canvas. tiles: n_tiles int32 tile indices b * ty * tx + iy * tx
// + ix over the ty x tx grid of 32 x 64 tiles, the first n_active of them
// intersecting their image's extent, the rest wholly outside it; every tile
// of the batch appears once. H * W < 2^31. stream: a cudaStream_t.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fast_margin_nms_tiles_f32(const float* in, float* out, const int* extents,
                                         const int* tiles, int n_active, int n_tiles,
                                         int H, int W, void* stream) {
  if (n_tiles <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const int vec = W % 4 == 0 &&
                  ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int tiles_y = (H + kTileH - 1) / kTileH, tiles_x = (W + kTileW - 1) / kTileW;
  fast_margin_nms_kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      in, out, extents, tiles, n_active, H, W, tiles_y, tiles_x, vec);
  return (int)cudaGetLastError();
}
