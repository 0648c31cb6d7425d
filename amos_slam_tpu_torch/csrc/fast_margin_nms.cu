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
// polarity max_s min_arc fl(c - I) = fl(c - min_s max_arc I). The kernels
// reduce the raw circle values and subtract the centre twice, not 16
// times; the result is bit-exact against the plain PyTorch version
// (amos_slam_tpu_torch/ops/fast.py) for finite inputs.
// Keys (the persistent kernel). Each staged f32 with bits u becomes the
// int32 k = u ^ ((u >> 31) & 0x7fffffff): the identity on u >= 0, the
// reversal of the negatives' order below 0. Signed integer order on k is
// float order on the values, with -0 < +0 the one difference; the map is
// its own inverse. So min and max of keys select a value equal to the
// float min or max (of the two zeros, either one), and fl(+0 - c) =
// fl(-0 - c) up to the sign of a zero result, which the clamp at 0 makes a
// margin of 0 either way. The clamp itself is a signed max with 0 on the
// raw bits of the two differences: a negative float has negative bits.
// Margins are then >= +0 or the -inf of the NMS, whose bits are negative,
// so the NMS compares raw bits as signed integers. Equal values written
// as +0 or -0 are equal to torch.equal.
//
// Bound on this card (NVIDIA H100 80GB HBM3, 700 W). Bytes: each pixel
// inside an extent read once + the whole canvas written once. At the main
// path's pyramid (8, 480, 640) with the level extents of
// ORBConfig.level_sizes (950,532 of 2,457,600 pixels): 13.6 MB, 4.07 us at
// 3.35 TB/s; at multistream's (64, 480, 640) 8x that, 32.6 us, at a mesh
// group's (32, 480, 640) 16.3 us. Operations: OPS_PER_PIXEL
// (ops/kernels/fast_margin_nms.py) x the pixels read, 1.5 us at (8, 480,
// 640) at the published 67 TFLOP/s, so bytes bound it under the published
// rates. The issue rate is the other floor: nearly every instruction of
// the margins is a min or max, and f32 min/max, int32 min/max and the DPX
// three-input min/max each issue at ~60 lanes per clock per SM, half the
// f32 add rate (tools/time_fast_kernel.py --pipe-probe; each DPX call is
// one SASS instruction, VIMNMX3). With MINMAX_PER_MARGIN instructions for
// each of the 8.3 M margins at (64, 480, 640), that is 54.2 us for the
// tiles kernel's f32 reduction and 39.9 us for the persistent kernel's keys.
// Measured there: 86.2 us (tiles kernel 104.0 us); the persistent kernel
// without global memory traffic (FMN_ABLATE_STAGE, _ZERO, _STORE) takes
// 68.9 us, so the arithmetic and its barriers hold it, and memory adds
// the rest.
//
// Design. Two kernels over one (image, 32 x 64 tile) grid; the wrapper
// picks one by the number of tiles that intersect their image's extent
// ("active") against the persistent kernel's resident blocks (one wave).
//   * Tiles kernel (up to two waves of active tiles: the single route,
//     (8, 480, 640) and KITTI's (8, 376, 1241)). One block per entry of a
//     host-built table cached on the device, active tiles first, so they
//     are dispatched first: 512 active and 688 zero tiles at (8, 480, 640).
//     __launch_bounds__(256, 4) keeps registers at <= 64 per thread and a
//     block holds 21 KB of shared memory, so >= 4 blocks share an SM. An
//     active block stages the tile plus a 4-px halo (circle radius 3 + NMS
//     radius 1) in shared memory with 16-byte loads, row and column indices
//     wrapped by compare and add (x0 - 4 is a multiple of 4, so with
//     W % 4 == 0 a staged row is 18 aligned float4s; other widths take a
//     scalar path), computes margins over the tile plus a 1-px ring (-inf
//     outside H x W; skipped beyond the extent's own 1-px ring, which no
//     output reads), then the NMS, and writes 0 outside the extent. A zero
//     block loads nothing and writes 0 with 16-byte stores.
//   * Persistent kernel (more: the batched route, 4,096 active and 5,504
//     zero tiles at (64, 480, 640), 2,048 and 2,752 at (32, 480, 640)). One
//     wave of blocks (396: 3 per SM, 85 registers a thread, the margin loop
//     unrolled 4 rows deep), each walking its own list of tiles with their
//     extents, held in shared memory so that no step waits on a global load;
//     the host deals each block an equal share of the active tiles (largest
//     margin count first, in a snake over the blocks) and of the zero tiles,
//     spread between them. While a block computes one active tile, the next
//     one's halo is on its way: one TMA load completing on an mbarrier when
//     it needs no wrap (most tiles), cp.async with the compare-and-add wrap
//     otherwise. Margins reduce integer keys (see Keys) with three-input DPX
//     min/max, 36 instructions per polarity instead of 47, each thread down
//     one column of the tile so that loads and stores are conflict-free; the
//     NMS takes one three-input max per axis. The output tile and the zero
//     tiles leave through TMA stores from shared memory. Widths that are not
//     a multiple of 4 stage with cp.async and store with plain stores. At
//     (8, 480, 640) this kernel is 4% slower than the tiles kernel, at
//     KITTI's 772 active tiles (2 per block, little to overlap) 32%,
//     hence two waves.
//   * Both reduce fewer min/max than the plain version: the centre is
//     subtracted after the reduction (see Exactness), the arcs are reduced
//     in pairs (margin_at, margin_key), and the NMS is separable: each
//     thread takes 4 x 2 output pixels, a max of 3 along rows, then along
//     columns.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Variant switches, for the timing tool only
// (amos_slam_tpu_torch/tools/time_fast_kernel.py --variant NAME=-D...=1).
// The ablations skip a phase, to time what it costs; their output is wrong
// by design and is not checked. The others undo one design choice of the
// persistent kernel and stay exact: f32 min/max in place of the keys, and
// cp.async / plain stores in place of the TMA.
#ifndef FMN_ABLATE_MARGIN  // margin := the centre value
#define FMN_ABLATE_MARGIN 0
#endif
#ifndef FMN_ABLATE_STAGE   // no loads: the stage holds whatever shared memory held
#define FMN_ABLATE_STAGE 0
#endif
#ifndef FMN_ABLATE_ZERO    // zero tiles write nothing
#define FMN_ABLATE_ZERO 0
#endif
#ifndef FMN_ABLATE_STORE   // the persistent kernel's active tiles store nothing
#define FMN_ABLATE_STORE 0
#endif
#ifndef FMN_MINMAX_F32
#define FMN_MINMAX_F32 0
#endif
#ifndef FMN_TMA_LOAD       // TMA loads of halos that need no wrap (16-byte rows)
#define FMN_TMA_LOAD 1
#endif
#ifndef FMN_TMA_STORE      // TMA stores of output and zero tiles (16-byte rows)
#define FMN_TMA_STORE 1
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
constexpr int kNoMargin = INT32_MIN;       // below the bits of every margin >= +0
constexpr int kZeroRows = 8;               // rows of a zero tile per TMA store

static_assert(kThreads == kQuads * (kTileH / 2), "NMS takes 4 x 2 px per thread");
static_assert(kThreads == 4 * kTileW && kThreads - 2 * kTileW >= 2 * kMH,
              "margins: 4 row groups of 64 columns, the ring by the groups with 8 rows");
static_assert(kThreads >= 64 + kInW, "scalar staging: one thread per row/column index");

// v mod n by compare and add, no division (v lies within a tile of [0, n)).
__device__ __forceinline__ int wrap(int v, int n) {
  while (v < 0) v += n;
  while (v >= n) v -= n;
  return v;
}

// The order-preserving int32 key of an f32's bits, and back (see Keys).
__device__ __forceinline__ int key_of(int u) { return u ^ ((u >> 31) & 0x7fffffff); }

// FAST-9 margin of the pixel at s[r][c] (the circle lies within +-3).
//
// bright = max over the 16 arc starts k of min(v[k..k+8]). Arcs k and k+1
// (k even) share v[k+1..k+8], so by distributivity
//   max(min9[k], min9[k+1]) = min(min(v[k+1..k+8]), max(v[k], v[k+9])),
// and the 8-minima at odd starts come from pairs, then quads: 8 + 8 + 8
// for the 8-minima, 16 for the pairs of arcs, 7 for the max over them, 47
// min/max in all instead of 79. The dark polarity is the same with min and
// max exchanged.
__device__ __forceinline__ float margin_at(const float (*s)[kInW], int r, int c) {
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

// margin_at on keys (s holds key_of of the staged bits), returned as the
// bits of the f32 margin. Pairs (8) and quads (8) at odd starts; for each
// pair of arcs k, k+1 (k even) one three-input min of the two quads that
// make v[k+1..k+8] and max(v[k], v[k+9]) (8 + 8); the max over the 8 pairs
// in 4 three-input steps: 36 per polarity. With FMN_MINMAX_F32, s holds
// the raw bits and margin_at reduces them.
__device__ __forceinline__ int margin_key(const int (*s)[kInW], int r, int c) {
#if FMN_MINMAX_F32
  const float m = margin_at(reinterpret_cast<const float (*)[kInW]>(s), r, c);
  return __float_as_int(m);
#else
  const int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  int v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = s[r + dy[k]][c + dx[k]];
  const int ctr = s[r][c];

  int lo[8], hi[8];  // min / max of v[j], v[j + 1], j = 2i + 1
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j = 2 * i + 1;
    lo[i] = min(v[j], v[(j + 1) & 15]);
    hi[i] = max(v[j], v[(j + 1) & 15]);
  }
  int lq[8], hq[8];  // of v[j..j+3]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    lq[i] = min(lo[i], lo[(i + 1) & 7]);
    hq[i] = max(hi[i], hi[(i + 1) & 7]);
  }
  int a[8], d[8];    // arcs 2i and 2i + 1, each polarity
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = v[2 * i], f = v[(2 * i + 9) & 15];
    a[i] = __vimin3_s32(lq[i], lq[(i + 2) & 7], max(e, f));
    d[i] = __vimax3_s32(hq[i], hq[(i + 2) & 7], min(e, f));
  }
  int bright = __vimax3_s32(a[0], a[1], a[2]);
  int dark = __vimin3_s32(d[0], d[1], d[2]);
  bright = __vimax3_s32(bright, a[3], a[4]);
  dark = __vimin3_s32(dark, d[3], d[4]);
  bright = __vimax3_s32(bright, a[5], a[6]);
  dark = __vimin3_s32(dark, d[5], d[6]);
  bright = max(bright, a[7]);
  dark = min(dark, d[7]);
  const float fb = __int_as_float(key_of(bright)), fd = __int_as_float(key_of(dark));
  const float fc = __int_as_float(key_of(ctr));
  return __vimax_s32_relu(__float_as_int(fb - fc), __float_as_int(fc - fd));
#endif
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

// ---------------------------------------------------------------- persistent

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// At most N of this thread's newest commit groups still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The TMA unit stores a box of the tensor `map` at (x, y, b) from shared
// memory, in this thread's bulk group; the thread goes on at once.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* smem, int x,
                                          int y, int b) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      ::"l"(map), "r"(s), "r"(x), "r"(y), "r"(b) : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::); }

// This thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Shared memory written by threads is visible to the TMA unit after this
// fence and a barrier.
__device__ __forceinline__ void fence_to_bulk() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA load of a box of `map` at (x, y, b) into shared memory, completing
// on the mbarrier bar with its byte count.
__device__ __forceinline__ void tma_load(void* smem, const CUtensorMap* map, int x, int y, int b,
                                         unsigned long long* bar) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned m = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(s), "l"(map), "r"(x), "r"(y), "r"(b), "r"(m) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  const unsigned m = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(m), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar, int bytes) {
  const unsigned m = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(m), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int phase) {
  const unsigned m = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(m), "r"(phase) : "memory");
}

// The TMA unit's views of out, (W, H, B) f32 in boxes of a tile and of
// kZeroRows rows of one, and of in, in boxes of a staged tile.
struct TmaMaps {
  CUtensorMap tile, zero, in;
};

struct Canvas {
  const float* in;
  float* out;
  int H, W, tiles_x, vec;
};

// One entry of a block's list: image b, top-left pixel, the image's extent.
struct Tile {
  int b, y0, x0, hb, wb;
};

// Issue the copies of one tile plus its halo into s (no wait), wrapped over
// H x W by compare and add; 16 bytes each when vec (see the tiles kernel).
// With a map, a halo that needs no wrap is one TMA load completing on bar
// (returns true).
__device__ __forceinline__ bool stage_async(int (*s)[kInW], const Canvas& cv, const Tile& o,
                                            const CUtensorMap* map, unsigned long long* bar) {
#if !FMN_ABLATE_STAGE
  const float* img = cv.in + (size_t)o.b * cv.H * cv.W;
  if (map != nullptr && o.y0 >= kHalo && o.x0 >= kHalo && o.y0 + kTileH + kHalo <= cv.H &&
      o.x0 + kTileW + kHalo <= cv.W) {
    if (threadIdx.x == 0) {
      fence_to_bulk();  // after the threads' own accesses to s
      mbar_expect(bar, kInH * kInW * 4);
      tma_load(&s[0][0], map, o.x0 - kHalo, o.y0 - kHalo, o.b, bar);
    }
    return true;
  }
  if (cv.vec) {
    for (int i = threadIdx.x; i < kInH * kInW4; i += kThreads) {
      const int r = i / kInW4, q = i - r * kInW4;
      const int y = wrap(o.y0 - kHalo + r, cv.H), x = wrap(o.x0 - kHalo + 4 * q, cv.W);
      cp_async16(&s[r][4 * q], img + (size_t)y * cv.W + x);
    }
  } else {
    for (int i = threadIdx.x; i < kInH * kInW; i += kThreads) {
      const int r = i / kInW, c = i - r * kInW;
      const int y = wrap(o.y0 - kHalo + r, cv.H), x = wrap(o.x0 - kHalo + c, cv.W);
      cp_async4(&s[r][c], img + (size_t)y * cv.W + x);
    }
  }
#endif
  return false;
}

constexpr int kList = 128;  // list entries held in shared memory at a time

// A block's walk over its L list entries, kList of them at a time in shared
// memory, so that no step waits on a global load.
struct Walk {
  const int4* list;  // this block's L entries {b, tile in image, h_b, w_b}, b = -1: none
  int L, base;
  int4* s_list;
  const TmaMaps* maps;  // TMA stores, or null
  const float* s_zero;  // kZeroRows x kTileW zeros in shared memory

  // The next entry at or after i that is an active tile, or -1; the zero
  // tiles met on the way are written (stores in flight, no wait). Called by
  // every thread of the block alike.
  __device__ __forceinline__ int next_active(const Canvas& cv, int i, Tile* o) {
    for (; i < L; ++i) {
      if (i >= base + kList) {
        __syncthreads();
        base = i;
        if (threadIdx.x < kList && base + (int)threadIdx.x < L)
          s_list[threadIdx.x] = list[base + threadIdx.x];
        __syncthreads();
      }
      const int4 e = s_list[i - base];
      if (e.x < 0) continue;
      const int ty = e.y / cv.tiles_x;
      *o = {e.x, ty * kTileH, (e.y - ty * cv.tiles_x) * kTileW, e.z, e.w};
      if (o->y0 < o->hb && o->x0 < o->wb) return i;
#if !FMN_ABLATE_ZERO
      if (maps == nullptr) {
        zero_tile(cv.out, {o->b, o->y0, o->x0}, cv.H, cv.W, cv.vec);
      } else if (threadIdx.x == 0) {
        for (int r = 0; r < kTileH && o->y0 + r < cv.H; r += kZeroRows)
          tma_store(&maps->zero, s_zero, o->x0, o->y0 + r, o->b);
        bulk_commit();
      }
#endif
    }
    return -1;
  }
};

// One wave of blocks; block k walks entries k * L .. k * L + L - 1 of list,
// active and zero tiles in any order. Double-buffered: the next active
// tile's copies fly while the current one's margins are computed.
// 3 blocks of 256 threads per SM leave 85 registers a thread, so that the
// margin loop can run 4 rows at once (4 blocks and no unroll: 6% slower).
constexpr int kPersistentBlocksPerSM = 3;
constexpr int kMarginUnroll = 4;
__global__ void __launch_bounds__(kThreads, kPersistentBlocksPerSM)
fast_margin_nms_persistent_kernel(Canvas cv, const int4* __restrict__ list, int L,
                                  const __grid_constant__ TmaMaps maps) {
  __shared__ __align__(128) int s_in[2][kInH][kInW];
  __shared__ __align__(16) int s_m[kMH][kMStride];
  __shared__ int4 s_list[kList];
  __shared__ __align__(8) unsigned long long s_bar[2];  // TMA loads into s_in[0], s_in[1]
#if FMN_TMA_STORE
  __shared__ __align__(128) float s_out[kTileH][kTileW];
  __shared__ __align__(128) float s_zero[kZeroRows][kTileW];
#else
  float (*s_out)[kTileW] = nullptr;
  float (*s_zero)[kTileW] = nullptr;
#endif
  const bool tma = FMN_TMA_STORE && cv.vec;

  const int t = threadIdx.x;
  const CUtensorMap* in_map = FMN_TMA_LOAD && cv.vec ? &maps.in : nullptr;
  if (in_map != nullptr && t == 0) {
    mbar_init(&s_bar[0], 1);
    mbar_init(&s_bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int phase = 0;  // bit j: the parity of s_bar[j]'s next completion
#if FMN_TMA_STORE
  for (int i = t; i < kZeroRows * kTileW; i += kThreads) (&s_zero[0][0])[i] = 0.f;
  fence_to_bulk();
  __syncthreads();
#endif
  Walk walk{list + (size_t)blockIdx.x * L, L, -kList, s_list, tma ? &maps : nullptr,
            reinterpret_cast<const float*>(s_zero)};
  Tile cur_o, nxt_o;
  bool cur_tma = false, nxt_tma = false;
  int cur = walk.next_active(cv, 0, &cur_o);
  if (cur >= 0) cur_tma = stage_async(s_in[0], cv, cur_o, in_map, &s_bar[0]);
  cp_async_commit();
  for (int buf = 0; cur >= 0; buf ^= 1) {
    const int nxt = walk.next_active(cv, cur + 1, &nxt_o);
    if (nxt >= 0) nxt_tma = stage_async(s_in[buf ^ 1], cv, nxt_o, in_map, &s_bar[buf ^ 1]);
    cp_async_commit();
    cp_async_wait<1>();  // the current tile's copies have landed
    if (cur_tma) {
      mbar_wait(&s_bar[buf], (phase >> buf) & 1);
      phase ^= 1 << buf;
    }
    __syncthreads();

    int (*s)[kInW] = s_in[buf];
#if !FMN_MINMAX_F32
    for (int i = t; i < kInH * kInW4; i += kThreads) {  // bits -> keys, in place
      int4* p = reinterpret_cast<int4*>(&s[0][0]) + i;
      int4 k = *p;
      k.x = key_of(k.x);
      k.y = key_of(k.y);
      k.z = key_of(k.z);
      k.w = key_of(k.w);
      *p = k;
    }
    __syncthreads();
#endif

    const int b = cur_o.b, y0 = cur_o.y0, x0 = cur_o.x0, hb = cur_o.hb, wb = cur_o.wb;
    const int H = cv.H, W = cv.W;
    // margins over the tile plus a 1-px ring, as in the tiles kernel
    const int y_end = min(H, hb + 1), x_end = min(W, wb + 1);
    // thread t: margin column 1 + t % 64, rows t / 64, + 4, ... (9 rows for
    // the first 128 threads, 8 for the rest); then the ring's columns 0 and
    // 65, one margin each for 68 of the threads with 8 rows
    {
      const int c = 1 + (t & (kTileW - 1)), g = t >> 6;
      const int x = x0 - 1 + c;
      const bool x_in = x < x_end;
#pragma unroll kMarginUnroll
      for (int r = g; r < kMH; r += kThreads / kTileW) {
        const int y = y0 - 1 + r;
        int m = kNoMargin;
        if (x_in && y >= 0 && y < y_end)
          m = FMN_ABLATE_MARGIN ? s[r + 3][c + 3] : margin_key(s, r + 3, c + 3);
        s_m[r][c] = m;
      }
      const int k = t - 2 * kTileW;
      if (k >= 0 && k < 2 * kMH) {
        const int r = k >> 1, cr = (k & 1) * (kMW - 1);
        const int y = y0 - 1 + r, xr = x0 - 1 + cr;
        int m = kNoMargin;
        if (y >= 0 && y < y_end && xr >= 0 && xr < x_end)
          m = FMN_ABLATE_MARGIN ? s[r + 3][cr + 3] : margin_key(s, r + 3, cr + 3);
        s_m[r][cr] = m;
      }
    }
    if (tma && t == 0) bulk_wait_read();  // the last tile's store has read s_out
    __syncthreads();

    // NMS on the margins' bits, one three-input max per axis
    const int c0 = 4 * (t % kQuads), r0 = 2 * (t / kQuads);
    int hmax[4][4], ctr[2][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int4 a = *reinterpret_cast<const int4*>(&s_m[r0 + k][c0]);
      const int2 e = *reinterpret_cast<const int2*>(&s_m[r0 + k][c0 + 4]);
      const int v[6] = {a.x, a.y, a.z, a.w, e.x, e.y};
#pragma unroll
      for (int j = 0; j < 4; ++j) hmax[k][j] = __vimax3_s32(v[j], v[j + 1], v[j + 2]);
      if (k == 1 || k == 2) {
#pragma unroll
        for (int j = 0; j < 4; ++j) ctr[k - 1][j] = v[j + 1];
      }
    }
    float* dst = cv.out + (size_t)b * H * W;
    const int x = x0 + c0;
#pragma unroll
    for (int j2 = 0; j2 < 2; ++j2) {
      const int y = y0 + r0 + j2;
      if (y >= H) continue;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int mx = __vimax3_s32(hmax[j2][j], hmax[j2 + 1][j], hmax[j2 + 2][j]);
        const int c = ctr[j2][j];
        o[j] = (y < hb && x + j < wb && c >= mx) ? __int_as_float(c) : 0.0f;
      }
      if (FMN_ABLATE_STORE && o[0] != -1.0f) continue;  // keeps the NMS, stores nothing
      float* p = dst + (size_t)y * W + x;
      if (tma) {
        *reinterpret_cast<float4*>(&s_out[r0 + j2][c0]) = make_float4(o[0], o[1], o[2], o[3]);
      } else if (cv.vec) {
        if (x < W) *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (x + j < W) p[j] = o[j];
      }
    }
    if (tma) {
      fence_to_bulk();
      __syncthreads();
      if (t == 0) {
        tma_store(&maps.tile, &s_out[0][0], x0, y0, b);
        bulk_commit();
      }
    }
    cur = nxt;
    cur_o = nxt_o;
    cur_tma = nxt_tma;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (tma && t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The TMA views of in and out, (B, H, W) f32 each, W % 4 == 0, 16-byte aligned.
int encode_maps(TmaMaps* maps, const float* in, float* out, int B, int H, int W) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                             const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                             const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)H * W * 4};
  const cuuint32_t tile_box[3] = {kTileW, kTileH, 1}, zero_box[3] = {kTileW, kZeroRows, 1};
  const cuuint32_t in_box[3] = {kInW, kInH, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  CUtensorMap* targets[3] = {&maps->tile, &maps->zero, &maps->in};
  const cuuint32_t* boxes[3] = {tile_box, zero_box, in_box};
  void* bases[3] = {out, out, const_cast<float*>(in)};
  for (int i = 0; i < 3; ++i) {
    const CUresult r = encode(targets[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, bases[i], dims,
                              strides, boxes[i], unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

int is_vec(const float* in, const float* out, int W) {
  return W % 4 == 0 &&
         ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
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
  const int tiles_y = (H + kTileH - 1) / kTileH, tiles_x = (W + kTileW - 1) / kTileW;
  fast_margin_nms_kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      in, out, extents, tiles, n_active, H, W, tiles_y, tiles_x, is_vec(in, out, W));
  return (int)cudaGetLastError();
}

// The persistent kernel: grid blocks, block k walking entries k * L ..
// k * L + L - 1 of list (grid * L int4 {b, iy * tx + ix, h_b, w_b}: the
// tile's image, its index within the image's ty x tx grid of 32 x 64 tiles,
// and the image's extent as above; b = -1 for no tile), each tile of the
// batch exactly once; B images. Same buffers and return as
// fast_margin_nms_tiles_f32.
extern "C" int fast_margin_nms_persistent_f32(const float* in, float* out, const int* list,
                                              int L, int grid, int B, int H, int W,
                                              void* stream) {
  if (L <= 0 || grid <= 0 || B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const Canvas cv{in, out, H, W, (W + kTileW - 1) / kTileW, is_vec(in, out, W)};
  TmaMaps maps{};
  if ((FMN_TMA_STORE || FMN_TMA_LOAD) && cv.vec) {
    const int rc = encode_maps(&maps, in, out, B, H, W);
    if (rc != 0) return rc;
  }
  fast_margin_nms_persistent_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      cv, reinterpret_cast<const int4*>(list), L, maps);
  return (int)cudaGetLastError();
}

// Blocks of the persistent kernel that the current device holds at once
// (SMs x resident blocks per SM), or -(CUDA error).
extern "C" int fast_margin_nms_wave(void) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fast_margin_nms_persistent_kernel, kThreads, 0);
  return e == cudaSuccess ? sms * per_sm : -(int)e;
}
