// Kernel K3: the windowed ("banded") affine mask warp fused with the
// winner-takes-last composition, for large maps (512x1024).
//
// Replaces: c2m_tpu/ops/pallas/maskwarp_banded.py, _call (:110) with body
// _kernel (:69) and the host-side plan_windows (:142), together with the
// lax.cond gather fallback and the winner reduction around it in
// c2m_tpu/ops/raster.py:308-330. It computes exactly what K2 (maskwarp.cu)
// computes: winner [B, T, H, W] int32, the last valid node whose warped mask
// covers the pixel; the warped stack [B, N, T, H, W] is never written.
//
// What carries over from the TPU kernel is its idea: an output tile can only
// touch a small window of the source map, because the source coordinates
// are affine in the output pixel, so their extremes over a tile sit at the
// tile's corners (+-1 for the bilinear support). The MXU hat contraction,
// the factored row/column plan in SMEM and the four BlockSpec quadrants are
// not copied, nor is its staging of the map's window: a GPU gathers.
//
// What bounds it on the H100: operations, as K2 (it writes 4 bytes per pixel
// and reads a 2 MB map from L2): ~30 float operations and 4 cached loads per
// (pixel, node) that the tile's window lets through, one compare per
// (source pixel, node) for the boxes, and ~60 operations per (tile, node)
// for the windows. On the long-horizon maps only 4.4% of (tile, node) pairs
// are live. The first version of this kernel gave each (b, t, 16x32 tile) a
// block of 512 threads (40,960 blocks at B = 4): the block planned every
// node, then staged each live node's region of the map in shared memory
// behind two barriers. A block is a chain of dependent global loads and
// barriers, and two of them fit on an SM, so the SMs mostly waited: 0.75
// ms at B = 4, where the taps themselves are ~0.07 ms of issue. Staging the
// live tiles alone, from a list made by a plan pass, still took 0.52 ms.
// This version gives a tile to a warp and has no barrier at all:
//
// 0. a memset: the boxes to NOWHERE.
// 1. node_boxes_kernel: the bounding box of `instance == id` for every valid
//    node, [B, N, 4] as (min y, -max y, min x, -max x) so that one atomicMin
//    serves all four; a node that is nowhere on the map keeps NOWHERE.
//    Exact integer arithmetic.
// 2. warp_masks_tiles_kernel: a warp per (b, t, 16x32 tile), 8 tiles a
//    block, so that ~24 tiles are in flight on an SM and their loads
//    overlap.
//    a. Plan: lane n evaluates node n's affine at the tile's four corners
//       (in rounds of 32 nodes) -> the source window, clipped to the image,
//       met with the node's box: the same float32 operations as the first
//       version, so the same verdicts (source_windows_plain in
//       ops/hopper/maskwarp_banded.py repeats them). A ballot makes the
//       round's live-node bits (tile_masks_plain there).
//    b. Visit: for each live node in node order (the last covered node
//       wins), its affine, id and box come from the planning lane by
//       shuffles, and each lane samples its 4x4 pixels of the tile: four
//       taps, a tap outside the node's box is 0 without a load, any other
//       reads the map through the read-only cache (neighbouring lanes read
//       neighbouring pixels). A tile with no live node does no sampling.
//    c. Each lane stores its 4 rows of 4 winners as 16-byte pieces.
//
// Times (NVIDIA H100 80GB HBM3, 700 W; kernel_ab.py, device alone, in turns
// with the first version): GNN-like thetas at [4,24,10,512,1024] 0.196 ms
// (first version 0.772), the box pass 0.024 of it; [1,...] 0.069 (0.203).
//
// The sampling arithmetic is written term for term as maskwarp.cu:44-72 and
// the library is built with -fmad=false, so K3 == K2 == the plain version.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int TILE_H = 16;
constexpr int TILE_W = 32;
constexpr int WARPS = 8;          // tiles per block
constexpr int PIX = 4;            // a lane's pixels: PIX rows x PIX columns
constexpr int BOX_THREADS = 256;
constexpr int BOX_PIXELS = 4;     // source pixels per thread of the box pass
constexpr int NOWHERE = 0x7f7f7f7f;   // a box slot no pixel lowered (memset 0x7f)
constexpr unsigned FULL = 0xffffffffu;

// Lower a shared minimum; the unsynchronised read only saves atomics (the
// value never rises, so a stale read can at worst issue one that is not
// needed).
__device__ __forceinline__ void lower(int* slot, int v) {
  if (v < *reinterpret_cast<volatile int*>(slot)) atomicMin(slot, v);
}

__global__ void __launch_bounds__(BOX_THREADS) node_boxes_kernel(
    const float* __restrict__ instance,   // [B, H, W]
    const float* __restrict__ ids,        // [B, N]
    const int* __restrict__ valid,        // [B, N]
    int* __restrict__ boxes,              // [B, N, 4], filled with NOWHERE
    long long N, long long H, long long W) {
  extern __shared__ int box_smem[];
  int* sbox = box_smem;                                     // [N, 4]
  float* sid = reinterpret_cast<float*>(box_smem + 4 * N);  // [N]
  long long b = blockIdx.y;
  int tid = threadIdx.x;
  for (long long k = tid; k < 4 * N; k += BOX_THREADS) sbox[k] = NOWHERE;
  // an invalid node matches nothing (NaN != everything)
  for (long long n = tid; n < N; n += BOX_THREADS)
    sid[n] = valid[b * N + n] ? ids[b * N + n] : __int_as_float(0x7fc00000);
  __syncthreads();

  const float* inst = instance + b * H * W;
  long long first = (long long)blockIdx.x * BOX_THREADS * BOX_PIXELS + tid;
  for (int j = 0; j < BOX_PIXELS; ++j) {
    long long i = first + (long long)j * BOX_THREADS;
    if (i >= H * W) break;
    float v = inst[i];
    int y = (int)(i / W), x = (int)(i % W);
    for (long long n = 0; n < N; ++n) {
      if (v != sid[n]) continue;
      lower(sbox + 4 * n + 0, y);
      lower(sbox + 4 * n + 1, -y);
      lower(sbox + 4 * n + 2, x);
      lower(sbox + 4 * n + 3, -x);
    }
  }
  __syncthreads();
  for (long long k = tid; k < 4 * N; k += BOX_THREADS)
    if (sbox[k] != NOWHERE) atomicMin(boxes + b * 4 * N + k, sbox[k]);
}

// Source coordinate of one axis: ((g + 1) * size - 1) / 2 with g the affine
// row applied to the align_corners=False base coordinates (bx, by).
__device__ __forceinline__ float source_coord(float a, float b, float c,
                                              float bx, float by, float size) {
  float g = a * bx + b * by + c;
  return ((g + 1.0f) * size - 1.0f) * 0.5f;
}

// A (b, t, tile)'s corner pixels (clipped to the image) as base coordinates.
struct Corners {
  float bx[2], by[2];
};

__device__ __forceinline__ Corners corners_of(long long tile_y,
                                              long long tile_x, long long H,
                                              long long W) {
  float fw = (float)W, fh = (float)H;
  long long cx0 = tile_x * TILE_W, cy0 = tile_y * TILE_H;
  long long cx1 = cx0 + TILE_W - 1 < W - 1 ? cx0 + TILE_W - 1 : W - 1;
  long long cy1 = cy0 + TILE_H - 1 < H - 1 ? cy0 + TILE_H - 1 : H - 1;
  Corners c;
  c.bx[0] = (2.0f * (float)cx0 + 1.0f) / fw - 1.0f;
  c.bx[1] = (2.0f * (float)cx1 + 1.0f) / fw - 1.0f;
  c.by[0] = (2.0f * (float)cy0 + 1.0f) / fh - 1.0f;
  c.by[1] = (2.0f * (float)cy1 + 1.0f) / fh - 1.0f;
  return c;
}

// The verdict for one (tile, node): the node's source window over the tile
// met with its box. Returns whether anything is left; fills the box.
__device__ __forceinline__ bool plan_node(const float* th, const int* box,
                                          const Corners& c, float fw,
                                          float fh, int* pbox) {
  if (box[0] == NOWHERE) return false;     // nowhere on the map
  float sx_lo = source_coord(th[0], th[1], th[2], c.bx[0], c.by[0], fw);
  float sy_lo = source_coord(th[3], th[4], th[5], c.bx[0], c.by[0], fh);
  float sx_hi = sx_lo, sy_hi = sy_lo;
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    float sxk = source_coord(th[0], th[1], th[2], c.bx[k & 1], c.by[k >> 1],
                             fw);
    float syk = source_coord(th[3], th[4], th[5], c.bx[k & 1], c.by[k >> 1],
                             fh);
    sx_lo = fminf(sx_lo, sxk);
    sx_hi = fmaxf(sx_hi, sxk);
    sy_lo = fminf(sy_lo, syk);
    sy_hi = fmaxf(sy_hi, syk);
  }
  // fmaxf/fminf drop a NaN operand: a NaN span becomes the whole axis
  float xlo = fmaxf(floorf(sx_lo) - 1.0f, 0.0f);
  float xhi = fminf(ceilf(sx_hi) + 1.0f, fw - 1.0f);
  float ylo = fmaxf(floorf(sy_lo) - 1.0f, 0.0f);
  float yhi = fminf(ceilf(sy_hi) + 1.0f, fh - 1.0f);
  if (!(xlo <= xhi && ylo <= yhi)) return false;   // wholly off the image
  pbox[0] = box[0];
  pbox[1] = -box[1];
  pbox[2] = box[2];
  pbox[3] = -box[3];
  return max((int)ylo, pbox[0]) <= min((int)yhi, pbox[1]) &&
         max((int)xlo, pbox[2]) <= min((int)xhi, pbox[3]);
}

// At most 80 registers, so that three blocks (24 tiles) share an SM: left
// alone the compiler takes 162 and one block, 0.34 ms at B = 4 against 0.20;
// 64 registers spill and lose at B = 1.
__global__ void __launch_bounds__(WARPS * 32, 3) warp_masks_tiles_kernel(
    const float* __restrict__ instance,   // [B, H, W]
    const float* __restrict__ ids,        // [B, N]
    const int* __restrict__ valid,        // [B, N]
    const float* __restrict__ thetas,     // [B, N, T, 6]
    const int* __restrict__ boxes,        // [B, N, 4] from node_boxes_kernel
    int* __restrict__ winner,             // [B, T, H, W]
    long long N, long long T, long long H, long long W, long long tiles_y,
    long long tiles_x, long long tiles, float thr) {
  int lane = threadIdx.x & 31;
  long long tile = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (tile >= tiles) return;               // the whole warp leaves together
  long long tile_x = tile % tiles_x;
  long long tile_y = (tile / tiles_x) % tiles_y;
  long long t = (tile / (tiles_x * tiles_y)) % T;
  long long b = tile / (tiles_x * tiles_y * T);
  Corners c = corners_of(tile_y, tile_x, H, W);
  float fw = (float)W, fh = (float)H;
  // this lane's pixels: rows py + i, columns px + j, i, j < PIX, and their
  // align_corners=False base coordinates
  long long px = tile_x * TILE_W + (lane % (TILE_W / PIX)) * PIX;
  long long py = tile_y * TILE_H + (lane / (TILE_W / PIX)) * PIX;
  float bx[PIX], by[PIX];
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    bx[k] = (2.0f * (float)(px + k) + 1.0f) / fw - 1.0f;
    by[k] = (2.0f * (float)(py + k) + 1.0f) / fh - 1.0f;
  }
  const float* inst = instance + b * H * W;
  int res[PIX * PIX];
#pragma unroll
  for (int k = 0; k < PIX * PIX; ++k) res[k] = 0;

  for (long long base = 0; base < N; base += 32) {
    // a. plan: lane n holds node base + n's affine, id and box
    long long n = base + lane;
    float th[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float id = 0.0f;
    int pbox[4] = {0, 0, 0, 0};
    bool live = false;
    if (n < N && valid[b * N + n]) {
      const float* src = thetas + ((b * N + n) * T + t) * 6;
#pragma unroll
      for (int k = 0; k < 6; ++k) th[k] = src[k];
      id = ids[b * N + n];
      live = plan_node(th, boxes + (b * N + n) * 4, c, fw, fh, pbox);
    }
    unsigned word = __ballot_sync(FULL, live);
    // b. visit the live nodes in order
    while (word) {
      int q = __ffs(word) - 1;
      word &= word - 1;
      float t0 = __shfl_sync(FULL, th[0], q), t1 = __shfl_sync(FULL, th[1], q);
      float t2 = __shfl_sync(FULL, th[2], q), t3 = __shfl_sync(FULL, th[3], q);
      float t4 = __shfl_sync(FULL, th[4], q), t5 = __shfl_sync(FULL, th[5], q);
      float qid = __shfl_sync(FULL, id, q);
      int y_lo = __shfl_sync(FULL, pbox[0], q), y_hi = __shfl_sync(FULL, pbox[1], q);
      int x_lo = __shfl_sync(FULL, pbox[2], q), x_hi = __shfl_sync(FULL, pbox[3], q);
      int rank = (int)(base + q) + 1;
      // a tap: 1 where the map holds the node's id; outside its box (which
      // lies inside the image and holds every pixel of the node) 0 unread
      auto tap = [&](int xx, int yy) -> float {
        if (xx < x_lo || xx > x_hi || yy < y_lo || yy > y_hi) return 0.0f;
        return __ldg(inst + (long long)yy * W + xx) == qid ? 1.0f : 0.0f;
      };
#pragma unroll
      for (int i = 0; i < PIX; ++i) {
#pragma unroll
        for (int j = 0; j < PIX; ++j) {
          // the four taps of this pixel, as maskwarp.cu:52-72
          float sx = source_coord(t0, t1, t2, bx[j], by[i], fw);
          float sy = source_coord(t3, t4, t5, bx[j], by[i], fh);
          float x0f = floorf(sx), y0f = floorf(sy);
          float wx = sx - x0f, wy = sy - y0f;
          // far outside: no corner can be inside (keeps the casts in range)
          if (!(x0f >= -1.0f && x0f <= fw && y0f >= -1.0f && y0f <= fh))
            continue;
          int x0 = (int)x0f, y0 = (int)y0f;
          float v00 = tap(x0, y0), v10 = tap(x0 + 1, y0);
          float v01 = tap(x0, y0 + 1), v11 = tap(x0 + 1, y0 + 1);
          float top = v00 * (1.0f - wx) + v10 * wx;
          float bot = v01 * (1.0f - wx) + v11 * wx;
          float val = top * (1.0f - wy) + bot * wy;
          if (val >= thr) res[i * PIX + j] = rank;
        }
      }
    }
  }
  // c. the lane's rows, 16 bytes at a time where rows stay aligned
  int* out = winner + ((b * T + t) * H + py) * W + px;
  bool vec = W % 4 == 0 && px + PIX <= W;
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    if (py + i >= H) break;
    int* row = out + (long long)i * W;
    if (vec) {
      *reinterpret_cast<int4*>(row) = make_int4(
          res[i * PIX], res[i * PIX + 1], res[i * PIX + 2], res[i * PIX + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < PIX; ++j)
        if (px + j < W) row[j] = res[i * PIX + j];
    }
  }
}

}  // namespace

// scratch: int32 [B*N*4], the nodes' boxes; the wrapper allocates it, this
// fills it.
extern "C" int c2m_warp_masks_banded(const void* instance, const void* ids,
                                     const void* valid, const void* thetas,
                                     void* scratch, void* winner, long long B,
                                     long long N, long long T, long long H,
                                     long long W, float thr, void* stream) {
  long long tiles_y = (H + TILE_H - 1) / TILE_H;
  long long tiles_x = (W + TILE_W - 1) / TILE_W;
  long long tiles = B * T * tiles_y * tiles_x;
  long long blocks = (tiles + WARPS - 1) / WARPS;
  long long box_blocks = (H * W + BOX_THREADS * BOX_PIXELS - 1) /
                         (BOX_THREADS * BOX_PIXELS);
  // the box pass keeps 5 ints per node in 48 KB of shared memory
  if (tiles <= 0 || blocks > 2147483647LL || box_blocks > 2147483647LL ||
      B > 65535 || H > INT_MAX || W > INT_MAX || N * 5 * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* boxes = static_cast<int*>(scratch);
  int err = (int)cudaMemsetAsync(boxes, 0x7f, (size_t)(B * N * 4) * sizeof(int),
                                 s);
  if (err) return err;
  if (N > 0) {
    node_boxes_kernel<<<dim3((unsigned)box_blocks, (unsigned)B), BOX_THREADS,
                        (size_t)(N * 5 * sizeof(int)), s>>>(
        static_cast<const float*>(instance), static_cast<const float*>(ids),
        static_cast<const int*>(valid), boxes, N, H, W);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  warp_masks_tiles_kernel<<<(unsigned)blocks, WARPS * 32, 0, s>>>(
      static_cast<const float*>(instance), static_cast<const float*>(ids),
      static_cast<const int*>(valid), static_cast<const float*>(thetas), boxes,
      static_cast<int*>(winner), N, T, H, W, tiles_y, tiles_x, tiles, thr);
  return (int)cudaGetLastError();
}
