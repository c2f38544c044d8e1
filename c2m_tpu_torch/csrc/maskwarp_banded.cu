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
// not copied. Two kernels on one stream:
//
// node_boxes_kernel: the bounding box of `instance == id` for every valid
// node, [B, N, 4] int32 as (min y, -max y, min x, -max x) so that one
// atomicMin serves all four (the wrapper fills it with INT_MAX: a node that
// is nowhere on the map keeps that). Exact integer arithmetic.
//
// warp_masks_banded_kernel: a thread block owns one (b, t, 16x32 output
// tile).
//   1. Thread n evaluates node n's affine at the tile's four corners -> the
//      source window, clipped to the image, and intersects it with the
//      node's box. No window (the tile maps wholly off the image) or no
//      intersection skips the node for the whole tile, with no per-pixel
//      work: the common case, since an object covers a few tiles and the
//      loop visits all nodes. The verdict and the region go to shared
//      memory.
//   2. For every node that is left, in order (the last covered node wins),
//      the block stages `instance == id` over the region (window x box) as
//      bytes in shared memory, if it fits the budget of WIN_MAX pixels;
//   3. each thread tests its four taps: a tap outside the node's box is 0,
//      a tap in the staged region reads shared memory, and any other tap
//      (rounding of the corner estimate) reads global memory, so that once
//      a node is visited the result does not depend on the window
//      arithmetic;
//   4. a region larger than the budget (a strong zoom-out) takes the
//      per-thread global gather of maskwarp.cu for that node and tile: the
//      in-kernel branch that stands for the TPU path's lax.cond fallback.
//
// What bounds it on the H100: operations, as K2 (it writes 4 bytes per pixel
// and reads a 2 MB map from L2). K2 pays ~30 float operations and 4 cached
// loads per (pixel, node); K3 pays them only for (tile, node) pairs whose
// window meets the node's box, plus one compare per (source pixel, node)
// for the boxes.
//
// The sampling arithmetic is written term for term as maskwarp.cu:44-72 and
// the library is built with -fmad=false, so K3 == K2 == the plain version.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int TILE_H = 16;
constexpr int TILE_W = 32;
constexpr int THREADS = TILE_H * TILE_W;
constexpr int WIN_MAX = 8192;   // staged region budget, pixels (= bytes)
constexpr int BOX_THREADS = 256;
constexpr int BOX_PIXELS = 4;   // source pixels per thread of the box pass

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
    int* __restrict__ boxes,              // [B, N, 4], filled with INT_MAX
    long long N, long long H, long long W) {
  extern __shared__ int box_smem[];
  int* sbox = box_smem;                                     // [N, 4]
  float* sid = reinterpret_cast<float*>(box_smem + 4 * N);  // [N]
  long long b = blockIdx.y;
  int tid = threadIdx.x;
  for (long long k = tid; k < 4 * N; k += BOX_THREADS) sbox[k] = INT_MAX;
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
    if (sbox[k] != INT_MAX) atomicMin(boxes + b * 4 * N + k, sbox[k]);
}

// Source coordinate of one axis: ((g + 1) * size - 1) / 2 with g the affine
// row applied to the align_corners=False base coordinates (bx, by).
__device__ __forceinline__ float source_coord(float a, float b, float c,
                                              float bx, float by, float size) {
  float g = a * bx + b * by + c;
  return ((g + 1.0f) * size - 1.0f) * 0.5f;
}

// What a block keeps of a node: its box and the region to stage, both
// inclusive (y0, y1, x0, x1); live == 0 skips the node for this tile.
struct NodePlan {
  int live;
  int box[4];
  int reg[4];
};

__global__ void __launch_bounds__(THREADS) warp_masks_banded_kernel(
    const float* __restrict__ instance,   // [B, H, W]
    const float* __restrict__ ids,        // [B, N]
    const int* __restrict__ valid,        // [B, N]
    const float* __restrict__ thetas,     // [B, N, T, 6]
    const int* __restrict__ boxes,        // [B, N, 4] from node_boxes_kernel
    int* __restrict__ winner,             // [B, T, H, W]
    long long B, long long N, long long T, long long H, long long W,
    long long tiles_y, long long tiles_x, float thr) {
  __shared__ unsigned char win[WIN_MAX];
  extern __shared__ int plan_smem[];
  NodePlan* plan = reinterpret_cast<NodePlan*>(plan_smem);   // [N]

  long long blk = blockIdx.x;
  long long tile_x = blk % tiles_x;
  long long tile_y = (blk / tiles_x) % tiles_y;
  long long t = (blk / (tiles_x * tiles_y)) % T;
  long long b = blk / (tiles_x * tiles_y * T);
  int tid = threadIdx.x;
  long long x = tile_x * TILE_W + tid % TILE_W;
  long long y = tile_y * TILE_H + tid / TILE_W;
  bool active = x < W && y < H;
  float fw = (float)W, fh = (float)H;

  // 1. one thread per node: the tile's source window under the node's
  // affine, met with the node's box
  {
    // the tile's corner pixels (clipped to the image), their base coords
    long long cx0 = tile_x * TILE_W, cy0 = tile_y * TILE_H;
    long long cx1 = cx0 + TILE_W - 1 < W - 1 ? cx0 + TILE_W - 1 : W - 1;
    long long cy1 = cy0 + TILE_H - 1 < H - 1 ? cy0 + TILE_H - 1 : H - 1;
    float bxc[2] = {(2.0f * (float)cx0 + 1.0f) / fw - 1.0f,
                    (2.0f * (float)cx1 + 1.0f) / fw - 1.0f};
    float byc[2] = {(2.0f * (float)cy0 + 1.0f) / fh - 1.0f,
                    (2.0f * (float)cy1 + 1.0f) / fh - 1.0f};
    for (long long n = tid; n < N; n += THREADS) {
      NodePlan p;
      p.live = 0;
      const int* box = boxes + (b * N + n) * 4;
      if (valid[b * N + n] && box[0] != INT_MAX) {
        const float* th = thetas + ((b * N + n) * T + t) * 6;
        float t0 = th[0], t1 = th[1], t2 = th[2], t3 = th[3], t4 = th[4],
              t5 = th[5];
        float sx_lo = source_coord(t0, t1, t2, bxc[0], byc[0], fw);
        float sy_lo = source_coord(t3, t4, t5, bxc[0], byc[0], fh);
        float sx_hi = sx_lo, sy_hi = sy_lo;
#pragma unroll
        for (int k = 1; k < 4; ++k) {
          float sxk = source_coord(t0, t1, t2, bxc[k & 1], byc[k >> 1], fw);
          float syk = source_coord(t3, t4, t5, bxc[k & 1], byc[k >> 1], fh);
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
        if (xlo <= xhi && ylo <= yhi) {          // else wholly off the image
          p.box[0] = box[0];
          p.box[1] = -box[1];
          p.box[2] = box[2];
          p.box[3] = -box[3];
          p.reg[0] = max((int)ylo, p.box[0]);
          p.reg[1] = min((int)yhi, p.box[1]);
          p.reg[2] = max((int)xlo, p.box[2]);
          p.reg[3] = min((int)xhi, p.box[3]);
          p.live = p.reg[0] <= p.reg[1] && p.reg[2] <= p.reg[3];
        }
      }
      plan[n] = p;
    }
  }
  __syncthreads();

  // align_corners=False base coordinates of this thread's output pixel
  float bx = (2.0f * (float)x + 1.0f) / fw - 1.0f;
  float by = (2.0f * (float)y + 1.0f) / fh - 1.0f;
  const float* inst = instance + b * H * W;
  int result = 0;
  bool dirty = false;                      // the window holds a node's bytes
  for (long long n = 0; n < N; ++n) {
    if (!plan[n].live) continue;                          // block-uniform
    const NodePlan p = plan[n];
    float id = ids[b * N + n];
    const float* th = thetas + ((b * N + n) * T + t) * 6;
    float t0 = th[0], t1 = th[1], t2 = th[2], t3 = th[3], t4 = th[4],
          t5 = th[5];
    int rw = p.reg[3] - p.reg[2] + 1, rh = p.reg[1] - p.reg[0] + 1;
    bool staged = (long long)rw * rh <= (long long)WIN_MAX;  // block-uniform

    // 2. stage `instance == id` over the region
    if (staged) {
      if (dirty) __syncthreads();      // the last node's taps are all read
      for (int i = tid; i < rw * rh; i += THREADS) {
        long long yy = p.reg[0] + i / rw, xx = p.reg[2] + i % rw;
        win[i] = inst[yy * W + xx] == id ? 1 : 0;
      }
      __syncthreads();
      dirty = true;
    }

    // 3./4. the four taps of this pixel, as maskwarp.cu:52-72
    if (active) {
      float sx = source_coord(t0, t1, t2, bx, by, fw);
      float sy = source_coord(t3, t4, t5, bx, by, fh);
      float x0f = floorf(sx), y0f = floorf(sy);
      float wx = sx - x0f, wy = sy - y0f;
      // far outside: no corner can be inside (also keeps the casts in range)
      if (x0f >= -1.0f && x0f <= fw && y0f >= -1.0f && y0f <= fh) {
        int x0 = (int)x0f, y0 = (int)y0f;
        int x1 = x0 + 1, y1 = y0 + 1;
        auto tap = [&](int xx, int yy) -> float {
          // the box lies inside the image and holds every pixel of the node
          if (xx < p.box[2] || xx > p.box[3] || yy < p.box[0] || yy > p.box[1])
            return 0.0f;
          if (staged && xx >= p.reg[2] && xx <= p.reg[3] && yy >= p.reg[0] &&
              yy <= p.reg[1])
            return win[(yy - p.reg[0]) * rw + (xx - p.reg[2])] ? 1.0f : 0.0f;
          return inst[(long long)yy * W + xx] == id ? 1.0f : 0.0f;
        };
        float v00 = tap(x0, y0), v10 = tap(x1, y0);
        float v01 = tap(x0, y1), v11 = tap(x1, y1);
        float top = v00 * (1.0f - wx) + v10 * wx;
        float bot = v01 * (1.0f - wx) + v11 * wx;
        float val = top * (1.0f - wy) + bot * wy;
        if (val >= thr) result = (int)(n + 1);
      }
    }
  }
  if (active) winner[((b * T + t) * H + y) * W + x] = result;
}

}  // namespace

extern "C" int c2m_warp_masks_banded(const void* instance, const void* ids,
                                     const void* valid, const void* thetas,
                                     void* boxes, void* winner, long long B,
                                     long long N, long long T, long long H,
                                     long long W, float thr, void* stream) {
  long long tiles_y = (H + TILE_H - 1) / TILE_H;
  long long tiles_x = (W + TILE_W - 1) / TILE_W;
  long long blocks = B * T * tiles_y * tiles_x;
  long long box_blocks = (H * W + BOX_THREADS * BOX_PIXELS - 1) /
                         (BOX_THREADS * BOX_PIXELS);
  // 40 KB of dynamic shared memory beside the 8 KB window: N <= 1137
  long long plan_bytes = N * (long long)sizeof(NodePlan);
  if (blocks <= 0 || blocks > 2147483647LL || box_blocks > 2147483647LL ||
      B > 65535 || H > INT_MAX || W > INT_MAX || plan_bytes > 40 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  node_boxes_kernel<<<dim3((unsigned)box_blocks, (unsigned)B), BOX_THREADS,
                      (size_t)(N * 5 * sizeof(int)), s>>>(
      static_cast<const float*>(instance), static_cast<const float*>(ids),
      static_cast<const int*>(valid), static_cast<int*>(boxes), N, H, W);
  int err = (int)cudaGetLastError();
  if (err) return err;
  warp_masks_banded_kernel<<<(unsigned)blocks, THREADS, (size_t)plan_bytes,
                             s>>>(
      static_cast<const float*>(instance), static_cast<const float*>(ids),
      static_cast<const int*>(valid), static_cast<const float*>(thetas),
      static_cast<const int*>(boxes), static_cast<int*>(winner), B, N, T, H, W,
      tiles_y, tiles_x, thr);
  return (int)cudaGetLastError();
}
