// Kernel K2: affine warp of every object mask, fused with the
// winner-takes-last composition of the rasterizer.
//
// Replaces: c2m_tpu/ops/pallas/maskwarp_kernel.py, _call (:68) with body
// _kernel (:39), and the reduction after it in c2m_tpu/ops/raster.py:325-330.
// The TPU has no per-pixel gather, so that kernel evaluated each bilinear
// sample as a hat-function contraction over the whole mask (quadratic in
// H*W) and wrote the full warped stack [B, N, T, H, W] for XLA to reduce.
//
// Function: each valid node's mask (instance == id) is warped by its affine
// of step t (affine_grid + zero-padded bilinear grid_sample,
// align_corners=False); a pixel is covered where the sample is >= thr
// (= 1 - 1e-5), and the last covered valid node wins (rank n + 1, 0 =
// background). The masks and the warped stack are never materialized: a
// corner is "inside" where instance == id of the node.
//
// What bounds it on the H100: instruction issue. Per (pixel, node) pair the
// exact sample takes ~60 instructions, 4 of them gathers from the instance
// map of one batch row (128 KB at 128x256, held in L1/L2); device memory
// sees only the inputs and the int32 winner map. The design cuts the pairs
// that need it, and what surrounds it:
// - a block owns a 32x8 tile of one (b, t) (grid x-tile, y-tile, b * T + t),
//   32-bit indices, no division per pixel;
// - the block stages its (b, t) node table once in shared memory: the valid
//   nodes only, compacted in node order (a ballot and a prefix count), each
//   with its rank, id and six thetas, NODE_CHUNK nodes at a time;
// - nodes are visited last to first and a pixel stops at the first covered
//   one: the same winner, since the last covered node wins. A pixel that no
//   node covers still visits every valid node. Once every pixel of the tile
//   has its winner, the block skips the earlier chunks;
// - a pair whose tap of the largest weight lies outside the object is
//   decided from that one gather (the sample is then at most 3/4), found
//   with six fmaf from the thetas: on the journal maps most pairs are such
//   background pairs (staging the test's own affines with the node, four
//   fmaf, measured slower).
// Every other pair evaluates the first version's float expression term for
// term (affine_grid + grid_sample_normalized, align_corners=False) and the
// library is built with -fmad=false, so the {0,1} decision matches the plain
// version's and K3's bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32, TY = 8, THREADS = TX * TY;
constexpr int NODE_CHUNK = THREADS;   // one node per thread when staging

__global__ void __launch_bounds__(THREADS) warp_masks_winner_kernel(
    const float* __restrict__ instance,   // [B, H, W]
    const float* __restrict__ ids,        // [B, N]
    const int* __restrict__ valid,        // [B, N]
    const float* __restrict__ thetas,     // [B, N, T, 6]
    int* __restrict__ winner,             // [B, T, H, W]
    int N, int T, int H, int W, float thr) {
  // node entry: thetas 0-3, then thetas 4-5, id, rank (int bits; negative
  // where the node skips the quick test)
  __shared__ float4 node_a[NODE_CHUNK], node_b[NODE_CHUNK];
  __shared__ int warp_count[THREADS / 32];

  const int tid = threadIdx.y * TX + threadIdx.x, lane = tid & 31;
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  const int bt = blockIdx.z, b = bt / T, t = bt - b * T;
  const bool inside = x < W && y < H;
  // align_corners=False base coordinates of this output pixel
  const float bx = (2.0f * (float)x + 1.0f) / (float)W - 1.0f;
  const float by = (2.0f * (float)y + 1.0f) / (float)H - 1.0f;
  const float* inst = instance + (size_t)b * H * W;
  // source x + 1/2 = (gx + 1) * W / 2: the nearest tap is its floor
  const float half_w = 0.5f * (float)W, half_h = 0.5f * (float)H;
  int win = 0;
  bool done = !inside;

  const int nchunks = (N + NODE_CHUNK - 1) / NODE_CHUNK;
  for (int ch = nchunks - 1; ch >= 0; --ch) {
    // compact this chunk's valid nodes in node order
    const int n = ch * NODE_CHUNK + tid;
    const bool v = n < N && valid[(size_t)b * N + n] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, v);
    if (lane == 0) warp_count[tid >> 5] = __popc(ballot);
    __syncthreads();
    int pos = __popc(ballot & ((1u << lane) - 1u)), count = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      int c = warp_count[w];
      if (w < (tid >> 5)) pos += c;
      count += c;
    }
    if (v) {
      const float* th = thetas + (((size_t)b * N + n) * T + t) * 6;
      // the quick test's position is off by a few float steps of its
      // terms' sum: below 2^16 px that is far under the 1/4 px it may miss
      // by; a node beyond it (or with NaN thetas) takes the exact path at
      // every pixel, marked by a negative rank
      bool quick =
          (fabsf(th[0]) + fabsf(th[1]) + fabsf(th[2]) + 1.0f) * half_w <
              65536.0f &&
          (fabsf(th[3]) + fabsf(th[4]) + fabsf(th[5]) + 1.0f) * half_h <
              65536.0f;
      node_a[pos] = make_float4(th[0], th[1], th[2], th[3]);
      node_b[pos] = make_float4(th[4], th[5], ids[(size_t)b * N + n],
                                __int_as_float(quick ? n + 1 : -(n + 1)));
    }
    __syncthreads();

    for (int k = count - 1; k >= 0 && !done; --k) {
      const float4 na = node_a[k], nb = node_b[k];
      const float id = nb.z;
      const int rank = __float_as_int(nb.w);
      // the tap of the largest weight (>= 1/4), from the sample position
      // to within rounding (fmaf; either tap of a near tie weighs ~1/2):
      // where it is not inside the object the sample is <= 3/4 < thr,
      // whatever the other taps hold, so the pair is decided by one gather
      if (rank > 0) {
        int xn = __float2int_rd(fmaf(fmaf(na.x, bx, fmaf(na.y, by, na.z)),
                                     half_w, half_w));
        int yn = __float2int_rd(fmaf(fmaf(na.w, bx, fmaf(nb.x, by, nb.y)),
                                     half_h, half_h));
        if (!((unsigned)xn < (unsigned)W && (unsigned)yn < (unsigned)H &&
              __ldg(inst + yn * W + xn) == id)) continue;
      }
      // the first version's expression, term for term
      float gx = na.x * bx + na.y * by + na.z;
      float gy = na.w * bx + nb.x * by + nb.y;
      float sx = ((gx + 1.0f) * (float)W - 1.0f) * 0.5f;
      float sy = ((gy + 1.0f) * (float)H - 1.0f) * 0.5f;
      float x0f = floorf(sx), y0f = floorf(sy);
      float wx = sx - x0f, wy = sy - y0f;
      // far outside: no corner can be inside (also keeps the casts in range)
      if (!(x0f >= -1.0f && x0f <= (float)W && y0f >= -1.0f &&
            y0f <= (float)H)) continue;
      int x0 = (int)x0f, y0 = (int)y0f;
      int x1 = x0 + 1, y1 = y0 + 1;
      bool vx0 = x0 >= 0 && x0 <= W - 1, vx1 = x1 >= 0 && x1 <= W - 1;
      bool vy0 = y0 >= 0 && y0 <= H - 1, vy1 = y1 >= 0 && y1 <= H - 1;
      float v00 = (vx0 && vy0 && __ldg(inst + y0 * W + x0) == id) ? 1.0f : 0.0f;
      float v10 = (vx1 && vy0 && __ldg(inst + y0 * W + x1) == id) ? 1.0f : 0.0f;
      float v01 = (vx0 && vy1 && __ldg(inst + y1 * W + x0) == id) ? 1.0f : 0.0f;
      float v11 = (vx1 && vy1 && __ldg(inst + y1 * W + x1) == id) ? 1.0f : 0.0f;
      float top = v00 * (1.0f - wx) + v10 * wx;
      float bot = v01 * (1.0f - wx) + v11 * wx;
      float val = top * (1.0f - wy) + bot * wy;
      if (val >= thr) {
        win = abs(rank);
        done = true;
      }
    }
    // every pixel of the tile settled: the earlier nodes cannot change it
    if (__syncthreads_and(done)) break;
  }
  if (inside) winner[(((size_t)b * T + t) * H + y) * W + x] = win;
}

}  // namespace

extern "C" int c2m_warp_masks_winner(const void* instance, const void* ids,
                                     const void* valid, const void* thetas,
                                     void* winner, long long B, long long N,
                                     long long T, long long H, long long W,
                                     float thr, void* stream) {
  if (B <= 0 || N < 0 || T <= 0 || H <= 0 || W <= 0 || B * T > 65535 ||
      H * W > 2147483647LL || N > 2147483647LL - NODE_CHUNK)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((W + TX - 1) / TX), (unsigned)((H + TY - 1) / TY),
            (unsigned)(B * T));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  warp_masks_winner_kernel<<<grid, dim3(TX, TY), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(instance), static_cast<const float*>(ids),
      static_cast<const int*>(valid), static_cast<const float*>(thetas),
      static_cast<int*>(winner), (int)N, (int)T, (int)H, (int)W, thr);
  return (int)cudaGetLastError();
}
