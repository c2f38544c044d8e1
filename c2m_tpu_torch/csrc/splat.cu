// Kernel K4: forward bilinear splat (corresponding map), no gradient.
//
// Replaces: c2m_tpu/ops/pallas/splat_kernel.py, _splat_call (:61) with body
// _splat_kernel (:38). A TPU scatter-add is a serial loop, so that kernel
// rewrote the splat as a dense hat-function matmul over all (point, pixel)
// pairs. A GPU has native float atomics, so the port is the direct scatter:
// O(H*W) work instead of O((H*W)^2 / band).
//
// What bounds it on the H100: the atomics, not the 12 bytes a pixel its bound
// counts. The first version made up to four float atomicAdds into L2 per
// source point (84M for [40,512,1024,2], whose 168 MB of output do not fit
// the 50 MB L2). This version keeps most of them on the SM:
//
//   - a block owns a TW x TH tile of source points and a shared-memory
//     accumulator that covers the tile plus a halo of R pixels on each side.
//     A corner that lands inside it is a shared-memory atomicAdd; a corner
//     that lands outside (a flow longer than R) goes straight to the output
//     as before, so every coordinate stays correct whatever its size;
//   - after a barrier the block adds its accumulator to the output, only
//     where it is non-zero, four neighbouring pixels in one 16-byte atomic
//     where W is a multiple of 4 (sm_90 has atomicAdd on a float4 in global
//     memory), else one scalar atomic per non-zero pixel;
//   - a 3-D launch (tile x, tile y, image) and 32-bit offsets inside an
//     image: no 64-bit division;
//   - the output is zeroed on the same stream first (4 bytes a pixel, in the
//     bound already).
// Tile and halo (64 x 32, 8) were chosen on the card among seven shapes that
// differed by under 10% (PERF.md section 6 has their times). The Python
// wrapper mirrors them (splat_kernel.TILE, HALO) for its plain emulation.
// What is left: a float atomicAdd on shared memory compiles to a
// compare-and-swap loop on this card, and the output is written twice (the
// zeroing, then the read-modify-write of the flush).
//
// Contract, unchanged: corner order, weights and the `invalid` rule of the
// plain version (corresponding_map_plain); a NaN, infinite or far-out
// coordinate adds nothing and touches no memory (float to int only after the
// clamp test). The atomics sum in an order that changes from run to run, so a
// mass can differ from the plain version in the last bits; only pixels whose
// mass lies within that of the 0.5 threshold the rasterizer binarizes at can
// flip.
//
// Times (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 3, device alone):
// [40,512,1024,2] 0.24 ms on +-10 px noise, 0.22 on smooth flows (first
// version 1.01 with its wrapper, bound 0.075); [60,128,256,2] 0.028 (0.11,
// 0.007). PERF.md section 6 has every shape.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_W = 64, TILE_H = 32, HALO = 8;

#if defined(__CUDACC_VER_MAJOR__) && \
    (__CUDACC_VER_MAJOR__ > 12 || \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
#define C2M_FLOAT4_ATOMICS 1
#else
#define C2M_FLOAT4_ATOMICS 0
#endif

// acc: the block's accumulator, AW wide, whose (0, 0) is pixel (ox, oy) of
// the image; img: the image's output plane.
template <int AW, int AH>
__device__ __forceinline__ void add_corner(float* acc, float* img, float x,
                                           float y, float cx, float cy, int ox,
                                           int oy, int H, int W) {
  float cxc = fminf(fmaxf(cx, 0.0f), (float)(W - 1));
  float cyc = fminf(fmaxf(cy, 0.0f), (float)(H - 1));
  if (cx != cxc || cy != cyc) return;          // corner outside the image
  float wgt = (1.0f - fabsf(x - cxc)) * (1.0f - fabsf(y - cyc));
  if (wgt == 0.0f) return;                     // adds nothing
  int ix = (int)cxc, iy = (int)cyc;
  unsigned lx = (unsigned)(ix - ox), ly = (unsigned)(iy - oy);
  if (lx < (unsigned)AW && ly < (unsigned)AH)
    atomicAdd(acc + ly * AW + lx, wgt);
  else
    atomicAdd(img + iy * W + ix, wgt);
}

__global__ void __launch_bounds__(THREADS)
splat_kernel(const float* __restrict__ coords, float* __restrict__ out,
             long long b0, int H, int W, int pairs_aligned, int vec_flush) {
  constexpr int TW = TILE_W, TH = TILE_H, R = HALO;
  constexpr int AW = TW + 2 * R, AH = TH + 2 * R;
  static_assert(TW % 4 == 0 && R % 4 == 0, "16-byte groups of the flush");
  static_assert(AW * AH * 4 <= 48 * 1024, "static shared memory");
  __shared__ __align__(16) float acc[AW * AH];
  for (int i = threadIdx.x; i < AW * AH / 4; i += THREADS)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  long long b = b0 + blockIdx.z;
  int tx0 = blockIdx.x * TW, ty0 = blockIdx.y * TH;
  int ox = tx0 - R, oy = ty0 - R;
  const float* src = coords + b * H * W * 2;
  float* img = out + b * H * W;
  for (int i = threadIdx.x; i < TW * TH; i += THREADS) {
    int px = tx0 + i % TW, py = ty0 + i / TW;
    if (px >= W || py >= H) continue;
    const float* p = src + ((size_t)py * W + px) * 2;
    float x, y;
    if (pairs_aligned) {
      float2 c = *reinterpret_cast<const float2*>(p);
      x = c.x; y = c.y;
    } else {
      x = p[0]; y = p[1];
    }
    float xf = floorf(x), yf = floorf(y);
    float xc = xf + 1.0f, yc = yf + 1.0f;
    add_corner<AW, AH>(acc, img, x, y, xc, yc, ox, oy, H, W);
    add_corner<AW, AH>(acc, img, x, y, xc, yf, ox, oy, H, W);
    add_corner<AW, AH>(acc, img, x, y, xf, yc, ox, oy, H, W);
    add_corner<AW, AH>(acc, img, x, y, xf, yf, ox, oy, H, W);
  }
  __syncthreads();

  // the flush: ox is a multiple of 4, so with W % 4 == 0 a group of four
  // accumulator columns lies wholly inside or wholly outside the image and
  // starts on a 16-byte boundary of the output
  for (int i = threadIdx.x; i < AW * AH / 4; i += THREADS) {
    int ly = i / (AW / 4), lx = (i % (AW / 4)) * 4;
    int gy = oy + ly, gx = ox + lx;
    if (gy < 0 || gy >= H) continue;
    float4 v = reinterpret_cast<const float4*>(acc)[i];
    if (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f) continue;
    float* dst = img + gy * W + gx;
#if C2M_FLOAT4_ATOMICS
    if (vec_flush) {
      if (gx >= 0 && gx < W) atomicAdd(reinterpret_cast<float4*>(dst), v);
      continue;
    }
#endif
    // entries outside the image are zero: no corner was added there
    if (v.x != 0.f) atomicAdd(dst + 0, v.x);
    if (v.y != 0.f) atomicAdd(dst + 1, v.y);
    if (v.z != 0.f) atomicAdd(dst + 2, v.z);
    if (v.w != 0.f) atomicAdd(dst + 3, v.w);
  }
}

}  // namespace

extern "C" int c2m_splat(const void* coords_, void* out_, long long B,
                         long long H_, long long W_, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (H_ * W_ >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  int H = (int)H_, W = (int)W_;
  cudaError_t err = cudaMemsetAsync(out_, 0, sizeof(float) * B * H * W, stream);
  if (err != cudaSuccess) return (int)err;
  const float* coords = static_cast<const float*>(coords_);
  float* out = static_cast<float*>(out_);
  int pairs_aligned = reinterpret_cast<size_t>(coords) % 8 == 0;
  // 16-byte atomics in the flush where every group of four starts on a
  // 16-byte boundary of the output (splat_kernel.splat_route mirrors this)
  int vec_flush = W % 4 == 0 && reinterpret_cast<size_t>(out) % 16 == 0;
  unsigned tiles_x = (W + TILE_W - 1) / TILE_W;
  unsigned tiles_y = (H + TILE_H - 1) / TILE_H;
  if (tiles_y > 65535u) return (int)cudaErrorInvalidValue;
  for (long long b0 = 0; b0 < B; b0 += 65535) {      // gridDim.z's limit
    long long nb = B - b0 < 65535 ? B - b0 : 65535;
    splat_kernel<<<dim3(tiles_x, tiles_y, (unsigned)nb), THREADS, 0, stream>>>(
        coords, out, b0, H, W, pairs_aligned, vec_flush);
  }
  return (int)cudaGetLastError();
}
