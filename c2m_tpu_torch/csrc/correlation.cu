// Kernel K5: the FlowNetC correlation cost volume.
//
// Replaces: c2m_tpu/ops/pallas/correlation_kernel.py, correlation_pallas
// (:48) with body _corr_kernel (:36). out[b, y, x, dyi * D + dxi] is the
// channel mean of a[b, y, x, :] * b[b, y + dy, x + dx, :] with
// dy = dyi * stride - md, dx = dxi * stride - md, D = 2 * (md / stride) + 1,
// and zero where (y + dy, x + dx) leaves the image. Inputs NHWC float32 or
// bfloat16, accumulation and output float32.
//
// The TPU kernel kept `a` and a zero-padded copy of `b` in VMEM and swept
// the displacements as a sequential grid axis. Here the padded copy is never
// built (the bounds are tested), and the reuse that VMEM gave comes from a
// tile: a thread block owns XT consecutive pixels of one row (b, y). Their
// `a` vectors sit in shared memory. The work is cut into units (dy, xb): one
// channel vector b[y + dy, xb, :]. A warp takes a unit, reads the vector once
// (lanes stride the channels, so the loads coalesce), and dots it with the
// `a` vector of every tile pixel x for which xb - x is a displacement of the
// grid (XT / stride of them), shuffle-reduces each sum and puts it into a
// shared [XT, D*D] tile, which the block writes out as one contiguous run.
//
// What bounds it on the H100: operations on a large map (2 * C per output
// element whose displacement stays inside the image), bytes on FlowNetC's
// small ones, where most of the 441 displacements leave the 16x32 map and
// cost nothing (58 MB in and out at [30,16,32,256]). This first version
// issues scalar loads and one multiply and one add per product
// (-fmad=false, shared with the other kernels), so it sits well above
// either bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int XT = 8;          // pixels of one row per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) correlation_kernel(
    const T* __restrict__ a,      // [B, H, W, C]
    const T* __restrict__ b,      // [B, H, W, C]
    float* __restrict__ out,      // [B, H, W, D*D]
    long long B, long long H, long long W, long long C, int md, int stride,
    int D, long long tiles_x) {
  extern __shared__ float smem[];
  float* a_s = smem;                        // [XT, C]
  float* out_s = smem + (long long)XT * C;  // [XT, D*D]
  int DD = D * D;

  long long blk = blockIdx.x;
  long long x0 = (blk % tiles_x) * XT;
  long long y = (blk / tiles_x) % H;
  long long bb = blk / (tiles_x * H);
  int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int npix = (int)(W - x0 < XT ? W - x0 : XT);   // pixels of a ragged tile

  const T* a_row = a + ((bb * H + y) * W + x0) * C;   // npix * C contiguous
  for (long long i = tid; i < (long long)npix * C; i += THREADS)
    a_s[i] = to_float(a_row[i]);
  for (int i = tid; i < XT * DD; i += THREADS) out_s[i] = 0.0f;
  __syncthreads();

  // units: (dyi, col) with the b column xb = x0 - md + col
  int ncols = XT + 2 * md;
  for (int u = warp; u < D * ncols; u += WARPS) {
    int dyi = u / ncols, col = u % ncols;
    long long yb = y + (long long)dyi * stride - md;
    long long xb = x0 - md + col;
    if (yb < 0 || yb >= H || xb < 0 || xb >= W) continue;   // zeros outside
    // tile pixels this column is a displacement of: dx = xb - x in
    // [-md, md] with (dx + md) % stride == 0
    unsigned match = 0;
#pragma unroll
    for (int px = 0; px < XT; ++px) {
      int dx = (int)(xb - (x0 + px));
      if (px < npix && dx >= -md && dx <= md && (dx + md) % stride == 0)
        match |= 1u << px;
    }
    if (!match) continue;
    float acc[XT];
#pragma unroll
    for (int px = 0; px < XT; ++px) acc[px] = 0.0f;
    const T* b_vec = b + ((bb * H + yb) * W + xb) * C;
    for (long long c = lane; c < C; c += 32) {
      float bv = to_float(b_vec[c]);
#pragma unroll
      for (int px = 0; px < XT; ++px)
        if (match & (1u << px)) acc[px] += a_s[px * C + c] * bv;
    }
#pragma unroll
    for (int px = 0; px < XT; ++px) {
      if (!(match & (1u << px))) continue;                   // warp-uniform
      float s = acc[px];
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) {
        int dxi = ((int)(xb - (x0 + px)) + md) / stride;
        out_s[px * DD + dyi * D + dxi] = s / (float)C;
      }
    }
  }
  __syncthreads();

  float* out_row = out + ((bb * H + y) * W + x0) * DD;      // npix * DD
  for (int i = tid; i < npix * DD; i += THREADS) out_row[i] = out_s[i];
}

template <typename T>
int launch(const void* a, const void* b, void* out, long long B, long long H,
           long long W, long long C, int md, int stride, void* stream) {
  if (md < 0 || stride < 1) return (int)cudaErrorInvalidValue;
  int D = 2 * (md / stride) + 1;
  long long tiles_x = (W + XT - 1) / XT;
  long long blocks = B * H * tiles_x;
  long long smem = ((long long)XT * C + (long long)XT * D * D) * 4;
  if (blocks <= 0 || blocks > 2147483647LL || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  correlation_kernel<T><<<(unsigned)blocks, THREADS, (size_t)smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float*>(out), B, H, W, C, md, stride, D, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int c2m_correlation_f32(const void* a, const void* b, void* out,
                                   long long B, long long H, long long W,
                                   long long C, int md, int stride,
                                   void* stream) {
  return launch<float>(a, b, out, B, H, W, C, md, stride, stream);
}

extern "C" int c2m_correlation_bf16(const void* a, const void* b, void* out,
                                    long long B, long long H, long long W,
                                    long long C, int md, int stride,
                                    void* stream) {
  return launch<__nv_bfloat16>(a, b, out, B, H, W, C, md, stride, stream);
}
