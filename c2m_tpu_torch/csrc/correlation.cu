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
// built. For one (b, y, dy) the outputs over (x, dxi) are a band of the
// product A_y [W x C] . B_{y+dy}^T [C x W]: column xb = x + dxi * stride - md
// of B meets pixel x. A block owns (b, y, a run of XR = 16 * stride pixels)
// and sweeps the displacement rows dy that stay inside the image, several
// at once (a "wave"); rows that leave it are only written as zeros. Per wave
// it stages, C_CHUNK channels at a time into two buffers, the run's `a`
// vectors and, for each dy of the wave, the B columns the run's band needs
// (float32 by 16-byte cp.async, so the copy of one chunk runs under the
// products of the one before; bfloat16 loaded and widened). A thread keeps a register
// tile of PX = 4 pixels `stride` apart by QD = 21 consecutive displacements
// (one whole displacement row at FlowNetC's md 20, stride 2): per channel it
// reads 4 + 24 staged values (neighbouring pixels and displacements share
// columns) for 84 products, accumulated with explicit fmaf, so the
// library's -fmad=false, which the other kernels need to agree bit for bit,
// does not touch it. No shuffle reduction: each sum lives in one thread.
// Only displacements on the stride grid are computed. A tile whose columns
// all leave the image is skipped and stores zeros. The stage keeps each
// quad of channels as a plane of float4 slots, swizzled so that the eight
// tiles of a row (a quarter warp) read distinct banks with 128-bit loads.
// A wave's sums go out through shared memory, each pixel's rows of
// displacements as one run.
//
// What bounds it on the H100: bytes at FlowNetC's map. At [30,16,32,256]
// 58 MB in and out (0.0175 ms at 3.35 TB/s) against ~0.8 GFLOP of useful
// products (~0.012 ms at the 67 TFLOP/s of float32 CUDA cores). The tensor
// cores are not used: in TF32 the products would keep ~3 decimal digits and
// miss the 1e-5 agreement with the float32 plain version, and the work is
// small beside the bytes. Inside the kernel the limit is shared-memory
// reads (28 a tile per 84 fmaf) and the re-staging of B rows from L2 (each
// row of B is staged by every row y that it is a displacement of).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int PX = 4;              // pixels of a thread's tile
constexpr int QD = 21;             // displacements of a thread's tile
constexpr int NK = PX + QD - 1;    // B columns one tile reads per channel
constexpr int PXG = 16;            // pixels of one stride class in a run
constexpr int C_CHUNK = 8;         // channels staged at a time: two quads
constexpr int MAX_THREADS = 256;
constexpr int SMEM_TARGET = 64 * 1024;    // per block: three blocks an SM
constexpr int SMEM_MAX = 227 * 1024;

// The stage holds float4 quads of channels in planes: a plane per quad,
// a column (or pixel) per slot. Slots are swizzled, two spare slots after
// every eight, so that the eight tiles of a displacement row, whose first
// columns are r + 8 m (r < 2, m < 4) at stride 2, read eight distinct
// 16-byte bank groups: a warp's 128-bit loads go conflict-free.
__host__ __device__ __forceinline__ int slot(int col) {
  return col + 2 * (col >> 3);
}

struct Geometry {
  int xr;       // pixels of a run: stride * PXG
  int dxg;      // displacement groups of QD
  int per_dy;   // tiles of one displacement row: (xr / PX) * dxg
  int ncols;    // staged B columns of one row
  int npa;      // slots of an `a` plane: slot(xr - 1) + 1
  int ncp;      // slots of a B plane: slot(ncols - 1) + 1
  int ndy_max;  // displacement rows of one wave
  int threads;
  int smem;     // bytes, both buffers
};

// quads of one buffer: two `a` planes, two B planes a row
__host__ __device__ int stage_quads(const Geometry& g, int ndy) {
  return 2 * g.npa + ndy * 2 * g.ncp;
}

Geometry geometry(int H, int md, int stride) {
  Geometry g;
  int D = 2 * (md / stride) + 1;
  g.xr = stride * PXG;
  g.dxg = (D + QD - 1) / QD;
  g.per_dy = (g.xr / PX) * g.dxg;
  g.ncols = stride * (PXG + g.dxg * QD - 1);
  g.npa = slot(g.xr - 1) + 1;
  g.ncp = slot(g.ncols - 1) + 1;
  int rows = (H + stride - 1) / stride;      // grid rows inside the image
  int ndy = MAX_THREADS / g.per_dy;
  if (ndy > D) ndy = D;
  if (ndy > rows) ndy = rows;
  while (ndy > 1 && 2 * stage_quads(g, ndy) * 16 > SMEM_TARGET) --ndy;
  g.ndy_max = ndy;
  g.threads = (ndy * g.per_dy + 31) / 32 * 32;
  // both buffers; a wave's outputs reuse them (xr * D floats a row fit in
  // the 16 * ncp floats of its B planes, since ncp >= stride * (PXG + D - 1))
  g.smem = 2 * stage_quads(g, ndy) * 16;
  return g;
}

// 16 bytes global -> shared without registers; zeros where !valid
__device__ __forceinline__ void cp_async16(float4* dst, const float* src,
                                           bool valid) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Channels c .. c + 3 of one pixel vector into a slot: float32 with
// 16-byte alignment by cp.async (the copy of one chunk runs under the
// products of the one before); otherwise loaded, widened and stored.
template <typename T>
__device__ __forceinline__ void put(float4* dst, const T* __restrict__ v,
                                    int c, int C, bool vec) {
  if (sizeof(T) == 4 && vec) {
    cp_async16(dst, reinterpret_cast<const float*>(v) + (c < C ? c : 0),
               c < C);
    return;
  }
  float e[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) e[q] = c + q < C ? widen(v[c + q]) : 0.0f;
  *dst = make_float4(e[0], e[1], e[2], e[3]);
}

// Stage channels [c0, c0 + C_CHUNK) of the run's a vectors and of the B
// columns [col_lo, col_hi) that lie inside the image, of `rows`
// displacement rows. A thread owns one quad and every (blockDim.x / 2)-th
// column. What lies outside the image was zeroed and is never written.
template <typename T>
__device__ __forceinline__ void stage(
    const T* __restrict__ a_run, const T* __restrict__ b_row0, float4* st,
    const Geometry& g, int c0, int C, bool vec, int npix, int col_lo,
    int col_hi, int rows, size_t row_step) {
  const int h = threadIdx.x & 1;
  const int first = threadIdx.x >> 1, nslot = blockDim.x >> 1;
  const int c = c0 + 4 * h;
  float4* as_ = st + h * g.npa;
  for (int px = first; px < npix; px += nslot)
    put(as_ + slot(px), a_run + (size_t)px * C, c, C, vec);
  float4* bs = st + 2 * g.npa + h * g.ncp;
  for (int col = col_lo + first; col < col_hi; col += nslot) {
    const T* src = b_row0 + (size_t)col * C;
    float4* dst = bs + slot(col);
    for (int row = 0; row < rows; ++row)
      put(dst + row * 2 * g.ncp, src + row * row_step, c, C, vec);
  }
}

// The stage slot of column base + d: at stride 2 with one displacement
// group a tile's first column is r + 8 m (r < 2), so the swizzle of
// base + d (d even, known at compile time) is slot(base) plus a constant.
template <bool FAST>
__device__ __forceinline__ int slot_at(int base_slot, int base, int d) {
  return FAST ? base_slot + d + 2 * (d >> 3) : slot(base + d);
}

template <typename T, bool FAST>
__global__ void __launch_bounds__(MAX_THREADS) correlation_kernel(
    const T* __restrict__ a,      // [B, H, W, C]
    const T* __restrict__ b,      // [B, H, W, C]
    float* __restrict__ out,      // [B, H, W, D*D]
    int H, int W, int C, int md, int stride, int D, bool vec, Geometry g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int s = FAST ? 2 : stride;
  const int DD = D * D;
  const int x0 = blockIdx.x * g.xr, y = blockIdx.y, bb = blockIdx.z;
  const int npix = min(g.xr, W - x0);
  const int tid = threadIdx.x;
  const T* a_run = a + (((size_t)bb * H + y) * W + x0) * C;
  float* out_run = out + (((size_t)bb * H + y) * W + x0) * DD;

  // displacement rows inside the image: dyi in [lo, hi]
  const int lo = max(0, (md - y + s - 1) / s);
  const int hi = min(D - 1, (H - 1 - y + md) / s);
  const int nvalid = hi - lo + 1;              // >= 1: dy = 0 is on the grid

  // rows that leave the image: zeros, [0, lo) and (hi, D) of every pixel
  {
    const int n0 = lo * D, nz = n0 + (D - 1 - hi) * D;
    for (int px = 0; px < npix; ++px)
      for (int r = tid; r < nz; r += blockDim.x)
        out_run[px * DD + (r < n0 ? r : (hi + 1) * D + r - n0)] = 0.0f;
  }
  // staged columns inside the image: col = xb - x0 + md in [col_lo, col_hi)
  const int col_lo = max(0, md - x0), col_hi = min(g.ncols, W - x0 + md);

  // this thread's tile: wave row, pixel group (stride class r, block mb),
  // displacement group dg
  const int per_dy = g.per_dy, mbs = PXG / PX;
  const int row = tid / per_dy, rem = tid % per_dy;
  const int pg = rem / g.dxg, dg = rem % g.dxg;
  const int xoff = pg / mbs + s * (pg % mbs) * PX;     // pixel 0 in the run
  const int cbase = xoff + s * dg * QD;                // column of k = 0
  const int xslot = slot(xoff), cslot = slot(cbase);
  // columns [cbase, cbase + s * (NK - 1)] of the stage
  const bool outside = x0 + xoff >= W || cbase + s * (NK - 1) < col_lo ||
                       cbase >= col_hi;

  const int nwaves = (nvalid + g.ndy_max - 1) / g.ndy_max;
  const int ndy = (nvalid + nwaves - 1) / nwaves;
  const int nchunks = (C + C_CHUNK - 1) / C_CHUNK;
  const int quads = stage_quads(g, ndy);              // one buffer
  const size_t row_step = (size_t)s * W * C;

  for (int dyi0 = lo; dyi0 <= hi; dyi0 += ndy) {
    const int rows = min(ndy, hi - dyi0 + 1);
    const bool active = row < rows && !outside;
    // B row of the wave's first displacement, at column 0 of the stage
    const T* b_row0 =
        b + ((((long long)bb * H + y + dyi0 * s - md) * W) + x0 - md) * C;
    float acc[PX][QD];
#pragma unroll
    for (int i = 0; i < PX; ++i)
#pragma unroll
      for (int j = 0; j < QD; ++j) acc[i][j] = 0.0f;

    // what is never staged stays zero (pixels past the image, columns
    // outside it); the previous wave's outputs lay here
    for (int i = tid; i < g.smem / 16; i += blockDim.x)
      smem4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();
    stage<T>(a_run, b_row0, smem4, g, 0, C, vec, npix, col_lo, col_hi, rows,
             row_step);
    cp_async_commit();
    for (int k = 0; k < nchunks; ++k) {
      if (k + 1 < nchunks) {
        stage<T>(a_run, b_row0, smem4 + ((k + 1) & 1) * quads, g,
                 (k + 1) * C_CHUNK, C, vec, npix, col_lo, col_hi, rows,
                 row_step);
        cp_async_commit();
        cp_async_wait<1>();              // chunk k has landed
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        const float4* st = smem4 + (k & 1) * quads;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4* as_ = st + h * g.npa;
          const float4* bs = st + 2 * g.npa + (row * 2 + h) * g.ncp;
          float4 av[PX];
#pragma unroll
          for (int i = 0; i < PX; ++i)
            av[i] = as_[slot_at<FAST>(xslot, xoff, s * i)];
#pragma unroll
          for (int q = 0; q < NK; ++q) {
            const float4 bv = bs[slot_at<FAST>(cslot, cbase, s * q)];
#pragma unroll
            for (int i = 0; i < PX; ++i) {
              const int j = q - i;
              if (j < 0 || j >= QD) continue;
              acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
              acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
              acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
              acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
            }
          }
        }
      }
      __syncthreads();                   // before chunk k + 2 overwrites it
    }

    // the wave's outputs through shared memory (the stage is free now):
    // [px][row][dxi], so that each pixel's rows go out as one run
    const int run = rows * D;
    if (row < rows) {
      const float inv_c = 1.0f / (float)C;
      float* o = smem + row * D;
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        int px = xoff + s * i;
        if (px >= npix) continue;
#pragma unroll
        for (int j = 0; j < QD; ++j) {
          int dxi = dg * QD + j;
          if (dxi < D) o[px * run + dxi] = acc[i][j] * inv_c;
        }
      }
    }
    __syncthreads();
    for (int px = 0; px < npix; ++px)
      for (int r = tid; r < run; r += blockDim.x)
        out_run[px * DD + dyi0 * D + r] = smem[px * run + r];
    __syncthreads();                     // before the next wave's stage
  }
}

template <typename T>
int launch(const void* a, const void* b, void* out, long long B, long long H,
           long long W, long long C, int md, int stride, void* stream) {
  if (md < 0 || stride < 1 || md % stride || B <= 0 || H <= 0 || W <= 0 ||
      C <= 0)
    return (int)cudaErrorInvalidValue;
  int D = 2 * (md / stride) + 1;
  // 32-bit offsets inside one output row and the stage
  if (B > 65535 || H > 65535 || W * (long long)D * D > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Geometry g = geometry((int)H, md, stride);
  if (g.per_dy > MAX_THREADS || g.smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((W + g.xr - 1) / g.xr), (unsigned)H, (unsigned)B);
  // four channels a copy: 16 bytes (float32) or 8 (bfloat16) aligned
  bool vec = C % 4 == 0 &&
             (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) %
                     (4 * sizeof(T)) == 0;
  auto kernel = stride == 2 && g.dxg == 1 ? correlation_kernel<T, true>
                                          : correlation_kernel<T, false>;
  if (g.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, g.threads, (size_t)g.smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float*>(out), (int)H, (int)W, (int)C, md, stride, D, vec,
      g);
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
