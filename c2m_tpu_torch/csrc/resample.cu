// Kernel K1: backward bilinear resample, optionally times an occlusion mask.
//
// Replaces: c2m_tpu/ops/pallas/warp_kernels.py, _resample_pallas (:111) with
// body _warp_kernel (:76). On the TPU there is no joint (row, col) gather, so
// that kernel builds each tap from a one-hot row select around lane gathers
// and only covers H <= 128, W % 128 == 0. A GPU gathers directly.
//
// What bounds it on the H100: memory, if the kernel lets it. Per pixel the
// function reads one flow, one mask value and four taps of C channels
// (neighbouring pixels share taps, so they come from L1/L2) and writes C
// values; there are ~16 float operations per pixel and ~10 per element. The
// first version (one thread per output ELEMENT, 64-bit index arithmetic,
// kept below as route 3) was bound by its own instructions instead: four
// 64-bit divisions per element, the whole pixel arithmetic redone by each of
// a pixel's C threads, 2-byte loads in bfloat16. Measured on the card at
// bfloat16 [40,64,128,256]: 0.70 ms, of which the divisions were 0.30 (route
// 0 is that layout without them) and the layout another 0.26. This version
// does what belongs to a pixel once and moves wide:
//
//   route 1 "vec"    bfloat16 with C % 8 == 0, float32 with C % 4 == 0, base
//                    pointers 16-byte aligned: a lane owns 8 (4) neighbouring
//                    channels of one pixel: four 16-byte tap loads, the blend
//                    in float32, one 16-byte store. min(C/8, 32) lanes share a
//                    pixel (a warp's tap request is 512 contiguous bytes at
//                    C = 256 bfloat16, four runs of 128 at C = 64) and the
//                    flow, the coordinate, the weights, the tap offsets and
//                    the mask are computed once per lane, not once per element.
//   route 2 "pixel"  C <= 4 (frames, flows, masks), C at compile time: a warp
//                    owns 32 neighbouring pixels, lane l computes pixel l's
//                    taps once, then the warp walks its 32*C output elements
//                    in C rounds, each lane fetching its element's pixel
//                    record by shuffle. The taps of a row are one run of 2C
//                    values from x0 (x1 = x0 + 1 is its neighbour in memory;
//                    at the right border x1 = x0), so the C lanes of a pixel
//                    read neighbouring addresses and every store of the warp
//                    is one 128-byte run.
//                    (A thread that walks its own pixel was tried first:
//                    as fast on smooth flows, 1.4x slower on scattered ones;
//                    PERF.md section 6 has its times.)
//   route 0 "scalar" any other C, or pointers that are not 16-byte aligned:
//                    one thread per element, 32-bit indices.
//   route 3 "scalar64" the first version: 64-bit indices, plain divisions,
//                    for tensors of 2^31 elements and more.
//
// Frames per image: the image holds B / frames rows and output row i reads
// image row i / frames (flow, mask and output hold B rows), so a caller that
// warps one image into T frames passes it once instead of T copies. Only
// the image's base offset depends on it, in every route (one more
// multiply-high division per pixel, by a divisor prepared on the host).
//
// The wrapper (c2m_tpu_torch/ops/hopper/warp_kernels.py, resample_route)
// picks the route; routes 1-2 need B*H*W < 2^31 and H*W*C < 2^31 (32-bit
// offsets inside an image, a 64-bit base per image), route 0 B*H*W*C < 2^31.
// Routes 0-2 divide by W and H (route 0 also by C) with a multiply-high and
// a shift (divisors prepared on the host): no division instruction at all.
//
// Not used, on purpose: TMA and cp.async tile staging want addresses that are
// known before the data, and the taps depend on the flow; the four taps hit
// L1/L2 already (each image value is read about four times, by neighbours),
// and after this redesign the large shapes run at 1.4-2.0x their bound, so
// tap traffic is not what is left. No tensor cores: there is no product here.
//
// Source coordinates follow the reference's mixed align_corners convention:
//   sx = (x + fx) * W/(W-1) - 0.5,  sy = (y + fy) * H/(H-1) - 0.5,
// clamped to the image (border padding). The arithmetic is written term for
// term as the plain version (c2m_tpu_torch/ops/hopper/warp_kernels.py) and
// the library is built with -fmad=false, so float32 results match it bit for
// bit, and bfloat16 results are one rounding of the same float32 value.
//
// Times (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 3, device alone):
// bfloat16 x mask [40,64,128,256] 0.14 ms (first version 0.70, bound 0.10),
// float32 [40,512,1024,3] 0.39 ms on scattered and 0.25 on smooth flows
// (first version 0.52, F.grid_sample 0.50 / 0.35, bound 0.20). PERF.md
// section 6 has every shape.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// n / d for n < 2^31 by one multiply-high and one shift
struct FastDiv {
  unsigned mul, shr, d;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return d == 1 ? n : __umulhi(n, mul) >> shr;
  }
};

FastDiv fast_div(unsigned d) {
  FastDiv f = {0u, 0u, d};
  if (d > 1) {
    unsigned lg = 0;                       // ceil(log2 d)
    while ((1ull << lg) < d) ++lg;
    unsigned p = 31 + lg;
    f.mul = (unsigned)(((1ull << p) + d - 1) / d);
    f.shr = p - 32;
  }
  return f;
}

// What a pixel needs before its channels: bilinear weights, the offset of
// its top-left tap inside the image (in pixels) and the steps to the right
// and the lower neighbour (0 at the border), all from the flow.
struct Taps {
  float wx, wy;
  unsigned p00;      // y0 * W + x0
  unsigned dx, dy;   // x1 - x0 in pixels, (y1 - y0) * W in pixels
};

__device__ __forceinline__ Taps taps_of(float fx, float fy, unsigned x,
                                        unsigned y, unsigned H, unsigned W,
                                        float wf, float hf) {
  float sx = ((float)x + fx) * wf - 0.5f;
  float sy = ((float)y + fy) * hf - 0.5f;
  sx = fminf(fmaxf(sx, 0.0f), (float)(W - 1));
  sy = fminf(fmaxf(sy, 0.0f), (float)(H - 1));
  float x0f = floorf(sx), y0f = floorf(sy);
  Taps t;
  t.wx = sx - x0f;
  t.wy = sy - y0f;
  // sx, sy lie in [0, W-1] x [0, H-1] (a NaN flow clamps to 0), so the
  // conversions are safe and x0, y0 need no second clamp
  unsigned x0 = (unsigned)x0f, y0 = (unsigned)y0f;
  t.p00 = y0 * W + x0;
  t.dx = x0 + 1 < W ? 1u : 0u;
  t.dy = y0 + 1 < H ? W : 0u;
  return t;
}

__device__ __forceinline__ float blend(float v00, float v10, float v01,
                                       float v11, float wx, float wy) {
  float top = v00 * (1.0f - wx) + v10 * wx;
  float bot = v01 * (1.0f - wx) + v11 * wx;
  return top * (1.0f - wy) + bot * wy;
}

// 16 bytes of channels: 4 float32 or 8 bfloat16
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bfloat16 is the upper half of the float32 of the same value
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<unsigned*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Route 1. blockDim = (lanes of a pixel, pixels of a block).
template <typename T>
__global__ void resample_vec_kernel(const T* __restrict__ img,
                                    const float2* __restrict__ flow,
                                    const float* __restrict__ mask,
                                    T* __restrict__ out, unsigned npix,
                                    unsigned H, unsigned W, unsigned chunks,
                                    FastDiv divW, FastDiv divH, FastDiv divF,
                                    float wf, float hf, int masked) {
  constexpr int N = Chunk<T>::N;
  unsigned pix = blockIdx.x * blockDim.y + threadIdx.y;
  if (pix >= npix) return;
  unsigned row = divW.div(pix);            // b * H + y
  unsigned x = pix - row * W;
  unsigned b = divH.div(row);
  unsigned y = row - b * H;
  float2 f = flow[pix];
  float m = masked ? mask[pix] : 1.0f;
  Taps t = taps_of(f.x, f.y, x, y, H, W, wf, hf);
  const uint4* r0 = reinterpret_cast<const uint4*>(img)
      + ((size_t)divF.div(b) * H * W + t.p00) * chunks;
  const uint4* r1 = r0 + t.dy * chunks;
  unsigned dx = t.dx * chunks;
  uint4* o = reinterpret_cast<uint4*>(out) + (size_t)pix * chunks;
  for (unsigned ch = threadIdx.x; ch < chunks; ch += blockDim.x) {
    uint4 u00 = r0[ch], u10 = r0[dx + ch], u01 = r1[ch], u11 = r1[dx + ch];
    float v00[N], v10[N], v01[N], v11[N], res[N];
    Chunk<T>::unpack(u00, v00);
    Chunk<T>::unpack(u10, v10);
    Chunk<T>::unpack(u01, v01);
    Chunk<T>::unpack(u11, v11);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      res[i] = blend(v00[i], v10[i], v01[i], v11[i], t.wx, t.wy);
      if (masked) res[i] = res[i] * m;
    }
    o[ch] = Chunk<T>::pack(res);
  }
}

// Route 2. A warp owns 32 neighbouring pixels, C known to the compiler. Lane
// l computes the taps of pixel l once; then the warp's 32*C output elements
// are taken in C rounds of 32 neighbouring elements: a lane fetches its
// element's pixel record from the lane that computed it (shuffles), loads
// its four taps and stores one value. So the pixel arithmetic is done once
// per pixel, the C lanes of a pixel read neighbouring addresses (on a
// scattered flow that is C times fewer cache lines per load than a thread
// that walks its own pixel), and every store of the warp is one contiguous
// 128-byte run.
constexpr int PIXEL_THREADS = 256;

template <typename T, int C>
__global__ void resample_pixel_kernel(const T* __restrict__ img,
                                      const float2* __restrict__ flow,
                                      const float* __restrict__ mask,
                                      T* __restrict__ out, unsigned npix,
                                      unsigned H, unsigned W, FastDiv divW,
                                      FastDiv divH, FastDiv divF, float wf,
                                      float hf, int masked) {
  const unsigned FULL = 0xffffffffu;
  unsigned lane = threadIdx.x & 31u;
  unsigned first = blockIdx.x * PIXEL_THREADS + (threadIdx.x & ~31u);
  if (first >= npix) return;               // the whole warp leaves together
  unsigned pix = first + lane;
  unsigned live = pix < npix ? pix : npix - 1;    // a lane past the end
  unsigned row = divW.div(live);                  // repeats the last pixel
  unsigned x = live - row * W;
  unsigned b = divH.div(row);
  unsigned y = row - b * H;
  float2 f = flow[live];
  float m = masked ? mask[live] : 1.0f;
  Taps t = taps_of(f.x, f.y, x, y, H, W, wf, hf);
  unsigned p00 = divF.div(b) * H * W + t.p00;   // in pixels of the image
  unsigned steps = t.dx | (t.dy ? 2u : 0u);
  unsigned left = npix - first;            // pixels of this warp
  unsigned n = (left < 32u ? left : 32u) * C;
  T* o = out + (size_t)first * C;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    unsigned e = k * 32 + lane;            // element of the warp's run
    unsigned q = e / C, c = e - q * C;     // its pixel's lane, its channel
    unsigned qp00 = __shfl_sync(FULL, p00, q);
    unsigned qsteps = __shfl_sync(FULL, steps, q);
    float wx = __shfl_sync(FULL, t.wx, q), wy = __shfl_sync(FULL, t.wy, q);
    float qm = __shfl_sync(FULL, m, q);
    const T* r0 = img + (size_t)qp00 * C + c;
    const T* r1 = r0 + (qsteps & 2u ? W * C : 0u);
    unsigned dx = (qsteps & 1u) * C;
    float res = blend(to_f(r0[0]), to_f(r0[dx]), to_f(r1[0]), to_f(r1[dx]),
                      wx, wy);
    if (masked) res = res * qm;
    if (e < n) store(o + e, res);
  }
}

// Route 0. One thread per element, 32-bit indices: C neighbouring lanes share
// a pixel (its flow and mask loads are broadcasts, its taps neighbours in
// memory) and the stores of a warp are one contiguous run.
template <typename T>
__global__ void resample_scalar_kernel(const T* __restrict__ img,
                                       const float* __restrict__ flow,
                                       const float* __restrict__ mask,
                                       T* __restrict__ out, unsigned total,
                                       unsigned H, unsigned W, unsigned C,
                                       FastDiv divC, FastDiv divW,
                                       FastDiv divH, FastDiv divF, float wf,
                                       float hf, int masked) {
  unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  unsigned pix = divC.div(i);
  unsigned c = i - pix * C;
  unsigned row = divW.div(pix);
  unsigned x = pix - row * W;
  unsigned b = divH.div(row);
  unsigned y = row - b * H;
  Taps t = taps_of(flow[2 * pix], flow[2 * pix + 1], x, y, H, W, wf, hf);
  const T* r0 = img + (divF.div(b) * H * W + t.p00) * C + c;
  const T* r1 = r0 + t.dy * C;
  unsigned dx = t.dx * C;
  float res = blend(to_f(r0[0]), to_f(r0[dx]), to_f(r1[0]), to_f(r1[dx]),
                    t.wx, t.wy);
  if (masked) res = res * mask[pix];
  store(out + i, res);
}

// Route 3. The same with 64-bit indices and plain divisions, grid-stride.
template <typename T>
__global__ void resample_scalar64_kernel(const T* __restrict__ img,
                                         const float* __restrict__ flow,
                                         const float* __restrict__ mask,
                                         T* __restrict__ out, long long B,
                                         long long H, long long W, long long C,
                                         long long frames, float wf, float hf,
                                         int masked) {
  long long total = B * H * W * C;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    long long c = i % C;
    long long pix = i / C;                 // b*H*W + y*W + x
    long long x = pix % W;
    long long y = (pix / W) % H;
    long long b = pix / (H * W);
    float sx = ((float)x + flow[pix * 2 + 0]) * wf - 0.5f;
    float sy = ((float)y + flow[pix * 2 + 1]) * hf - 0.5f;
    sx = fminf(fmaxf(sx, 0.0f), (float)(W - 1));
    sy = fminf(fmaxf(sy, 0.0f), (float)(H - 1));
    float x0f = floorf(sx), y0f = floorf(sy);
    float wx = sx - x0f, wy = sy - y0f;
    long long x0 = (long long)x0f, y0 = (long long)y0f;
    long long x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
    const T* base = img + (b / frames) * H * W * C + c;
    float res = blend(to_f(base[(y0 * W + x0) * C]),
                      to_f(base[(y0 * W + x1) * C]),
                      to_f(base[(y1 * W + x0) * C]),
                      to_f(base[(y1 * W + x1) * C]), wx, wy);
    if (masked) res = res * mask[pix];
    store(out + i, res);
  }
}

enum Route { SCALAR = 0, VEC = 1, PIXEL = 2, SCALAR64 = 3 };

template <typename T>
int launch(const void* img_, const void* flow_, const void* mask_, void* out_,
           long long B, long long H, long long W, long long C,
           long long frames, int masked, int route, cudaStream_t stream) {
  // the same float the plain version uses: double quotient rounded once
  double dw = W - 1.0 < 1e-6 ? 1e-6 : W - 1.0;
  double dh = H - 1.0 < 1e-6 ? 1e-6 : H - 1.0;
  float wf = (float)((double)W / dw), hf = (float)((double)H / dh);
  const T* img = static_cast<const T*>(img_);
  const float* flow = static_cast<const float*>(flow_);
  const float* mask = static_cast<const float*>(mask_);
  T* out = static_cast<T*>(out_);
  long long total = B * H * W * C;
  if (frames < 1 || B % frames != 0) return (int)cudaErrorInvalidValue;
  if (route == SCALAR64) {
    long long blocks = (total + 255) / 256;
    if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond this
    resample_scalar64_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
        img, flow, mask, out, B, H, W, C, frames, wf, hf, masked);
    return (int)cudaGetLastError();
  }
  if (route == SCALAR) {
    if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    resample_scalar_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0,
                                stream>>>(
        img, flow, mask, out, (unsigned)total, (unsigned)H, (unsigned)W,
        (unsigned)C, fast_div((unsigned)C), fast_div((unsigned)W),
        fast_div((unsigned)H), fast_div((unsigned)frames), wf, hf, masked);
    return (int)cudaGetLastError();
  }
  if (B * H * W >= (1LL << 31) || H * W * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  unsigned npix = (unsigned)(B * H * W);
  FastDiv dW = fast_div((unsigned)W), dH = fast_div((unsigned)H);
  FastDiv dF = fast_div((unsigned)frames);
  const float2* flow2 = static_cast<const float2*>(flow_);
  if (route == VEC) {
    constexpr int N = Chunk<T>::N;
    if (C % N != 0) return (int)cudaErrorInvalidValue;
    unsigned chunks = (unsigned)(C / N);
    unsigned lanes = chunks < 32 ? chunks : 32;
    unsigned rows = 256 / lanes;
    dim3 block(lanes, rows);
    unsigned blocks = (npix + rows - 1) / rows;
    resample_vec_kernel<T><<<blocks, block, 0, stream>>>(
        img, flow2, mask, out, npix, (unsigned)H, (unsigned)W, chunks, dW, dH,
        dF, wf, hf, masked);
    return (int)cudaGetLastError();
  }
  if (route != PIXEL) return (int)cudaErrorInvalidValue;
  unsigned blocks = (npix + PIXEL_THREADS - 1) / PIXEL_THREADS;
#define C2M_PIXEL(CC)                                                        \
  case CC:                                                                   \
    resample_pixel_kernel<T, CC><<<blocks, PIXEL_THREADS, 0, stream>>>(      \
        img, flow2, mask, out, npix, (unsigned)H, (unsigned)W, dW, dH, dF,   \
        wf, hf, masked);                                                     \
    break;
  switch (C) {
    C2M_PIXEL(1) C2M_PIXEL(2) C2M_PIXEL(3) C2M_PIXEL(4)
    default: return (int)cudaErrorInvalidValue;
  }
#undef C2M_PIXEL
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int c2m_resample_f32(const void* img, const void* flow,
                                const void* mask, void* out, long long B,
                                long long H, long long W, long long C,
                                long long frames, int masked, int route,
                                void* stream) {
  return launch<float>(img, flow, mask, out, B, H, W, C, frames, masked, route,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int c2m_resample_bf16(const void* img, const void* flow,
                                 const void* mask, void* out, long long B,
                                 long long H, long long W, long long C,
                                 long long frames, int masked, int route,
                                 void* stream) {
  return launch<__nv_bfloat16>(img, flow, mask, out, B, H, W, C, frames,
                               masked, route,
                               static_cast<cudaStream_t>(stream));
}
