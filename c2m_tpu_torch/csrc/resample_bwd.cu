// Kernel K1, backward: the vector-Jacobian product of the bilinear resample
// of csrc/resample.cu,
//   out = bilinear_border(image[b / frames], sx, sy) [* mask],
//   sx = (x + fx) * W/(W-1) - 0.5,  sy = (y + fy) * H/(H-1) - 0.5,
// coordinates clamped to the image before the floor.
//
// Replaces: nothing written for the TPU. The JAX package has no Pallas
// backward for c2m_tpu/ops/pallas/warp_kernels.py; its train step
// differentiates the jnp path (_resample_jnp, c2m_tpu/ops/warp.py:195) with
// jax.grad. The port's forward on the card is a CUDA kernel, so its backward
// is one too. This is what jax.grad of that function gives:
//   grad_image[b / frames, y?, x?, c] += g * m * w??     at the four taps;
//   grad_flow[b, y, x, 0] = W/(W-1) * sum_c g * m * ((v10 - v00)(1 - wy)
//                                                    + (v11 - v01) wy),
//     and the y twin with H/(H-1); zero where the coordinate was clamped
//     (the gradient of the clamp; a coordinate exactly on the border passes
//     its gradient, as torch.clamp does), and floor carries none;
//   grad_mask[b, y, x, 0] = sum_c g * (unmasked warped value).
// With frames > 1 the T frames of one image add into one image gradient:
// the caller passes the image once (the forward's frames-per-image count)
// and no T-fold gradient is summed afterwards.
//
// What bounds it on the H100: the image gradient. It is a scatter to
// data-dependent addresses, float32 atomics into a buffer the wrapper zeroes
// (and casts once to bfloat16 where the image is bfloat16; nothing is
// accumulated in bfloat16), so the L2's atomic units, not the bytes that
// must move, set the pace: four taps of C float32 additions per output
// pixel. The rest reads the upstream gradient, the flow and the mask once
// and, for the flow and mask gradients, the taps (neighbouring pixels share
// them in L1/L2), and writes the flow and mask gradients.
//
// The first version (route 3 below) had the costs the forward's first
// version had, and more: one thread per element with five 64-bit divisions,
// the pixel's coordinate, clamp and weights redone by each of its C threads,
// 2-byte loads in bfloat16, four scalar float atomics per element, and the
// flow and mask sums found with __match_any_sync and five rounds of three
// shuffles per element, finished with atomics into zeroed buffers. This
// version lays the work out as the forward does:
//
//   route 1 "vec"    C % 4 == 0, base pointers 16-byte aligned: a lane owns
//                    pieces of 4 channels of one pixel (8 bytes of bfloat16
//                    or 16 of float32 read at once), a group of G lanes a
//                    pixel, G = C/4 rounded up to a power of two, at most 32
//                    where the flow or mask gradient is asked for (else at
//                    most 256: the decoder skips' 512 channels spread over
//                    128 lanes). The coordinate, clamps, weights, tap
//                    offsets and the mask are computed once per lane, with
//                    32-bit offsets and multiply-high divisions. The image
//                    gradient of a piece is one 16-byte vector atomic a tap
//                    (atomicAdd(float4*, float4): RED.F32x4, global memory,
//                    compute capability 9.x), and the lanes of a warp cover
//                    one contiguous run of 512 bytes with it. A pixel's flow
//                    and mask sums never leave its lane group: each lane
//                    adds its pieces in order, then the group adds across
//                    lanes with xor shuffles, and lane 0 stores the result.
//                    No atomics and no zero-fill for those two, and the
//                    result does not change from run to run.
//                    (Pieces of 8 bfloat16 channels, as the forward reads
//                    them, were tried first: each lane's two float4 atomics
//                    a tap then land 32 bytes apart across the warp, and the
//                    kernel took 1.3-2x as long. Four scalar atomics in place
//                    of each float4 one: 3-4x as long. PERF.md section 6.)
//   route 2 "pixel"  C <= 3 (frames, flows), C at compile time: a lane owns a
//                    pixel, reads its C upstream values and four taps of C
//                    channels, adds its channels in order and stores the
//                    flow and mask gradients; the image gradient goes out
//                    by one float2 atomic a tap at C = 2, else C scalar ones.
//   route 3 "scalar64" the first version: one thread per element, 64-bit
//                    indices and plain divisions, atomics for all three
//                    gradients into zeroed buffers. It takes every shape:
//                    the wrapper sends it what routes 1-2 do not take (odd
//                    C above 3, unaligned views, 2^31 pixels and more).
//
// The wrapper (c2m_tpu_torch/ops/hopper/warp_kernels.py,
// resample_backward_route) picks the route; routes 1-2 need B*H*W < 2^31
// and H*W*C < 2^31. resample_backward_plain there is the decomposition of
// routes 1-2 in PyTorch: per-tap index_add_ for the image gradient and the
// lane-group order of the flow and mask sums.
//
// Times (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 3, the kernel
// alone by torch.profiler): bfloat16 x mask [10,64,128,256], three
// gradients, 0.129 ms (first version 0.334); the long-horizon skip
// [10,128,256,64] at frames = 10, image gradient, 0.089 (0.188). PERF.md
// section 6 has every shape.
//
// Float atomics add in an order that changes from run to run, so the image
// gradient (and, on route 3, the flow and mask gradients) are not
// bit-reproducible; they agree with autograd of the plain version to
// float32 summation error.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// n / d for n < 2^31 by one multiply-high and one shift (as csrc/resample.cu)
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

// A pixel's sampling record, as the forward's taps_of, plus whether each
// coordinate lay inside the image before the clamp (else its gradient is 0).
struct Taps {
  float wx, wy;
  unsigned p00;      // y0 * W + x0
  unsigned dx, dy;   // x1 - x0 in pixels, (y1 - y0) * W in pixels
  bool in_x, in_y;
};

__device__ __forceinline__ Taps taps_of(float fx, float fy, unsigned x,
                                        unsigned y, unsigned H, unsigned W,
                                        float wf, float hf) {
  float sx = ((float)x + fx) * wf - 0.5f;
  float sy = ((float)y + fy) * hf - 0.5f;
  Taps t;
  t.in_x = sx >= 0.0f && sx <= (float)(W - 1);
  t.in_y = sy >= 0.0f && sy <= (float)(H - 1);
  sx = fminf(fmaxf(sx, 0.0f), (float)(W - 1));
  sy = fminf(fmaxf(sy, 0.0f), (float)(H - 1));
  float x0f = floorf(sx), y0f = floorf(sy);
  t.wx = sx - x0f;
  t.wy = sy - y0f;
  unsigned x0 = (unsigned)x0f, y0 = (unsigned)y0f;
  t.p00 = y0 * W + x0;
  t.dx = x0 + 1 < W ? 1u : 0u;
  t.dy = y0 + 1 < H ? W : 0u;
  return t;
}

// One channel's terms of the three sums, in the first version's order.
struct Terms {
  float fx, fy, m;
};

__device__ __forceinline__ void add_terms(Terms& acc, float g, float gm,
                                          float v00, float v10, float v01,
                                          float v11, const Taps& t,
                                          bool need_flow, bool need_mask) {
  if (need_flow) {
    if (t.in_x)
      acc.fx += gm * ((v10 - v00) * (1.0f - t.wy) + (v11 - v01) * t.wy);
    if (t.in_y)
      acc.fy += gm * ((v01 - v00) * (1.0f - t.wx) + (v11 - v10) * t.wx);
  }
  if (need_mask) {
    float top = v00 * (1.0f - t.wx) + v10 * t.wx;
    float bot = v01 * (1.0f - t.wx) + v11 * t.wx;
    acc.m += g * (top * (1.0f - t.wy) + bot * t.wy);
  }
}

// A lane's piece of a pixel's channels: N channels of type T, loaded as one
// V. The image gradient of a piece is N/4 float4 atomics, so a piece of 4
// channels (16 bytes of float32, 8 of bfloat16) makes a warp's float4
// atomics one contiguous run (512 bytes).
template <typename T, int N> struct Piece;
template <> struct Piece<float, 4> {
  using V = uint4;
  __device__ static void unpack(const V& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
};
template <> struct Piece<__nv_bfloat16, 4> {
  using V = uint2;
  __device__ static void unpack(const V& u, float* f) {
    // a bfloat16 is the upper half of the float32 of the same value
    f[0] = __uint_as_float(u.x << 16);
    f[1] = __uint_as_float(u.x & 0xffff0000u);
    f[2] = __uint_as_float(u.y << 16);
    f[3] = __uint_as_float(u.y & 0xffff0000u);
  }
};
// N float32 values added into 16-byte aligned global memory, 4 at a time
// (one RED.F32x4 each).
template <int N>
__device__ __forceinline__ void scatter(float* p, const float* v, float w) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    atomicAdd(reinterpret_cast<float4*>(p + i),
              make_float4(v[i] * w, v[i + 1] * w, v[i + 2] * w, v[i + 3] * w));
}

constexpr int THREADS = 256;

// Route 1. A 1-D block of 256 threads; lanes [k*G, (k+1)*G) own pixel
// blockIdx.x * (256 / G) + k, a lane its pieces lane, lane + G, ... G is a
// power of two; where the flow or mask gradient is asked for it is at most
// 32, so a group never straddles a warp and its shuffles name its own lanes
// only.
template <typename T, int N>
__global__ void __launch_bounds__(THREADS) resample_bwd_vec_kernel(
    const T* __restrict__ gout, const T* __restrict__ img,
    const float2* __restrict__ flow, const float* __restrict__ mask,
    float* __restrict__ gimg, float2* __restrict__ gflow,
    float* __restrict__ gmask, unsigned npix, unsigned H, unsigned W,
    unsigned chunks, unsigned G, FastDiv divW, FastDiv divH, FastDiv divF,
    float wf, float hf, int masked, int need_img, int need_flow,
    int need_mask) {
  using P = Piece<T, N>;
  using V = typename P::V;
  unsigned lane = threadIdx.x % G;
  unsigned pix = blockIdx.x * (THREADS / G) + threadIdx.x / G;
  if (pix >= npix) return;                 // the whole group leaves together
  unsigned row = divW.div(pix);            // b * H + y
  unsigned x = pix - row * W;
  unsigned b = divH.div(row);
  unsigned y = row - b * H;
  float2 f = flow[pix];
  float m = masked ? mask[pix] : 1.0f;
  Taps t = taps_of(f.x, f.y, x, y, H, W, wf, hf);
  size_t p00 = (size_t)divF.div(b) * H * W + t.p00;   // pixel of the image
  const V* r0 = reinterpret_cast<const V*>(img) + p00 * chunks;
  const V* r1 = r0 + t.dy * chunks;
  unsigned dxc = t.dx * chunks;
  const V* go = reinterpret_cast<const V*>(gout) + (size_t)pix * chunks;
  unsigned C = chunks * N;
  float* q0 = gimg + p00 * C;
  float* q1 = q0 + (size_t)t.dy * C;
  unsigned dxe = t.dx * C;
  bool need_taps = need_flow || need_mask;
  Terms acc = {0.0f, 0.0f, 0.0f};
  for (unsigned ch = lane; ch < chunks; ch += G) {
    float g[N], gm[N];
    P::unpack(go[ch], g);
#pragma unroll
    for (int i = 0; i < N; ++i) gm[i] = masked ? g[i] * m : g[i];
    if (need_img) {
      float gt[N], gb[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        gt[i] = gm[i] * (1.0f - t.wy);
        gb[i] = gm[i] * t.wy;
      }
      unsigned e = ch * N;
      scatter<N>(q0 + e, gt, 1.0f - t.wx);
      scatter<N>(q0 + dxe + e, gt, t.wx);
      scatter<N>(q1 + e, gb, 1.0f - t.wx);
      scatter<N>(q1 + dxe + e, gb, t.wx);
    }
    if (need_taps) {
      float v00[N], v10[N], v01[N], v11[N];
      P::unpack(r0[ch], v00);
      P::unpack(r0[dxc + ch], v10);
      P::unpack(r1[ch], v01);
      P::unpack(r1[dxc + ch], v11);
#pragma unroll
      for (int i = 0; i < N; ++i)
        add_terms(acc, g[i], gm[i], v00[i], v10[i], v01[i], v11[i], t,
                  need_flow, need_mask);
    }
  }
  if (!need_taps) return;
  // the group's lanes, within its warp
  unsigned warp_lane = threadIdx.x & 31u;
  unsigned peers = G == 32 ? 0xffffffffu
                           : ((1u << G) - 1u) << (warp_lane & ~(G - 1u));
  for (unsigned o = G >> 1; o > 0; o >>= 1) {
    acc.fx += __shfl_xor_sync(peers, acc.fx, o);
    acc.fy += __shfl_xor_sync(peers, acc.fy, o);
    acc.m += __shfl_xor_sync(peers, acc.m, o);
  }
  if (lane == 0) {
    if (need_flow) gflow[pix] = make_float2(acc.fx * wf, acc.fy * hf);
    if (need_mask) gmask[pix] = acc.m;
  }
}

// Route 2. A lane owns a pixel of C <= 3 channels.
template <typename T, int C>
__global__ void __launch_bounds__(THREADS) resample_bwd_pixel_kernel(
    const T* __restrict__ gout, const T* __restrict__ img,
    const float2* __restrict__ flow, const float* __restrict__ mask,
    float* __restrict__ gimg, float2* __restrict__ gflow,
    float* __restrict__ gmask, unsigned npix, unsigned H, unsigned W,
    FastDiv divW, FastDiv divH, FastDiv divF, float wf, float hf, int masked,
    int need_img, int need_flow, int need_mask) {
  unsigned pix = blockIdx.x * THREADS + threadIdx.x;
  if (pix >= npix) return;
  unsigned row = divW.div(pix);
  unsigned x = pix - row * W;
  unsigned b = divH.div(row);
  unsigned y = row - b * H;
  float2 f = flow[pix];
  float m = masked ? mask[pix] : 1.0f;
  Taps t = taps_of(f.x, f.y, x, y, H, W, wf, hf);
  size_t p00 = (size_t)divF.div(b) * H * W + t.p00;
  const T* r0 = img + p00 * C;
  const T* r1 = r0 + (size_t)t.dy * C;
  unsigned dx = t.dx * C;
  float* q0 = gimg + p00 * C;
  float* q1 = q0 + (size_t)t.dy * C;
  const T* go = gout + (size_t)pix * C;
  Terms acc = {0.0f, 0.0f, 0.0f};
  float gm2[2] = {0.0f, 0.0f};             // C == 2: one float2 atomic a tap
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float g = to_f(go[c]);
    float gm = masked ? g * m : g;
    if (need_img && C != 2) {
      float gt = gm * (1.0f - t.wy), gb = gm * t.wy;
      atomicAdd(q0 + c, gt * (1.0f - t.wx));
      atomicAdd(q0 + dx + c, gt * t.wx);
      atomicAdd(q1 + c, gb * (1.0f - t.wx));
      atomicAdd(q1 + dx + c, gb * t.wx);
    }
    if (need_img && C == 2) gm2[c] = gm;
    if (need_flow || need_mask)
      add_terms(acc, g, gm, to_f(r0[c]), to_f(r0[dx + c]), to_f(r1[c]),
                to_f(r1[dx + c]), t, need_flow, need_mask);
  }
  if (need_img && C == 2) {
    float t0 = gm2[0] * (1.0f - t.wy), t1 = gm2[1] * (1.0f - t.wy);
    float b0 = gm2[0] * t.wy, b1 = gm2[1] * t.wy;
    atomicAdd(reinterpret_cast<float2*>(q0),
              make_float2(t0 * (1.0f - t.wx), t1 * (1.0f - t.wx)));
    atomicAdd(reinterpret_cast<float2*>(q0 + dx),
              make_float2(t0 * t.wx, t1 * t.wx));
    atomicAdd(reinterpret_cast<float2*>(q1),
              make_float2(b0 * (1.0f - t.wx), b1 * (1.0f - t.wx)));
    atomicAdd(reinterpret_cast<float2*>(q1 + dx),
              make_float2(b0 * t.wx, b1 * t.wx));
  }
  if (need_flow) gflow[pix] = make_float2(acc.fx * wf, acc.fy * hf);
  if (need_mask) gmask[pix] = acc.m;
}

// Route 3, the first version (see the note at the top), with the image row
// b / frames.
template <typename T>
__global__ void resample_bwd_scalar64_kernel(
    const T* __restrict__ gout, const T* __restrict__ img,
    const float* __restrict__ flow, const float* __restrict__ mask,
    float* __restrict__ gimg, float* __restrict__ gflow,
    float* __restrict__ gmask, long long B, long long H, long long W,
    long long C, long long frames, float wf, float hf, int masked,
    int need_img, int need_flow, int need_mask) {
  const unsigned full = 0xffffffffu;
  long long total = B * H * W * C;
  // whole warps enter the loop together: the bound is rounded up to 32 and
  // both the first index of a warp and the stride are multiples of 32
  long long padded = (total + 31) / 32 * 32;
  int lane = threadIdx.x & 31;
  bool need_taps = need_flow || need_mask;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < padded; i += (long long)gridDim.x * blockDim.x) {
    bool valid = i < total;
    long long pix = valid ? i / C : -1;      // b*H*W + y*W + x
    float cfx = 0.0f, cfy = 0.0f, cm = 0.0f;
    if (valid) {
      long long c = i % C;
      long long x = pix % W;
      long long y = (pix / W) % H;
      long long b = pix / (H * W);
      float sx = ((float)x + flow[pix * 2 + 0]) * wf - 0.5f;
      float sy = ((float)y + flow[pix * 2 + 1]) * hf - 0.5f;
      bool in_x = sx >= 0.0f && sx <= (float)(W - 1);
      bool in_y = sy >= 0.0f && sy <= (float)(H - 1);
      sx = fminf(fmaxf(sx, 0.0f), (float)(W - 1));
      sy = fminf(fmaxf(sy, 0.0f), (float)(H - 1));
      float x0f = floorf(sx), y0f = floorf(sy);
      float wx = sx - x0f, wy = sy - y0f;
      long long x0 = (long long)x0f, y0 = (long long)y0f;
      long long x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
      x0 = min(max(x0, 0LL), W - 1);
      y0 = min(max(y0, 0LL), H - 1);
      long long base = (b / frames) * H * W * C + c;
      long long o00 = base + (y0 * W + x0) * C, o10 = base + (y0 * W + x1) * C;
      long long o01 = base + (y1 * W + x0) * C, o11 = base + (y1 * W + x1) * C;
      float g = to_f(gout[i]);
      float gm = masked ? g * mask[pix] : g;
      if (need_img) {
        float gt = gm * (1.0f - wy), gb = gm * wy;
        atomicAdd(gimg + o00, gt * (1.0f - wx));
        atomicAdd(gimg + o10, gt * wx);
        atomicAdd(gimg + o01, gb * (1.0f - wx));
        atomicAdd(gimg + o11, gb * wx);
      }
      if (need_taps) {
        float v00 = to_f(img[o00]), v10 = to_f(img[o10]);
        float v01 = to_f(img[o01]), v11 = to_f(img[o11]);
        if (need_flow) {
          if (in_x) cfx = gm * ((v10 - v00) * (1.0f - wy) + (v11 - v01) * wy);
          if (in_y) cfy = gm * ((v01 - v00) * (1.0f - wx) + (v11 - v10) * wx);
        }
        if (need_mask) {
          float top = v00 * (1.0f - wx) + v10 * wx;
          float bot = v01 * (1.0f - wx) + v11 * wx;
          cm = g * (top * (1.0f - wy) + bot * wy);
        }
      }
    }
    if (need_taps) {
      // lanes of one pixel are a contiguous run; add within the run
      unsigned peers = __match_any_sync(full, pix);
      for (int o = 16; o > 0; o >>= 1) {
        float ox = __shfl_down_sync(full, cfx, o);
        float oy = __shfl_down_sync(full, cfy, o);
        float om = __shfl_down_sync(full, cm, o);
        if (lane + o < 32 && ((peers >> (lane + o)) & 1u)) {
          cfx += ox;
          cfy += oy;
          cm += om;
        }
      }
      if (valid && lane == __ffs(peers) - 1) {
        if (need_flow) {
          atomicAdd(gflow + pix * 2 + 0, cfx * wf);
          atomicAdd(gflow + pix * 2 + 1, cfy * hf);
        }
        if (need_mask) atomicAdd(gmask + pix, cm);
      }
    }
  }
}

enum Route { VEC = 1, PIXEL = 2, SCALAR64 = 3 };

template <typename T>
int launch(const void* gout_, const void* img_, const void* flow_,
           const void* mask_, void* gimg_, void* gflow_, void* gmask_,
           long long B, long long H, long long W, long long C,
           long long frames, int masked, int need_img, int need_flow,
           int need_mask, int route, cudaStream_t stream) {
  // the same floats as the forward: double quotient rounded once
  double dw = W - 1.0 < 1e-6 ? 1e-6 : W - 1.0;
  double dh = H - 1.0 < 1e-6 ? 1e-6 : H - 1.0;
  float wf = (float)((double)W / dw), hf = (float)((double)H / dh);
  const T* gout = static_cast<const T*>(gout_);
  const T* img = static_cast<const T*>(img_);
  const float* mask = static_cast<const float*>(mask_);
  float* gimg = static_cast<float*>(gimg_);
  float* gmask = static_cast<float*>(gmask_);
  if (frames < 1 || B % frames != 0) return (int)cudaErrorInvalidValue;
  if (route == SCALAR64) {
    long long total = B * H * W * C;
    long long blocks = (total + THREADS - 1) / THREADS;
    if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond this
    resample_bwd_scalar64_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
        gout, img, static_cast<const float*>(flow_), mask, gimg,
        static_cast<float*>(gflow_), gmask, B, H, W, C, frames, wf, hf,
        masked, need_img, need_flow, need_mask);
    return (int)cudaGetLastError();
  }
  if (B * H * W >= (1LL << 31) || H * W * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  unsigned npix = (unsigned)(B * H * W);
  FastDiv dW = fast_div((unsigned)W), dH = fast_div((unsigned)H);
  FastDiv dF = fast_div((unsigned)frames);
  const float2* flow = static_cast<const float2*>(flow_);
  float2* gflow = static_cast<float2*>(gflow_);
  if (route == VEC) {
    if (C % 4 != 0) return (int)cudaErrorInvalidValue;
    unsigned chunks = (unsigned)(C / 4);
    // lanes of a pixel: its pieces, rounded up to a power of two; at most a
    // warp where the flow or mask sums are taken, else at most the block
    unsigned cap = need_flow || need_mask ? 32 : THREADS;
    unsigned G = 1;
    while (G < chunks && G < cap) G <<= 1;
    unsigned blocks = (npix + THREADS / G - 1) / (THREADS / G);
    resample_bwd_vec_kernel<T, 4><<<blocks, THREADS, 0, stream>>>(
        gout, img, flow, mask, gimg, gflow, gmask, npix, (unsigned)H,
        (unsigned)W, chunks, G, dW, dH, dF, wf, hf, masked, need_img,
        need_flow, need_mask);
    return (int)cudaGetLastError();
  }
  if (route != PIXEL) return (int)cudaErrorInvalidValue;
  unsigned blocks = (npix + THREADS - 1) / THREADS;
#define C2M_PIXEL(CC)                                                        \
  case CC:                                                                   \
    resample_bwd_pixel_kernel<T, CC><<<blocks, THREADS, 0, stream>>>(        \
        gout, img, flow, mask, gimg, gflow, gmask, npix, (unsigned)H,        \
        (unsigned)W, dW, dH, dF, wf, hf, masked, need_img, need_flow,        \
        need_mask);                                                          \
    break;
  switch (C) {
    C2M_PIXEL(1) C2M_PIXEL(2) C2M_PIXEL(3)
    default: return (int)cudaErrorInvalidValue;
  }
#undef C2M_PIXEL
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int c2m_resample_bwd_f32(const void* gout, const void* img,
                                    const void* flow, const void* mask,
                                    void* gimg, void* gflow, void* gmask,
                                    long long B, long long H, long long W,
                                    long long C, long long frames, int masked,
                                    int need_img, int need_flow, int need_mask,
                                    int route, void* stream) {
  return launch<float>(gout, img, flow, mask, gimg, gflow, gmask, B, H, W, C,
                       frames, masked, need_img, need_flow, need_mask, route,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int c2m_resample_bwd_bf16(const void* gout, const void* img,
                                     const void* flow, const void* mask,
                                     void* gimg, void* gflow, void* gmask,
                                     long long B, long long H, long long W,
                                     long long C, long long frames,
                                     int masked, int need_img, int need_flow,
                                     int need_mask, int route, void* stream) {
  return launch<__nv_bfloat16>(gout, img, flow, mask, gimg, gflow, gmask, B, H,
                               W, C, frames, masked, need_img, need_flow,
                               need_mask, route,
                               static_cast<cudaStream_t>(stream));
}
