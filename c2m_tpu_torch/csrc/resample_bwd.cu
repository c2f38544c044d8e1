// Kernel K1, backward: the vector-Jacobian product of the bilinear resample
// of csrc/resample.cu,
//   out = bilinear_border(image, sx, sy) [* mask],
//   sx = (x + fx) * W/(W-1) - 0.5,  sy = (y + fy) * H/(H-1) - 0.5,
// coordinates clamped to the image before the floor.
//
// Replaces: nothing written for the TPU. The JAX package has no Pallas
// backward for c2m_tpu/ops/pallas/warp_kernels.py; its train step
// differentiates the jnp path (_resample_jnp, c2m_tpu/ops/warp.py:195) with
// jax.grad. The port's forward on the card is a CUDA kernel, so its backward
// is one too. This is what jax.grad of that function gives:
//   grad_image[b, y?, x?, c] += g * m * w??              at the four taps;
//   grad_flow[b, y, x, 0] = W/(W-1) * sum_c g * m * ((v10 - v00)(1 - wy)
//                                                    + (v11 - v01) wy),
//     and the y twin with H/(H-1); zero where the coordinate was clamped
//     (the gradient of the clamp; a coordinate exactly on the border passes
//     its gradient, as torch.clamp does), and floor carries none;
//   grad_mask[b, y, x, 0] = sum_c g * (unmasked warped value).
//
// What bounds it on the H100: memory, and within that the atomics. The image
// gradient is a scatter to data-dependent addresses: four float atomicAdds
// per element into a float32 buffer that the wrapper zeroes first (and casts
// once to bfloat16 at the end where the image is bfloat16; nothing is
// accumulated in bfloat16). Design: one thread per output element in NHWC
// order, as the forward, so the C threads of one pixel read and scatter to
// neighbouring channels of each tap (coalesced). The flow and mask gradients
// are sums over the channels of one pixel: the lanes of a warp that hold the
// same pixel (a contiguous run, found with __match_any_sync) add their terms
// with shuffles, and the run's first lane issues one atomicAdd per output
// (several warps share a pixel when C > 32). Gradients nobody asked for are
// skipped: without the flow and mask gradients the taps are not even read.
//
// Float atomics add in an order that changes from run to run, so the image
// gradient (and the flow and mask gradients when C > 32) are not
// bit-reproducible; they agree with autograd of the plain version to
// float32 summation error.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void resample_bwd_kernel(const T* __restrict__ gout,
                                    const T* __restrict__ img,
                                    const float* __restrict__ flow,
                                    const float* __restrict__ mask,
                                    float* __restrict__ gimg,
                                    float* __restrict__ gflow,
                                    float* __restrict__ gmask,
                                    long long B, long long H, long long W,
                                    long long C, float wf, float hf,
                                    int masked, int need_img, int need_flow,
                                    int need_mask) {
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
      long long base = b * H * W * C + c;
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

template <typename T>
int launch(const void* gout, const void* img, const void* flow,
           const void* mask, void* gimg, void* gflow, void* gmask,
           long long B, long long H, long long W, long long C, int masked,
           int need_img, int need_flow, int need_mask, cudaStream_t stream) {
  // the same floats as the forward: double quotient rounded once
  double dw = W - 1.0 < 1e-6 ? 1e-6 : W - 1.0;
  double dh = H - 1.0 < 1e-6 ? 1e-6 : H - 1.0;
  float wf = (float)((double)W / dw), hf = (float)((double)H / dh);
  long long total = B * H * W * C;
  int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond this
  resample_bwd_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(gout), static_cast<const T*>(img),
      static_cast<const float*>(flow), static_cast<const float*>(mask),
      static_cast<float*>(gimg), static_cast<float*>(gflow),
      static_cast<float*>(gmask), B, H, W, C, wf, hf, masked, need_img,
      need_flow, need_mask);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int c2m_resample_bwd_f32(const void* gout, const void* img,
                                    const void* flow, const void* mask,
                                    void* gimg, void* gflow, void* gmask,
                                    long long B, long long H, long long W,
                                    long long C, int masked, int need_img,
                                    int need_flow, int need_mask,
                                    void* stream) {
  return launch<float>(gout, img, flow, mask, gimg, gflow, gmask, B, H, W, C,
                       masked, need_img, need_flow, need_mask,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int c2m_resample_bwd_bf16(const void* gout, const void* img,
                                     const void* flow, const void* mask,
                                     void* gimg, void* gflow, void* gmask,
                                     long long B, long long H, long long W,
                                     long long C, int masked, int need_img,
                                     int need_flow, int need_mask,
                                     void* stream) {
  return launch<__nv_bfloat16>(gout, img, flow, mask, gimg, gflow, gmask, B, H,
                               W, C, masked, need_img, need_flow, need_mask,
                               static_cast<cudaStream_t>(stream));
}
