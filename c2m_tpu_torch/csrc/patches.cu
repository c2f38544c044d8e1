// The patch gather of a channels-last convolution (im2col): one chunk of
// rows of the patch matrix of a 2D or 3D convolution, the layer's padding
// applied on the fly, so that one float32 GEMM on cuBLAS computes the conv.
//
// Replaces no TPU kernel. The JAX package leaves its convolutions to XLA,
// and the port gave them to cuDNN, whose float32 engines (TF32 off) ran the
// serving forward's convolutions at 5-7 TFLOP/s on an H100 taken together:
// implicit GEMMs at 1-34 TFLOP/s, and at two 3x3 shapes of a 12-clip
// request the FFT path (complex GEMMs of 32x32 and 64x32 tiles, per
// frequency) at about 1 TFLOP/s, 20-150 ms each. The same convolution is
// the GEMM of this matrix (rows = output pixels, K = taps x C) with the
// weight (N = output channels), which cuBLAS's float32 GEMM runs at 17-40
// TFLOP/s there from 32 output channels up (nn/layers.patch_conv, outside
// any kernel). No padded copy of the input is written on the way:
// pad_spatial's index_select goes.
//
// What bounds it: bytes. It writes rows x K x 4 bytes and reads the input;
// each input pixel is read by up to taps rows, mostly out of L2. Its bound
// is the patch bytes written plus the input bytes read once, at 3.35 TB/s.
// It does no arithmetic but index arithmetic, which a first version (a
// thread per element, seven divisions each) let bound it where it moved 4
// bytes a thread: 3.6x its bound at C = 34. So a block owns a run of whole
// rows: it decomposes each row's index once into shared memory, and a tap's
// offsets come from a table there; a thread then walks its elements with
// one multiply-high division each (Div) and moves 16 or 8 bytes where C
// allows.
//
// Layout: input [B, T, H, W, C] contiguous (a 2D conv has T = 1, kt = 1).
// Row r of the chunk is output pixel row0 + r, counted over B x To x Ho x
// Wo in that order; it holds, tap after tap (dt, dh, dw), the C channels of
// the input pixel the tap reads: k = ((dt * kh + dh) * kw + dw) * C + c.
// A tap's C channels are then one contiguous run in the input and in the
// row, so a thread moves 4 channels (16 bytes) where C % 4 == 0 and both
// pointers are 16-byte aligned (route vec4), 2 where C is even (vec2: C =
// 2, 34 in the journal model), else one (scalar: C = 3). The weight is
// permuted to the same (taps, c) order once per call, by the layer.
//
// Padding, per axis, by pad_spatial's rule (nn/layers.py): zeros (a tap
// outside the input reads 0), edge (clamped into the input), reflect (|i|,
// then 2(n-1) - i past the end). The host passes edge for reflect on an
// axis no longer than its pad, as pad_spatial falls back there; a tap the
// mode leaves outside the input reads 0 and touches no memory.
//
// Indices: the element index inside a chunk is 32-bit (the wrapper keeps a
// chunk under 2^31 elements and the entry point refuses more); row and
// input offsets are 32-bit where the input and the row count stay under
// 2^31 elements, else 64-bit (wide).
//
// Times (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 18, device, the
// request's chunks together; bound in brackets): [60,128,256,64] 3x3 vec4
// 1.77 ms (1.50), [12,5,128,256,34] 3x3x3 vec2 3.09 (2.23), [60,128,256,3]
// 7x7 scalar 0.90 (0.35); the 44 convs of a 12-clip request about 21.5 ms
// (17.4). PERF.md section 6 has every shape.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCK_ELEMS = 2048;   // moved elements a block aims at (8 a thread)
constexpr int MAX_ROWS = 64;        // rows a block decomposes into shared memory
constexpr int MAX_TAPS = 1024;      // the tap table; kt, kh, kw < 1024 each
constexpr long long INT32_LIMIT = 2147483647LL;

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31 by one multiply-high (the
// method of PyTorch's IntDivider): m and s from d on the host
struct Div {
  unsigned d, m, s;
};

Div make_div(unsigned d) {
  unsigned s = 0;
  while (s < 32 && (1ull << s) < d) ++s;
  const unsigned long long one = 1;
  return Div{d, (unsigned)(((one << 32) * ((one << s) - d)) / d + 1), s};
}

__device__ __forceinline__ unsigned quot(const Div& v, unsigned n) {
  return (__umulhi(n, v.m) + n) >> v.s;
}

__device__ __forceinline__ long long quot(const Div& v, long long n) {
  return n / (long long)v.d;
}

// one spatial axis: input size, stride, pad, mode (0 zeros, 1 edge,
// 2 reflect)
struct Axis {
  int n, s, p, mode;
};

// the input coordinate i (tap offset added) as the axis's padding reads
// it; outside [0, n) only under zeros (or a reflect the host should have
// made edge), where it reads 0
__device__ __forceinline__ int fold(int i, const Axis& a) {
  if (a.mode == 2) {
    i = abs(i);
    if (i > a.n - 1) i = 2 * (a.n - 1) - i;
  } else if (a.mode == 1) {
    i = min(max(i, 0), a.n - 1);
  }
  return i;
}

struct Geometry {
  Axis t, h, w;
  int kt, kh, kw;
  int cv;                  // C in moved elements (float4, float2 or float)
  int kv;                  // K in moved elements: kt * kh * kw * cv
  int rows_per_block;      // whole rows a block writes
  int step_r, step_k;      // THREADS = step_r * kv + step_k
  Div k_div, c_div, wo, ho, to;   // kv, cv, Wo, Ho, To
};

// where a row's taps start: its image and each axis's first input
// coordinate before padding
struct RowBase {
  long long b;
  int t, h, w;
};

template <typename V>
__device__ __forceinline__ V zero() {
  V v;
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(V) / sizeof(float)); ++i) f[i] = 0.0f;
  return v;
}

// a block per run of rows_per_block rows of the chunk; out[r * kv + k]
template <typename V, typename Idx>
__global__ void __launch_bounds__(THREADS)
    patches_kernel(const V* __restrict__ x, V* __restrict__ out, Geometry g,
                   Idx row0, unsigned rows) {
  __shared__ int taps[MAX_TAPS];
  __shared__ RowBase base[MAX_ROWS];
  const unsigned first = blockIdx.x * (unsigned)g.rows_per_block;
  const int n_rows = (int)min((unsigned)g.rows_per_block, rows - first);
  const int n_taps = g.kt * g.kh * g.kw;
  for (int i = threadIdx.x; i < n_taps; i += THREADS) {
    const int dw = i % g.kw, th = i / g.kw;
    taps[i] = ((th / g.kh) << 20) | ((th % g.kh) << 10) | dw;
  }
  for (int i = threadIdx.x; i < n_rows; i += THREADS) {
    const Idx row = row0 + (Idx)(first + i);
    const Idx q1 = quot(g.wo, row);               // (b * To + to) * Ho + ho
    const Idx q2 = quot(g.ho, q1);                // b * To + to
    const Idx b = quot(g.to, q2);
    base[i] = RowBase{(long long)b,
                      (int)(q2 - b * (Idx)g.to.d) * g.t.s - g.t.p,
                      (int)(q1 - q2 * (Idx)g.ho.d) * g.h.s - g.h.p,
                      (int)(row - q1 * (Idx)g.wo.d) * g.w.s - g.w.p};
  }
  __syncthreads();
  V* dst = out + (size_t)first * g.kv;
  const unsigned n = (unsigned)n_rows * g.kv;
  unsigned r = quot(g.k_div, threadIdx.x);
  unsigned k = threadIdx.x - r * g.kv;
  for (unsigned e = threadIdx.x; e < n; e += THREADS) {
    const unsigned tap = quot(g.c_div, k);
    const unsigned c = k - tap * g.cv;
    const int packed = taps[tap];
    const RowBase rb = base[r];
    const int ti = fold(rb.t + (packed >> 20), g.t);
    const int hi = fold(rb.h + ((packed >> 10) & 1023), g.h);
    const int wi = fold(rb.w + (packed & 1023), g.w);
    V val = zero<V>();
    if ((unsigned)ti < (unsigned)g.t.n && (unsigned)hi < (unsigned)g.h.n &&
        (unsigned)wi < (unsigned)g.w.n)
      val = __ldg(x + (((((Idx)rb.b * g.t.n + ti) * g.h.n + hi) * g.w.n +
                        wi) * g.cv + c));
    dst[e] = val;
    r += g.step_r;
    k += g.step_k;
    if (k >= (unsigned)g.kv) {
      k -= g.kv;
      ++r;
    }
  }
}

template <typename V, typename Idx>
int launch(const void* x, void* out, const Geometry& g, long long row0,
           long long rows, cudaStream_t stream) {
  const unsigned blocks =
      (unsigned)((rows + g.rows_per_block - 1) / g.rows_per_block);
  patches_kernel<V, Idx><<<blocks, THREADS, 0, stream>>>(
      static_cast<const V*>(x), static_cast<V*>(out), g, (Idx)row0,
      (unsigned)rows);
  return (int)cudaGetLastError();
}

bool make_axis(long long n, long long k, long long s, long long p, int mode,
               Axis* a, long long* out) {
  if (n <= 0 || k <= 0 || s <= 0 || p < 0 || mode < 0 || mode > 2 ||
      n > INT32_LIMIT || p > INT32_LIMIT || k >= 1024 || s > INT32_LIMIT ||
      n + 2 * p < k || n + 2 * p > INT32_LIMIT)
    return false;
  *out = (n + 2 * p - k) / s + 1;
  *a = Axis{(int)n, (int)s, (int)p, mode};
  return true;
}

}  // namespace

// rows [row0, row0 + rows) of the patch matrix of x [B, T, H, W, C] float32
// into out [rows, kt * kh * kw * C]; modes per axis 0 zeros, 1 edge,
// 2 reflect; width: floats a thread moves, 4 (C % 4 == 0, x and out
// 16-byte aligned), 2 (C even, 8-byte aligned) or 1; wide: 64-bit row and
// input offsets
extern "C" int c2m_conv_patches_f32(
    const void* x, void* out, long long B, long long T, long long H,
    long long W, long long C, long long kt, long long kh, long long kw,
    long long st, long long sh, long long sw, long long pt, long long ph,
    long long pw, int mt, int mh, int mw, long long row0, long long rows,
    int width, int wide, void* stream) {
  Geometry g;
  long long to, ho, wo;
  if (B <= 0 || C <= 0 || rows < 0 || row0 < 0 ||
      !(width == 1 || width == 2 || width == 4) || C % width != 0 ||
      !make_axis(T, kt, st, pt, mt, &g.t, &to) ||
      !make_axis(H, kh, sh, ph, mh, &g.h, &ho) ||
      !make_axis(W, kw, sw, pw, mw, &g.w, &wo) || kt * kh * kw > MAX_TAPS)
    return (int)cudaErrorInvalidValue;
  const long long cv = C / width;
  const long long kv = kt * kh * kw * cv;
  const long long all_rows = B * to * ho * wo;
  if (row0 + rows > all_rows || rows * kv > INT32_LIMIT ||
      (!wide && (B * T * H * W * C > INT32_LIMIT || all_rows > INT32_LIMIT)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  g.kt = (int)kt;
  g.kh = (int)kh;
  g.kw = (int)kw;
  g.cv = (int)cv;
  g.kv = (int)kv;
  g.rows_per_block = (int)std::min<long long>(
      MAX_ROWS, std::max<long long>(1, BLOCK_ELEMS / kv));
  g.step_r = THREADS / g.kv;
  g.step_k = THREADS % g.kv;
  g.k_div = make_div((unsigned)kv);
  g.c_div = make_div((unsigned)cv);
  g.wo = make_div((unsigned)wo);
  g.ho = make_div((unsigned)ho);
  g.to = make_div((unsigned)to);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 4)
    return wide ? launch<float4, long long>(x, out, g, row0, rows, s)
                : launch<float4, unsigned>(x, out, g, row0, rows, s);
  if (width == 2)
    return wide ? launch<float2, long long>(x, out, g, row0, rows, s)
                : launch<float2, unsigned>(x, out, g, row0, rows, s);
  return wide ? launch<float, long long>(x, out, g, row0, rows, s)
              : launch<float, unsigned>(x, out, g, row0, rows, s);
}
