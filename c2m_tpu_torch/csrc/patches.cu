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
// 2 reflect), kernel size and output size
struct Axis {
  int n, s, p, mode, k, out;
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
  *a = Axis{(int)n, (int)s, (int)p, mode, (int)k, (int)*out};
  return true;
}

// -- the adjoint of the gather: the input gradient of a chunk --------------
//
// The input gradient of the same convolution: grad_patches = grad_y x
// weight is one cuBLAS float32 GEMM (nn/layers.PatchConv, outside any
// kernel), and this kernel adds each element of that chunk of rows back
// into the input element the gather read it from, by the gather's own
// index rule, so that it is the exact adjoint of pad_spatial + unfold:
// zeros (a tap outside the input is dropped), edge (clamped: the border
// pixel takes every tap that clamped onto it) and reflect (folded: 1..p
// take the taps at -1..-p, n-1-p..n-2 those past the end).
//
// Replaces no TPU kernel: the JAX package differentiates its convolutions
// through XLA, and the port's train step gave them to cuDNN, whose float32
// backward (TF32 off) ran as FFT convolutions (complex GEMMs of 32x32
// tiles, region_transform, vector_fft) and implicit-GEMM dgrad engines:
// about 90 ms of a 363 ms journal train step on an H100 with the forward's
// FFT kernels beside them (the benchmark's ledger, cell journal.train).
//
// What bounds it: bytes. It reads grad_patches once (rows x K x 4 bytes)
// and reads and writes the input gradient once; it does no arithmetic but
// the sums and index arithmetic. Its design:
// - gather form, no atomics: a thread owns an input element (4 or 2
//   channels where C allows: 16- or 8-byte moves, as the gather) and walks
//   the (output pixel, tap) pairs of the chunk that read it, at most
//   ceil(k/s) per padded coordinate folding onto it per axis, summing in a
//   fixed order, so the gradient is the same bit for bit from run to run;
// - a block owns a run of one input line (b, t, h): the t and h axes'
//   pairs are the same for the whole block and are listed once in shared
//   memory; the w axis's are walked per thread from at most three ranges
//   of padded coordinates (folded low, direct, folded high);
// - one multiply-high division (Div) splits a thread's element into pixel
//   and channel;
// - reads: for C >= 32 a warp's threads that share a pixel read one
//   contiguous run of C floats of a row (the tap's channels), 128 bytes or
//   more.
// A chunk may split an image: the first chunk writes every element of the
// input gradient (0 where it has no pair), later chunks add into the lines
// they can touch (the host bounds that run of lines: layers and
// patches_kernel.adjoint_lines).

constexpr int MAX_PAIRS = 64;   // (output, tap) pairs of one t or h coordinate

// the padded coordinates u = j + p whose fold is input coordinate i, as
// three ascending ranges [lo, hi], empty where lo > hi: folded from below
// the input (edge: every u of the low pad at i = 0; reflect: u = p - i for
// 1 <= i <= p), the direct u = i + p, folded from above it
__device__ __forceinline__ void u_ranges(int i, const Axis& a, int* lo,
                                         int* hi) {
  lo[0] = 1;
  hi[0] = 0;
  if (a.mode == 1 && i == 0) {
    lo[0] = 0;
    hi[0] = a.p - 1;
  } else if (a.mode == 2 && i >= 1 && i <= a.p) {
    lo[0] = hi[0] = a.p - i;
  }
  lo[1] = hi[1] = i + a.p;
  lo[2] = 1;
  hi[2] = 0;
  if (a.mode == 1 && i == a.n - 1) {
    lo[2] = a.n + a.p;
    hi[2] = a.n + 2 * a.p - 1;
  } else if (a.mode == 2 && i >= a.n - 1 - a.p && i <= a.n - 2) {
    lo[2] = hi[2] = 2 * (a.n - 1) - i + a.p;
  }
}

// the first output coordinate whose window holds padded coordinate u
__device__ __forceinline__ int first_out(int u, const Axis& a) {
  const int x = u - a.k + 1;
  return x <= 0 ? 0 : (x + a.s - 1) / a.s;
}

// every (output coordinate, tap) pair of axis a that reads input coordinate
// i, in the order the sums take them; -> how many
__device__ int axis_pairs(int i, const Axis& a, int2* pairs) {
  int lo[3], hi[3];
  u_ranges(i, a, lo, hi);
  int n = 0;
  for (int r = 0; r < 3; ++r)
    for (int u = lo[r]; u <= hi[r]; ++u)
      for (int o = first_out(u, a), last = min(a.out - 1, u / a.s); o <= last;
           ++o)
        pairs[n++] = make_int2(o, u - o * a.s);
  return n;
}

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float2& a, const float2& b) {
  a.x += b.x;
  a.y += b.y;
}
__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

struct AdjointGeometry {
  Axis t, h, w;
  int kv, cv;              // K and C in moved elements
  Div c_div;               // cv
};

constexpr int ADJ_BLOCK_ELEMS = 2048;   // moved elements of a line a block owns

// block (x, y): input line line0 + x, elements [y, y + 1) x ADJ_BLOCK_ELEMS
// of it; out[line * W * cv + w * cv + c] (+)= sum over the chunk's pairs
template <typename V>
__global__ void __launch_bounds__(THREADS)
    adjoint_kernel(const V* __restrict__ gp, V* __restrict__ out,
                   AdjointGeometry g, long long line0, long long row0,
                   unsigned rows, int accumulate) {
  __shared__ int2 tp[MAX_PAIRS], hp[MAX_PAIRS];
  __shared__ int nt, nh;
  const long long line = line0 + blockIdx.x;
  const int h = (int)(line % g.h.n);
  const long long q = line / g.h.n;
  const int t = (int)(q % g.t.n);
  const long long b = q / g.t.n;
  if (threadIdx.x == 0) nt = axis_pairs(t, g.t, tp);
  if (threadIdx.x == 32) nh = axis_pairs(h, g.h, hp);
  __syncthreads();
  const int line_elems = g.w.n * g.cv;
  const int e1 = min((int)(blockIdx.y + 1) * ADJ_BLOCK_ELEMS, line_elems);
  V* dst = out + line * (long long)line_elems;
  for (int e = blockIdx.y * ADJ_BLOCK_ELEMS + threadIdx.x; e < e1;
       e += THREADS) {
    const int w = (int)quot(g.c_div, (unsigned)e);
    const int c = e - w * g.cv;
    int lo[3], hi[3];
    u_ranges(w, g.w, lo, hi);
    V acc = zero<V>();
    for (int it = 0; it < nt; ++it) {
      const int2 pt = tp[it];
      for (int ih = 0; ih < nh; ++ih) {
        const int2 ph = hp[ih];
        // the chunk's row of output (b, ot, oh, 0)
        const long long rb =
            ((b * g.t.out + pt.x) * g.h.out + ph.x) * (long long)g.w.out -
            row0;
        if (rb + g.w.out <= 0 || rb >= (long long)rows) continue;
        const int tap = (pt.y * g.h.k + ph.y) * g.w.k;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          for (int u = lo[r]; u <= hi[r]; ++u)
            for (int o = first_out(u, g.w), last = min(g.w.out - 1, u / g.w.s);
                 o <= last; ++o) {
              const long long row = rb + o;
              if (row < 0 || row >= (long long)rows) continue;
              add_to(acc, __ldg(gp + (unsigned)row * (unsigned)g.kv +
                                (unsigned)((tap + u - o * g.w.s) * g.cv + c)));
            }
        }
      }
    }
    if (accumulate) {
      V old = dst[e];
      add_to(old, acc);
      acc = old;
    }
    dst[e] = acc;
  }
}

template <typename V>
int launch_adjoint(const void* gp, void* out, const AdjointGeometry& g,
                   long long line0, long long lines, long long row0,
                   long long rows, int accumulate, cudaStream_t stream) {
  const long long line_elems = (long long)g.w.n * g.cv;
  const dim3 grid((unsigned)lines,
                  (unsigned)((line_elems + ADJ_BLOCK_ELEMS - 1) /
                             ADJ_BLOCK_ELEMS));
  adjoint_kernel<V><<<grid, THREADS, 0, stream>>>(
      static_cast<const V*>(gp), static_cast<V*>(out), g, line0, row0,
      (unsigned)rows, accumulate);
  return (int)cudaGetLastError();
}

// the most pairs axis_pairs can list for one coordinate of axis a: at most
// 1 + 2p padded coordinates fold onto it (edge on an axis of length 1),
// each read by at most ceil(k / s) outputs
bool pairs_fit(const Axis& a) {
  return (1LL + 2LL * a.p) * ((a.k + a.s - 1) / a.s) <= MAX_PAIRS;
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

// the input gradient of rows [row0, row0 + rows) of the patch matrix of a
// conv of x [B, T, H, W, C] float32: grad_patches [rows, kt * kh * kw * C]
// (the gather's layout) added back into out [B, T, H, W, C] along the
// gather's index rule, over the input lines [line0, line0 + lines) (a line
// is (b, t, h), all W x C of it); accumulate 0 writes those lines (0 where
// the chunk reads nothing), 1 adds into them; modes and width as
// c2m_conv_patches_f32 (width for both pointers)
extern "C" int c2m_conv_patches_adjoint_f32(
    const void* gp, void* out, long long B, long long T, long long H,
    long long W, long long C, long long kt, long long kh, long long kw,
    long long st, long long sh, long long sw, long long pt, long long ph,
    long long pw, int mt, int mh, int mw, long long row0, long long rows,
    long long line0, long long lines, int accumulate, int width,
    void* stream) {
  AdjointGeometry g;
  long long to, ho, wo;
  if (B <= 0 || C <= 0 || rows < 0 || row0 < 0 || line0 < 0 || lines < 0 ||
      !(width == 1 || width == 2 || width == 4) || C % width != 0 ||
      !make_axis(T, kt, st, pt, mt, &g.t, &to) ||
      !make_axis(H, kh, sh, ph, mh, &g.h, &ho) ||
      !make_axis(W, kw, sw, pw, mw, &g.w, &wo) || !pairs_fit(g.t) ||
      !pairs_fit(g.h))
    return (int)cudaErrorInvalidValue;
  const long long cv = C / width;
  const long long kv = kt * kh * kw * cv;
  if (row0 + rows > B * to * ho * wo || rows * kv > INT32_LIMIT ||
      line0 + lines > B * T * H || lines > INT32_LIMIT ||
      W * cv > INT32_LIMIT || (W * cv + ADJ_BLOCK_ELEMS - 1) /
      ADJ_BLOCK_ELEMS > 65535)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || lines == 0) return 0;
  g.kv = (int)kv;
  g.cv = (int)cv;
  g.c_div = make_div((unsigned)cv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 4)
    return launch_adjoint<float4>(gp, out, g, line0, lines, row0, rows,
                                  accumulate, s);
  if (width == 2)
    return launch_adjoint<float2>(gp, out, g, line0, lines, row0, rows,
                                  accumulate, s);
  return launch_adjoint<float>(gp, out, g, line0, lines, row0, rows,
                               accumulate, s);
}
