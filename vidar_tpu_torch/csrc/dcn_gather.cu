// Modulated deformable-conv tap sampling in f32, no conv (K9).
//
// Replaces vidar_tpu/ops/dcn_pallas.py: dcn_gather (called through
// dcn_sample, the f32 path of vidar_tpu/models/resnet.py:137-145). For each
// output pixel q and tap t it samples the f32 input x [B, H, W, C]
// bilinearly at pixel coordinates (sy[q,t], sx[q,t]), a corner off the map
// reading zero (the TPU kernel's zero ring), and multiplies the sample by
// the modulation mask: taps [B, Q, 9, C] f32. The conv kernel is applied
// outside, by a matrix product, as in the JAX package.
//
// What bounds it on the H100: the output. At ResNet-101 stage 3 over the 30
// images of a full window (58x100, C = 256) it writes 1.6 GB of taps and
// needs 178 MB of input, so it is bound by bytes (0.54 ms at 3.35 TB/s).
// The TPU kernel packs the four corners of every pixel into one 128-lane
// row of a VMEM table. The first design here (one warp per (image, pixel,
// tap), its lanes over the channels, every corner row read from global
// memory) read 4 corner rows per tap: 6.3 GB through L1 and L2 against
// the 1.6 GB it wrote, since the 8 taps of a block share few rows and
// neighbouring blocks run on other SMs.
//
// This design tiles. Where Q = H*W (the ResNet DCN: 3x3, stride 1, pad 1)
// a block owns a tile of TR x TC = 2 x 16 output pixels (all 9 taps) of one
// image over a slice of 64 channels, and
//   1. stages the tile's window of x, its rows and columns and two more on
//      each side (6 x 20 pixels, the corners of every tap displaced by less
//      than a pixel), 64 channels a pixel, in shared memory with 16-byte
//      cp.async copies;
//   2. while the copies fly, writes for every (pixel, tap) its four corner
//      sources (a window slot; a pixel of x for a corner on the map outside
//      the window, which trained offsets make common; or none off the map),
//      corner weights and mask into shared-memory tables;
//   3. then each half-warp makes one (pixel, tap) at a time, a lane 4
//      channels, from the window (or an __ldg of x), and writes it with a
//      streaming store (st.global.cs).
// Corner traffic through L2 falls from 4 rows a tap to (TR + 4) x (TC + 4)
// / (9 TR TC) = 0.42 of a row a tap. The sum keeps the plain version's order, (((c00 w00 + c01 w01) + c10 w10) +
// c11 w11) x mask, without fused multiply-adds, and skips a corner off the
// map (its term is an exact zero), so the taps equal the plain version's,
// and the first design's, bit for bit up to the sign of a zero.
//
// Measured (tools/kernel_ab.py, device time, NVIDIA H100 80GB HBM3 at
// 700.00 W, against the first design in the same process): the window's
// stage 3 0.644 ms (0.905; 83% of the bound), its stage 4 0.324 (0.392),
// the fine-tune step's 24-image calls 0.516 and 0.260 (0.724, 0.314), its
// one-image calls 0.025 (0.034) at stage 3 and 0.016 (0.014) at stage 4,
// whose 480 blocks are less than one wave and too few warps to keep the
// stores flowing. Timed variants at stage 3: with no corner reads (the
// writes alone) 0.553 ms; with no window (corners through L1, same tiles)
// 0.678; with plain stores 0.645; 1 x 16 tiles 0.705, 4 x 16 0.663, 2 x 8
// 0.697; a window fitted to the tile's corners by a block reduction before
// the copies 0.645.
//
// A Q other than H*W (no DCN of the models), a C that is not a multiple of
// 4, or an x or output that does not start on a 16-byte boundary, takes a
// scalar kernel with the same arithmetic, one
// thread per (image, pixel, tap, channel), as K10 does
// (csrc/dcn_gather16.cu). dcn_sample_route names the kernel a call takes.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int TAPS = 9;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNKS = 16;  // float4 chunks of a pixel's channel slice
constexpr int SLICE = 4 * CHUNKS;  // channels of a block
constexpr int HALO = 4;  // window rows (columns) beyond the tile's
constexpr int OFF_MAP = INT_MIN;  // a corner source off the map

constexpr int TR = 2, TC = 16;  // a tile's output rows and columns
constexpr int ITEMS = TR * TC * TAPS;  // its (pixel, tap) pairs
constexpr int WPIX = (TR + HALO) * (TC + HALO);  // its window's pixels

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

__device__ __forceinline__ float4 madd(float4 acc, float4 v, float w) {
  return make_float4(__fadd_rn(acc.x, __fmul_rn(v.x, w)),
                     __fadd_rn(acc.y, __fmul_rn(v.y, w)),
                     __fadd_rn(acc.z, __fmul_rn(v.z, w)),
                     __fadd_rn(acc.w, __fmul_rn(v.w, w)));
}

__global__ void __launch_bounds__(THREADS)
dcn_gather_tile_kernel(const float* __restrict__ x,
                       const float* __restrict__ sx,
                       const float* __restrict__ sy,
                       const float* __restrict__ mask,
                       float* __restrict__ out, int H, int W, int C,
                       int tiles_r, int tiles_c, int slices) {
  // the window, then per (pixel, tap) its corner sources, corner weights
  // and mask, then the tile's output pixels (41 KB)
  __shared__ float4 win[WPIX * CHUNKS];
  __shared__ int4 src[ITEMS];
  __shared__ float4 cw[ITEMS];
  __shared__ float msk[ITEMS];
  __shared__ int qidx[TR * TC];

  const int tid = threadIdx.x;
  int t = blockIdx.x;
  const int slice = t % slices;
  t /= slices;
  const int tcol = t % tiles_c;
  t /= tiles_c;
  const int trow = t % tiles_r;
  const long long b = t / tiles_r;
  const int r0 = trow * TR, c0 = tcol * TC;
  const int nvc = min(TC, W - c0);
  const int items = min(TR, H - r0) * nvc * TAPS;
  const int ch0 = slice * SLICE;
  const int cs = min(CHUNKS, (C - ch0) >> 2);  // chunks in this slice
  const long long row0 = b * H * W * TAPS;     // the image's first tap row

  // 1. the window: the tile's rows and columns and HALO / 2 beyond them on
  // each side, cut to the map
  const int wy0 = max(r0 - HALO / 2, 0), wx0 = max(c0 - HALO / 2, 0);
  const int wr = min(r0 + TR + HALO / 2, H) - wy0;
  const int wc = min(c0 + TC + HALO / 2, W) - wx0;
  const float* xb = x + b * H * W * C + ch0;
  {
    const int j = tid & (CHUNKS - 1);
    if (j < cs) {
      for (int p = tid / CHUNKS; p < wr * wc; p += THREADS / CHUNKS) {
        const int r = p / wc, c = p - r * wc;
        cp_async16(win + p * CHUNKS + j,
                   xb + ((long long)(wy0 + r) * W + wx0 + c) * C + 4 * j);
      }
    }
  }

  // 2. while the copies fly, per (pixel, tap): corner sources, weights
  // and mask
  for (int k = tid; k < items; k += THREADS) {
    const int li = k / TAPS, lr = li / nvc;
    const int q = (r0 + lr) * W + c0 + li - lr * nvc;
    const long long it = row0 + (long long)q * TAPS + (k - li * TAPS);
    if (k == li * TAPS) qidx[li] = q;
    const float px = __ldg(sx + it), py = __ldg(sy + it);
    const float x0f = floorf(px), y0f = floorf(py);
    const int ix0 = (int)x0f, iy0 = (int)y0f;
    const float wx1 = __fsub_rn(px, x0f);
    const float wy1 = __fsub_rn(py, y0f);
    const float wx[2] = {__fsub_rn(1.f, wx1), wx1};
    const float wy[2] = {__fsub_rn(1.f, wy1), wy1};
    int s[4];
    float w[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int iy = iy0 + (c >> 1), ix = ix0 + (c & 1);
      w[c] = __fmul_rn(wy[c >> 1], wx[c & 1]);
      if (iy < 0 || iy >= H || ix < 0 || ix >= W)
        s[c] = OFF_MAP;
      else if (iy >= wy0 && iy < wy0 + wr && ix >= wx0 && ix < wx0 + wc)
        s[c] = ((iy - wy0) * wc + ix - wx0) * CHUNKS;
      else
        s[c] = -(iy * W + ix) - 1;
    }
    src[k] = make_int4(s[0], s[1], s[2], s[3]);
    cw[k] = make_float4(w[0], w[1], w[2], w[3]);
    msk[k] = __ldg(mask + it);
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. a half-warp per (pixel, tap), a lane per 4 channels
  const int lane = tid & 31, j = lane & (CHUNKS - 1);
  if (j >= cs) return;
  const float4* xg = reinterpret_cast<const float4*>(xb) + j;
  const int c4 = C >> 2;
  for (int k = (tid >> 5) * 2 + (lane >> 4); k < items; k += WARPS * 2) {
    const int4 s = src[k];
    const float4 w = cw[k];
    const int sc[4] = {s.x, s.y, s.z, s.w};
    const float wc4[4] = {w.x, w.y, w.z, w.w};
    float4 v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (sc[c] >= 0)
        v[c] = win[sc[c] + j];
      else if (sc[c] != OFF_MAP)
        v[c] = __ldg(xg + (long long)(-sc[c] - 1) * c4);
    }
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (sc[c] != OFF_MAP) acc = madd(acc, v[c], wc4[c]);
    const float m = msk[k];
    const int li = k / TAPS;
    float4* dst = reinterpret_cast<float4*>(
        out + (row0 + (long long)qidx[li] * TAPS + (k - li * TAPS)) * C +
        ch0) + j;
    __stcs(dst, make_float4(__fmul_rn(acc.x, m), __fmul_rn(acc.y, m),
                            __fmul_rn(acc.z, m), __fmul_rn(acc.w, m)));
  }
}

// One thread per (image, pixel, tap, channel): any C, any alignment.
__global__ void __launch_bounds__(THREADS)
dcn_gather_scalar_kernel(const float* __restrict__ x,
                         const float* __restrict__ sx,
                         const float* __restrict__ sy,
                         const float* __restrict__ mask,
                         float* __restrict__ out, int H, int W, int C, int Q,
                         long long n) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n) return;
  const long long item = t / C;
  const int ch = (int)(t - item * C);
  const long long b = item / ((long long)Q * TAPS);
  const float px = __ldg(sx + item);
  const float py = __ldg(sy + item);
  const float x0f = floorf(px);
  const float y0f = floorf(py);
  const int ix0 = (int)x0f;
  const int iy0 = (int)y0f;
  const float wx1 = __fsub_rn(px, x0f);
  const float wy1 = __fsub_rn(py, y0f);
  const float wx[2] = {__fsub_rn(1.f, wx1), wx1};
  const float wy[2] = {__fsub_rn(1.f, wy1), wy1};
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int iy = iy0 + (c >> 1), ix = ix0 + (c & 1);
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
      const float v = __ldg(x + ((b * H + iy) * W + ix) * C + ch);
      acc = __fadd_rn(acc, __fmul_rn(v, __fmul_rn(wy[c >> 1], wx[c & 1])));
    }
  }
  out[t] = __fmul_rn(acc, __ldg(mask + item));
}

// 1: the tiled kernel, 0: the scalar kernel
int route(const void* x, const void* out, int H, int W, int C, int Q) {
  return (long long)H * W == Q && C % 4 == 0 &&
         (reinterpret_cast<size_t>(x) & 15) == 0 &&
         (reinterpret_cast<size_t>(out) & 15) == 0;
}

}  // namespace

// Which kernel dcn_sample_forward runs for these arguments: 1 the tiled
// kernel, 0 the scalar kernel.
extern "C" int dcn_sample_route(const void* x, const void* out, int H, int W,
                                int C, int Q) {
  return route(x, out, H, W, C, Q);
}

extern "C" int dcn_sample_forward(const void* x, const void* sx,
                                  const void* sy, const void* mask, void* out,
                                  int B, int H, int W, int C, int Q,
                                  void* stream) {
  const long long items = (long long)B * Q * TAPS;
  if (items == 0 || C == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (route(x, out, H, W, C, Q)) {
    const int tiles_r = (H + TR - 1) / TR, tiles_c = (W + TC - 1) / TC;
    const int slices = (C + SLICE - 1) / SLICE;
    const long long blocks = (long long)B * tiles_r * tiles_c * slices;
    dcn_gather_tile_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(
        (const float*)x, (const float*)sx, (const float*)sy,
        (const float*)mask, (float*)out, H, W, C, tiles_r, tiles_c, slices);
  } else {
    const long long n = items * C;
    const long long blocks = (n + THREADS - 1) / THREADS;
    dcn_gather_scalar_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(
        (const float*)x, (const float*)sx, (const float*)sy,
        (const float*)mask, (float*)out, H, W, C, Q, n);
  }
  return (int)cudaGetLastError();
}
