// Modulated deformable-conv tap sampling of a bf16 map, no conv (K10).
//
// Replaces vidar_tpu/ops/dcn_pallas.py: dcn16_gather (called through
// dcn_sample16, the bf16 path of vidar_tpu/models/resnet.py:128-132 for a
// shape the fused conv does not take). For each output pixel q and tap t it
// samples the bf16 input x [B, H, W, C] bilinearly at pixel coordinates
// (sy[q,t], sx[q,t]), a corner off the map reading zero (the TPU kernel's
// zero ring), with each corner's weight (bilinear x modulation mask) folded
// first, sums the four corners in f32 and rounds the tap to bf16: taps
// [B, Q, 9*C] bf16, channels in natural order. The conv kernel is applied
// outside, by a matrix product, as in the JAX package.
//
// The TPU kernel packs channel pairs into u32 rows of a VMEM-resident table
// with a zero ring and emits each tap's channels evens || odds; here x is
// read in place and the channels keep their order. The arithmetic is K2's
// tap stage (csrc/dcn_conv.cu) and the plain version's: corner weights
// (wy * wx) * mask, corners summed (y0x0, y0x1, y1x0, y1x1) without fused
// multiply-adds, an off-map corner skipped (its term is an exact zero), then
// one round to nearest even folded into the store, so the taps equal the
// plain version's bit for bit. The module casts the taps to bf16 at once, so
// writing bf16 halves the bytes of an f32 store with the same result.
//
// What bounds it on the H100: the taps it writes. At ResNet-101 stage 1 over
// the 30 images of the forecast (232x400, C = 64) one call writes 3.2 GB of
// taps and reads 0.36 GB of x and 0.30 GB of coordinates and masks, so it is
// bound by bytes (1.15 ms at 3.35 TB/s). The first design, one thread per
// (image, pixel, tap, 8 channels) reading its tap's 4 corner rows from
// global memory, took 2.792 ms there (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700.00 W): 4 rows of x through L1 and L2 for every tap it wrote, with
// few of them shared within a block.
//
// The staged design is K9's (csrc/dcn_gather.cu). Where Q = H*W (the
// ResNet DCN: 3x3, stride 1, pad 1) a block owns a tile of TR x TC = 8 x 8
// output pixels (all 9 taps) of one image over a slice of 64 channels, and
//   1. stages the tile's window of x, its rows and columns and two more on
//      each side (12 x 12 pixels), 64 channels (128 bytes) a pixel, in
//      shared memory with 16-byte cp.async copies;
//   2. while the copies fly, loads the tile's coordinates and masks (all
//      of a thread's before it uses any) and writes for every (pixel, tap)
//      its four corner sources (a window slot; a pixel of x for a corner on
//      the map outside the window; or none off the map), its corner
//      weights, the mask folded in, and its output row into shared-memory
//      tables;
//   3. then each group of 8 lanes makes one (pixel, tap) at a time, a lane
//      8 channels, from the window (or an __ldg of x), and writes it with a
//      16-byte streaming store (st.global.cs): a warp's 4 groups write 512
//      contiguous bytes.
// Unlike K9 it is bound by instruction issue as much as by bytes: a lane
// converts, multiplies and adds 32 bf16 values for each 16 bytes it
// writes, 4x K9's work per byte, and reads 64 bytes of window for them.
// So the block is capped at 51 registers for 5 blocks (40 warps) an SM,
// and the first corner's products start the sum.
//
// Measured (tools/kernel_ab.py, device time, NVIDIA H100 80GB HBM3 at
// 700.00 W, against the first design in the same process): stage 1 of
// the all-DCN forecast 1.492 ms (2.760), 77% of the bound. Timed variants
// (copies with one edit, the same call): the writes alone (no window, no
// corner reads) 1.243 ms; the window staged but not read 1.351; no window
// (corners through L1) 1.634; 4 x 16 tiles 1.484. In earlier calls: 2 x 16
// tiles, K9's, 1.93 ms before the loads were batched and 1.80 after; 4 x
// 16 tiles 1.63, 1.61 with 5 blocks an SM, 1.55 with the first corner
// starting the sum; 8 x 16 and 4 x 32 tiles (68 and 75 KB, 3 blocks) 1.61
// and 1.63; 6 blocks an SM 3% slower, two items a loop step 4% slower.
// The arithmetic is the first design's, except that the first corner's
// products start the sum, as the plain version's first term does, where
// the first design added them to zero; the taps stay equal to the plain
// version's (off-map corners, whose zero terms it skips, can change no
// more than the sign of a zero).
//
// A Q other than H*W (no DCN of the models) with C % 8 == 0 and an x on a
// 16-byte boundary takes the first design's vector kernel; any other C or
// alignment a scalar kernel with the same arithmetic, one thread per
// channel. dcn_sample16_route names the kernel a call takes.

#include <climits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TAPS = 9;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNKS = 8;  // 16-byte chunks (8 channels) of a pixel's slice
constexpr int SLICE = 8 * CHUNKS;  // channels of a block
constexpr int GROUPS = 32 / CHUNKS;  // (pixel, tap) items a warp makes at once
constexpr int HALO = 4;  // window rows (columns) beyond the tile's
constexpr int OFF_MAP = INT_MIN;  // a corner source off the map
constexpr int TR = 8, TC = 8;  // a tile's output rows and columns
constexpr int MIN_BLOCKS = 5;  // blocks an SM holds (51 registers)

// Corner pixel offsets (in pixels from the image start) and weights of one
// tap; a weight is zero for a corner off the map.
__device__ __forceinline__ void tap_corners(float px, float py, float m,
                                            int H, int W, long long* pix,
                                            float* wgt) {
  const float x0f = floorf(px);
  const float y0f = floorf(py);
  const int ix0 = (int)x0f;
  const int iy0 = (int)y0f;
  const float wx1 = __fsub_rn(px, x0f);
  const float wy1 = __fsub_rn(py, y0f);
  const float wx[2] = {__fsub_rn(1.f, wx1), wx1};
  const float wy[2] = {__fsub_rn(1.f, wy1), wy1};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int iy = iy0 + (c >> 1), ix = ix0 + (c & 1);
    const bool on = iy >= 0 && iy < H && ix >= 0 && ix < W;
    pix[c] = on ? (long long)iy * W + ix : 0;
    wgt[c] = on ? __fmul_rn(__fmul_rn(wy[c >> 1], wx[c & 1]), m) : 0.f;
  }
}

// acc[2k], acc[2k + 1] += the 8 channels of v times w, no fused
// multiply-adds
__device__ __forceinline__ void madd8(float (&acc)[8], const uint4& v,
                                      float w) {
  const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(v2[k]);
    acc[2 * k] = __fadd_rn(acc[2 * k], __fmul_rn(f.x, w));
    acc[2 * k + 1] = __fadd_rn(acc[2 * k + 1], __fmul_rn(f.y, w));
  }
}

// acc = the 8 channels of v times w: the first corner's terms start the
// sums, as in the plain version
__device__ __forceinline__ void mul8(float (&acc)[8], const uint4& v,
                                     float w) {
  const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(v2[k]);
    acc[2 * k] = __fmul_rn(f.x, w);
    acc[2 * k + 1] = __fmul_rn(f.y, w);
  }
}

// the 8 sums rounded to nearest even, packed
__device__ __forceinline__ uint4 pack8(const float (&acc)[8]) {
  uint4 o;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o2[k] = __floats2bfloat162_rn(acc[2 * k], acc[2 * k + 1]);
  return o;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

// The staged kernel's shared memory: the window, then per (pixel, tap) its
// corner sources, weights and output row (39 KB at 8 x 8).
template <int R, int CC>
struct Tile {
  static constexpr int ITEMS = R * CC * TAPS;  // (pixel, tap) pairs
  static constexpr int WPIX = (R + HALO) * (CC + HALO);  // window pixels
  static constexpr int PASSES = (ITEMS + THREADS - 1) / THREADS;
  static constexpr size_t BYTES =
      sizeof(uint4) * WPIX * CHUNKS +
      (sizeof(int4) + sizeof(float4) + sizeof(int)) * ITEMS;
};

template <int R, int CC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
dcn_gather16_tile_kernel(const __nv_bfloat16* __restrict__ x,
                         const float* __restrict__ sx,
                         const float* __restrict__ sy,
                         const float* __restrict__ mask,
                         __nv_bfloat16* __restrict__ out, int H, int W,
                         int C, int tiles_r, int tiles_c, int slices) {
  using T = Tile<R, CC>;
  extern __shared__ uint4 smem[];
  uint4* win = smem;
  int4* src = reinterpret_cast<int4*>(win + T::WPIX * CHUNKS);
  float4* cw = reinterpret_cast<float4*>(src + T::ITEMS);
  int* trow_of = reinterpret_cast<int*>(cw + T::ITEMS);

  const int tid = threadIdx.x;
  int t = blockIdx.x;
  const int slice = t % slices;
  t /= slices;
  const int tcol = t % tiles_c;
  t /= tiles_c;
  const int trow = t % tiles_r;
  const long long b = t / tiles_r;
  const int r0 = trow * R, c0 = tcol * CC;
  const int nvc = min(CC, W - c0);
  const int items = min(R, H - r0) * nvc * TAPS;
  const int ch0 = slice * SLICE;
  const int cs = min(CHUNKS, (C - ch0) >> 3);  // chunks in this slice
  const long long row0 = b * H * W * TAPS;     // the image's first tap row

  // 1. the window: the tile's rows and columns and HALO / 2 beyond them on
  // each side, cut to the map
  const int wy0 = max(r0 - HALO / 2, 0), wx0 = max(c0 - HALO / 2, 0);
  const int wr = min(r0 + R + HALO / 2, H) - wy0;
  const int wc = min(c0 + CC + HALO / 2, W) - wx0;
  const __nv_bfloat16* xb = x + b * H * W * C + ch0;
  {
    const int j = tid & (CHUNKS - 1);
    if (j < cs) {
      for (int p = tid / CHUNKS; p < wr * wc; p += THREADS / CHUNKS) {
        const int r = p / wc, c = p - r * wc;
        cp_async16(win + p * CHUNKS + j,
                   xb + ((long long)(wy0 + r) * W + wx0 + c) * C + 8 * j);
      }
    }
  }

  // 2. while the copies fly, per (pixel, tap): corner sources and weights
  // (every pass's coordinates loaded before any is used)
  float pxs[T::PASSES], pys[T::PASSES], ms[T::PASSES];
#pragma unroll
  for (int i = 0; i < T::PASSES; ++i) {
    const int k = tid + i * THREADS;
    if (k >= items) break;
    const int li = k / TAPS, lr = li / nvc;
    const int q = (r0 + lr) * W + c0 + li - lr * nvc;
    const int tr = q * TAPS + k - li * TAPS;  // the tap's row in the image
    const long long it = row0 + tr;
    trow_of[k] = tr;
    pxs[i] = __ldg(sx + it);
    pys[i] = __ldg(sy + it);
    ms[i] = __ldg(mask + it);
  }
#pragma unroll
  for (int i = 0; i < T::PASSES; ++i) {
    const int k = tid + i * THREADS;
    if (k >= items) break;
    const float px = pxs[i], py = pys[i], m = ms[i];
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
      w[c] = __fmul_rn(__fmul_rn(wy[c >> 1], wx[c & 1]), m);
      if (iy < 0 || iy >= H || ix < 0 || ix >= W)
        s[c] = OFF_MAP;
      else if (iy >= wy0 && iy < wy0 + wr && ix >= wx0 && ix < wx0 + wc)
        s[c] = ((iy - wy0) * wc + ix - wx0) * CHUNKS;
      else
        s[c] = -(iy * W + ix) - 1;
    }
    src[k] = make_int4(s[0], s[1], s[2], s[3]);
    cw[k] = make_float4(w[0], w[1], w[2], w[3]);
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. a group of 8 lanes per (pixel, tap), a lane per 8 channels
  const int lane = tid & 31, j = lane & (CHUNKS - 1);
  if (j >= cs) return;
  const uint4* xg = reinterpret_cast<const uint4*>(xb) + j;
  uint4* outg = reinterpret_cast<uint4*>(out + row0 * C + ch0) + j;
  const int c8 = C >> 3;
  for (int k = (tid >> 5) * GROUPS + lane / CHUNKS; k < items;
       k += WARPS * GROUPS) {
    const int4 s = src[k];
    const float4 w = cw[k];
    const int sc[4] = {s.x, s.y, s.z, s.w};
    const float wc4[4] = {w.x, w.y, w.z, w.w};
    uint4 v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (sc[c] >= 0)
        v[c] = win[sc[c] + j];
      else if (sc[c] != OFF_MAP)
        v[c] = __ldg(xg + (long long)(-sc[c] - 1) * c8);
    }
    float acc[8];
    if (sc[0] != OFF_MAP) {
      mul8(acc, v[0], wc4[0]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    }
#pragma unroll
    for (int c = 1; c < 4; ++c)
      if (sc[c] != OFF_MAP) madd8(acc, v[c], wc4[c]);
    __stcs(outg + (long long)trow_of[k] * c8, pack8(acc));
  }
}

// The first design: one thread per (image, pixel, tap, 8-channel chunk),
// 16-byte loads and stores. Needs C % 8 == 0 and x on a 16-byte boundary.
__global__ void __launch_bounds__(THREADS)
dcn_gather16_vec_kernel(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ sx,
                        const float* __restrict__ sy,
                        const float* __restrict__ mask,
                        __nv_bfloat16* __restrict__ out, int H, int W, int C,
                        int Q, long long n) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n) return;
  const int chunks = C >> 3;
  const long long item = t / chunks;
  const int j = (int)(t - item * chunks);
  const long long b = item / ((long long)Q * TAPS);
  long long pix[4];
  float wgt[4];
  tap_corners(__ldg(sx + item), __ldg(sy + item), __ldg(mask + item), H, W,
              pix, wgt);
  const __nv_bfloat16* xb = x + b * H * W * C;
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (wgt[c] != 0.f)
      madd8(acc, __ldg(reinterpret_cast<const uint4*>(xb + pix[c] * C) + j),
            wgt[c]);
  }
  reinterpret_cast<uint4*>(out + item * C)[j] = pack8(acc);
}

// One thread per (image, pixel, tap, channel): any C, any alignment.
__global__ void __launch_bounds__(THREADS)
dcn_gather16_scalar_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ sx,
                           const float* __restrict__ sy,
                           const float* __restrict__ mask,
                           __nv_bfloat16* __restrict__ out, int H, int W,
                           int C, int Q, long long n) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n) return;
  const long long item = t / C;
  const int ch = (int)(t - item * C);
  const long long b = item / ((long long)Q * TAPS);
  long long pix[4];
  float wgt[4];
  tap_corners(__ldg(sx + item), __ldg(sy + item), __ldg(mask + item), H, W,
              pix, wgt);
  const __nv_bfloat16* xb = x + b * H * W * C;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (wgt[c] != 0.f) {
      acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(xb[pix[c] * C + ch]),
                                     wgt[c]));
    }
  }
  out[t] = __float2bfloat16_rn(acc);
}

// 2: the staged kernel, 1: the vector kernel, 0: the scalar kernel
int route(const void* x, const void* out, int H, int W, int C, int Q) {
  if (C % 8 != 0 || (reinterpret_cast<size_t>(x) & 15) != 0 ||
      (reinterpret_cast<size_t>(out) & 15) != 0)
    return 0;
  // the staged kernel indexes an image's tap rows in int
  return (long long)H * W == Q && (long long)Q * TAPS <= INT_MAX ? 2 : 1;
}

}  // namespace

// Which kernel dcn_sample16_forward runs for these arguments: 2 the staged
// kernel, 1 the vector kernel, 0 the scalar kernel.
extern "C" int dcn_sample16_route(const void* x, const void* out, int H,
                                  int W, int C, int Q) {
  return route(x, out, H, W, C, Q);
}

extern "C" int dcn_sample16_forward(const void* x, const void* sx,
                                    const void* sy, const void* mask,
                                    void* out, int B, int H, int W, int C,
                                    int Q, void* stream) {
  const long long items = (long long)B * Q * TAPS;
  if (items == 0 || C == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int r = route(x, out, H, W, C, Q);
  if (r == 2) {
    const int tiles_r = (H + TR - 1) / TR, tiles_c = (W + TC - 1) / TC;
    const int slices = (C + SLICE - 1) / SLICE;
    const long long blocks = (long long)B * tiles_r * tiles_c * slices;
    constexpr size_t bytes = Tile<TR, TC>::BYTES;
    if (bytes > 48 * 1024) {  // above the default limit
      const cudaError_t attr = cudaFuncSetAttribute(
          dcn_gather16_tile_kernel<TR, TC>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (attr != cudaSuccess) return (int)attr;
    }
    dcn_gather16_tile_kernel<TR, TC><<<(unsigned)blocks, THREADS, bytes,
                                       st>>>(
        (const __nv_bfloat16*)x, (const float*)sx, (const float*)sy,
        (const float*)mask, (__nv_bfloat16*)out, H, W, C, tiles_r, tiles_c,
        slices);
    return (int)cudaGetLastError();
  }
  const long long n = items * (r == 1 ? C / 8 : C);
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (r == 1) {
    dcn_gather16_vec_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, (const float*)sx, (const float*)sy,
        (const float*)mask, (__nv_bfloat16*)out, H, W, C, Q, n);
  } else {
    dcn_gather16_scalar_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, (const float*)sx, (const float*)sy,
        (const float*)mask, (__nv_bfloat16*)out, H, W, C, Q, n);
  }
  return (int)cudaGetLastError();
}
