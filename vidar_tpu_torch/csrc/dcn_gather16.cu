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
// bound by bytes (about 1.2 ms at 3.35 TB/s). The design: one thread per
// (image, pixel, tap, 8 channels); it computes its tap's corners (the C / 8
// threads of a tap share those loads through L1), reads each on-map corner's
// 8 channels with one 16-byte load and writes the 8 taps with one 16-byte
// store, so a warp's stores are one contiguous run. A C that is not a
// multiple of 8, or an x that does not start on a 16-byte boundary, takes a
// scalar kernel with the same arithmetic, one thread per channel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TAPS = 9;
constexpr int THREADS = 256;

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

// One thread per (image, pixel, tap, 8-channel chunk): 16-byte loads and
// stores. Needs C % 8 == 0 and x on a 16-byte boundary.
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
    if (wgt[c] != 0.f) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(xb + pix[c] * C) +
                            j);
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(v2[k]);
        acc[2 * k] = __fadd_rn(acc[2 * k], __fmul_rn(f.x, wgt[c]));
        acc[2 * k + 1] = __fadd_rn(acc[2 * k + 1], __fmul_rn(f.y, wgt[c]));
      }
    }
  }
  uint4 o;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o2[k] = __floats2bfloat162_rn(acc[2 * k], acc[2 * k + 1]);
  reinterpret_cast<uint4*>(out + item * C)[j] = o;
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

}  // namespace

extern "C" int dcn_sample16_forward(const void* x, const void* sx,
                                    const void* sy, const void* mask,
                                    void* out, int B, int H, int W, int C,
                                    int Q, void* stream) {
  const long long items = (long long)B * Q * TAPS;
  if (items == 0 || C == 0) return (int)cudaGetLastError();
  const bool vec = C % 8 == 0 && (reinterpret_cast<size_t>(x) & 15) == 0;
  const long long n = items * (vec ? C / 8 : C);
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (vec) {
    dcn_gather16_vec_kernel<<<(unsigned)blocks, THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (const float*)sx, (const float*)sy,
        (const float*)mask, (__nv_bfloat16*)out, H, W, C, Q, n);
  } else {
    dcn_gather16_scalar_kernel<<<(unsigned)blocks, THREADS, 0,
                                 (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (const float*)sx, (const float*)sy,
        (const float*)mask, (__nv_bfloat16*)out, H, W, C, Q, n);
  }
  return (int)cudaGetLastError();
}
