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
// The TPU kernel packs the four corners of every pixel into one 128-lane
// row of a VMEM table; here x is read in place. One warp owns one (image,
// pixel, tap): it reads the coordinates and the mask once (a broadcast),
// and its lanes walk the channels with 16-byte loads of each corner row,
// so every corner read and every tap row written is coalesced. The sum
// runs in the plain version's order, (((c00 w00 + c01 w01) + c10 w10) +
// c11 w11) x mask, without fused multiply-adds, so the taps equal the
// plain version's bit for bit. A corner off the map is skipped: its term
// is an exact zero.
//
// What bounds it on the H100: the output. At ResNet-101 stage 3 over the 30
// images of a full window (58x100, C = 256) it writes 1.6 GB of taps and
// reads 178 MB of input (each pixel row is read by up to 36 taps, mostly
// from L2), so it is bound by bytes.
//
// A C that is not a multiple of 4, or an x that does not start on a 16-byte
// boundary, takes a scalar kernel with the same arithmetic, one thread per
// (image, pixel, tap, channel), as K10 does (csrc/dcn_gather16.cu).

#include <cuda_runtime.h>

namespace {

constexpr int TAPS = 9;
constexpr int WARPS = 8;  // (pixel, tap) items per block

__global__ void __launch_bounds__(WARPS * 32)
dcn_gather_kernel(const float* __restrict__ x, const float* __restrict__ sx,
                  const float* __restrict__ sy,
                  const float* __restrict__ mask, float* __restrict__ out,
                  int H, int W, int C, int Q, long long items) {
  const long long item = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= items) return;
  const int lane = threadIdx.x & 31;
  const long long b = item / ((long long)Q * TAPS);
  const float px = sx[item];
  const float py = sy[item];
  const float m = mask[item];
  const float x0f = floorf(px);
  const float y0f = floorf(py);
  const int ix0 = (int)x0f;
  const int iy0 = (int)y0f;
  const float wx1 = __fsub_rn(px, x0f);
  const float wy1 = __fsub_rn(py, y0f);
  const float wx[2] = {__fsub_rn(1.f, wx1), wx1};
  const float wy[2] = {__fsub_rn(1.f, wy1), wy1};
  const float4* rows[4];
  float wgt[4];
  bool on[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int iy = iy0 + (c >> 1), ix = ix0 + (c & 1);
    on[c] = iy >= 0 && iy < H && ix >= 0 && ix < W;
    wgt[c] = __fmul_rn(wy[c >> 1], wx[c & 1]);
    rows[c] = reinterpret_cast<const float4*>(
        x + ((b * H + (on[c] ? iy : 0)) * W + (on[c] ? ix : 0)) * C);
  }
  float4* dst = reinterpret_cast<float4*>(out + item * C);
  const int c4n = C >> 2;
  for (int j = lane; j < c4n; j += 32) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (on[c]) {
        const float4 v = __ldg(rows[c] + j);
        acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, wgt[c]));
        acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, wgt[c]));
        acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, wgt[c]));
        acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, wgt[c]));
      }
    }
    dst[j] = make_float4(__fmul_rn(acc.x, m), __fmul_rn(acc.y, m),
                         __fmul_rn(acc.z, m), __fmul_rn(acc.w, m));
  }
}

// One thread per (image, pixel, tap, channel): any C, any alignment.
__global__ void __launch_bounds__(WARPS * 32)
dcn_gather_scalar_kernel(const float* __restrict__ x,
                         const float* __restrict__ sx,
                         const float* __restrict__ sy,
                         const float* __restrict__ mask,
                         float* __restrict__ out, int H, int W, int C, int Q,
                         long long n) {
  const long long t = (long long)blockIdx.x * (WARPS * 32) + threadIdx.x;
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

}  // namespace

extern "C" int dcn_sample_forward(const void* x, const void* sx,
                                  const void* sy, const void* mask, void* out,
                                  int B, int H, int W, int C, int Q,
                                  void* stream) {
  const long long items = (long long)B * Q * TAPS;
  if (items == 0 || C == 0) return (int)cudaGetLastError();
  if (C % 4 == 0 && (reinterpret_cast<size_t>(x) & 15) == 0 &&
      (reinterpret_cast<size_t>(out) & 15) == 0) {
    const long long blocks = (items + WARPS - 1) / WARPS;
    dcn_gather_kernel<<<(unsigned)blocks, WARPS * 32, 0,
                        (cudaStream_t)stream>>>(
        (const float*)x, (const float*)sx, (const float*)sy,
        (const float*)mask, (float*)out, H, W, C, Q, items);
  } else {
    const long long n = items * C;
    const long long blocks = (n + WARPS * 32 - 1) / (WARPS * 32);
    dcn_gather_scalar_kernel<<<(unsigned)blocks, WARPS * 32, 0,
                               (cudaStream_t)stream>>>(
        (const float*)x, (const float*)sx, (const float*)sy,
        (const float*)mask, (float*)out, H, W, C, Q, n);
  }
  return (int)cudaGetLastError();
}
