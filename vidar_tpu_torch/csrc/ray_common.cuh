// Shared pieces of the latent-rendering ray kernels (K3, K4 and their
// backwards K6/K7, K8).
//
// Every float operation that the plain PyTorch version also performs is
// written with the round-to-nearest intrinsics, so nvcc cannot contract it
// into an FMA: the ray geometry (waypoints, their lengths, the
// strict-inside and valid tests) then comes out bit-identical to the plain
// version's, and only the bilinear sums and the products along the ray can
// differ from it, by rounding order.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace ray {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// [-1, 1] waypoint of the radial ray through a cell: (0.5 + rn * step)*2 - 1
__device__ __forceinline__ float waypoint(float rn, float step) {
  return __fsub_rn(__fmul_rn(__fadd_rn(0.5f, __fmul_rn(rn, step)), 2.f), 1.f);
}

__device__ __forceinline__ float length2(float x, float y) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)));
}

// Bilinear sample (grid_sample, align_corners=False, zero padding) of
// channel `ch` of a channels-last map [H, W, CT] at the normalised point
// (gx, gy) in [-1, 1].
template <typename T>
__device__ __forceinline__ float sample(const T* __restrict__ map, int H,
                                        int W, int CT, int ch, float gx,
                                        float gy) {
  const float x =
      __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gx, 1.f), (float)W), 1.f), 0.5f);
  const float y =
      __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gy, 1.f), (float)H), 1.f), 0.5f);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const int ix0 = (int)x0f;
  const int iy0 = (int)y0f;
  if (iy0 < -1 || iy0 > H - 1 || ix0 < -1 || ix0 > W - 1) return 0.f;
  const float wx1 = __fsub_rn(x, x0f);
  const float wy1 = __fsub_rn(y, y0f);
  const float wx0 = __fsub_rn(1.f, wx1);
  const float wy0 = __fsub_rn(1.f, wy1);
  float v = 0.f;
  if (iy0 >= 0 && ix0 >= 0)
    v = __fadd_rn(v, __fmul_rn(to_f32(map[(iy0 * W + ix0) * CT + ch]),
                               __fmul_rn(wy0, wx0)));
  if (iy0 >= 0 && ix0 + 1 < W)
    v = __fadd_rn(v, __fmul_rn(to_f32(map[(iy0 * W + ix0 + 1) * CT + ch]),
                               __fmul_rn(wy0, wx1)));
  if (iy0 + 1 < H && ix0 >= 0)
    v = __fadd_rn(v, __fmul_rn(to_f32(map[((iy0 + 1) * W + ix0) * CT + ch]),
                               __fmul_rn(wy1, wx0)));
  if (iy0 + 1 < H && ix0 + 1 < W)
    v = __fadd_rn(v,
                  __fmul_rn(to_f32(map[((iy0 + 1) * W + ix0 + 1) * CT + ch]),
                            __fmul_rn(wy1, wx1)));
  return v;
}

// Adjoint of `sample`: adds val * (corner weight) into channel `ch` of each
// on-map corner of an f32 map gradient [H, W, CT] (atomically: many rays
// cross one cell).
__device__ __forceinline__ void scatter(float* __restrict__ dmap, int H,
                                        int W, int CT, int ch, float gx,
                                        float gy, float val) {
  const float x =
      __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gx, 1.f), (float)W), 1.f), 0.5f);
  const float y =
      __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gy, 1.f), (float)H), 1.f), 0.5f);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const int ix0 = (int)x0f;
  const int iy0 = (int)y0f;
  if (iy0 < -1 || iy0 > H - 1 || ix0 < -1 || ix0 > W - 1) return;
  const float wx1 = __fsub_rn(x, x0f);
  const float wy1 = __fsub_rn(y, y0f);
  const float wx0 = __fsub_rn(1.f, wx1);
  const float wy0 = __fsub_rn(1.f, wy1);
  if (iy0 >= 0 && ix0 >= 0)
    atomicAdd(dmap + (iy0 * W + ix0) * CT + ch, val * __fmul_rn(wy0, wx0));
  if (iy0 >= 0 && ix0 + 1 < W)
    atomicAdd(dmap + (iy0 * W + ix0 + 1) * CT + ch,
              val * __fmul_rn(wy0, wx1));
  if (iy0 + 1 < H && ix0 >= 0)
    atomicAdd(dmap + ((iy0 + 1) * W + ix0) * CT + ch,
              val * __fmul_rn(wy1, wx0));
  if (iy0 + 1 < H && ix0 + 1 < W)
    atomicAdd(dmap + ((iy0 + 1) * W + ix0 + 1) * CT + ch,
              val * __fmul_rn(wy1, wx1));
}

}  // namespace ray
