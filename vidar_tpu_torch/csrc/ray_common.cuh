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

#include <type_traits>

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


// The vector kernels (K3, K6/K7): S lanes sample a point, each lane CPL
// bins of its corner rows.

// CPL bins of T in one load: 16 bytes, or 8 (4 bf16 bins)
template <typename T, int CPL>
struct Chunk {
  static constexpr int BYTES = CPL * (int)sizeof(T);
  using Raw = typename std::conditional<BYTES == 16, uint4, uint2>::type;
  __device__ __forceinline__ static void unpack(const Raw& r,
                                                float (&f)[CPL]) {
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int k = 0; k < CPL; ++k) f[k] = to_f32(e[k]);
  }
};

// A sample point's top-left corner and fractions, sample's
// arithmetic: {ix0, iy0, wx1, wy1} (the fractions' bits), ix0 = OFF_MAP for
// a point beyond the zero ring (a zero sample).
constexpr int OFF_MAP = -(1 << 30);

__device__ __forceinline__ int4 corner_of(int H, int W, float gx, float gy) {
  const float x =
      __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gx, 1.f), (float)W), 1.f), 0.5f);
  const float y =
      __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gy, 1.f), (float)H), 1.f), 0.5f);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const int ix0 = (int)x0f;
  const int iy0 = (int)y0f;
  if (iy0 < -1 || iy0 > H - 1 || ix0 < -1 || ix0 > W - 1)
    return make_int4(OFF_MAP, 0, 0, 0);
  return make_int4(ix0, iy0, __float_as_int(__fsub_rn(x, x0f)),
                   __float_as_int(__fsub_rn(y, y0f)));
}

// The lane's CPL bins (part `part` of each corner row) of the bilinear
// sample at corner `cr`: the on-map corners' chunks, all read before any is
// used, summed in sample's corner order with fused multiply-adds.
template <typename T, int ZD, int CPL>
__device__ __forceinline__ void sample_bins(const T* __restrict__ map, int H,
                                            int W, int part, int4 cr,
                                            float (&v)[CPL]) {
  using C = Chunk<T, CPL>;
#pragma unroll
  for (int k = 0; k < CPL; ++k) v[k] = 0.f;
  if (cr.x == OFF_MAP) return;
  const float wx1 = __int_as_float(cr.z), wy1 = __int_as_float(cr.w);
  const float wx[2] = {__fsub_rn(1.f, wx1), wx1};
  const float wy[2] = {__fsub_rn(1.f, wy1), wy1};
  typename C::Raw raw[4];
  bool on[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int iy = cr.y + (c >> 1), ix = cr.x + (c & 1);
    on[c] = iy >= 0 && iy < H && ix >= 0 && ix < W;
    if (on[c])
      raw[c] = __ldg(reinterpret_cast<const typename C::Raw*>(
                         map + (iy * W + ix) * ZD) + part);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (!on[c]) continue;
    const float w = __fmul_rn(wy[c >> 1], wx[c & 1]);
    float e[CPL];
    C::unpack(raw[c], e);
#pragma unroll
    for (int k = 0; k < CPL; ++k) v[k] = fmaf(e[k], w, v[k]);
  }
}

}  // namespace ray
