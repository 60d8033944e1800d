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


// The vector kernels (K3, K6/K7, K8): S lanes sample a point, each lane
// CPL bins of its corner rows.

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

// The lane's CPL bins of NP chunks of each corner row (chunks part + q STEP,
// q < NP) of the bilinear sample at corner `cr`: the on-map corners'
// chunks, all read before any is used, summed in sample's corner order
// with fused multiply-adds.
template <typename T, int ROW, int CPL, int NP, int STEP>
__device__ __forceinline__ void sample_chunks(const T* __restrict__ map,
                                              int H, int W, int part,
                                              int4 cr, float (&v)[NP][CPL]) {
  using C = Chunk<T, CPL>;
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int k = 0; k < CPL; ++k) v[q][k] = 0.f;
  if (cr.x == OFF_MAP) return;
  const float wx1 = __int_as_float(cr.z), wy1 = __int_as_float(cr.w);
  const float wx[2] = {__fsub_rn(1.f, wx1), wx1};
  const float wy[2] = {__fsub_rn(1.f, wy1), wy1};
  typename C::Raw raw[4][NP];
  bool on[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int iy = cr.y + (c >> 1), ix = cr.x + (c & 1);
    on[c] = iy >= 0 && iy < H && ix >= 0 && ix < W;
    if (on[c]) {
      const typename C::Raw* row = reinterpret_cast<const typename C::Raw*>(
          map + (iy * W + ix) * ROW) + part;
#pragma unroll
      for (int q = 0; q < NP; ++q) raw[c][q] = __ldg(row + q * STEP);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (!on[c]) continue;
    const float w = __fmul_rn(wy[c >> 1], wx[c & 1]);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      float e[CPL];
      C::unpack(raw[c][q], e);
#pragma unroll
      for (int k = 0; k < CPL; ++k) v[q][k] = fmaf(e[k], w, v[q][k]);
    }
  }
}

// The lane's CPL bins (part `part` of each corner row) of the bilinear
// sample at corner `cr` (sample_chunks of one chunk).
template <typename T, int ROW, int CPL>
__device__ __forceinline__ void sample_bins(const T* __restrict__ map, int H,
                                            int W, int part, int4 cr,
                                            float (&v)[CPL]) {
  sample_chunks<T, ROW, CPL, 1, 0>(
      map, H, W, part, cr, *reinterpret_cast<float(*)[1][CPL]>(&v));
}

// Lists in `batch`, in order, the sample corners of the waypoints g0 +
// lane of the ray (rx, ry) whose length is below `limit` -> their count,
// or -1 where the walk may stop: none is listed and, the steps ascending
// from zero (`prefix`), none after them would be.
__device__ __forceinline__ int list_inside(int4* batch,
                                           const float* __restrict__ steps,
                                           int g0, int G, int lane, float rx,
                                           float ry, float limit, int H,
                                           int W, bool prefix) {
  const int g = g0 + lane;
  bool inside = false;
  float px = 0.f, py = 0.f;
  if (g < G) {
    const float step = __ldg(steps + g);
    px = waypoint(rx, step);
    py = waypoint(ry, step);
    inside = length2(px, py) < limit;
  }
  const unsigned in = __ballot_sync(0xffffffffu, inside);
  if (!in) return prefix ? -1 : 0;
  if (inside)  // the waypoint's place among the batch's inside ones
    batch[__popc(in & ((1u << lane) - 1u))] = corner_of(H, W, px, py);
  __syncwarp();
  return __popc(in);
}

// The backward kernels' scatter (K6/K7, K8): a lane's 4 bins of a corner
// row at a time, with one vector f32 reduction.

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// row[0:4] += v (red.global.add.v4.f32), skipped for 4 zeros
__device__ __forceinline__ void red4(float* row, float4 v) {
  if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
    atomicAdd(reinterpret_cast<float4*>(row), v);
}

// The 4 corner rows of sample corner cr (pixel index, -1 off the map) and,
// for each of NP float4s of a lane's bins, d times each row's bilinear
// weight.
template <int NP>
__device__ __forceinline__ void corner_rows(int H, int W, int4 cr,
                                            const float (&d)[NP][4],
                                            int (&np)[4],
                                            float4 (&nv)[4][NP]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) np[c] = -1;
  if (cr.x == OFF_MAP) return;
  const float wx1 = __int_as_float(cr.z), wy1 = __int_as_float(cr.w);
  const float wx[2] = {__fsub_rn(1.f, wx1), wx1};
  const float wy[2] = {__fsub_rn(1.f, wy1), wy1};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int iy = cr.y + (c >> 1), ix = cr.x + (c & 1);
    const float w = __fmul_rn(wy[c >> 1], wx[c & 1]);
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) np[c] = iy * W + ix;
#pragma unroll
    for (int q = 0; q < NP; ++q)
      nv[c][q] = make_float4(d[q][0] * w, d[q][1] * w, d[q][2] * w,
                             d[q][3] * w);
  }
}

// A lane group's corner rows along a run of consecutive waypoints, which
// in the presets lie a pixel apart along the ray and so share one or two
// corners: the last waypoint's 4 rows stay pending, the next one's take
// the sums of those they share, and the others go out. ROW: the floats of
// a gradient row; drow: the lane's first float4 of row 0, its q-th STEP
// floats further on.
template <int ROW, int NP, int STEP>
struct PendingRows {
  int pix[4] = {-1, -1, -1, -1};  // -1: none
  float4 val[4][NP];

  __device__ __forceinline__ void push(float* drow, const int (&np)[4],
                                       float4 (&nv)[4][NP]) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (np[c] >= 0 && np[c] == pix[j]) {
#pragma unroll
          for (int q = 0; q < NP; ++q) nv[c][q] = add4(nv[c][q], val[j][q]);
          pix[j] = -1;
        }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      send(drow, j);
      pix[j] = np[j];
#pragma unroll
      for (int q = 0; q < NP; ++q) val[j][q] = nv[j][q];
    }
  }

  __device__ __forceinline__ void flush(float* drow) {
#pragma unroll
    for (int j = 0; j < 4; ++j) send(drow, j);
  }

  __device__ __forceinline__ void send(float* drow, int j) {
    if (pix[j] >= 0)
#pragma unroll
      for (int q = 0; q < NP; ++q)
        red4(drow + pix[j] * ROW + q * STEP, val[j][q]);
  }
};

}  // namespace ray
