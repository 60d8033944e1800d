// Multi-scale deformable attention forward (K1).
//
// Replaces vidar_tpu/ops/msda_pallas.py: msda_gather_fused (f32 tables, the
// SCA call) and msda_gather_fused16 (bf16 values as u32 row pairs, the TSA
// and decoder calls). Same function as mmcv's ms_deform_attn forward: for
// each (batch, query, head), the sum over levels x points of the attention
// weight times the bilinear sample (align_corners=False, zeros outside the
// map) of the head's value map at the sampling location.
//
// What bounds it on the H100: gathers. Every sample reads 4 value rows of
// `dim` channels at data-dependent addresses: the forecast's SCA call (6 x
// 12000 queries x 8 heads x 32 samples) reads 74M corner rows of 64 bytes,
// 4.7 GB, mostly out of L2 and L1, against the 390 MB that must come from
// HBM (its bound, 0.116 ms). FLOPs are negligible. So the limit is how many
// row reads the load units keep in flight. The first design (one warp per
// (query, head), one lane per channel, the samples walked one at a time,
// each one's location broadcast by three shuffles and its geometry
// recomputed by every lane, 2- or 4-byte loads) issued 128 narrow loads per
// (query, head) with little in flight: 2.71 ms per bf16 SCA call, 3.71 ms
// per f32 fine-tune SCA call.
//
// The vector design spreads a warp's lanes over (sample, channel chunk): a
// head's row is split into 16-byte chunks, G lanes per row (dim 32: 4 lanes
// of 8 bf16 channels, or 8 lanes of 4 f32 channels), so a warp holds 32 / G
// lane groups and carries 8 (bf16) or 4 (f32) samples at once. The groups
// of one (batch, query, head) item take its samples in turn (group g:
// samples g, g + GPI, ...); with few samples (TSA and the decoders: 4) one
// warp serves two items. Each group loads its own sample's location and
// weight and computes that sample's geometry once (no shuffles), then
// issues the four corner reads as 16-byte vector loads before it uses any
// of them. A thread holds at most 64 registers, so 32 warps share an SM and
// keep their loads in flight (batching 2 or 4 samples per group held more
// registers, fewer warps, and ran slower). The sums stay in f32 registers;
// at the end the groups of an item add theirs with xor shuffles and the
// first group writes the head's outputs with 16-byte stores. The per-sample
// arithmetic is the plain version's (__fmul_rn/__fadd_rn, the corner test
// of the top-left corner); only the order of the f32 sum over samples
// changes. The grid stays camera-major (image slowest, then query, then
// head), so one camera's value maps (15.8 MB in bf16, 31.6 MB in f32 at SCA)
// stay in the 50 MB L2 while its queries run. A row of 1 to 32 chunks of
// 16 bytes (a power of two; up to dim 256 in bf16, 128 in f32) takes the
// vector kernel. Any other dim, or a value off a 16-byte boundary, runs the
// first design's kernel, with the same arithmetic, its lanes over a
// 32-channel slice of the row at a time.
//
// Measured (chip_smoke.py phases 3 and 6, CUDA events, NVIDIA H100 80GB
// HBM3 at 700 W, against the first design in the same call): bf16 SCA 0.83
// ms (2.72), TSA 0.26 ms (0.60), decoder 0.14 ms (0.30); f32 fine-tune SCA
// 1.50-1.53 ms (3.66-3.71), TSA 0.43-0.44 ms (0.58-0.59). Still 7-8x the
// HBM bound: the corner rows come from L2 and L1, whose rate, not HBM's,
// now bounds it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The 16-byte chunk of a row as CPL f32 values.
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int CPL = 4;
  __device__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int CPL = 8;
  __device__ static void unpack(const uint4& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 v = __bfloat1622float2(h[k]);
      f[2 * k] = v.x;
      f[2 * k + 1] = v.y;
    }
  }
};

// G lanes per value row (CPL channels each), GPI lane groups per (batch,
// query, head) item, 32 / (G * GPI) items per warp. At most 64 registers a
// thread, so 4 blocks (32 warps) share an SM and keep its loads in flight.
template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
msda_forward_vec_kernel(const T* __restrict__ value,
                        const int* __restrict__ shapes,
                        const int* __restrict__ level_start,
                        const float* __restrict__ loc,
                        const float* __restrict__ weights,
                        float* __restrict__ out, int V, int Q, int heads,
                        int dim, int L, int P, int G, int GPI,
                        long long total) {
  constexpr int CPL = Chunk<T>::CPL;
  const int lane = threadIdx.x & 31;
  const int group = lane / G;
  const int sub = lane - group * G;
  const int gi = group % GPI;  // this group's share of the item's samples
  const int items_per_warp = 32 / (G * GPI);
  const long long warp =
      (long long)blockIdx.x * (THREADS >> 5) + (threadIdx.x >> 5);
  const long long item = warp * items_per_warp + group / GPI;
  const bool valid = item < total;  // every lane stays for the shuffles
  const long long it = valid ? item : 0;  // (b, q, head)
  const int head = (int)(it % heads);
  const long long bq = it / heads;  // b * Q + q
  const long long b = bq / Q;
  const int LP = valid ? L * P : 0;
  // loc [B, Q, heads, L, P, 2] and weights [B, Q, heads, L, P]
  const float2* loc_i = reinterpret_cast<const float2*>(loc) + it * L * P;
  const float* aw_i = weights + it * L * P;
  // value [B, V, heads, dim]; this lane's chunk of the head's row
  const long long vstride = (long long)heads * dim;
  const T* vbase =
      value + b * V * vstride + (long long)head * dim + sub * CPL;

  float acc[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) acc[k] = 0.f;

  for (int s = gi; s < LP; s += GPI) {
    const float2 lxy = __ldg(loc_i + s);
    const float aw = __ldg(aw_i + s);
    const int l = s / P;
    const int h = __ldg(shapes + 2 * l);
    const int w = __ldg(shapes + 2 * l + 1);
    // pixel coords, align_corners=False: loc * size - 0.5
    const float x = __fsub_rn(__fmul_rn(lxy.x, (float)w), 0.5f);
    const float y = __fsub_rn(__fmul_rn(lxy.y, (float)h), 0.5f);
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const int ix0 = (int)x0f;
    const int iy0 = (int)y0f;
    // a sample touches the map iff its top-left corner is in
    // [-1, h-1] x [-1, w-1] (vidar_tpu/ops/msda.py:913-918)
    if (iy0 < -1 || iy0 > h - 1 || ix0 < -1 || ix0 > w - 1) continue;
    const float wx1 = __fsub_rn(x, x0f);
    const float wy1 = __fsub_rn(y, y0f);
    const float wx[2] = {__fsub_rn(1.f, wx1), wx1};
    const float wy[2] = {__fsub_rn(1.f, wy1), wy1};
    const T* lv = vbase + (long long)__ldg(level_start + l) * vstride;
    // the four corner reads, all issued before any is used
    uint4 raw[4];
    bool on[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int iy = iy0 + (c >> 1), ix = ix0 + (c & 1);
      on[c] = iy >= 0 && iy <= h - 1 && ix >= 0 && ix <= w - 1;
      raw[c] = on[c] ? __ldg(reinterpret_cast<const uint4*>(
                           lv + (long long)(iy * w + ix) * vstride))
                     : make_uint4(0u, 0u, 0u, 0u);
    }
    // the sample, in the plain version's corner order
    float v[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) v[k] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!on[c]) continue;
      const float cw = __fmul_rn(wy[c >> 1], wx[c & 1]);
      float f[CPL];
      Chunk<T>::unpack(raw[c], f);
#pragma unroll
      for (int k = 0; k < CPL; ++k)
        v[k] = __fadd_rn(v[k], __fmul_rn(cw, f[k]));
    }
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      acc[k] = __fadd_rn(acc[k], __fmul_rn(aw, v[k]));
  }

  // the item's groups are GPI neighbouring lane groups: add their sums
  for (int off = G; off < G * GPI; off <<= 1) {
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      acc[k] = __fadd_rn(acc[k], __shfl_xor_sync(0xffffffffu, acc[k], off));
  }
  if (valid && gi == 0) {
    float4* o = reinterpret_cast<float4*>(out + bq * vstride +
                                          (long long)head * dim + sub * CPL);
#pragma unroll
    for (int k = 0; k < CPL / 4; ++k)
      o[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2],
                         acc[4 * k + 3]);
  }
}

// Any dim: one warp per (batch, query, head), one lane per channel of a
// 32-channel slice of the head's row, the slices taken in turn and the
// samples walked one at a time.
template <typename T>
__global__ void __launch_bounds__(THREADS)
msda_forward_scalar_kernel(const T* __restrict__ value,
                           const int* __restrict__ shapes,
                           const int* __restrict__ level_start,
                           const float* __restrict__ loc,
                           const float* __restrict__ weights,
                           float* __restrict__ out, int V, int Q, int heads,
                           int dim, int L, int P, long long total) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * (THREADS >> 5) + (threadIdx.x >> 5);
  if (warp >= total) return;  // uniform across the warp
  const int head = (int)(warp % heads);
  const long long bq = warp / heads;  // b * Q + q
  const long long b = bq / Q;
  const int LP = L * P;
  const float* loc_w = loc + warp * LP * 2;
  const float* aw_w = weights + warp * LP;
  const long long vstride = (long long)heads * dim;

  for (int c0 = 0; c0 < dim; c0 += 32) {
    const int ch = c0 + lane;
    const T* vbase = value + b * V * vstride + (long long)head * dim + ch;
    float acc = 0.f;
    for (int s0 = 0; s0 < LP; s0 += 32) {
      const int s = s0 + lane;
      float lx = 0.f, ly = 0.f, la = 0.f;
      if (s < LP) {
        lx = loc_w[2 * s];
        ly = loc_w[2 * s + 1];
        la = aw_w[s];
      }
      const int n = min(32, LP - s0);
      for (int j = 0; j < n; ++j) {
        const float locx = __shfl_sync(0xffffffffu, lx, j);
        const float locy = __shfl_sync(0xffffffffu, ly, j);
        const float aw = __shfl_sync(0xffffffffu, la, j);
        const int l = (s0 + j) / P;
        const int h = __ldg(shapes + 2 * l);
        const int w = __ldg(shapes + 2 * l + 1);
        const T* lv = vbase + (long long)__ldg(level_start + l) * vstride;
        const float x = __fsub_rn(__fmul_rn(locx, (float)w), 0.5f);
        const float y = __fsub_rn(__fmul_rn(locy, (float)h), 0.5f);
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        const int ix0 = (int)x0f;
        const int iy0 = (int)y0f;
        if (ch >= dim || iy0 < -1 || iy0 > h - 1 || ix0 < -1 ||
            ix0 > w - 1) {
          continue;
        }
        const float wx1 = __fsub_rn(x, x0f);
        const float wy1 = __fsub_rn(y, y0f);
        const float wx0 = __fsub_rn(1.f, wx1);
        const float wy0 = __fsub_rn(1.f, wy1);
        const bool y0ok = iy0 >= 0, y1ok = iy0 + 1 <= h - 1;
        const bool x0ok = ix0 >= 0, x1ok = ix0 + 1 <= w - 1;
        float v = 0.f;
        if (y0ok && x0ok)
          v = __fadd_rn(v, __fmul_rn(__fmul_rn(wy0, wx0),
                to_f32(lv[(long long)(iy0 * w + ix0) * vstride])));
        if (y0ok && x1ok)
          v = __fadd_rn(v, __fmul_rn(__fmul_rn(wy0, wx1),
                to_f32(lv[(long long)(iy0 * w + ix0 + 1) * vstride])));
        if (y1ok && x0ok)
          v = __fadd_rn(v, __fmul_rn(__fmul_rn(wy1, wx0),
                to_f32(lv[(long long)((iy0 + 1) * w + ix0) * vstride])));
        if (y1ok && x1ok)
          v = __fadd_rn(v, __fmul_rn(__fmul_rn(wy1, wx1),
                to_f32(lv[(long long)((iy0 + 1) * w + ix0 + 1) *
                          vstride])));
        acc = __fadd_rn(acc, __fmul_rn(aw, v));
      }
    }
    if (ch < dim) out[bq * vstride + (long long)head * dim + ch] = acc;
  }
}

template <typename T>
cudaError_t launch(const void* value, const void* shapes,
                   const void* level_start, const void* loc,
                   const void* weights, void* out, int B, int V, int Q,
                   int heads, int dim, int L, int P, cudaStream_t st) {
  const long long total = (long long)B * Q * heads;
  constexpr int CPL = Chunk<T>::CPL;
  const int G = dim / CPL;
  const bool vec = dim % CPL == 0 && G <= 32 && (G & (G - 1)) == 0 &&
                   (reinterpret_cast<size_t>(value) & 15) == 0 &&
                   (reinterpret_cast<size_t>(out) & 15) == 0 &&
                   (reinterpret_cast<size_t>(loc) & 7) == 0;
  if (vec) {
    // enough groups per item for its samples, at most the warp's
    int GPI = 1;
    while (GPI < L * P && GPI * G < 32) GPI <<= 1;
    const long long items_per_warp = 32 / (G * GPI);
    const long long warps = (total + items_per_warp - 1) / items_per_warp;
    const long long blocks = (warps * 32 + THREADS - 1) / THREADS;
    msda_forward_vec_kernel<T><<<(unsigned)blocks, THREADS, 0, st>>>(
        (const T*)value, (const int*)shapes, (const int*)level_start,
        (const float*)loc, (const float*)weights, (float*)out, V, Q, heads,
        dim, L, P, G, GPI, total);
  } else {
    const long long blocks = (total * 32 + THREADS - 1) / THREADS;
    msda_forward_scalar_kernel<T><<<(unsigned)blocks, THREADS, 0, st>>>(
        (const T*)value, (const int*)shapes, (const int*)level_start,
        (const float*)loc, (const float*)weights, (float*)out, V, Q, heads,
        dim, L, P, total);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int msda_forward(const void* value, int value_is_bf16,
                            const void* shapes, const void* level_start,
                            const void* loc, const void* weights, void* out,
                            int B, int V, int Q, int heads, int dim, int L,
                            int P, void* stream) {
  if ((long long)B * Q * heads == 0 || dim == 0)
    return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(value_is_bf16
                   ? launch<__nv_bfloat16>(value, shapes, level_start, loc,
                                           weights, out, B, V, Q, heads, dim,
                                           L, P, st)
                   : launch<float>(value, shapes, level_start, loc, weights,
                                   out, B, V, Q, heads, dim, L, P, st));
}
