// Latent rendering, pass 2: probability-weighted ray aggregation (K4).
//
// Replaces vidar_tpu/ops/latent_render_pallas.py: ray_agg_fused (called from
// _aggregate_fused_partials, vidar_tpu/models/latent_rendering.py:354). Spec:
// _aggregate_xla (latent_rendering.py:310-340). The fused map holds c_r LoRA
// feature channels and Z first-hit probability channels per cell. Along the
// radial ray of cell n, at the G waypoints (the cell itself excluded) that
// lie inside the map's boundary square, feature channel k and probability
// channel k // (c_r / Z) are sampled bilinearly (zeros outside); the output
// is sum(feat * prob) / (sum(prob) + eps). Any group size c_r / Z is taken,
// so no shape falls back to another path.
//
// What bounds it on the H100: instruction issue. The fused map (200x200x32
// bf16 = 2.6 MB at the flagship) sits in L2 and L1, and FLOPs are few. The
// first design, one thread per (batch, cell, feature channel), walked all
// 256 waypoints in every thread, recomputed each waypoint's geometry and
// its bilinear corners twice per channel (for the feature and for its
// probability channel) and read the corners 2 bytes at a time: 2 x c_r = 32
// times the geometry per waypoint, 0.597 ms against a 0.024 ms operations
// bound (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).
//
// The vector design: one warp per (batch, cell), its lanes over the
// waypoints. S lanes share a waypoint (S = 4 for f32 c_r = Z = 16, 2 for
// bf16; the most that leave each lane whole 16-byte chunks of features and
// of the probabilities that weight them), so the warp takes 32 / S
// waypoints at a time. A lane computes its waypoint's geometry once, reads
// its part of each on-map corner's row with 16-byte loads, probabilities
// first, samples those channels, and adds feature x probability into its
// c_r / S numerators and the probabilities into its Z / S denominators, all
// f32 registers. At the end the warp adds its lanes' sums with xor shuffles
// and the first S lanes divide once and write the cell's c_r outputs with
// 16-byte stores. c_r and Z are template arguments (register arrays): the
// presets' pairs, (16, 16) and (4, 4), are built. The
// ray geometry and each sample keep the plain version's arithmetic (the
// round-to-nearest intrinsics of ray_common.cuh, corners in its order);
// only the order of the two sums over waypoints changes. Any other (c_r, Z),
// a c_r or Z that is not a whole number of 16-byte chunks (8 bf16 or 4 f32
// channels), or a map off a 16-byte boundary runs the first design's
// kernel.
//
// Measured (tools/kernel_ab.py, CUDA events, NVIDIA H100 80GB HBM3 at
// 700 W, against the first design in the same process): the forecast's
// bf16 map 0.195 ms (0.576), the fine-tune's f32 map 0.209 ms (0.563). One
// lane a waypoint held every channel of the row and ran at 0.27 ms (bf16)
// and 0.62 ms (f32, 128 registers with spills); two a waypoint in f32, 0.31
// ms; 8-byte runs of 4 channels in place of 16-byte chunks, which let bf16
// take 4 lanes a waypoint, 0.23-0.25 ms.

#include "ray_common.cuh"

namespace {

// The first design, for any (c_r, Z) and alignment: one thread per (batch,
// cell, feature channel), the channel fastest.
template <typename T>
__global__ void ray_aggregate_kernel(const T* __restrict__ fmap,
                                     const float* __restrict__ grids,
                                     const float* __restrict__ radial,
                                     const float* __restrict__ steps,
                                     float* __restrict__ out, int B, int H,
                                     int W, int CT, int c_r, int Z, int N,
                                     int G, float eps) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * N * c_r) return;
  const int k = (int)(idx % c_r);
  const int n = (int)((idx / c_r) % N);
  const long long b = idx / ((long long)c_r * N);
  const int zc = c_r + k / (c_r / Z);  // probability channel of k
  const T* map = fmap + b * H * W * CT;
  const float rx = radial[2 * n], ry = radial[2 * n + 1];
  // waypoints strictly inside the unit square's boundary along the ray
  const float boundary = fminf(__fdiv_rn(1.f, fabsf(rx)),
                               __fdiv_rn(1.f, fabsf(ry)));
  float num = 0.f, den = 0.f;
  for (int g = 0; g < G; ++g) {
    const float step = __ldg(steps + g);
    const float px = ray::waypoint(rx, step);
    const float py = ray::waypoint(ry, step);
    if (!(ray::length2(px, py) < boundary)) continue;
    const float f = ray::sample(map, H, W, CT, k, px, py);
    const float p = ray::sample(map, H, W, CT, zc, px, py);
    num = __fadd_rn(num, __fmul_rn(f, p));
    den = __fadd_rn(den, p);
  }
  out[idx] = __fdiv_rn(num, __fadd_rn(den, eps));
}

// A 16-byte chunk of a row as f32 values: 4 f32 or 8 bf16 channels.
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 v = __bfloat1622float2(h[k]);
    f[2 * k] = v.x;
    f[2 * k + 1] = v.y;
  }
}

// One 16-byte chunk j of a bilinear sample: the on-map corners' chunks
// (row[c] null off the map), each read before any is used, times their
// weights, summed in corner order.
template <int CPL>
__device__ __forceinline__ void sample_chunk(const uint4* const (&row)[4],
                                             const float (&cw)[4], int j,
                                             float (&v)[CPL]) {
  uint4 raw[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    raw[c] = row[c] ? __ldg(row[c] + j) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int k = 0; k < CPL; ++k) v[k] = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (!row[c]) continue;
    float e[CPL];
    unpack(raw[c], e);
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      v[k] = __fadd_rn(v[k], __fmul_rn(e[k], cw[c]));
  }
}

// One warp per (batch, cell), lanes over waypoints: S lanes per waypoint,
// lane part h (of S) owning the feature channels [h CR/S, (h+1) CR/S) and
// the probability channels [h ZD/S, (h+1) ZD/S) that weight them, each a
// whole number of 16-byte chunks of the row.
template <typename T, int CR, int ZD, int S>
__global__ void __launch_bounds__(256, S == 1 ? 2 : 4)
ray_aggregate_vec_kernel(const T* __restrict__ fmap,
                         const float* __restrict__ radial,
                         const float* __restrict__ steps,
                         float* __restrict__ out, int B, int H, int W, int N,
                         int G, float eps) {
  constexpr int CT = CR + ZD;
  constexpr int GRP = CR / ZD;
  constexpr int CPL = 16 / sizeof(T);  // channels per 16-byte chunk
  constexpr int NCH = CT / CPL;        // chunks per row
  constexpr int CH = CR / S, ZH = ZD / S;  // this lane's channels
  const int lane = threadIdx.x & 31;
  const int part = lane % S;
  const int fc0 = part * CH / CPL;              // its first feature chunk
  const int pc0 = (CR + part * ZH) / CPL;       // its first probability one
  const long long warp =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (warp >= (long long)B * N) return;  // uniform across the warp
  const int n = (int)(warp % N);
  const long long b = warp / N;
  const uint4* map = reinterpret_cast<const uint4*>(fmap + b * H * W * CT);
  const float rx = __ldg(radial + 2 * n), ry = __ldg(radial + 2 * n + 1);
  // waypoints strictly inside the unit square's boundary along the ray
  const float boundary = fminf(__fdiv_rn(1.f, fabsf(rx)),
                               __fdiv_rn(1.f, fabsf(ry)));
  float num[CH], den[ZH];
#pragma unroll
  for (int k = 0; k < CH; ++k) num[k] = 0.f;
#pragma unroll
  for (int z = 0; z < ZH; ++z) den[z] = 0.f;

  for (int g = lane / S; g < G; g += 32 / S) {
    const float step = __ldg(steps + g);
    const float gx = ray::waypoint(rx, step);
    const float gy = ray::waypoint(ry, step);
    if (!(ray::length2(gx, gy) < boundary)) continue;
    // ray::sample's geometry
    const float x = __fmul_rn(
        __fsub_rn(__fmul_rn(__fadd_rn(gx, 1.f), (float)W), 1.f), 0.5f);
    const float y = __fmul_rn(
        __fsub_rn(__fmul_rn(__fadd_rn(gy, 1.f), (float)H), 1.f), 0.5f);
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const int ix0 = (int)x0f;
    const int iy0 = (int)y0f;
    if (iy0 < -1 || iy0 > H - 1 || ix0 < -1 || ix0 > W - 1) continue;
    const float wx1 = __fsub_rn(x, x0f);
    const float wy1 = __fsub_rn(y, y0f);
    const float wx[2] = {__fsub_rn(1.f, wx1), wx1};
    const float wy[2] = {__fsub_rn(1.f, wy1), wy1};
    // the on-map corners and their weights, in ray::sample's order
    const uint4* row[4];
    float cw[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int iy = iy0 + (c >> 1), ix = ix0 + (c & 1);
      const bool on = iy >= 0 && iy < H && ix >= 0 && ix < W;
      row[c] = on ? map + (long long)(iy * W + ix) * NCH : nullptr;
      cw[c] = __fmul_rn(wy[c >> 1], wx[c & 1]);
    }
    // the probabilities first, then the features, each times its own
    float p[ZH];
#pragma unroll
    for (int j = 0; j < ZH / CPL; ++j) {
      float v[CPL];
      sample_chunk(row, cw, pc0 + j, v);
#pragma unroll
      for (int k = 0; k < CPL; ++k) p[j * CPL + k] = v[k];
    }
#pragma unroll
    for (int z = 0; z < ZH; ++z) den[z] = __fadd_rn(den[z], p[z]);
#pragma unroll
    for (int j = 0; j < CH / CPL; ++j) {
      float v[CPL];
      sample_chunk(row, cw, fc0 + j, v);
#pragma unroll
      for (int k = 0; k < CPL; ++k)
        num[j * CPL + k] = __fadd_rn(
            num[j * CPL + k], __fmul_rn(v[k], p[(j * CPL + k) / GRP]));
    }
  }

  // the sums of the lanes of each part, then one division per output
#pragma unroll
  for (int off = S; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < CH; ++k)
      num[k] = __fadd_rn(num[k], __shfl_xor_sync(0xffffffffu, num[k], off));
#pragma unroll
    for (int z = 0; z < ZH; ++z)
      den[z] = __fadd_rn(den[z], __shfl_xor_sync(0xffffffffu, den[z], off));
  }
  if (lane < S) {
    float4* o = reinterpret_cast<float4*>(out + warp * CR + part * CH);
#pragma unroll
    for (int k = 0; k < CH; k += 4)
      o[k / 4] = make_float4(
          __fdiv_rn(num[k], __fadd_rn(den[k / GRP], eps)),
          __fdiv_rn(num[k + 1], __fadd_rn(den[(k + 1) / GRP], eps)),
          __fdiv_rn(num[k + 2], __fadd_rn(den[(k + 2) / GRP], eps)),
          __fdiv_rn(num[k + 3], __fadd_rn(den[(k + 3) / GRP], eps)));
  }
}

// Whether S lanes a waypoint each get whole 16-byte chunks (CPL channels)
// of features and probabilities, and whole float4s of outputs.
constexpr bool parts(int CR, int ZD, int CPL, int S) {
  return (CR / S) % CPL == 0 && (ZD / S) % CPL == 0 && (CR / S) % 4 == 0;
}

// Launches the vector kernel for (CR, ZD) when the call has that shape and
// its features and probabilities are whole 16-byte chunks, with S = 4, 2 or
// 1 lanes a waypoint, the most that leave each lane whole chunks -> whether
// it launched.
template <typename T, int CR, int ZD>
bool launch_vec(const void* fmap, const void* radial, const void* steps,
                void* out, int B, int H, int W, int c_r, int Z, int N, int G,
                float eps, cudaStream_t st) {
  constexpr int CPL = 16 / sizeof(T);
  constexpr int S =
      parts(CR, ZD, CPL, 4) ? 4 : parts(CR, ZD, CPL, 2) ? 2 : 1;
  if constexpr (CR % CPL != 0 || ZD % CPL != 0) {
    return false;
  } else {
    if (c_r != CR || Z != ZD) return false;
    const long long threads = (long long)B * N * 32;
    const unsigned blocks = (unsigned)((threads + 255) / 256);
    ray_aggregate_vec_kernel<T, CR, ZD, S><<<blocks, 256, 0, st>>>(
        (const T*)fmap, (const float*)radial, (const float*)steps,
        (float*)out, B, H, W, N, G, eps);
    return true;
  }
}

template <typename T>
void launch(const void* fmap, const void* grids, const void* radial,
            const void* steps, void* out, int B, int H, int W, int CT,
            int c_r, int Z, int N, int G, float eps, cudaStream_t st) {
  const bool aligned = (reinterpret_cast<size_t>(fmap) & 15) == 0 &&
                       (reinterpret_cast<size_t>(out) & 15) == 0;
  // the presets' shapes: (16, 16) at the flagship, (4, 4) in the tiny ones
  if (aligned &&
      (launch_vec<T, 16, 16>(fmap, radial, steps, out, B, H, W, c_r, Z, N,
                             G, eps, st) ||
       launch_vec<T, 4, 4>(fmap, radial, steps, out, B, H, W, c_r, Z, N, G,
                           eps, st)))
    return;
  const long long total = (long long)B * N * c_r;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  ray_aggregate_kernel<T><<<blocks, threads, 0, st>>>(
      (const T*)fmap, (const float*)grids, (const float*)radial,
      (const float*)steps, (float*)out, B, H, W, CT, c_r, Z, N, G, eps);
}

}  // namespace

extern "C" int ray_aggregate_forward(const void* fmap, int fmap_is_bf16,
                                     const void* grids, const void* radial,
                                     const void* steps, void* out, int B,
                                     int H, int W, int CT, int c_r, int Z,
                                     int N, int G, float eps, void* stream) {
  if ((long long)B * N * c_r == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (fmap_is_bf16) {
    launch<__nv_bfloat16>(fmap, grids, radial, steps, out, B, H, W, CT, c_r,
                          Z, N, G, eps, st);
  } else {
    launch<float>(fmap, grids, radial, steps, out, B, H, W, CT, c_r, Z, N, G,
                  eps, st);
  }
  return (int)cudaGetLastError();
}
