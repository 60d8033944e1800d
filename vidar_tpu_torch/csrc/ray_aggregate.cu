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
// What bounds it on the H100: like K3, dependent-address loads that hit in
// cache, in a sequential walk (counted from the shapes: 40000 cells x 16
// channels x 256 waypoints x 8 loads), not HBM bytes (the fused map is
// 200x200x32 bf16 = 2.6 MB) and not FLOPs. The design: one thread per (batch,
// cell, feature channel) with the channel fastest, so a warp's corner reads
// of the 16 feature channels and of the 16 probability channels are 32-byte
// segments; waypoints and their validity are recomputed in registers;
// numerator and denominator are carried in registers and divided once.
//
// Measured at the forecast's shape (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700 W): 0.58 ms per call (plain PyTorch 44.1 ms).

#include "ray_common.cuh"

namespace {

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

}  // namespace

extern "C" int ray_aggregate_forward(const void* fmap, int fmap_is_bf16,
                                     const void* grids, const void* radial,
                                     const void* steps, void* out, int B,
                                     int H, int W, int CT, int c_r, int Z,
                                     int N, int G, float eps, void* stream) {
  const long long total = (long long)B * N * c_r;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (fmap_is_bf16) {
    ray_aggregate_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)fmap, (const float*)grids,
        (const float*)radial, (const float*)steps, (float*)out, B, H, W, CT,
        c_r, Z, N, G, eps);
  } else {
    ray_aggregate_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)fmap, (const float*)grids, (const float*)radial,
        (const float*)steps, (float*)out, B, H, W, CT, c_r, Z, N, G, eps);
  }
  return (int)cudaGetLastError();
}
