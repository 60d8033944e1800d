// Latent rendering, pass 2 backward: d(ray aggregation)/d(fused map) (K8).
//
// Replaces vidar_tpu/ops/latent_render_pallas.py: ray_agg_fused_bwd (called
// from _aggregate_bwd, vidar_tpu/models/latent_rendering.py:397-468). The
// forward (K4, csrc/ray_aggregate.cu) is out_k = num_k / (den_z + eps), with
// num_k = sum_g f_k(g) p_z(g) and den_z = sum_g p_z(g) over the waypoints g
// inside the map's boundary square, feature channel k weighted by
// probability channel z = k // (c_r / Z). The backward recomputes
// (num, den), forms
//   dnum_k = g_k / (den_z + eps),   dden_k = -g_k num_k / (den_z + eps)^2
// (latent_rendering.py:431-437), and scatters, at every valid waypoint,
//   d f_k(g) = dnum_k p_z(g)             into feature channel k,
//   d p_z(g) = dnum_k f_k(g) + dden_k    into probability channel c_r + z
// with the bilinear corner weights. The group sum over the k of one z
// happens in the atomics. Only the fused map gets a gradient: the ray
// geometry is constant, as in the JAX custom_vjp.
//
// What bounds it on the H100: as K4, cached dependent-address loads in a
// sequential walk (done twice: once for (num, den), once for the scatter),
// plus 8 f32 atomic updates per valid waypoint (counted from the shapes:
// 40000 cells x 16 channels x ~230 waypoints x 8 = 1.2G atomics into a
// 5.1 MB f32 map gradient that stays in L2). The design keeps K4's layout,
// one thread per (batch, cell, feature channel) with the channel fastest,
// so a warp's atomics on one corner land on 16 neighbouring addresses of
// one row. The TPU kernel's column-chunked packed tables (a VMEM budget)
// have no counterpart, and (num, den) never go to device memory.

#include "ray_common.cuh"

namespace {

template <typename T>
__global__ void ray_aggregate_backward_kernel(
    const T* __restrict__ fmap, const float* __restrict__ grids,
    const float* __restrict__ radial, const float* __restrict__ steps,
    const float* __restrict__ gout, float* __restrict__ dfmap, int B, int H,
    int W, int CT, int c_r, int Z, int N, int G, float eps) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * N * c_r) return;
  const float g = gout[idx];
  if (g == 0.f) return;  // this channel sends no gradient anywhere
  const int k = (int)(idx % c_r);
  const int n = (int)((idx / c_r) % N);
  const long long b = idx / ((long long)c_r * N);
  const int zc = c_r + k / (c_r / Z);  // probability channel of k
  const T* map = fmap + b * H * W * CT;
  float* dmap = dfmap + b * H * W * CT;
  const float rx = radial[2 * n], ry = radial[2 * n + 1];
  const float boundary = fminf(__fdiv_rn(1.f, fabsf(rx)),
                               __fdiv_rn(1.f, fabsf(ry)));
  // (num, den) with K4's exact arithmetic
  float num = 0.f, den = 0.f;
  for (int s = 0; s < G; ++s) {
    const float step = __ldg(steps + s);
    const float px = ray::waypoint(rx, step);
    const float py = ray::waypoint(ry, step);
    if (!(ray::length2(px, py) < boundary)) continue;
    const float f = ray::sample(map, H, W, CT, k, px, py);
    const float p = ray::sample(map, H, W, CT, zc, px, py);
    num = __fadd_rn(num, __fmul_rn(f, p));
    den = __fadd_rn(den, p);
  }
  // autograd's division adjoints of num / (den + eps)
  const float dd = __fadd_rn(den, eps);
  const float dnum = g / dd;
  const float dden = -g * ((num / dd) / dd);
  for (int s = 0; s < G; ++s) {
    const float step = __ldg(steps + s);
    const float px = ray::waypoint(rx, step);
    const float py = ray::waypoint(ry, step);
    if (!(ray::length2(px, py) < boundary)) continue;
    const float f = ray::sample(map, H, W, CT, k, px, py);
    const float p = ray::sample(map, H, W, CT, zc, px, py);
    ray::scatter(dmap, H, W, CT, k, px, py, dnum * p);
    ray::scatter(dmap, H, W, CT, zc, px, py, dnum * f + dden);
  }
}

}  // namespace

// dfmap: f32 [B, H, W, CT], zeroed by the caller.
extern "C" int ray_aggregate_backward(const void* fmap, int fmap_is_bf16,
                                      const void* grids, const void* radial,
                                      const void* steps, const void* gout,
                                      void* dfmap, int B, int H, int W,
                                      int CT, int c_r, int Z, int N, int G,
                                      float eps, void* stream) {
  const long long total = (long long)B * N * c_r;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (fmap_is_bf16) {
    ray_aggregate_backward_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)fmap, (const float*)grids,
        (const float*)radial, (const float*)steps, (const float*)gout,
        (float*)dfmap, B, H, W, CT, c_r, Z, N, G, eps);
  } else {
    ray_aggregate_backward_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)fmap, (const float*)grids, (const float*)radial,
        (const float*)steps, (const float*)gout, (float*)dfmap, B, H, W, CT,
        c_r, Z, N, G, eps);
  }
  return (int)cudaGetLastError();
}
