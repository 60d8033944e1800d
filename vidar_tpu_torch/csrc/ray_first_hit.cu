// Latent rendering, pass 1: first-hit probability along radial rays (K3).
//
// Replaces vidar_tpu/ops/latent_render_pallas.py: ray_prob_fused (called from
// _first_hit_fused_impl, vidar_tpu/models/latent_rendering.py:175). Spec:
// _first_hit_xla (latent_rendering.py:81-105). For every BEV cell n and
// height bin z, the ray from the map centre through the cell is sampled at G
// waypoints plus the cell itself; each sample is the bilinear occupancy logit
// (zeros outside the map) passed through sigmoid or 1 - exp(-relu). The
// output is the final transmittance prod_k (1 - p_k * inside_k) over the
// waypoints strictly closer to the centre than the cell, times the cell's own
// p.
//
// What bounds it on the H100: neither bytes nor FLOPs in bulk. The map is
// small (200x200x16 bf16 = 1.3 MB, within L2), but every (cell, z) walks 257
// waypoints in sequence with 4 dependent-address loads and one transcendental
// each: counted from the shapes, 40000 x 16 x 257 x 4 = 660M loads that hit
// in cache. The design: one thread per (batch, cell, z) with z fastest, so
// the threads of a warp read the 16 bins of a corner as one 32-byte (bf16)
// segment; the geometry is recomputed in registers from the cell centre, the
// radial direction and the step table (no [N, 257, 2] path tensor in memory),
// and the product is carried in a register. The TPU kernel's packed corner
// tables and column chunks (a VMEM budget) are not needed.
//
// Measured at the forecast's shape (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700 W): 0.43 ms per call (plain PyTorch 37.9 ms).

#include "ray_common.cuh"

namespace {

template <typename T>
__global__ void ray_first_hit_kernel(const T* __restrict__ occ,
                                     const float* __restrict__ grids,
                                     const float* __restrict__ radial,
                                     const float* __restrict__ steps,
                                     float* __restrict__ out, int B, int H,
                                     int W, int Z, int N, int G,
                                     int act_exp) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * N * Z) return;
  const int z = (int)(idx % Z);
  const int n = (int)((idx / Z) % N);
  const long long b = idx / ((long long)Z * N);
  const T* map = occ + b * H * W * Z;
  const float rx = radial[2 * n], ry = radial[2 * n + 1];
  // the cell itself is the last point of the path
  const float cx = __fsub_rn(__fmul_rn(grids[2 * n], 2.f), 1.f);
  const float cy = __fsub_rn(__fmul_rn(grids[2 * n + 1], 2.f), 1.f);
  const float cell_len = ray::length2(cx, cy);
  float prod = 1.f;
  for (int k = 0; k < G; ++k) {
    const float step = __ldg(steps + k);
    const float px = ray::waypoint(rx, step);
    const float py = ray::waypoint(ry, step);
    if (!(ray::length2(px, py) < cell_len)) continue;  // factor 1
    const float logit = ray::sample(map, H, W, Z, z, px, py);
    const float p = act_exp ? __fsub_rn(1.f, expf(-fmaxf(logit, 0.f)))
                            : 1.f / (1.f + expf(-logit));
    prod = __fmul_rn(prod, __fsub_rn(1.f, p));
  }
  const float logit = ray::sample(map, H, W, Z, z, cx, cy);
  const float p_last = act_exp ? __fsub_rn(1.f, expf(-fmaxf(logit, 0.f)))
                               : 1.f / (1.f + expf(-logit));
  out[idx] = __fmul_rn(prod, p_last);
}

}  // namespace

extern "C" int ray_first_hit_forward(const void* occ, int occ_is_bf16,
                                     const void* grids, const void* radial,
                                     const void* steps, void* out, int B,
                                     int H, int W, int Z, int N, int G,
                                     int act_exp, void* stream) {
  const long long total = (long long)B * N * Z;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (occ_is_bf16) {
    ray_first_hit_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)occ, (const float*)grids, (const float*)radial,
        (const float*)steps, (float*)out, B, H, W, Z, N, G, act_exp);
  } else {
    ray_first_hit_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)occ, (const float*)grids, (const float*)radial,
        (const float*)steps, (float*)out, B, H, W, Z, N, G, act_exp);
  }
  return (int)cudaGetLastError();
}
