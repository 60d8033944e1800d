// Latent rendering, pass 1 backward: d(first-hit probability)/d(occupancy
// logits) (K6 and K7 in one kernel).
//
// Replaces vidar_tpu/ops/latent_render_pallas.py: ray_prob_dlogit (K6, the
// per-waypoint dlogit by a prefix/suffix-product sweep) and ray_prob_scatter
// (K7, the bilinear scatter of dlogit into the packed occupancy gradient),
// both called from _first_hit_bwd (vidar_tpu/models/latent_rendering.py:
// 236-298). The forward (K3, csrc/ray_first_hit.cu) is
//   out[z] = P * L,   P = prod_k (1 - ps_k m_k),   L = ps_cell,
// ps = act(bilinear occupancy logit), m_k = 1 for the waypoints strictly
// closer to the map centre than the cell. Its gradient per waypoint is
//   dlogit_k    = -g L pref_k suf_k m_k act'(logit_k),
//   dlogit_cell =  g P act'(logit_cell),
// pref_k / suf_k the products of the factors before / after waypoint k.
// Nothing is divided by (1 - ps m), so a saturated ray (a factor of
// exactly 0) gets the exact gradient. Only the occupancy map gets a
// gradient: the ray geometry is constant, as in the JAX custom_vjp.
//
// What bounds it on the H100: as in K3, cached dependent-address loads in a
// sequential walk, plus here one atomic update of 4 corners per inside
// waypoint (counted from the shapes: 40000 cells x 16 bins x ~80 inside
// waypoints x 4 corners = 0.2G f32 atomics into a 2.6 MB map that stays in
// L2). The JAX package writes the [B, N, S*Z] f32 dlogit to HBM between its
// two kernels (658 MB at the flagship shape) only because Mosaic needed a
// separate scatter kernel; here each dlogit is scattered as soon as it is
// formed, so nothing goes to device memory but the map gradient. The
// design: one thread per (batch, cell, z), z fastest, as in K3. A thread
// cannot keep 256 prefix products in registers, so the forward sweep keeps
// a checkpoint of the prefix product every SEG waypoints (in local memory);
// the reverse sweep then walks the segments from the last, recomputes a
// segment's SEG activations and prefixes in registers from its checkpoint,
// and runs the suffix product backward through it. Each inside waypoint is
// sampled twice, nothing is stored per waypoint, and the products are taken
// in the forward's order, so pref_k is the forward's own value.

#include "ray_common.cuh"

namespace {

constexpr int SEG = 16;      // waypoints per checkpoint segment
constexpr int MAX_SEG = 64;  // G <= SEG * MAX_SEG waypoints

// p = act(logit) as K3 computes it, and dp/dlogit as autograd of the plain
// version takes it (relu' = [logit > 0]).
__device__ __forceinline__ float activate(float logit, int act_exp,
                                          float* dact) {
  if (act_exp) {
    const float e = expf(-fmaxf(logit, 0.f));
    *dact = logit > 0.f ? e : 0.f;
    return __fsub_rn(1.f, e);
  }
  const float p = 1.f / (1.f + expf(-logit));
  *dact = p * (1.f - p);
  return p;
}

template <typename T>
__global__ void ray_first_hit_backward_kernel(
    const T* __restrict__ occ, const float* __restrict__ grids,
    const float* __restrict__ radial, const float* __restrict__ steps,
    const float* __restrict__ gout, float* __restrict__ docc, int B, int H,
    int W, int Z, int N, int G, int act_exp) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * N * Z) return;
  const float g = gout[idx];
  if (g == 0.f) return;  // every dlogit of this (cell, z) is zero
  const int z = (int)(idx % Z);
  const int n = (int)((idx / Z) % N);
  const long long b = idx / ((long long)Z * N);
  const T* map = occ + b * H * W * Z;
  float* dmap = docc + b * H * W * Z;
  const float rx = radial[2 * n], ry = radial[2 * n + 1];
  const float cx = __fsub_rn(__fmul_rn(grids[2 * n], 2.f), 1.f);
  const float cy = __fsub_rn(__fmul_rn(grids[2 * n + 1], 2.f), 1.f);
  const float cell_len = ray::length2(cx, cy);
  const int nseg = (G + SEG - 1) / SEG;

  // forward sweep: the full product P, and the prefix product at the start
  // of every segment
  float ckpt[MAX_SEG];
  float prod = 1.f;
  for (int sg = 0; sg < nseg; ++sg) {
    ckpt[sg] = prod;
    const int k1 = min(G, (sg + 1) * SEG);
    for (int k = sg * SEG; k < k1; ++k) {
      const float step = __ldg(steps + k);
      const float px = ray::waypoint(rx, step);
      const float py = ray::waypoint(ry, step);
      if (!(ray::length2(px, py) < cell_len)) continue;  // factor 1
      float dact;
      const float p =
          activate(ray::sample(map, H, W, Z, z, px, py), act_exp, &dact);
      prod = __fmul_rn(prod, __fsub_rn(1.f, p));
    }
  }
  float dact_cell;
  const float p_cell =
      activate(ray::sample(map, H, W, Z, z, cx, cy), act_exp, &dact_cell);
  ray::scatter(dmap, H, W, Z, z, cx, cy, g * prod * dact_cell);

  // reverse sweep, one segment at a time from the last
  const float gl = g * p_cell;
  float suf = 1.f;
  for (int sg = nseg - 1; sg >= 0; --sg) {
    float ps[SEG], da[SEG], pref[SEG];
    bool ins[SEG];
    float pr = ckpt[sg];
#pragma unroll
    for (int j = 0; j < SEG; ++j) {
      const int k = sg * SEG + j;
      ins[j] = false;
      ps[j] = 0.f;
      da[j] = 0.f;
      pref[j] = pr;
      if (k < G) {
        const float step = __ldg(steps + k);
        const float px = ray::waypoint(rx, step);
        const float py = ray::waypoint(ry, step);
        if (ray::length2(px, py) < cell_len) {
          ins[j] = true;
          ps[j] = activate(ray::sample(map, H, W, Z, z, px, py), act_exp,
                           &da[j]);
          pr = __fmul_rn(pr, __fsub_rn(1.f, ps[j]));
        }
      }
    }
#pragma unroll
    for (int j = SEG - 1; j >= 0; --j) {
      if (!ins[j]) continue;
      const float step = __ldg(steps + sg * SEG + j);
      const float px = ray::waypoint(rx, step);
      const float py = ray::waypoint(ry, step);
      ray::scatter(dmap, H, W, Z, z, px, py, -(pref[j] * suf) * gl * da[j]);
      suf = __fmul_rn(suf, __fsub_rn(1.f, ps[j]));
    }
  }
}

}  // namespace

// docc: f32 [B, H, W, Z], zeroed by the caller.
extern "C" int ray_first_hit_backward(const void* occ, int occ_is_bf16,
                                      const void* grids, const void* radial,
                                      const void* steps, const void* gout,
                                      void* docc, int B, int H, int W, int Z,
                                      int N, int G, int act_exp,
                                      void* stream) {
  if (G > SEG * MAX_SEG) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * N * Z;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (occ_is_bf16) {
    ray_first_hit_backward_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)occ, (const float*)grids, (const float*)radial,
        (const float*)steps, (const float*)gout, (float*)docc, B, H, W, Z, N,
        G, act_exp);
  } else {
    ray_first_hit_backward_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)occ, (const float*)grids, (const float*)radial,
        (const float*)steps, (const float*)gout, (float*)docc, B, H, W, Z, N,
        G, act_exp);
  }
  return (int)cudaGetLastError();
}
