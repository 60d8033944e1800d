// Latent rendering, pass 1 backward: d(first-hit probability)/d(occupancy
// logits) (K6 and K7 in one kernel).
//
// Replaces vidar_tpu/ops/latent_render_pallas.py: ray_prob_dlogit (K6, the
// per-waypoint dlogit by a prefix/suffix-product sweep) and ray_prob_scatter
// (K7, the bilinear scatter of dlogit into the packed occupancy gradient),
// both called from _first_hit_bwd (vidar_tpu/models/latent_rendering.py:
// 236-298). The forward (K3, csrc/ray_first_hit.cu) is
//   out[z] = P * L,   P = prod_k (1 - p_k m_k),   L = p_cell,
// p = act(bilinear occupancy logit), m_k = 1 for the waypoints strictly
// closer to the map centre than the cell. Its gradient per waypoint is
//   dlogit_k = -g L act'(l_k) m_k prod_{j != k} (1 - p_j m_j),
// and for both activations act'(l_k) holds the factor 1 - p_k, so no
// product has to leave waypoint k out:
//   sigmoid         act' = p (1 - p)         dlogit_k = -g L P p_k m_k
//   1 - exp(-relu)  act' = e^-l [l > 0]      dlogit_k = -g L P [l_k > 0] m_k
//                        = (1 - p) [l > 0]
// and the cell's own term is dlogit_cell = g P act'(l_cell). P is formed as
// K3 forms it, in exact arithmetic the product of the factors 1 - p:
// sigmoid's 1 - p = 1 / (1 + e^l), so P is one division per bin by the
// product of the denominators; the exponential's 1 - p = e^-relu(l), so P
// = exp(-sum relu(l)). Nothing is divided by 1 - p m: a saturated ray (P =
// 0) gets the exact gradient, and with the exponential a waypoint whose
// own factor rounds to 0 in the plain version's 1 - (1 - e^-l) keeps the
// gradient autograd gives it (e^-l times the others' product), which that
// rounded product would zero. Only the occupancy map gets a gradient: the
// ray geometry is constant, as in the JAX custom_vjp.
//
// What bounds it on the H100: instruction issue, as in K3, plus the
// scatter: 40000 cells x ~77 inside waypoints x 4 corners x 16 bins =
// 0.2G f32 adds into a 2.6 MB map that stays in L2 (0.0236 ms of f32
// operations at the pre-training step's shapes, chip_smoke.py's bound).
// The JAX package writes the [B, N, S*Z] f32 dlogit to HBM between its two
// kernels (658 MB at the flagship shape) only because Mosaic needed a
// separate scatter kernel; here each dlogit is scattered as soon as it is
// formed.
//
// The first design (one thread per (batch, cell, bin), 1.942 ms on the
// pre-training step's bf16 map and 0.815 ms on the fine-tune's f32 one,
// chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W) walked all G waypoints
// twice in every thread, recomputed each waypoint's geometry once per bin,
// kept a checkpoint of the prefix product every 16 waypoints in a 64-entry
// local table (so G <= 1024) for a reverse sweep that formed the suffix
// products, and scattered each corner and bin with a scalar atomic.
//
// The vector design takes K3's layout: one warp per (batch, cell), the
// waypoints 32 at a time, a lane each for the geometry (ray_common.cuh's
// round-to-nearest intrinsics, so the strict-inside test is the plain
// version's bit for bit); a ballot lists the inside waypoints' sample
// corners in shared memory, and S lanes a listed waypoint sample it over
// 4 bins of the corner rows (8 or 16 bytes). Two walks over the list:
//   1. P per bin (K3's accumulators, xor-shuffles across the lanes), then
//      the cell's own term, scattered by the first S lanes;
//   2. each listed waypoint re-sampled, its dlogit -g L P (p_k or
//      [l_k > 0]) formed per bin and scattered into the 4 corner rows with
//      float4 reductions (red.global.add.v4.f32), runs of 4 zero bins
//      skipped. A lane group takes a run of consecutive waypoints and
//      merges the corner rows that neighbours share before they go out.
// A cell whose g is zero in every bin, or whose g L P is, skips the walks
// it does not need. When the steps ascend from zero (the block checks
// them) the inside waypoints are a prefix, and both walks stop at the
// first batch with none. No table, no reverse sweep, any G.
//
// Measured (tools/kernel_ab.py, device time, NVIDIA H100 80GB HBM3 at
// 700.00 W, against the first design in the same process): the
// pre-training step's bf16 map 0.345 ms (1.906), the fine-tune step's f32
// map 0.108 ms (0.784), where g is zero in 74% of the cells; each map cast
// to the other dtype 0.356 and 0.104 ms (the first design 1.901 and
// 0.788): the cells' zero gradients, not the dtype, set both designs' gap
// between the two steps. Timed variants (copies with one edit, the same
// call), bf16 input: walk 1 alone 0.129 ms; walk 2 without its reductions
// (merge kept) 0.319; without the merge 0.452; plain stores for the
// reductions 0.425. So walk 2's sampling and merging, instruction issue,
// bound it now, and the merge takes 0.107 ms off. Earlier calls: 2
// lanes a bf16 row (16-byte chunks, 8 bins), whose reductions each fill
// half a 32-byte sector, 0.946 ms; 4 bins a lane without the merge 0.445;
// the merge with no reductions within 3 px of the map centre, where every
// ray starts, unchanged (no contention left to remove).
//
// Z = 16 and Z = 4 (the presets) with a 16-byte aligned map and gradient
// run the vector kernel; any other Z or alignment the scalar kernel, the
// first design's layout (a thread per (batch, cell, bin)) with the same two
// walks. ray_first_hit_backward_route names the kernel a call takes.

#include "ray_common.cuh"

namespace {

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

// Walk 1's accumulator of the factors 1 - p: the exponent sum (exponential)
// or the product of the denominators 1 + e^l (sigmoid); and P from it.
__device__ __forceinline__ float accumulate(float acc, float logit,
                                            bool act_exp) {
  return act_exp ? __fadd_rn(acc, fmaxf(logit, 0.f))
                 : __fmul_rn(acc, __fadd_rn(1.f, expf(logit)));
}

__device__ __forceinline__ float product(float acc, bool act_exp) {
  return act_exp ? expf(-acc) : 1.f / acc;
}

// dlogit of an inside waypoint with logit l, given -g L P
__device__ __forceinline__ float dlogit(float l, float ngl, bool act_exp) {
  return act_exp ? (l > 0.f ? ngl : 0.f)
                 : ngl * __fdividef(1.f, 1.f + expf(-l));
}

// The scalar kernel: one thread per (batch, cell, bin), the bin fastest.
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

  // walk 1: P
  float acc = act_exp ? 0.f : 1.f;
  for (int k = 0; k < G; ++k) {
    const float step = __ldg(steps + k);
    const float px = ray::waypoint(rx, step);
    const float py = ray::waypoint(ry, step);
    if (!(ray::length2(px, py) < cell_len)) continue;  // factor 1
    acc = accumulate(acc, ray::sample(map, H, W, Z, z, px, py), act_exp);
  }
  const float prod = product(acc, act_exp);
  float dact_cell;
  const float p_cell =
      activate(ray::sample(map, H, W, Z, z, cx, cy), act_exp, &dact_cell);
  ray::scatter(dmap, H, W, Z, z, cx, cy, g * prod * dact_cell);

  // walk 2: each inside waypoint's dlogit, scattered
  const float ngl = -(g * p_cell * prod);
  if (ngl == 0.f) return;
  for (int k = 0; k < G; ++k) {
    const float step = __ldg(steps + k);
    const float px = ray::waypoint(rx, step);
    const float py = ray::waypoint(ry, step);
    if (!(ray::length2(px, py) < cell_len)) continue;
    const float d =
        dlogit(ray::sample(map, H, W, Z, z, px, py), ngl, act_exp);
    if (d != 0.f) ray::scatter(dmap, H, W, Z, z, px, py, d);
  }
}

// One warp per (batch, cell); S lanes a listed waypoint, lane part h (of S)
// owning bins [h CPL, (h + 1) CPL). EXP: the activation 1 - exp(-relu),
// else sigmoid.
template <typename T, int ZD, bool EXP>
__global__ void __launch_bounds__(256)
ray_first_hit_backward_vec_kernel(const T* __restrict__ occ,
                                  const float* __restrict__ grids,
                                  const float* __restrict__ radial,
                                  const float* __restrict__ steps,
                                  const float* __restrict__ gout,
                                  float* __restrict__ docc, int B, int H,
                                  int W, int N, int G) {
  constexpr int CPL = 4;  // bins a lane: one float4 of the gradient row
  constexpr int S = ZD / CPL;
  constexpr int PER = 32 / S;  // waypoints sampled per warp step
  __shared__ int4 corners[8][32];  // a batch's inside waypoints, per warp
  // whether the steps ascend from zero: then the waypoints inside the
  // cell's radius are a prefix (K3)
  bool ascending = true;
  for (int k = threadIdx.x; k < G; k += blockDim.x) {
    const float s = __ldg(steps + k);
    ascending &= k == 0 ? s >= 0.f : __ldg(steps + k - 1) <= s;
  }
  const bool prefix = __syncthreads_and(ascending);
  const long long warp =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (warp >= (long long)B * N) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int part = lane % S;
  float gz[CPL];  // this lane's bins of g
  {
    const float4* gp =
        reinterpret_cast<const float4*>(gout + warp * ZD + part * CPL);
    bool live = false;
#pragma unroll
    for (int r = 0; r < CPL / 4; ++r) {
      const float4 v = __ldg(gp + r);
      gz[4 * r] = v.x;
      gz[4 * r + 1] = v.y;
      gz[4 * r + 2] = v.z;
      gz[4 * r + 3] = v.w;
      live |= v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
    }
    if (!__any_sync(0xffffffffu, live)) return;  // every dlogit is zero
  }
  const int n = (int)(warp % N);
  const long long b = warp / N;
  const T* map = occ + b * H * W * ZD;
  float* drow = docc + b * H * W * ZD + part * CPL;  // the lane's bins
  int4* batch = corners[threadIdx.x >> 5];
  const float rx = __ldg(radial + 2 * n), ry = __ldg(radial + 2 * n + 1);
  const float cx = __fsub_rn(__fmul_rn(__ldg(grids + 2 * n), 2.f), 1.f);
  const float cy = __fsub_rn(__fmul_rn(__ldg(grids + 2 * n + 1), 2.f), 1.f);
  const float cell_len = ray::length2(cx, cy);

  // walk 1: P per bin
  float acc[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) acc[k] = EXP ? 0.f : 1.f;
  for (int g0 = 0; g0 < G; g0 += 32) {
    const int n_in = ray::list_inside(batch, steps, g0, G, lane, rx, ry,
                                      cell_len, H, W, prefix);
    if (n_in < 0) break;
    for (int k = lane / S; k < n_in; k += PER) {
      float logit[CPL];
      ray::sample_bins<T, ZD, CPL>(map, H, W, part, batch[k], logit);
#pragma unroll
      for (int z = 0; z < CPL; ++z) acc[z] = accumulate(acc[z], logit[z], EXP);
    }
    __syncwarp();
  }
#pragma unroll
  for (int off = S; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const float o = __shfl_xor_sync(0xffffffffu, acc[k], off);
      acc[k] = EXP ? __fadd_rn(acc[k], o) : __fmul_rn(acc[k], o);
    }
  }

  // the cell's own term; ngl = -g L P for walk 2
  const int4 cell = ray::corner_of(H, W, cx, cy);
  float ngl[CPL];
  bool live = false;
  {
    float logit[CPL], dcell[1][CPL];
    ray::sample_bins<T, ZD, CPL>(map, H, W, part, cell, logit);
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const float prod = product(acc[k], EXP);
      float dact;
      const float p = activate(logit[k], EXP, &dact);
      dcell[0][k] = gz[k] * prod * dact;
      ngl[k] = -(gz[k] * p * prod);
      live |= ngl[k] != 0.f;
    }
    if (lane < S) {
      int np[4];
      float4 nv[4][1];
      ray::corner_rows(H, W, cell, dcell, np, nv);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (np[c] >= 0) ray::red4(drow + np[c] * ZD, nv[c][0]);
    }
  }
  if (!__any_sync(0xffffffffu, live)) return;

  // walk 2: each inside waypoint's dlogit, scattered; a lane group takes a
  // run of consecutive listed waypoints and merges the corner rows they
  // share (ray::PendingRows)
  for (int g0 = 0; g0 < G; g0 += 32) {
    const int n_in = ray::list_inside(batch, steps, g0, G, lane, rx, ry,
                                      cell_len, H, W, prefix);
    if (n_in < 0) break;
    const int run = (n_in + PER - 1) / PER;
    const int k0 = lane / S * run, k1 = min(k0 + run, n_in);
    ray::PendingRows<ZD, 1, 0> rows;
    for (int k = k0; k < k1; ++k) {
      const int4 cr = batch[k];
      float d[1][CPL];
      ray::sample_bins<T, ZD, CPL>(map, H, W, part, cr, d[0]);
#pragma unroll
      for (int z = 0; z < CPL; ++z) d[0][z] = dlogit(d[0][z], ngl[z], EXP);
      int np[4];
      float4 nv[4][1];
      ray::corner_rows(H, W, cr, d, np, nv);
      rows.push(drow, np, nv);
    }
    rows.flush(drow);
    __syncwarp();
  }
}

// 1: the vector kernel, 0: the scalar kernel
int route(const void* occ, const void* gout, const void* docc, int Z) {
  return (Z == 16 || Z == 4) && (reinterpret_cast<size_t>(occ) & 15) == 0 &&
         (reinterpret_cast<size_t>(gout) & 15) == 0 &&
         (reinterpret_cast<size_t>(docc) & 15) == 0;
}

template <typename T>
void launch(const void* occ, const void* grids, const void* radial,
            const void* steps, const void* gout, void* docc, int B, int H,
            int W, int Z, int N, int G, int act_exp, cudaStream_t st) {
  if (route(occ, gout, docc, Z)) {
    const unsigned blocks = (unsigned)(((long long)B * N * 32 + 255) / 256);
    auto kernel =
        Z == 16 ? (act_exp ? ray_first_hit_backward_vec_kernel<T, 16, true>
                           : ray_first_hit_backward_vec_kernel<T, 16, false>)
                : (act_exp ? ray_first_hit_backward_vec_kernel<T, 4, true>
                           : ray_first_hit_backward_vec_kernel<T, 4, false>);
    kernel<<<blocks, 256, 0, st>>>(
        (const T*)occ, (const float*)grids, (const float*)radial,
        (const float*)steps, (const float*)gout, (float*)docc, B, H, W, N,
        G);
    return;
  }
  const long long total = (long long)B * N * Z;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  ray_first_hit_backward_kernel<T><<<blocks, 256, 0, st>>>(
      (const T*)occ, (const float*)grids, (const float*)radial,
      (const float*)steps, (const float*)gout, (float*)docc, B, H, W, Z, N, G,
      act_exp);
}

}  // namespace

// Which kernel ray_first_hit_backward runs for these arguments: 1 the vector
// kernel, 0 the scalar kernel.
extern "C" int ray_first_hit_backward_route(const void* occ, const void* gout,
                                            const void* docc, int Z) {
  return route(occ, gout, docc, Z);
}

// docc: f32 [B, H, W, Z], zeroed by the caller.
extern "C" int ray_first_hit_backward(const void* occ, int occ_is_bf16,
                                      const void* grids, const void* radial,
                                      const void* steps, const void* gout,
                                      void* docc, int B, int H, int W, int Z,
                                      int N, int G, int act_exp,
                                      void* stream) {
  if ((long long)B * N * Z == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (occ_is_bf16) {
    launch<__nv_bfloat16>(occ, grids, radial, steps, gout, docc, B, H, W, Z,
                          N, G, act_exp, st);
  } else {
    launch<float>(occ, grids, radial, steps, gout, docc, B, H, W, Z, N, G,
                  act_exp, st);
  }
  return (int)cudaGetLastError();
}
