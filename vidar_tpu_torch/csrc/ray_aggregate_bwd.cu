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
// What bounds it on the H100: instruction issue in the scatter walk. The
// fused map (2.6 MB in bf16 at the flagship's 200 x 200 x 32) and its f32
// gradient (5.1 MB) stay in L2. At the flagship geometry (G = 256 steps a
// pixel apart) a cell has 114.8 valid waypoints, 4.59M (cell, waypoint)
// pairs in all; at 4 corner rows of 8 float4s each, up to 147M float4
// reductions: 122M on the pre-training step, where g is zero in 15.4% of
// the cells, 83M after the merge below (counted by tools/kernel_ab.py).
//
// The first design (one thread per (batch, cell, feature channel), 1.327
// ms on the pre-training step's bf16 map and 0.200 ms on the fine-tune's
// f32 one, where g is zero in 99.84% of the cells) walked all G waypoints
// twice in every thread, recomputed each waypoint's geometry and corners 2
// x c_r = 32 times, read the corners 2 bytes at a time and scattered with
// 8 scalar atomics a valid waypoint. It stays for the shapes the vector
// kernel does not take.
//
// The vector design combines K4's walk and K6/K7's scatter: one warp per
// (batch, cell), which returns at once where the cell's g is zero. The
// waypoints go 32 at a time, a lane each for the geometry (ray_common.cuh's
// round-to-nearest intrinsics, so the valid test is the plain version's bit
// for bit); a ballot lists the valid waypoints' sample corners in shared
// memory. S = c_r / 4 lanes sample a listed waypoint, lane part r reading
// feature chunk r and the probability chunk that weights it (4 channels
// each: 8 bytes in bf16, 16 in f32), so no lane needs another's sample.
// Two walks over the lists:
//   1. (num, den) per channel, summed across the lanes by xor shuffles;
//      every lane then forms its channels' dnum and dden;
//   2. each listed waypoint re-sampled, its row gradient formed and
//      scattered into the 4 corner rows with float4 reductions
//      (red.global.add.v4.f32; the 4 lanes of a waypoint cover 64
//      contiguous bytes of the row's features, then of its probabilities,
//      whole 32-byte sectors). A lane group takes a run of consecutive
//      listed waypoints and merges the corner rows neighbours share before
//      they go out (ray::PendingRows): 68.3% of the reductions remain.
// When the steps ascend from zero (the block checks them) the valid
// waypoints are a prefix, and both walks stop at the first batch with none.
// The TPU kernel's column-chunked packed tables and 0/1 expansion matmuls
// (a VMEM budget) have no counterpart, and (num, den) never go to device
// memory.
//
// Measured (tools/kernel_ab.py, device time, NVIDIA H100 80GB HBM3 at
// 700.00 W, against the first design in the same process): the
// pre-training step's bf16 map 0.633 ms (1.327), the fine-tune step's f32
// map 0.042 ms (0.200); each cast to the other dtype 0.686 (1.279) and
// 0.042 (0.174). Timed variants (copies with one edit, the same call), bf16
// input: walk 1 alone 0.153 ms; walk 2 alone 0.555; no reductions (merge
// kept) 0.568; plain stores for the reductions 0.650; no merge 0.755. So
// walk 2's sampling and merge bound it, the reductions cost 0.065 ms and
// the merge saves 0.12. Earlier calls: 8 lanes a waypoint, 4 channels each,
// with each lane's partner sample taken by a shuffle, 0.81 ms (0.72 with
// at most 85 registers; its merge cost more than it saved); at most 128
// registers (launch bounds of 2 blocks an SM) took the f32 map from 0.94
// to 0.68 ms; merging only the 9 corner pairs a monotone ray can share, in
// the ray's corner order, gained nothing here and cost K6/K7 19 registers.
//
// (c_r, Z) = (16, 16) and (4, 4) (the presets) with the map, g and the
// gradient on 16-byte boundaries run the vector kernel; any other shape or
// alignment the scalar kernel. ray_aggregate_backward_route names the
// kernel a call takes.

#include "ray_common.cuh"

namespace {

// The first design, for any (c_r, Z) and alignment: one thread per (batch,
// cell, feature channel), the channel fastest.
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


// One warp per (batch, cell); S = CR / 4 lanes a listed waypoint, lane
// part r owning feature chunk r (channels [4r, 4r + 4) of the row) and the
// probability chunk that weights it (channels CR + [4r, 4r + 4): CR == ZD,
// so feature k pairs with probability CR + k). At most 128 registers, so
// that 2 blocks fit an SM (without the bound, the f32 map took 0.94 ms in
// place of 0.68).
template <typename T, int CR>
__global__ void __launch_bounds__(256, 2)
ray_aggregate_backward_vec_kernel(const T* __restrict__ fmap,
                                  const float* __restrict__ radial,
                                  const float* __restrict__ steps,
                                  const float* __restrict__ gout,
                                  float* __restrict__ dfmap, int B, int H,
                                  int W, int N, int G, float eps) {
  constexpr int CT = 2 * CR;  // channels of a row
  constexpr int S = CR / 4;   // lanes a waypoint
  constexpr int PER = 32 / S;  // waypoints sampled per warp step
  __shared__ int4 corners[8][32];  // a batch's inside waypoints, per warp
  // whether the steps ascend from zero: then the waypoints inside the
  // boundary square are a prefix (K3)
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
  const float4 g4 =
      __ldg(reinterpret_cast<const float4*>(gout + warp * CR) + part);
  if (!__any_sync(0xffffffffu, g4.x != 0.f || g4.y != 0.f || g4.z != 0.f ||
                                   g4.w != 0.f))
    return;  // the cell sends no gradient anywhere
  const float g[4] = {g4.x, g4.y, g4.z, g4.w};
  const int n = (int)(warp % N);
  const long long b = warp / N;
  const T* map = fmap + b * H * W * CT;
  float* drow = dfmap + b * H * W * CT + part * 4;  // the lane's features
  int4* batch = corners[threadIdx.x >> 5];
  const float rx = __ldg(radial + 2 * n), ry = __ldg(radial + 2 * n + 1);
  // waypoints strictly inside the unit square's boundary along the ray
  const float boundary = fminf(__fdiv_rn(1.f, fabsf(rx)),
                               __fdiv_rn(1.f, fabsf(ry)));

  // walk 1: num and den of the lane's channels; v[0] the features, v[1]
  // the probabilities
  float num[4] = {0.f, 0.f, 0.f, 0.f}, den[4] = {0.f, 0.f, 0.f, 0.f};
  for (int g0 = 0; g0 < G; g0 += 32) {
    const int n_in = ray::list_inside(batch, steps, g0, G, lane, rx, ry,
                                      boundary, H, W, prefix);
    if (n_in < 0) break;
    for (int k = lane / S; k < n_in; k += PER) {
      float v[2][4];
      ray::sample_chunks<T, CT, 4, 2, S>(map, H, W, part, batch[k], v);
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        num[z] = __fadd_rn(num[z], __fmul_rn(v[0][z], v[1][z]));
        den[z] = __fadd_rn(den[z], v[1][z]);
      }
    }
    __syncwarp();
  }
  // the sums of the lanes of each part; then the division's adjoints
  // (autograd's: dnum = g / dd, dden = -g (num / dd) / dd, dd = den + eps)
  float dnum[4], dden[4];
#pragma unroll
  for (int z = 0; z < 4; ++z) {
#pragma unroll
    for (int off = S; off < 32; off <<= 1) {
      num[z] = __fadd_rn(num[z], __shfl_xor_sync(0xffffffffu, num[z], off));
      den[z] = __fadd_rn(den[z], __shfl_xor_sync(0xffffffffu, den[z], off));
    }
    const float dd = __fadd_rn(den[z], eps);
    dnum[z] = g[z] / dd;
    dden[z] = -g[z] * ((num[z] / dd) / dd);
  }

  // walk 2: each inside waypoint's row gradient (d f = dnum p, d p = dnum f
  // + dden), scattered; a lane group takes a run of consecutive listed
  // waypoints and merges the corner rows they share (ray::PendingRows)
  for (int g0 = 0; g0 < G; g0 += 32) {
    const int n_in = ray::list_inside(batch, steps, g0, G, lane, rx, ry,
                                      boundary, H, W, prefix);
    if (n_in < 0) break;
    const int run = (n_in + PER - 1) / PER;
    const int k0 = lane / S * run, k1 = min(k0 + run, n_in);
    ray::PendingRows<CT, 2, CR> rows;
    for (int k = k0; k < k1; ++k) {
      const int4 cr = batch[k];
      float v[2][4], d[2][4];
      ray::sample_chunks<T, CT, 4, 2, S>(map, H, W, part, cr, v);
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        d[0][z] = dnum[z] * v[1][z];
        d[1][z] = fmaf(dnum[z], v[0][z], dden[z]);
      }
      int np[4];
      float4 nv[4][2];
      ray::corner_rows(H, W, cr, d, np, nv);
      rows.push(drow, np, nv);
    }
    rows.flush(drow);
    __syncwarp();
  }
}

// 1: the vector kernel, 0: the scalar kernel (the first design)
int route(const void* fmap, const void* gout, const void* dfmap, int c_r,
          int Z) {
  return ((c_r == 16 && Z == 16) || (c_r == 4 && Z == 4)) &&
         (reinterpret_cast<size_t>(fmap) & 15) == 0 &&
         (reinterpret_cast<size_t>(gout) & 15) == 0 &&
         (reinterpret_cast<size_t>(dfmap) & 15) == 0;
}

template <typename T>
void launch(const void* fmap, const void* grids, const void* radial,
            const void* steps, const void* gout, void* dfmap, int B, int H,
            int W, int CT, int c_r, int Z, int N, int G, float eps,
            cudaStream_t st) {
  if (route(fmap, gout, dfmap, c_r, Z)) {
    const unsigned blocks = (unsigned)(((long long)B * N * 32 + 255) / 256);
    auto kernel = c_r == 16 ? ray_aggregate_backward_vec_kernel<T, 16>
                            : ray_aggregate_backward_vec_kernel<T, 4>;
    kernel<<<blocks, 256, 0, st>>>(
        (const T*)fmap, (const float*)radial, (const float*)steps,
        (const float*)gout, (float*)dfmap, B, H, W, N, G, eps);
    return;
  }
  const long long total = (long long)B * N * c_r;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  ray_aggregate_backward_kernel<T><<<blocks, 256, 0, st>>>(
      (const T*)fmap, (const float*)grids, (const float*)radial,
      (const float*)steps, (const float*)gout, (float*)dfmap, B, H, W, CT,
      c_r, Z, N, G, eps);
}

}  // namespace

// Which kernel ray_aggregate_backward runs for these arguments: 1 the
// vector kernel, 0 the scalar kernel.
extern "C" int ray_aggregate_backward_route(const void* fmap,
                                            const void* gout,
                                            const void* dfmap, int c_r,
                                            int Z) {
  return route(fmap, gout, dfmap, c_r, Z);
}

// dfmap: f32 [B, H, W, CT], zeroed by the caller.
extern "C" int ray_aggregate_backward(const void* fmap, int fmap_is_bf16,
                                      const void* grids, const void* radial,
                                      const void* steps, const void* gout,
                                      void* dfmap, int B, int H, int W,
                                      int CT, int c_r, int Z, int N, int G,
                                      float eps, void* stream) {
  if ((long long)B * N * c_r == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (fmap_is_bf16) {
    launch<__nv_bfloat16>(fmap, grids, radial, steps, gout, dfmap, B, H, W,
                          CT, c_r, Z, N, G, eps, st);
  } else {
    launch<float>(fmap, grids, radial, steps, gout, dfmap, B, H, W, CT, c_r,
                  Z, N, G, eps, st);
  }
  return (int)cudaGetLastError();
}
