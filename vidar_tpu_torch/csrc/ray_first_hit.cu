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
// What bounds it on the H100: instruction issue. The map is small (200x200x16
// bf16 = 1.3 MB, within L2 and largely L1) and FLOPs are few (0.013 ms at
// the f32 peak). The first design, one thread per (batch, cell, bin) with the
// bins fastest, walked all G waypoints in every thread and recomputed each
// waypoint's geometry (a correctly rounded sqrt among it) once per bin, 16
// times, for all 256 waypoints though only about 77 lie inside a cell's
// radius on average, and read each corner 2 or 4 bytes at a time: 0.428 ms
// bf16 and 0.436 ms f32 against a 0.0132 ms bound (chip_smoke.py, NVIDIA
// H100 80GB HBM3, 700.00 W).
//
// The vector design takes K4's layout (csrc/ray_aggregate.cu): one warp per
// (batch, cell). The warp walks the waypoints 32 at a time, a lane each: it
// computes the waypoint's geometry once, with ray_common.cuh's
// round-to-nearest intrinsics, so the strict-inside test is the plain
// version's bit for bit, and writes the sample corner of each inside
// waypoint into a per-warp shared-memory list (its place from a ballot).
// Then S lanes a waypoint sample the listed ones, each lane one 16-byte
// chunk of a corner row's Z bins (S = 2 for bf16 and 4 for f32 at Z = 16;
// at Z = 4 one lane holds the row, 8 bytes in bf16), so no lane is idle on
// an outside waypoint. When the steps ascend from zero (the block checks
// them), a waypoint's length never decreases along the ray, so the warp
// stops at the first batch with no inside waypoint. The factor 1 - p is
// folded into a per-bin accumulator without a division per sample: for
// sigmoid 1 - p = 1 / (1 + e^l), and the lane keeps the product of the
// denominators; for 1 - exp(-relu) it is e^-relu(l), and the lane keeps the
// sum of the exponents. An xor-shuffle product (sum) joins the lanes, and
// the first S lanes take one division (exponential) per bin, multiply by
// the cell's own p and write the Z outputs with 16-byte stores. The
// samples use fused multiply-adds. So the outputs differ from the plain
// version's by rounding alone (4.5e-8 at the paths' inputs).
//
// Measured (tools/kernel_ab.py, device time, NVIDIA H100 80GB HBM3 at
// 700.00 W, against the first design in the same process): the forecast's
// bf16 map 0.114 ms (0.414), the fine-tune's f32 map 0.107 ms (0.405), 8x
// the operations bound. Timed variants (bf16 / f32): with no activation
// 0.097 / 0.094 ms, every corner read from one line 0.102 / 0.089, without
// the early stop 0.121 / 0.116, without fused multiply-adds 0.120 / 0.119.
// No single part bounds it: instruction issue, spread over the geometry,
// the samples and the activation. A first vector design with S lanes on
// every waypoint of a batch (idle where it was outside) and the division
// per sample ran 0.144 / 0.150 ms.
//
// Z = 16 and Z = 4 (the presets) with a 16-byte aligned map and output run
// the vector kernel; any other Z or alignment the first design's kernel.
// ray_first_hit_route names the kernel a call takes.

#include "ray_common.cuh"

namespace {

__device__ __forceinline__ float activate(float logit, int act_exp) {
  return act_exp ? __fsub_rn(1.f, expf(-fmaxf(logit, 0.f)))
                 : 1.f / (1.f + expf(-logit));
}

// The first design, for any Z and alignment: one thread per (batch, cell,
// bin), the bin fastest.
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
    prod = __fmul_rn(prod, __fsub_rn(1.f, activate(logit, act_exp)));
  }
  const float logit = ray::sample(map, H, W, Z, z, cx, cy);
  out[idx] = __fmul_rn(prod, activate(logit, act_exp));
}

// One warp per (batch, cell). The warp walks the waypoints 32 at a time, a
// lane each for the geometry; the inside ones are then sampled S lanes a
// waypoint, lane part h (of S) owning bins [h CPL, (h + 1) CPL). EXP: the
// activation 1 - exp(-relu), else sigmoid.
template <typename T, int ZD, bool EXP>
__global__ void __launch_bounds__(256)
ray_first_hit_vec_kernel(const T* __restrict__ occ,
                         const float* __restrict__ grids,
                         const float* __restrict__ radial,
                         const float* __restrict__ steps,
                         float* __restrict__ out, int B, int H, int W, int N,
                         int G) {
  constexpr int ROW = ZD * (int)sizeof(T);  // bytes of a cell's bins
  constexpr int S = ROW >= 16 ? ROW / 16 : 1;
  constexpr int CPL = ZD / S;
  constexpr int PER = 32 / S;  // waypoints sampled per warp step
  __shared__ int4 corners[8][32];  // a batch's inside waypoints, per warp
  // whether the steps ascend from zero: then the waypoints' lengths never
  // decrease along a ray (each rounded operation is monotone), and the
  // waypoints inside the cell's radius are a prefix
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
  const int n = (int)(warp % N);
  const T* map = occ + (warp / N) * H * W * ZD;
  int4* batch = corners[threadIdx.x >> 5];
  const float rx = __ldg(radial + 2 * n), ry = __ldg(radial + 2 * n + 1);
  const float cx = __fsub_rn(__fmul_rn(__ldg(grids + 2 * n), 2.f), 1.f);
  const float cy = __fsub_rn(__fmul_rn(__ldg(grids + 2 * n + 1), 2.f), 1.f);
  const float cell_len = ray::length2(cx, cy);
  // per bin, the product of the factors 1 - p: for sigmoid 1 - p =
  // 1 / (1 + e^l), kept as the product of the denominators; for the
  // exponential 1 - p = e^-relu(l), kept as the sum of the exponents
  float acc[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) acc[k] = EXP ? 0.f : 1.f;

  for (int g0 = 0; g0 < G; g0 += 32) {
    const int g = g0 + lane;
    bool inside = false;
    float px = 0.f, py = 0.f;
    if (g < G) {
      const float step = __ldg(steps + g);
      px = ray::waypoint(rx, step);
      py = ray::waypoint(ry, step);
      inside = ray::length2(px, py) < cell_len;
    }
    const unsigned in = __ballot_sync(0xffffffffu, inside);
    if (!in) {
      if (prefix) break;
      continue;
    }
    if (inside)  // the waypoint's place among the batch's inside ones
      batch[__popc(in & ((1u << lane) - 1u))] =
          ray::corner_of(H, W, px, py);
    __syncwarp();
    const int n_in = __popc(in);
    for (int k = lane / S; k < n_in; k += PER) {
      float logit[CPL];
      ray::sample_bins<T, ZD, CPL>(map, H, W, part, batch[k], logit);
#pragma unroll
      for (int z = 0; z < CPL; ++z)
        acc[z] = EXP ? __fadd_rn(acc[z], fmaxf(logit[z], 0.f))
                     : __fmul_rn(acc[z], __fadd_rn(1.f, expf(logit[z])));
    }
    __syncwarp();
  }

  // the lanes of each part together, then the cell's own p
#pragma unroll
  for (int off = S; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const float o = __shfl_xor_sync(0xffffffffu, acc[k], off);
      acc[k] = EXP ? __fadd_rn(acc[k], o) : __fmul_rn(acc[k], o);
    }
  }
  if (lane < S) {
    float logit[CPL];
    ray::sample_bins<T, ZD, CPL>(map, H, W, part,
                                 ray::corner_of(H, W, cx, cy), logit);
    float t[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      t[k] = __fmul_rn(EXP ? expf(-acc[k]) : 1.f / acc[k],
                       activate(logit[k], EXP));
    float4* o = reinterpret_cast<float4*>(out + warp * ZD + part * CPL);
#pragma unroll
    for (int k = 0; k < CPL; k += 4)
      o[k / 4] = make_float4(t[k], t[k + 1], t[k + 2], t[k + 3]);
  }
}

// 1: the vector kernel, 0: the first design
int route(const void* occ, const void* out, int Z) {
  return (Z == 16 || Z == 4) && (reinterpret_cast<size_t>(occ) & 15) == 0 &&
         (reinterpret_cast<size_t>(out) & 15) == 0;
}

template <typename T>
void launch(const void* occ, const void* grids, const void* radial,
            const void* steps, void* out, int B, int H, int W, int Z, int N,
            int G, int act_exp, cudaStream_t st) {
  if (route(occ, out, Z)) {
    const unsigned blocks = (unsigned)(((long long)B * N * 32 + 255) / 256);
    auto kernel =
        Z == 16 ? (act_exp ? ray_first_hit_vec_kernel<T, 16, true>
                           : ray_first_hit_vec_kernel<T, 16, false>)
                : (act_exp ? ray_first_hit_vec_kernel<T, 4, true>
                           : ray_first_hit_vec_kernel<T, 4, false>);
    kernel<<<blocks, 256, 0, st>>>(
        (const T*)occ, (const float*)grids, (const float*)radial,
        (const float*)steps, (float*)out, B, H, W, N, G);
    return;
  }
  const long long total = (long long)B * N * Z;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  ray_first_hit_kernel<T><<<blocks, 256, 0, st>>>(
      (const T*)occ, (const float*)grids, (const float*)radial,
      (const float*)steps, (float*)out, B, H, W, Z, N, G, act_exp);
}

}  // namespace

// Which kernel ray_first_hit_forward runs for these arguments: 1 the vector
// kernel, 0 the first design.
extern "C" int ray_first_hit_route(const void* occ, const void* out, int Z) {
  return route(occ, out, Z);
}

extern "C" int ray_first_hit_forward(const void* occ, int occ_is_bf16,
                                     const void* grids, const void* radial,
                                     const void* steps, void* out, int B,
                                     int H, int W, int Z, int N, int G,
                                     int act_exp, void* stream) {
  if ((long long)B * N * Z == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (occ_is_bf16) {
    launch<__nv_bfloat16>(occ, grids, radial, steps, out, B, H, W, Z, N, G,
                          act_exp, st);
  } else {
    launch<float>(occ, grids, radial, steps, out, B, H, W, Z, N, G, act_exp,
                  st);
  }
  return (int)cudaGetLastError();
}
