// Multi-scale deformable attention backward (K5).
//
// Replaces vidar_tpu/ops/msda_pallas.py: msda_gather_fused_bwd (the two
// Pallas passes under _msda_fused_bwd, vidar_tpu/ops/msda.py:838-924: the
// per-sample dwx/dwy/daw pass, then the scatter into the packed table
// gradient). Same function as mmcv's ms_deform_attn backward: for each
// (batch, query, head) and each of the L x P samples, with the upstream
// gradient dout over the head's channels,
//   t_c      = <dout, v_c>                 for the four corners c,
//   dweight  = sum_c w_c t_c               (the bilinear sample . dout),
//   dwx      = aw (wy0 (t01 - t00) + wy1 (t11 - t10)),
//   dwy      = aw (wx0 (t10 - t00) + wx1 (t11 - t01)),
//   dloc     = (dwx * w, dwy * h)          (loc is in [0, 1] map units),
//   dvalue_c += aw w_c dout                (the table scatter).
// A sample whose top-left corner lies outside [-1, h-1] x [-1, w-1] touches
// nothing: its dloc and dweight are zero (vidar_tpu/ops/msda.py:905-923);
// a corner off the map reads zero and receives nothing.
//
// What bounds it on the H100. Every sample reads 4 corner rows and adds
// into the same 4 rows of the f32 value gradient (SCA at the flagship,
// counted from the shapes: 6 x 12000 queries x 8 heads x 32 samples x 4
// corners = 74M rows each way, mostly out of L2). FLOPs are negligible.
// The first design (one warp per (batch, query, head), one lane per
// channel, each sample's location broadcast by three shuffles, its
// geometry recomputed by every lane, four 5-step butterfly reductions for
// the dots t_c and four rows of 32 scalar f32 atomics) took 3.49 ms for
// the pre-training step's bf16 SCA call and 4.39 ms for the fine-tune's
// f32 one.
//
// The vector design is K1's (csrc/msda.cu): a warp's lanes go over (sample,
// channel runs), G lanes per row, each lane holding two runs of 4 channels
// (dim 32: 4 lanes a row, run j of lane sub at channels 4 (4 j + sub)), so
// a warp carries 8 samples at once; with few samples (TSA and the decoders:
// 4) one warp serves two (batch, query, head) items. Each lane group loads
// its own sample's location and weight, computes that sample's geometry
// once and issues its corner reads (16 bytes a run in f32, 8 in bf16)
// before it uses any of them. The four dots are summed over the group's
// lanes with log2(G) xor shuffles (a mask of the group's own lanes: the
// groups of a warp walk different samples), and the group's first lane
// writes the sample's dloc and dweight. The scatter adds each run with
// Hopper's vector f32 atomics (atomicAdd on a float4, red.global.add.v4.f32
// on compute capability 9.x), one instruction per 4 channels where the
// first design spent one per channel; a run's lanes across the group cover
// whole 32-byte sectors. The samples of one query, head and level often
// share corners, and a warp instruction whose lanes add into one address
// is served one lane after another: so the groups of an item that hold
// the same corner row first add their weights aw w_c in the lowest of them
// (__match_any_sync on the row and item, shuffles of one float), and each
// row run takes one atomic per warp. The grid stays camera-major, so one
// camera's f32 dvalue slice (31.6 MB at SCA) stays in the 50 MB L2 while
// its queries scatter into it. At most 64 registers a thread, as K1.
//
// Measured (tools/kernel_ab.py, CUDA events, NVIDIA H100 80GB HBM3 at
// 700 W, against the first design in the same process), bf16 pre-training
// / f32 fine-tune inputs: SCA 1.73 / 2.17 ms (3.49 / 4.39), TSA 0.41 /
// 0.45 ms (0.84 / 0.84), decoder 0.20 / 0.022 ms (0.42 / 0.037). Timed
// variants at the bf16 SCA call split the rest: without atomics (plain
// stores) 1.55 ms, without corner reads 1.57 ms, without the merge 2.89
// ms, without merge or atomics 1.29 ms. So what is left is the per-sample
// instruction work (geometry, dots, shuffles, the merge), not the scatter
// or the gather. One run a lane in f32 (4 samples a warp) ran at 3.16 /
// 0.70 ms (SCA / TSA); 80 registers a thread, slower; splitting an item's
// samples among its groups in runs (so the groups hold other levels at
// once) saved atomics but merged less, 4% slower. A dim whose rows do not
// split into a power of two (at most 32) of lanes of 8 channels, or a
// value, dout or dvalue off a 16-byte boundary, runs the first design's
// kernel, its lanes over a 32-channel slice of the row at a time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A run of 4 channels of a value row: one 16-byte load in f32, one
// 8-byte load in bf16, unpacked to f32.
template <typename T> struct Run;

template <> struct Run<float> {
  using Raw = uint4;
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void unpack(const Raw& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};

template <> struct Run<__nv_bfloat16> {
  using Raw = uint2;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ static void unpack(const Raw& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Runs of 4 channels per lane: 8 channels, so a dim-32 row takes 4 lanes
// and a warp carries 8 samples.
constexpr int RUNS = 2;

// G lanes per value row, RUNS runs per lane (run j of lane sub: channels
// 4 (j G + sub) .. + 3), GPI lane groups per (batch, query, head) item,
// 32 / (G * GPI) items per warp.

template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
msda_backward_vec_kernel(const T* __restrict__ value,
                         const int* __restrict__ shapes,
                         const int* __restrict__ level_start,
                         const float* __restrict__ loc,
                         const float* __restrict__ weights,
                         const float* __restrict__ dout,
                         float* __restrict__ dvalue,
                         float* __restrict__ dloc,
                         float* __restrict__ dweights, int V, int Q,
                         int heads, int dim, int L, int P, int G, int GPI,
                         long long total) {
  const int lane = threadIdx.x & 31;
  const int group = lane / G;
  const int sub = lane - group * G;
  const int gi = group % GPI;  // this group's share of the item's samples
  const unsigned gmask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (group * G);
  const int items_per_warp = 32 / (G * GPI);
  const long long warp =
      (long long)blockIdx.x * (THREADS >> 5) + (threadIdx.x >> 5);
  const int slot = group / GPI;  // the item's place in the warp
  const long long item = warp * items_per_warp + slot;
  if (item >= total) return;  // whole groups leave; no warp-wide sync below
  // the lanes that hold the same channels as this one, in every group
  unsigned same_sub = 0u;
  for (int l2 = sub; l2 < 32; l2 += G) same_sub |= 1u << l2;
  const int head = (int)(item % heads);
  const long long bq = item / heads;  // b * Q + q
  const long long b = bq / Q;
  const int LP = L * P;
  // loc [B, Q, heads, L, P, 2] and weights [B, Q, heads, L, P]; dloc and
  // dweights alike
  const float2* loc_i = reinterpret_cast<const float2*>(loc) + item * LP;
  const float* aw_i = weights + item * LP;
  float2* dloc_i = reinterpret_cast<float2*>(dloc) + item * LP;
  float* dw_i = dweights + item * LP;
  // value and dvalue [B, V, heads, dim]: the head's row; this lane's run j
  // starts 4 (j G + sub) channels into it
  const long long vstride = (long long)heads * dim;
  const long long voff = b * V * vstride + (long long)head * dim;
  const T* vbase = value + voff + 4 * sub;
  float* dvbase = dvalue + voff;
  // this lane's runs of dout [B, Q, heads * dim]
  float g[4 * RUNS];
  {
    const float* d = dout + bq * vstride + (long long)head * dim + 4 * sub;
#pragma unroll
    for (int j = 0; j < RUNS; ++j) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(d + 4 * j * G));
      g[4 * j] = v.x;
      g[4 * j + 1] = v.y;
      g[4 * j + 2] = v.z;
      g[4 * j + 3] = v.w;
    }
  }

  for (int s = gi; s < LP; s += GPI) {
    const float2 lxy = __ldg(loc_i + s);
    const float aw = __ldg(aw_i + s);
    const int l = s / P;
    const int h = __ldg(shapes + 2 * l);
    const int w = __ldg(shapes + 2 * l + 1);
    // the forward's exact arithmetic (csrc/msda.cu)
    const float x = __fsub_rn(__fmul_rn(lxy.x, (float)w), 0.5f);
    const float y = __fsub_rn(__fmul_rn(lxy.y, (float)h), 0.5f);
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const int ix0 = (int)x0f;
    const int iy0 = (int)y0f;
    if (iy0 < -1 || iy0 > h - 1 || ix0 < -1 || ix0 > w - 1) {
      // the sample touches nothing: its grads are 0
      if (sub == 0) {
        dloc_i[s] = make_float2(0.f, 0.f);
        dw_i[s] = 0.f;
      }
      continue;
    }
    const float wx1 = __fsub_rn(x, x0f);
    const float wy1 = __fsub_rn(y, y0f);
    const float wx[2] = {__fsub_rn(1.f, wx1), wx1};
    const float wy[2] = {__fsub_rn(1.f, wy1), wy1};
    const long long lofs = (long long)__ldg(level_start + l) * vstride;
    // the four corner reads, all issued before any is used
    long long row[4];
    typename Run<T>::Raw raw[4][RUNS];
    bool on[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int iy = iy0 + (c >> 1), ix = ix0 + (c & 1);
      on[c] = iy >= 0 && iy <= h - 1 && ix >= 0 && ix <= w - 1;
      row[c] = lofs + (long long)(iy * w + ix) * vstride;
#pragma unroll
      for (int j = 0; j < RUNS; ++j)
        raw[c][j] = on[c] ? Run<T>::load(vbase + row[c] + 4 * j * G)
                          : typename Run<T>::Raw{};
    }
    // this lane's part of the four dots, then the group's sum
    float t[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      t[c] = 0.f;
#pragma unroll
      for (int j = 0; j < RUNS; ++j) {
        float f[4];
        Run<T>::unpack(raw[c][j], f);
#pragma unroll
        for (int k = 0; k < 4; ++k) t[c] += g[4 * j + k] * f[k];
      }
    }
    for (int off = 1; off < G; off <<= 1) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        t[c] += __shfl_xor_sync(gmask, t[c], off);
    }
    if (sub == 0) {
      dw_i[s] = wy[0] * wx[0] * t[0] + wy[0] * wx[1] * t[1] +
                wy[1] * wx[0] * t[2] + wy[1] * wx[1] * t[3];
      dloc_i[s] = make_float2(
          aw * (wy[0] * (t[1] - t[0]) + wy[1] * (t[3] - t[2])) * (float)w,
          aw * (wx[0] * (t[2] - t[0]) + wx[1] * (t[3] - t[1])) * (float)h);
    }
    // the scatter of aw w_c dout into each on-map corner. The groups of an
    // item whose corner rows coincide add their weights aw w_c in the lowest
    // of them first (they share dout), so a row takes one atomic per run
    const unsigned active = __activemask();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float scale = aw * (wy[c >> 1] * wx[c & 1]);
      // the corner row's offset and the item's slot (< 32): lanes with one
      // key add the same dout runs to the same row
      const unsigned long long key =
          on[c] ? ((unsigned long long)(voff + row[c]) << 5 | slot) + 1 : 0;
      const unsigned peers = __match_any_sync(active, key) & same_sub;
      const bool leader = on[c] && lane == __ffs(peers) - 1;
      unsigned rest = leader ? peers & (peers - 1u) : 0u;
      float sum = scale;
      while (__any_sync(active, rest != 0u)) {
        const float o = __shfl_sync(active, scale, rest ? __ffs(rest) - 1
                                                        : lane);
        if (rest) sum += o;
        rest &= rest - 1u;
      }
      if (leader) {
        float* dst = dvbase + row[c] + 4 * sub;
#pragma unroll
        for (int j = 0; j < RUNS; ++j)
          atomicAdd(reinterpret_cast<float4*>(dst + 4 * j * G),
                    make_float4(sum * g[4 * j], sum * g[4 * j + 1],
                                sum * g[4 * j + 2], sum * g[4 * j + 3]));
      }
    }
  }
}

// Any dim: one warp per (batch, query, head), one lane per channel of a
// 32-channel slice of the head's row; the samples walked one at a time,
// the slices of each sample in turn.
template <typename T>
__global__ void __launch_bounds__(THREADS)
msda_backward_scalar_kernel(const T* __restrict__ value,
                            const int* __restrict__ shapes,
                            const int* __restrict__ level_start,
                            const float* __restrict__ loc,
                            const float* __restrict__ weights,
                            const float* __restrict__ dout,
                            float* __restrict__ dvalue,
                            float* __restrict__ dloc,
                            float* __restrict__ dweights, int V, int Q,
                            int heads, int dim, int L, int P,
                            long long total) {
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
  float* dloc_w = dloc + warp * LP * 2;
  float* dw_w = dweights + warp * LP;
  const long long vstride = (long long)heads * dim;
  const long long vbase_off = b * V * vstride + (long long)head * dim;
  const T* vbase = value + vbase_off;
  float* dvbase = dvalue + vbase_off;
  const float* gbase = dout + bq * vstride + (long long)head * dim;

  for (int s0 = 0; s0 < LP; s0 += 32) {
    const int s = s0 + lane;
    float lx = 0.f, ly = 0.f, la = 0.f;
    if (s < LP) {
      lx = loc_w[2 * s];
      ly = loc_w[2 * s + 1];
      la = aw_w[s];
    }
    float my_dx = 0.f, my_dy = 0.f, my_dw = 0.f;
    const int n = min(32, LP - s0);
    for (int j = 0; j < n; ++j) {
      const float locx = __shfl_sync(0xffffffffu, lx, j);
      const float locy = __shfl_sync(0xffffffffu, ly, j);
      const float aw = __shfl_sync(0xffffffffu, la, j);
      const int l = (s0 + j) / P;
      const int h = __ldg(shapes + 2 * l);
      const int w = __ldg(shapes + 2 * l + 1);
      const long long lofs = (long long)__ldg(level_start + l) * vstride;
      const T* lv = vbase + lofs;
      float* dlv = dvbase + lofs;
      const float x = __fsub_rn(__fmul_rn(locx, (float)w), 0.5f);
      const float y = __fsub_rn(__fmul_rn(locy, (float)h), 0.5f);
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const int ix0 = (int)x0f;
      const int iy0 = (int)y0f;
      if (iy0 < -1 || iy0 > h - 1 || ix0 < -1 || ix0 > w - 1) {
        continue;  // uniform: the sample touches nothing, its grads are 0
      }
      const float wx1 = __fsub_rn(x, x0f);
      const float wy1 = __fsub_rn(y, y0f);
      const float wx0 = __fsub_rn(1.f, wx1);
      const float wy0 = __fsub_rn(1.f, wy1);
      const bool y0ok = iy0 >= 0, y1ok = iy0 + 1 <= h - 1;
      const bool x0ok = ix0 >= 0, x1ok = ix0 + 1 <= w - 1;
      const long long r00 = (long long)(iy0 * w + ix0) * vstride;
      const long long r01 = r00 + vstride;
      const long long r10 = r00 + (long long)w * vstride;
      const long long r11 = r10 + vstride;
      const float w00 = wy0 * wx0, w01 = wy0 * wx1;
      const float w10 = wy1 * wx0, w11 = wy1 * wx1;
      float p00 = 0.f, p01 = 0.f, p10 = 0.f, p11 = 0.f;
      for (int ch = lane; ch < dim; ch += 32) {
        const float g = __ldg(gbase + ch);
        if (y0ok && x0ok) p00 += g * to_f32(lv[r00 + ch]);
        if (y0ok && x1ok) p01 += g * to_f32(lv[r01 + ch]);
        if (y1ok && x0ok) p10 += g * to_f32(lv[r10 + ch]);
        if (y1ok && x1ok) p11 += g * to_f32(lv[r11 + ch]);
        const float ag = aw * g;
        if (y0ok && x0ok) atomicAdd(dlv + r00 + ch, ag * w00);
        if (y0ok && x1ok) atomicAdd(dlv + r01 + ch, ag * w01);
        if (y1ok && x0ok) atomicAdd(dlv + r10 + ch, ag * w10);
        if (y1ok && x1ok) atomicAdd(dlv + r11 + ch, ag * w11);
      }
      const float t00 = warp_sum(p00);
      const float t01 = warp_sum(p01);
      const float t10 = warp_sum(p10);
      const float t11 = warp_sum(p11);
      if (lane == j) {
        my_dw = w00 * t00 + w01 * t01 + w10 * t10 + w11 * t11;
        my_dx = aw * (wy0 * (t01 - t00) + wy1 * (t11 - t10)) * (float)w;
        my_dy = aw * (wx0 * (t10 - t00) + wx1 * (t11 - t01)) * (float)h;
      }
    }
    if (s < LP) {
      dloc_w[2 * s] = my_dx;
      dloc_w[2 * s + 1] = my_dy;
      dw_w[s] = my_dw;
    }
  }
}

template <typename T>
cudaError_t launch(const void* value, const void* shapes,
                   const void* level_start, const void* loc,
                   const void* weights, const void* dout, void* dvalue,
                   void* dloc, void* dweights, int B, int V, int Q,
                   int heads, int dim, int L, int P, cudaStream_t st) {
  const long long total = (long long)B * Q * heads;
  const int G = dim / (4 * RUNS);
  const bool vec = dim % (4 * RUNS) == 0 && G > 0 && G <= 32 &&
                   (G & (G - 1)) == 0 &&
                   (reinterpret_cast<size_t>(value) & 15) == 0 &&
                   (reinterpret_cast<size_t>(dout) & 15) == 0 &&
                   (reinterpret_cast<size_t>(dvalue) & 15) == 0 &&
                   (reinterpret_cast<size_t>(loc) & 7) == 0 &&
                   (reinterpret_cast<size_t>(dloc) & 7) == 0;
  if (vec) {
    // enough groups per item for its samples, at most the warp's
    int GPI = 1;
    while (GPI < L * P && GPI * G < 32) GPI <<= 1;
    const long long items_per_warp = 32 / (G * GPI);
    const long long warps = (total + items_per_warp - 1) / items_per_warp;
    const long long blocks = (warps * 32 + THREADS - 1) / THREADS;
    msda_backward_vec_kernel<T><<<(unsigned)blocks, THREADS, 0, st>>>(
        (const T*)value, (const int*)shapes, (const int*)level_start,
        (const float*)loc, (const float*)weights, (const float*)dout,
        (float*)dvalue, (float*)dloc, (float*)dweights, V, Q, heads, dim, L,
        P, G, GPI, total);
  } else {
    const long long blocks = (total * 32 + THREADS - 1) / THREADS;
    msda_backward_scalar_kernel<T><<<(unsigned)blocks, THREADS, 0, st>>>(
        (const T*)value, (const int*)shapes, (const int*)level_start,
        (const float*)loc, (const float*)weights, (const float*)dout,
        (float*)dvalue, (float*)dloc, (float*)dweights, V, Q, heads, dim, L,
        P, total);
  }
  return cudaGetLastError();
}

}  // namespace

// dvalue: f32 [B, V, heads, dim], zeroed by the caller; dloc and dweights
// are written in full.
extern "C" int msda_backward(const void* value, int value_is_bf16,
                             const void* shapes, const void* level_start,
                             const void* loc, const void* weights,
                             const void* dout, void* dvalue, void* dloc,
                             void* dweights, int B, int V, int Q, int heads,
                             int dim, int L, int P, void* stream) {
  if ((long long)B * Q * heads == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(value_is_bf16
                   ? launch<__nv_bfloat16>(value, shapes, level_start, loc,
                                           weights, dout, dvalue, dloc,
                                           dweights, B, V, Q, heads, dim, L,
                                           P, st)
                   : launch<float>(value, shapes, level_start, loc, weights,
                                   dout, dvalue, dloc, dweights, B, V, Q,
                                   heads, dim, L, P, st));
}
