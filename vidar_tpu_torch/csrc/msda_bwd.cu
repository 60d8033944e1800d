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
// What bounds it on the H100: like K1, data-dependent row reads (4 corner
// rows per sample) plus, here, 4 atomic row updates per sample into the f32
// value gradient (SCA at the flagship, counted from the shapes: 6 x 12000 x
// 8 heads x 32 samples x 4 corners = 74M rows each way). FLOPs are
// negligible. The design keeps K1's layout: one warp per (batch, query,
// head), one lane per channel, so a corner read is one coalesced row and a
// corner update is one coalesced row of 32 f32 atomics (mmcv's col2im
// scatter); the four dots t_c are butterfly warp reductions, so every lane
// holds them and the lane that owns a sample writes its dloc and dweight
// (one coalesced store per 32 samples). The TPU's two passes and its packed
// corner tables have no counterpart: atomics replace the sequential
// table accumulation, and nothing is staged in device memory between the
// two halves.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void msda_backward_kernel(const T* __restrict__ value,
                                     const int* __restrict__ shapes,
                                     const int* __restrict__ level_start,
                                     const float* __restrict__ loc,
                                     const float* __restrict__ weights,
                                     const float* __restrict__ dout,
                                     float* __restrict__ dvalue,
                                     float* __restrict__ dloc,
                                     float* __restrict__ dweights, int B,
                                     int V, int Q, int heads, int dim,
                                     int L, int P) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const long long total = (long long)B * Q * heads;
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
  const bool chan = lane < dim;
  const float g = chan ? dout[bq * vstride + (long long)head * dim + lane]
                       : 0.f;

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
      // the forward's exact arithmetic (csrc/msda.cu)
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
      const long long r00 = (long long)(iy0 * w + ix0) * vstride + lane;
      const long long r01 = r00 + vstride;
      const long long r10 = r00 + (long long)w * vstride;
      const long long r11 = r10 + vstride;
      const float v00 = (chan && y0ok && x0ok) ? to_f32(lv[r00]) : 0.f;
      const float v01 = (chan && y0ok && x1ok) ? to_f32(lv[r01]) : 0.f;
      const float v10 = (chan && y1ok && x0ok) ? to_f32(lv[r10]) : 0.f;
      const float v11 = (chan && y1ok && x1ok) ? to_f32(lv[r11]) : 0.f;
      const float t00 = warp_sum(g * v00);
      const float t01 = warp_sum(g * v01);
      const float t10 = warp_sum(g * v10);
      const float t11 = warp_sum(g * v11);
      const float w00 = wy0 * wx0, w01 = wy0 * wx1;
      const float w10 = wy1 * wx0, w11 = wy1 * wx1;
      if (lane == j) {
        my_dw = w00 * t00 + w01 * t01 + w10 * t10 + w11 * t11;
        my_dx = aw * (wy0 * (t01 - t00) + wy1 * (t11 - t10)) * (float)w;
        my_dy = aw * (wx0 * (t10 - t00) + wx1 * (t11 - t01)) * (float)h;
      }
      const float ag = aw * g;
      if (chan) {
        if (y0ok && x0ok) atomicAdd(dlv + r00, ag * w00);
        if (y0ok && x1ok) atomicAdd(dlv + r01, ag * w01);
        if (y1ok && x0ok) atomicAdd(dlv + r10, ag * w10);
        if (y1ok && x1ok) atomicAdd(dlv + r11, ag * w11);
      }
    }
    if (s < LP) {
      dloc_w[2 * s] = my_dx;
      dloc_w[2 * s + 1] = my_dy;
      dw_w[s] = my_dw;
    }
  }
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
  const long long warps = (long long)B * Q * heads;
  if (warps == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  if (value_is_bf16) {
    msda_backward_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)value, (const int*)shapes,
        (const int*)level_start, (const float*)loc, (const float*)weights,
        (const float*)dout, (float*)dvalue, (float*)dloc, (float*)dweights,
        B, V, Q, heads, dim, L, P);
  } else {
    msda_backward_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
        (const float*)value, (const int*)shapes, (const int*)level_start,
        (const float*)loc, (const float*)weights, (const float*)dout,
        (float*)dvalue, (float*)dloc, (float*)dweights, B, V, Q, heads, dim,
        L, P);
  }
  return (int)cudaGetLastError();
}
