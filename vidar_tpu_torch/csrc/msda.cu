// Multi-scale deformable attention forward (K1).
//
// Replaces vidar_tpu/ops/msda_pallas.py: msda_gather_fused (f32 tables, the
// SCA call) and msda_gather_fused16 (bf16 values as u32 row pairs, the TSA
// and decoder calls). Same function as mmcv's ms_deform_attn forward: for
// each (batch, query, head), the sum over levels x points of the attention
// weight times the bilinear sample (align_corners=False, zeros outside the
// map) of the head's value map at the sampling location.
//
// What bounds it on the H100: gathers. Every sample reads 4 value rows of
// `dim` channels at data-dependent addresses (SCA, counted from the shapes: 6
// x 12000 queries x 8 heads x 32 samples x 4 corners = 74M rows of 64 bytes
// in bf16, against 95 MB of value maps that L2 can partly hold). FLOPs are
// negligible. The design answers with one warp per (batch, query, head) and
// one lane per channel, so each corner read is one coalesced 64-byte (bf16)
// or 128-byte (f32) row, with the sample's location and weight loaded once
// per warp and broadcast by shuffle; the sum stays in a register in f32. The
// TPU kernel's packed-corner tables, row-pair packing and VMEM budgets have
// no counterpart: they existed for Mosaic, and a Hopper warp reads bf16 rows
// directly.
//
// Measured at the forecast's shapes (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700 W): 2.70 ms per SCA call (plain PyTorch 39.8 ms), 0.60 ms per TSA call
// (11.3 ms), 0.30 ms per decoder call (9.1 ms).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void msda_forward_kernel(const T* __restrict__ value,
                                    const int* __restrict__ shapes,
                                    const int* __restrict__ level_start,
                                    const float* __restrict__ loc,
                                    const float* __restrict__ weights,
                                    float* __restrict__ out,
                                    int B, int V, int Q, int heads, int dim,
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
  // loc [B, Q, heads, L, P, 2] and weights [B, Q, heads, L, P]
  const float* loc_w = loc + warp * LP * 2;
  const float* aw_w = weights + warp * LP;
  // value [B, V, heads, dim]
  const long long vstride = (long long)heads * dim;
  const T* vbase = value + b * V * vstride + (long long)head * dim;

  float acc = 0.f;
  for (int s0 = 0; s0 < LP; s0 += 32) {
    const int s = s0 + lane;
    float lx = 0.f, ly = 0.f, la = 0.f;
    if (s < LP) {
      lx = loc_w[2 * s];
      ly = loc_w[2 * s + 1];
      la = aw_w[s];
    }
    const int n = min(32, LP - s0);
    for (int j = 0; j < n; ++j) {
      const float locx = __shfl_sync(0xffffffffu, lx, j);
      const float locy = __shfl_sync(0xffffffffu, ly, j);
      const float aw = __shfl_sync(0xffffffffu, la, j);
      const int l = (s0 + j) / P;
      const int h = __ldg(shapes + 2 * l);
      const int w = __ldg(shapes + 2 * l + 1);
      const T* lv = vbase + (long long)__ldg(level_start + l) * vstride;
      // pixel coords, align_corners=False: loc * size - 0.5
      const float x = __fsub_rn(__fmul_rn(locx, (float)w), 0.5f);
      const float y = __fsub_rn(__fmul_rn(locy, (float)h), 0.5f);
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const int ix0 = (int)x0f;
      const int iy0 = (int)y0f;
      // a sample touches the map iff its top-left corner is in
      // [-1, h-1] x [-1, w-1] (vidar_tpu/ops/msda.py:913-918)
      if (lane >= dim || iy0 < -1 || iy0 > h - 1 || ix0 < -1 ||
          ix0 > w - 1) {
        continue;
      }
      const float wx1 = __fsub_rn(x, x0f);
      const float wy1 = __fsub_rn(y, y0f);
      const float wx0 = __fsub_rn(1.f, wx1);
      const float wy0 = __fsub_rn(1.f, wy1);
      const bool y0ok = iy0 >= 0, y1ok = iy0 + 1 <= h - 1;
      const bool x0ok = ix0 >= 0, x1ok = ix0 + 1 <= w - 1;
      float v = 0.f;
      if (y0ok && x0ok)
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(wy0, wx0),
              to_f32(lv[(long long)(iy0 * w + ix0) * vstride + lane])));
      if (y0ok && x1ok)
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(wy0, wx1),
              to_f32(lv[(long long)(iy0 * w + ix0 + 1) * vstride + lane])));
      if (y1ok && x0ok)
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(wy1, wx0),
              to_f32(lv[(long long)((iy0 + 1) * w + ix0) * vstride + lane])));
      if (y1ok && x1ok)
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(wy1, wx1),
              to_f32(lv[(long long)((iy0 + 1) * w + ix0 + 1) * vstride +
                        lane])));
      acc = __fadd_rn(acc, __fmul_rn(aw, v));
    }
  }
  if (lane < dim) out[bq * vstride + (long long)head * dim + lane] = acc;
}

}  // namespace

extern "C" int msda_forward(const void* value, int value_is_bf16,
                            const void* shapes, const void* level_start,
                            const void* loc, const void* weights, void* out,
                            int B, int V, int Q, int heads, int dim, int L,
                            int P, void* stream) {
  const long long warps = (long long)B * Q * heads;
  if (warps == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  if (value_is_bf16) {
    msda_forward_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)value, (const int*)shapes,
        (const int*)level_start, (const float*)loc, (const float*)weights,
        (float*)out, B, V, Q, heads, dim, L, P);
  } else {
    msda_forward_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
        (const float*)value, (const int*)shapes, (const int*)level_start,
        (const float*)loc, (const float*)weights, (float*)out, B, V, Q,
        heads, dim, L, P);
  }
  return (int)cudaGetLastError();
}
