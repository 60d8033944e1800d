// Fused modulated 3x3 deformable convolution, DCNv2 forward (K2).
//
// Replaces vidar_tpu/ops/dcn_pallas.py: dcn16_conv_gather (called through
// dcn_conv16, selected at vidar_tpu/models/resnet.py:120-127). For each
// output pixel q and tap t it samples the bf16 input bilinearly at (sy[q,t],
// sx[q,t]) with zeros outside the map, multiplies by the modulation mask,
// rounds the tap to bf16 (as the TPU kernel does before its MXU product,
// dcn_pallas.py:640-648), and contracts the [Q, 9*C] taps with the [9*C, CO]
// bf16 kernel, accumulating in f32. The tap tensor never reaches global
// memory.
//
// What bounds it on the H100: at ResNet-101 stage 3 (30 images x 58x100, C =
// CO = 256) one call is, counted from the shapes, 205 GFLOP of bf16 product
// against 89 MB of input, so the product is compute bound on the tensor
// cores; the data-dependent gather in front of it (4 corner reads per tap
// element) is the other half of the work. The design: a block owns a 64-pixel
// x 128-channel output tile; it computes the 64 x 9 taps' corner offsets and
// weights once into shared memory, then walks K = 9*C in steps of 32: the
// block gathers the 64 x 32 tap slice (each thread two adjacent channels, one
// 4-byte read per corner, 16 threads per 64-byte row) into shared memory as
// bf16, stages the 32 x 128 weight slice with 16-byte loads, and eight warps
// run WMMA 16x16x16 bf16 products with f32 accumulators (each warp a 32 x 32
// sub-tile). The output tile goes through shared memory so that a ragged last
// pixel tile is masked. Simple first: no cp.async pipelining, no wgmma, no
// TMA yet.
//
// Measured at the forecast's shapes (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700 W): 2.99 ms per stage-3 call (plain PyTorch 33.5 ms), 3.00 ms per
// stage-4 call (20.8 ms).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;         // output pixels per block
constexpr int BN = 128;        // output channels per block
constexpr int BK = 32;         // K slice (channels of one tap)
constexpr int TAPS = 9;
constexpr int NTHREADS = 256;  // 8 warps: 2 (M) x 4 (N), 32 x 32 each
constexpr int A_LD = BK + 8;   // bf16 elements
constexpr int B_LD = BN + 8;   // bf16 elements
constexpr int C_LD = BN + 4;   // f32 elements

constexpr int GEO_BYTES = BM * TAPS * 4 * 4;             // 9216
constexpr int OFF_GEO_W = GEO_BYTES;                     // f32 weights
constexpr int OFF_A = 2 * GEO_BYTES;                     // 18432
constexpr int OFF_B = OFF_A + BM * A_LD * 2;             // 23552
constexpr int OFF_C = OFF_B + BK * B_LD * 2;             // 32256
constexpr int SMEM_BYTES = OFF_C + BM * C_LD * 4;        // 66048

__global__ void __launch_bounds__(NTHREADS)
dcn_conv_kernel(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ sx, const float* __restrict__ sy,
                const float* __restrict__ mask,
                const __nv_bfloat16* __restrict__ weight,
                float* __restrict__ out, int H, int W, int C, int Q, int CO) {
  extern __shared__ __align__(128) unsigned char smem[];
  int* geo_off = reinterpret_cast<int*>(smem);
  float* geo_w = reinterpret_cast<float*>(smem + OFF_GEO_W);
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem + OFF_A);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + OFF_B);
  float* Cs = reinterpret_cast<float*>(smem + OFF_C);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int warp_m = warp >> 2;  // 0..1
  const int warp_n = warp & 3;   // 0..3
  const long long b = blockIdx.z;
  const int q0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // 1. corner offsets (elements into the image) and weights (bilinear x
  //    mask, zero for corners off the map) for every (pixel, tap)
  for (int i = tid; i < BM * TAPS; i += NTHREADS) {
    const int r = i / TAPS;
    const int t = i - r * TAPS;
    const int q = q0 + r;
    int off[4] = {0, 0, 0, 0};
    float wgt[4] = {0.f, 0.f, 0.f, 0.f};
    if (q < Q) {
      const long long gi = (b * Q + q) * TAPS + t;
      const float px = sx[gi];
      const float py = sy[gi];
      const float m = mask[gi];
      const float x0f = floorf(px);
      const float y0f = floorf(py);
      const int ix0 = (int)x0f;
      const int iy0 = (int)y0f;
      if (iy0 >= -1 && iy0 <= H - 1 && ix0 >= -1 && ix0 <= W - 1) {
        const float wx1 = __fsub_rn(px, x0f);
        const float wy1 = __fsub_rn(py, y0f);
        const float wx[2] = {__fsub_rn(1.f, wx1), wx1};
        const float wy[2] = {__fsub_rn(1.f, wy1), wy1};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int dy = c >> 1, dx = c & 1;
          const int iy = iy0 + dy, ix = ix0 + dx;
          if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
            off[c] = (iy * W + ix) * C;
            wgt[c] = __fmul_rn(__fmul_rn(wy[dy], wx[dx]), m);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      geo_off[i * 4 + c] = off[c];
      geo_w[i * 4 + c] = wgt[c];
    }
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const __nv_bfloat16* xb = x + b * H * W * C;
  const int kc_per_tap = C / BK;
  const int ch2 = 2 * (tid & 15);  // this thread's channel pair in a slice
  for (int kt = 0; kt < TAPS * kc_per_tap; ++kt) {
    const int t = kt / kc_per_tap;
    const int c0 = (kt - t * kc_per_tap) * BK;

    // 2a. tap slice: BM x BK bilinear-folded, masked, rounded to bf16
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
      const int r = (tid >> 4) + 16 * i;
      const int g = (r * TAPS + t) * 4;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float wc = geo_w[g + c];
        if (wc != 0.f) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  xb + geo_off[g + c] + c0 + ch2));
          a0 = __fadd_rn(a0, __fmul_rn(v.x, wc));
          a1 = __fadd_rn(a1, __fmul_rn(v.y, wc));
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(As + r * A_LD + ch2) =
          __floats2bfloat162_rn(a0, a1);
    }
    // 2b. weight slice: rows t*C + c0 .. +BK, columns n0 .. n0+BN
    for (int i = tid; i < BK * BN / 8; i += NTHREADS) {
      const int k = i / (BN / 8);
      const int j8 = (i - k * (BN / 8)) * 8;
      *reinterpret_cast<int4*>(Bs + k * B_LD + j8) =
          *reinterpret_cast<const int4*>(
              weight + (long long)(t * C + c0 + k) * CO + n0 + j8);
    }
    __syncthreads();

    // 2c. tensor-core product of the slice
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (warp_m * 32 + i * 16) * A_LD + kk,
                               A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * B_LD + warp_n * 32 + j * 16,
                               B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // 3. epilogue through shared memory; rows past Q are dropped
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          Cs + (warp_m * 32 + i * 16) * C_LD + warp_n * 32 + j * 16,
          acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN / 4; i += NTHREADS) {
    const int r = i / (BN / 4);
    const int c4 = (i - r * (BN / 4)) * 4;
    const int q = q0 + r;
    if (q < Q) {
      *reinterpret_cast<float4*>(out + (b * Q + q) * CO + n0 + c4) =
          *reinterpret_cast<const float4*>(Cs + r * C_LD + c4);
    }
  }
}

}  // namespace

extern "C" int dcn_conv_forward(const void* x, const void* sx, const void* sy,
                                const void* mask, const void* weight,
                                void* out, int B, int H, int W, int C, int Q,
                                int CO, void* stream) {
  if ((long long)B * Q == 0) return (int)cudaGetLastError();
  cudaError_t err = cudaFuncSetAttribute(
      dcn_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + BM - 1) / BM, CO / BN, B);
  dcn_conv_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)sx, (const float*)sy,
      (const float*)mask, (const __nv_bfloat16*)weight, (float*)out, H, W, C,
      Q, CO);
  return (int)cudaGetLastError();
}
