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
// CO = 256) one call is 205 GFLOP of bf16 product against 89 MB of input:
// 0.21 ms at the tensor cores' peak, so the product bounds it by operations.
// The gather in front of the product is as large a job for the other units:
// every tap element is 4 corner reads, 4 products and 4 adds in f32 (no
// FMAs: the taps must equal the plain version's bit for bit) and a round to
// bf16. Run one after the other, with each pixel's taps gathered once per
// 128 output channels, the two took 3.0 ms at every stage.
//
// This design overlaps the two and gathers each tap once per 256 output
// channels. A block owns BM = 64 x WGS pixels (WGS warpgroups of 128
// threads, each the product of 64 rows) by BN output channels, and walks K =
// 9*C in slices of 64 (one 128-byte row of bf16 per pixel; a slice may span
// two taps where C % 64 != 0, and the last one is padded with zeros). The
// slices go through a ring of two shared-memory stages, each holding the
// slice's taps (A, BM x 64, K-major) and weights (B, 64 x BN, N-major as the
// weight lies in memory), both in the 128-byte swizzled layout that wgmma
// reads. For slice s every warpgroup issues its asynchronous wgmma m64nBNk16
// products (bf16 in, f32 accumulators in registers) on stage s & 1, then,
// while the tensor cores run them, the same threads stage slice s + 1 into
// the other stage: the weights by cp.async, and the taps from the corner
// rows that cp.async brought into per-thread slots (see load_corners), with
// the per-(pixel, tap) corner offsets and weights that the block computed
// once into shared memory. Then wgmma.wait, a fence that makes the stores
// visible to the tensor cores, one barrier, and the next slice. The
// epilogue writes each accumulator pair from registers as a float2; rows
// past Q are dropped.
//
// No warp is set aside as a producer. The gather is ALU work that needs
// every warp's issue slots, where a TMA producer would need one thread; the
// BN = 256 accumulators (128 registers a thread) and the corner slots (64
// KB) leave neither registers nor shared memory for more warps. Tried on
// the card and dropped as slower: the corners loaded into registers,
// refetching each row's corners a full slice ahead, and 64-pixel tiles at
// two blocks an SM for stage 2.
//
// Tiles: (WGS, BN) = (2, 256) where CO % 256 == 0 and the call has at least
// one full wave of such tiles (132 SMs), else (2, 128), else (1, 128), so a
// small call (one image of 5800 pixels at stage 3: 46 tiles of 128 x 256)
// still spreads over the card (182 tiles of 64 x 128).
//
// Measured (chip_smoke.py phases 3, 5 and 8, CUDA events, NVIDIA H100 80GB
// HBM3 at 700 W, against the first design in the same call): stage 3 1.03
// ms (2.98-2.99), stage 4 1.05-1.06 ms (3.00-3.01), stage 2 1.74-1.77 ms
// (3.06-3.08); the pre-training step's one-image stage-3 call 0.09 ms and
// its 24-image call 0.84 ms (tools/kernel_ab.py times both designs there).
// It reaches 20% of the bf16 peak at stages 3-4 and 12% at stage 2. What
// bounds it now is the gather's traffic through L2: per tap element 4
// corner rows of 16 bytes per 8 channels and a share of the weight slices,
// about 12 bytes at stage 3 (4.8 GB a call) and 10 at stage 2 (8.0 GB),
// moved at 4.6-4.7 TB/s at both stages.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TAPS = 9;
constexpr int BK = 64;  // K slice: one 128-byte swizzled row per pixel
// B (weights, N-major) in shared memory: 64-column blocks of BK rows, 8-row
// K groups 1024 bytes apart. For an N-major swizzled operand the leading
// byte offset steps along N and the stride byte offset along K.
constexpr uint32_t B_LBO = BK * 128;
constexpr uint32_t B_SBO = 1024;

// A 128-byte swizzle: in each 1024-byte atom of 8 rows of 128 bytes, the
// 16-byte chunk index is XORed with the row index (wgmma's and TMA's
// SWIZZLE_128B).
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & 7u) << 4);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

// 16 bytes global -> shared, asynchronous, straight from L2 (.cg); `bytes`
// < 16 fills the rest with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D[64 x N] += A[64 x 16] (K-major, shared) * B[16 x N] (N-major, shared):
// imm-trans-b = 1. The accumulator fragment of thread (warp w, lane l) of
// the warpgroup: d[4j + 2i + e] is row 16w + l/4 + 8i, column 8j + 2(l%4) +
// e.
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int N> struct Mma;
template <> struct Mma<128> {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b) {
    wgmma_n128(d, a, b);
  }
};
template <> struct Mma<256> {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b) {
    wgmma_n256(d, a, b);
  }
};

// Keeps the compiler from moving accumulator registers across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int WGS, int BN>
struct Tile {
  static constexpr int BM = 64 * WGS;
  static constexpr int THREADS = 128 * WGS;
  // 8-channel chunks of a slice (BM x 64) per thread, one per row: 4
  static constexpr int ROWS_PER_THREAD = BM * (BK / 8) / THREADS;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // per (pixel, tap): 4 corner offsets (int, elements into the image), 4
  // corner weights (f32, bilinear x mask, zero off the map)
  static constexpr int GEO_BYTES = BM * TAPS * 32;
  // per thread: 4 corners x 16 bytes of each of its rows
  static constexpr int SLOT_BYTES = THREADS * ROWS_PER_THREAD * 4 * 16;
  static constexpr int SMEM_BYTES =
      1024 + 2 * STAGE_BYTES + GEO_BYTES + SLOT_BYTES;
  static constexpr int NACC = BN / 2;  // f32 accumulators per thread
};

template <int WGS, int BN>
__global__ void __launch_bounds__(128 * WGS, WGS == 1 ? 2 : 1)
dcn_conv_kernel(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ sx, const float* __restrict__ sy,
                const float* __restrict__ mask,
                const __nv_bfloat16* __restrict__ weight,
                float* __restrict__ out, int H, int W, int C, int Q, int CO,
                int m_tiles) {
  using T = Tile<WGS, BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle works on 1024-byte atoms: align the ring to 1024 bytes
  const uint32_t raw_addr = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t pad = (1024u - (raw_addr & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + pad;
  const uint32_t ring = raw_addr + pad;  // stage s: A at s * STAGE_BYTES
  int4* geo_off = reinterpret_cast<int4*>(smem + 2 * T::STAGE_BYTES);
  float4* geo_w = reinterpret_cast<float4*>(smem + 2 * T::STAGE_BYTES +
                                            T::BM * TAPS * 16);
  const uint32_t slots = ring + 2 * T::STAGE_BYTES + T::GEO_BYTES;

  const int tid = threadIdx.x;
  const int n_tiles = CO / BN;
  // output channel tiles fastest, so the tiles of one pixel tile run side
  // by side and share its corner reads through L2
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int mt = blockIdx.x / n_tiles;
  const long long b = mt / m_tiles;
  const int q0 = (mt - (int)b * m_tiles) * T::BM;
  const int K = TAPS * C;
  const int KT = (K + BK - 1) / BK;

  // 1. corner offsets and weights of every (pixel, tap) of the tile
  for (int i = tid; i < T::BM * TAPS; i += T::THREADS) {
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
    geo_off[i] = make_int4(off[0], off[1], off[2], off[3]);
    geo_w[i] = make_float4(wgt[0], wgt[1], wgt[2], wgt[3]);
  }
  __syncthreads();

  const __nv_bfloat16* xb = x + b * H * W * C;
  const int kc = tid & 7;  // this thread's 8-channel chunk of a slice row

  // weights of slice s into stage st: 64 rows x BN columns, N-major, as
  // BN / 64 column blocks of 8 atoms (8 K rows x 64 columns, 1024 bytes)
  auto stage_weights = [&](int s, int st) {
    const uint32_t base = ring + st * T::STAGE_BYTES + T::A_BYTES;
    constexpr int CHUNKS = BK * BN / 8;
#pragma unroll
    for (int j = 0; j < CHUNKS / T::THREADS; ++j) {
      const int i = tid + j * T::THREADS;
      const int kr = i / (BN / 8);
      const int nc = i - kr * (BN / 8);
      const int k = s * BK + kr;
      const uint32_t off = (nc >> 3) * (BK * 128) + kr * 128 + (nc & 7) * 16;
      const bool in = k < K;
      cp_async16(base + swz(off),
                 in ? weight + (long long)k * CO + n0 + nc * 8 : weight,
                 in ? 16 : 0);
    }
  };

  // The corner rows of a slice: each thread owns one 8-channel chunk of
  // ROWS_PER_THREAD pixel rows and copies the chunk's 4 corners (16 bytes
  // each) by cp.async into its own slots, issued as soon as the previous
  // slice's taps are made, so its 16 reads are in flight together and held
  // in no register. A corner that weighs nothing (off the map, or a zero
  // mask) reads nothing: its slot is zero-filled, and the taps are made
  // without branches. Slots are interleaved by thread, so a warp's 16-byte
  // accesses hit every bank once.
  auto load_corners = [&](int s) {
    const int k = s * BK + kc * 8;
    if (k >= K) return;
    const int t = k / C;
    const __nv_bfloat16* xk = xb + (k - t * C);
#pragma unroll
    for (int j = 0; j < T::ROWS_PER_THREAD; ++j) {
      const int g = ((tid >> 3) + j * (T::THREADS / 8)) * TAPS + t;
      const int4 o = geo_off[g];
      const float4 wv = geo_w[g];
      const int offs[4] = {o.x, o.y, o.z, o.w};
      const float ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool read = ws[c] != 0.f;
        cp_async16(slots + ((j * 4 + c) * T::THREADS + tid) * 16,
                   read ? xk + offs[c] : xk, read ? 16 : 0);
      }
    }
  };

  // taps of slice s into stage st from the thread's slots: BM rows x 64
  // channels, K-major; rows of k >= K are zeros
  auto make_taps = [&](int s, int st) {
    const int k = s * BK + kc * 8;
    const bool kin = k < K;
    const int t = kin ? k / C : 0;
#pragma unroll
    for (int j = 0; j < T::ROWS_PER_THREAD; ++j) {
      const int r = (tid >> 3) + j * (T::THREADS / 8);
      const float4 wv = kin ? geo_w[r * TAPS + t]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      const float ws[4] = {wv.x, wv.y, wv.z, wv.w};
      float a[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] = 0.f;
      // corners in order (y0x0, y0x1, y1x0, y1x1), products and sums
      // rounded apart: the taps of _taps16_plain (a corner that weighs
      // nothing adds a zero)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            smem + (slots - ring) + ((j * 4 + c) * T::THREADS + tid) * 16);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          a[2 * e] = __fadd_rn(a[2 * e], __fmul_rn(f.x, ws[c]));
          a[2 * e + 1] = __fadd_rn(a[2 * e + 1], __fmul_rn(f.y, ws[c]));
        }
      }
      uint4 o;
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o2[e] = __floats2bfloat162_rn(a[2 * e], a[2 * e + 1]);
      *reinterpret_cast<uint4*>(smem + st * T::STAGE_BYTES +
                                swz(r * 128 + kc * 16)) = o;
    }
  };

  // 2. the K loop over a two-stage ring. cp.async groups, in commit order:
  // the weights of slice s + 1, then the corners of slice s + 2; waiting for
  // all but the newest group finds the one before it landed.
  float acc[T::NACC];
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0.f;
  const int wg = tid >> 7;

  load_corners(0);
  cp_async_commit();
  stage_weights(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // corners of slice 0
  make_taps(0, 0);
  if (KT > 1) load_corners(1);
  cp_async_commit();
  cp_async_wait<1>();  // weights of slice 0
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  for (int s = 0; s < KT; ++s) {
    const int st = s & 1;
    const uint32_t a_addr = ring + st * T::STAGE_BYTES + wg * 64 * 128;
    const uint32_t b_addr = ring + st * T::STAGE_BYTES + T::A_BYTES;
    pin<T::NACC>(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: +32 bytes per 16 K within the swizzled row; B: +2 atoms of 8 K
      Mma<BN>::run(acc, smem_desc(a_addr + kk * 32, 16, 1024),
                   smem_desc(b_addr + kk * 2048, B_LBO, B_SBO));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    pin<T::NACC>(acc);
    // while the products run: slice s + 1 into the other stage
    if (s + 1 < KT) stage_weights(s + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // corners of slice s + 1
    if (s + 1 < KT) make_taps(s + 1, st ^ 1);
    if (s + 2 < KT) load_corners(s + 2);
    cp_async_commit();
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    pin<T::NACC>(acc);
    cp_async_wait<1>();  // weights of slice s + 1
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
  cp_async_wait<0>();

  // 3. epilogue from registers; rows past Q are dropped
  const int lane = tid & 31;
  const int row0 = q0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  float* ob = out + b * Q * CO + n0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = row0 + 8 * i;
    if (q >= Q) continue;
    float* orow = ob + (long long)q * CO;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

template <int WGS, int BN>
cudaError_t launch(const void* x, const void* sx, const void* sy,
                   const void* mask, const void* weight, void* out, int B,
                   int H, int W, int C, int Q, int CO, cudaStream_t st) {
  using T = Tile<WGS, BN>;
  auto kernel = dcn_conv_kernel<WGS, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int m_tiles = (Q + T::BM - 1) / T::BM;
  const long long blocks = (long long)B * m_tiles * (CO / BN);
  kernel<<<(unsigned)blocks, T::THREADS, T::SMEM_BYTES, st>>>(
      (const __nv_bfloat16*)x, (const float*)sx, (const float*)sy,
      (const float*)mask, (const __nv_bfloat16*)weight, (float*)out, H, W, C,
      Q, CO, m_tiles);
  return cudaGetLastError();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

}  // namespace

extern "C" int dcn_conv_forward(const void* x, const void* sx, const void* sy,
                                const void* mask, const void* weight,
                                void* out, int B, int H, int W, int C, int Q,
                                int CO, void* stream) {
  if ((long long)B * Q == 0) return (int)cudaGetLastError();
  // 16-byte loads of x and weight rows; int corner offsets into one image
  if (C % 8 != 0 || CO % 128 != 0 ||
      (reinterpret_cast<size_t>(x) & 15) != 0 ||
      (reinterpret_cast<size_t>(weight) & 15) != 0 ||
      (long long)H * W * C >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long tiles128 = (long long)B * ((Q + 127) / 128);
  const int sms = sm_count();
  if (CO % 256 == 0 && tiles128 * (CO / 256) >= sms)
    return (int)launch<2, 256>(x, sx, sy, mask, weight, out, B, H, W, C, Q,
                               CO, st);
  if (tiles128 * (CO / 128) >= sms)
    return (int)launch<2, 128>(x, sx, sy, mask, weight, out, B, H, W, C, Q,
                               CO, st);
  return (int)launch<1, 128>(x, sx, sy, mask, weight, out, B, H, W, C, Q, CO,
                             st);
}
