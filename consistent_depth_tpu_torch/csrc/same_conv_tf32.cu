// f32 stride-1, same-padding, odd-k 2-D convolution on Hopper's tensor
// cores (sm_90a) in 3xTF32: the f32 instantiations of the implicit-GEMM
// conv of same_conv_tc.cuh, which holds the design and replaces the TPU
// kernel consistent_depth_tpu/ops/s2d_conv.py (_s2d_conv_kernel) in both
// directions, in f32, the fine-tune's default precision.
//
// What bounds it on the card: the tensor cores' TF32 rate (495 TFLOP/s
// dense) over three products per product. A single TF32 product keeps 11
// of f32's 24 mantissa bits, about 3e-4 of max |ref| on the hourglass's
// convs (tests/test_torch_s2d_conv.py emulates it on the CPU): outside the
// 1e-4 band of the f32 path. So every operand v is split into
//   big = tf32(v), small = tf32(v - big)   (cvt.rna: nearest, ties away)
// and each product is small*big + big*small + big*big (small*small, below
// 2^-22 of the product, is dropped), about 1e-7 before the f32 sums. This
// is the split CUTLASS calls OpMultiplyAddFastF32.
//
// Accuracy of the sums. Inside one mma.sync the tensor cores add the
// products and the f32 accumulator with truncation, not rounding to
// nearest, so chaining every tap's three MMAs onto one accumulator
// (3 k^2 Ci / 8 MMAs at k=11, Ci=64: 2904) lets a bias toward zero grow to
// 7e-5 of max |ref| on the card. Each tap's three products of an n tile go
// into a zeroed partial instead, which the FP32 pipes add to the
// accumulator, rounding to nearest: 4e-6 at most over the hourglass's
// classes (PERF.md). What remains is each partial's own truncation, under
// one ulp of it.
//
// What is f32's own:
//   - mma.sync.m16n8k8 TF32 x TF32 -> f32. A step is 8 reduction channels,
//     the same 32 bytes per pixel as bf16's 16, so the halo, the weight
//     ring, the swizzle and the ldmatrix reads of A and of the forward's B
//     are bf16's: ldmatrix.x4.b16 hands lane (g, t) word t of row g of each
//     8x8 b16 matrix, which is the TF32 fragment (g, t) (g+8, t) (g, t+4)
//     (g+8, t+4) for A and (k t, n g) (k t+4, n g) for B;
//   - the split runs once in shared memory (SPLIT): when a step's weight
//     slice has landed, and a chunk's halo at its first step, the block
//     rewrites it as big in place and writes small into a second copy,
//     which costs one more halo buffer, one more weight stage and one more
//     barrier per step. Splitting in registers after every fragment load
//     instead repeats the split for every tap and every warp, and measured
//     slower (PERF.md);
//   - the output-channel block stops at 32 (MAX_COB): at 64, both copies'
//     fragments take 255 registers and spill;
//   - the grad-input's weight view has its output channel contiguous, and
//     ldmatrix.trans transposes 16-bit elements only, so its B fragments
//     are 32-bit shared loads from the [tap][8 o][COB i] stage, whose unit
//     swizzle (b_swz) keeps each warp-wide load conflict-free; no repack;
//   - epilogue: no rounding; lanes t and t^1 swap half their pairs with one
//     shuffle so that each stores 4 channels of one pixel with a 16-byte
//     store, straight from registers where Co is a multiple of 4.

#include "same_conv_tc.cuh"

namespace {

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void lds128(uint32_t (&v)[4], uint32_t addr) {
  asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr));
}
__device__ __forceinline__ void sts128(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.u32 [%0], {%1,%2,%3,%4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]));
}

// v = big + small + (what is dropped), big and small TF32 values
__device__ __forceinline__ void split(uint32_t v, uint32_t& big,
                                      uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(__uint_as_float(v)));
  asm("cvt.rna.tf32.f32 %0, %1;\n"
      : "=r"(small)
      : "f"(__uint_as_float(v) - __uint_as_float(big)));
}

__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one n tile of both m tiles, one tap, in 3xTF32: small*big, big*small,
// big*big into zeroed partials, which the FP32 pipes then add to the
// accumulators d0, d1 (see the note on accuracy at the top)
__device__ __forceinline__ void mma3(float (&d0)[4], float (&d1)[4],
                                     const uint32_t (&ab)[2][4],
                                     const uint32_t (&as)[2][4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
  float t0[4] = {0.f, 0.f, 0.f, 0.f};
  float t1[4] = {0.f, 0.f, 0.f, 0.f};
  mma1688(t0, as[0], bb0, bb1);
  mma1688(t1, as[1], bb0, bb1);
  mma1688(t0, ab[0], bs0, bs1);
  mma1688(t1, ab[1], bs0, bs1);
  mma1688(t0, ab[0], bb0, bb1);
  mma1688(t1, ab[1], bb0, bb1);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    d0[q] += t0[q];
    d1[q] += t1[q];
  }
}

template <>
struct Elem<float> {
  // at 64 both copies of the fragments take 255 registers and spill; 32
  // measured faster in total (PERF.md)
  static constexpr int MAX_COB = 32;
  static constexpr int DTYPE = 0;
  static constexpr int STAGE = 0;  // the epilogue stores from registers
  static constexpr bool SPLIT = true;

  // big in place, small into the second copy, 16 bytes per thread and step
  static __device__ __forceinline__ void split_units(uint32_t base,
                                                     uint32_t copy, int units,
                                                     int tid, int nthreads) {
    for (int i = tid; i < units; i += nthreads) {
      uint32_t v[4], big[4], small[4];
      lds128(v, base + i * 16);
#pragma unroll
      for (int q = 0; q < 4; ++q) split(v[q], big[q], small[q]);
      sts128(base + i * 16, big);
      sts128(copy + i * 16, small);
    }
  }

  static __device__ __forceinline__ float to_f32(float v) { return v; }
  static __device__ __forceinline__ float from_f32(float v) { return v; }
  static __device__ __forceinline__ uint32_t bits(float v) {
    return __float_as_uint(v);
  }

  // Lane (g, t) reads word g % 4 of unit 2j + g / 4 in rows t and t + 4:
  // XOR-ing the unit with 2 (row % 4) puts the four rows' two units in
  // eight distinct bank groups; rows of 4 units (COB 16) start alternately
  // at bank 0 and 16 already, and take (row & 2).
  template <int UPR>
  static __device__ __forceinline__ int b_swz(int row, int u) {
    return u ^ (UPR == 4 ? (row & 2) : ((row & 3) << 1));
  }

  // big from the halo and the weight stage, small from their second
  // copies (a + a2, wb + w2)
  template <int COB, bool GRAD>
  static __device__ __forceinline__ void tap(float (&acc)[2][COB / 8][4],
                                             const uint32_t (&a)[2],
                                             uint32_t a2, uint32_t wb,
                                             uint32_t w2, int c, int lane) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      ldsm4(ab[m], a[m]);
      ldsm4(as[m], a[m] + a2);
    }
    if (!GRAD) {
      const int b_n = (lane & 7) + ((lane >> 4) << 3);  // o row
      const int b_unit = (lane >> 3) & 1;               // k half
#pragma unroll
      for (int j = 0; j < COB / 16; ++j) {
        uint32_t bb[4], bs[4];
        const int row = c * COB + j * 16 + b_n;
        const uint32_t addr = wb + (row * 2 + swz<2>(row, b_unit)) * 16;
        ldsm4(bb, addr);
        ldsm4(bs, addr + w2);
        mma3(acc[0][2 * j], acc[1][2 * j], ab, as, bb[0], bb[1], bs[0],
             bs[1]);
        mma3(acc[0][2 * j + 1], acc[1][2 * j + 1], ab, as, bb[2], bb[3],
             bs[2], bs[3]);
      }
    } else {
      constexpr int UPR = COB / 4;
      const int g = lane >> 2;
      const int r0 = c * 8 + (lane & 3);  // k row of b0; b1's is r0 + 4
      const int word = (g & 3) * 4;
#pragma unroll
      for (int j = 0; j < COB / 8; ++j) {
        const int u = j * 2 + (g >> 2);
        const uint32_t addr0 =
            wb + (r0 * UPR + b_swz<UPR>(r0, u)) * 16 + word;
        const uint32_t addr1 =
            wb + ((r0 + 4) * UPR + b_swz<UPR>(r0 + 4, u)) * 16 + word;
        mma3(acc[0][j], acc[1][j], ab, as, lds32(addr0), lds32(addr1),
             lds32(addr0 + w2), lds32(addr1 + w2));
      }
    }
  }

  // lane t holds channels 2t, 2t+1 of pixels g and g+8; after the swap an
  // even lane holds channels 2t..2t+3 of pixel g, an odd lane channels
  // 2t-2..2t+1 of pixel g+8 (rows oy, oy + 1)
  template <int COB>
  static __device__ __forceinline__ void store(
      const Params<float>& p, const float (&acc)[2][COB / 8][4],
      const float (&bias)[COB / 8][2], int n, int oy, int ox0, int o0,
      int /*warp*/, int lane, unsigned char* /*smem*/) {
    const int g = lane >> 2;
    const int t = lane & 3;
    const bool odd = t & 1;
    const int x = ox0 + g + (odd ? 8 : 0);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int y = oy + m;
      const bool in = y < p.H && x < p.W;
#pragma unroll
      for (int j = 0; j < COB / 8; ++j) {
        const float v0 = acc[m][j][0] + bias[j][0];
        const float v1 = acc[m][j][1] + bias[j][1];
        const float v2 = acc[m][j][2] + bias[j][0];
        const float v3 = acc[m][j][3] + bias[j][1];
        const float s0 = __shfl_xor_sync(0xffffffffu, odd ? v0 : v2, 1);
        const float s1 = __shfl_xor_sync(0xffffffffu, odd ? v1 : v3, 1);
        const int o = o0 + j * 8 + 2 * (t & 2);
        if (in && o < p.Cn)
          *reinterpret_cast<float4*>(p.out + out_offset(p, n, y, x) + o) =
              odd ? make_float4(s0, s1, v2, v3) : make_float4(v0, v1, s0, s1);
      }
    }
  }
};

}  // namespace

extern "C" {

// The f32 counterparts of same_conv_tc_forward and same_conv_tc_grad_input
// (same_conv_tc.cu), with f32 tensors, dtype 0 (float32), strides in
// multiples of 4 elements (16 bytes) unless the reduction is narrow, and
// for the grad-input Ci a multiple of 4.
int same_conv_tf32_forward(const void* x, const void* w, const void* bias,
                           void* out, int dtype, int N, int H, int W, int Ci,
                           int Co, int K, int64_t xs_n, int64_t xs_h,
                           int64_t xs_w, int64_t xs_c, int64_t ws_r,
                           int64_t ws_c, int64_t ws_i, int64_t ws_o,
                           int tile_h, int split, void* workspace,
                           void* stream) {
  return forward_entry<float>(x, w, bias, out, dtype, N, H, W, Ci, Co, K,
                              xs_n, xs_h, xs_w, xs_c, ws_r, ws_c, ws_i, ws_o,
                              tile_h, split, workspace, stream);
}

int same_conv_tf32_grad_input(const void* ct, const void* w, void* dx,
                              int dtype, int N, int H, int W, int Ci, int Co,
                              int K, int64_t cs_n, int64_t cs_h,
                              int64_t cs_w, int64_t cs_c, int64_t ws_r,
                              int64_t ws_c, int64_t ws_i, int64_t ws_o,
                              int tile_h, int split, void* workspace,
                              void* stream) {
  return grad_input_entry<float>(ct, w, dx, dtype, N, H, W, Ci, Co, K, cs_n,
                                 cs_h, cs_w, cs_c, ws_r, ws_c, ws_i, ws_o,
                                 tile_h, split, workspace, stream);
}

// The message of a cudaError_t value that any entry of the library returned.
const char* same_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
