// bf16 stride-1, same-padding, odd-k 2-D convolution on Hopper's tensor
// cores (sm_90a): the bf16 instantiations of the implicit-GEMM conv of
// same_conv_tc.cuh, which holds the design and replaces the TPU kernel
// consistent_depth_tpu/ops/s2d_conv.py (_s2d_conv_kernel) in both
// directions.
//
// What is bf16's own:
//   - mma.sync.m16n8k16 bf16 x bf16 -> f32. Products of bf16 are exact in
//     f32 and the sums stay in f32, so the result is an f32 conv's of the
//     same bf16 inputs up to summation order;
//   - a step is 16 reduction channels; the forward's B fragments come from
//     its [tap][o][16 i] weight stage by ldmatrix, the grad-input's from
//     its [tap][16 o][i] stage by ldmatrix.trans, which transposes 16-bit
//     elements;
//   - epilogue: the sum is rounded to bf16 once, staged in shared memory
//     and stored in 16-byte units of 8 channels where Co is a multiple of
//     8; the split-K reduction rounds likewise.

#include "same_conv_tc.cuh"

namespace {

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
struct Elem<bf16> {
  static constexpr int DTYPE = 1;
  static constexpr int MAX_COB = 64;
  static constexpr int STAGE = 32 * 2;  // 32 pixels of a warp, 2 bytes
  static constexpr bool SPLIT = false;

  static __device__ __forceinline__ float to_f32(bf16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ bf16 from_f32(float v) {
    return __float2bfloat16(v);
  }
  static __device__ __forceinline__ uint32_t bits(bf16 v) {
    return __bfloat16_as_ushort(v);
  }

  // ldmatrix.trans reads eight consecutive rows at one unit
  template <int UPR>
  static __device__ __forceinline__ int b_swz(int row, int u) {
    return swz<UPR>(row, u);
  }

  template <int COB, bool GRAD>
  static __device__ __forceinline__ void tap(float (&acc)[2][COB / 8][4],
                                             const uint32_t (&a_addr)[2],
                                             uint32_t, uint32_t wb, uint32_t,
                                             int c, int lane) {
    constexpr int UPR = COB / 8;
    uint32_t a[2][4];
    ldsm4(a[0], a_addr[0]);
    ldsm4(a[1], a_addr[1]);
    const int b_n = (lane & 7) + ((lane >> 4) << 3);        // forward: o row
    const int b_unit = (lane >> 3) & 1;                     // forward: k half
    const int b_k = (lane & 7) + (((lane >> 3) & 1) << 3);  // grad: k row
    const int b_nu = lane >> 4;                             // grad: o unit
#pragma unroll
    for (int j = 0; j < COB / 16; ++j) {
      uint32_t b[4];
      if (!GRAD) {
        const int row = c * COB + j * 16 + b_n;
        ldsm4(b, wb + (row * 2 + swz<2>(row, b_unit)) * 16);
      } else {
        const int row = c * 16 + b_k;
        ldsm4_t(b, wb + (row * UPR + swz<UPR>(row, j * 2 + b_nu)) * 16);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma16816(acc[m][2 * j], a[m], b[0], b[1]);
        mma16816(acc[m][2 * j + 1], a[m], b[2], b[3]);
      }
    }
  }

  // stage the warp's 32 pixels x COB channels (rows oy, oy + 1), then
  // 16-byte stores
  template <int COB>
  static __device__ __forceinline__ void store(
      const Params<bf16>& p, const float (&acc)[2][COB / 8][4],
      const float (&bias)[COB / 8][2], int n, int oy, int ox0, int o0,
      int warp, int lane, unsigned char* smem) {
    const int g = lane >> 2;
    const int t = lane & 3;
    bf16* stg = reinterpret_cast<bf16*>(smem) + warp * 32 * COB;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < COB / 8; ++j) {
          const int px = m * 16 + g + h * 8;
          *reinterpret_cast<__nv_bfloat162*>(stg + px * COB + j * 8 + 2 * t) =
              __floats2bfloat162_rn(acc[m][j][2 * h] + bias[j][0],
                                    acc[m][j][2 * h + 1] + bias[j][1]);
        }
    __syncwarp();
    constexpr int UPX = COB / 8;
    for (int i = lane; i < 32 * UPX; i += 32) {
      const int px = i / UPX;
      const int u = i - px * UPX;
      const int y = oy + (px >> 4);
      const int x = ox0 + (px & 15);
      const int o = o0 + u * 8;
      if (y < p.H && x < p.W && o < p.Cn)
        *reinterpret_cast<uint4*>(p.out + out_offset(p, n, y, x) + o) =
            *reinterpret_cast<const uint4*>(stg + px * COB + u * 8);
    }
  }
};

}  // namespace

extern "C" {

// x: (N, H, W, Ci) bf16 with element strides xs_{n,h,w,c} (xs_c == 1);
// w: (K, K, Ci, Co) bf16 with element strides ws_{r,c,i,o} (ws_i == 1);
// strides multiples of 8 and bases 16-byte aligned unless Ci is narrow;
// bias: (Co,) contiguous or NULL; out: (N, H, W, Co) contiguous. tile_h:
// output rows per block (4, 8 or 16); split: blocks per output tile over
// the reduction, with workspace (split, N, H, W, Co) f32 when split > 1.
// dtype must be 1 (bfloat16). Returns a cudaError_t value; 0 means launched.
int same_conv_tc_forward(const void* x, const void* w, const void* bias,
                         void* out, int dtype, int N, int H, int W, int Ci,
                         int Co, int K, int64_t xs_n, int64_t xs_h,
                         int64_t xs_w, int64_t xs_c, int64_t ws_r,
                         int64_t ws_c, int64_t ws_i, int64_t ws_o,
                         int tile_h, int split, void* workspace,
                         void* stream) {
  return forward_entry<bf16>(x, w, bias, out, dtype, N, H, W, Ci, Co, K,
                             xs_n, xs_h, xs_w, xs_c, ws_r, ws_c, ws_i, ws_o,
                             tile_h, split, workspace, stream);
}

// Grad-input of same_conv_tc_forward. ct: (N, H, W, Co) bf16 with element
// strides cs_{n,h,w,c} (cs_c == 1; multiples of 8 unless Co is narrow); w:
// the forward's (K, K, Ci, Co) weight with element strides ws_{r,c,i,o}
// (ws_i == 1, the others multiples of 8, Ci a multiple of 8); dx:
// (N, H, W, Ci) contiguous. The flipped, channel-swapped weight is a view
// (no copy). Other arguments as above.
int same_conv_tc_grad_input(const void* ct, const void* w, void* dx,
                            int dtype, int N, int H, int W, int Ci, int Co,
                            int K, int64_t cs_n, int64_t cs_h, int64_t cs_w,
                            int64_t cs_c, int64_t ws_r, int64_t ws_c,
                            int64_t ws_i, int64_t ws_o, int tile_h,
                            int split, void* workspace, void* stream) {
  return grad_input_entry<bf16>(ct, w, dx, dtype, N, H, W, Ci, Co, K, cs_n,
                                cs_h, cs_w, cs_c, ws_r, ws_c, ws_i, ws_o,
                                tile_h, split, workspace, stream);
}

}  // extern "C"
