// bf16 stride-1, same-padding, odd-k 2-D convolution on Hopper's tensor
// cores (sm_90a): an implicit GEMM with mma.sync, ldmatrix and cp.async.
//
// Replaces the TPU kernel consistent_depth_tpu/ops/s2d_conv.py
// (_s2d_conv_kernel, launched by _s2d_conv_pallas_jit) for bf16 tensors,
// in both directions the port runs it: the forward, and the grad-input of
// the TPU package's custom VJP (consistent_depth_tpu/models/layers.py,
// _conv_pallas_bwd), which is the same conv of the cotangent with the
// flipped, channel-swapped weight. The f32 parity mode stays on the FMA
// template in same_conv.cu, as does a grad-input into a number of channels
// that is not a multiple of 8 (the stem's, which training never needs).
//
//   out[n,y,x,o] = bias[o] + sum_{r,c,i} x[n,y+r-p,x+c-p,i] w[r,c,i,o]
//
// as a GEMM: M = output pixels, N = output channels, K = k*k taps times the
// reduction channels, walked tap by tap. The space-to-depth relayout of the
// TPU kernel exists for the MXU's 128 lanes and is not carried over.
//
// What bounds it on the card: operations. The hourglass's 68 convs of one
// batch-8 forward at 224x384 do 742 GFLOP against 1.24 GB of bytes: 0.75 ms
// at the bf16 tensor-core peak (989 TFLOP/s) against 0.37 ms at 3.35 TB/s;
// the 67 grad-inputs of a train step do 716 GFLOP (0.72 ms). What the
// design does about each limit of the FMA template (same_conv.cu):
//   - tensor cores: mma.sync.m16n8k16 bf16 x bf16 -> f32. Products of bf16
//     are exact in f32 and the sums stay in f32, so the result is the FMA
//     template's up to summation order. A shifted tap window is a set of
//     row addresses into one halo tile, so ldmatrix reads the A fragments
//     straight from it: no im2col copy;
//   - shared memory: dynamic, above 48 KB (up to 108 KB at k=11 with a
//     64-channel output block). A step is one tap row of 16 reduction
//     channels: the halo tile (th+k-1) x (16+k-1) of the 16 channels,
//     staged at the chunk's first step and read by its k steps, and the
//     weight slice of the tap row. A Co block of 64 at k=11 would need
//     248 KB for all taps' weights; a tap row needs 22.5 KB;
//   - copies overlap compute: every load is a 16-byte cp.async into a ring
//     of three weight stages (two steps in flight) and two halo buffers;
//     out-of-image pixels and channels past the end are zero-filled by a
//     source size of 0. Index math runs per 16-byte unit, with divisions
//     by compile-time constants only;
//   - narrow reductions (the stem's 3 input channels, the merged heads'
//     2-channel cotangent) cannot be cut into 16-byte units: their chunk
//     is loaded by element and zero-padded to 16 channels in shared
//     memory, so the tensor cores do 16/3 and 16/2 times the work there;
//   - bank conflicts: every shared-memory row is a whole number of 16-byte
//     units, and the unit index is XOR-swizzled by the row, so the eight
//     row addresses of each ldmatrix land in eight distinct bank groups;
//   - weights through their strides: the forward's weight is an HWIO view
//     of an OIHW channels_last tensor (its reduction channel i contiguous),
//     staged [tap][o][16 i] and read by ldmatrix; the grad-input reads the
//     flipped, channel-swapped view (its output channel i contiguous),
//     staged [tap][16 o][i] and read by ldmatrix.trans. No repack;
//   - filling the card: the wrapper's plan (ops/s2d_conv.py::_plan) picks
//     a tile of 4, 8 or 16 output rows by 16 columns per block, and where
//     even the smallest tile leaves fewer than 2x132 blocks it splits the
//     reduction steps over blocks into an f32 workspace; a second kernel
//     adds the partial sums in a fixed order (no atomics: runs repeat bit
//     for bit), adds the bias and rounds;
//   - epilogue: the bias is added in f32, the sum rounded to bf16 once and
//     staged in shared memory, then stored NHWC in 16-byte stores where Co
//     is a multiple of 8; ragged rows, columns and channels are masked.
//
// Instantiations: k (3, 5, 7, 11) x Co block (16, 32, 64) x direction;
// the tile height, the split and every size are run-time values.
//
// The kernels allocate nothing, launch on the caller's stream and do not
// synchronise. The C entries return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 16;       // output columns per tile: one m16 fragment
constexpr int CH = 16;       // reduction channels per step: one k16 slice
constexpr int WSTAGES = 3;   // weight ring: two steps in flight

typedef __nv_bfloat16 bf16;

struct Params {
  const bf16* x;     // (N, H, W, Cr): channel stride 1
  const bf16* w;     // element (tap row 0, tap col 0, red 0, out 0)
  const bf16* bias;  // (Cn,) or null
  bf16* out;         // (N, H, W, Cn) contiguous
  float* ws;         // (split, N, H, W, Cn) f32 when split > 1
  int N, H, W, Cr, Cn, th, tiles_w, split, steps;
  int64_t xs_n, xs_h, xs_w;
  int64_t w_r, w_c, w_red, w_out;
};

template <int K, int COB, bool GRAD>
struct Cfg {
  static_assert(K >= 3, "a chunk's halo buffer is refilled two steps ahead, "
                        "after the chunk before it has run its k steps");
  static constexpr int P = (K - 1) / 2;
  static constexpr int HALO_W = TW + K - 1;
  // 16-byte units per shared-memory row of the weight slice: the forward
  // stages rows of 16 reduction channels, the grad-input rows of COB
  // output channels
  static constexpr int B_UPR = GRAD ? COB / 8 : 2;
  static constexpr int W_UNITS = K * (GRAD ? CH * B_UPR : COB * 2);
  static constexpr int W_BYTES = W_UNITS * 16;
};

// the 16-byte unit u of row `row` in a region of `upr` units per row: the
// eight rows of one ldmatrix then fall into eight distinct bank groups
template <int UPR>
__device__ __forceinline__ int swz(int row, int u) {
  constexpr int SHIFT = UPR == 2 ? 2 : UPR == 4 ? 1 : 0;
  return u ^ ((row >> SHIFT) & (UPR - 1));
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a 16-byte unit of 8 channels of a narrow reduction (fewer than 8
// channels, or a count that is not a multiple of 8, so that rows are not
// 16-byte aligned): the first n channels by element loads, zeros after
__device__ __forceinline__ void ld_narrow(uint32_t dst, const bf16* src,
                                          int n, int64_t stride) {
  uint32_t v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t lo =
        2 * q < n ? __bfloat16_as_ushort(src[2 * q * stride]) : 0u;
    const uint32_t hi =
        2 * q + 1 < n ? __bfloat16_as_ushort(src[(2 * q + 1) * stride]) : 0u;
    v[q] = lo | (hi << 16);
  }
  asm volatile("st.shared.v4.u32 [%0], {%1,%2,%3,%4};\n" ::"r"(dst),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
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

// element offset of output pixel (n, y, x) in an (N, H, W, Cn) tensor
__device__ __forceinline__ int64_t out_offset(const Params& p, int n, int y,
                                              int x) {
  return ((static_cast<int64_t>(n) * p.H + y) * p.W + x) * p.Cn;
}

template <int K, int COB, bool GRAD>
__global__ void __launch_bounds__(256)
conv_tc_kernel(const Params p) {
  using C = Cfg<K, COB, GRAD>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int th = p.th;
  const int halo_units = (th + K - 1) * C::HALO_W * 2;
  const uint32_t s_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t s_w = s_base + 2 * halo_units * 16;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int oy0 = (blockIdx.x / p.tiles_w) * th;
  const int ox0 = (blockIdx.x % p.tiles_w) * TW;
  const int o0 = blockIdx.y * COB;
  const int n = blockIdx.z / p.split;
  const int sp = blockIdx.z % p.split;
  // this block's reduction steps: the sp-th of split near-equal ranges
  const int s_begin =
      static_cast<int>(static_cast<int64_t>(sp) * p.steps / p.split);
  const int s_end =
      static_cast<int>(static_cast<int64_t>(sp + 1) * p.steps / p.split);
  const bf16* xn = p.x + n * p.xs_n;
  // the stem's 3 input channels, the merged heads' 2-channel cotangent
  const bool narrow = (p.Cr & 7) != 0;

  // -- loads of one step: the chunk's halo at its first step (or the
  // split's), and the weight slice of the step's tap row
  auto load_step = [&](int s, int slot) {
    const int chunk = s / K;
    const int r = s - chunk * K;
    const int ci0 = chunk * CH;
    if (s == s_begin || r == 0) {
      const uint32_t hb = s_base + (chunk & 1) * halo_units * 16;
      for (int i = tid; i < halo_units; i += nthreads) {
        const int u = i & 1;
        const int pix = i >> 1;
        const int hr = pix / C::HALO_W;
        const int hc = pix - hr * C::HALO_W;
        const int gy = oy0 - C::P + hr;
        const int gx = ox0 - C::P + hc;
        const int ci = ci0 + u * 8;
        const bool ok =
            gy >= 0 && gy < p.H && gx >= 0 && gx < p.W && ci < p.Cr;
        const bf16* src = ok ? xn + gy * p.xs_h + gx * p.xs_w + ci : p.x;
        const uint32_t dst = hb + (pix * 2 + swz<2>(pix, u)) * 16;
        if (narrow)
          ld_narrow(dst, src, ok ? min(8, p.Cr - ci) : 0, 1);
        else
          cp16(dst, src, ok);
      }
    }
    const uint32_t wb = s_w + slot * C::W_BYTES;
    for (int i = tid; i < C::W_UNITS; i += nthreads) {
      int c, red, out, dst;
      if (!GRAD) {
        // [tap][o][16 reduction channels]: two units per row
        const int u = i & 1;
        const int o = (i >> 1) & (COB - 1);
        c = (i >> 1) / COB;
        red = ci0 + u * 8;
        out = o0 + o;
        const int row = c * COB + o;
        dst = row * 2 + swz<2>(row, u);
      } else {
        // [tap][16 reduction channels][COB output channels]
        const int u = i & (C::B_UPR - 1);
        const int kr = (i / C::B_UPR) & (CH - 1);
        c = i / (C::B_UPR * CH);
        red = ci0 + kr;
        out = o0 + u * 8;
        const int row = c * CH + kr;
        dst = row * C::B_UPR + swz<C::B_UPR>(row, u);
      }
      const bool ok = red < p.Cr && out < p.Cn;
      const bf16* src =
          ok ? p.w + r * p.w_r + c * p.w_c + red * p.w_red + out * p.w_out
             : p.w;
      // the forward's units run along the reduction channels
      if (!GRAD && narrow)
        ld_narrow(wb + dst * 16, src, ok ? min(8, p.Cr - red) : 0, p.w_red);
      else
        cp16(wb + dst * 16, src, ok);
    }
  };

  float acc[2][COB / 8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < COB / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;

  // per-lane parts of the ldmatrix row addresses
  const int a_col = (lane & 7) + ((lane >> 3) & 1) * 8;  // pixel in m16
  const int a_unit = lane >> 4;                           // k half
  const int b_n = (lane & 7) + ((lane >> 4) << 3);        // forward: o row
  const int b_unit = (lane >> 3) & 1;                     // forward: k half
  const int b_k = (lane & 7) + (((lane >> 3) & 1) << 3);  // grad: k row
  const int b_nu = lane >> 4;                             // grad: o unit

  for (int i = 0; i < WSTAGES - 1; ++i) {
    if (s_begin + i < s_end) load_step(s_begin + i, i);
    cp_commit();
  }
  for (int s = s_begin; s < s_end; ++s) {
    cp_wait<WSTAGES - 2>();
    __syncthreads();  // step s has landed; step s-1's buffers are free
    const int nxt = s + WSTAGES - 1;
    if (nxt < s_end) load_step(nxt, (nxt - s_begin) % WSTAGES);
    cp_commit();

    const int chunk = s / K;
    const int r = s - chunk * K;
    const uint32_t hb = s_base + (chunk & 1) * halo_units * 16;
    const uint32_t wb = s_w + ((s - s_begin) % WSTAGES) * C::W_BYTES;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int pix = (warp * 2 + m + r) * C::HALO_W + a_col + c;
        ldsm4(a[m], hb + (pix * 2 + swz<2>(pix, a_unit)) * 16);
      }
#pragma unroll
      for (int j = 0; j < COB / 16; ++j) {
        uint32_t b[4];
        if (!GRAD) {
          const int row = c * COB + j * 16 + b_n;
          ldsm4(b, wb + (row * 2 + swz<2>(row, b_unit)) * 16);
        } else {
          const int row = c * CH + b_k;
          ldsm4_t(b, wb + (row * C::B_UPR +
                           swz<C::B_UPR>(row, j * 2 + b_nu)) * 16);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma16816(acc[m][2 * j], a[m], b[0], b[1]);
          mma16816(acc[m][2 * j + 1], a[m], b[2], b[3]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // every warp is done with the ring: reuse it to stage

  // -- epilogue. Fragment (m, j, q): pixel column m16 row g (+8 for q >= 2)
  // of output row 2*warp + m, output channel 8j + 2t (+1 for odd q)
  const int g = lane >> 2;
  const int t = lane & 3;
  if (p.split > 1) {
    float* wsp = p.ws + static_cast<int64_t>(sp) * p.N * p.H * p.W * p.Cn;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int oy = oy0 + warp * 2 + m;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = ox0 + g + h * 8;
        if (oy >= p.H || ox >= p.W) continue;
        float* dst = wsp + out_offset(p, n, oy, ox);
#pragma unroll
        for (int j = 0; j < COB / 8; ++j) {
          const int o = o0 + j * 8 + 2 * t;
          if (o < p.Cn) dst[o] = acc[m][j][2 * h];
          if (o + 1 < p.Cn) dst[o + 1] = acc[m][j][2 * h + 1];
        }
      }
    }
    return;
  }
  float bias[COB / 8][2];
#pragma unroll
  for (int j = 0; j < COB / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = o0 + j * 8 + 2 * t + e;
      bias[j][e] = (p.bias != nullptr && o < p.Cn)
                       ? __bfloat162float(p.bias[o])
                       : 0.f;
    }
  if ((p.Cn & 7) != 0) {
    // narrow or ragged Co (the merged heads' 2): element stores
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int oy = oy0 + warp * 2 + m;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = ox0 + g + h * 8;
        if (oy >= p.H || ox >= p.W) continue;
        bf16* dst = p.out + out_offset(p, n, oy, ox);
#pragma unroll
        for (int j = 0; j < COB / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = o0 + j * 8 + 2 * t + e;
            if (o < p.Cn)
              dst[o] = __float2bfloat16(acc[m][j][2 * h + e] + bias[j][e]);
          }
      }
    }
    return;
  }
  // stage the warp's 32 pixels x COB channels, then 16-byte stores
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
    const int oy = oy0 + warp * 2 + (px >> 4);
    const int ox = ox0 + (px & 15);
    const int o = o0 + u * 8;
    if (oy < p.H && ox < p.W && o < p.Cn)
      *reinterpret_cast<uint4*>(p.out + out_offset(p, n, oy, ox) + o) =
          *reinterpret_cast<const uint4*>(stg + px * COB + u * 8);
  }
}

// out = bf16(sum over the splits in order + bias), one element per thread
__global__ void split_reduce_kernel(const float* __restrict__ ws,
                                    const bf16* __restrict__ bias,
                                    bf16* __restrict__ out, int64_t count,
                                    int Cn, int split) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < count; i += stride) {
    float v = 0.f;
    for (int s = 0; s < split; ++s) v += ws[s * count + i];
    if (bias != nullptr) v += __bfloat162float(bias[i % Cn]);
    out[i] = __float2bfloat16(v);
  }
}

template <int K, int COB, bool GRAD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<K, COB, GRAD>;
  const int nwarps = p.th / 2;
  const int halo_bytes = (p.th + K - 1) * C::HALO_W * 2 * 16;
  int smem = 2 * halo_bytes + WSTAGES * C::W_BYTES;
  const int stage = nwarps * 32 * COB * 2;
  if (stage > smem) smem = stage;
  static int attr_set = 0;  // the largest size granted so far
  if (smem > 48 * 1024 && smem > attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_tc_kernel<K, COB, GRAD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = smem;
  }
  const int tiles_h = (p.H + p.th - 1) / p.th;
  const dim3 grid(tiles_h * p.tiles_w, (p.Cn + COB - 1) / COB, p.N * p.split);
  conv_tc_kernel<K, COB, GRAD><<<grid, nwarps * 32, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.split == 1) return e;
  const int64_t count = static_cast<int64_t>(p.N) * p.H * p.W * p.Cn;
  const int blocks =
      static_cast<int>((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  split_reduce_kernel<<<blocks, 256, 0, stream>>>(p.ws, p.bias, p.out, count,
                                                  p.Cn, p.split);
  return cudaGetLastError();
}

template <int COB, bool GRAD>
cudaError_t launch_k(int K, const Params& p, cudaStream_t s) {
  switch (K) {
    case 3: return launch<3, COB, GRAD>(p, s);
    case 5: return launch<5, COB, GRAD>(p, s);
    case 7: return launch<7, COB, GRAD>(p, s);
    case 11: return launch<11, COB, GRAD>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool GRAD>
cudaError_t launch_cob(int K, const Params& p, cudaStream_t s) {
  if (p.Cn <= 16) return launch_k<16, GRAD>(K, p, s);
  if (p.Cn <= 32) return launch_k<32, GRAD>(K, p, s);
  return launch_k<64, GRAD>(K, p, s);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// what the loads need: the activations' channels and the weight's input
// channels contiguous (ws_i == 1); for the 16-byte copies of a reduction
// of a multiple of 8 channels, every other stride a multiple of 8
// elements and 16-byte aligned bases (a narrow reduction is loaded by
// element, except the grad-input's weight, whose units run along the
// output channels, which must be a multiple of 8); a tile of 4, 8 or 16
// rows; the split within the steps
bool valid(const Params& p, int K, int64_t xs_c, int64_t ws_i, bool grad) {
  const int steps = (p.Cr + CH - 1) / CH * K;
  const bool tile_ok = p.th == 4 || p.th == 8 || p.th == 16;
  const bool wide = p.Cr % 8 == 0;
  const bool x_ok = !wide || (p.xs_n % 8 == 0 && p.xs_h % 8 == 0 &&
                              p.xs_w % 8 == 0 && aligned16(p.x));
  const bool w_ok = (!wide && !grad) ||
                    (p.w_r % 8 == 0 && p.w_c % 8 == 0 &&
                     (grad ? p.w_red : p.w_out) % 8 == 0 && aligned16(p.w) &&
                     (!grad || p.Cn % 8 == 0));
  return p.N > 0 && p.H > 0 && p.W > 0 && p.Cr > 0 && p.Cn > 0 &&
         xs_c == 1 && ws_i == 1 && x_ok && w_ok && tile_ok && p.split >= 1 &&
         p.split <= steps && static_cast<int64_t>(p.N) * p.split <= 65535 &&
         p.steps == steps && (p.split == 1 || p.ws != nullptr) &&
         aligned16(p.out);
}

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
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const bf16*>(bias);
  p.out = static_cast<bf16*>(out);
  p.ws = static_cast<float*>(workspace);
  p.N = N; p.H = H; p.W = W; p.Cr = Ci; p.Cn = Co;
  p.th = tile_h;
  p.tiles_w = (W + TW - 1) / TW;
  p.split = split;
  p.steps = (Ci + CH - 1) / CH * K;
  p.xs_n = xs_n; p.xs_h = xs_h; p.xs_w = xs_w;
  p.w_r = ws_r; p.w_c = ws_c; p.w_red = ws_i; p.w_out = ws_o;
  if (dtype != 1 || !valid(p, K, xs_c, ws_i, false))
    return cudaErrorInvalidValue;
  return launch_cob<false>(K, p, static_cast<cudaStream_t>(stream));
}

// Grad-input of same_conv_tc_forward. ct: (N, H, W, Co) bf16 with element
// strides cs_{n,h,w,c} (cs_c == 1; multiples of 8 unless Co is narrow); w:
// the forward's (K, K, Ci, Co) weight with element strides ws_{r,c,i,o}
// (ws_i == 1, the others multiples of 8, Ci a multiple of 8); dx:
// (N, H, W, Ci) contiguous. The flipped, channel-swapped weight is a view:
// tap (r, c) reads w[K-1-r, K-1-c], reduction channel o reads w[..., o],
// output channel i reads w[..., i, :]. Other arguments as above.
int same_conv_tc_grad_input(const void* ct, const void* w, void* dx,
                            int dtype, int N, int H, int W, int Ci, int Co,
                            int K, int64_t cs_n, int64_t cs_h, int64_t cs_w,
                            int64_t cs_c, int64_t ws_r, int64_t ws_c,
                            int64_t ws_i, int64_t ws_o, int tile_h,
                            int split, void* workspace, void* stream) {
  Params p;
  p.x = static_cast<const bf16*>(ct);
  p.w = static_cast<const bf16*>(w) + (K - 1) * ws_r + (K - 1) * ws_c;
  p.bias = nullptr;
  p.out = static_cast<bf16*>(dx);
  p.ws = static_cast<float*>(workspace);
  p.N = N; p.H = H; p.W = W; p.Cr = Co; p.Cn = Ci;
  p.th = tile_h;
  p.tiles_w = (W + TW - 1) / TW;
  p.split = split;
  p.steps = (Co + CH - 1) / CH * K;
  p.xs_n = cs_n; p.xs_h = cs_h; p.xs_w = cs_w;
  p.w_r = -ws_r; p.w_c = -ws_c; p.w_red = ws_o; p.w_out = ws_i;
  if (dtype != 1 || K <= 0 || !valid(p, K, cs_c, ws_i, true))
    return cudaErrorInvalidValue;
  return launch_cob<true>(K, p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
