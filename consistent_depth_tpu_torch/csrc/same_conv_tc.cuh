// Stride-1, same-padding, odd-k 2-D convolution on Hopper's tensor cores
// (sm_90a): an implicit GEMM with mma.sync, ldmatrix and cp.async. The
// machinery shared by the two element types, each instantiated by its own
// source (one nvcc process each):
//   - same_conv_tc.cu: bf16, one mma.sync.m16n8k16 per product;
//   - same_conv_tf32.cu: f32, three mma.sync.m16n8k8 TF32 products per
//     product (3xTF32), which keeps f32's accuracy.
//
// Replaces the TPU kernel consistent_depth_tpu/ops/s2d_conv.py
// (_s2d_conv_kernel, launched by _s2d_conv_pallas_jit), in both directions
// the port runs it: the forward, and the grad-input of the TPU package's
// custom VJP (consistent_depth_tpu/models/layers.py, _conv_pallas_bwd),
// which is the same conv of the cotangent with the flipped,
// channel-swapped weight. A grad-input into a number of channels that is
// not a whole number of 16-byte units (the stem's 3, which training never
// needs) goes to the plain version (ops/s2d_conv.py) instead.
//
//   out[n,y,x,o] = bias[o] + sum_{r,c,i} x[n,y+r-p,x+c-p,i] w[r,c,i,o]
//
// as a GEMM: M = output pixels, N = output channels, K = k*k taps times the
// reduction channels, walked tap by tap. The space-to-depth relayout of the
// TPU kernel exists for the MXU's 128 lanes and is not carried over.
//
// What bounds it on the card: operations. The hourglass's 68 convs of one
// batch-8 forward at 224x384 do 742 GFLOP against 1.24 GB of bf16 bytes
// (2.48 GB in f32); the 67 grad-inputs of a train step do 716 GFLOP. What
// the design does about each limit:
//   - tensor cores, fed straight from shared memory: a shifted tap window is
//     a set of row addresses into one halo tile, so ldmatrix reads the A
//     fragments from it with no im2col copy. A step is 32 bytes of each
//     pixel's reduction channels (16 bf16 or 8 f32): two 16-byte units per
//     pixel, which is the same ldmatrix read for both types;
//   - shared memory: dynamic, above 48 KB (up to 108 KB at k=11 with a
//     64-channel output block in bf16, 110 KB with f32's second copies at
//     a 32-channel block). A step is one tap row of those channels: the
//     halo tile (th+k-1) x (16+k-1), staged at the chunk's first step and
//     read by its k steps, and the weight slice of the tap row. A Co block
//     of 64 at k=11 would need 248 KB for all taps' weights; a tap row
//     needs 22.5 KB;
//   - copies overlap compute: every load is a 16-byte cp.async into a ring
//     of three weight stages (two steps in flight) and two halo buffers;
//     out-of-image pixels and channels past the end are zero-filled by a
//     source size of 0. Index math runs per 16-byte unit, with divisions
//     by compile-time constants only;
//   - narrow reductions (the stem's 3 input channels, the merged heads'
//     2-channel cotangent) cannot be cut into 16-byte units: their chunk
//     is loaded by element and zero-padded in shared memory, so the tensor
//     cores do more work there (16/3 and 16/2 times in bf16, 8/3 and 8/2 in
//     f32);
//   - bank conflicts: every shared-memory row is a whole number of 16-byte
//     units, and the unit index is XOR-swizzled by the row, so the eight
//     row addresses of each ldmatrix land in eight distinct bank groups;
//   - weights through their strides: the forward's weight is an HWIO view
//     of an OIHW channels_last tensor (its reduction channel i contiguous),
//     staged [tap][o][step's i] and read by ldmatrix; the grad-input reads
//     the flipped, channel-swapped view (its output channel i contiguous),
//     staged [tap][step's o][i] and read as each element type says. No
//     repack;
//   - filling the card: the wrapper's plan (ops/s2d_conv.py::_plan) picks
//     a tile of 4, 8 or 16 output rows by 16 columns per block, and where
//     even the smallest tile leaves fewer than 2x132 blocks it splits the
//     reduction steps over blocks into an f32 workspace; a second kernel
//     adds the partial sums in a fixed order (no atomics: runs repeat bit
//     for bit), adds the bias and stores;
//   - epilogue: the bias is added in f32 and the sum stored NHWC in
//     16-byte stores where Co is a whole number of 16-byte units; ragged
//     rows, columns and channels are masked.
//
// Instantiations per element type: k (3, 5, 7, 11) x Co block (16, 32, and
// 64 where the type allows it) x direction; the tile height, the split and
// every size are run-time values. The kernels allocate nothing, launch on the caller's stream and
// do not synchronise. The C entries return cudaGetLastError() after the
// launch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 16;       // output columns per tile: one m16 fragment
constexpr int WSTAGES = 3;   // weight ring: two steps in flight

typedef __nv_bfloat16 bf16;

// The element type's part of the kernel, defined by the source of each
// type before its C entries instantiate the kernel:
//   DTYPE         the dtype code of the C entries (0 f32, 1 bf16);
//   MAX_COB       the largest output-channel block (32 or 64);
//   STAGE         shared-memory bytes per output channel of one warp that
//                 the epilogue stages (0: none);
//   SPLIT         whether a step first rewrites its landed halo and weight
//                 slice in place and writes a second copy of each, in one
//                 more halo buffer and one more weight stage
//                 (split_units(base, copy, units, tid, nthreads));
//   to_f32, from_f32, bits (an element's bits in the low bits of a word);
//   b_swz<UPR>    the swizzle of the grad-input's weight rows of UPR units;
//   tap<COB, GRAD>(acc, a, a2, wb, w2, c, lane)
//                 tap c of a step: the A fragments at the ldmatrix row
//                 addresses a[2] (and a + a2 in the second copy), the B
//                 fragments from the weight stage at wb (and wb + w2),
//                 multiplied into acc;
//   store<COB>(...)
//                 the epilogue's stores where Co is a whole number of
//                 16-byte units.
template <typename T>
struct Elem;

// elements per 16-byte unit, and reduction channels per step: the two
// units (32 bytes) of one pixel
template <typename T>
struct Unit {
  static constexpr int E = 16 / sizeof(T);
  static constexpr int CH = 2 * E;
};

template <typename T>
struct Params {
  const T* x;     // (N, H, W, Cr): channel stride 1
  const T* w;     // element (tap row 0, tap col 0, red 0, out 0)
  const T* bias;  // (Cn,) or null
  T* out;         // (N, H, W, Cn) contiguous
  float* ws;      // (split, N, H, W, Cn) f32 when split > 1
  int N, H, W, Cr, Cn, th, tiles_w, split, steps;
  int64_t xs_n, xs_h, xs_w;
  int64_t w_r, w_c, w_red, w_out;
};

template <typename T, int K, int COB, bool GRAD>
struct Cfg {
  static_assert(K >= 3, "a chunk's halo buffer is refilled two steps ahead, "
                        "after the chunk before it has run its k steps");
  static constexpr int P = (K - 1) / 2;
  static constexpr int HALO_W = TW + K - 1;
  static constexpr int E = Unit<T>::E;
  static constexpr int CH = Unit<T>::CH;
  // 16-byte units per shared-memory row of the weight slice: the forward
  // stages rows of CH reduction channels, the grad-input rows of COB
  // output channels
  static constexpr int B_UPR = GRAD ? COB / E : 2;
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

// a 16-byte unit of a narrow reduction (fewer channels than a unit holds,
// or a count that is not a whole number of units, so that rows are not
// 16-byte aligned): the first n channels by element loads, zeros after
template <typename T>
__device__ __forceinline__ void ld_narrow(uint32_t dst, const T* src, int n,
                                          int64_t stride) {
  constexpr int PER_WORD = 4 / sizeof(T);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < Unit<T>::E; ++e)
    if (e < n)
      v[e / PER_WORD] |= Elem<T>::bits(src[e * stride])
                         << (32 / PER_WORD * (e % PER_WORD));
  asm volatile("st.shared.v4.u32 [%0], {%1,%2,%3,%4};\n" ::"r"(dst),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// element offset of output pixel (n, y, x) in an (N, H, W, Cn) tensor
template <typename T>
__device__ __forceinline__ int64_t out_offset(const Params<T>& p, int n,
                                              int y, int x) {
  return ((static_cast<int64_t>(n) * p.H + y) * p.W + x) * p.Cn;
}

template <typename T, int K, int COB, bool GRAD>
__global__ void __launch_bounds__(256)
conv_tc_kernel(const Params<T> p) {
  using C = Cfg<T, K, COB, GRAD>;
  using Ty = Elem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int th = p.th;
  const int halo_units = (th + K - 1) * C::HALO_W * 2;
  // two halo buffers, the weight ring, and where the element type splits
  // its operands, the second copies of a halo and of a weight stage
  const uint32_t s_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t s_w = s_base + 2 * halo_units * 16;
  const uint32_t s_halo2 = s_w + WSTAGES * C::W_BYTES;
  const uint32_t s_w2 = s_halo2 + halo_units * 16;

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
  const T* xn = p.x + n * p.xs_n;
  // the stem's 3 input channels, the merged heads' 2-channel cotangent
  const bool narrow = p.Cr % C::E != 0;

  // -- loads of one step: the chunk's halo at its first step (or the
  // split's), and the weight slice of the step's tap row
  auto load_step = [&](int s, int slot) {
    const int chunk = s / K;
    const int r = s - chunk * K;
    const int ci0 = chunk * C::CH;
    if (s == s_begin || r == 0) {
      const uint32_t hb = s_base + (chunk & 1) * halo_units * 16;
      for (int i = tid; i < halo_units; i += nthreads) {
        const int u = i & 1;
        const int pix = i >> 1;
        const int hr = pix / C::HALO_W;
        const int hc = pix - hr * C::HALO_W;
        const int gy = oy0 - C::P + hr;
        const int gx = ox0 - C::P + hc;
        const int ci = ci0 + u * C::E;
        const bool ok =
            gy >= 0 && gy < p.H && gx >= 0 && gx < p.W && ci < p.Cr;
        const T* src = ok ? xn + gy * p.xs_h + gx * p.xs_w + ci : p.x;
        const uint32_t dst = hb + (pix * 2 + swz<2>(pix, u)) * 16;
        if (narrow)
          ld_narrow(dst, src, ok ? min(C::E, p.Cr - ci) : 0, 1);
        else
          cp16(dst, src, ok);
      }
    }
    const uint32_t wb = s_w + slot * C::W_BYTES;
    for (int i = tid; i < C::W_UNITS; i += nthreads) {
      int c, red, out, dst;
      if (!GRAD) {
        // [tap][o][CH reduction channels]: two units per row
        const int u = i & 1;
        const int o = (i >> 1) & (COB - 1);
        c = (i >> 1) / COB;
        red = ci0 + u * C::E;
        out = o0 + o;
        const int row = c * COB + o;
        dst = row * 2 + swz<2>(row, u);
      } else {
        // [tap][CH reduction channels][COB output channels]
        const int u = i & (C::B_UPR - 1);
        const int kr = (i / C::B_UPR) & (C::CH - 1);
        c = i / (C::B_UPR * C::CH);
        red = ci0 + kr;
        out = o0 + u * C::E;
        const int row = c * C::CH + kr;
        dst = row * C::B_UPR + Ty::template b_swz<C::B_UPR>(row, u);
      }
      const bool ok = red < p.Cr && out < p.Cn;
      const T* src =
          ok ? p.w + r * p.w_r + c * p.w_c + red * p.w_red + out * p.w_out
             : p.w;
      // the forward's units run along the reduction channels
      if (!GRAD && narrow)
        ld_narrow(wb + dst * 16, src, ok ? min(C::E, p.Cr - red) : 0,
                  p.w_red);
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

  // per-lane parts of the A fragments' ldmatrix row addresses
  const int a_col = (lane & 7) + ((lane >> 3) & 1) * 8;  // pixel in m16
  const int a_unit = lane >> 4;                           // unit of the step

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
    if constexpr (Ty::SPLIT) {
      // every warp is past step s-1, so the second copies are free
      if (s == s_begin || r == 0)
        Ty::split_units(hb, s_halo2, halo_units, tid, nthreads);
      Ty::split_units(wb, s_w2, C::W_UNITS, tid, nthreads);
      __syncthreads();
    }
#pragma unroll
    for (int c = 0; c < K; ++c) {
      // A of output rows 2*warp + m: pixel m16 row g (+8) in words t of
      // the step's two units, which is the bf16 m16n8k16 and the TF32
      // m16n8k8 A fragment alike
      uint32_t a[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int pix = (warp * 2 + m + r) * C::HALO_W + a_col + c;
        a[m] = hb + (pix * 2 + swz<2>(pix, a_unit)) * 16;
      }
      Ty::template tap<COB, GRAD>(acc, a, s_halo2 - hb, wb, s_w2 - wb, c,
                                  lane);
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
      bias[j][e] =
          (p.bias != nullptr && o < p.Cn) ? Ty::to_f32(p.bias[o]) : 0.f;
    }
  if (p.Cn % C::E != 0) {
    // narrow or ragged Co (the merged heads' 2): element stores
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int oy = oy0 + warp * 2 + m;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = ox0 + g + h * 8;
        if (oy >= p.H || ox >= p.W) continue;
        T* dst = p.out + out_offset(p, n, oy, ox);
#pragma unroll
        for (int j = 0; j < COB / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = o0 + j * 8 + 2 * t + e;
            if (o < p.Cn)
              dst[o] = Ty::from_f32(acc[m][j][2 * h + e] + bias[j][e]);
          }
      }
    }
    return;
  }
  Ty::template store<COB>(p, acc, bias, n, oy0 + warp * 2, ox0, o0, warp,
                         lane, smem);
}

// out = sum over the splits in order + bias, one element per thread
template <typename T>
__global__ void split_reduce_kernel(const float* __restrict__ ws,
                                    const T* __restrict__ bias,
                                    T* __restrict__ out, int64_t count,
                                    int Cn, int split) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < count; i += stride) {
    float v = 0.f;
    for (int s = 0; s < split; ++s) v += ws[s * count + i];
    if (bias != nullptr) v += Elem<T>::to_f32(bias[i % Cn]);
    out[i] = Elem<T>::from_f32(v);
  }
}

template <typename T, int K, int COB, bool GRAD>
cudaError_t launch(const Params<T>& p, cudaStream_t stream) {
  using C = Cfg<T, K, COB, GRAD>;
  const int nwarps = p.th / 2;
  const int halo_bytes = (p.th + K - 1) * C::HALO_W * 2 * 16;
  int smem = (Elem<T>::SPLIT ? 3 : 2) * halo_bytes +
             (Elem<T>::SPLIT ? WSTAGES + 1 : WSTAGES) * C::W_BYTES;
  const int stage = nwarps * COB * Elem<T>::STAGE;
  if (stage > smem) smem = stage;
  static int attr_set = 0;  // the largest size granted so far
  if (smem > 48 * 1024 && smem > attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_tc_kernel<T, K, COB, GRAD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = smem;
  }
  const int tiles_h = (p.H + p.th - 1) / p.th;
  const dim3 grid(tiles_h * p.tiles_w, (p.Cn + COB - 1) / COB, p.N * p.split);
  conv_tc_kernel<T, K, COB, GRAD><<<grid, nwarps * 32, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.split == 1) return e;
  const int64_t count = static_cast<int64_t>(p.N) * p.H * p.W * p.Cn;
  const int blocks =
      static_cast<int>((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  split_reduce_kernel<T><<<blocks, 256, 0, stream>>>(p.ws, p.bias, p.out,
                                                     count, p.Cn, p.split);
  return cudaGetLastError();
}

template <typename T, int COB, bool GRAD>
cudaError_t launch_k(int K, const Params<T>& p, cudaStream_t s) {
  switch (K) {
    case 3: return launch<T, 3, COB, GRAD>(p, s);
    case 5: return launch<T, 5, COB, GRAD>(p, s);
    case 7: return launch<T, 7, COB, GRAD>(p, s);
    case 11: return launch<T, 11, COB, GRAD>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool GRAD>
cudaError_t launch_cob(int K, const Params<T>& p, cudaStream_t s) {
  if (p.Cn <= 16) return launch_k<T, 16, GRAD>(K, p, s);
  if constexpr (Elem<T>::MAX_COB > 32) {
    if (p.Cn > 32) return launch_k<T, 64, GRAD>(K, p, s);
  }
  return launch_k<T, 32, GRAD>(K, p, s);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// what the loads need: the activations' channels and the weight's input
// channels contiguous (ws_i == 1); for the 16-byte copies of a reduction
// of a whole number of units, every other stride a whole number of units
// and 16-byte aligned bases (a narrow reduction is loaded by element,
// except the grad-input's weight, whose units run along the output
// channels, which must be a whole number of units); a tile of 4, 8 or 16
// rows; the split within the steps
template <typename T>
bool valid(const Params<T>& p, int K, int64_t xs_c, int64_t ws_i,
           bool grad) {
  constexpr int E = Unit<T>::E;
  const int steps = (p.Cr + Unit<T>::CH - 1) / Unit<T>::CH * K;
  const bool tile_ok = p.th == 4 || p.th == 8 || p.th == 16;
  const bool wide = p.Cr % E == 0;
  const bool x_ok = !wide || (p.xs_n % E == 0 && p.xs_h % E == 0 &&
                              p.xs_w % E == 0 && aligned16(p.x));
  const bool w_ok = (!wide && !grad) ||
                    (p.w_r % E == 0 && p.w_c % E == 0 &&
                     (grad ? p.w_red : p.w_out) % E == 0 && aligned16(p.w) &&
                     (!grad || p.Cn % E == 0));
  return p.N > 0 && p.H > 0 && p.W > 0 && p.Cr > 0 && p.Cn > 0 &&
         xs_c == 1 && ws_i == 1 && x_ok && w_ok && tile_ok && p.split >= 1 &&
         p.split <= steps && static_cast<int64_t>(p.N) * p.split <= 65535 &&
         p.steps == steps && (p.split == 1 || p.ws != nullptr) &&
         aligned16(p.out);
}

// The bodies of the C entries of element type T (see same_conv_tc.cu for
// the arguments).
template <typename T>
int forward_entry(const void* x, const void* w, const void* bias, void* out,
                  int dtype, int N, int H, int W, int Ci, int Co, int K,
                  int64_t xs_n, int64_t xs_h, int64_t xs_w, int64_t xs_c,
                  int64_t ws_r, int64_t ws_c, int64_t ws_i, int64_t ws_o,
                  int tile_h, int split, void* workspace, void* stream) {
  Params<T> p;
  p.x = static_cast<const T*>(x);
  p.w = static_cast<const T*>(w);
  p.bias = static_cast<const T*>(bias);
  p.out = static_cast<T*>(out);
  p.ws = static_cast<float*>(workspace);
  p.N = N; p.H = H; p.W = W; p.Cr = Ci; p.Cn = Co;
  p.th = tile_h;
  p.tiles_w = (W + TW - 1) / TW;
  p.split = split;
  p.steps = (Ci + Unit<T>::CH - 1) / Unit<T>::CH * K;
  p.xs_n = xs_n; p.xs_h = xs_h; p.xs_w = xs_w;
  p.w_r = ws_r; p.w_c = ws_c; p.w_red = ws_i; p.w_out = ws_o;
  if (dtype != Elem<T>::DTYPE || !valid(p, K, xs_c, ws_i, false))
    return cudaErrorInvalidValue;
  return launch_cob<T, false>(K, p, static_cast<cudaStream_t>(stream));
}

// The flipped, channel-swapped weight is a view: tap (r, c) reads
// w[K-1-r, K-1-c], reduction channel o reads w[..., o], output channel i
// reads w[..., i, :].
template <typename T>
int grad_input_entry(const void* ct, const void* w, void* dx, int dtype,
                     int N, int H, int W, int Ci, int Co, int K,
                     int64_t cs_n, int64_t cs_h, int64_t cs_w, int64_t cs_c,
                     int64_t ws_r, int64_t ws_c, int64_t ws_i, int64_t ws_o,
                     int tile_h, int split, void* workspace, void* stream) {
  Params<T> p;
  p.x = static_cast<const T*>(ct);
  p.w = static_cast<const T*>(w) + (K - 1) * ws_r + (K - 1) * ws_c;
  p.bias = nullptr;
  p.out = static_cast<T*>(dx);
  p.ws = static_cast<float*>(workspace);
  p.N = N; p.H = H; p.W = W; p.Cr = Co; p.Cn = Ci;
  p.th = tile_h;
  p.tiles_w = (W + TW - 1) / TW;
  p.split = split;
  p.steps = (Co + Unit<T>::CH - 1) / Unit<T>::CH * K;
  p.xs_n = cs_n; p.xs_h = cs_h; p.xs_w = cs_w;
  p.w_r = -ws_r; p.w_c = -ws_c; p.w_red = ws_o; p.w_out = ws_i;
  if (dtype != Elem<T>::DTYPE || K <= 0 || !valid(p, K, cs_c, ws_i, true))
    return cudaErrorInvalidValue;
  return launch_cob<T, true>(K, p, static_cast<cudaStream_t>(stream));
}

}  // namespace
