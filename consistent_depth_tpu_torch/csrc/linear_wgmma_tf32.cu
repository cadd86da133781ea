// f32 GEMMs of a linear layer for Hopper (sm_90a) in 3xTF32 on wgmma: the
// forward y = x w^T + b, the grad-input g w and the grad-weight g^T x of
// ops/transformer.py::_Linear, each as one product
//
//   out[r, c] = sum_k A[r, k] B[c, k]   (+ bias[c])
//
// over R output rows, C output columns and a reduction of Kr, with B split
// beforehand into two K-major TF32 planes (big, small) by this source's split
// kernel, and A read from shared memory as it came and split in registers.
//
// Replaces no TPU kernel: the JAX package has no transformer. It was added
// for dav2-large's linears (models/vit.py: qkv, proj, fc1, fc2 of 24
// blocks; models/depth_anything_v2.py: the two stride-k transposed convs
// as one linear each), which cuBLAS ran as an f32 SGEMM on the FMA pipes,
// about half of a fine-tune step on an H100.
//
// What bounds it: operations, at the tensor cores' TF32 rate (495 TFLOP/s
// dense on an H100) over three products per product, 165 TFLOP/s. One TF32
// product keeps 11 of f32's 24 mantissa bits, so every operand v is split
// into big = tf32(v), small = tf32(v - big) (nearest, ties away, as
// cvt.rna) and each product is big*big + big*small + small*big (small*small,
// below 2^-22 of the product, is dropped). What the design does:
//   - one block per SM walks over output tiles of 128 x 128 (a persistent
//     grid): a producer warp keeps a ring of 4 stages of 32 reduction
//     elements in flight by TMA (A's tile, B's big and small boxes), and two
//     consumer warpgroups each take 64 rows of the tile with
//     wgmma.mma_async m64n128k8 TF32, A from registers ("RS"). The producer
//     loads the next tile's stages while the consumers store this one's;
//   - B, K-major as TF32 wgmma requires, is split once a call: the weight as
//     it is (forward) by same_conv_wgmma_tf32.cu's weight split, one tap of
//     ~4 M elements in a few us, or transposed (grad-input) by this source's
//     linear_tf32_split; for the grad-weight the narrower of g and x, also
//     transposed, so that the rows are contiguous. A is x or g as it lies:
//     K-major for the forward and the grad-input (one ldmatrix.x4.b16 a k8
//     step gives the TF32 fragment, as in same_conv_wgmma_tf32.cu), and
//     MN-major for the grad-weight (four 32-bit loads a k8 step, the
//     fragment's rows mapped onto the 128-byte swizzle so that no two lanes
//     meet in a bank). The split costs two integer instructions a rounding
//     and a subtract;
//   - accuracy of the sums: the tensor cores add into their f32 sum by
//     truncation, so a consumer chains at most FLUSH_K8 k8 steps onto a
//     partial (scale-d = 0 restarts it) and adds the partial to its
//     accumulator on the FP32 pipes, rounding to nearest; the two
//     warpgroups do so half a period apart. Accumulator and partial take
//     128 registers a thread; the producer gives up its registers
//     (setmaxnreg) for them;
//   - a commit group is one k8 step of three products: a consumer issues it,
//     waits for the group before it and loads the next step's A meanwhile
//     into the other of two register buffers;
//   - ragged edges: TMA fills coordinates outside the tensors with zeros, and
//     the epilogue masks its stores;
//   - few output tiles over a long reduction (the grad-weight of a 1024 x
//     1024 weight is 64 tiles): the reduction is split over blocks, each
//     split's partial sums go to an f32 workspace, and a second pass adds
//     them in a fixed order (no atomics: two calls give bitwise the same
//     result). Tiles and split come from the shapes (ops/transformer.py,
//     _plan).
//
// Instantiations: A K-major or MN-major. The kernels allocate nothing,
// launch on the caller's stream and do not synchronise. The C entries
// return cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for arguments they do not take.

#include "same_conv_wgmma.cuh"

namespace {

constexpr int BM = 128;       // output rows of a tile: two warpgroups of m64
constexpr int BN = 128;       // output columns of a tile: wgmma's N
constexpr int BK = 32;        // reduction elements a stage: 128-byte rows
constexpr int K8 = BK / 8;    // k8 steps a stage
constexpr int NST = 4;        // stages of the ring
constexpr int A_BYTES = BM * BK * 4;
constexpr int PLANE_BYTES = BN * BK * 4;
constexpr int STAGE_BYTES = A_BYTES + 2 * PLANE_BYTES;
constexpr int GEMM_SMEM = ALIGN + NST * STAGE_BYTES + 16 * NST;
constexpr int GEMM_THREADS = 384;   // producer warpgroup, two consumers
// k8 steps chained onto a partial before it is added to the accumulator
constexpr int FLUSH_K8 = 4;
// B's descriptor, start address 0: K-major, 128-byte swizzle (1 << 62);
// stride between 8-row groups 1024 bytes; leading offset unused (1)
constexpr uint64_t B_DESC =
    (1ull << 16) | (static_cast<uint64_t>(8 * BK * 4 / 16) << 32) |
    (1ull << 62);
static_assert(GEMM_SMEM <= SMEM_LIMIT, "ring exceeds shared memory");

struct Gemm {
  const float* bias;   // (C,) or null
  float* out;          // out[r * out_sr + c * out_sc]
  float* ws;           // (split, R, C) f32 when split > 1
  int64_t out_sr, out_sc;
  int R, C, Kr;
  int tiles_c, tiles, split, units, kblocks;
};

// v rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), by two integer instructions at the full rate, bit for bit as
// same_conv_wgmma_tf32.cu's weight split rounds
__device__ __forceinline__ uint32_t tf32_round(uint32_t v) {
  return (v + 0x1000u) & 0xFFFFE000u;
}

// v = big + small + (what is dropped, below 2^-22 of v)
__device__ __forceinline__ void split(uint32_t v, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_round(v);
  small = tf32_round(
      __float_as_uint(__uint_as_float(v) - __uint_as_float(big)));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// wgmma.mma_async m64n128k8, f32 += tf32 x tf32, A from registers (the
// m16n8k8 TF32 A fragment of each warp's 16 rows), B K-major through its
// descriptor; scale 0 ignores d's old value
__device__ __forceinline__ void mma128(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t desc_b, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale));
}

// -- the kernels ------------------------------------------------------------

// Unit u of the grid's work: output tile u % tiles (columns fastest), the
// reduction's split u / tiles, whose k-blocks are [kb0, kb1)
__device__ __forceinline__ void unit_of(const Gemm& p, int u, int& r0,
                                        int& c0, int& sp, int& kb0,
                                        int& kb1) {
  const int tile = u % p.tiles;
  sp = u / p.tiles;
  r0 = (tile / p.tiles_c) * BM;
  c0 = (tile % p.tiles_c) * BN;
  kb0 = static_cast<int>(static_cast<int64_t>(sp) * p.kblocks / p.split);
  kb1 = static_cast<int>(static_cast<int64_t>(sp + 1) * p.kblocks / p.split);
}

// The row of the tile that a consumer's accumulator row holds: warp `warp`
// of warpgroup `wg`, fragment row g + 8h. K-major A: in order. MN-major A:
// the rows are columns of A's 32-wide TMA boxes, 16-byte chunk
// 2 (warp & 1) + h + 4 (g >> 2) of box 2 wg + warp / 2, element g & 3, so
// that a fragment load's 32 lanes fall in 32 banks under the swizzle
template <bool A_MN>
__device__ __forceinline__ int tile_row(int wg, int warp, int g, int h) {
  if (A_MN)
    return (2 * wg + (warp >> 1)) * 32 +
           4 * (2 * (warp & 1) + h + 4 * (g >> 2)) + (g & 3);
  return wg * 64 + warp * 16 + g + 8 * h;
}

// Block: warpgroup 0 produces (one thread issues every copy), warpgroups 1
// and 2 consume, rows [64 (wg - 1), 64 wg) of each tile. A_MN: A is stored
// reduction-major, out[r, c] = sum_k a[k, r] b[c, k].
template <bool A_MN>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
linear_tf32_kernel(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap bmap, const Gemm p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + ALIGN - 1) & ~(ALIGN - 1);
  const uint32_t full = ring + NST * STAGE_BYTES;
  const uint32_t empty = full + 8 * NST;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < NST; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 8);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, made warp-uniform for the compiler by a shuffle
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 0) {
    // -- producer: a stage is A's tile (one box K-major, four 32-column
    // boxes MN-major), then B's big and small boxes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 0) return;
    int slot = 0;
    uint32_t ph = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      int r0, c0, sp, kb0, kb1;
      unit_of(p, u, r0, c0, sp, kb0, kb1);
      for (int kb = kb0; kb < kb1; ++kb) {
        mbar_wait_one(empty + 8 * slot, ph ^ 1);
        const uint32_t bar = full + 8 * slot;
        mbar_expect_tx(bar, STAGE_BYTES);
        const uint32_t a = ring + slot * STAGE_BYTES;
        const int k0 = kb * BK;
        if (A_MN) {
#pragma unroll
          for (int b = 0; b < BM / 32; ++b)
            tma_load_4d(a + b * 32 * BK * 4, &amap, bar, r0 + 32 * b, k0, 0,
                        0);
        } else {
          tma_load_4d(a, &amap, bar, k0, r0, 0, 0);
        }
        tma_load_4d(a + A_BYTES, &bmap, bar, k0, c0, 0, 0);
        tma_load_4d(a + A_BYTES + PLANE_BYTES, &bmap, bar, k0, c0, 1, 0);
        if (++slot == NST) {
          slot = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // -- consumers --------------------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = role - 1;
  const int warp = __shfl_sync(0xffffffffu, (tid >> 5) & 3, 0);
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  // the lane's A addresses in a stage at k8 step 0. MN-major: fragment
  // register e (row g + 8 (e & 1), reduction t + 4 (e >> 1)), a step 8 rows
  // of 128 bytes further. K-major: the ldmatrix row (its byte offset and
  // its swizzle) and the 16-byte half of the k8 step
  uint32_t a_off[4];
  if (A_MN) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kt = t + 4 * (e >> 1);
      const int row = tile_row<true>(wg, warp, g, e & 1);
      a_off[e] = (row >> 5) * 32 * BK * 4 + kt * 128 +
                 ((((row & 31) >> 2) ^ kt) << 4) + (row & 3) * 4;
    }
  } else {
    const int row = wg * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    a_off[0] = row * 128;
    a_off[1] = (row & 7) << 4;
    a_off[2] = (lane >> 4) * 16;
    a_off[3] = 0;
  }

  float acc[64], part[64];
  // two register buffers of a k8 step's A fragments, big and small, and
  // the stage each was loaded from
  uint32_t ab[2][4], as[2][4], stage_of[2];
  int ld_slot = 0, rel_slot = 0;
  uint32_t ld_ph = 0, cur = ring;

  // A of step i (k8 step i % K8 of its stage) into buffer `buf`
  auto load = [&](auto buf, int i) {
    constexpr int B = decltype(buf)::value;
    const int kk = i % K8;
    if (kk == 0) {
      mbar_wait_warp(full + 8 * ld_slot, ld_ph);
      cur = ring + ld_slot * STAGE_BYTES;
      if (++ld_slot == NST) {
        ld_slot = 0;
        ld_ph ^= 1;
      }
    }
    stage_of[B] = cur;
    uint32_t v[4];
    if (A_MN) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = lds32(cur + kk * 8 * 128 + a_off[e]);
    } else {
      ldsm4(v, cur + a_off[0] + ((kk * 32 + a_off[2]) ^ a_off[1]));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) split(v[e], ab[B][e], as[B][e]);
  };

  // step i's three products onto the partial, restarting it where `fresh`
  auto issue = [&](auto buf, int i, bool fresh) {
    constexpr int B = decltype(buf)::value;
    const uint32_t b = stage_of[B] + A_BYTES + (i % K8) * 32;
    const uint64_t big = B_DESC | ((b & 0x3FFFF) >> 4);
    const uint64_t small = big + (PLANE_BYTES >> 4);
    // the split's results are registers like any: pin them before the
    // fence, or the compiler may compute them after it
    fence_acc(part);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      asm volatile("" : "+r"(ab[B][e]), "+r"(as[B][e]));
    wgmma_fence();
    mma128(part, ab[B], big, fresh ? 0 : 1);
    mma128(part, ab[B], small, 1);
    mma128(part, as[B], big, 1);
    wgmma_commit();
  };

  // the partial onto the accumulator (every group complete)
  auto flush = [&]() {
    fence_acc(part);
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] += part[e];
  };
  // a stage whose last step is complete back to the producer
  auto release = [&]() {
    if (lane == 0) mbar_arrive(empty + 8 * rel_slot);
    if (++rel_slot == NST) rel_slot = 0;
  };

  constexpr std::integral_constant<int, 0> b0{};
  constexpr std::integral_constant<int, 1> b1{};
  const int64_t ws_plane = static_cast<int64_t>(p.R) * p.C;
  const int flush_phase = wg * (FLUSH_K8 / 2);
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    int r0, c0, sp, kb0, kb1;
    unit_of(p, u, r0, c0, sp, kb0, kb1);
    const int steps = (kb1 - kb0) * K8;   // even
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;

    // step i restarts the partial (after waiting for every group before it
    // and flushing them) or is issued onto it and then step i-1 waited for;
    // a stage goes back once its last step is complete. The two warpgroups
    // flush half a period apart, so that one keeps the tensor cores busy
    // while the other waits for its groups
    auto step = [&](auto buf, auto other, int i) {
      const bool fresh = i == 0 || (i + flush_phase) % FLUSH_K8 == 0;
      if (i > 0 && fresh) {
        wgmma_wait<0>();
        flush();
        if ((i - 1) % K8 == K8 - 1) release();
      }
      issue(buf, i, fresh);
      if (i > 0 && !fresh) {
        wgmma_wait<1>();
        if ((i - 1) % K8 == K8 - 1) release();
      }
      if (i + 1 < steps) load(other, i + 1);
    };
    load(b0, 0);
    for (int i = 0; i < steps; i += 2) {
      step(b0, b1, i);
      step(b1, b0, i + 1);
    }
    wgmma_wait<0>();
    flush();
    release();

    // -- epilogue. acc[4j + 2h + e]: tile row tile_row(wg, warp, g, h),
    // column 8j + 2t + e. The bias is read before any store: a load after a
    // store through another pointer would wait for it
    if (p.split == 1 && p.bias != nullptr) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = c0 + 8 * j + 2 * t;
        const float b0 = col < p.C ? p.bias[col] : 0.f;
        const float b1 = col + 1 < p.C ? p.bias[col + 1] : 0.f;
        acc[4 * j] += b0;
        acc[4 * j + 1] += b1;
        acc[4 * j + 2] += b0;
        acc[4 * j + 3] += b1;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + tile_row<A_MN>(wg, warp, g, h);
      if (row >= p.R) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = c0 + 8 * j + 2 * t;
        const float v0 = acc[4 * j + 2 * h];
        const float v1 = acc[4 * j + 2 * h + 1];
        if (p.split > 1) {
          float* dst = p.ws + sp * ws_plane +
                       static_cast<int64_t>(row) * p.C + col;
          if (col + 1 < p.C && (p.C & 1) == 0) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            if (col < p.C) dst[0] = v0;
            if (col + 1 < p.C) dst[1] = v1;
          }
          continue;
        }
        float* dst = p.out + row * p.out_sr + col * p.out_sc;
        if (p.out_sc == 1 && col + 1 < p.C && (p.out_sr & 1) == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          if (col < p.C) dst[0] = v0;
          if (col + 1 < p.C) dst[p.out_sc] = v1;
        }
      }
    }
  }
}

// planes[p][j][i] = (big, small)[p] of src[i * s_row + j * s_col]: the
// matrix transposed, through a 32 x 32 tile in shared memory so that reads
// and writes both run along rows. Block (32, 8); grid (row tiles, column
// tiles)
__global__ void split_transpose_kernel(const float* __restrict__ src,
                                       float* __restrict__ planes, int rows,
                                       int cols, int64_t s_row, int64_t s_col,
                                       int64_t ld, int64_t plane) {
  __shared__ float tile[32][33];
  const int i0 = blockIdx.x * 32;
  const int j0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = i0 + ty + 8 * q;
    const int j = j0 + tx;
    tile[ty + 8 * q][tx] =
        i < rows && j < cols ? src[i * s_row + j * s_col] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = j0 + ty + 8 * q;
    const int i = i0 + tx;
    if (i < rows && j < cols) {
      uint32_t big, small;
      split(__float_as_uint(tile[tx][ty + 8 * q]), big, small);
      planes[j * ld + i] = __uint_as_float(big);
      planes[plane + j * ld + i] = __uint_as_float(small);
    }
  }
}

// out[r * sr + c * sc] = sum over the splits in order of ws[s, r, c] (+
// bias[c]), one element per thread
__global__ void split_reduce_kernel(const float* __restrict__ ws,
                                    const float* __restrict__ bias,
                                    float* __restrict__ out, int R, int C,
                                    int split, int64_t sr, int64_t sc) {
  const int64_t count = static_cast<int64_t>(R) * C;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < count; i += stride) {
    const int64_t r = i / C;
    const int64_t c = i - r * C;
    float v = 0.f;
    for (int s = 0; s < split; ++s) v += ws[s * count + i];
    if (bias != nullptr) v += bias[c];
    out[r * sr + c * sc] = v;
  }
}

// -- host ---------------------------------------------------------------------

template <bool A_MN>
cudaError_t launch(const Gemm& p, const CUtensorMap& amap,
                   const CUtensorMap& bmap, int blocks, cudaStream_t stream) {
  static int granted = 0;
  const cudaError_t e =
      grant_smem(linear_tf32_kernel<A_MN>, GEMM_SMEM, granted);
  if (e != cudaSuccess) return e;
  linear_tf32_kernel<A_MN>
      <<<blocks, GEMM_THREADS, GEMM_SMEM, stream>>>(amap, bmap, p);
  return cudaGetLastError();
}

int blocks_for(int64_t n) {
  return static_cast<int>((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
}

}  // namespace

extern "C" {

// out[r, c] = sum_k A[r, k] planes[0 or 1][c, k] products in 3xTF32 (+
// bias[c]), R x C outputs over a reduction of Kr. a: f32, 16-byte aligned,
// rows of a_ld elements (a multiple of 4): A[r, k] = a[r * a_ld + k], or
// with a_mn != 0, a[k * a_ld + r]. planes: linear_tf32_split's (2, C, b_ld)
// f32 (b_ld a multiple of 4, at least Kr), 16-byte aligned. bias: (C,)
// contiguous or NULL. out[r * out_sr + c * out_sc]. split: blocks over the
// reduction (1 to ceil(Kr / 32)); blocks: the persistent grid; workspace:
// (split, R, C) f32 when split > 1, else unused. Returns a cudaError_t
// value; 0 means launched (the GEMM and the reduce of a split).
int linear_wgmma_tf32(const void* a, int64_t a_ld, int a_mn,
                      const void* planes, int64_t b_ld, const void* bias,
                      void* out, int64_t out_sr, int64_t out_sc, int R, int C,
                      int Kr, int split, int blocks, void* workspace,
                      void* stream) {
  Gemm p;
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.ws = static_cast<float*>(workspace);
  p.out_sr = out_sr;
  p.out_sc = out_sc;
  p.R = R;
  p.C = C;
  p.Kr = Kr;
  p.tiles_c = (C + BN - 1) / BN;
  p.tiles = ((R + BM - 1) / BM) * p.tiles_c;
  p.kblocks = (Kr + BK - 1) / BK;
  p.split = split;
  p.units = p.tiles * split;
  const bool ok =
      R > 0 && C > 0 && Kr > 0 && split >= 1 && split <= p.kblocks &&
      blocks >= 1 && static_cast<int64_t>(p.tiles) * split < (1LL << 31) &&
      aligned16(a) && aligned16(planes) && a_ld % 4 == 0 && b_ld % 4 == 0 &&
      b_ld >= Kr && a_ld >= (a_mn ? R : Kr) &&
      (split == 1 || (workspace != nullptr && aligned16(workspace)));
  if (!ok) return cudaErrorInvalidValue;

  // A: (Kr, R) K-major, a box of 32 reduction elements by 128 rows; or (R,
  // Kr) MN-major, a box of 32 rows by 32 reduction elements. Both rows of
  // 128 bytes, swizzled by 128 bytes
  CUtensorMap amap, bmap;
  const cuuint64_t a_row = static_cast<cuuint64_t>(a_ld) * 4;
  const cuuint64_t a_rows = static_cast<cuuint64_t>(a_mn ? Kr : R);
  const cuuint64_t adims[4] = {static_cast<cuuint64_t>(a_mn ? R : Kr),
                               a_rows, 1, 1};
  const cuuint64_t astrides[3] = {a_row, a_row * a_rows, a_row * a_rows};
  const cuuint32_t abox[4] = {32, static_cast<cuuint32_t>(a_mn ? BK : BM),
                              1, 1};
  // B: the planes as (Kr, C, 2), a box of 32 reduction elements by 128
  // columns of one plane
  const cuuint64_t b_row = static_cast<cuuint64_t>(b_ld) * 4;
  const cuuint64_t bdims[4] = {static_cast<cuuint64_t>(Kr),
                               static_cast<cuuint64_t>(C), 2, 1};
  const cuuint64_t bstrides[3] = {b_row, b_row * C, 2 * b_row * C};
  const cuuint32_t bbox[4] = {BK, BN, 1, 1};
  if (!encode(&amap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a, adims, astrides,
              abox, 128) ||
      !encode(&bmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, planes, bdims,
              bstrides, bbox, 128))
    return cudaErrorInvalidValue;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split > 1) p.bias = nullptr;
  const cudaError_t e = a_mn ? launch<true>(p, amap, bmap, blocks, s)
                             : launch<false>(p, amap, bmap, blocks, s);
  if (e != cudaSuccess || split == 1) return e;
  const int64_t count = static_cast<int64_t>(R) * C;
  split_reduce_kernel<<<blocks_for(count), 256, 0, s>>>(
      p.ws, static_cast<const float*>(bias), p.out, R, C, split, out_sr,
      out_sc);
  return cudaGetLastError();
}

// The (rows, cols) f32 matrix src[i * s_row + j * s_col] split into two
// TF32 planes of its transpose, big = tf32(v) and small = tf32(v - big)
// (cvt.rna): (2, cols, ld), ld >= rows, planes[p][j][i]. Returns a
// cudaError_t value.
int linear_tf32_split(const void* src, void* planes, int rows, int cols,
                      int64_t s_row, int64_t s_col, int64_t ld,
                      void* stream) {
  if (rows <= 0 || cols <= 0 || ld < rows || (cols + 31) / 32 > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((rows + 31) / 32, (cols + 31) / 32);
  split_transpose_kernel<<<grid, dim3(32, 8), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(planes), rows, cols,
      s_row, s_col, ld, static_cast<int64_t>(cols) * ld);
  return cudaGetLastError();
}

}  // extern "C"
