// f32 stride-1, same-padding, odd-k 2-D convolution for Hopper (sm_90a) in
// 3xTF32 on wgmma: an implicit GEMM whose pre-split weights and halo tiles
// come by TMA through an mbarrier ring, a producer warp apart from the
// consumer warpgroups (the machinery of same_conv_wgmma.cuh, shared with
// the bf16 kernel of same_conv_wgmma.cu).
//
// Replaces the TPU kernel consistent_depth_tpu/ops/s2d_conv.py
// (_s2d_conv_kernel, launched by _s2d_conv_pallas_jit) in f32, the
// fine-tune's default precision, in both directions the port runs it: the
// forward, and the grad-input of the TPU package's custom VJP
// (consistent_depth_tpu/models/layers.py, _conv_pallas_bwd), the same conv
// of the cotangent with the flipped, channel-swapped weight:
//
//   out[n,y,x,o] = bias[o] + sum_{r,c,i} x[n,y+r-p,x+c-p,i] w[r,c,i,o]
//
// What bounds it: operations, at the tensor cores' TF32 rate (495 TFLOP/s
// dense on an H100) over three products per product. One TF32 product
// keeps 11 of f32's 24 mantissa bits (3e-4 of max |ref| on the hourglass's
// convs), so every operand v is split into
//   big = tf32(v), small = tf32(v - big)   (nearest, ties away: cvt.rna)
// and each product is big*big + big*small + small*big (small*small, below
// 2^-22 of the product, is dropped). What each design point does:
//   - the weight is split once per call, by its own kernel, into two planes
//     big and small laid out K-major for the direction at hand,
//     [plane][r][c][o][i] for the forward and [plane][r][c][i][o] for the
//     grad-input (the reduction channel contiguous): TF32 wgmma reads B only
//     K-major (no transpose for 32-bit types), and the grad-input's view of
//     the weight is MN-major. k^2 Ci Co elements, a few us. The grad-input's
//     tap flip stays an index, (k-1-r, k-1-c), in the TMA coordinate;
//   - wgmma.mma_async m64nNk8 TF32 with A from registers ("RS"): a tap's
//     shifted window is a set of row addresses into the halo tile, so each
//     warp of a consumer warpgroup reads its 16 rows of A with one
//     ldmatrix.x4.b16 per k8 step (lane (g, t) gets word t of row g of each
//     8x8 b16 matrix: the TF32 fragment (g,t) (g+8,t) (g,t+4) (g+8,t+4),
//     which is CuTe's ALayout_64x8 for SM90_64xNx8_F32TF32TF32_RS per warp)
//     and splits it in registers: two integer instructions a rounding
//     (cvt.rna, on the conversion pipe, measured up to 22% slower) and a
//     subtract. The halo is held once in shared memory, as it came. At
//     16-row tiles for k >= 7 (two m64 tiles per warpgroup, twice the A
//     fragments per stage) the consumers split each chunk's halo once in
//     shared memory instead, into a second copy, and read both by ldmatrix;
//   - B big and small: two TMA boxes per stage of the ring, read through two
//     descriptors; a chunk is 16 channels, 64 bytes of each pixel, swizzled
//     by 64 bytes (the halo's rows and B's rows alike), so that a k=11 tap
//     row of 11 stages fits beside two halo tiles at every tile height; a
//     k=3 reduction over more than 16 channels at tiles below 16 rows takes
//     32 (the 128-byte swizzle, four k8 steps a tap), which ran faster;
//   - accuracy of the sums: the tensor cores add into their f32 sum with
//     truncation, so chaining every product of a block onto one sum biases
//     it toward zero (5e-5 to 7e-5 of max |ref| on the card at k=11, 64
//     channels). A consumer chains one tap row's products onto a partial
//     (scale-d = 0 on the row's first restarts it), which the FP32 pipes
//     then add to the accumulator, rounding to nearest: at most 5.2e-6 over
//     the classes of mc, midas2 and monodepth2 (a partial per tap: 4.0e-6,
//     and 10-16% slower on mc's k=11 classes of 32 or more output channels).
//     The card's check holds every class to 2e-5 of max |plain| (PERF.md
//     section 6 has the errors of the three ways);
//   - a commit group is one tap: a consumer warpgroup issues a tap's group
//     onto the partial and then waits for the group before it, loading the
//     next tap's A fragments meanwhile into the other of two register
//     buffers; at a tap row's first tap it waits for every group and adds
//     the partial first. Two consumer warpgroups keep the tensor cores busy
//     through those waits;
//   - registers: the accumulator, the partial and two buffers of A, big and
//     small (at most 96 a thread before addressing; every instantiation 168,
//     the launch bound's, with no spill): output-channel blocks of 16, 32 or
//     64, two m64 tiles per warpgroup (a 16-row tile) only for blocks of up
//     to 32. The A registers are pinned before each wgmma.fence, so that the
//     compiler does not compute the split after it (ptxas injected a fence
//     of its own before each wgmma then, C7519);
//   - filling the card, the tile and the split of the reduction: as the bf16
//     kernel (ops/s2d_conv.py::_plan), each split's partial sums reduced in a
//     fixed order by the shared reduce kernel.
//
// What still holds it back (PERF.md section 6): at N = 16 each m64n16k8
// carries as many A fragments as an m64n64k8 and the split's instructions
// come per fragment, so the classes of 16 or fewer output channels ran
// faster on same_conv_tf32.cu and stay there (ops/s2d_conv.py,
// WGMMA_TF32_THIN); elsewhere the wait at each tap row's start and the copy
// pipeline keep it at 30-56% of its bound.
//
// Instantiations: output-channel block (16, 32, 64) x m64 tiles per
// warpgroup (1, or 2 for blocks of up to 32) x chunk (16, or 32 at one m64
// tile) x the halo split in shared memory (at two m64 tiles); k, the
// direction, the tile height, the ring's depth and the split are run-time
// values. The kernels allocate nothing, launch on the caller's stream and do
// not synchronise. The C entries return cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for arguments they do not take.

#include "same_conv_wgmma.cuh"

namespace {

// When a consumer adds its partial sums to the accumulator (the FP32
// pipes, rounding to nearest) and restarts them: at the first tap of each
// tap row (FLUSH_ROW), after every tap (FLUSH_TAP), or only at the end
// (FLUSH_NEVER: every product chained in the tensor cores, which truncate).
// Measured alternatives: tools/torch_conv_wgmma.py --dtype f32 --variants.
enum { FLUSH_NEVER, FLUSH_ROW, FLUSH_TAP };
constexpr int FLUSH = FLUSH_ROW;

// v rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero: half of the 13 dropped bits added to the magnitude), by two
// integer instructions at the full rate
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

__device__ __forceinline__ void lds128(uint32_t (&v)[4], uint32_t addr) {
  asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr));
}
__device__ __forceinline__ void sts128(uint32_t addr,
                                       const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.u32 [%0], {%1,%2,%3,%4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// wgmma.mma_async m64nNk8, f32 += tf32 x tf32, A from registers (the
// m16n8k8 TF32 A fragment of each warp's 16 rows), B K-major through its
// descriptor; scale 0 ignores d's old value
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15},"
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        "%26, %27, %28, %29, %30, %31},"
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale));
  }
};

// -- the kernels ------------------------------------------------------------

// planes[p][r][c][n][k] = (big, small)[p] of w[r, c] at reduction channel k
// and output channel n, w read through any element strides
__global__ void split_weight_kernel(const float* __restrict__ w,
                                    float* __restrict__ planes, int K, int Cr,
                                    int Cn, int64_t s_r, int64_t s_c,
                                    int64_t s_red, int64_t s_n) {
  const int64_t total = static_cast<int64_t>(K) * K * Cn * Cr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    int64_t q = i;
    const int kr = static_cast<int>(q % Cr);
    q /= Cr;
    const int nn = static_cast<int>(q % Cn);
    q /= Cn;
    const int c = static_cast<int>(q % K);
    const int r = static_cast<int>(q / K);
    const float v = w[r * s_r + c * s_c + kr * s_red + nn * s_n];
    uint32_t big, small;
    split(__float_as_uint(v), big, small);
    planes[i] = __uint_as_float(big);
    planes[total + i] = __uint_as_float(small);
  }
}

// Block: warpgroup 0 produces, warpgroups 1..nwg consume. Consumer
// warpgroup j holds output rows (j*MT + t)*4 + warp of the tile, t < MT,
// each warp 16 columns. A chunk is NK k8 steps (8 NK channels); SMEM: the
// chunk's halo is split once in shared memory.
template <int COB, int MT, int NK, bool SMEM>
__global__ void __launch_bounds__(384, 1)
conv_tf32_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const Params<float> p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = smem_layout(p, smem_raw);
  const int tid = threadIdx.x;
  const int oy0 = (blockIdx.x / p.tiles_w) * p.th;
  const int ox0 = (blockIdx.x % p.tiles_w) * TW;
  const int o0 = blockIdx.y * COB;
  const int n = blockIdx.z / p.split;
  const int sp = blockIdx.z % p.split;
  int s_begin, s_end;
  step_range(p, sp, s_begin, s_end);
  const int K = p.K;

  if (tid == 0) init_barriers(p, sm);
  __syncthreads();

  // the warpgroup index, made warp-uniform for the compiler by a shuffle
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 0) {
    // -- producer: warp 0 issues every copy (same_conv_wgmma.cuh)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid >= 32) return;
    // the planes' map: (reduction channel, output channel, c, plane*K + r);
    // a stage is tap (r, c)'s big box, then its small box
    auto load_stage = [&](uint32_t dst, uint32_t full, int chunk, int r,
                          int c) {
      const int cc = p.flip ? K - 1 - c : c;
      const int rr = p.flip ? K - 1 - r : r;
      tma_load_4d(dst, &wmap, full, chunk * p.ch, o0, cc, rr);
      tma_load_4d(dst + p.plane_bytes, &wmap, full, chunk * p.ch, o0, cc,
                  K + rr);
    };
    produce(p, sm, xmap, tid, n, ox0, oy0, s_begin, s_end,
            p.halo_h * p.halo_w * NK * 32, 2 * NK * 32 * COB, load_stage);
    return;
  }

  // -- consumers ------------------------------------------------------------
  const int wg = role - 1;
  const int warp = __shfl_sync(0xffffffffu, (tid >> 5) & 3, 0);
  const int lane = tid & 31;

  float acc[MT][COB / 2], part[MT][COB / 2];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < COB / 2; ++i) acc[t][i] = part[t][i] = 0.f;
  // a commit group is one tap: NK k8 steps of three products; two register
  // buffers of its A fragments, big and small
  uint32_t ab[2][MT][NK][4], as[2][MT][NK][4];
  // whether the tap of each buffer is the first of its tap row
  bool row_start[2];

  // the lane's ldmatrix rows at tap (0, 0): pixel a_col of its warp's 16
  // in output row (wg*MT + t)*4 + warp, unit a_half of 16 bytes
  const int a_col = (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t a_half = (lane >> 4) * 16;
  int a_pix[MT];
#pragma unroll
  for (int t = 0; t < MT; ++t)
    a_pix[t] = ((wg * MT + t) * 4 + warp) * p.halo_w + a_col;
  constexpr int PIX_BYTES = NK * 32;
  const int taps = (s_end - s_begin) * K;
  // SMEM: the small copy of halo buffer b is buffer b + halos / 2
  const uint32_t small_off = (p.halos / 2) * p.halo_bytes;

  // the next tap to load: tap (r, c) of its chunk, at pixel offset tap_pix
  // of the halo tile; the next weight stage to issue, `slot` of phase
  // parity `ph`, and the next to release
  int r = s_begin - (s_begin / K) * K, c = 0, tap_pix = r * p.halo_w;
  int slot = 0, rel_slot = 0, hl = 0, hb = 0;
  uint32_t ph = 0;
  bool new_chunk = true;

  // A of the next tap into buffer `buf`, big and small
  auto load = [&](auto buf, int i) {
    constexpr int B = decltype(buf)::value;
    row_start[B] = c == 0;
    if (new_chunk) {
      // the last chunk's halo was read by ldmatrix already (where the
      // split wrote it, every lane orders its writes before the next TMA)
      if (i != 0) {
        if (SMEM) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
        }
        if (lane == 0) mbar_arrive(sm.hempty + 8 * hb);
      }
      hb = hl & 1;
      mbar_wait_warp(sm.hfull + 8 * hb, (hl >> 1) & 1);
      ++hl;
      if (SMEM) {
        // the consumers split the chunk's halo in 16-byte units, then
        // meet on a named barrier before any reads a fragment
        const uint32_t h = sm.halo + hb * p.halo_bytes;
        const int units = p.halo_h * p.halo_w * PIX_BYTES / 16;
        for (int u = tid - 128; u < units; u += 128 * p.nwg) {
          uint32_t v[4], big[4], small[4];
          lds128(v, h + u * 16);
#pragma unroll
          for (int e = 0; e < 4; ++e) split(v[e], big[e], small[e]);
          sts128(h + u * 16, big);
          sts128(h + small_off + u * 16, small);
        }
        asm volatile("bar.sync 1, %0;\n" ::"r"(128 * p.nwg) : "memory");
      }
    }
    const uint32_t hbase = sm.halo + hb * p.halo_bytes;
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      const uint32_t row = (a_pix[t] + tap_pix) * PIX_BYTES + a_half;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint32_t off = row + kk * 32;
        const uint32_t addr = hbase + (off ^ ((off >> 3) & p.a_swz));
        if (SMEM) {
          ldsm4(ab[B][t][kk], addr);
          ldsm4(as[B][t][kk], addr + small_off);
        } else {
          uint32_t v[4];
          ldsm4(v, addr);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split(v[e], ab[B][t][kk][e], as[B][t][kk][e]);
        }
      }
    }
    new_chunk = false;
    if (++c == K) {
      c = 0;
      if (++r == K) {
        r = 0;
        new_chunk = true;
      }
      tap_pix = r * p.halo_w;
    } else {
      ++tap_pix;
    }
  };

  // one k8 step of m64 tile t into the sums d: big*big (scale 0 restarts
  // the sums), big*small, small*big
  auto mma3 = [&](float (&d)[COB / 2], const uint32_t (&a_big)[4],
                  const uint32_t (&a_small)[4], uint64_t big, uint64_t small,
                  int scale) {
    Wgmma<COB>::mma(d, a_big, big, scale);
    Wgmma<COB>::mma(d, a_big, small, 1);
    Wgmma<COB>::mma(d, a_small, big, 1);
  };

  // the tap of buffer `buf` against the next weight stage onto the
  // partial sums, restarting them where `fresh`
  auto issue = [&](auto buf, bool fresh) {
    constexpr int B = decltype(buf)::value;
    mbar_wait_warp(sm.wfull + 8 * slot, ph);
    const uint32_t stage = sm.w + slot * p.stage_bytes;
    const uint64_t big = p.b_desc | ((stage & 0x3FFFF) >> 4);
    const uint64_t small = big + (p.plane_bytes >> 4);
    if (++slot == p.nst) {
      slot = 0;
      ph ^= 1;
    }
    // the split's results are registers like any: pin them here, before
    // the fence, or the compiler may compute them after it (and ptxas then
    // injects a fence of its own before each wgmma that reads them)
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      fence_acc(part[t]);
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          asm volatile("" : "+r"(ab[B][t][kk][e]), "+r"(as[B][t][kk][e]));
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const uint64_t kb = (kk * p.b_kk_bytes) >> 4;
#pragma unroll
      for (int t = 0; t < MT; ++t)
        mma3(part[t], ab[B][t][kk], as[B][t][kk], big + kb, small + kb,
             fresh && kk == 0 ? 0 : 1);
    }
    wgmma_commit();
  };

  // the partial sums onto the accumulator (every group complete)
  auto flush = [&]() {
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      fence_acc(part[t]);
#pragma unroll
      for (int e = 0; e < COB / 2; ++e) acc[t][e] += part[t][e];
    }
  };
  // the last group's weight stage back to the producer
  auto release = [&]() {
    if (lane == 0) mbar_arrive(sm.wempty + 8 * rel_slot);
    if (++rel_slot == p.nst) rel_slot = 0;
  };

  // group i restarts the partial (after waiting for every group before it
  // and flushing them), or is issued onto it and then group i-1 waited for,
  // so that one group's products run while the next one's A loads
  auto step = [&](auto buf, auto other, int i) {
    constexpr int B = decltype(buf)::value;
    const bool fresh = i == 0 || FLUSH == FLUSH_TAP ||
                       (FLUSH == FLUSH_ROW && row_start[B]);
    if (i > 0 && fresh) {
      wgmma_wait<0>();
      flush();
      release();
    }
    issue(buf, fresh);
    if (i > 0 && !fresh) {
      wgmma_wait<1>();
      release();
    }
    if (i + 1 < taps) load(other, i + 1);
  };
  constexpr std::integral_constant<int, 0> b0{};
  constexpr std::integral_constant<int, 1> b1{};
  if (taps > 0) load(b0, 0);
  int i = 0;
  for (; i + 1 < taps; i += 2) {
    step(b0, b1, i);
    step(b1, b0, i + 1);
  }
  if (i < taps) step(b0, b1, i);
  wgmma_wait<0>();
  if (taps > 0) {
    flush();
    release();
  }

  // -- epilogue. acc[t][4j + 2h + e]: pixel column g + 8h of output row
  // (wg*MT + t)*4 + warp, output channel o0 + 8j + 2tq + e
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int64_t plane = static_cast<int64_t>(p.N) * p.H * p.W * p.Cn;
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    const int oy = oy0 + (wg * MT + t) * 4 + warp;
    if (oy >= p.H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ox = ox0 + g + 8 * h;
      if (ox >= p.W) continue;
      const int64_t pix =
          (static_cast<int64_t>(n) * p.H + oy) * p.W + ox;
      float* dst0 = p.split > 1 ? p.ws + sp * plane : p.out;
#pragma unroll
      for (int j = 0; j < COB / 8; ++j) {
        const int o = o0 + 8 * j + 2 * tq;
        float v0 = acc[t][4 * j + 2 * h];
        float v1 = acc[t][4 * j + 2 * h + 1];
        if (p.split == 1 && p.bias != nullptr) {
          if (o < p.Cn) v0 += p.bias[o];
          if (o + 1 < p.Cn) v1 += p.bias[o + 1];
        }
        float* dst = dst0 + pix * p.Cn + o;
        if (o + 1 < p.Cn && (p.Cn & 1) == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          if (o < p.Cn) dst[0] = v0;
          if (o + 1 < p.Cn) dst[1] = v1;
        }
      }
    }
  }
}

// -- host ---------------------------------------------------------------------

// the output-channel block (wgmma's N)
int block_of(int Cn) { return Cn <= 16 ? 16 : Cn <= 32 ? 32 : 64; }

// The reduction channels per chunk: 32 (the 128-byte swizzle, four k8
// steps a tap) for a k=3 reduction over more than 16 channels at a tile of
// one m64 per warpgroup, where it measured faster, unless a split over
// `split` blocks would find fewer steps; else 16, whose two halo tiles
// leave a k=11 tap row's 11 stages room at every tile height
int chunk_of(int Cr, int K, int tile_h, int split) {
  return K == 3 && Cr > 16 && tile_h < 16 && (Cr + 31) / 32 * K >= split
             ? 32 : 16;
}

// Whether the consumers split each chunk's halo once in shared memory:
// at 16-row tiles (two m64 tiles per warpgroup, twice the A fragments per
// stage) for k >= 7, where it measured faster than the split in registers
bool smem_split_of(int K, int tile_h) { return tile_h == 16 && K >= 7; }

cudaError_t split_weight(const float* w, float* planes, int K, int Cr, int Cn,
                         int64_t s_r, int64_t s_c, int64_t s_red,
                         int64_t s_n, cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(K) * K * Cn * Cr;
  const int blocks = static_cast<int>(
      (total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024);
  split_weight_kernel<<<blocks, 256, 0, stream>>>(w, planes, K, Cr, Cn, s_r,
                                                  s_c, s_red, s_n);
  return cudaGetLastError();
}

template <int COB, int MT, int NK, bool SMEM>
cudaError_t launch(const Params<float>& p, const CUtensorMap& xmap,
                   const CUtensorMap& wmap, int smem, cudaStream_t stream) {
  static int granted = 0;
  const cudaError_t e0 =
      grant_smem(conv_tf32_kernel<COB, MT, NK, SMEM>, smem, granted);
  if (e0 != cudaSuccess) return e0;
  const int tiles_h = (p.H + p.th - 1) / p.th;
  const dim3 grid(tiles_h * p.tiles_w, (p.Cn + COB - 1) / COB,
                  p.N * p.split);
  conv_tf32_kernel<COB, MT, NK, SMEM>
      <<<grid, 128 * (1 + p.nwg), smem, stream>>>(xmap, wmap, p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.split == 1) return e;
  return launch_split_reduce(p, stream);
}

// the instantiation: a 16-row tile holds two m64 tiles per warpgroup (its
// chunk 16, the halo split in shared memory or not); smaller tiles one (a
// chunk of 16 or 32, the split in registers)
template <int COB>
cudaError_t launch_tile(const Params<float>& p, bool smem_split,
                        const CUtensorMap& xmap, const CUtensorMap& wmap,
                        int smem, cudaStream_t s) {
  if constexpr (COB <= 32) {
    if (p.th == 16)
      return smem_split ? launch<COB, 2, 2, true>(p, xmap, wmap, smem, s)
                        : launch<COB, 2, 2, false>(p, xmap, wmap, smem, s);
  }
  return p.ch == 32 ? launch<COB, 1, 4, false>(p, xmap, wmap, smem, s)
                    : launch<COB, 1, 2, false>(p, xmap, wmap, smem, s);
}

cudaError_t launch_cob(const Params<float>& p, bool smem_split,
                       const CUtensorMap& xmap, const CUtensorMap& wmap,
                       int smem, cudaStream_t s) {
  switch (block_of(p.Cn)) {
    case 16: return launch_tile<16>(p, smem_split, xmap, wmap, smem, s);
    case 32: return launch_tile<32>(p, smem_split, xmap, wmap, smem, s);
    default: return launch_tile<64>(p, smem_split, xmap, wmap, smem, s);
  }
}

// Both directions: a (N, H, W, Cr) with element strides as_{n,h,w} (channel
// stride 1) is reduced against the weight w (K, K, Ci, Co) with element
// strides ws_{r,c,i,o} into out (N, H, W, Cn). The forward reduces over i
// (Cr = Ci, Cn = Co); the grad-input over o (Cr = Co, Cn = Ci) with the
// taps flipped. The workspace holds the weight's planes, then the split's
// partial sums.
int conv_entry(bool grad, const void* a, const void* w, const void* bias,
               void* out, int dtype, int N, int H, int W, int Ci, int Co,
               int K, int64_t as_n, int64_t as_h, int64_t as_w, int64_t as_c,
               int64_t ws_r, int64_t ws_c, int64_t ws_i, int64_t ws_o,
               int tile_h, int split, void* workspace, void* stream) {
  Params<float> p;
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.N = N; p.H = H; p.W = W;
  p.Cr = grad ? Co : Ci;
  p.Cn = grad ? Ci : Co;
  p.K = K; p.P = (K - 1) / 2;
  p.th = tile_h;
  p.tiles_w = (W + TW - 1) / TW;
  p.split = split;
  p.ch = chunk_of(p.Cr, K, tile_h, split);
  p.lg_nk = 0;
  p.steps = (p.Cr + p.ch - 1) / p.ch * K;
  const bool smem_split = smem_split_of(K, tile_h);
  p.flip = grad ? 1 : 0;
  const int cob = block_of(p.Cn);
  p.nwg = tile_h == 4 ? 1 : 2;
  const bool dims_ok = N > 0 && H > 0 && W > 0 && Ci > 0 && Co > 0 &&
                       (K == 3 || K == 5 || K == 7 || K == 11);
  const bool tile_ok =
      tile_h == 4 || tile_h == 8 || (tile_h == 16 && cob <= 32);
  // TMA: 16-byte aligned bases and strides; the reduction channels a whole
  // number of 16-byte units (4 f32). The weight is read by element.
  // a batch of one may carry any batch stride: give the map a plain one
  const int64_t xs_n = N == 1 ? as_h * H : as_n;
  const bool strides_ok = as_c == 1 && aligned16(a) && aligned16(workspace) &&
                          p.Cr % 4 == 0 && xs_n % 4 == 0 && as_h % 4 == 0 &&
                          as_w % 4 == 0 && as_h > 0 && as_w > 0;
  if (dtype != 0 || !dims_ok || !tile_ok || !strides_ok || split < 1 ||
      split > p.steps || static_cast<int64_t>(N) * split > 65535 ||
      workspace == nullptr)
    return cudaErrorInvalidValue;
  float* planes = static_cast<float*>(workspace);
  const int64_t plane_elems = static_cast<int64_t>(K) * K * p.Cn * p.Cr;
  p.ws = planes + 2 * plane_elems;

  // shared memory: the halo tiles (two where the reduction has more than
  // one chunk; where the halo is split in shared memory, then their small
  // copies), the ring of stages (a tap's big and small boxes each), the
  // barriers, the alignment. The producer fills a tap row's K stages at
  // once; a consumer holds one stage while it loads the next tap
  p.halo_w = TW + K - 1;
  p.halo_h = tile_h + K - 1;
  p.halo_bytes = round_up(p.halo_h * p.halo_w * p.ch * 4, ALIGN);
  p.plane_bytes = round_up(p.ch * cob * 4, ALIGN);
  p.stage_bytes = 2 * p.plane_bytes;
  p.halos = (p.Cr > p.ch ? 2 : 1) * (smem_split ? 2 : 1);
  const int fixed = ALIGN + p.halos * p.halo_bytes + 32 + 16 * MAX_STAGES;
  p.nst = (SMEM_LIMIT - fixed) / p.stage_bytes;
  if (p.nst > MAX_STAGES) p.nst = MAX_STAGES;
  if (p.nst < 2 || p.nst < K) return cudaErrorInvalidValue;
  const int smem = fixed + p.nst * p.stage_bytes;
  p.a_swz = ((p.ch * 4 / 16) - 1) << 4;

  CUtensorMap xmap, wmap;
  if (!encode_halo(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a, xs_n, as_h,
                   as_w, p))
    return cudaErrorInvalidValue;
  // the planes as (reduction channel, output channel, c, plane*K + r); a
  // box is one tap's chunk of reduction channels by the block's output
  // channels, K-major B in rows of a chunk's channels
  const cuuint64_t wdims[4] = {static_cast<cuuint64_t>(p.Cr),
                               static_cast<cuuint64_t>(p.Cn),
                               static_cast<cuuint64_t>(K),
                               static_cast<cuuint64_t>(2 * K)};
  const cuuint64_t row = static_cast<cuuint64_t>(p.Cr) * 4;
  const cuuint64_t wstrides[3] = {row, row * p.Cn, row * p.Cn * K};
  const cuuint32_t wbox[4] = {static_cast<cuuint32_t>(p.ch),
                              static_cast<cuuint32_t>(cob), 1, 1};
  if (!encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, planes, wdims, wstrides,
              wbox, p.ch * 4))
    return cudaErrorInvalidValue;
  // K-major, swizzled: LBO unused (1); SBO 8 rows of a chunk's bytes, in
  // 16-byte units; a k8 step is 32 bytes along the row
  p.b_kk_bytes = 32;
  p.b_desc = (1ull << 16) | (static_cast<uint64_t>(8 * p.ch * 4 / 16) << 32) |
             (layout_of(p.ch * 4) << 62);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      split_weight(static_cast<const float*>(w), planes, K, p.Cr, p.Cn, ws_r,
                   ws_c, grad ? ws_o : ws_i, grad ? ws_i : ws_o, s);
  if (e != cudaSuccess) return e;
  return launch_cob(p, smem_split, xmap, wmap, smem, s);
}

}  // namespace

extern "C" {

// x: (N, H, W, Ci) f32 with element strides xs_{n,h,w,c} (xs_c == 1, Ci a
// multiple of 4, the other strides positive multiples of 4, the base
// 16-byte aligned); w: (K, K, Ci, Co) f32 with any element strides
// ws_{r,c,i,o}; bias: (Co,) contiguous or NULL; out: (N, H, W, Co)
// contiguous. tile_h: output rows per block (4, 8, or 16 for Co <= 32);
// split: blocks per output tile over the reduction. workspace: 16-byte
// aligned, 2 K K Ci Co f32 for the weight's planes, then (split, N, H, W,
// Co) f32 when split > 1. dtype must be 0 (float32). Returns a cudaError_t
// value; 0 means launched (the weight split, the conv, and the reduce of a
// split).
int same_conv_wgmma_tf32_forward(const void* x, const void* w,
                                 const void* bias, void* out, int dtype,
                                 int N, int H, int W, int Ci, int Co, int K,
                                 int64_t xs_n, int64_t xs_h, int64_t xs_w,
                                 int64_t xs_c, int64_t ws_r, int64_t ws_c,
                                 int64_t ws_i, int64_t ws_o, int tile_h,
                                 int split, void* workspace, void* stream) {
  return conv_entry(false, x, w, bias, out, dtype, N, H, W, Ci, Co, K, xs_n,
                    xs_h, xs_w, xs_c, ws_r, ws_c, ws_i, ws_o, tile_h, split,
                    workspace, stream);
}

// Grad-input of same_conv_wgmma_tf32_forward. ct: (N, H, W, Co) f32 with
// element strides cs_{n,h,w,c} (cs_c == 1, Co a multiple of 4); w: the
// forward's (K, K, Ci, Co) weight with any element strides ws_{r,c,i,o};
// dx: (N, H, W, Ci) contiguous; workspace as above with (split, N, H, W,
// Ci). The flipped, channel-swapped weight is the planes' tap coordinate
// and layout.
int same_conv_wgmma_tf32_grad_input(const void* ct, const void* w, void* dx,
                                    int dtype, int N, int H, int W, int Ci,
                                    int Co, int K, int64_t cs_n, int64_t cs_h,
                                    int64_t cs_w, int64_t cs_c, int64_t ws_r,
                                    int64_t ws_c, int64_t ws_i, int64_t ws_o,
                                    int tile_h, int split, void* workspace,
                                    void* stream) {
  return conv_entry(true, ct, w, nullptr, dx, dtype, N, H, W, Ci, Co, K,
                    cs_n, cs_h, cs_w, cs_c, ws_r, ws_c, ws_i, ws_o, tile_h,
                    split, workspace, stream);
}

// The weight split alone: planes (2, K, K, Co, Ci) f32 of w (K, K, Ci, Co)
// with element strides ws_{r,c,i,o}, or (2, K, K, Ci, Co) with grad != 0;
// plane 0 big = tf32(w), plane 1 small = tf32(w - big), cvt.rna.
int same_conv_tf32_split_weight(const void* w, void* planes, int Ci, int Co,
                                int K, int64_t ws_r, int64_t ws_c,
                                int64_t ws_i, int64_t ws_o, int grad,
                                void* stream) {
  if (Ci <= 0 || Co <= 0 || K <= 0) return cudaErrorInvalidValue;
  return split_weight(static_cast<const float*>(w), static_cast<float*>(planes),
                      K, grad ? Co : Ci, grad ? Ci : Co, ws_r, ws_c,
                      grad ? ws_o : ws_i, grad ? ws_i : ws_o,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
