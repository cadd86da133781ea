// bf16 stride-1, same-padding, odd-k 2-D convolution for Hopper (sm_90a):
// an implicit GEMM on wgmma, its weights fed by TMA through an mbarrier
// ring, a producer warp apart from the consumer warpgroups.
//
// Replaces the TPU kernel consistent_depth_tpu/ops/s2d_conv.py
// (_s2d_conv_kernel, launched by _s2d_conv_pallas_jit) in bf16, in both
// directions the port runs it: the forward, and the grad-input of the TPU
// package's custom VJP (consistent_depth_tpu/models/layers.py,
// _conv_pallas_bwd), the same conv of the cotangent with the flipped,
// channel-swapped weight:
//
//   out[n,y,x,o] = bias[o] + sum_{r,c,i} x[n,y+r-p,x+c-p,i] w[r,c,i,o]
//
// as a GEMM: M = output pixels, N = output channels, K = k*k taps times the
// reduction channels, walked chunk by chunk (16, 32 or 64 channels) and tap
// by tap. The space-to-depth relayout of the TPU kernel exists for the
// MXU's 128 lanes and is not carried over. Reductions that cannot be cut
// into 16-byte units (the stem's 3 input channels, the merged heads'
// 2-channel cotangent) stay on the mma.sync kernel of same_conv_tc.cu,
// which loads them by element; TMA needs 16-byte strides.
//
// What bounds it: operations. The hourglass's 68 convs of one batch-8
// forward at 224x384 do 742 GFLOP against 1.24 GB of bf16 bytes (0.75 ms
// against 0.37 ms on an H100); the 67 grad-inputs of a train step do 716
// GFLOP. What each design point does about it:
//   - wgmma.mma_async m64nNk16 with A from registers ("RS"): a tap's shifted
//     window is a set of row addresses into the halo tile, which no
//     shared-memory descriptor can express, so each warp of a consumer
//     warpgroup reads its 16 rows of A (16 output pixels of one row) with
//     ldmatrix.x4 from the halo tile (the m16n8k16 A layout, which is the
//     per-warp layout of wgmma's register A). N is the output-channel block
//     (16, 32, 64 or 128), accumulated in f32 registers (N/2 a thread per
//     m64 tile);
//   - B from shared memory through a descriptor: one tap's weight slice
//     (a chunk of reduction channels by the block's output channels) per
//     stage of a ring of up to 24. The forward's weight has its reduction
//     channel i contiguous, so B is K-major; the grad-input's view has its
//     output channel i contiguous, so B is MN-major, and wgmma transposes it
//     (imm-trans-b = 1). The grad-input's tap flip is an index, (k-1-r,
//     k-1-c), in the TMA coordinate;
//   - TMA: the producer warp loads each stage with one tensor-map copy
//     (two for an MN-major block of 128), a tap row's K stages at once
//     from K lanes (one thread's serial chain of wait, expect and copy per
//     tap caps a block at ~0.3 us a tap), swizzled so that the rows wgmma
//     reads are the canonical 32/64/128-byte swizzle atoms
//     the descriptor names; completion is counted on the stage's full
//     mbarrier and the consumer warps release it on its empty mbarrier;
//   - the halo tile through TMA as well: a 4-D tiled map over NHWC whose box
//     starts at (x0-p, y0-p); coordinates outside the tensor are filled with
//     zeros, which is exactly same padding and ragged channels. Its swizzle
//     (the chunk's width) puts the 8 pixel rows of each ldmatrix in 8
//     distinct bank groups, whatever the tap's shift. Two halo buffers where
//     the reduction has more than one chunk; the next chunk's halo is
//     requested a few tap rows into the current one;
//   - warp specialisation: warpgroup 0 is the producer (setmaxnreg.dec
//     releases its registers; warp 0 issues every copy), warpgroups 1
//     and 2 (or 1 alone for a 4-row tile) consume. A commit group is four
//     k16 steps of a warpgroup's m64 tiles (one tap of a 64-channel chunk,
//     two of 32, four of 16); a consumer waits for all but the newest group
//     (wgmma.wait_group 1), so that one group's products run while the next
//     one's A fragments load into the other of two register buffers. The
//     taps are walked incrementally and the chunk's steps are a template
//     parameter, so that the issue slots go to ldmatrix and wgmma: a
//     generic step loop (divisions, per-step branches) costs ~500
//     instructions a tap against ~64 clocks of tensor work at N = 16;
//   - filling the card: the wrapper's plan (ops/s2d_conv.py::_plan) picks a
//     tile of 4, 8 or 16 output rows by 16 columns (two m64 tiles per
//     consumer warpgroup at 16 rows, for blocks of up to 64 channels) and
//     where even the smallest tile leaves fewer than 2x132 blocks it splits
//     the reduction's steps (one chunk by one tap row) over blocks into an
//     f32 workspace; a second kernel adds the partial sums in a fixed order
//     (no atomics: runs repeat bit for bit), adds the bias and stores;
//   - tensor maps from the host: cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint (no link against the driver library), two maps
//     per call, kept in a small cache keyed by every argument of the encode
//     (a bf16 train step is host-bound), passed as __grid_constant__
//     parameters.
//
// What still holds it back (PERF.md section 6): at N = 16 every
// m64n16k16 reads as many A bytes from shared memory as an m64n64k16, and
// a 16-channel reduction gives a tap one k16 step, so those classes stay
// on same_conv_tc.cu (ops/s2d_conv.py, WGMMA_THIN); elsewhere the copy
// pipeline (barrier handshakes, one TMA per tap) and the A fragments'
// shared-memory reads, not the tensor cores, set the pace.
//
// The machinery this source shares with the f32 kernel
// (same_conv_wgmma_tf32.cu) is in same_conv_wgmma.cuh: the PTX wrappers,
// the bounded barrier waits, the producer warp, the halo's TMA, the
// tensor-map encode and its cache, and the split-K reduce kernel.
//
// Instantiations: N block (16, 32, 64, 128) x direction x m64 tiles per
// warpgroup (1, or 2 for blocks of up to 64) x 16-channel steps per chunk
// (1, 2, 4); k, the tile height, the ring's depth and the split are
// run-time values. The kernels allocate nothing, launch on the caller's
// stream and do not synchronise.
// The C entries return cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments they do not take.

#include "same_conv_wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, A from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B through its descriptor;
// TRANS_B 0: B K-major, 1: B MN-major
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  template <int TRANS_B>
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
          "n"(TRANS_B));
  }
};

template <>
struct Wgmma<32> {
  template <int TRANS_B>
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15},"
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
          "n"(TRANS_B));
  }
};

template <>
struct Wgmma<64> {
  template <int TRANS_B>
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        "%26, %27, %28, %29, %30, %31},"
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
          "n"(TRANS_B));
  }
};

template <>
struct Wgmma<128> {
  template <int TRANS_B>
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
        "%62, %63},"
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
          "n"(TRANS_B));
  }
};

// -- the kernel -----------------------------------------------------------

// Block: warpgroup 0 produces, warpgroups 1..nwg consume. Consumer
// warpgroup j holds output rows (j*MT + t)*4 + warp of the tile, t < MT,
// each warp 16 columns.
template <int COB, bool GRAD, int MT, int NK>
__global__ void __launch_bounds__(384, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const Params<bf16> p) {
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
    // the weight stage of tap (r, c) of a chunk: map dimensions 0 the
    // contiguous i, then c, r and o by stride; the grad-input's tap (r, c)
    // reads w[K-1-r, K-1-c]
    auto load_stage = [&](uint32_t dst, uint32_t full, int chunk, int r,
                          int c) {
      const int cc = GRAD ? K - 1 - c : c;
      const int rr = GRAD ? K - 1 - r : r;
      const int oo = GRAD ? chunk * p.ch : o0;
      const int d1 = p.wpos_c == 1 ? cc : p.wpos_r == 1 ? rr : oo;
      const int d2 = p.wpos_c == 2 ? cc : p.wpos_r == 2 ? rr : oo;
      const int d3 = p.wpos_c == 3 ? cc : p.wpos_r == 3 ? rr : oo;
      if (!GRAD) {
        tma_load_4d(dst, &wmap, full, chunk * p.ch, d1, d2, d3);
      } else {
        for (int a = 0; a < p.b_atoms; ++a)
          tma_load_4d(dst + a * p.b_atom_bytes, &wmap, full, o0 + a * 64,
                      d1, d2, d3);
      }
    };
    produce(p, sm, xmap, tid, n, ox0, oy0, s_begin, s_end,
            p.halo_h * p.halo_w * p.ch * 2, p.ch * COB * 2, load_stage);
    return;
  }

  // -- consumers ------------------------------------------------------------
  const int wg = role - 1;
  const int warp = __shfl_sync(0xffffffffu, (tid >> 5) & 3, 0);
  const int lane = tid & 31;

  float acc[MT][COB / 2];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < COB / 2; ++i) acc[t][i] = 0.f;
  // a commit group is four k16 steps: TPG taps of NK steps; two register
  // buffers of its A fragments
  constexpr int TPG = 4 / NK;
  uint32_t a[2][TPG][MT][NK][4];

  // the lane's ldmatrix rows at tap (0, 0): pixel a_col of its warp's 16
  // in output row (wg*MT + t)*4 + warp, unit a_half of 16 channels
  const int a_col = (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t a_half = (lane >> 4) * 16;
  int a_pix[MT];
#pragma unroll
  for (int t = 0; t < MT; ++t)
    a_pix[t] = ((wg * MT + t) * 4 + warp) * p.halo_w + a_col;
  constexpr int PIX_BYTES = NK * 32;
  const int taps = (s_end - s_begin) * K;

  // the next tap: tap (r, c) of its chunk, at pixel offset tap_pix of the
  // halo tile; the next weight stage `slot` of phase parity `ph`; the
  // stages waited for (`held`) and released
  int r = s_begin - (s_begin / K) * K, c = 0, tap_pix = r * p.halo_w;
  int slot = 0, rel_slot = 0, held = 0, released = 0, hl = 0, hb = 0;
  uint32_t ph = 0;
  bool new_chunk = true;

  auto group = [&](auto buf, int g0) {
    constexpr int B = decltype(buf)::value;
    const int held_before = held;
    uint32_t stage[TPG];
#pragma unroll
    for (int j = 0; j < TPG; ++j) {
      if (g0 + j >= taps) {
        // past the block's last tap: zeros times the last tap's B
#pragma unroll
        for (int t = 0; t < MT; ++t)
#pragma unroll
          for (int kk = 0; kk < NK; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) a[B][j][t][kk][e] = 0u;
        stage[j] = stage[j > 0 ? j - 1 : 0];
        continue;
      }
      if (new_chunk) {
        // the last chunk's halo was read by ldmatrix already
        if (g0 + j != 0 && lane == 0) mbar_arrive(sm.hempty + 8 * hb);
        hb = hl & 1;
        mbar_wait_warp(sm.hfull + 8 * hb, (hl >> 1) & 1);
        ++hl;
      }
      mbar_wait_warp(sm.wfull + 8 * slot, ph);
      const uint32_t hbase = sm.halo + hb * p.halo_bytes;
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const uint32_t row = (a_pix[t] + tap_pix) * PIX_BYTES + a_half;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          const uint32_t off = row + kk * 32;
          ldsm4(a[B][j][t][kk], hbase + (off ^ ((off >> 3) & p.a_swz)));
        }
      }
      stage[j] = sm.w + slot * p.stage_bytes;
      ++held;
      if (++slot == p.nst) {
        slot = 0;
        ph ^= 1;
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
    }
#pragma unroll
    for (int t = 0; t < MT; ++t) fence_acc(acc[t]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < TPG; ++j) {
      const uint64_t desc = p.b_desc | ((stage[j] & 0x3FFFF) >> 4);
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
#pragma unroll
        for (int t = 0; t < MT; ++t)
          Wgmma<COB>::template mma<GRAD ? 1 : 0>(
              acc[t], a[B][j][t][kk], desc + ((kk * p.b_kk_bytes) >> 4));
    }
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int t = 0; t < MT; ++t) fence_acc(acc[t]);
    // every earlier group is complete: release the stages of its taps
    for (; released < held_before; ++released) {
      if (lane == 0) mbar_arrive(sm.wempty + 8 * rel_slot);
      if (++rel_slot == p.nst) rel_slot = 0;
    }
  };
  int first = 0;
  for (; first + TPG < taps; first += 2 * TPG) {
    group(std::integral_constant<int, 0>(), first);
    group(std::integral_constant<int, 1>(), first + TPG);
  }
  if (first < taps) group(std::integral_constant<int, 0>(), first);
  wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < MT; ++t) fence_acc(acc[t]);

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
#pragma unroll
      for (int j = 0; j < COB / 8; ++j) {
        const int o = o0 + 8 * j + 2 * tq;
        float v0 = acc[t][4 * j + 2 * h];
        float v1 = acc[t][4 * j + 2 * h + 1];
        if (p.split > 1) {
          float* dst = p.ws + sp * plane + pix * p.Cn + o;
          if (o < p.Cn) dst[0] = v0;
          if (o + 1 < p.Cn) dst[1] = v1;
          continue;
        }
        if (p.bias != nullptr) {
          if (o < p.Cn) v0 += __bfloat162float(p.bias[o]);
          if (o + 1 < p.Cn) v1 += __bfloat162float(p.bias[o + 1]);
        }
        bf16* dst = p.out + pix * p.Cn + o;
        if (o + 1 < p.Cn && (p.Cn & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (o < p.Cn) dst[0] = __float2bfloat16(v0);
          if (o + 1 < p.Cn) dst[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// the reduction channels per chunk (wgmma's k16 steps walk 16 of them):
// the fewest of 16, 32, 64 that hold the reduction, halved while a split
// over `split` blocks would find fewer steps (a chunk by a tap row); and
// the output-channel block
int chunk_of(int Cr, int K, int split) {
  int ch = Cr <= 16 ? 16 : Cr <= 32 ? 32 : 64;
  while (ch > 16 && (Cr + ch - 1) / ch * K < split) ch /= 2;
  return ch;
}
int block_of(int Cn) {
  return Cn <= 16 ? 16 : Cn <= 32 ? 32 : Cn <= 64 ? 64 : 128;
}

template <int COB, bool GRAD, int MT, int NK>
cudaError_t launch(const Params<bf16>& p, const CUtensorMap& xmap,
                   const CUtensorMap& wmap, int smem, cudaStream_t stream) {
  static int granted = 0;
  const cudaError_t e0 =
      grant_smem(conv_wgmma_kernel<COB, GRAD, MT, NK>, smem, granted);
  if (e0 != cudaSuccess) return e0;
  const int tiles_h = (p.H + p.th - 1) / p.th;
  const dim3 grid(tiles_h * p.tiles_w, (p.Cn + COB - 1) / COB,
                  p.N * p.split);
  conv_wgmma_kernel<COB, GRAD, MT, NK>
      <<<grid, 128 * (1 + p.nwg), smem, stream>>>(xmap, wmap, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.split == 1) return e;
  return launch_split_reduce(p, stream);
}

template <int COB, bool GRAD, int MT>
cudaError_t launch_nk(const Params<bf16>& p, const CUtensorMap& xmap,
                      const CUtensorMap& wmap, int smem, cudaStream_t s) {
  switch (p.lg_nk) {
    case 0: return launch<COB, GRAD, MT, 1>(p, xmap, wmap, smem, s);
    case 1: return launch<COB, GRAD, MT, 2>(p, xmap, wmap, smem, s);
    default: return launch<COB, GRAD, MT, 4>(p, xmap, wmap, smem, s);
  }
}

template <bool GRAD>
cudaError_t launch_cob(const Params<bf16>& p, const CUtensorMap& xmap,
                       const CUtensorMap& wmap, int smem, cudaStream_t s) {
  const bool two = p.th == 16;
  switch (block_of(p.Cn)) {
    case 16:
      return two ? launch_nk<16, GRAD, 2>(p, xmap, wmap, smem, s)
                 : launch_nk<16, GRAD, 1>(p, xmap, wmap, smem, s);
    case 32:
      return two ? launch_nk<32, GRAD, 2>(p, xmap, wmap, smem, s)
                 : launch_nk<32, GRAD, 1>(p, xmap, wmap, smem, s);
    case 64:
      return two ? launch_nk<64, GRAD, 2>(p, xmap, wmap, smem, s)
                 : launch_nk<64, GRAD, 1>(p, xmap, wmap, smem, s);
    default: return launch_nk<128, GRAD, 1>(p, xmap, wmap, smem, s);
  }
}

// Both directions: a (N, H, W, Cr) with element strides as_{n,h,w} (channel
// stride 1) is reduced against the weight w (K, K, Ci, Co) with element
// strides ws_{r,c,i,o} (ws_i == 1) into out (N, H, W, Cn). The forward
// reduces over i (Cr = Ci, Cn = Co); the grad-input over o (Cr = Co, Cn =
// Ci) with the taps flipped.
int conv_entry(bool grad, const void* a, const void* w, const void* bias,
               void* out, int dtype, int N, int H, int W, int Ci, int Co,
               int K, int64_t as_n, int64_t as_h, int64_t as_w, int64_t as_c,
               int64_t ws_r, int64_t ws_c, int64_t ws_i, int64_t ws_o,
               int tile_h, int split, void* workspace, void* stream) {
  Params<bf16> p;
  p.bias = static_cast<const bf16*>(bias);
  p.out = static_cast<bf16*>(out);
  p.ws = static_cast<float*>(workspace);
  p.N = N; p.H = H; p.W = W;
  p.Cr = grad ? Co : Ci;
  p.Cn = grad ? Ci : Co;
  p.K = K; p.P = (K - 1) / 2;
  p.th = tile_h;
  p.tiles_w = (W + TW - 1) / TW;
  p.split = split;
  p.ch = chunk_of(p.Cr, K, split);
  p.lg_nk = p.ch == 64 ? 2 : p.ch == 32 ? 1 : 0;
  p.steps = (p.Cr + p.ch - 1) / p.ch * K;
  const int cob = block_of(p.Cn);
  p.nwg = tile_h == 4 ? 1 : 2;
  const bool dims_ok = N > 0 && H > 0 && W > 0 && Ci > 0 && Co > 0 &&
                       (K == 3 || K == 5 || K == 7 || K == 11);
  const bool tile_ok =
      tile_h == 4 || tile_h == 8 || (tile_h == 16 && cob <= 64);
  // TMA: 16-byte aligned bases and strides; the reduction channels a whole
  // number of 16-byte units (8 bf16), and in the grad-input the output
  // channels (the weight's contiguous i) too
  // a batch of one may carry any batch stride: give the map a plain one
  const int64_t xs_n = N == 1 ? as_h * H : as_n;
  const bool strides_ok =
      as_c == 1 && ws_i == 1 && aligned16(a) && aligned16(w) &&
      p.Cr % 8 == 0 && (!grad || p.Cn % 8 == 0) && xs_n % 8 == 0 &&
      as_h % 8 == 0 && as_w % 8 == 0 && ws_r % 8 == 0 && ws_c % 8 == 0 &&
      ws_o % 8 == 0 && as_h > 0 && as_w > 0 && ws_r > 0 && ws_c > 0 &&
      ws_o > 0;
  if (dtype != 1 || !dims_ok || !tile_ok || !strides_ok || split < 1 ||
      split > p.steps || static_cast<int64_t>(N) * split > 65535 ||
      (split > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;

  // shared memory: the halo tiles (two where the reduction has more than
  // one chunk), the ring, the barriers, the alignment. A consumer holds a
  // commit group's stages (4 / NK taps) until the next group is issued,
  // so the ring needs two groups
  p.halo_w = TW + K - 1;
  p.halo_h = tile_h + K - 1;
  p.halo_bytes = round_up(p.halo_h * p.halo_w * p.ch * 2, ALIGN);
  p.stage_bytes = round_up(p.ch * cob * 2, ALIGN);
  p.halos = p.Cr > p.ch ? 2 : 1;
  const int fixed = ALIGN + p.halos * p.halo_bytes + 32 + 16 * MAX_STAGES;
  p.nst = (SMEM_LIMIT - fixed) / p.stage_bytes;
  if (p.nst > MAX_STAGES) p.nst = MAX_STAGES;
  // the producer fills a tap row's K stages at once
  if (p.nst < 2 * (4 >> p.lg_nk) || p.nst < K) return cudaErrorInvalidValue;
  const int smem = fixed + p.nst * p.stage_bytes;
  p.a_swz = ((p.ch * 2 / 16) - 1) << 4;

  // the halo: x as (C, W, H, N), a box of one chunk by the halo tile
  CUtensorMap xmap, wmap;
  if (!encode_halo(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, xs_n, as_h,
                   as_w, p))
    return cudaErrorInvalidValue;

  // the weight as (i, then c, r, o by increasing stride); one box is a
  // tap's chunk of reduction channels by the block's output channels
  const int64_t st[3] = {ws_c, ws_r, ws_o};
  const int64_t extent[3] = {K, K, Co};
  int order[3] = {0, 1, 2};  // order[d - 1]: which of c, r, o is dim d
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (st[order[j]] < st[order[i]]) {
        const int t = order[i];
        order[i] = order[j];
        order[j] = t;
      }
  int pos[3];
  for (int d = 0; d < 3; ++d) pos[order[d]] = d + 1;
  p.wpos_c = pos[0];
  p.wpos_r = pos[1];
  cuuint64_t wdims[4] = {static_cast<cuuint64_t>(Ci), 0, 0, 0};
  cuuint64_t wstrides[3];
  cuuint32_t wbox[4] = {0, 1, 1, 1};
  for (int d = 0; d < 3; ++d) {
    wdims[d + 1] = static_cast<cuuint64_t>(extent[order[d]]);
    wstrides[d] = static_cast<cuuint64_t>(st[order[d]] * 2);
  }
  int w_swizzle;
  if (!grad) {
    // [o][i] per tap: K-major B, rows of ch channels
    wbox[0] = p.ch;
    wbox[pos[2]] = cob;
    w_swizzle = p.ch * 2;
    p.b_atoms = 1;
    p.b_atom_bytes = 0;
    p.b_kk_bytes = 32;
    // SBO: 8 rows of ch*2 bytes, in 16-byte units; LBO unused (1)
    p.b_desc = (1ull << 16) | (static_cast<uint64_t>(p.ch) << 32) |
               (layout_of(w_swizzle) << 62);
  } else {
    // [o][i] per tap with i contiguous: MN-major B, boxes of up to 64 i
    const int inner = cob < 64 ? cob : 64;
    wbox[0] = inner;
    wbox[pos[2]] = p.ch;
    w_swizzle = inner * 2;
    p.b_atoms = cob / inner;
    p.b_atom_bytes = p.ch * inner * 2;
    p.b_kk_bytes = 16 * inner * 2;
    // LBO: from one 64-channel atom to the next; SBO: 8 rows of the atom
    const uint64_t lbo = p.b_atoms > 1 ? p.b_atom_bytes / 16 : 1;
    p.b_desc = (lbo << 16) | (static_cast<uint64_t>(inner * 2 * 8 / 16) << 32) |
               (layout_of(w_swizzle) << 62);
  }
  if (!encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, wdims, wstrides,
              wbox, w_swizzle))
    return cudaErrorInvalidValue;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return grad ? launch_cob<true>(p, xmap, wmap, smem, s)
              : launch_cob<false>(p, xmap, wmap, smem, s);
}

}  // namespace

extern "C" {

// x: (N, H, W, Ci) bf16 with element strides xs_{n,h,w,c} (xs_c == 1); w:
// (K, K, Ci, Co) bf16 with element strides ws_{r,c,i,o} (ws_i == 1); Ci a
// multiple of 8, the other strides positive multiples of 8 and the bases
// 16-byte aligned; bias: (Co,) contiguous or NULL; out: (N, H, W, Co)
// contiguous. tile_h: output rows per block (4, 8, or 16 for Co <= 32);
// split: blocks per output tile over the reduction, with workspace
// (split, N, H, W, Co) f32 when split > 1. dtype must be 1 (bfloat16).
// Returns a cudaError_t value; 0 means launched.
int same_conv_wgmma_forward(const void* x, const void* w, const void* bias,
                            void* out, int dtype, int N, int H, int W,
                            int Ci, int Co, int K, int64_t xs_n,
                            int64_t xs_h, int64_t xs_w, int64_t xs_c,
                            int64_t ws_r, int64_t ws_c, int64_t ws_i,
                            int64_t ws_o, int tile_h, int split,
                            void* workspace, void* stream) {
  return conv_entry(false, x, w, bias, out, dtype, N, H, W, Ci, Co, K, xs_n,
                    xs_h, xs_w, xs_c, ws_r, ws_c, ws_i, ws_o, tile_h, split,
                    workspace, stream);
}

// Grad-input of same_conv_wgmma_forward. ct: (N, H, W, Co) bf16 with
// element strides cs_{n,h,w,c} (cs_c == 1, Co a multiple of 8); w: the
// forward's (K, K, Ci, Co) weight with element strides ws_{r,c,i,o}
// (ws_i == 1, Ci a multiple of 8); dx: (N, H, W, Ci) contiguous. The
// flipped, channel-swapped weight is read through the tensor map's
// coordinates (no copy). Other arguments as above.
int same_conv_wgmma_grad_input(const void* ct, const void* w, void* dx,
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

}  // extern "C"
