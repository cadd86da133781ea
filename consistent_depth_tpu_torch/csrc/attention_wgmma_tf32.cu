// f32 attention of a ViT block for Hopper (sm_90a) in 3xTF32 on wgmma, a
// flash attention whose scores never leave the chip: the forward
//
//   O = softmax(Q K^T / 8) V,   lse = log of each row's sum of exp (natural)
//
// and its backward from the forward's O and lse (ops/transformer.py,
// _Attention), for a head width d of 64 (every DINOv2 backbone's) or 32
// (the small networks of the tests).
//
// Replaces no TPU kernel: the JAX package has no transformer. It was added
// for dav2-large's attention (models/vit.py, 24 blocks of 16 heads over
// 2,332 tokens), which the library's memory-efficient kernel ran in 3xTF32
// on mma.sync (64 x 64 tiles, no TMA, no wgmma) at ~17% of the bound below:
// ~460 ms of a ~1,030 ms fine-tune step on an H100.
//
// What bounds it: operations, 4 B H L^2 d FLOP forward and twice that
// backward, at the tensor cores' TF32 rate (495 TFLOP/s dense) over three
// products per product, 165 TFLOP/s; the bytes (Q, K, V, O, dO and the
// gradients once) are ~1% of that time. Every operand v is split into big =
// tf32(v), small = tf32(v - big) (nearest, ties away, as cvt.rna) and each
// product is big*big + big*small + small*big, as in linear_wgmma_tf32.cu.
// What the design does:
//   - every product is wgmma.mma_async m64n64k8 TF32 with A from registers
//     ("RS") and B a K-major operand of 64 rows x 64 reduction elements in
//     shared memory: two TF32 planes (big, small), each two TMA boxes of 32
//     elements (128-byte rows, 128-byte swizzle). A is split in registers as
//     it is loaded (but dS, read from its planes); B is split beforehand;
//   - TF32 wgmma reads both operands K-major only. What reaches the kernel
//     K-major (q, k, v and dO rows of d) is read as it lies, q and dO
//     straight from the caller's strided views by TMA; a product whose B
//     would be MN-major takes a transposed copy made once a call by
//     attention_tf32_split, inside the span, and freed with it (V^T for P V,
//     K^T for dQ = dS K), as are K's and V's planes; where the transposed
//     operand can be A instead, it is read MN-major by 32-bit loads (dO^T
//     for dV^T = dO^T P and Q^T for dK^T = Q^T dS from the raw tiles, dS for
//     dQ from its split planes), the fragment's rows mapped onto the swizzle
//     so that no two lanes meet in a bank (linear_wgmma_tf32.cu's tile_row);
//   - the forward's P reaches P V from the accumulator's registers. An
//     accumulator holds columns 2t, 2t+1 of each 8 where the TF32 A fragment
//     wants t, t+4; the reduction's order does not matter, so V^T holds its
//     keys in the order 0 2 4 6 1 3 5 7 within each 8, and the accumulator
//     is the fragment as it is. In the backward P and dS are B operands (of
//     dV^T and dK^T): a warpgroup stores each split, transposed, into a 32 KB
//     buffer of its own in the swizzled layout;
//   - the tensor cores add into their f32 sum by truncation, so no chain is
//     longer than 4 k8 steps (12 products): each 64-wide reduction is two
//     chains added on the FP32 pipes, and the sums over key or query tiles
//     (O, dV, dK) are f32 adds too. With single chains of 24 the backward's
//     gradients lay 1.8-2.8x further from f64 than the library's;
//   - softmax in f32: scores scaled by 1/sqrt(d) (1/8, exact, at 64), exp2
//     of (x - max) log2 e,
//     the running max and sum per row (FlashAttention 2's online softmax);
//     keys past L are -inf before the max, rows past L are read as zeros
//     (TMA's fill) and never written;
//   - forward: a block is 128 queries of one (batch, head), two consumer
//     warpgroups of 64 rows, Q as it lies in shared memory (32 KB); a
//     producer warp streams K's planes and V^T's planes, 64 keys a stage,
//     through a ring of 3 stages of 64 KB (224 KB a block). It writes O in
//     the (B, L, H, d) layout the library's kernel writes, and lse (B, H, L)
//     f32;
//   - backward: a block is 64 keys of one (batch, head): K's and V's planes
//     and K^T's planes stay in shared memory (96 KB); the two warpgroups
//     take query tiles of 64 in turn, each with its own dO and Q tiles (16
//     KB each) and its own P/dS buffer, and each issues its own copies: with
//     no producer warp the block is two warpgroups, whose threads may hold
//     255 registers (the compiler allots registers to whole warpgroups; at
//     the 168 of three it spilled and serialised the wgmmas). A tile: S =
//     Q K^T, dP = dO V^T, P = exp2(S/8 - lse), dS = P (dP - D) / 8 with D =
//     rowsum(dO o O) from attention_rowdot; dS stored, dQ = dS K, dK^T +=
//     Q^T dS; the next tile's Q requested; P stored, dV^T += dO^T P; the
//     next tile's dO requested, so that each copy runs under a product.
//     dQ goes to an f32 (B, H, L, d) sum by atomic adds of pairs
//     (FlashAttention 2's choice: two calls may differ in dQ's last bits;
//     dK and dV are bitwise repeatable); each warpgroup's dK and dV sums
//     are added in shared memory at the end and written once;
//   - a head width of 32 runs the same tiles of 64: every TMA read of q, dO,
//     K's and V's planes past column 32 (or row 32 of a transposed plane)
//     is filled with zeros, which add nothing to the sums, and the outputs'
//     columns (or, for dK^T and dV^T, rows) past 32 are not written. It
//     costs the operations of a width of 64, and keeps one design for both
//     (D, a template parameter of the two kernels).
//
// The kernels allocate nothing, launch on the caller's stream and do not
// synchronise. The C entries return cudaGetLastError() after the launches,
// or cudaErrorInvalidValue for arguments they do not take.

#include "same_conv_wgmma.cuh"

namespace {

constexpr int HD = 64;            // the tiles' head width, the widest taken
constexpr int TILE = 64;          // a consumer's rows; a stage's keys
constexpr int BOX = TILE * 128;   // a TMA box: 64 rows of 32 f32 (128 B)
constexpr int RAW = 2 * BOX;      // a 64 x 64 tile as it lies: two boxes
constexpr int OPERAND = 4 * BOX;  // a B operand: two planes of two boxes
constexpr int FWD_STAGES = 3;
// forward: two consumer warpgroups, then one producer warp; backward: two
// warpgroups that issue their own copies, so that the compiler may give a
// thread 255 registers (it allots registers to whole warpgroups: 168 for
// three)
constexpr int THREADS = 288;
constexpr int BWD_THREADS = 256;
constexpr int FWD_BARS = 1 + 2 * FWD_STAGES;
constexpr int BWD_BARS = 5;
constexpr int FWD_SMEM =
    ALIGN + 2 * RAW + FWD_STAGES * 2 * OPERAND + 8 * FWD_BARS;
constexpr int BWD_SMEM = ALIGN + 3 * OPERAND + 2 * (2 * RAW + OPERAND) +
                         8 * BWD_BARS;
static_assert(FWD_SMEM <= SMEM_LIMIT, "forward exceeds shared memory");
static_assert(BWD_SMEM <= SMEM_LIMIT, "backward exceeds shared memory");
// 1 / sqrt(D) in f32
template <int D>
__device__ __forceinline__ constexpr float scale() {
  return D == 64 ? 0.125f : 0.17677669529663688f;
}
constexpr float LOG2E = 1.4426950408889634f;
// B's descriptor, start address 0: K-major, 128-byte swizzle (1 << 62);
// stride between 8-row groups 1024 bytes; leading offset unused (1)
constexpr uint64_t B_DESC = (1ull << 16) | (64ull << 32) | (1ull << 62);

// where a (B, H, L, d) view's L, H and B went among its map's dimensions
struct View {
  int pl, ph, pb;
};

struct Fwd {
  float* out;           // out[b * o_sb + h * o_sh + q * o_sl + d]
  float* lse;           // (B H, L)
  int64_t o_sb, o_sh, o_sl;
  int H, L, nk;         // nk: key tiles
  View q;
};

struct Bwd {
  const float* lse;     // (B H, L)
  const float* dsum;    // (B H, L): rowsum(dO o O)
  float* dq;            // (B H, L, d), zeroed: the atomic sums
  float* dk;            // (B H, L, d)
  float* dv;            // (B H, L, d)
  int H, L, nq;         // nq: query tiles
  View q, g;
};

// v rounded to TF32 as cvt.rna.tf32.f32 rounds it, by two integer
// instructions, bit for bit as linear_wgmma_tf32.cu's split
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

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// the threads of named barrier `id` (a warpgroup, or both consumers)
__device__ __forceinline__ void sync_threads_of(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// this thread's shared-memory stores made visible to wgmma's reads
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma.mma_async m64n64k8, f32 += tf32 x tf32, A from registers (the
// m16n8k8 TF32 A fragment of each warp's 16 rows), B K-major through its
// descriptor; scale 0 ignores d's old value
__device__ __forceinline__ void mma64(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t desc_b, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale));
}

// the descriptor of a B operand's plane (0 big, 1 small) at k8 step kk
__device__ __forceinline__ uint64_t desc_of(uint32_t operand, int plane,
                                            int kk) {
  const uint32_t addr =
      operand + plane * 2 * BOX + (kk >> 2) * BOX + (kk & 3) * 32;
  return B_DESC | ((addr & 0x3FFFF) >> 4);
}

// step kk's three products onto acc, restarting it where `fresh`
__device__ __forceinline__ void issue(float (&acc)[32], uint32_t (&ab)[4],
                                      uint32_t (&as)[4], uint32_t operand,
                                      int kk, bool fresh) {
  const uint64_t big = desc_of(operand, 0, kk);
  const uint64_t small = desc_of(operand, 1, kk);
  // the split's results are registers like any: pin them before the fence,
  // or the compiler may compute them after it
  fence_acc(acc);
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(ab[e]), "+r"(as[e]));
  wgmma_fence();
  mma64(acc, ab, big, fresh ? 0 : 1);
  mma64(acc, ab, small, 1);
  mma64(acc, as, big, 1);
  wgmma_commit();
}

// The sum over the 8 k8 steps of a 64-wide reduction of A B in 3xTF32 as
// two chains, steps 0-3 into x and 4-7 into y, each restarted, which the
// caller adds on the FP32 pipes. load(kk, big, small) gives A's fragment of
// step kk split; step kk + 1's is loaded while step kk runs, into the other
// of two register buffers
template <typename Load>
__device__ __forceinline__ void product2(float (&x)[32], float (&y)[32],
                                        uint32_t operand, Load load) {
  uint32_t ab[2][4], as[2][4];
  load(0, ab[0], as[0]);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int c = kk & 1;
    if (kk < 4)
      issue(x, ab[c], as[c], operand, kk, kk == 0);
    else
      issue(y, ab[c], as[c], operand, kk, kk == 4);
    if (kk < 7) {
      wgmma_wait<1>();
      load(kk + 1, ab[c ^ 1], as[c ^ 1]);
    }
  }
  wgmma_wait<0>();
  fence_acc(x);
  fence_acc(y);
}

// A's fragments from a raw 64 x 64 tile (rows of the product, the head
// width as the reduction): one ldmatrix.x4.b16 a k8 step
struct KMajor {
  uint32_t tile, row_off, swz, half;
  __device__ __forceinline__ KMajor(uint32_t raw, int warp, int lane) {
    const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    tile = raw;
    row_off = row * 128;
    swz = (row & 7) << 4;
    half = (lane >> 4) * 16;
  }
  __device__ __forceinline__ void operator()(int kk, uint32_t (&big)[4],
                                             uint32_t (&small)[4]) const {
    uint32_t v[4];
    ldsm4(v, tile + (kk >> 2) * BOX + row_off + (((kk & 3) * 32 + half) ^ swz));
#pragma unroll
    for (int e = 0; e < 4; ++e) split(v[e], big[e], small[e]);
  }
};

// The row of a 64-row accumulator that a warp's fragment row g + 8h holds
// when A is read MN-major: 16-byte chunk 2 (warp & 1) + h + 4 (g >> 2) of
// box warp / 2, element g & 3, so that a fragment load's 32 lanes fall in
// 32 banks under the swizzle
__device__ __forceinline__ int mn_row(int warp, int g, int h) {
  return (warp >> 1) * 32 + 4 * (2 * (warp & 1) + h + 4 * (g >> 2)) + (g & 3);
}

// A's fragments read MN-major from a raw 64 x 64 tile (A[m][k] =
// tile[k][m]: the tile's rows are the reduction, its head width the
// product's rows, mapped by mn_row): four 32-bit loads a k8 step
struct MNMajor {
  uint32_t off[4];
  __device__ __forceinline__ MNMajor(uint32_t raw, int warp, int g, int t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = mn_row(warp, g, e & 1);
      const int k = t + 4 * (e >> 1);
      off[e] = raw + (m >> 5) * BOX + k * 128 + ((((m & 31) >> 2) ^ k) << 4) +
               (m & 3) * 4;
    }
  }
  __device__ __forceinline__ void operator()(int kk, uint32_t (&big)[4],
                                             uint32_t (&small)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split(lds32(off[e] + kk * 8 * 128), big[e], small[e]);
  }
};

// A's fragments read MN-major, as MNMajor reads them, from a B operand's
// planes already split (dS, stored by store_transposed: A[m][k] = dS's
// plane[k][m])
struct MNPlanes {
  MNMajor at;
  __device__ __forceinline__ MNPlanes(uint32_t operand, int warp, int g,
                                      int t)
      : at(operand, warp, g, t) {}
  __device__ __forceinline__ void operator()(int kk, uint32_t (&big)[4],
                                             uint32_t (&small)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      big[e] = lds32(at.off[e] + kk * 8 * 128);
      small[e] = lds32(at.off[e] + kk * 8 * 128 + 2 * BOX);
    }
  }
};

// A's fragments from an accumulator's registers (P, dS): columns 2t, 2t+1
// of chunk kk are the fragment's k = t, t + 4 (the B operand holds its keys
// in that order)
struct FromAcc {
  const float (&v)[32];
  __device__ __forceinline__ void operator()(int kk, uint32_t (&big)[4],
                                             uint32_t (&small)[4]) const {
    split(__float_as_uint(v[4 * kk]), big[0], small[0]);
    split(__float_as_uint(v[4 * kk + 2]), big[1], small[1]);
    split(__float_as_uint(v[4 * kk + 1]), big[2], small[2]);
    split(__float_as_uint(v[4 * kk + 3]), big[3], small[3]);
  }
};

// An accumulator v (rows: the warpgroup's 64 queries in order; columns: 64
// keys) stored split as a B operand whose rows are the keys and whose
// reduction runs over the queries
__device__ __forceinline__ void store_transposed(uint32_t operand,
                                                 const float (&v)[32],
                                                 int warp, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = warp * 16 + g + 8 * h;
        const int key = 8 * j + 2 * t + e;
        const uint32_t at = operand + (q >> 5) * BOX + key * 128 +
                            ((((q & 31) >> 2) ^ (key & 7)) << 4) + (q & 3) * 4;
        uint32_t big, small;
        split(__float_as_uint(v[4 * j + 2 * h + e]), big, small);
        sts32(at, big);
        sts32(at + 2 * BOX, small);
      }
}

// a box of 32 head-width elements by 64 rows from row `row` of a view
__device__ __forceinline__ void load_view(uint32_t dst, const CUtensorMap* map,
                                          const View& v, uint32_t bar,
                                          int d0, int row, int h, int b) {
  auto at = [&](int dim) { return v.pl == dim ? row : v.ph == dim ? h : b; };
  tma_load_4d(dst, map, bar, d0, at(1), at(2), at(3));
}

// a B operand's four boxes: K-major planes (2, B H, L, d) from key
// `key0`, or transposed planes (2, B H, d, lp) from key `key0`
__device__ __forceinline__ void load_operand(uint32_t dst,
                                             const CUtensorMap* map,
                                             uint32_t bar, bool transposed,
                                             int key0, int bh) {
#pragma unroll
  for (int plane = 0; plane < 2; ++plane)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t at = dst + plane * 2 * BOX + half * BOX;
      if (transposed)
        tma_load_4d(at, map, bar, key0 + 32 * half, 0, bh, plane);
      else
        tma_load_4d(at, map, bar, 32 * half, key0, bh, plane);
    }
}

// dst[0] += a, dst[1] += b in device memory, atomically, as one vector add
// (sm_90; dst 8-byte aligned)
__device__ __forceinline__ void add_pair(float* dst, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(a, b));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// -- the forward --------------------------------------------------------------

// Block (query tile of 128, b h): warpgroups 0 and 1 consume 64 query rows
// each, warp 8 produces (one thread issues every copy); D the head width
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
attention_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const Fwd p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + ALIGN - 1) & ~(ALIGN - 1);
  const uint32_t ring = qs + 2 * RAW;   // stages: K's planes, V^T's planes
  const uint32_t qfull = ring + FWD_STAGES * 2 * OPERAND;
  const uint32_t full = qfull + 8;
  const uint32_t empty = full + 8 * FWD_STAGES;
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.x * 2 * TILE;
  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int i = 0; i < FWD_STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 8);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 2) {
    if (tid != 256) return;
    mbar_expect_tx(qfull, 2 * RAW);
    for (int w = 0; w < 2; ++w)
      for (int half = 0; half < 2; ++half)
        load_view(qs + w * RAW + half * BOX, &qmap, p.q, qfull, 32 * half,
                  q0 + TILE * w, h, b);
    int slot = 0;
    uint32_t ph = 0;
    for (int kt = 0; kt < p.nk; ++kt) {
      mbar_wait_one(empty + 8 * slot, ph ^ 1);
      const uint32_t bar = full + 8 * slot;
      mbar_expect_tx(bar, 2 * OPERAND);
      const uint32_t kop = ring + slot * 2 * OPERAND;
      load_operand(kop, &kmap, bar, false, kt * TILE, bh);
      load_operand(kop + OPERAND, &vmap, bar, true, kt * TILE, bh);
      if (++slot == FWD_STAGES) {
        slot = 0;
        ph ^= 1;
      }
    }
    return;
  }

  // -- consumers --------------------------------------------------------------
  const int wg = role;
  const int warp = __shfl_sync(0xffffffffu, (tid >> 5) & 3, 0);
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const KMajor load_q(qs + wg * RAW, warp, lane);

  float o[32], s[32], x[32], y[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait_warp(qfull, 0);
  int slot = 0;
  uint32_t ph = 0;
  for (int kt = 0; kt < p.nk; ++kt) {
    mbar_wait_warp(full + 8 * slot, ph);
    const uint32_t kop = ring + slot * 2 * OPERAND;
    product2(s, x, kop, load_q);

    // the tile's scores over 8, keys past L at -inf; the rows' new max
    const int key0 = kt * TILE + 2 * t;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          float v = (s[i] + x[i]) * scale<D>();
          if (key0 + 8 * j + e >= p.L) v = -INFINITY;
          s[i] = v;
          mx[r] = fmaxf(mx[r], v);
        }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f((m[r] - mx[r]) * LOG2E);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp2f((s[i] - m[r]) * LOG2E);
      l[r] += s[i];
    }

    product2(x, y, kop + OPERAND, FromAcc{s});
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = o[i] * alpha[(i >> 1) & 1] + (x[i] + y[i]);
    if (lane == 0) mbar_arrive(empty + 8 * slot);
    if (++slot == FWD_STAGES) {
      slot = 0;
      ph ^= 1;
    }
  }

  // -- epilogue: O over each row's sum, lse = max + log(sum)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    const int q = q0 + TILE * wg + warp * 16 + g + 8 * r;
    if (q >= p.L) continue;
    const float inv = 1.f / sum;
    float* dst = p.out + b * p.o_sb + h * p.o_sh + q * p.o_sl + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (t == 0)
      p.lse[static_cast<int64_t>(bh) * p.L + q] = m[r] + logf(sum);
  }
}

// -- the backward -------------------------------------------------------------

// Block (key tile of 64, b h): warpgroups w = 0, 1 take query tiles w,
// w + 2, ...; each one's first thread issues its own copies (and warpgroup
// 0's the block's K, V and K^T planes), so that the block is two
// warpgroups, whose threads may hold 255 registers. A tile: S and dP; dS
// stored, dQ and dK^T from it, and Q's buffer refilled with the next tile's
// while P is stored and dV^T computed; then dO's buffer refilled while the
// next tile's S is computed; D the head width
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
attention_bwd_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap gmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap ktmap, const Bwd p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t kop = (smem_u32(smem_raw) + ALIGN - 1) & ~(ALIGN - 1);
  const uint32_t vop = kop + OPERAND;
  const uint32_t ktop = vop + OPERAND;
  const uint32_t own = ktop + OPERAND;   // per consumer: dO, Q, P/dS
  constexpr int OWN = 2 * RAW + OPERAND;
  const uint32_t bars = own + 2 * OWN;
  const uint32_t stat = bars;
  const uint32_t gfull = bars + 8, qfull = bars + 24;
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int k0 = blockIdx.x * TILE;
  if (tid == 0) {
    mbar_init(stat, 1);
    for (int w = 0; w < 2; ++w) {
      mbar_init(gfull + 8 * w, 1);
      mbar_init(qfull + 8 * w, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int w = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, (tid >> 5) & 3, 0);
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool leader = (tid & 127) == 0;
  const uint32_t gs = own + w * OWN, qs = gs + RAW, buf = qs + RAW;
  const int bar_id = 1 + w;
  // tile qt's dO or Q into this warpgroup's buffer
  auto load_tile = [&](const CUtensorMap* map, const View& v, uint32_t dst,
                       uint32_t bar, int qt) {
    mbar_expect_tx(bar, RAW);
    for (int half = 0; half < 2; ++half)
      load_view(dst + half * BOX, map, v, bar, 32 * half, qt * TILE, h, b);
  };
  if (leader) {
    if (w == 0) {
      mbar_expect_tx(stat, 3 * OPERAND);
      load_operand(kop, &kmap, stat, false, k0, bh);
      load_operand(vop, &vmap, stat, false, k0, bh);
      load_operand(ktop, &ktmap, stat, true, k0, bh);
    }
    if (w < p.nq) {
      load_tile(&qmap, p.q, qs, qfull + 8 * w, w);
      load_tile(&gmap, p.g, gs, gfull + 8 * w, w);
    }
  }
  const KMajor load_g(gs, warp, lane), load_q(qs, warp, lane);
  const MNMajor load_gt(gs, warp, g, t), load_qt(qs, warp, g, t);
  const MNPlanes load_ds(buf, warp, g, t);
  const int64_t rows = static_cast<int64_t>(bh) * p.L;

  float dv[32], dk[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dv[e] = dk[e] = 0.f;
  mbar_wait_warp(stat, 0);
  uint32_t ph = 0;
  for (int qt = w; qt < p.nq; qt += 2, ph ^= 1) {
    const int q0 = qt * TILE + warp * 16 + g;   // the accumulators' rows
    float lse[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + 8 * r;
      lse[r] = q < p.L ? p.lse[rows + q] : INFINITY;
      dd[r] = q < p.L ? p.dsum[rows + q] : 0.f;
    }
    float s[32], dp[32], x[32];
    mbar_wait_warp(qfull + 8 * w, ph);
    product2(s, x, kop, load_q);               // S = Q K^T
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] += x[i];
    mbar_wait_warp(gfull + 8 * w, ph);
    product2(dp, x, vop, load_g);              // dP = dO V^T
    // P = exp(S / 8 - lse), keys past L at 0; dS = P (dP - D) / 8
    const int key0 = k0 + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          const float v = exp2f((s[i] * scale<D>() - lse[r]) * LOG2E);
          const float pr = key0 + 8 * j + e < p.L ? v : 0.f;
          s[i] = pr;
          dp[i] = scale<D>() * pr * (dp[i] + x[i] - dd[r]);
        }

    // the buffer is free: every warp's dV^T of the last tile is complete
    store_transposed(buf, dp, warp, g, t);
    fence_to_async();
    sync_threads_of(bar_id, 128);
    product2(dp, x, ktop, load_ds);            // dQ = dS K
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = qt * TILE + mn_row(warp, g, r);
      if (q >= p.L) continue;
      float* dst = p.dq + (rows + q) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        add_pair(dst + 8 * j, dp[4 * j + 2 * r] + x[4 * j + 2 * r],
                 dp[4 * j + 2 * r + 1] + x[4 * j + 2 * r + 1]);
    }
    product2(dp, x, buf, load_qt);             // dK^T += Q^T dS
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] += dp[i] + x[i];

    // every warp is done with Q and dS: the next tile's Q comes meanwhile
    sync_threads_of(bar_id, 128);
    if (leader && qt + 2 < p.nq)
      load_tile(&qmap, p.q, qs, qfull + 8 * w, qt + 2);
    store_transposed(buf, s, warp, g, t);
    fence_to_async();
    sync_threads_of(bar_id, 128);
    product2(s, x, buf, load_gt);              // dV^T += dO^T P
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[i] += s[i] + x[i];
    // every warp is done with dO and P
    sync_threads_of(bar_id, 128);
    if (leader && qt + 2 < p.nq)
      load_tile(&gmap, p.g, gs, gfull + 8 * w, qt + 2);
  }

  // -- epilogue: warpgroup 1 hands its sums to warpgroup 0 through its own
  // buffer (element e of thread i at e * 128 + i), which adds and writes.
  // Accumulator element 4j + 2r + e: head-width row mn_row(warp, g, r), key
  // 8j + 2t + e
  const int i0 = tid & 127;
  const uint32_t hand = own + OWN + 2 * RAW;
  if (w == 1) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      sts32(hand + (e * 128 + i0) * 4, __float_as_uint(dv[e]));
      sts32(hand + ((32 + e) * 128 + i0) * 4, __float_as_uint(dk[e]));
    }
  }
  sync_threads_of(3, 256);
  if (w == 1) return;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    dv[e] += __uint_as_float(lds32(hand + (e * 128 + i0) * 4));
    dk[e] += __uint_as_float(lds32(hand + ((32 + e) * 128 + i0) * 4));
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + 8 * j + 2 * t + e;
      if (key >= p.L) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = mn_row(warp, g, r);
        if (row >= D) continue;
        const int64_t at = (rows + key) * D + row;
        p.dv[at] = dv[4 * j + 2 * r + e];
        p.dk[at] = dk[4 * j + 2 * r + e];
      }
    }
}

// -- the passes beside them ---------------------------------------------------

// The TF32 planes (big, small) of a (B, H, L, d) tensor src (element
// strides s_b, s_h, s_l; the head width contiguous): K-major `rows` (2, B H,
// L, d), and transposed `cols` (2, B H, d, lp), zero from L to lp, where
// `permute` keys 8G + (0 2 4 6 1 3 5 7) at 8G + (0 ... 7) (the order in
// which an accumulator gives P as an A fragment). Either may be null.
// Block: 256 threads, 64 keys of one (b, h)
__global__ void split_kernel(const float* __restrict__ src, int64_t s_b,
                             int64_t s_h, int64_t s_l, int H, int L, int d,
                             int lp, float* __restrict__ rows,
                             float* __restrict__ cols, int permute) {
  __shared__ float tile[TILE][HD + 1];
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * TILE;
  const int64_t bhs = gridDim.y;
  const float* base = src + b * s_b + h * s_h;
  const int shift = d == 64 ? 6 : 5;   // d is 64 or 32
  for (int i = threadIdx.x; i < TILE * d; i += blockDim.x) {
    const int r = i >> shift, c = i & (d - 1);
    const int key = k0 + r;
    const float v = key < L ? base[key * s_l + c] : 0.f;
    tile[r][c] = v;
    if (rows != nullptr && key < L) {
      uint32_t big, small;
      split(__float_as_uint(v), big, small);
      const int64_t at = (static_cast<int64_t>(bh) * L + key) * d + c;
      rows[at] = __uint_as_float(big);
      rows[bhs * L * d + at] = __uint_as_float(small);
    }
  }
  if (cols == nullptr) return;
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * d; i += blockDim.x) {
    const int c = i / TILE, kp = i % TILE;
    const int key = k0 + kp;
    if (key >= lp) continue;
    const int q = kp & 7;
    const int from =
        permute ? (kp & ~7) | (q < 4 ? 2 * q : 2 * (q - 4) + 1) : kp;
    uint32_t big, small;
    split(__float_as_uint(tile[from][c]), big, small);
    const int64_t at = (static_cast<int64_t>(bh) * d + c) * lp + key;
    cols[at] = __uint_as_float(big);
    cols[bhs * d * lp + at] = __uint_as_float(small);
  }
}

// dsum[b h, q] = sum over the head width d of o[b, h, q] g[b, h, q]
// (element strides of each (B, H, L, d) view given, the head width
// contiguous and 8-byte aligned); a warp a row
__global__ void rowdot_kernel(const float* __restrict__ o, int64_t o_sb,
                              int64_t o_sh, int64_t o_sl,
                              const float* __restrict__ g, int64_t g_sb,
                              int64_t g_sh, int64_t g_sl,
                              float* __restrict__ dsum, int H, int L, int d,
                              int64_t count) {
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= count) return;
  const int64_t bh = r / L, q = r - bh * L;
  const int64_t b = bh / H, h = bh - b * H;
  float v = 0.f;
  if (2 * lane < d) {
    const float2 a = *reinterpret_cast<const float2*>(
        o + b * o_sb + h * o_sh + q * o_sl + 2 * lane);
    const float2 c = *reinterpret_cast<const float2*>(
        g + b * g_sb + h * g_sh + q * g_sl + 2 * lane);
    v = a.x * c.x + a.y * c.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) dsum[r] = v;
}

// -- host ---------------------------------------------------------------------

// A (B, H, L, d) f32 view with element strides (sb, sh, sl, 1) as a 4-D
// map of boxes of 32 head-width elements by 64 rows of L (past d, TMA fills
// zeros); its dimensions past the head width are L, H and B in order of
// stride, and v says where each went
bool encode_view(CUtensorMap* map, const void* ptr, int B, int H, int L,
                 int d, int64_t sb, int64_t sh, int64_t sl, View& v) {
  struct Dim {
    int64_t stride;
    int size, which;
  } dm[3] = {{sl, L, 0}, {sh, H, 1}, {sb, B, 2}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j + 1 < 3 - i; ++j)
      if (dm[j].stride > dm[j + 1].stride) {
        const Dim tmp = dm[j];
        dm[j] = dm[j + 1];
        dm[j + 1] = tmp;
      }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), 1, 1, 1};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {32, 1, 1, 1};
  int pos[3];
  for (int i = 0; i < 3; ++i) {
    dims[1 + i] = static_cast<cuuint64_t>(dm[i].size);
    strides[i] = static_cast<cuuint64_t>(dm[i].stride) * 4;
    box[1 + i] = dm[i].which == 0 ? TILE : 1;
    pos[dm[i].which] = 1 + i;
  }
  v.pl = pos[0];
  v.ph = pos[1];
  v.pb = pos[2];
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, dims, strides,
                box, 128);
}

// the planes of attention_tf32_split: K-major (2, B H, L, d), or
// transposed (2, B H, d, lp); boxes of 32 by 64 (past d, zeros)
bool encode_planes(CUtensorMap* map, const void* ptr, int BH, int L, int d,
                   int lp, bool transposed) {
  const cuuint64_t inner = transposed ? lp : d;
  const cuuint64_t outer = transposed ? d : L;
  const cuuint64_t dims[4] = {inner, outer, static_cast<cuuint64_t>(BH), 2};
  const cuuint64_t strides[3] = {inner * 4, inner * outer * 4,
                                 inner * outer * BH * 4};
  const cuuint32_t box[4] = {32, TILE, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, dims, strides,
                box, 128);
}

bool strides_ok(int64_t sb, int64_t sh, int64_t sl) {
  return sb > 0 && sh > 0 && sl > 0 && sb % 4 == 0 && sh % 4 == 0 &&
         sl % 4 == 0;
}

// the head widths taken: 64, and 32 (a template instance of each kernel)
bool shape_ok(int B, int H, int L, int d, int lp) {
  return B > 0 && H > 0 && L > 0 && static_cast<int64_t>(B) * H <= 65535 &&
         (d == 64 || d == 32) && lp % 8 == 0 && lp >= L && lp < L + 8;
}

template <int D>
cudaError_t launch_forward(const CUtensorMap& qmap, const CUtensorMap& kmap,
                           const CUtensorMap& vmap, const Fwd& p, int BH,
                           cudaStream_t stream) {
  static int granted = 0;
  const cudaError_t e = grant_smem(attention_fwd_kernel<D>, FWD_SMEM, granted);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.L + 2 * TILE - 1) / (2 * TILE), BH);
  attention_fwd_kernel<D><<<grid, THREADS, FWD_SMEM, stream>>>(qmap, kmap,
                                                                vmap, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_backward(const CUtensorMap& qmap, const CUtensorMap& gmap,
                            const CUtensorMap& kmap, const CUtensorMap& vmap,
                            const CUtensorMap& ktmap, const Bwd& p, int BH,
                            cudaStream_t stream) {
  static int granted = 0;
  const cudaError_t e = grant_smem(attention_bwd_kernel<D>, BWD_SMEM, granted);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.nq, BH);
  attention_bwd_kernel<D><<<grid, BWD_THREADS, BWD_SMEM, stream>>>(
      qmap, gmap, kmap, vmap, ktmap, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The TF32 planes of a (B, H, L, d) f32 tensor src (element strides s_b,
// s_h, s_l, the last 1): rows (2, B H, L, d) K-major, cols (2, B H, d, lp)
// transposed, lp = L rounded up to 8, zero past L; with permute != 0 its
// keys in the order in which the forward's accumulator gives P (V^T for the
// forward; K^T for the backward is in order). Either output may be NULL.
// Returns a cudaError_t value.
int attention_tf32_split(const void* src, int64_t s_b, int64_t s_h,
                         int64_t s_l, int B, int H, int L, int d, void* rows,
                         void* cols, int lp, int permute, void* stream) {
  if (!shape_ok(B, H, L, d, lp) || (rows == nullptr && cols == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((L + TILE - 1) / TILE, B * H);
  split_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), s_b, s_h, s_l, H, L, d, lp,
      static_cast<float*>(rows), static_cast<float*>(cols), permute);
  return cudaGetLastError();
}

// O and lse of softmax(Q K^T / sqrt(d)) V over a head width d of 64 or 32.
// q: (B, H, L, d) f32 with element strides q_sb, q_sh, q_sl (multiples of
// 4, the last 1), 16-byte aligned; kplanes: attention_tf32_split's rows of
// K; vtplanes: its cols of V, permuted; out: element strides o_sb, o_sh,
// o_sl (even), the last 1; lse (B H, L) f32. Returns a cudaError_t value.
int attention_wgmma_tf32_forward(const void* q, int64_t q_sb, int64_t q_sh,
                                 int64_t q_sl, const void* kplanes,
                                 const void* vtplanes, void* out,
                                 int64_t o_sb, int64_t o_sh, int64_t o_sl,
                                 void* lse, int B, int H, int L, int d,
                                 int lp, void* stream) {
  if (!shape_ok(B, H, L, d, lp) || !strides_ok(q_sb, q_sh, q_sl) ||
      !aligned16(q) || !aligned16(kplanes) || !aligned16(vtplanes) ||
      (o_sb | o_sh | o_sl) & 1 || (reinterpret_cast<uintptr_t>(out) & 7))
    return cudaErrorInvalidValue;
  Fwd p;
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_sl = o_sl;
  p.H = H;
  p.L = L;
  p.nk = (L + TILE - 1) / TILE;
  CUtensorMap qmap, kmap, vmap;
  if (!encode_view(&qmap, q, B, H, L, d, q_sb, q_sh, q_sl, p.q) ||
      !encode_planes(&kmap, kplanes, B * H, L, d, lp, false) ||
      !encode_planes(&vmap, vtplanes, B * H, L, d, lp, true))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch_forward<64>(qmap, kmap, vmap, p, B * H, st)
                 : launch_forward<32>(qmap, kmap, vmap, p, B * H, st);
}

// dQ, dK and dV of the forward above from its lse and dsum = rowsum(dO o O)
// (attention_rowdot). q, dout: (B, H, L, d) f32 views as the forward's q;
// kplanes, vplanes: attention_tf32_split's rows of K and of V; ktplanes: its
// cols of K in order; dq: (B H, L, d) f32 zeroed (the kernel adds into it);
// dk, dv: (B H, L, d) f32. Returns a cudaError_t value.
int attention_wgmma_tf32_backward(
    const void* q, int64_t q_sb, int64_t q_sh, int64_t q_sl, const void* dout,
    int64_t g_sb, int64_t g_sh, int64_t g_sl, const void* kplanes,
    const void* vplanes, const void* ktplanes, const void* lse,
    const void* dsum, void* dq, void* dk, void* dv, int B, int H, int L,
    int d, int lp, void* stream) {
  if (!shape_ok(B, H, L, d, lp) || !strides_ok(q_sb, q_sh, q_sl) ||
      !strides_ok(g_sb, g_sh, g_sl) || !aligned16(q) || !aligned16(dout) ||
      !aligned16(kplanes) || !aligned16(vplanes) || !aligned16(ktplanes))
    return cudaErrorInvalidValue;
  Bwd p;
  p.lse = static_cast<const float*>(lse);
  p.dsum = static_cast<const float*>(dsum);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.H = H;
  p.L = L;
  p.nq = (L + TILE - 1) / TILE;
  CUtensorMap qmap, gmap, kmap, vmap, ktmap;
  if (!encode_view(&qmap, q, B, H, L, d, q_sb, q_sh, q_sl, p.q) ||
      !encode_view(&gmap, dout, B, H, L, d, g_sb, g_sh, g_sl, p.g) ||
      !encode_planes(&kmap, kplanes, B * H, L, d, lp, false) ||
      !encode_planes(&vmap, vplanes, B * H, L, d, lp, false) ||
      !encode_planes(&ktmap, ktplanes, B * H, L, d, lp, true))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d == 64
             ? launch_backward<64>(qmap, gmap, kmap, vmap, ktmap, p, B * H, st)
             : launch_backward<32>(qmap, gmap, kmap, vmap, ktmap, p, B * H,
                                   st);
}

// dsum (B H, L) f32 = the rows' dot products of o and dout, (B, H, L, d)
// f32 views (d 64 or 32) with element strides (o_sb, o_sh, o_sl), (g_sb,
// g_sh, g_sl), even, the last 1, 8-byte aligned. Returns a cudaError_t
// value.
int attention_rowdot(const void* o, int64_t o_sb, int64_t o_sh, int64_t o_sl,
                     const void* dout, int64_t g_sb, int64_t g_sh,
                     int64_t g_sl, void* dsum, int B, int H, int L, int d,
                     void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || (d != 64 && d != 32) ||
      (o_sb | o_sh | o_sl | g_sb | g_sh | g_sl) & 1 ||
      (reinterpret_cast<uintptr_t>(o) & 7) ||
      (reinterpret_cast<uintptr_t>(dout) & 7))
    return cudaErrorInvalidValue;
  const int64_t count = static_cast<int64_t>(B) * H * L;
  const int64_t blocks = (count * 32 + 255) / 256;
  rowdot_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), o_sb, o_sh, o_sl,
      static_cast<const float*>(dout), g_sb, g_sh, g_sl,
      static_cast<float*>(dsum), H, L, d, count);
  return cudaGetLastError();
}

}  // extern "C"
