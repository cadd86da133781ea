// The machinery of the wgmma convs that does not depend on the element
// type, shared by the two sources that instantiate it (one nvcc process
// each):
//   - same_conv_wgmma.cu: bf16, one wgmma.mma_async m64nNk16 per product;
//   - same_conv_wgmma_tf32.cu: f32, three wgmma.mma_async m64nNk8 TF32
//     products per product (3xTF32) on weights split beforehand.
// Both compute the stride-1, same-padding, odd-k conv as an implicit GEMM
// (M = output pixels of a tile of 16 columns, N = an output-channel block,
// K = k*k taps times the reduction channels, walked a chunk of channels and
// a tap at a time), with A read by ldmatrix from a halo tile and B from a
// ring of weight stages, both filled by TMA.
//
// What is here:
//   - the PTX wrappers: mbarriers, the 4-D tiled TMA copy, ldmatrix, the
//     wgmma fence, commit and wait, the accumulator fence;
//   - the bounded mbarrier waits: a wait that outlasts WAIT_LIMIT clocks
//     (~10 s) is a fault of the ring, not a slow copy, and traps, so that
//     the launch fails instead of hanging;
//   - the producer warp: each chunk's halo tile, by one TMA copy whose box
//     starts at (x0-p, y0-p), so that coordinates outside the tensor fill
//     with zeros (same padding and ragged channels); and a tap row's k
//     weight stages at once, lane c the tap (r, c) on its own stage, the
//     copies of a stage issued by the element type's own function;
//   - the tensor-map encode (cuTensorMapEncodeTiled from the driver through
//     cudaGetDriverEntryPoint, no link against the driver library) and a
//     small cache of encoded maps keyed by every argument of the encode;
//   - the split-K reduce kernel: the partial sums of a split reduction,
//     added in a fixed order (no atomics), plus the bias.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <mutex>
#include <type_traits>

namespace {

constexpr int TW = 16;             // output columns per tile: one warp's m16
constexpr int MAX_STAGES = 24;     // weight ring: one tap a stage
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one block
constexpr int ALIGN = 1024;        // the 128-byte swizzle's repeat
// a wait on an mbarrier that outlasts this many clocks (~10 s) is a fault
// of the ring, not a slow copy: trap, so that the launch fails
constexpr long long WAIT_LIMIT = 20000000000LL;

template <typename T>
struct Params {
  const T* bias;     // (Cn,) or null
  T* out;            // (N, H, W, Cn) contiguous
  float* ws;         // (split, N, H, W, Cn) f32 when split > 1
  int N, H, W, Cr, Cn, K, P;
  int th, tiles_w, split, steps, nwg;
  int ch, lg_nk;           // reduction channels per chunk, log2(ch / 16)
  int halo_w, halo_h, halo_bytes, halos, stage_bytes, nst;
  int a_swz;               // the halo's swizzle: XOR mask of bits 4-6
  int wpos_c, wpos_r;      // weight map dimension of c and r (o: the third)
  int b_atoms, b_atom_bytes;   // bf16 grad-input: TMA boxes of 64 channels
  uint32_t b_kk_bytes;         // B's advance per k step of wgmma
  uint64_t b_desc;             // B's descriptor, start address 0
  int flip;                    // f32: the taps read flipped (grad-input)
  uint32_t plane_bytes;        // f32: a stage's big plane, then its small
};

// -- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// one thread spins until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait_one(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > WAIT_LIMIT) __trap();
}

// a whole warp spins until the phase has completed, every lane polling
// (each its own acquire) and the warp leaving together on a vote: the
// wgmmas after it are then on a path the compiler knows is convergent
__device__ __forceinline__ void mbar_wait_warp(uint32_t bar,
                                               uint32_t parity) {
  if (__all_sync(0xffffffffu, mbar_try(bar, parity))) return;
  const long long t0 = clock64();
  while (!__all_sync(0xffffffffu, mbar_try(bar, parity)))
    if (clock64() - t0 > WAIT_LIMIT) __trap();
}

// a 4-D tiled TMA copy into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from touching the accumulators while a wgmma group
// that writes them may be in flight
template <int LEN>
__device__ __forceinline__ void fence_acc(float (&acc)[LEN]) {
#pragma unroll
  for (int i = 0; i < LEN; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// -- the block's shared memory and the producer ---------------------------

// Shared memory of a block: the halo buffers, the weight ring, then the
// mbarriers: halo full [0, 2), halo empty [2, 4), a full and an empty one
// per stage.
struct Smem {
  uint32_t halo, w, hfull, hempty, wfull, wempty;
};

template <typename P>
__device__ __forceinline__ Smem smem_layout(const P& p, const void* raw) {
  Smem s;
  s.halo = (smem_u32(raw) + ALIGN - 1) & ~(ALIGN - 1);
  s.w = s.halo + p.halos * p.halo_bytes;
  const uint32_t bars = s.w + p.nst * p.stage_bytes;
  s.hfull = bars;
  s.hempty = bars + 16;
  s.wfull = bars + 32;
  s.wempty = s.wfull + 8 * p.nst;
  return s;
}

// thread 0 sets up the barriers: one arrival (the producer's expect) fills
// a buffer, every consumer warp's arrival empties it
template <typename P>
__device__ __forceinline__ void init_barriers(const P& p, const Smem& s) {
  for (int b = 0; b < 2; ++b) {
    mbar_init(s.hfull + 8 * b, 1);
    mbar_init(s.hempty + 8 * b, 4 * p.nwg);
  }
  for (int i = 0; i < p.nst; ++i) {
    mbar_init(s.wfull + 8 * i, 1);
    mbar_init(s.wempty + 8 * i, 4 * p.nwg);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer warp issues every copy of the block's reduction steps
// [s_begin, s_end) (a step: a chunk of reduction channels by a tap row), a
// tap row at once: lane c the tap (r, c) on its own stage, whose copies
// `load_stage(dst, full, chunk, r, c)` starts (stage_tx bytes in all); the
// halo by lane 0 (halo_tx bytes). One thread's wait, expect and copy for
// each tap in turn held the consumers back.
template <typename P, typename LoadStage>
__device__ __forceinline__ void produce(const P& p, const Smem& sm,
                                        const CUtensorMap& xmap, int lane,
                                        int n, int ox0, int oy0, int s_begin,
                                        int s_end, uint32_t halo_tx,
                                        uint32_t stage_tx,
                                        LoadStage load_stage) {
  const int K = p.K;
  int hl = 0;  // halo loads so far
  auto load_halo = [&](int chunk) {
    if (lane == 0) {
      const int b = hl & 1;
      mbar_wait_one(sm.hempty + 8 * b, ((hl >> 1) & 1) ^ 1);
      mbar_expect_tx(sm.hfull + 8 * b, halo_tx);
      tma_load_4d(sm.halo + b * p.halo_bytes, &xmap, sm.hfull + 8 * b,
                  chunk * p.ch, ox0 - p.P, oy0 - p.P, n);
    }
    ++hl;
  };
  const int ch_last = (s_end - 1) / K;
  // the next chunk's halo goes out some rows into this chunk, once the
  // consumers are into it (they release the last chunk's buffer there)
  const int trigger = max(1, p.nst / (2 * K));
  load_halo(s_begin / K);
  int slot = 0;
  uint32_t ph = 0;
  bool pending = false;
  int in_chunk = 0;
  for (int s = s_begin; s < s_end; ++s) {
    const int chunk = s / K;
    const int r = s - chunk * K;
    if (s == s_begin || r == 0) {
      if (pending) load_halo(chunk);
      pending = chunk < ch_last;
      in_chunk = 0;
    }
    if (lane < K) {
      // the ring holds at least K stages: one wrap at most in a row
      int sl = slot + lane;
      uint32_t pp = ph;
      if (sl >= p.nst) {
        sl -= p.nst;
        pp ^= 1;
      }
      mbar_wait_one(sm.wempty + 8 * sl, pp ^ 1);
      const uint32_t full = sm.wfull + 8 * sl;
      mbar_expect_tx(full, stage_tx);
      load_stage(sm.w + sl * p.stage_bytes, full, chunk, r, lane);
    }
    __syncwarp();
    slot += K;
    if (slot >= p.nst) {
      slot -= p.nst;
      ph ^= 1;
    }
    if (pending && ++in_chunk == trigger) {
      load_halo(chunk + 1);
      pending = false;
    }
  }
}

// this block's reduction steps (chunk, tap row) of split sp: the sp-th of
// p.split near-equal ranges
template <typename P>
__device__ __forceinline__ void step_range(const P& p, int sp, int& s_begin,
                                           int& s_end) {
  s_begin = static_cast<int>(static_cast<int64_t>(sp) * p.steps / p.split);
  s_end = static_cast<int>(static_cast<int64_t>(sp + 1) * p.steps / p.split);
}

// -- the split-K reduce ---------------------------------------------------

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

// out = sum over the splits in order + bias, one element per thread
template <typename T>
__global__ void wgmma_split_reduce_kernel(const float* __restrict__ ws,
                                          const T* __restrict__ bias,
                                          T* __restrict__ out, int64_t count,
                                          int Cn, int split) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < count; i += stride) {
    float v = 0.f;
    for (int s = 0; s < split; ++s) v += ws[s * count + i];
    if (bias != nullptr) v += to_f32(bias[i % Cn]);
    store_f32(out + i, v);
  }
}

template <typename T>
cudaError_t launch_split_reduce(const Params<T>& p, cudaStream_t stream) {
  const int64_t count = static_cast<int64_t>(p.N) * p.H * p.W * p.Cn;
  const int blocks = static_cast<int>(
      (count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  wgmma_split_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      p.ws, p.bias, p.out, count, p.Cn, p.split);
  return cudaGetLastError();
}

// -- host ---------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

CUtensorMapSwizzle swizzle_of(int bytes) {
  return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
}

// the descriptor's layout type of a swizzle of `bytes`: 1 = 128B, 2 = 64B,
// 3 = 32B
uint64_t layout_of(int bytes) {
  return bytes == 128 ? 1 : bytes == 64 ? 2 : 3;
}

// what a tensor map encodes: the element type, the base, its sizes,
// strides, box, swizzle
struct MapKey {
  uint64_t words[14];
  bool operator==(const MapKey& o) const {
    return std::memcmp(words, o.words, sizeof(words)) == 0;
  }
};

// Encoded maps, direct-mapped by a hash of their key: a train step's
// activations come back at the same addresses from the caching allocator
// and its weights stay where they are, so a step re-encodes little. A map
// is a pure function of its key, so a hit is the map encoding would give.
constexpr int MAP_CACHE = 512;
struct MapCache {
  std::mutex lock;
  MapKey keys[MAP_CACHE];
  CUtensorMap maps[MAP_CACHE];
  bool used[MAP_CACHE] = {};
};

bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
            const cuuint64_t (&dims)[4], const cuuint64_t (&strides)[3],
            const cuuint32_t (&box)[4], int swizzle_bytes) {
  static MapCache cache;
  MapKey key;
  key.words[0] = reinterpret_cast<uintptr_t>(ptr);
  for (int i = 0; i < 4; ++i) key.words[1 + i] = dims[i];
  for (int i = 0; i < 3; ++i) key.words[5 + i] = strides[i];
  for (int i = 0; i < 4; ++i) key.words[8 + i] = box[i];
  key.words[12] = static_cast<uint64_t>(swizzle_bytes);
  key.words[13] = static_cast<uint64_t>(type);
  uint64_t h = 1469598103934665603ull;  // FNV-1a over the words
  for (uint64_t w : key.words) h = (h ^ w) * 1099511628211ull;
  const int slot = static_cast<int>(h % MAP_CACHE);
  std::lock_guard<std::mutex> guard(cache.lock);
  if (cache.used[slot] && cache.keys[slot] == key) {
    *map = cache.maps[slot];
    return true;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(swizzle_bytes),
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  cache.keys[slot] = key;
  cache.maps[slot] = *map;
  cache.used[slot] = true;
  return true;
}

// The halo's map: the (N, H, W, Cr) tensor a with element strides (xs_n,
// as_h, as_w, 1) as (C, W, H, N), a box of one chunk of p.ch channels by
// the halo tile, swizzled by the chunk's width
template <typename T>
bool encode_halo(CUtensorMap* map, CUtensorMapDataType type, const void* a,
                 int64_t xs_n, int64_t as_h, int64_t as_w,
                 const Params<T>& p) {
  constexpr int elem = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(p.Cr),
                              static_cast<cuuint64_t>(p.W),
                              static_cast<cuuint64_t>(p.H),
                              static_cast<cuuint64_t>(p.N)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(as_w * elem),
                                 static_cast<cuuint64_t>(as_h * elem),
                                 static_cast<cuuint64_t>(xs_n * elem)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(p.ch),
                             static_cast<cuuint32_t>(p.halo_w),
                             static_cast<cuuint32_t>(p.halo_h), 1};
  return encode(map, type, a, dims, strides, box, p.ch * elem);
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// Grant `kernel` `smem` bytes of dynamic shared memory where it needs more
// than the default 48 KB; `granted` keeps the largest size granted so far
template <typename Kernel>
cudaError_t grant_smem(Kernel kernel, int smem, int& granted) {
  if (smem <= 48 * 1024 || smem <= granted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) granted = smem;
  return e;
}

}  // namespace
