// FlowNetC cost volume (correlation) for Hopper (sm_90a).
//
// Replaces the TPU kernel consistent_depth_tpu/flow/correlation.py
// (_corr_kernel, launched by correlation_pallas at :116). That kernel DMAs a
// row band of a zero-padded copy of f2, with a max-displacement halo, into
// VMEM once per 8-row band and computes all D*D planes from it. The kernel
// here computes the same function directly:
//
//   out[b,y,x,(dy+r)*D + (dx+r)] =
//       (1/C) * sum_c f1[b,y,x,c] * f2[b, y + 2*dy, x + 2*dx, c]
//
// for |dy|, |dx| <= r, D = 2r+1, with f2 read as zero outside the image, in
// f32 with f32 accumulation. No padded copy of f2 is made and no shape has
// to divide a tile: out-of-image reads and ragged tiles are masked. It
// takes stride 2, r in {2, 10} and C a multiple of 4 (flow/correlation.py,
// _plan; FlowNetC's call, r = 10), and reads inputs with a unit channel
// stride and 16-byte aligned pixels (the wrapper copies any other input
// first, _aligned).
//
// What bounds it on the card: the FMA pipes. At FlowNet2's 1x56x128x256
// with r = 10 it does 1.6 GFLOP against 27 MB of compulsory device memory
// traffic (12.6 MB written, 7.3 MB read per input): 24 us on the f32 FMA
// pipes, 8 us at the memory's bandwidth. The design:
//
//   1. A register tile, for few shared loads per FMA. Lane (p = lane >> 4,
//      g = lane & 15) owns the four columns x_k = x0 + p + 2(4g + k),
//      k = 0..3, and all D displacement slots j, in acc[4][D] (84 values at
//      r = 10). Slot j reads f2 column x_k + 2(j - r) = x0 - 2r + p + 2q
//      with q = 4g + k + j, so per 4-channel quad a lane loads 4 f1 and
//      D + 3 f2 float4 values for 4*D dot4s: 28 LDS.128 for 84 dot4s
//      (336 FMAs) at r = 10. An SM serves one 128-byte wavefront per clock
//      and issues four warp-FMAs per clock; shared-memory traffic is 112
//      wavefront-clocks against 84 FMA-clocks per quad and warp, so the
//      kernel is bound by shared memory at about 75% of FMA peak.
//   2. f1 shared across dy. A block is (128-column tile, row y, b x
//      dy-group) with G = 7 warps, one per dy of the group
//      (dyi = group*G + warp); the G warps share one staged f1 chunk, so f1
//      is read ceil(D/G) times. G = 7 ran faster than 1 and 3 at FlowNet2's
//      shape on the card (PERF.md).
//   3. Overlap. A two-stage ring of CK = 16 channels filled by 16-byte
//      cp.async.cg with zero-fill (columns outside [0, W), quads at or past
//      C): chunk n+1 is in flight while chunk n is computed.
//   4. Wide output runs. Each lane writes its D results of column x_k
//      straight from registers to out[b, y, x_k, dyi*D .. dyi*D + D-1], and
//      the G warps of a block fill G*D adjacent floats of each pixel.
//
// Banded shared layout, in float4 units of 4 consecutive channels (u
// indexes the quads of a chunk, p the column parity):
//   s1[u][p][sigma(i)], i = 4g + k, sigma(i) = (i & 3)*16 + (i >> 2),
//   64 units per parity plane;
//   s2[warp][u][p][tau(q)], tau(q) = (q & 3)*QQ + (q >> 2),
//   QQ = (64 + 2r + 3) / 4, q < 64 + 2r.
// For a fixed k, or a fixed t = k + j, the 16 lanes of one parity read 16
// consecutive units, so every LDS.128 takes the 4-wavefront minimum. The
// copies give four adjacent threads the four quads of one column (64-byte
// global runs) and the eight columns of one warp instruction distinct
// 16-byte bank groups, so the cp.async stores are conflict-free as well.
// A warp whose dyi >= D, or whose f2 row y + 2(dyi - r) lies outside
// [0, H), joins every barrier and copies its share of f1, but issues no f2
// copies and no FMAs; it writes zeros (nothing for dyi >= D).
// Shared bytes per block: 2 stages x 16 ch x 4 B x (128 + G*2*(64 + 2r)),
// 166,912 B at r = 10.
// Tensor cores are left out: f32 accuracy at 1e-5 would need 3xTF32, and
// the banded product wastes about half of each MMA tile.
//
// The kernel allocates nothing, launches on the caller's stream and does
// not synchronise. The C entry returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 128;        // output columns per block
constexpr int CK = 16;         // channels per staged chunk
constexpr int NQ = CK / 4;     // float4 quads per chunk
constexpr int STEP = 2;        // the displacement step s

template <int R>
struct Band {
  static constexpr int D = 2 * R + 1;
  static constexpr int NQCOL = 64 + 2 * R;       // f2 columns per parity
  static constexpr int QQ = (NQCOL + 3) / 4;
  static constexpr int S2_PLANE = 4 * QQ;        // units per parity plane
  static constexpr int S1_UNITS = NQ * 2 * 64;   // f1 units per stage
  static constexpr int S2_UNITS = NQ * 2 * S2_PLANE;  // per warp and stage
};

template <int R, int G>
constexpr int banded_smem() {
  return 2 * 16 * (Band<R>::S1_UNITS + G * Band<R>::S2_UNITS);
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

template <int R, int G>
__global__ void __launch_bounds__(G * 32)
correlation_banded_kernel(const float* __restrict__ f1,
                          const float* __restrict__ f2,
                          float* __restrict__ out, int H, int W, int C,
                          int ngroups, int64_t f1n, int64_t f1h, int64_t f1w,
                          int64_t f2n, int64_t f2h, int64_t f2w) {
  using P = Band<R>;
  constexpr int D = P::D;
  extern __shared__ float4 smem4[];  // s1[2][S1_UNITS], s2[G][2][S2_UNITS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int p = lane >> 4;
  const int g = lane & 15;
  const int x0 = blockIdx.x * TW;
  const int y = blockIdx.y;
  const int b = blockIdx.z / ngroups;
  const int dyi = (blockIdx.z % ngroups) * G + warp;
  const int y2 = y + STEP * (dyi - R);
  const bool active = dyi < D && y2 >= 0 && y2 < H;  // uniform over the warp

  const float4* s1 = smem4;
  const float4* s2 = smem4 + 2 * P::S1_UNITS + warp * 2 * P::S2_UNITS;
  const uint32_t s1_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(s1));
  const uint32_t s2_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(s2));
  const float* f1row = f1 + b * f1n + y * f1h;
  const float* f2row = f2 + b * f2n + (active ? y2 : 0) * f2h;

  // one chunk of CK channels into stage (chunk & 1), as one commit group
  auto stage = [&](int chunk) {
    const int c0 = chunk * CK;
    const uint32_t d1 = s1_addr + (chunk & 1) * P::S1_UNITS * 16;
    // f1: unit (u, m), m = (gh, k, p, gl) from high to low bits, g = 8gh + gl
    for (int idx = tid; idx < NQ * TW; idx += G * 32) {
      const int u = idx & (NQ - 1);
      const int m = idx >> 2;
      const int pp = (m >> 3) & 1;
      const int k = (m >> 4) & 3;
      const int gg = ((m >> 6) << 3) | (m & 7);
      const int x = x0 + pp + 2 * (4 * gg + k);
      const int c = c0 + 4 * u;
      const bool ok = x < W && c < C;
      cp16(d1 + ((u * 2 + pp) * 64 + k * 16 + gg) * 16,
           ok ? f1row + x * f1w + c : f1, ok);
    }
    if (active) {
      // f2: unit (u, m), m = p * 4QQ + tau, q = 4 (tau % QQ) + tau / QQ
      const uint32_t d2 = s2_addr + (chunk & 1) * P::S2_UNITS * 16;
      for (int idx = lane; idx < NQ * 2 * P::S2_PLANE; idx += 32) {
        const int u = idx & (NQ - 1);
        const int m = idx >> 2;
        const int pp = m / P::S2_PLANE;
        const int tau = m - pp * P::S2_PLANE;
        const int q = 4 * (tau % P::QQ) + tau / P::QQ;
        const int x = x0 - STEP * R + pp + 2 * q;
        const int c = c0 + 4 * u;
        const bool ok = q < P::NQCOL && x >= 0 && x < W && c < C;
        cp16(d2 + ((u * 2 + pp) * P::S2_PLANE + tau) * 16,
             ok ? f2row + x * f2w + c : f2, ok);
      }
    }
    cp_commit();
  };

  float acc[4][D];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < D; ++j) acc[k][j] = 0.f;

  const int nchunks = (C + CK - 1) / CK;
  stage(0);
  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + 1 < nchunks)
      stage(ch + 1);
    else
      cp_commit();                       // an empty group keeps the count
    cp_wait<1>();                        // chunk ch has landed (this thread)
    __syncthreads();                     // ... and every thread's
    if (active) {
      const float4* a_base = s1 + (ch & 1) * P::S1_UNITS + p * 64 + g;
      const float4* b_base =
          s2 + (ch & 1) * P::S2_UNITS + p * P::S2_PLANE + g;
#pragma unroll 1
      for (int u = 0; u < NQ; ++u) {
        float4 a[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) a[k] = a_base[u * 2 * 64 + 16 * k];
        const float4* bu = b_base + u * 2 * P::S2_PLANE;
#pragma unroll
        for (int t = 0; t < D + 3; ++t) {
          const float4 v = bu[(t & 3) * P::QQ + (t >> 2)];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = t - k;
            if (j >= 0 && j < D) {
              float s = acc[k][j];
              s = fmaf(a[k].x, v.x, s);
              s = fmaf(a[k].y, v.y, s);
              s = fmaf(a[k].z, v.z, s);
              s = fmaf(a[k].w, v.w, s);
              acc[k][j] = s;
            }
          }
        }
      }
    }
    __syncthreads();                     // stage (ch & 1) may be refilled
  }

  if (dyi >= D) return;
  const float rc = static_cast<float>(C);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int x = x0 + p + 2 * (4 * g + k);
    if (x < W) {
      float* o = out + ((static_cast<int64_t>(b) * H + y) * W + x) * (D * D) +
                 dyi * D;
#pragma unroll
      for (int j = 0; j < D; ++j) o[j] = acc[k][j] / rc;
    }
  }
}

template <int R, int G>
cudaError_t launch_banded(const float* f1, const float* f2, float* out, int B,
                          int H, int W, int C, int64_t f1n, int64_t f1h,
                          int64_t f1w, int64_t f2n, int64_t f2h, int64_t f2w,
                          cudaStream_t stream) {
  constexpr int D = 2 * R + 1;
  constexpr int smem = banded_smem<R, G>();
  const int ngroups = (D + G - 1) / G;
  const int64_t z = static_cast<int64_t>(B) * ngroups;
  if (z > 65535) return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (smem > 48 * 1024 && !attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        correlation_banded_kernel<R, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((W + TW - 1) / TW, H, static_cast<unsigned>(z));
  correlation_banded_kernel<R, G><<<grid, G * 32, smem, stream>>>(
      f1, f2, out, H, W, C, ngroups, f1n, f1h, f1w, f2n, f2h, f2w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The banded kernel. f1, f2: (B, H, W, C) float32 with unit channel stride
// and element strides f{1,2}s_{n,h,w}, each a multiple of 4, and 16-byte
// aligned base addresses; C a multiple of 4; out: (B, H, W, D*D) float32,
// contiguous, D = 2r+1; the displacement step is 2; r is 2 or 10. Returns a
// cudaError_t value; 0 means launched.
int correlation_banded_forward(const void* f1, const void* f2, void* out,
                               int B, int H, int W, int C, int r,
                               int64_t f1s_n, int64_t f1s_h, int64_t f1s_w,
                               int64_t f2s_n, int64_t f2s_h, int64_t f2s_w,
                               void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 4 != 0 || H > 65535 ||
      (reinterpret_cast<uintptr_t>(f1) | reinterpret_cast<uintptr_t>(f2)) %
              16 != 0 ||
      (f1s_n | f1s_h | f1s_w | f2s_n | f2s_h | f2s_w) % 4 != 0)
    return cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(f1);
  const float* c = static_cast<const float*>(f2);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CDTT_BANDED(RR, GG)                                                  \
  if (r == RR)                                                               \
    return launch_banded<RR, GG>(a, c, o, B, H, W, C, f1s_n, f1s_h, f1s_w,   \
                                 f2s_n, f2s_h, f2s_w, s);
  CDTT_BANDED(10, 7)
  CDTT_BANDED(2, 7)
#undef CDTT_BANDED
  return cudaErrorInvalidValue;
}

}  // extern "C"
