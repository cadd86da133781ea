// FlowNetC cost volume (correlation) for Hopper (sm_90a).
//
// Replaces the TPU kernel consistent_depth_tpu/flow/correlation.py
// (_corr_kernel, launched by correlation_pallas). That kernel DMAs a row
// band of a zero-padded copy of f2, with a max-displacement halo, into VMEM
// once per band and computes all D*D planes from it. This kernel computes
// the same function directly:
//
//   out[b,y,x,(dy+r)*D + (dx+r)] =
//       (1/C) * sum_c f1[b,y,x,c] * f2[b, y + s*dy, x + s*dx, c]
//
// for |dy|, |dx| <= r, D = 2r+1, with f2 read as zero outside the image, in
// f32 with f32 accumulation. No padded copy of f2 is made and no shape has
// to divide a tile: out-of-image reads and ragged tiles are masked.
//
// What bounds it on the card: on-chip traffic. At FlowNet2's 1x56x128x256
// with r = 10, s = 2 it does 1.6 GFLOP against 27 MB of compulsory device
// memory traffic (12.6 MB written, 7.3 MB read per input): 24 us on the f32
// FMA pipes, 8 us at the memory's bandwidth. What a direct kernel pays on
// top is the staging: every f2 row is re-read from L2 for each of the D
// output rows that use it, and every FMA needs a shared-memory load. The
// design keeps every product in registers and shared memory and spends as
// few loads per FMA as a simple layout allows:
//   - one block per (b, y, 32-column tile, dy): it stages the f1 row tile
//     and the one f2 row y + s*dy it needs, with its +-r*s column halo
//     (32 + 40 columns at FlowNet2's setting), in shared memory in chunks
//     of 32 channels (13.6 KB), loaded with the channel index fastest so
//     that channels_last inputs are read in 128-byte runs;
//   - lane l of warp w owns column x0 + l and displacements dx_i = w + 7k,
//     k < 3: one f1 load feeds three f32 FMAs, and all shared-memory reads
//     are consecutive words across the warp (row strides are odd, so the
//     transposing stores are conflict-free too);
//   - the block's 32 x D results for its dy are staged in shared memory and
//     written as D contiguous floats per pixel, so the stores come in
//     84-byte runs rather than 1764-byte strides;
//   - a dy whose f2 row lies outside the image writes zeros and loads
//     nothing.
// f1 is re-read from L2 for each of the D values of dy; keeping it resident
// across dy, and tensor-core tiles over the channel sum, are later steps.
//
// The kernel allocates nothing, launches on the caller's stream and does
// not synchronise. The C entry returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_X = 32;              // output columns per block (lanes)
constexpr int WARPS = 7;                // thread rows
constexpr int NACC = 3;                 // displacements per thread
constexpr int SLOTS = WARPS * NACC;     // dx values per block: 21
constexpr int CHUNK = 32;               // channels staged per pass
constexpr int NTHREADS = TILE_X * WARPS;
constexpr int S1_LD = TILE_X + 1;       // odd row stride of the f1 tile
constexpr size_t STATIC_SMEM = TILE_X * SLOTS * sizeof(float);
constexpr size_t MAX_SMEM = 48 * 1024;

__host__ __device__ inline int s2_ld(int reach) {
  return (TILE_X + 2 * reach) | 1;      // odd row stride of the f2 row
}

__host__ __device__ inline size_t dynamic_smem(int reach) {
  return static_cast<size_t>(CHUNK) * (S1_LD + s2_ld(reach)) * sizeof(float);
}

__global__ void __launch_bounds__(NTHREADS)
correlation_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                   float* __restrict__ out, int H, int W, int C, int r,
                   int stride, int groups, int64_t f1n, int64_t f1h,
                   int64_t f1w, int64_t f1c, int64_t f2n, int64_t f2h,
                   int64_t f2w, int64_t f2c) {
  extern __shared__ float smem[];
  __shared__ float s_out[TILE_X * SLOTS];  // [x][slot]

  const int D = 2 * r + 1;
  const int reach = r * stride;
  const int span = TILE_X + 2 * reach;
  const int ld2 = s2_ld(reach);
  float* s1 = smem;                        // [CHUNK][S1_LD]
  float* s2 = smem + CHUNK * S1_LD;        // [CHUNK][ld2]

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * TILE_X + lane;
  const int x0 = blockIdx.x * TILE_X;
  const int y = blockIdx.y;
  const int g = blockIdx.z % groups;
  const int dyi = (blockIdx.z / groups) % D;
  const int b = blockIdx.z / groups / D;
  const int dx0 = g * SLOTS;               // first displacement index
  const int nslots = min(SLOTS, D - dx0);
  const int nx = min(TILE_X, W - x0);
  const int y2 = y + (dyi - r) * stride;

  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.f;

  if (y2 >= 0 && y2 < H) {                 // uniform over the block
    const float* f1row = f1 + b * f1n + y * f1h;
    const float* f2row = f2 + b * f2n + y2 * f2h;
    for (int c0 = 0; c0 < C; c0 += CHUNK) {
      const int nc = min(CHUNK, C - c0);
      __syncthreads();                     // the previous chunk's reads are done
      for (int i = tid; i < CHUNK * TILE_X; i += NTHREADS) {
        const int c = i % CHUNK;
        const int xx = i / CHUNK;
        float v = 0.f;
        if (c < nc && xx < nx)
          v = __ldg(f1row + (x0 + xx) * f1w + (c0 + c) * f1c);
        s1[c * S1_LD + xx] = v;
      }
      for (int i = tid; i < CHUNK * span; i += NTHREADS) {
        const int c = i % CHUNK;
        const int col = i / CHUNK;
        const int gx = x0 - reach + col;
        float v = 0.f;
        if (c < nc && gx >= 0 && gx < W)
          v = __ldg(f2row + gx * f2w + (c0 + c) * f2c);
        s2[c * ld2 + col] = v;
      }
      __syncthreads();
      for (int c = 0; c < nc; ++c) {
        const float a = s1[c * S1_LD + lane];
        const float* row = s2 + c * ld2 + lane;
#pragma unroll
        for (int k = 0; k < NACC; ++k) {
          const int j = warp + k * WARPS;
          if (j < nslots) acc[k] = fmaf(a, row[(dx0 + j) * stride], acc[k]);
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    const int j = warp + k * WARPS;
    if (j < nslots) s_out[lane * SLOTS + j] = acc[k] / static_cast<float>(C);
  }
  __syncthreads();
  const int64_t D2 = static_cast<int64_t>(D) * D;
  float* base = out + ((static_cast<int64_t>(b) * H + y) * W + x0) * D2 +
                dyi * D + dx0;
  for (int i = tid; i < nx * nslots; i += NTHREADS) {
    const int xx = i / nslots;
    const int j = i % nslots;
    base[xx * D2 + j] = s_out[xx * SLOTS + j];
  }
}

}  // namespace

extern "C" {

// f1, f2: (B, H, W, C) float32 with element strides f{1,2}s_{n,h,w,c};
// out: (B, H, W, D*D) float32, contiguous, D = 2r+1. The displacement step
// is ``stride`` pixels, so the reach is r*stride (at most 148 so that the
// staged rows fit 48 KB of shared memory). Returns a cudaError_t value; 0
// means launched.
int correlation_forward(const void* f1, const void* f2, void* out, int B,
                        int H, int W, int C, int r, int stride,
                        int64_t f1s_n, int64_t f1s_h, int64_t f1s_w,
                        int64_t f1s_c, int64_t f2s_n, int64_t f2s_h,
                        int64_t f2s_w, int64_t f2s_c, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || r < 0 || stride < 1 ||
      H > 65535)
    return cudaErrorInvalidValue;
  const int D = 2 * r + 1;
  const int groups = (D + SLOTS - 1) / SLOTS;
  const int64_t z = static_cast<int64_t>(B) * D * groups;
  const size_t smem = dynamic_smem(r * stride);
  if (z > 65535 || smem + STATIC_SMEM > MAX_SMEM) return cudaErrorInvalidValue;
  const dim3 grid((W + TILE_X - 1) / TILE_X, H, static_cast<unsigned>(z));
  const dim3 block(TILE_X, WARPS);
  correlation_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2),
      static_cast<float*>(out), H, W, C, r, stride, groups, f1s_n, f1s_h,
      f1s_w, f1s_c, f2s_n, f2s_h, f2s_w, f2s_c);
  return cudaGetLastError();
}

}  // extern "C"
