// Grad-weight of a grouped 3x3 conv (padding 1, dilation 1, stride 1 or
// 2) for Hopper (sm_90a), on the FMA pipes in f32.
//
// Replaces no TPU kernel: the JAX package leaves the grouped conv of
// ResNeXt-101 32x8d (models/resnet.py, Bottleneck.conv2) to XLA. It was
// added because the library's f32 grouped grad-weight took ~65% of a
// midas2 fine-tune step on an H100 (197.5 ms of ~305 ms, 0.17% of its
// bound); the grouped conv's forward and grad-input stay on the library,
// and so does all of a bf16 grouped conv (the library's bf16 grad-weight
// ran faster than a bf16 build of this kernel at every midas2 class).
//
// What it computes, per group g of Cg = C / groups channels (input and
// output alike), with f32 sums:
//
//   dW[g*Cg + o, i, r, s] = sum over n, y, x of
//       dY[n, y, x, g*Cg + o] * X[n, y*st + r - 1, x*st + s - 1, g*Cg + i]
//
// with X read as zero outside the image. X and dY are NHWC views with unit
// channel stride and 16-byte aligned pixels (channels_last activations);
// dW takes any strides.
//
// What bounds it on the card: bytes. A midas2 step (33 convs, 8 images at
// 224x384) does 52.3 GFLOP against ~1.1 GB of compulsory traffic (x and dY
// read once, dW written): 0.34 ms at 3.35 TB/s; its FLOP take 0.32 ms at
// TF32's 165 TFLOP/s for f32-exact products and 0.78 ms on the f32 FMA
// pipes (67 TFLOP/s), which this kernel uses. What the design does:
//
//   1. FMA throughput. A thread keeps an 8 x 8 tile of sums (8 output
//      channels o by 8 input channels i, one tap) in registers: per pixel it
//      loads 8 dY and 8 X values (four 16-byte shared loads) for 64
//      FMAs.
//   2. Shared-memory bandwidth. A block is 9 warps, one per tap; the 32
//      lanes of a warp are (group, o-block, i-block) triples, so lanes that
//      share an o-block (or an i-block) read one address (a broadcast), and
//      16-byte units are stored even/odd split, so that each of a lane's two
//      16-byte loads lies beside its neighbours' (no bank conflict).
//   3. Device memory. A block stages a segment of TX output pixels of one
//      row (their dY, and the 3 x ((TX-1)*st + 3) halo of X they need) by
//      16-byte cp.async with zero fill for the padding, two stages deep,
//      for its slab of channels: dY is read once from device memory, X
//      about three times, the repeats mostly from L2.
//   4. Few outputs over many pixels. dW has C * Cg * 9 values, summed over
//      N*Ho*Wo pixels (672 to 43,008 in midas2), so the pixels are split
//      over blocks (split-K): each block sums a contiguous range of
//      segments into an f32 partial of its own in a workspace, and a second
//      pass adds the partials in a fixed order and writes dW in its
//      layout. No atomics: two calls give bitwise the same gradient.
//
// Slabs: a block takes the dY channels of GW groups and, of each group,
// the X channels of IBW i-blocks of 8. Cg = 8: 32 groups (lane = group);
// 16: 8 groups x 2 o-blocks x 2 i-blocks; 32: 2 x 4 x 4; 64: 1 x 8 x 4
// (half a group's inputs). grid = (splits, channel blocks). The workspace
// holds splits x C * Cg * 9 floats, each block's partial in the order its
// threads hold it (ops/grouped_conv.py, _plan).
//
// The kernels allocate nothing, launch on the caller's stream and do not
// synchronise. The C entry returns cudaGetLastError() after each launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 8;                        // output pixels a stage
constexpr int TAPS = 9;
constexpr int LANES = 32;
constexpr int THREADS = TAPS * LANES;        // one warp per tap
constexpr int TILE = 64;                     // sums a thread: 8 o x 8 i
constexpr int BLOCK_UNITS = THREADS * TILE / 4;  // float4s of a partial
constexpr int REDUCE_THREADS = 256;

template <int CG>
struct Slab {
  static constexpr int NB = CG / 8;              // 8-channel blocks a group
  static constexpr int IBW = NB < 4 ? NB : 4;    // i-blocks a block takes
  static constexpr int GW = LANES / (NB * IBW);  // groups a block takes
  static constexpr int CBI = NB / IBW;           // blocks per group set
  static constexpr int CO = GW * CG;             // dY channels staged
  static constexpr int CI = GW * IBW * 8;        // X channels staged
};

template <int CG, int ST>
struct Tiles {
  using S = Slab<CG>;
  static constexpr int UNIT = 4;                 // channels a 16-byte unit
  static constexpr int XW = (TX - 1) * ST + 3;   // halo columns
  static constexpr int NUO = S::CO / UNIT;       // dY units a pixel
  static constexpr int NUI = S::CI / UNIT;       // X units a pixel
  static constexpr int DY_UNITS = TX * NUO;
  static constexpr int X_UNITS = 3 * XW * NUI;
  static constexpr int STAGE_UNITS = DY_UNITS + X_UNITS;
  static constexpr int SMEM = 2 * 16 * STAGE_UNITS;
};

// where 16-byte unit u of a pixel's n units lies: even/odd split (a lane's
// 8 channels, units 2q and 2q + 1, lie at q and n/2 + q)
__device__ __forceinline__ int unit_pos(int u, int n) {
  return (u & 1) * (n >> 1) + (u >> 1);
}

// the 8 channels of 8-block q of a pixel whose n units start at pix
__device__ __forceinline__ void load8(const uint4* pix, int q, int n,
                                      float (&v)[8]) {
  const uint4 a = pix[q];
  const uint4 b = pix[(n >> 1) + q];
  v[0] = __uint_as_float(a.x);
  v[1] = __uint_as_float(a.y);
  v[2] = __uint_as_float(a.z);
  v[3] = __uint_as_float(a.w);
  v[4] = __uint_as_float(b.x);
  v[5] = __uint_as_float(b.y);
  v[6] = __uint_as_float(b.z);
  v[7] = __uint_as_float(b.w);
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <int CG, int ST>
__global__ void __launch_bounds__(THREADS, 2)
grouped_wgrad_kernel(const float* __restrict__ x,
                     const float* __restrict__ dy,
                     float4* __restrict__ ws, int H, int W, int Ho, int Wo,
                     int nxs, int64_t nseg, int64_t xn, int64_t xh,
                     int64_t xw, int64_t dyn, int64_t dyh, int64_t dyw) {
  using S = Slab<CG>;
  using P = Tiles<CG, ST>;
  extern __shared__ uint4 smem[];  // [2][dY TX x NUO | X 3 x XW x NUI]

  const int tid = threadIdx.x;
  const int tap = tid / LANES;
  const int lane = tid % LANES;
  const int r = tap / 3;
  const int s = tap % 3;
  const int gl = lane / (S::NB * S::IBW);
  const int ob = (lane / S::IBW) % S::NB;
  const int ibl = lane % S::IBW;
  const int qo = gl * S::NB + ob;    // the lane's 8-block of the dY slab
  const int qi = gl * S::IBW + ibl;  // and of the X slab
  const int cb = blockIdx.y;
  const int co0 = (cb / S::CBI) * S::CO;
  const int ci0 = co0 + (cb % S::CBI) * S::IBW * 8;
  const int64_t seg0 = nseg * blockIdx.x / gridDim.x;
  const int64_t nk = nseg * (blockIdx.x + 1) / gridDim.x - seg0;
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  auto decode = [&](int64_t seg, int64_t& n, int& y, int& x0) {
    const int64_t t = seg / nxs;
    x0 = static_cast<int>(seg - t * nxs) * TX;
    n = t / Ho;
    y = static_cast<int>(t - n * Ho);
  };

  // segment seg into stage buf, as one commit group
  auto stage = [&](int64_t seg, int buf) {
    int64_t n;
    int y, x0;
    decode(seg, n, y, x0);
    const int nv = min(TX, Wo - x0);
    const uint32_t sdy = base + 16 * buf * P::STAGE_UNITS;
    const uint32_t sx = sdy + 16 * P::DY_UNITS;
    const float* dyrow = dy + n * dyn + y * dyh + co0;
    for (int idx = tid; idx < P::DY_UNITS; idx += THREADS) {
      const int j = idx / P::NUO;
      const int u = idx % P::NUO;
      if (j < nv)
        cp16(sdy + 16 * (j * P::NUO + unit_pos(u, P::NUO)),
             dyrow + (x0 + j) * dyw + u * P::UNIT, true);
    }
    const float* xim = x + n * xn + ci0;
    for (int idx = tid; idx < P::X_UNITS; idx += THREADS) {
      const int u = idx % P::NUI;
      const int c = (idx / P::NUI) % P::XW;
      const int rr = idx / (P::NUI * P::XW);
      const int iy = y * ST - 1 + rr;
      const int ix = x0 * ST - 1 + c;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
      cp16(sx + 16 * ((rr * P::XW + c) * P::NUI + unit_pos(u, P::NUI)),
           ok ? xim + iy * xh + ix * xw + u * P::UNIT : x, ok);
    }
    cp_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  if (nk > 0) stage(seg0, 0);
  for (int64_t k = 0; k < nk; ++k) {
    if (k + 1 < nk)
      stage(seg0 + k + 1, (k + 1) & 1);
    else
      cp_commit();                     // an empty group keeps the count
    cp_wait_one();                     // segment k has landed (this thread)
    __syncthreads();                   // ... and every thread's
    int64_t n;
    int y, x0;
    decode(seg0 + k, n, y, x0);
    const int nv = min(TX, Wo - x0);
    const uint4* sdy = smem + (k & 1) * P::STAGE_UNITS;
    const uint4* sx = sdy + P::DY_UNITS + (r * P::XW + s) * P::NUI;
#pragma unroll 2
    for (int j = 0; j < nv; ++j) {
      float a[8], b[8];
      load8(sdy + j * P::NUO, qo, P::NUO, a);
      load8(sx + j * ST * P::NUI, qi, P::NUI, b);
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
    }
    __syncthreads();                   // stage (k & 1) may be refilled
  }

  // the partial: float4 e of the block's lies at (tap * 16 + e) * 32 + lane,
  // float4 e holding acc[e / 2][4 * (e % 2) .. + 3]
  float4* out = ws + (static_cast<int64_t>(blockIdx.x) * gridDim.y + cb) *
                         BLOCK_UNITS + tap * 16 * LANES + lane;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int a = e >> 1;
    const int b = 4 * (e & 1);
    out[e * LANES] =
        make_float4(acc[a][b], acc[a][b + 1], acc[a][b + 2], acc[a][b + 3]);
  }
}

// dW from the splits' partials: float4 e of the partial layout summed over
// the splits in order, its four values written to their (o, i, r, s)
template <int CG>
__global__ void __launch_bounds__(REDUCE_THREADS)
grouped_wgrad_reduce(const float4* __restrict__ ws, float* __restrict__ dw,
                     int splits, int64_t units, int64_t wo, int64_t wi,
                     int64_t wr, int64_t wc) {
  using S = Slab<CG>;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * REDUCE_THREADS +
                    threadIdx.x;
  if (e >= units) return;
  float4 v = ws[e];
  for (int sp = 1; sp < splits; ++sp) {
    const float4 w = ws[sp * units + e];
    v.x += w.x;
    v.y += w.y;
    v.z += w.z;
    v.w += w.w;
  }
  const int cb = static_cast<int>(e / BLOCK_UNITS);
  const int rem = static_cast<int>(e % BLOCK_UNITS);
  const int tap = rem / (16 * LANES);
  const int k = (rem / LANES) % 16;
  const int lane = rem % LANES;
  const int gl = lane / (S::NB * S::IBW);
  const int ob = (lane / S::IBW) % S::NB;
  const int ibl = lane % S::IBW;
  const int64_t o = (cb / S::CBI) * S::CO + gl * CG + ob * 8 + (k >> 1);
  const int64_t i = ((cb % S::CBI) * S::IBW + ibl) * 8 + 4 * (k & 1);
  float* p = dw + o * wo + i * wi + (tap / 3) * wr + (tap % 3) * wc;
  p[0] = v.x;
  p[wi] = v.y;
  p[2 * wi] = v.z;
  p[3 * wi] = v.w;
}

template <int CG, int ST>
cudaError_t launch(const float* x, const float* dy, float* dw, void* ws,
                   int N, int H, int W, int C, int groups, int splits,
                   int64_t xn, int64_t xh, int64_t xw, int64_t dyn,
                   int64_t dyh, int64_t dyw, int64_t wo, int64_t wi,
                   int64_t wr, int64_t wc, cudaStream_t stream) {
  using S = Slab<CG>;
  using P = Tiles<CG, ST>;
  if (groups % S::GW != 0 || C != groups * CG || splits < 1)
    return cudaErrorInvalidValue;
  auto kernel = grouped_wgrad_kernel<CG, ST>;
  static bool granted = false;
  if (!granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (err != cudaSuccess) return err;
    granted = true;
  }
  const int Ho = (H - 1) / ST + 1;
  const int Wo = (W - 1) / ST + 1;
  const int nxs = (Wo + TX - 1) / TX;
  const int64_t nseg = static_cast<int64_t>(N) * Ho * nxs;
  const int cbs = groups / S::GW * S::CBI;
  kernel<<<dim3(splits, cbs), THREADS, P::SMEM, stream>>>(
      x, dy, static_cast<float4*>(ws), H, W, Ho, Wo, nxs, nseg, xn, xh, xw,
      dyn, dyh, dyw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t units = static_cast<int64_t>(cbs) * BLOCK_UNITS;
  grouped_wgrad_reduce<CG><<<
      static_cast<unsigned>((units + REDUCE_THREADS - 1) / REDUCE_THREADS),
      REDUCE_THREADS, 0, stream>>>(static_cast<const float4*>(ws), dw,
                                   splits, units, wo, wi, wr, wc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dW (C, C / groups, 3, 3) of the grouped 3x3 conv of x (N, H, W, C) whose
// cotangent is dy (N, Ho, Wo, C), all f32; the (n, h, w) element strides
// of x and of dy, the (o, i, r, s) element strides of dw; ws the f32
// workspace of splits x C * (C / groups) * 9
int grouped_wgrad(const void* x, const void* dy, void* dw, void* ws, int N,
                  int H, int W, int C, int groups, int stride, int splits,
                  int64_t xn, int64_t xh, int64_t xw, int64_t dyn,
                  int64_t dyh, int64_t dyw, int64_t wo, int64_t wi,
                  int64_t wr, int64_t wc, void* stream) {
  if (groups < 1 || C % groups != 0) return cudaErrorInvalidValue;
  const int cg = C / groups;
  const float* xf = static_cast<const float*>(x);
  const float* dyf = static_cast<const float*>(dy);
  float* dwf = static_cast<float*>(dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GROUPED_WGRAD_CASE(CG, ST)                                           \
  if (cg == CG && stride == ST)                                              \
    return launch<CG, ST>(xf, dyf, dwf, ws, N, H, W, C, groups, splits, xn,  \
                          xh, xw, dyn, dyh, dyw, wo, wi, wr, wc, st);
  GROUPED_WGRAD_CASE(8, 1)
  GROUPED_WGRAD_CASE(8, 2)
  GROUPED_WGRAD_CASE(16, 1)
  GROUPED_WGRAD_CASE(16, 2)
  GROUPED_WGRAD_CASE(32, 1)
  GROUPED_WGRAD_CASE(32, 2)
  GROUPED_WGRAD_CASE(64, 1)
  GROUPED_WGRAD_CASE(64, 2)
#undef GROUPED_WGRAD_CASE
  return cudaErrorInvalidValue;
}

}  // extern "C"
