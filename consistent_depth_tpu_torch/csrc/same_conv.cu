// Direct stride-1, same-padding, odd-k 2-D convolution for Hopper (sm_90a).
//
// Replaces the TPU kernel consistent_depth_tpu/ops/s2d_conv.py
// (_s2d_conv_kernel, launched by _s2d_conv_pallas_jit). That kernel
// relays the input into space-to-depth form inside VMEM so that the
// hourglass's narrow convs (C_out 16/32) fill the MXU's 128 lanes. Hopper
// has no such lane constraint, so this kernel computes the same function
// directly: out[n,y,x,o] = bias[o] + sum_{r,c,i} x[n,y+r-p,x+c-p,i] w[r,c,i,o]
// with zero padding and f32 accumulation, for f32 and bf16 tensors.
//
// What bounds it on the card: arithmetic. The hourglass's k x k convs do
// 2*k*k*Ci FLOPs per output element against a few bytes moved (k=11, Ci=64:
// ~15.5 kFLOP per element), far above the H100's FLOP/byte ridge. This first
// version runs on the f32 FMA pipes (67 TFLOP/s peak) rather than the tensor
// cores, and is written to be right first:
//   - one block computes a 16x16 pixel tile for COB output channels; each
//     of its 128 threads holds 2 pixels x COB channels of f32 accumulators
//     in registers, so every shared-memory weight load feeds 2 FMAs and
//     every input load feeds COB FMAs;
//   - the input tile plus its (k-1)/2 halo and the matching weight slice
//     are staged in shared memory in chunks of CIC input channels, sized so
//     that k=11 at COB=32 still fits the 48 KB static limit (no divisibility
//     rule on H, W or the channel counts: ragged tiles and channel chunks are
//     masked, out-of-range taps read zero);
//   - weight reads are warp-wide broadcasts, input reads are consecutive
//     words across the warp (conflict-free within each half-warp).
// Tensor-core (wgmma) tiles fed by TMA are the later step for speed.
//
// The conv's grad-input (same_conv_grad_input) is the same kernel, as the
// TPU package's custom VJP does it (consistent_depth_tpu/models/layers.py,
// _conv_pallas_bwd): dx[n,y,x,i] = sum_{r,c,o} ct[n,y+p-r,x+p-c,o] w[r,c,i,o]
// is the same-padding conv of the cotangent with the flipped,
// channel-swapped weight. The kernel reads its weight through int64
// strides, so the flip and the swap cost no copy: the entry passes a
// pointer to w[k-1,k-1,0,0] with strides (-ws_r, -ws_c, ws_o, ws_i) and
// exchanges Ci and Co. A template flag for the flip would double the
// instantiations (and the build time) for the same arithmetic.
//
// The kernel allocates nothing, launches on the caller's stream and does
// not synchronise. The C entries return cudaGetLastError() after the
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 16;
constexpr int TILE_H = 16;
constexpr int THREADS_X = 16;
constexpr int THREADS_Y = 8;
constexpr int ROWS_PER_THREAD = TILE_H / THREADS_Y;
constexpr int NTHREADS = THREADS_X * THREADS_Y;
// f32 words of one weight chunk in shared memory (32 KB)
constexpr int W_CHUNK_WORDS = 8192;

constexpr int pick_cic(int k, int cob) {
  return W_CHUNK_WORDS / (k * k * cob) >= 8   ? 8
         : W_CHUNK_WORDS / (k * k * cob) >= 4 ? 4
         : W_CHUNK_WORDS / (k * k * cob) >= 2 ? 2
                                               : 1;
}

template <int K, int COB>
struct Tile {
  static constexpr int P = (K - 1) / 2;
  static constexpr int IN_H = TILE_H + K - 1;
  static constexpr int IN_W = TILE_W + K - 1;
  static constexpr int CIC = pick_cic(K, COB);
  // rounded up to 4 words so that the weight slice after it is 16-byte
  // aligned for float4 reads
  static constexpr int X_WORDS = (CIC * IN_H * IN_W + 3) / 4 * 4;
  static constexpr int W_WORDS = K * K * CIC * COB;
};

__device__ __forceinline__ float to_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float to_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int K, int COB>
__global__ void __launch_bounds__(NTHREADS)
same_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ out, int H,
                 int W, int Ci, int Co, int tiles_w, int64_t xsn,
                 int64_t xsh, int64_t xsw, int64_t xsc, int64_t wsr,
                 int64_t wsc, int64_t wsi, int64_t wso) {
  using TL = Tile<K, COB>;
  static_assert(COB % 4 == 0, "COB must be a multiple of 4");
  static_assert((TL::X_WORDS + TL::W_WORDS) * sizeof(float) <= 48 * 1024,
                "tile exceeds the static shared-memory limit");
  __shared__ __align__(16) float s_x[TL::X_WORDS];  // [CIC][IN_H][IN_W]
  __shared__ __align__(16) float s_w[TL::W_WORDS];  // [K*K][CIC][COB]

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * THREADS_X + tx;
  const int oy0 = (blockIdx.x / tiles_w) * TILE_H;
  const int ox0 = (blockIdx.x % tiles_w) * TILE_W;
  const int co0 = blockIdx.y * COB;
  const int n = blockIdx.z;
  const T* xn = x + n * xsn;

  float acc[ROWS_PER_THREAD][COB];
#pragma unroll
  for (int j = 0; j < ROWS_PER_THREAD; ++j)
#pragma unroll
    for (int o = 0; o < COB; ++o) acc[j][o] = 0.f;

  for (int ci0 = 0; ci0 < Ci; ci0 += TL::CIC) {
    const int nci = min(TL::CIC, Ci - ci0);
    __syncthreads();  // the previous chunk's reads are done
    // input tile + halo; the channel index runs fastest so that one
    // pixel's channels are read from adjacent addresses
    for (int i = tid; i < TL::CIC * TL::IN_H * TL::IN_W; i += NTHREADS) {
      const int ci = i % TL::CIC;
      const int pix = i / TL::CIC;
      const int r = pix / TL::IN_W;
      const int c = pix % TL::IN_W;
      const int gy = oy0 - TL::P + r;
      const int gx = ox0 - TL::P + c;
      float v = 0.f;
      if (ci < nci && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_f32(xn + gy * xsh + gx * xsw + (ci0 + ci) * xsc);
      s_x[(ci * TL::IN_H + r) * TL::IN_W + c] = v;
    }
    for (int i = tid; i < TL::W_WORDS; i += NTHREADS) {
      const int o = i % COB;
      const int rest = i / COB;
      const int ci = rest % TL::CIC;
      const int tap = rest / TL::CIC;
      float v = 0.f;
      if (ci < nci && co0 + o < Co)
        v = to_f32(w + (tap / K) * wsr + (tap % K) * wsc +
                   (ci0 + ci) * wsi + (co0 + o) * wso);
      s_w[i] = v;
    }
    __syncthreads();

    for (int ci = 0; ci < nci; ++ci) {
      const float* sx = s_x + ci * TL::IN_H * TL::IN_W;
#pragma unroll
      for (int kr = 0; kr < K; ++kr) {
#pragma unroll
        for (int kc = 0; kc < K; ++kc) {
          float xv[ROWS_PER_THREAD];
#pragma unroll
          for (int j = 0; j < ROWS_PER_THREAD; ++j)
            xv[j] = sx[(ty + j * THREADS_Y + kr) * TL::IN_W + tx + kc];
          const float4* wv = reinterpret_cast<const float4*>(
              s_w + ((kr * K + kc) * TL::CIC + ci) * COB);
#pragma unroll
          for (int q = 0; q < COB / 4; ++q) {
            const float4 wq = wv[q];
#pragma unroll
            for (int j = 0; j < ROWS_PER_THREAD; ++j) {
              acc[j][4 * q + 0] = fmaf(xv[j], wq.x, acc[j][4 * q + 0]);
              acc[j][4 * q + 1] = fmaf(xv[j], wq.y, acc[j][4 * q + 1]);
              acc[j][4 * q + 2] = fmaf(xv[j], wq.z, acc[j][4 * q + 2]);
              acc[j][4 * q + 3] = fmaf(xv[j], wq.w, acc[j][4 * q + 3]);
            }
          }
        }
      }
    }
  }

  const int ox = ox0 + tx;
#pragma unroll
  for (int j = 0; j < ROWS_PER_THREAD; ++j) {
    const int oy = oy0 + ty + j * THREADS_Y;
    if (oy >= H || ox >= W) continue;
    T* o_ptr = out + ((static_cast<int64_t>(n) * H + oy) * W + ox) * Co + co0;
#pragma unroll
    for (int o = 0; o < COB; ++o) {
      if (co0 + o < Co) {
        float v = acc[j][o];
        if (bias != nullptr) v += to_f32(bias + co0 + o);
        store_f32(o_ptr + o, v);
      }
    }
  }
}

template <typename T, int K, int COB>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out,
                   int N, int H, int W, int Ci, int Co, const int64_t* xs,
                   const int64_t* ws, cudaStream_t stream) {
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int tiles_h = (H + TILE_H - 1) / TILE_H;
  const dim3 grid(tiles_w * tiles_h, (Co + COB - 1) / COB, N);
  const dim3 block(THREADS_X, THREADS_Y);
  same_conv_kernel<T, K, COB><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), H, W, Ci, Co,
      tiles_w, xs[0], xs[1], xs[2], xs[3], ws[0], ws[1], ws[2], ws[3]);
  return cudaGetLastError();
}

template <typename T, int COB>
cudaError_t launch_k(int K, const void* x, const void* w, const void* bias,
                     void* out, int N, int H, int W, int Ci, int Co,
                     const int64_t* xs, const int64_t* ws,
                     cudaStream_t stream) {
  switch (K) {
    case 3:
      return launch<T, 3, COB>(x, w, bias, out, N, H, W, Ci, Co, xs, ws, stream);
    case 5:
      return launch<T, 5, COB>(x, w, bias, out, N, H, W, Ci, Co, xs, ws, stream);
    case 7:
      return launch<T, 7, COB>(x, w, bias, out, N, H, W, Ci, Co, xs, ws, stream);
    case 11:
      return launch<T, 11, COB>(x, w, bias, out, N, H, W, Ci, Co, xs, ws, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(int K, const void* x, const void* w, const void* bias,
                     void* out, int N, int H, int W, int Ci, int Co,
                     const int64_t* xs, const int64_t* ws,
                     cudaStream_t stream) {
  // 16 output channels per block for the narrow branches (C_out <= 16),
  // 32 otherwise
  if (Co <= 16)
    return launch_k<T, 16>(K, x, w, bias, out, N, H, W, Ci, Co, xs, ws, stream);
  return launch_k<T, 32>(K, x, w, bias, out, N, H, W, Ci, Co, xs, ws, stream);
}

}  // namespace

extern "C" {

// x: (N, H, W, Ci) with element strides xs_{n,h,w,c}; w: (K, K, Ci, Co) with
// element strides ws_{r,c,i,o}; bias: (Co,) contiguous or NULL; out: (N, H,
// W, Co) contiguous. dtype 0 = float32, 1 = bfloat16 (all four tensors).
// Returns a cudaError_t value; 0 means launched.
int same_conv_forward(const void* x, const void* w, const void* bias,
                      void* out, int dtype, int N, int H, int W, int Ci,
                      int Co, int K, int64_t xs_n, int64_t xs_h,
                      int64_t xs_w, int64_t xs_c, int64_t ws_r, int64_t ws_c,
                      int64_t ws_i, int64_t ws_o, void* stream) {
  const int64_t xs[4] = {xs_n, xs_h, xs_w, xs_c};
  const int64_t ws[4] = {ws_r, ws_c, ws_i, ws_o};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 || N > 65535)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_t<float>(K, x, w, bias, out, N, H, W, Ci, Co, xs, ws, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(K, x, w, bias, out, N, H, W, Ci, Co, xs,
                                   ws, s);
  return cudaErrorInvalidValue;
}

// Grad-input of same_conv_forward. ct: (N, H, W, Co) with element strides
// cs_{n,h,w,c}; w: the forward's (K, K, Ci, Co) weight with element strides
// ws_{r,c,i,o}; dx: (N, H, W, Ci) contiguous. dtype as above.
int same_conv_grad_input(const void* ct, const void* w, void* dx, int dtype,
                         int N, int H, int W, int Ci, int Co, int K,
                         int64_t cs_n, int64_t cs_h, int64_t cs_w,
                         int64_t cs_c, int64_t ws_r, int64_t ws_c,
                         int64_t ws_i, int64_t ws_o, void* stream) {
  const int64_t cs[4] = {cs_n, cs_h, cs_w, cs_c};
  // the flipped, channel-swapped weight as a strided view of w: tap (r, c)
  // reads w[K-1-r, K-1-c], input channel o reads w[..., o], output
  // channel i reads w[..., i, :]
  const int64_t wf[4] = {-ws_r, -ws_c, ws_o, ws_i};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 || N > 65535 ||
      K <= 0)
    return cudaErrorInvalidValue;
  const int64_t last = (K - 1) * ws_r + (K - 1) * ws_c;
  if (dtype == 0)
    return launch_t<float>(K, ct, static_cast<const float*>(w) + last,
                           nullptr, dx, N, H, W, Co, Ci, cs, wf, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(
        K, ct, static_cast<const __nv_bfloat16*>(w) + last, nullptr, dx, N,
        H, W, Co, Ci, cs, wf, s);
  return cudaErrorInvalidValue;
}

const char* same_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
