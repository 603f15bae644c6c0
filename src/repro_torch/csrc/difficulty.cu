// Fused DART difficulty estimator (paper section II.A, Eqs. 1-8) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/difficulty/difficulty_kernel.py
// (`_kernel` / `difficulty_pallas`).  Per image (H, W, C), fp32 in [0, 1]:
//   gray    = luma (C == 3) or the channel mean
//   a_edge  = share of the valid (H-2)(W-2) region whose 3x3 Sobel
//             magnitude exceeds tau_edge                       (Eqs. 1-4)
//   a_var   = 1 - exp(-var / var_scale), var = mean over channels of the
//             per-channel spatial variance                    (Eqs. 5-6)
//   a_grad  = 1 - exp(-mean|Laplacian| / grad_scale)           (Eq. 7)
//   alpha   = clip(w1 a_edge + w2 a_var + w3 a_grad, 0, 1)     (Eq. 8)
// Output (B, 4) = (a_edge, a_var, a_grad, alpha).
//
// Bound on an H100: each image is read from device memory once,
// B*H*W*C*4 bytes at 3.35 TB/s; the stencils are a few tens of flops per
// pixel, far below the fp32 rate.
//
// Design: one block per image, no shared-memory tile, so any H, W >= 3
// and any C work (a 224x224x3 image, 602 KB, would not fit in a block's
// shared memory).  Pass 1 reduces the per-channel sums to channel means.
// Pass 2 walks the pixels once more: the squared deviations, and on the
// valid region the Sobel and Laplacian stencils with gray computed on the
// fly from the 3x3 neighbourhood.  That neighbourhood is read again by
// the neighbouring threads; the re-reads hit L1/L2 (a 32x32x3 image is
// 12 KB, a 1024-image bucket 12.6 MB, inside the 50 MB L2), so device
// memory still sees each byte about once.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of one float per thread over the block; every thread gets the sum.
// `scratch` holds kThreads / kWarp floats.
__device__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  v = warp_sum(v);
  __syncthreads();                    // scratch may still be read
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / kWarp; ++w) total += scratch[w];
  return total;
}

__device__ __forceinline__ float gray_at(const float* __restrict__ img,
                                         int pix, int c) {
  const float* p = img + static_cast<int64_t>(pix) * c;
  if (c == 3) return 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
  float s = 0.f;
  for (int k = 0; k < c; ++k) s += p[k];
  return s / static_cast<float>(c);
}

__global__ void __launch_bounds__(kThreads)
difficulty_kernel(const float* __restrict__ images, float* __restrict__ out,
                  int h, int w, int c, float tau_edge, float var_scale,
                  float grad_scale, float w1, float w2, float w3) {
  extern __shared__ float mean[];                 // (c,) channel means
  __shared__ float scratch[kThreads / kWarp];
  const int hw = h * w;
  const float* img = images + static_cast<int64_t>(blockIdx.x) * hw * c;

  // ---- pass 1: per-channel means
  for (int k = 0; k < c; ++k) {
    float s = 0.f;
    for (int p = threadIdx.x; p < hw; p += kThreads)
      s += img[static_cast<int64_t>(p) * c + k];
    s = block_sum(s, scratch);
    if (threadIdx.x == 0) mean[k] = s / static_cast<float>(hw);
  }
  __syncthreads();

  // ---- pass 2: squared deviations + stencils on the valid region
  float sq = 0.f, lap_abs = 0.f, edges = 0.f;
  for (int p = threadIdx.x; p < hw; p += kThreads) {
    const float* px = img + static_cast<int64_t>(p) * c;
    for (int k = 0; k < c; ++k) {
      const float d = px[k] - mean[k];
      sq += d * d;
    }
    const int y = p / w, x = p % w;
    if (y < 1 || y > h - 2 || x < 1 || x > w - 2) continue;
    const float tl = gray_at(img, p - w - 1, c);
    const float tc = gray_at(img, p - w, c);
    const float tr = gray_at(img, p - w + 1, c);
    const float ml = gray_at(img, p - 1, c);
    const float mc = gray_at(img, p, c);
    const float mr = gray_at(img, p + 1, c);
    const float bl = gray_at(img, p + w - 1, c);
    const float bc = gray_at(img, p + w, c);
    const float br = gray_at(img, p + w + 1, c);
    const float gx = (tr + 2.f * mr + br) - (tl + 2.f * ml + bl);
    const float gy = (bl + 2.f * bc + br) - (tl + 2.f * tc + tr);
    edges += sqrtf(gx * gx + gy * gy) > tau_edge ? 1.f : 0.f;
    lap_abs += fabsf(tc + ml + mr + bc - 4.f * mc);
  }
  // Edge counts stay exact in fp32 up to 2^24 pixels per image.
  sq = block_sum(sq, scratch);
  lap_abs = block_sum(lap_abs, scratch);
  edges = block_sum(edges, scratch);

  if (threadIdx.x == 0) {
    const float valid = static_cast<float>((h - 2) * (w - 2));
    const float a_edge = edges / valid;
    const float var = sq / static_cast<float>(hw * c);
    const float a_var = 1.f - expf(-var / var_scale);
    const float a_grad = 1.f - expf(-(lap_abs / valid) / grad_scale);
    const float alpha = fminf(fmaxf(w1 * a_edge + w2 * a_var + w3 * a_grad,
                                    0.f), 1.f);
    float* o = out + static_cast<int64_t>(blockIdx.x) * 4;
    o[0] = a_edge;
    o[1] = a_var;
    o[2] = a_grad;
    o[3] = alpha;
  }
}

}  // namespace

// images: contiguous (b, h, w, c) float32; out: contiguous (b, 4) float32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int difficulty_launch(const void* images, void* out, int b, int h,
                                 int w, int c, float tau_edge,
                                 float var_scale, float grad_scale, float w1,
                                 float w2, float w3, void* stream) {
  difficulty_kernel<<<b, kThreads, c * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(images), static_cast<float*>(out), h, w, c,
      tau_edge, var_scale, grad_scale, w1, w2, w3);
  return static_cast<int>(cudaGetLastError());
}
