// Fused early-exit gate (paper Alg. 1, lines 5-9) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/exit_gate/exit_gate_kernel.py
// (`_kernel` / `exit_gate_pallas`).  Per row of logits (B, V), in fp32
// with the row max subtracted:
//   conf    = 1 / s,             s = sum_j exp(l_j - m)
//   entropy = log s - t / s,     t = sum_j (l_j - m) exp(l_j - m)
//   pred    = first argmax (ties go to the lowest index)
//   fire    = conf > tau' (strict)
//
// Bound on an H100: the logits are read once, B*V*itemsize bytes at
// 3.35 TB/s; the arithmetic (one exp and a few FMAs per element) is far
// below the fp32 rate.  At the classifier's V = 10 the whole batch is a
// few tens of KB, so the kernel is bound by its launch, not by memory.
//
// Design: one warp per row, kRowsPerBlock rows per block.  The lanes
// stride over V with coalesced loads, each keeping an online (max, s, t,
// argmax); when the running max moves from m to m' the partial sums are
// rescaled (s' = e^(m-m') s, t' = e^(m-m') (t + (m-m') s)).  The 32
// partials are merged with shuffles.  Nothing is staged in shared
// memory, so any V works, from 10 to an LM vocabulary of 129 280.  A
// lane adds up to V/32 terms one after another, so its fp32 sums are
// compensated (Kahan): without that, a 129 280-wide row came out 8e-6
// from the float64 value on an H100, against 2e-7 for torch's tree
// reductions.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Online softmax statistics of a set of logits.  An empty set has
// s == 0 (and m == -inf, idx == INT32_MAX).
struct Stats {
  float m;
  float s;
  float t;
  int idx;
};

// One lane's running statistics, with Kahan compensations cs and ct
// (the true sums are s - cs and t - ct).
struct Lane {
  Stats st;
  float cs;
  float ct;
};

__device__ __forceinline__ void kahan_add(float& sum, float& comp, float v) {
  const float y = v - comp;
  const float next = sum + y;
  comp = (next - sum) - y;
  sum = next;
}

__device__ __forceinline__ void push(Lane& a, float x, int j) {
  Stats& st = a.st;
  if (st.s == 0.f) {                    // first element of this lane
    st = Stats{x, 1.f, 0.f, j};
    a.cs = a.ct = 0.f;
  } else if (x > st.m) {                // strict: keeps the first argmax
    const float d = st.m - x;           // < 0
    const float r = expf(d);
    const float s0 = st.s - a.cs, t0 = st.t - a.ct;
    st = Stats{x, r * s0 + 1.f, r * (t0 + d * s0), j};
    a.cs = a.ct = 0.f;
  } else {
    const float d = x - st.m;
    const float e = expf(d);
    kahan_add(st.s, a.cs, e);
    kahan_add(st.t, a.ct, d * e);
  }
}

__device__ __forceinline__ Stats merge(const Stats& a, const Stats& b) {
  if (b.s == 0.f) return a;
  if (a.s == 0.f) return b;
  Stats o;
  o.m = fmaxf(a.m, b.m);
  const float da = a.m - o.m, db = b.m - o.m;   // both <= 0
  const float ra = expf(da), rb = expf(db);
  o.s = ra * a.s + rb * b.s;
  o.t = ra * (a.t + da * a.s) + rb * (b.t + db * b.s);
  if (a.m > b.m) {
    o.idx = a.idx;
  } else if (b.m > a.m) {
    o.idx = b.idx;
  } else {
    o.idx = min(a.idx, b.idx);
  }
  return o;
}

template <typename T>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
exit_gate_kernel(const T* __restrict__ logits,
                 const float* __restrict__ thresholds,
                 float* __restrict__ conf, float* __restrict__ entropy,
                 int32_t* __restrict__ pred, int32_t* __restrict__ fire,
                 int rows, int v) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;                      // whole warp leaves
  const T* x = logits + static_cast<int64_t>(row) * v;

  Lane acc{{-INFINITY, 0.f, 0.f, INT32_MAX}, 0.f, 0.f};
  for (int j = lane; j < v; j += kWarp) push(acc, to_float(x[j]), j);
  Stats st = acc.st;
  st.s -= acc.cs;
  st.t -= acc.ct;

#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    Stats other;
    other.m = __shfl_xor_sync(0xffffffffu, st.m, off);
    other.s = __shfl_xor_sync(0xffffffffu, st.s, off);
    other.t = __shfl_xor_sync(0xffffffffu, st.t, off);
    other.idx = __shfl_xor_sync(0xffffffffu, st.idx, off);
    st = merge(st, other);
  }

  if (lane == 0) {
    const float c = 1.f / st.s;
    conf[row] = c;
    entropy[row] = logf(st.s) - st.t / st.s;
    pred[row] = st.idx;
    fire[row] = c > thresholds[row] ? 1 : 0;
  }
}

template <typename T>
int launch(const void* logits, const void* thresholds, void* conf,
           void* entropy, void* pred, void* fire, int rows, int v,
           cudaStream_t stream) {
  const dim3 block(kWarp * kRowsPerBlock);
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  exit_gate_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<const float*>(thresholds),
      static_cast<float*>(conf), static_cast<float*>(entropy),
      static_cast<int32_t*>(pred), static_cast<int32_t*>(fire), rows, v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  Logits are a contiguous
// (rows, v) array; thresholds, conf, entropy, pred and fire are (rows,).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int exit_gate_launch(const void* logits, const void* thresholds,
                                void* conf, void* entropy, void* pred,
                                void* fire, int rows, int v, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(logits, thresholds, conf, entropy, pred, fire,
                           rows, v, s);
    case 1:
      return launch<__half>(logits, thresholds, conf, entropy, pred, fire,
                            rows, v, s);
    case 2:
      return launch<__nv_bfloat16>(logits, thresholds, conf, entropy, pred,
                                   fire, rows, v, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
