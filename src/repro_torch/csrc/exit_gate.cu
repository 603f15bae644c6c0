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
// The logits are read once, B*V*itemsize bytes at 3.35 TB/s; one exp and
// a few adds an element stay far below the fp32 rate.  exit_gate_plan
// picks one of three routes from V alone (the thresholds were measured on
// an H100; PERF.md has the sweep):
//
// short (V <= kShortMaxV, the classifier heads): kShortLanes lanes per
// row, each holding at most kShortMaxV / kShortLanes values from plain
// loads, two passes in registers (max and first argmax, then s and t)
// and two reductions over the lanes.  The bytes are a few tens of KB, so
// the route is bound by its launch and by the latency of its loads and
// reductions; thresholds[row] is read first so that its latency overlaps
// the logits'.  (A thread per row, and rows staged in shared memory
// by 16-byte loads, were both slower on the card: one row's serial chain
// or the staging outlasts the loads.)
//
// warp (V <= kWarpMaxV): one warp per row, kWarpRows rows a block.  Each
// lane holds its 16-byte vectors of the row in registers (scalar loads
// for a head and tail that are not 16-byte aligned): K = 4, 8 or 16 of
// them, the least class that covers V (PERF.md times each class against
// the next at the edge between them); two passes and two shuffle
// reductions.  Bound by bytes once the rows fill the card.
//
// split (wider rows, the LM vocabularies): V is cut into chunks of
// kSplitThreads * kSplitVectors 16-byte vectors (16 KB), one block a
// (row, chunk), so rows * chunks fills the 132 SMs from a handful of
// rows on.  A block reduces its chunk as the warp route reduces a row,
// with a block-wide step through shared memory, into a partial
// (m, s, t, idx); gate_merge_kernel merges a row's partials
// (s' = e^(m-M) s, t' = e^(m-M) (t + (m-M) s), equal maxima take the
// lower index).  The merge is a second kernel started by programmatic
// dependent launch, so its launch overlaps the partials; it waits
// (griddepcontrol.wait) before it reads them.  (On an H100, a merge
// through a cluster's shared memory was a little faster at a few rows and
// slower from 256 rows on.)  Bound by bytes.
//
// Every sum is a short run in one thread (at most 66 terms) and then a
// tree, so fp32 needs no compensation.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kShortMaxV = 64;
constexpr int kShortLanes = 16;         // lanes of a short row
constexpr int kShortThreads = 128;
constexpr int kWarpMaxV = 2048;
constexpr int kWarpRows = 4;            // rows (= warps) of a warp block
constexpr int kSplitThreads = 256;
constexpr int kSplitVectors = 4;        // 16-byte vectors a split thread
constexpr int kMergeRows = 8;           // rows (= warps) of a merge block

static_assert(kWarpMaxV <= 16 * kWarp * 4, "the warp route holds K <= 16");

enum Route { kShort = 0, kWarpRoute = 1, kSplit = 2 };

Route route_for(int v) {
  if (v <= kShortMaxV) return kShort;
  if (v <= kWarpMaxV) return kWarpRoute;
  return kSplit;
}

// Elements of T in one 16-byte vector, and columns of a split chunk.
template <typename T> __host__ __device__ constexpr int vec_width() {
  return 16 / sizeof(T);
}
template <typename T> __host__ __device__ constexpr int split_chunk() {
  return kSplitThreads * kSplitVectors * vec_width<T>();
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The W values of one 16-byte vector, in order.
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[4],
                                      float) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[8],
                                      __half) {
  const __half2* h = reinterpret_cast<const __half2*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[8],
                                      __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Lets the kernel launched after this one start (programmatic dependent
// launch); it still waits for this kernel's writes.
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Waits until the kernel ahead of a dependent launch has ended and its
// writes are visible.
__device__ __forceinline__ void wait_for_inputs() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// (m, idx) takes (om, oi) if om is larger, or equal at a lower index.
// The first element of a set is taken even at -inf, so a row of -inf
// gives index 0 as argmax does.
__device__ __forceinline__ void take_max(float& m, int& idx, float om,
                                         int oi) {
  if (om > m || (om == m && oi < idx)) {
    m = om;
    idx = oi;
  }
}

// Reductions over aligned groups of G lanes (G a power of two <= 32);
// every lane of a group ends with the group's result.
template <int G>
__device__ __forceinline__ void group_max(float& m, int& idx) {
#pragma unroll
  for (int off = G / 2; off > 0; off /= 2) {
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    take_max(m, idx, om, oi);
  }
}

template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// e^d as 2^(d log2 e): one fp32 multiply ahead of the hardware exp2.
__device__ __forceinline__ float exp_of(float d) {
  return exp2f(d * 1.4426950408889634f);
}

// Adds the terms of logit x to s = sum e^(x-m) and t = sum (x-m) e^(x-m).
__device__ __forceinline__ void add_term(float x, float m, float& s,
                                         float& t) {
  const float d = x - m;
  const float e = exp_of(d);
  s += e;
  t = fmaf(d, e, t);
}

// The thread's share of n contiguous logits at p (columns col0 ...) when
// G threads share them: scalar head elements up to the first 16-byte
// boundary (thread g takes head element g), vectors g, g + G, ... (at
// most K of them), then scalar tail elements.  Each thread sees its
// elements in increasing column order.
template <typename T, int K, int G>
struct Span {
  static constexpr int W = vec_width<T>();
  uint4 vec[K];
  float head_x, tail_x;
  int head, nvec, tail0, n, col0;

  __device__ __forceinline__ void load(const T* p, int n_, int col0_,
                                       int g) {
    n = n_;
    col0 = col0_;
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(p) % 16);
    head = min(n, static_cast<int>((16 - mis) % 16 / sizeof(T)));
    nvec = (n - head) / W;
    tail0 = head + nvec * W;
    const uint4* vp = reinterpret_cast<const uint4*>(p + head);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = g + k * G;
      if (q < nvec) vec[k] = __ldg(vp + q);
    }
    if (g < head) head_x = to_float(p[g]);
    if (tail0 + g < n) tail_x = to_float(p[tail0 + g]);
  }

  template <typename F>
  __device__ __forceinline__ void each(int g, F&& f) const {
    if (g < head) f(head_x, col0 + g);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = g + k * G;
      if (q < nvec) {
        float x[W];
        unpack(vec[k], x, T());
#pragma unroll
        for (int i = 0; i < W; ++i) f(x[i], col0 + head + q * W + i);
      }
    }
    if (tail0 + g < n) f(tail_x, col0 + tail0 + g);
  }

  __device__ __forceinline__ void first_max(int g, float& m, int& idx) const {
    m = -INFINITY;
    idx = INT32_MAX;
    each(g, [&](float x, int j) { take_max(m, idx, x, j); });
  }

  __device__ __forceinline__ void sums(int g, float mx, float& s,
                                       float& t) const {
    s = 0.f;
    t = 0.f;
    each(g, [&](float x, int) { add_term(x, mx, s, t); });
  }
};

// tau is thresholds[row], which the caller reads first.
__device__ __forceinline__ void write_row(int row, float s, float t, int idx,
                                          float tau, float* conf,
                                          float* entropy, int32_t* pred,
                                          int32_t* fire) {
  const float c = 1.f / s;
  conf[row] = c;
  entropy[row] = logf(s) - t * c;
  pred[row] = idx;
  fire[row] = c > tau ? 1 : 0;
}

// ---------------------------------------------------------------------------
// short route: kShortLanes lanes per row, the row in registers
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kShortThreads)
gate_short_kernel(const T* __restrict__ logits,
                  const float* __restrict__ thresholds,
                  float* __restrict__ conf, float* __restrict__ entropy,
                  int32_t* __restrict__ pred, int32_t* __restrict__ fire,
                  int rows, int v) {
  constexpr int J = kShortMaxV / kShortLanes;   // values a lane holds
  const int lane = threadIdx.x % kShortLanes;
  const int row = blockIdx.x * (kShortThreads / kShortLanes) +
                  threadIdx.x / kShortLanes;
  // a row past the end still takes part in its warp's shuffles
  const bool live = row < rows;
  const float tau = live && lane == 0 ? thresholds[row] : 0.f;
  const T* p = logits + static_cast<int64_t>(row) * v;
  float x[J];
#pragma unroll
  for (int k = 0; k < J; ++k) {
    const int j = lane + k * kShortLanes;
    if (live && j < v) x[k] = to_float(p[j]);
  }
  float m = -INFINITY;
  int idx = INT32_MAX;
#pragma unroll
  for (int k = 0; k < J; ++k) {
    const int j = lane + k * kShortLanes;
    if (live && j < v) take_max(m, idx, x[k], j);
  }
  group_max<kShortLanes>(m, idx);
  float s = 0.f, t = 0.f;
#pragma unroll
  for (int k = 0; k < J; ++k)
    if (live && lane + k * kShortLanes < v) add_term(x[k], m, s, t);
  s = group_sum<kShortLanes>(s);
  t = group_sum<kShortLanes>(t);
  if (live && lane == 0)
    write_row(row, s, t, idx, tau, conf, entropy, pred, fire);
}

// ---------------------------------------------------------------------------
// warp route: one warp per row, the row in registers
// ---------------------------------------------------------------------------

template <typename T, int K>
__global__ void __launch_bounds__(kWarp * kWarpRows)
gate_warp_kernel(const T* __restrict__ logits,
                 const float* __restrict__ thresholds,
                 float* __restrict__ conf, float* __restrict__ entropy,
                 int32_t* __restrict__ pred, int32_t* __restrict__ fire,
                 int rows, int v) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarpRows + threadIdx.x / kWarp;
  if (row >= rows) return;                      // whole warp leaves
  const float tau = lane == 0 ? thresholds[row] : 0.f;
  Span<T, K, kWarp> sp;
  sp.load(logits + static_cast<int64_t>(row) * v, v, 0, lane);
  float m;
  int idx;
  sp.first_max(lane, m, idx);
  group_max<kWarp>(m, idx);
  float s, t;
  sp.sums(lane, m, s, t);
  s = group_sum<kWarp>(s);
  t = group_sum<kWarp>(t);
  if (lane == 0)
    write_row(row, s, t, idx, tau, conf, entropy, pred, fire);
}

// ---------------------------------------------------------------------------
// split route: a block per (row, chunk) writes a partial, then a merge
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
gate_partial_kernel(const T* __restrict__ logits, float4* __restrict__ part,
                    int v, int chunks) {
  constexpr int kWarps = kSplitThreads / kWarp;
  constexpr int C = split_chunk<T>();
  __shared__ float red_m[kWarps], red_s[kWarps], red_t[kWarps];
  __shared__ int red_i[kWarps];
  allow_dependents();
  const int g = threadIdx.x, lane = g % kWarp, warp = g / kWarp;
  const int row = blockIdx.x / chunks;
  const int col0 = (blockIdx.x - row * chunks) * C;
  Span<T, kSplitVectors, kSplitThreads> sp;
  sp.load(logits + static_cast<int64_t>(row) * v + col0, min(C, v - col0),
          col0, g);

  float m;
  int idx;
  sp.first_max(g, m, idx);
  group_max<kWarp>(m, idx);
  if (lane == 0) {
    red_m[warp] = m;
    red_i[warp] = idx;
  }
  __syncthreads();
  m = red_m[0];
  idx = red_i[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) take_max(m, idx, red_m[w], red_i[w]);

  float s, t;
  sp.sums(g, m, s, t);
  s = group_sum<kWarp>(s);
  t = group_sum<kWarp>(t);
  if (lane == 0) {
    red_s[warp] = s;
    red_t[warp] = t;
  }
  __syncthreads();
  if (g == 0) {
    s = red_s[0];
    t = red_t[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      s += red_s[w];
      t += red_t[w];
    }
    part[blockIdx.x] = make_float4(m, s, t, __int_as_float(idx));
  }
}

// One warp per row: the row max M over the partials, then the partials'
// sums rescaled to M.  A chunk whose max is -inf holds nothing that
// counts (its own sums are NaN) and is skipped, unless the whole row is
// -inf, whose NaN the plain version gives too.
__global__ void __launch_bounds__(kWarp * kMergeRows)
gate_merge_kernel(const float4* __restrict__ part,
                  const float* __restrict__ thresholds,
                  float* __restrict__ conf, float* __restrict__ entropy,
                  int32_t* __restrict__ pred, int32_t* __restrict__ fire,
                  int rows, int chunks) {
  wait_for_inputs();
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kMergeRows + threadIdx.x / kWarp;
  if (row >= rows) return;                      // whole warp leaves
  const float tau = lane == 0 ? thresholds[row] : 0.f;
  const float4* pr = part + static_cast<int64_t>(row) * chunks;
  float m = -INFINITY;
  int idx = INT32_MAX;
  for (int c = lane; c < chunks; c += kWarp) {
    const float4 q = pr[c];
    take_max(m, idx, q.x, __float_as_int(q.w));
  }
  group_max<kWarp>(m, idx);
  float s = 0.f, t = 0.f;
  for (int c = lane; c < chunks; c += kWarp) {
    const float4 q = pr[c];
    if (q.x > -INFINITY || m == -INFINITY) {
      const float d = q.x - m;
      const float r = exp_of(d);
      s = fmaf(r, q.y, s);
      t = fmaf(r, fmaf(d, q.y, q.z), t);
    }
  }
  s = group_sum<kWarp>(s);
  t = group_sum<kWarp>(t);
  if (lane == 0)
    write_row(row, s, t, idx, tau, conf, entropy, pred, fire);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Launch `kern` on `stream`.  A dependent launch (the split route's
// merge) may start before the kernel ahead of it ends (programmatic
// dependent launch); the kernel waits for it with griddepcontrol.wait.
template <typename... Params, typename... Args>
int start_kernel(void (*kern)(Params...), int grid, int block,
                 cudaStream_t stream, bool dependent, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kern, args...));
}

// Elements of a 16-byte vector for a dtype (0 = float32, else 2 bytes).
int width_of(int dtype) { return dtype == 0 ? 4 : 8; }

int split_columns(int dtype) {
  return kSplitThreads * kSplitVectors * width_of(dtype);
}

// K, the 16-byte vectors a lane of the warp route holds: the least class
// that covers V (w elements a vector).
int warp_vectors(int v, int w) {
  const int k = (v + kWarp * w - 1) / (kWarp * w);
  return k <= 4 ? 4 : k <= 8 ? 8 : 16;
}

int chunks_of(int v, int columns) { return (v + columns - 1) / columns; }

template <typename T, int K>
int launch_warp_k(const T* x, const float* th, float* conf, float* ent,
                  int32_t* pred, int32_t* fire, int rows, int v,
                  cudaStream_t s) {
  return start_kernel(gate_warp_kernel<T, K>,
                      (rows + kWarpRows - 1) / kWarpRows, kWarp * kWarpRows,
                      s, false, x, th, conf, ent, pred, fire, rows, v);
}

template <typename T>
int launch_warp(const T* x, const float* th, float* conf, float* ent,
                int32_t* pred, int32_t* fire, int rows, int v,
                cudaStream_t s) {
  switch (warp_vectors(v, vec_width<T>())) {
    case 4:
      return launch_warp_k<T, 4>(x, th, conf, ent, pred, fire, rows, v, s);
    case 8:
      return launch_warp_k<T, 8>(x, th, conf, ent, pred, fire, rows, v, s);
    default:
      return launch_warp_k<T, 16>(x, th, conf, ent, pred, fire, rows, v, s);
  }
}

template <typename T>
int launch(const void* logits, const float* th, float* conf, float* ent,
           int32_t* pred, int32_t* fire, void* workspace, int rows, int v,
           cudaStream_t s) {
  const T* x = static_cast<const T*>(logits);
  switch (route_for(v)) {
    case kShort: {
      constexpr int per_block = kShortThreads / kShortLanes;
      return start_kernel(gate_short_kernel<T>,
                          (rows + per_block - 1) / per_block, kShortThreads,
                          s, false, x, th, conf, ent, pred, fire, rows, v);
    }
    case kWarpRoute:
      return launch_warp<T>(x, th, conf, ent, pred, fire, rows, v, s);
    default: {
      const int chunks = chunks_of(v, split_chunk<T>());
      float4* part = static_cast<float4*>(workspace);
      const int err = start_kernel(gate_partial_kernel<T>, rows * chunks,
                                   kSplitThreads, s, false, x, part, v,
                                   chunks);
      if (err) return err;
      return start_kernel(gate_merge_kernel,
                          (rows + kMergeRows - 1) / kMergeRows,
                          kWarp * kMergeRows, s, true,
                          static_cast<const float4*>(part), th, conf, ent,
                          pred, fire, rows, chunks);
    }
  }
}

bool valid(int rows, int v, int dtype) {
  if (rows < 1 || v < 1 || dtype < 0 || dtype > 2) return false;
  // the split grid is one dimension of rows * chunks blocks
  return route_for(v) != kSplit ||
         static_cast<int64_t>(rows) * chunks_of(v, split_columns(dtype)) <=
             INT32_MAX;
}

}  // namespace

// The route and workspace of a launch over logits (rows, v):
// plan[0] = route (0 short, 1 warp, 2 split), plan[1] = bytes of the
// partials workspace (0 unless split), plan[2] = the most columns the
// route's unit holds at this V: a short row, a warp row of its K class,
// a split chunk.  dtype as for exit_gate_launch.  Returns 0, or
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int exit_gate_plan(int rows, int v, int dtype, int64_t* plan) {
  if (!valid(rows, v, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const Route r = route_for(v);
  const int w = width_of(dtype);
  const int columns = r == kShort       ? kShortMaxV
                      : r == kWarpRoute ? warp_vectors(v, w) * kWarp * w
                                        : split_columns(dtype);
  plan[0] = r;
  plan[1] = r == kSplit
                ? static_cast<int64_t>(rows) * chunks_of(v, columns) * 16
                : 0;
  plan[2] = columns;
  return 0;
}

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  Logits are a contiguous
// (rows, v) array at any element-aligned address; thresholds, conf,
// entropy, pred and fire are (rows,); workspace (16-byte aligned) as
// exit_gate_plan sizes it.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int exit_gate_launch(const void* logits, const void* thresholds,
                                void* conf, void* entropy, void* pred,
                                void* fire, void* workspace, int rows, int v,
                                int dtype, void* stream) {
  if (!valid(rows, v, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* th = static_cast<const float*>(thresholds);
  float* c = static_cast<float*>(conf);
  float* e = static_cast<float*>(entropy);
  int32_t* p = static_cast<int32_t*>(pred);
  int32_t* f = static_cast<int32_t*>(fire);
  switch (dtype) {
    case 0:
      return launch<float>(logits, th, c, e, p, f, workspace, rows, v, s);
    case 1:
      return launch<__half>(logits, th, c, e, p, f, workspace, rows, v, s);
    default:
      return launch<__nv_bfloat16>(logits, th, c, e, p, f, workspace, rows,
                                   v, s);
  }
}
