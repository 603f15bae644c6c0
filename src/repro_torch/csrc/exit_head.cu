// Fused decode-time LM exit head (paper Alg. 1, lines 5-9, LM domain)
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/exit_head/exit_head_kernel.py
// (`_kernel` / `exit_head_gate_pallas`).  Per row b of h (B, D), in fp32:
//   hn     = h * rsqrt(mean(h^2) + eps) * scale     (never cast back)
//   l_v    = sum_d table[v, d] * hn[d]               (fp32 FMAs)
//   conf   = 1 / sum_v exp(l_v - max_v l_v)
//   pred   = first argmax of l (ties go to the lowest index)
//   fire   = conf > tau' (strict)
// The (B, V) logits never reach device memory.
//
// Bound on an H100: the (V, D) table is the only large input.  Read
// once it is V*D*itemsize bytes (131 MB at TinyLlama's V = 32000,
// D = 2048 in bf16: 0.039 ms at 3.35 TB/s).  The B*V*D fp32 FMAs run
// outside the tensor cores (67 TFLOP/s): at B = 64 they take 0.125 ms,
// so from a few dozen rows on the kernel is bound by operations.
//
// Design (split vocabulary): the grid is (vocab slice x row tile).  A
// block of 256 threads takes MT rows (4, 16 or 64, the smallest that
// holds B, so for B <= 64 every table row is read from memory exactly
// once per launch) and a slice of NT vocabulary rows.  It normalises
// its rows' squared sums first, then walks D in tiles of KT: each tile
// of the table slice is loaded with 16-byte vector loads into registers
// while the previous tile is multiplied, stored to shared memory in
// fp32 (transposed, padded against bank conflicts), and each thread
// accumulates a TM x TN register tile of logits with FMAs, so every
// table value loaded serves TM rows and every hn value TN vocabulary
// rows.  The block then reduces its logits to one partial (max, sum,
// first argmax) per (row, slice); a second small kernel merges the
// partials of each row in slice order and writes conf, pred and fire.
// Any V and D work: the last slice and the last D tile are masked, and
// a D whose rows are not 16-byte multiples takes scalar loads.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Tiles per row-tile size MT: TM rows x TN vocabulary entries a thread,
// KT values of D per shared-memory tile.
template <int MT> struct Tile;
template <> struct Tile<4> {
  static constexpr int TM = 4, TN = 1, KT = 64;
};
template <> struct Tile<16> {
  static constexpr int TM = 4, TN = 4, KT = 64;
};
template <> struct Tile<64> {
  static constexpr int TM = 8, TN = 4, KT = 32;
};

template <int MT> struct Shape {
  static constexpr int TM = Tile<MT>::TM;
  static constexpr int TN = Tile<MT>::TN;
  static constexpr int KT = Tile<MT>::KT;
  static constexpr int NG = kThreads / (MT / TM);   // threads along vocab
  static constexpr int NT = NG * TN;                 // vocabulary slice
  static constexpr int SLD = NT + 1;                 // padded sT row
  static constexpr size_t kSmemBytes =
      sizeof(float) * (KT * MT + KT * SLD + MT);
};

// Online softmax statistics; an empty set has s == 0.
struct Stats {
  float m;
  float s;
  int idx;
};

__device__ __forceinline__ Stats merge(const Stats& a, const Stats& b) {
  if (b.s == 0.f) return a;
  if (a.s == 0.f) return b;
  Stats o;
  o.m = fmaxf(a.m, b.m);
  o.s = a.s * expf(a.m - o.m) + b.s * expf(b.m - o.m);
  if (a.m > b.m) {
    o.idx = a.idx;
  } else if (b.m > a.m) {
    o.idx = b.idx;
  } else {
    o.idx = min(a.idx, b.idx);          // ties: the lowest index
  }
  return o;
}

__device__ __forceinline__ Stats shfl_merge(Stats st) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    Stats o;
    o.m = __shfl_xor_sync(0xffffffffu, st.m, off);
    o.s = __shfl_xor_sync(0xffffffffu, st.s, off);
    o.idx = __shfl_xor_sync(0xffffffffu, st.idx, off);
    st = merge(st, o);
  }
  return st;
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* out) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < int(16 / sizeof(T)); ++j) out[j] = to_float(e[j]);
}

// Partial (max, sum, argmax) of each row over one vocabulary slice.
template <typename T, int MT, bool kVector>
__global__ void __launch_bounds__(kThreads)
head_partial_kernel(const T* __restrict__ h, const T* __restrict__ scale,
                    const T* __restrict__ table, float* __restrict__ part_m,
                    float* __restrict__ part_s, int* __restrict__ part_i,
                    int rows, int d, int v, float eps) {
  using S = Shape<MT>;
  constexpr int TM = S::TM, TN = S::TN, KT = S::KT, NG = S::NG,
                NT = S::NT, SLD = S::SLD;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = KT / VEC;                    // vectors per row
  constexpr int T_PER = (NT * CHUNKS + kThreads - 1) / kThreads;
  constexpr int H_PER = (MT * CHUNKS + kThreads - 1) / kThreads;

  extern __shared__ float smem[];
  float* sH = smem;                     // [KT][MT]   hn tile
  float* sT = sH + KT * MT;             // [KT][SLD]  table tile, transposed
  float* rinv = sT + KT * SLD;          // [MT]       1 / rms per row

  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int v0 = blockIdx.x * NT;
  const int row0 = blockIdx.y * MT;
  const int n_tiles = (d + KT - 1) / KT;

  // 1 / rms of each row of the tile (one warp per row)
  for (int m = warp; m < MT; m += kThreads / kWarp) {
    const int row = row0 + m;
    float ss = 0.f;
    if (row < rows) {
      const T* x = h + static_cast<int64_t>(row) * d;
      for (int k = lane; k < d; k += kWarp) {
        const float f = to_float(x[k]);
        ss = fmaf(f, f, ss);
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) rinv[m] = row < rows ? rsqrtf(ss / d + eps) : 0.f;
  }
  __syncthreads();

  uint4 treg[T_PER];
  uint4 hreg[H_PER];
  uint4 sreg[H_PER];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // vector loads of tile `t` into registers (rows/columns past the edge
  // load zeros)
  auto fetch = [&](int t) {
    const int k0 = t * KT;
#pragma unroll
    for (int r = 0; r < T_PER; ++r) {
      const int e = tid + r * kThreads;
      const int n = e / CHUNKS, kk = k0 + (e % CHUNKS) * VEC;
      treg[r] = zero;
      if (e < NT * CHUNKS && v0 + n < v && kk < d)
        treg[r] = *reinterpret_cast<const uint4*>(
            table + static_cast<int64_t>(v0 + n) * d + kk);
    }
#pragma unroll
    for (int r = 0; r < H_PER; ++r) {
      const int e = tid + r * kThreads;
      const int m = e / CHUNKS, kk = k0 + (e % CHUNKS) * VEC;
      hreg[r] = zero;
      sreg[r] = zero;
      if (e < MT * CHUNKS && row0 + m < rows && kk < d) {
        hreg[r] = *reinterpret_cast<const uint4*>(
            h + static_cast<int64_t>(row0 + m) * d + kk);
        sreg[r] = *reinterpret_cast<const uint4*>(scale + kk);
      }
    }
  };
  // registers of the fetched tile -> shared memory, in fp32
  auto stash = [&]() {
#pragma unroll
    for (int r = 0; r < T_PER; ++r) {
      const int e = tid + r * kThreads;
      if (e >= NT * CHUNKS) break;
      const int n = e / CHUNKS, c = e % CHUNKS;
      float f[VEC];
      unpack<T>(treg[r], f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) sT[(c * VEC + j) * SLD + n] = f[j];
    }
#pragma unroll
    for (int r = 0; r < H_PER; ++r) {
      const int e = tid + r * kThreads;
      if (e >= MT * CHUNKS) break;
      const int m = e / CHUNKS, c = e % CHUNKS;
      float x[VEC], s[VEC];
      unpack<T>(hreg[r], x);
      unpack<T>(sreg[r], s);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        sH[(c * VEC + j) * MT + m] = x[j] * rinv[m] * s[j];
    }
  };
  // scalar loads of tile `t` straight into shared memory
  auto load_scalar = [&](int t) {
    const int k0 = t * KT;
    for (int e = tid; e < NT * KT; e += kThreads) {
      const int n = e / KT, k = e % KT;
      float f = 0.f;
      if (v0 + n < v && k0 + k < d)
        f = to_float(table[static_cast<int64_t>(v0 + n) * d + k0 + k]);
      sT[k * SLD + n] = f;
    }
    for (int e = tid; e < MT * KT; e += kThreads) {
      const int m = e / KT, k = e % KT;
      float f = 0.f;
      if (row0 + m < rows && k0 + k < d)
        f = to_float(h[static_cast<int64_t>(row0 + m) * d + k0 + k]) *
            rinv[m] * to_float(scale[k0 + k]);
      sH[k * MT + m] = f;
    }
  };

  const int cg = tid % NG, rg = tid / NG;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (kVector) fetch(0);
  for (int t = 0; t < n_tiles; ++t) {
    if (kVector) {
      stash();
    } else {
      load_scalar(t);
    }
    __syncthreads();
    if (kVector && t + 1 < n_tiles) fetch(t + 1);   // in flight meanwhile
#pragma unroll 8
    for (int k = 0; k < KT; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sH[k * MT + rg * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sT[k * SLD + cg + j * NG];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // (max, sum, first argmax) per row: this thread's TN logits, then the
  // warp (all lanes share a row group), then the warps of a row group
  constexpr int WPR = NG / kWarp;                     // warps per row group
  Stats* red = reinterpret_cast<Stats*>(sT);          // [warps][TM]
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    Stats st{-INFINITY, 0.f, INT32_MAX};
    float mx = -INFINITY;
    int arg = INT32_MAX;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = v0 + cg + j * NG;               // increasing in j
      if (col < v && acc[i][j] > mx) {
        mx = acc[i][j];
        arg = col;
      }
    }
    if (arg != INT32_MAX) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (v0 + cg + j * NG < v) s += expf(acc[i][j] - mx);
      st = Stats{mx, s, arg};
    }
    st = shfl_merge(st);
    if (lane == 0) red[warp * TM + i] = st;
  }
  __syncthreads();
  if (tid < MT) {
    const int g = tid / TM, i = tid % TM, row = row0 + tid;
    Stats st = red[(g * WPR) * TM + i];
    for (int w = 1; w < WPR; ++w) st = merge(st, red[(g * WPR + w) * TM + i]);
    if (row < rows) {
      const int64_t o = static_cast<int64_t>(row) * gridDim.x + blockIdx.x;
      part_m[o] = st.m;
      part_s[o] = st.s;
      part_i[o] = st.idx;
    }
  }
}

// One warp per row merges the row's partials, in slice order per lane
// and by (max, lowest index) across lanes.
__global__ void __launch_bounds__(kThreads)
head_merge_kernel(const float* __restrict__ part_m,
                  const float* __restrict__ part_s,
                  const int* __restrict__ part_i,
                  const float* __restrict__ thresholds,
                  float* __restrict__ conf, int32_t* __restrict__ pred,
                  int32_t* __restrict__ fire, int rows, int n_slices) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp;
  if (row >= rows) return;                          // whole warp leaves
  const int64_t base = static_cast<int64_t>(row) * n_slices;
  Stats st{-INFINITY, 0.f, INT32_MAX};
  for (int j = lane; j < n_slices; j += kWarp)
    st = merge(st, Stats{part_m[base + j], part_s[base + j],
                         part_i[base + j]});
  st = shfl_merge(st);
  if (lane == 0) {
    const float c = 1.f / st.s;
    conf[row] = c;
    pred[row] = st.idx;
    fire[row] = c > thresholds[row] ? 1 : 0;
  }
}

template <int MT> int slices_for(int v) {
  return (v + Shape<MT>::NT - 1) / Shape<MT>::NT;
}

int slices(int rows, int v) {
  if (rows <= 4) return slices_for<4>(v);
  if (rows <= 16) return slices_for<16>(v);
  return slices_for<64>(v);
}

template <typename T, int MT, bool kVector>
int launch_partial(const void* h, const void* scale, const void* table,
                   float* pm, float* ps, int* pi, int rows, int d, int v,
                   float eps, cudaStream_t stream) {
  constexpr size_t smem = Shape<MT>::kSmemBytes;
  auto kern = head_partial_kernel<T, MT, kVector>;
  static bool configured = false;          // once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(slices_for<MT>(v), (rows + MT - 1) / MT);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(scale),
      static_cast<const T*>(table), pm, ps, pi, rows, d, v, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVector>
int launch_partial_rows(const void* h, const void* scale, const void* table,
                        float* pm, float* ps, int* pi, int rows, int d,
                        int v, float eps, cudaStream_t stream) {
  if (rows <= 4)
    return launch_partial<T, 4, kVector>(h, scale, table, pm, ps, pi, rows,
                                         d, v, eps, stream);
  if (rows <= 16)
    return launch_partial<T, 16, kVector>(h, scale, table, pm, ps, pi, rows,
                                          d, v, eps, stream);
  return launch_partial<T, 64, kVector>(h, scale, table, pm, ps, pi, rows, d,
                                        v, eps, stream);
}

template <typename T>
int launch(const void* h, const void* scale, const void* table,
           const void* thresholds, void* conf, void* pred, void* fire,
           void* part_f, void* part_i, int rows, int d, int v, float eps,
           cudaStream_t stream) {
  const int n = slices(rows, v);
  float* pm = static_cast<float*>(part_f);
  float* ps = pm + static_cast<int64_t>(rows) * n;
  int* pi = static_cast<int*>(part_i);
  // 16-byte vectors need 16-byte rows and 16-byte aligned bases
  const bool vec =
      (d * sizeof(T)) % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(scale) |
       reinterpret_cast<uintptr_t>(table)) % 16 == 0;
  const int err = vec ? launch_partial_rows<T, true>(h, scale, table, pm, ps,
                                                     pi, rows, d, v, eps,
                                                     stream)
                      : launch_partial_rows<T, false>(h, scale, table, pm, ps,
                                                      pi, rows, d, v, eps,
                                                      stream);
  if (err) return err;
  const int per_block = kThreads / kWarp;
  head_merge_kernel<<<(rows + per_block - 1) / per_block, kThreads, 0,
                      stream>>>(pm, ps, pi,
                                static_cast<const float*>(thresholds),
                                static_cast<float*>(conf),
                                static_cast<int32_t*>(pred),
                                static_cast<int32_t*>(fire), rows, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Number of vocabulary slices a launch over `rows` rows uses: the caller
// allocates part_f as (2, rows, slices) float32 and part_i as (rows,
// slices) int32.
extern "C" int exit_head_slices(int rows, int v) { return slices(rows, v); }

// dtype: 0 = float32, 1 = float16, 2 = bfloat16, shared by h (rows, d),
// scale (d,) and table (v, d), all contiguous; thresholds (rows,) float32;
// conf float32, pred and fire int32, each (rows,).  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int exit_head_launch(const void* h, const void* scale,
                                const void* table, const void* thresholds,
                                void* conf, void* pred, void* fire,
                                void* part_f, void* part_i, int rows, int d,
                                int v, int dtype, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(h, scale, table, thresholds, conf, pred, fire,
                           part_f, part_i, rows, d, v, eps, s);
    case 1:
      return launch<__half>(h, scale, table, thresholds, conf, pred, fire,
                            part_f, part_i, rows, d, v, eps, s);
    case 2:
      return launch<__nv_bfloat16>(h, scale, table, thresholds, conf, pred,
                                   fire, part_f, part_i, rows, d, v, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
