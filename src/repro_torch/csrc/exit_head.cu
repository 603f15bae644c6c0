// Fused decode-time LM exit head (paper Alg. 1, lines 5-9, LM domain)
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/exit_head/exit_head_kernel.py
// (`_kernel` / `exit_head_gate_pallas`).  Per row b of h (B, D), in fp32:
//   hn     = h * rsqrt(mean(h^2) + eps) * scale     (never cast back)
//   l_v    = sum_d table[v, d] * hn[d]               (fp32-accurate)
//   conf   = 1 / sum_v exp(l_v - max_v l_v)
//   pred   = first argmax of l (ties go to the lowest index)
//   fire   = conf > tau' (strict)
// The (B, V) logits never reach device memory.
//
// Bound on an H100: the (V, D) table is the only large input.  Read once
// it is V*D*itemsize bytes: 131 MB at TinyLlama's V = 32000, D = 2048 in
// bf16, 0.039 ms at 3.35 TB/s.  Three bf16 tensor-core passes of
// 2*B*V*D flop at 989 TFLOP/s stay under that up to B ~ 100 (0.025 ms at
// B = 64); from there the tensor cores bound it (0.102 ms at B = 256).
//
// Which design a launch takes depends on the dtype alone:
//
// bf16 tables: tensor cores (head_split_kernel, head_tc_kernel).  A bf16
// table element is exact in bf16, so only hn needs more bits.  A first
// small kernel computes hn in fp32 once per launch and splits it into
// three bf16 terms, hi = bf16(hn), mid = bf16(hn - hi) and
// lo = bf16(hn - hi - mid): 8 + 8 + 8 bits hold hn's 24, so hn enters
// the products exact to fp32, whatever the input.  (Two terms hold 16
// bits; tests/test_torch_kernels.py emulates both and writes down what
// each costs.)  Each product table * term is exact in fp32, so three
// wgmma passes over the same table tile give the fp32-accurate logits,
// and the table is still read once.  Hopper's tensor cores do not round
// their fp32 sums like an fp32 FMA chain: over D = 2048 a sum kept in
// the wgmma accumulator loses low bits (on an NVIDIA H100 80GB HBM3 an
// unpromoted build of an earlier design moved conf by ~8e-6 from
// float64, close to the 1e-5 that the card's check allows).  So the
// wgmmas of each 64-wide K tile start a fresh sum (promotion), and it is
// added into a separate fp32 register sum with fp32 adds.
//
// Orientation (swap-AB): the table is the 64-row M side of wgmma, the
// B rows of hn the N side (N = 16, 32, 64 or 112, the smallest that
// holds B), so a block of 256 vocabulary rows keeps its logits of up to
// 112 rows in registers (112 is the most that fits beside the promoted
// sums).  For B <= 112 the grid reads every table element from device
// memory once; a larger B takes N tiles of 64, whose blocks for one
// vocabulary tile are launched side by side so that all but the first
// read the table tile from L2.
//
// Feeding: a producer warpgroup (one warp of it working, its registers
// handed to the consumers with setmaxnreg) keeps a ring of three stages
// in flight on mbarriers: the table tile (256 x 64) by TMA with the
// 128-byte swizzle, and the three terms of hn for the same 64 values of
// D, stored pre-swizzled by the split kernel, by one bulk copy.  Two
// consumer warpgroups each take two M tiles; a warp loads its table
// fragments once with ldmatrix and runs the three passes with them from
// registers, so shared memory serves each table tile once per M tile
// instead of once per term.  The first stages' table tiles are requested
// before the split kernel ends (programmatic dependent launch), and the
// merge kernel is launched the same way.  A row of D that TMA cannot
// describe (D not a multiple of 8, or an unaligned table) is staged by
// the producer warp itself into the same swizzled layout, zero-padded.
// The last vocabulary tile and the last K tile are masked (TMA's zero
// fill; rows past V are left out of the epilogue).  The epilogue reduces
// each block's logits to one partial (max, sum, first argmax) per (row,
// vocabulary tile), and head_merge_kernel merges a row's partials in
// tile order into conf, pred and fire.
//
// f32 and f16 tables: SIMT (head_partial_kernel).  fp32 FMAs outside
// the tensor cores (67 TFLOP/s: 0.125 ms at B = 64).  f16 cannot take
// the split as it stands (its low terms fall into subnormals), and a
// 3xTF32 design for f32 is later work.  The grid is (vocabulary slice x
// row tile).  A block of 256 threads takes MT rows (4, 16 or 64, the
// smallest that holds B, so for B <= 64 every table row is read from
// memory exactly once per launch) and a slice of NT vocabulary rows.  It
// normalises its rows' squared sums first, then walks D in tiles of KT:
// each tile of the table slice is loaded with 16-byte vector loads into
// registers while the previous tile is multiplied, stored to shared
// memory in fp32 (transposed, padded against bank conflicts), and each
// thread accumulates a TM x TN register tile of logits, so every table
// value loaded serves TM rows and every hn value TN vocabulary rows.
// Any V and D work: the last slice and the last D tile are masked, and a
// D whose rows are not 16-byte multiples takes scalar loads.
#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;

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

// Launch `kern` on `stream` so that it may start before the kernel ahead
// of it ends (programmatic dependent launch): it waits for that kernel
// with griddepcontrol.wait before it reads the kernel's output.
template <typename... Params, typename... Args>
int launch_dependent(void (*kern)(Params...), dim3 grid, dim3 block,
                     size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kern, args...));
}

// ---------------------------------------------------------------------------
// SIMT design (f32 and f16 tables)
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

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

// ---------------------------------------------------------------------------
// Tensor-core design (bf16 tables)
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kK = 64;                    // D values a stage: 128 bytes
constexpr int kTV = 256;                  // vocabulary rows a block
constexpr int kConsumerWarps = 8;         // two warpgroups, two M tiles each
// + a producer warpgroup: registers are handed out per warpgroup, so the
// producer gives its own back (setmaxnreg) for the consumers' sums
constexpr int kThreads = (kConsumerWarps + 4) * kWarp;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;        // 256 x 232 + 128 x 40 <= 65536
constexpr int kMaxN = 112;                // rows of hn a block
constexpr int kTerms = 3;                 // hi, mid, lo
// Three stages: a stage of the widest N class is 74 KB (32 KB of table,
// 42 KB of hn terms), and three fill the 227 KB a block may have; three
// 32 KB table tiles in flight per SM are more than the ~25 KB that keep
// the card's memory busy.
constexpr int kStages = 3;
constexpr uint32_t kTableBytes = kTV * kK * 2;           // 32 KB
constexpr uint32_t kRowBytes = kK * 2;                   // one swizzled row

template <int N> struct Cfg {
  static_assert(N % 16 == 0 && N <= kMaxN, "N class");
  static constexpr int kAcc = N / 2;      // accumulator floats a thread
  static constexpr uint32_t kTermBytes = N * kRowBytes;
  static constexpr uint32_t kHnBytes = kTerms * kTermBytes;
  static constexpr uint32_t kStageBytes = kTableBytes + kHnBytes;
  // 1024 bytes of slack align the ring to the swizzle's 1024-byte atom
  static constexpr size_t kSmemBytes =
      1024 + size_t{kStages} * kStageBytes + 2 * kStages * sizeof(uint64_t);
};

// Rows of hn a block takes (the wgmma N) and the number of N tiles.
struct Rows {
  int n;
  int tiles;
};

Rows rows_plan(int rows) {
  // up to 112 rows one N tile, the smallest class that holds them; more
  // rows take tiles of 64
  if (rows > kMaxN) return Rows{64, (rows + 63) / 64};
  return Rows{rows <= 16 ? 16 : rows <= 32 ? 32 : rows <= 64 ? 64 : kMaxN, 1};
}

int vocab_tiles(int v) { return (v + kTV - 1) / kTV; }
__host__ __device__ __forceinline__ int k_tiles(int d) {
  return (d + kK - 1) / kK;
}

size_t split_bytes(int rows, int d) {
  const Rows r = rows_plan(rows);
  return size_t{kTerms} * r.n * kRowBytes * k_tiles(d) * r.tiles;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// arrive once and expect `bytes` more from asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// contiguous bytes (16-byte aligned, a multiple of 16) into shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Byte offset of element k (of 64) of row r in a tile of 128-byte rows
// with the 128-byte swizzle: 16-byte chunk c of row r lies at c ^ (r % 8).
__host__ __device__ __forceinline__ uint32_t swizzled(int r, int k) {
  return r * kRowBytes + ((((k >> 3) ^ (r & 7)) << 4) | ((k & 7) << 1));
}

// wgmma descriptor of a K-major bf16 tile with the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (the stride byte
// offset); the leading byte offset is unused by this layout.  A k16 step
// is 32 bytes into each row.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x N, fp32) = a (64 x 16 bf16, registers) * b (N x 16 bf16, a
// K-major tile in shared memory)^T + (acc ? d : 0), for the N classes
// 16, 32, 64 and 112.  The asm operands are d[0 .. N/2) (%0 ...), then a,
// b and acc; HEAD_DREGS_G and HEAD_DOPS_G list the first 8 G of d.
template <int N> struct Mma;

#define HEAD_DREGS_1 "%0, %1, %2, %3, %4, %5, %6, %7"
#define HEAD_DREGS_2 HEAD_DREGS_1 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define HEAD_DREGS_4                                                      \
  HEAD_DREGS_2 ", %16, %17, %18, %19, %20, %21, %22, %23"                 \
               ", %24, %25, %26, %27, %28, %29, %30, %31"
#define HEAD_DREGS_7                                                      \
  HEAD_DREGS_4 ", %32, %33, %34, %35, %36, %37, %38, %39"                 \
               ", %40, %41, %42, %43, %44, %45, %46, %47"                 \
               ", %48, %49, %50, %51, %52, %53, %54, %55"
#define HEAD_DOP8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HEAD_DOPS_1 HEAD_DOP8(0)
#define HEAD_DOPS_2 HEAD_DOPS_1, HEAD_DOP8(8)
#define HEAD_DOPS_4 HEAD_DOPS_2, HEAD_DOP8(16), HEAD_DOP8(24)
#define HEAD_DOPS_7 HEAD_DOPS_4, HEAD_DOP8(32), HEAD_DOP8(40), HEAD_DOP8(48)
// N, G = N / 16, and the operand numbers of a[0..3], b and acc
#define HEAD_MMA(N, G, A0, A1, A2, A3, B, P)                              \
  template <> struct Mma<N> {                                             \
    static __device__ __forceinline__ void run(float (&d)[N / 2],         \
                                               const uint32_t (&a)[4],    \
                                               uint64_t b, int acc) {     \
      asm volatile(                                                       \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"    \
          HEAD_DREGS_##G "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3        \
          "}, %" #B ", p, 1, 1, 0;\n}\n"                                  \
          : HEAD_DOPS_##G                                                 \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc)); \
    }                                                                     \
  };
HEAD_MMA(16, 1, 8, 9, 10, 11, 12, 13)
HEAD_MMA(32, 2, 16, 17, 18, 19, 20, 21)
HEAD_MMA(64, 4, 32, 33, 34, 35, 36, 37)
HEAD_MMA(112, 7, 56, 57, 58, 59, 60, 61)
#undef HEAD_MMA
#undef HEAD_DOPS_7
#undef HEAD_DOPS_4
#undef HEAD_DOPS_2
#undef HEAD_DOPS_1
#undef HEAD_DOP8
#undef HEAD_DREGS_7
#undef HEAD_DREGS_4
#undef HEAD_DREGS_2
#undef HEAD_DREGS_1

// four 8x8 bf16 matrices of shared memory into registers: lane t gives
// the address of row t % 8 of matrix t / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return reinterpret_cast<const uint32_t&>(x);
}

// hn of each row in fp32, split into hi, mid and lo bf16 terms and
// written in head_tc_kernel's stage layout: [N tile][K tile][term][N
// rows][64 values], each 128-byte row swizzled.  Rows past B and values
// past D are zeros.  One block of 128 threads per (padded) row.
template <int N>
__global__ void __launch_bounds__(128)
head_split_kernel(const bf16* __restrict__ h, const bf16* __restrict__ scale,
                  uint8_t* __restrict__ hs, int rows, int d, float eps) {
  __shared__ float red[4];
  // head_tc_kernel may launch now: it stages its first table tiles while
  // this grid runs, and waits for it before it loads any term
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int prow = blockIdx.x;
  const int tile = prow / N, r = prow % N;
  const bool valid = prow < rows;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const bf16* x = h + static_cast<int64_t>(prow) * d;
  float ss = 0.f;
  if (valid) {
    for (int k = threadIdx.x; k < d; k += 128) {
      const float f = __bfloat162float(x[k]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  const float rinv =
      valid ? rsqrtf((red[0] + red[1] + red[2] + red[3]) / d + eps) : 0.f;
  const int n_k = k_tiles(d);
  for (int u = threadIdx.x; u < n_k * 8; u += 128) {   // 8 values each
    uint32_t t[kTerms][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float y[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = u * 8 + 2 * e + j;
        y[j] = valid && k < d ? __bfloat162float(x[k]) * rinv *
                                    __bfloat162float(scale[k])
                              : 0.f;
      }
      const __nv_bfloat162 hi = __floats2bfloat162_rn(y[0], y[1]);
      const float r0 = y[0] - __low2float(hi), r1 = y[1] - __high2float(hi);
      const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          r0 - __low2float(mid), r1 - __high2float(mid));
      t[0][e] = bits(hi);
      t[1][e] = bits(mid);
      t[2][e] = bits(lo);
    }
    uint8_t* blk =
        hs + (static_cast<int64_t>(tile) * n_k + u / 8) * Cfg<N>::kHnBytes +
        swizzled(r, (u % 8) * 8);
#pragma unroll
    for (int term = 0; term < kTerms; ++term)
      *reinterpret_cast<uint4*>(blk + term * Cfg<N>::kTermBytes) =
          make_uint4(t[term][0], t[term][1], t[term][2], t[term][3]);
  }
}

// Partial (max, sum, first argmax) of N rows of hn over 256 vocabulary
// rows.  Block b takes N tile b % n_tiles and vocabulary tile
// b / n_tiles.  Warps 0-7 (two warpgroups) consume; the third warpgroup
// produces (one thread with TMA, all four warps for rows TMA cannot
// describe).
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
head_tc_kernel(const __grid_constant__ CUtensorMap map_table,
               const bf16* __restrict__ table, const uint8_t* __restrict__ hs,
               float* __restrict__ part_m, float* __restrict__ part_s,
               int* __restrict__ part_i, int rows, int d, int v, int n_tiles,
               int use_tma) {
  using C = Cfg<N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  // the ring: kStages x (table tile, hn terms), then the full and empty
  // barriers
  const uint32_t s_full = base + kStages * C::kStageBytes;
  const uint32_t s_empty = s_full + kStages * 8;

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_tile = blockIdx.x % n_tiles;
  const int v_tile = blockIdx.x / n_tiles;
  const int v0 = v_tile * kTV;
  const int n_k = k_tiles(d);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(s_full + 8 * s, 1);                    // the producer
      mbar_init(s_empty + 8 * s, kConsumerWarps);      // a lane per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer warpgroup: with TMA one thread keeps the ring full; rows
    // that TMA cannot describe take all 128 threads to stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (use_tma && warp > kConsumerWarps) return;
    const int ptid = threadIdx.x - kConsumerWarps * kWarp;
    const uint8_t* src = hs + static_cast<int64_t>(n_tile) * n_k * C::kHnBytes;
    // the table does not depend on head_split_kernel: the first stages'
    // tiles are in flight before the terms are ready
    const int pre = use_tma ? (n_k < kStages ? n_k : kStages) : 0;
    if (ptid == 0) {
      for (int t = 0; t < pre; ++t) {
        const uint32_t full = s_full + 8 * t;
        mbar_expect_tx(full, kTableBytes + C::kHnBytes);
        tma_load_2d(base + t * C::kStageBytes, &map_table, full, t * kK, v0);
      }
    }
    asm volatile("griddepcontrol.wait;" ::: "memory");
    if (ptid == 0) {
      for (int t = 0; t < pre; ++t)
        bulk_load(base + t * C::kStageBytes + kTableBytes,
                  src + t * C::kHnBytes, C::kHnBytes, s_full + 8 * t);
    }
    for (int t = pre; t < n_k; ++t) {
      const int s = t % kStages;
      if (t >= kStages) mbar_wait(s_empty + 8 * s, ((t / kStages) + 1) & 1);
      const uint32_t full = s_full + 8 * s;
      const uint32_t stage = base + s * C::kStageBytes;
      if (use_tma) {
        if (ptid == 0) {
          mbar_expect_tx(full, kTableBytes + C::kHnBytes);
          tma_load_2d(stage, &map_table, full, t * kK, v0);
          bulk_load(stage + kTableBytes, src + t * C::kHnBytes, C::kHnBytes,
                    full);
        }
      } else {
        // the table tile in the same swizzled layout, zero-padded past V
        // and D, by the warpgroup's generic stores
        uint8_t* tile = gbase + s * C::kStageBytes;
        const int k0 = t * kK;
        for (int e = ptid; e < kTV * kK; e += 4 * kWarp) {
          const int r = e / kK, k = e % kK;
          bf16 val = __ushort_as_bfloat16(0);
          if (v0 + r < v && k0 + k < d)
            val = table[static_cast<int64_t>(v0 + r) * d + k0 + k];
          *reinterpret_cast<bf16*>(tile + swizzled(r, k)) = val;
        }
        // make the stores visible to wgmma's async proxy, then arrive
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync 2, 128;" ::: "memory");
        if (ptid == 0) {
          mbar_expect_tx(full, C::kHnBytes);
          bulk_load(stage + kTableBytes, src + t * C::kHnBytes, C::kHnBytes,
                    full);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  // consumer warpgroup wg runs M tiles 2 wg and 2 wg + 1 (vocabulary
  // rows v0 + 128 wg ...); lane (g, q) = (lane / 4, lane % 4) of warp wl
  // of the group holds, for each M tile, the vocabulary rows
  // 16 wl + g and 16 wl + g + 8 and the hn rows 8 j + 2 q and 8 j + 2 q + 1
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane / 4, q = lane % 4;
  float acc[2][C::kAcc], part[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) acc[0][i] = acc[1][i] = part[i] = 0.f;

  for (int t = 0; t < n_k; ++t) {
    const int s = t % kStages;
    mbar_wait(s_full + 8 * s, (t / kStages) & 1);
    const uint32_t stage = base + s * C::kStageBytes;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      // the table fragments of this M tile, read once for the three terms:
      // lane t gives row 16 wl + t % 16, 16-byte chunk 2 kk + t / 16
      uint32_t af[kK / 16][4];
      const uint32_t a = stage + (2 * wg + mi) * 64 * kRowBytes;
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk)
        ldmatrix_x4(af[kk], a + swizzled(16 * wl + lane % 16,
                                         16 * kk + 8 * (lane / 16)));
      fence_acc(part);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      // a fresh sum per stage, smallest terms first
#pragma unroll
      for (int term = kTerms - 1; term >= 0; --term) {
        const uint32_t b = stage + kTableBytes + term * C::kTermBytes;
#pragma unroll
        for (int kk = 0; kk < kK / 16; ++kk)
          Mma<N>::run(part, af[kk], desc_sw128(b + kk * 32),
                      term != kTerms - 1 || kk > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(part);
#pragma unroll
      for (int i = 0; i < C::kAcc; ++i) acc[mi][i] += part[i];   // promote
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(s_empty + 8 * s);     // stage s is free
  }

  // epilogue.  Every consumer is past its last wgmma and the producer
  // issued no more loads, so stage 0 holds the reduction.  Per hn row:
  // the max over this thread's four vocabulary rows and the 8 lanes of
  // the warp that share the row, then the sum of exp(l - max) and the
  // lowest vocabulary row at the max the same way, then the 8 warps.
  asm volatile("bar.sync 1, 256;" ::: "memory");
  Stats* red = reinterpret_cast<Stats*>(gbase);        // [8 warps][N]
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = -INFINITY;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int vr = v0 + (2 * wg + mi) * 64 + 16 * wl + g + 8 * hh;
          if (vr < v) mx = fmaxf(mx, acc[mi][4 * j + 2 * hh + e]);
        }
      }
#pragma unroll
      for (int off = 4; off < kWarp; off *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
      int arg = INT32_MAX;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {         // rows increase
          const int vr = v0 + (2 * wg + mi) * 64 + 16 * wl + g + 8 * hh;
          const float x = acc[mi][4 * j + 2 * hh + e];
          if (vr < v) {
            sum += expf(x - mx);
            if (x == mx && arg == INT32_MAX) arg = vr;
          }
        }
      }
#pragma unroll
      for (int off = 4; off < kWarp; off *= 2) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
        arg = min(arg, __shfl_xor_sync(0xffffffffu, arg, off));
      }
      if (g == 0) red[warp * N + 8 * j + 2 * q + e] = Stats{mx, sum, arg};
    }
  }
  asm volatile("bar.sync 1, 256;" ::: "memory");
  const int n_slices = gridDim.x / n_tiles;
  for (int col = threadIdx.x; col < N; col += kConsumerWarps * kWarp) {
    Stats st = red[col];
    for (int w = 1; w < kConsumerWarps; ++w) st = merge(st, red[w * N + col]);
    const int row = n_tile * N + col;
    if (row < rows) {
      const int64_t o = static_cast<int64_t>(row) * n_slices + v_tile;
      part_m[o] = st.m;
      part_s[o] = st.s;
      part_i[o] = st.idx;
    }
  }
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// cuTensorMapEncodeTiled of the driver, found through the runtime, so
// the library needs no -lcuda
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// The table's map: tiles of 256 rows x 64 values, 128-byte swizzle,
// zeros past V and D.  Returns 0, a cudaError_t, or minus the CUresult
// of a refused encode.
int encode_table(CUtensorMap* map, const void* table, int d, int v) {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(v)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint32_t box[2] = {kK, kTV};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(table), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

// The table's map, kept per thread for the last few tables: a map holds
// only the address, D, V and the fixed tile, so one kept for the same
// (table, d, v) is the map that a new encode would give.
int table_map(CUtensorMap* map, const void* table, int d, int v) {
  struct Entry {
    CUtensorMap map;
    const void* table;
    int d, v;
  };
  constexpr int kEntries = 8;
  static thread_local Entry kept[kEntries] = {};
  static thread_local int next = 0;
  for (const Entry& e : kept) {
    if (e.table == table && e.d == d && e.v == v) {
      *map = e.map;
      return 0;
    }
  }
  const int err = encode_table(map, table, d, v);
  if (err) return err;
  kept[next] = Entry{*map, table, d, v};
  next = (next + 1) % kEntries;
  return 0;
}

template <int N>
int launch_n(const void* h, const void* scale, const void* table,
             void* split, float* pm, float* ps, int* pi, int rows, int d,
             int v, int tiles, float eps, cudaStream_t stream) {
  using C = Cfg<N>;
  // TMA needs 16-byte row strides and a 16-byte aligned base
  const int use_tma =
      d % 8 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0;
  CUtensorMap map{};
  if (use_tma) {
    const int err = table_map(&map, table, d, v);
    if (err) return err;
  }
  static const cudaError_t configured = cudaFuncSetAttribute(
      head_tc_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmemBytes));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  head_split_kernel<N><<<tiles * N, 128, 0, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(scale),
      static_cast<uint8_t*>(split), rows, d, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_dependent(head_tc_kernel<N>, tiles * vocab_tiles(v),
                          kThreads, C::kSmemBytes, stream, map,
                          static_cast<const bf16*>(table),
                          static_cast<const uint8_t*>(split), pm, ps, pi,
                          rows, d, v, tiles, use_tma);
}

int launch(const void* h, const void* scale, const void* table, void* split,
           float* pm, float* ps, int* pi, int rows, int d, int v, float eps,
           cudaStream_t stream) {
  const Rows r = rows_plan(rows);
  switch (r.n) {
#define HEAD_N(N)                                                           \
  case N:                                                                   \
    return launch_n<N>(h, scale, table, split, pm, ps, pi, rows, d, v,      \
                       r.tiles, eps, stream);
    HEAD_N(16) HEAD_N(32) HEAD_N(64) HEAD_N(112)
#undef HEAD_N
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Both designs: merge and launch
// ---------------------------------------------------------------------------

// One warp per row merges the row's partials, in slice order per lane
// and by (max, lowest index) across lanes.  A lane loads its next 8
// partials before it merges them, so their loads are in flight together.
__global__ void __launch_bounds__(kThreads)
head_merge_kernel(const float* __restrict__ part_m,
                  const float* __restrict__ part_s,
                  const int* __restrict__ part_i,
                  const float* __restrict__ thresholds,
                  float* __restrict__ conf, int32_t* __restrict__ pred,
                  int32_t* __restrict__ fire, int rows, int n_slices) {
  constexpr int kBatch = 8;
  // launched while the partial kernel ends (programmatic dependent
  // launch): its partials are complete and visible past this wait
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp;
  if (row >= rows) return;                          // whole warp leaves
  const int64_t base = static_cast<int64_t>(row) * n_slices;
  Stats st{-INFINITY, 0.f, INT32_MAX};
  for (int j0 = lane; j0 < n_slices; j0 += kBatch * kWarp) {
    Stats batch[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * kWarp;
      batch[u] = j < n_slices ? Stats{part_m[base + j], part_s[base + j],
                                      part_i[base + j]}
                              : Stats{-INFINITY, 0.f, INT32_MAX};
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) st = merge(st, batch[u]);
  }
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

int simt_slices(int rows, int v) {
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
  static const cudaError_t configured = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (configured != cudaSuccess) return static_cast<int>(configured);
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
int launch_simt(const void* h, const void* scale, const void* table,
                float* pm, float* ps, int* pi, int rows, int d, int v,
                float eps, cudaStream_t stream) {
  // 16-byte vectors need 16-byte rows and 16-byte aligned bases
  const bool vec =
      (d * sizeof(T)) % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(scale) |
       reinterpret_cast<uintptr_t>(table)) % 16 == 0;
  return vec ? launch_partial_rows<T, true>(h, scale, table, pm, ps, pi, rows,
                                            d, v, eps, stream)
             : launch_partial_rows<T, false>(h, scale, table, pm, ps, pi,
                                             rows, d, v, eps, stream);
}

constexpr int kBf16 = 2;

int slices(int rows, int v, int dtype) {
  return dtype == kBf16 ? tc::vocab_tiles(v) : simt_slices(rows, v);
}

}  // namespace

// The workspace a launch over `rows` rows needs: plan[0] = vocabulary
// slices (the caller allocates part_f as (2, rows, slices) float32 and
// part_i as (rows, slices) int32), plan[1] = bytes of the split hn terms
// (0 for the SIMT design).  dtype as for exit_head_launch.
extern "C" int exit_head_plan(int rows, int d, int v, int dtype,
                              int64_t* plan) {
  if (rows < 1 || d < 1 || v < 1 || dtype < 0 || dtype > kBf16)
    return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = slices(rows, v, dtype);
  plan[1] = dtype == kBf16 ? static_cast<int64_t>(tc::split_bytes(rows, d))
                           : 0;
  return 0;
}

// dtype: 0 = float32, 1 = float16 (SIMT design), 2 = bfloat16 (tensor
// cores), shared by h (rows, d), scale (d,) and table (v, d), all
// contiguous; thresholds (rows,) float32; conf float32, pred and fire
// int32, each (rows,); part_f, part_i and split (16-byte aligned) as
// exit_head_plan sizes them.  Returns 0 on success, the cudaError_t of a
// refused launch, or minus the CUresult of a refused tensor-map encode.
extern "C" int exit_head_launch(const void* h, const void* scale,
                                const void* table, const void* thresholds,
                                void* conf, void* pred, void* fire,
                                void* part_f, void* part_i, void* split,
                                int rows, int d, int v, int dtype, float eps,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || d < 1 || v < 1 || dtype < 0 || dtype > kBf16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = slices(rows, v, dtype);
  float* pm = static_cast<float*>(part_f);
  float* ps = pm + static_cast<int64_t>(rows) * n;
  int* pi = static_cast<int*>(part_i);
  int err = 0;
  switch (dtype) {
    case 0:
      err = launch_simt<float>(h, scale, table, pm, ps, pi, rows, d, v, eps,
                               s);
      break;
    case 1:
      err = launch_simt<__half>(h, scale, table, pm, ps, pi, rows, d, v, eps,
                                s);
      break;
    default:
      err = tc::launch(h, scale, table, split, pm, ps, pi, rows, d, v, eps,
                       s);
  }
  if (err) return err;
  const int per_block = kThreads / kWarp;
  return launch_dependent(
      head_merge_kernel, (rows + per_block - 1) / per_block, kThreads, 0, s,
      static_cast<const float*>(pm), static_cast<const float*>(ps),
      static_cast<const int*>(pi), static_cast<const float*>(thresholds),
      static_cast<float*>(conf), static_cast<int32_t*>(pred),
      static_cast<int32_t*>(fire), rows, n);
}
