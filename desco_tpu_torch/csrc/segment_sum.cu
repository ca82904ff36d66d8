// Sorted segment-sum kernels for Hopper (sm_90a), plain C interface.
//
// K1 desco_sorted_segment_sum replaces desco_tpu's Pallas
//    pallas_sorted_segment_sum (desco_tpu/ops/pallas_segment.py:310).
//
// A sorted segment stream is CSR: the wrapper (ops/cuda_segment.py) hands
// in the row offsets, and optionally the row index of every edge, so one
// kernel computes out[r] = sum of x[rows[e]] over the edges of segment r:
// the gather is folded into the sum and the [E, K] messages never exist
// (desco_tpu's typed_edge_aggregate is "one fused gather + segment-sum").
// The same kernel is the backward of the gather-fused sum, run over the
// batch's source-sorted stream. Wide rows (more than 16 elements): one
// warp owns one segment and one chunk of 32 x (2- to 16-byte lane loads)
// columns, so wide rows are split over warps, and each element is the
// edge-order f32 sum of one lane. Narrow rows (at most 16 elements, the
// direction degrees, GAT's softmax denominator): a group of 1-16 lanes
// owns one segment, so a warp sums up to 32 consecutive segments, and a
// segment of more than 32 / (the group's lanes) edges is summed by its
// whole warp; the sum keeps a fixed order, lane groups over strided edges
// folded as a tree (segsum_narrow). Sums stay in f32 registers and are
// written once: no atomics, no spill row, and the result does not depend
// on the layout, the grid or the launch (deterministic). Edges past the
// last offset (the padding keys) are never visited. What bounds it: the
// bytes of the x rows (re-read from L2 once per edge when gathered), the
// index stream and the f32 output; a quarter of an f32 operation per
// byte. On one-column rows those bytes take under a microsecond, so the
// launch and the offsets' latency set the time, and the narrow layout
// needs a 32nd of the warps that a warp per segment would.
// desco_sorted_segment_sum_pair also sums a second, one-column operand
// over the same offsets in the same launch (GAT's softmax denominator
// beside its numerator).
//
// K4 desco_segment_sum_vjp_gather is the backward of K1, desco_tpu's
//    _ssum_ad_bwd (desco_tpu/ops/pallas_segment.py:464): d[e, :] =
//    g[seg[e], :] where 0 <= seg[e] < n_segments, else 0, in the dtype of
//    K1's messages. One thread copies one piece (at most 16 bytes of
//    output) of one row; bound by the [E, K] write. Its pair form writes
//    the second operand's cotangent from the same read of seg[e].
//
// The typed transform-aggregate (K2, K3) has kernels of its own, in
// typed_aggregate.cu.
//
// Row types: K1's messages are float32 or bfloat16 (dtype code 0 or 1),
// as the TPU kernels reduce bf16 rows; every sum is accumulated and
// written in float32. K4 reads a float32 cotangent and writes float32 or
// bfloat16 (round to nearest even). A lane's load is the widest of 16,
// 8, 4 (and for bf16 2) bytes that the row width and the pointers allow
// (pick_vec), so a 64-wide bf16 row is one 4-byte load per lane.
//
// Every function launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kUnroll = 8;  // rows one lane has in flight in K1's kernel

constexpr int kF32 = 0;   // dtype codes of the C interface
constexpr int kBf16 = 1;

// What K1's kernel does with a segment. kModeFull is the shipped kernel;
// the other two exist for the probe library (segment_sum_probe.cu), which
// strips the kernel in steps to see which part of it costs.
constexpr int kModeFull = 0;    // offsets read, rows converted and summed
constexpr int kModeNoOffs = 1;  // fixed run of rows per warp, no offsets
constexpr int kModeNoAcc = 2;   // kModeNoOffs, rows OR-folded, no convert

// The raw 32-bit words one lane loads from one row: VEC elements of T,
// 2 to 16 bytes (a 2-byte load is widened into one word).
template <typename T, int VEC>
struct Lane {
  static constexpr int kBytes = VEC * static_cast<int>(sizeof(T));
  static constexpr int kWords = kBytes >= 4 ? kBytes / 4 : 1;
  static_assert(kBytes == 2 || kBytes == 4 || kBytes == 8 || kBytes == 16,
                "a lane loads 2, 4, 8 or 16 bytes");
};

template <int WORDS>
struct Raw {
  unsigned w[WORDS];
};

template <typename T, int VEC>
__device__ __forceinline__ Raw<Lane<T, VEC>::kWords> load_raw(
    const T* __restrict__ p) {
  constexpr int kBytes = Lane<T, VEC>::kBytes;
  Raw<Lane<T, VEC>::kWords> r;
  if constexpr (kBytes == 2) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else if constexpr (kBytes == 4) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else if constexpr (kBytes == 8) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = t.x;
    r.w[1] = t.y;
  } else {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = t.x;
    r.w[1] = t.y;
    r.w[2] = t.z;
    r.w[3] = t.w;
  }
  return r;
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned bits) {
  return __bfloat162float(
      __ushort_as_bfloat16(static_cast<unsigned short>(bits & 0xffffu)));
}

__device__ __forceinline__ unsigned float_to_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));  // round to nearest even
}

// One element of T as a raw word, loaded where the code stands: the asm
// is volatile, so the compiler cannot sink the load to its first use
// after a loop of row loads, and its latency hides behind theirs.
template <typename T>
__device__ __forceinline__ unsigned load_early(const T* p) {
  if constexpr (sizeof(T) == 4) {
    unsigned v;
    asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
  } else {
    unsigned short h;
    asm volatile("ld.global.nc.u16 %0, [%1];" : "=h"(h) : "l"(p));
    return h;
  }
}

// acc += the VEC elements of one raw row piece, converted to f32.
template <typename T, int VEC>
__device__ __forceinline__ void add_raw(
    float (&acc)[VEC], const Raw<Lane<T, VEC>::kWords>& r) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += __uint_as_float(r.w[i]);
  } else if constexpr (VEC == 1) {
    acc[0] += bf16_bits_to_float(r.w[0]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      acc[2 * i] += bf16_bits_to_float(r.w[i]);         // low half first
      acc[2 * i + 1] += bf16_bits_to_float(r.w[i] >> 16);
    }
  }
}

// One raw row piece folded into the running state of K1's kernel: added
// to ``acc`` after conversion, or (kModeNoAcc) OR-ed into ``bits``.
template <typename T, int VEC, int MODE>
__device__ __forceinline__ void fold_raw(
    float (&acc)[VEC], unsigned (&bits)[Lane<T, VEC>::kWords],
    const Raw<Lane<T, VEC>::kWords>& r) {
  if constexpr (MODE == kModeNoAcc) {
#pragma unroll
    for (int i = 0; i < Lane<T, VEC>::kWords; ++i) bits[i] |= r.w[i];
  } else {
    add_raw<T, VEC>(acc, r);
  }
}

// One row piece of f32 results: 16-byte stores where VEC allows (the
// dispatch checks the output's alignment), else 8- or 4-byte ones.
template <int VEC>
__device__ __forceinline__ void store_row(float* __restrict__ p,
                                          const float (&acc)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(acc[0], acc[1]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = acc[i];
  }
}

// The f32 results of K1's kernel for one row piece: the sums, or
// (kModeNoAcc) the OR-ed bit pattern of each element as a number.
template <typename T, int VEC, int MODE>
__device__ __forceinline__ void finish(
    float (&acc)[VEC], const unsigned (&bits)[Lane<T, VEC>::kWords]) {
  if constexpr (MODE == kModeNoAcc) {
    if constexpr (sizeof(T) == 4 || VEC == 1) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = (float)bits[i];
    } else {
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) {
        acc[2 * i] = (float)(bits[i] & 0xffffu);
        acc[2 * i + 1] = (float)(bits[i] >> 16);
      }
    }
  }
}

constexpr int kLongUnroll = 8;  // rounds of a warp-wide segment in flight

// K1's narrow layout: rows of at most 16 elements, one element per lane
// (VEC == 1). A group of LANES lanes (a power of two >= K) owns one
// segment, lane c of the group its column c, so a warp sums 32 / LANES
// consecutive segments; the warp reads their offsets with one coalesced
// load and writes their results side by side.
//
// The order of the sum is fixed by the segment alone: the warp's G = 32 /
// LANES lane groups take edges g, g + G, g + 2G, ... of the segment, each
// adds its edges in order from 0, and the G partial sums are folded by
// lane l adding lane l ^ off for off = 16, 8, ... down to LANES: a tree
// over the groups, where one lane walking a hub segment in edge order
// would take n rounding steps, not log n, which GAT's softmax gradients
// amplify (on an H100 the sharded and the packed GAT tower then parted by
// 6.5e-4 of a gradient's scale on a 20,000-node graph, 2.5e-6 with the
// tree).
// A segment of at most G edges has at most one edge per group, so its owning lane computes that fold
// alone, its rows the groups' partials (empty groups add +0, which
// changes nothing). A longer segment is summed by its whole warp: the
// same fold, whichever computes it. After the short ones, each group
// loads its edges of a round (the warp's loads coalesced, the next round
// in flight), then the warp folds and the owning group keeps the result.
// ``block`` is the block's index in this layout.
template <typename T, int MODE, bool GATHER, int LANES>
__device__ __forceinline__ void segsum_narrow(
    const T* __restrict__ x, const int* __restrict__ rows,
    const int* __restrict__ offs, int n_segments, int k, int run,
    int n_rows, float* __restrict__ out, int block) {
  constexpr int kGroups = kWarp / LANES;
  constexpr int kWords = Lane<T, 1>::kWords;
  const int lane = threadIdx.x % kWarp;
  const long long first =
      ((long long)block * kWarpsPerBlock + threadIdx.x / kWarp) * kGroups;
  if (first >= n_segments) return;  // the whole warp
  const int seg0 = (int)first;
  const int g = lane / LANES;
  const int c = lane % LANES;
  const int n_live = min(kGroups, n_segments - seg0);  // warp-uniform
  const bool live = g < n_live;
  const bool col = live && c < k;
  int lo = 0, hi = 0;
  if constexpr (MODE == kModeFull) {
    // offsets seg0 .. seg0 + n_live: lanes 0 .. n_live, and a 33rd
    // for the last of 32 one-lane segments
    const int o = lane <= n_live ? __ldg(offs + seg0 + lane) : 0;
    lo = __shfl_sync(kFullMask, o, g);
    hi = __shfl_sync(kFullMask, o, (g + 1) % kWarp);
    if (kGroups == kWarp && g == kWarp - 1)
      hi = n_live == kWarp ? __ldg(offs + seg0 + kWarp) : 0;
  } else {
    const long long b = (long long)(seg0 + g) * run;
    lo = (int)min(b, (long long)n_rows);
    hi = (int)min(b + run, (long long)n_rows);
  }
  if (!live) lo = hi = 0;
  const int n = hi - lo;
  const bool is_long = n > kGroups;
  float acc[1] = {0.f};
  unsigned bits[kWords] = {0u};
  if (col && !is_long) {
    // at most one edge a group: group i's partial is 0 + edge i, or 0.
    // Slots 8-15 and 16-31 only where a segment of the warp reaches them
    Raw<kWords> r[kGroups];
    auto load_slot = [&](int i) {
      if (i < n) {
        int src = lo + i;
        if constexpr (GATHER) src = __ldg(rows + lo + i);
        r[i] = load_raw<T, 1>(x + (int64_t)src * k + c);
      }
    };
    constexpr int kFirst = kGroups < 8 ? kGroups : 8;
    constexpr int kSecond = kGroups < 16 ? kGroups : 16;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) r[i].w[0] = 0u;
#pragma unroll
    for (int i = 0; i < kFirst; ++i) load_slot(i);
    if (kGroups > 8 && n > 8) {
#pragma unroll
      for (int i = kFirst; i < kSecond; ++i) load_slot(i);
    }
    if (kGroups > 16 && n > 16) {
#pragma unroll
      for (int i = kSecond; i < kGroups; ++i) load_slot(i);
    }
    float v[kGroups];
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      float a[1] = {0.f};
      if (i < n) fold_raw<T, 1, MODE>(a, bits, r[i]);
      v[i] = a[0];
    }
    // group 0's side of the fold: v[i] += v[i + s] for s = G / 2 .. 1,
    // written out so that every index is a constant
    if constexpr (kGroups >= 32) {
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = v[i] + v[i + 16];
    }
    if constexpr (kGroups >= 16) {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = v[i] + v[i + 8];
    }
    if constexpr (kGroups >= 8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = v[i] + v[i + 4];
    }
    if constexpr (kGroups >= 4) {
      v[0] = v[0] + v[2];
      v[1] = v[1] + v[3];
    }
    acc[0] = v[0] + v[1];
  }
  // the long segments, one at a time, each by the whole warp
  unsigned todo = __ballot_sync(kFullMask, live && c == 0 && is_long);
  while (todo != 0u) {
    const int owner = __ffs(todo) - 1;
    todo &= todo - 1u;
    const int llo = __shfl_sync(kFullMask, lo, owner);
    const int lhi = __shfl_sync(kFullMask, hi, owner);
    // round b's loads: group g loads edge b + u * G + g, column c
    auto load_round = [&](int b, Raw<kWords>(&r)[kLongUnroll]) {
#pragma unroll
      for (int u = 0; u < kLongUnroll; ++u) {
        const int e = b + u * kGroups + g;
        r[u].w[0] = 0u;
        if (e < lhi && c < k) {
          int src = e;
          if constexpr (GATHER) src = __ldg(rows + e);
          r[u] = load_raw<T, 1>(x + (int64_t)src * k + c);
        }
      }
    };
    float lacc[1] = {0.f};
    unsigned lbits[kWords] = {0u};
    Raw<kWords> r[kLongUnroll];
    load_round(llo, r);
    for (int b = llo; b < lhi; b += kGroups * kLongUnroll) {
      Raw<kWords> next[kLongUnroll];  // in flight while this one is added
      load_round(b + kGroups * kLongUnroll, next);
#pragma unroll
      for (int u = 0; u < kLongUnroll; ++u)
        if (c < k && b + u * kGroups + g < lhi)
          fold_raw<T, 1, MODE>(lacc, lbits, r[u]);
#pragma unroll
      for (int u = 0; u < kLongUnroll; ++u) r[u] = next[u];
    }
    for (int off = kWarp / 2; off >= LANES; off >>= 1) {
      if constexpr (MODE == kModeNoAcc) {
        lbits[0] |= __shfl_xor_sync(kFullMask, lbits[0], off);
      } else {
        lacc[0] += __shfl_xor_sync(kFullMask, lacc[0], off);
      }
    }
    if (g == owner / LANES) {
      acc[0] = lacc[0];
      bits[0] = lbits[0];
    }
  }
  if (!col) return;
  finish<T, 1, MODE>(acc, bits);
  out[(int64_t)(seg0 + g) * k + c] = acc[0];
}

// K1's wide layout (rows of more than 16 elements): block * 8 + warp is
// the segment r, blockIdx.y the column chunk of 32 * VEC columns, so a
// wide row is split over several warps (512 pooling segments of 576
// columns are 512 x 9 warps, not 512 warps walking the columns in turn);
// lane l owns columns chunk + l*VEC .. +VEC and adds every edge of the
// segment in order. Gather: per 32 edges the warp reads the 32 row
// indices in one load and broadcasts them with __shfl_sync; x rows are
// then read with 2- to 16-byte lane loads, kUnroll rows in flight before
// the first add. AUX (identity rows): the one-column ``aux`` [E] over the
// same edges is summed into aux_out in the narrow layout's order at one
// column, lane l adding edges l, l + 32, ... (one coalesced load a
// chunk, issued with the rows'), the lanes folded as a tree at the end
// into lane 0: bit-equal to K1 on aux alone.
template <typename T, int VEC, int MODE, bool GATHER, bool AUX = false>
__device__ __forceinline__ void segsum_wide(
    const T* __restrict__ x, const int* __restrict__ rows,
    const int* __restrict__ offs, int n_segments, int k, int run,
    int n_rows, float* __restrict__ out, int block,
    const T* __restrict__ aux = nullptr, float* __restrict__ aux_out =
    nullptr) {
  constexpr int kWords = Lane<T, VEC>::kWords;
  const int seg = block * kWarpsPerBlock + (threadIdx.x / kWarp);
  const int lane = threadIdx.x % kWarp;
  if (seg >= n_segments) return;  // the whole warp: seg is warp-uniform
  int lo, hi;
  if constexpr (MODE == kModeFull) {
    lo = offs[seg];
    hi = offs[seg + 1];
  } else {
    const long long b = (long long)seg * run;
    lo = (int)min(b, (long long)n_rows);
    hi = (int)min(b + run, (long long)n_rows);
  }
  const int c = (int)blockIdx.y * kWarp * VEC + lane * VEC;
  const bool active = c < k;  // idle lanes still take part in shuffles
  const bool aux_warp = AUX && blockIdx.y == 0;  // warp-uniform
  const T* __restrict__ col = x + c;
  float acc[VEC];
  float acc_aux[1] = {0.f};  // lane l: edges l, l + 32, ... of aux
  unsigned bits[kWords];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kWords; ++i) bits[i] = 0u;
  for (int e0 = lo; e0 < hi; e0 += kWarp) {
    const int n = min(kWarp, hi - e0);  // warp-uniform
    int idx = 0;
    if constexpr (GATHER) {
      if (lane < n) idx = __ldg(rows + e0 + lane);
    }
    Raw<Lane<T, 1>::kWords> ra;
    ra.w[0] = 0u;
    if constexpr (AUX) {
      if (aux_warp && lane < n) ra.w[0] = load_early(aux + e0 + lane);
    }
    for (int j = 0; j < n; j += kUnroll) {
      Raw<kWords> r[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const int t = j + i;  // edge e0 + t of the segment
        int src;
        if constexpr (GATHER) {
          src = __shfl_sync(kFullMask, idx, t & (kWarp - 1));
        } else {
          src = e0 + t;
        }
        if (active && t < n) {
          r[i] = load_raw<T, VEC>(col + (int64_t)src * k);
        } else {
#pragma unroll
          for (int w = 0; w < kWords; ++w) r[i].w[w] = 0u;
        }
      }
#pragma unroll
      for (int i = 0; i < kUnroll; ++i)
        if (active && j + i < n) fold_raw<T, VEC, MODE>(acc, bits, r[i]);
    }
    if constexpr (AUX) {
      if (aux_warp && lane < n) add_raw<T, 1>(acc_aux, ra);
    }
  }
  if constexpr (AUX) {
    if (aux_warp) {
      for (int off = kWarp / 2; off >= 1; off >>= 1)
        acc_aux[0] += __shfl_xor_sync(kFullMask, acc_aux[0], off);
      if (lane == 0) aux_out[seg] = acc_aux[0];
    }
  }
  if (!active) return;
  finish<T, VEC, MODE>(acc, bits);
  store_row(out + (int64_t)seg * k + c, acc);
}

// K1: out[r, c] = sum of x[rows[e], c] for e in [offs[r], offs[r+1])
// (GATHER = false: rows is the identity, x[e, c]), in the wide layout
// (LANES == 32, edge order) or the narrow one (LANES < 32, the fold
// order). The order is a function of the segment and the row width
// alone, so the result does not depend on the grid, the launch or the
// path a segment takes. No [E, K] message
// tensor exists. MODE strips the kernel for the probe: kModeNoOffs gives
// segment r the fixed rows [r*run, min((r+1)*run, n_rows)) and reads no
// offsets; kModeNoAcc also replaces convert-and-add by an OR of the raw
// words and writes each OR-ed element's bit pattern as a number.
template <typename T, int VEC, int MODE, bool GATHER, int LANES>
__global__ void __launch_bounds__(kThreads)
segsum_rows_kernel(const T* __restrict__ x, const int* __restrict__ rows,
                   const int* __restrict__ offs, int n_segments, int k,
                   int run, int n_rows, float* __restrict__ out) {
  if constexpr (LANES < kWarp) {
    static_assert(VEC == 1, "narrow rows load one element per lane");
    segsum_narrow<T, MODE, GATHER, LANES>(x, rows, offs, n_segments, k, run,
                                          n_rows, out, blockIdx.x);
  } else {
    segsum_wide<T, VEC, MODE, GATHER>(x, rows, offs, n_segments, k, run,
                                      n_rows, out, blockIdx.x);
  }
}

// K1 on an operand pair over one sorted stream, in one launch: the wide
// rows x [E, k] (k > 16; GAT's numerator) and the one-column ``aux`` [E]
// (its denominator), which segsum_wide's AUX sums on the rows' own warps
// in the narrow layout's order at one column, bit-equal to two launches.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
segsum_pair_kernel(const T* __restrict__ x, const T* __restrict__ aux,
                   const int* __restrict__ offs, int n_segments, int k,
                   float* __restrict__ out, float* __restrict__ aux_out) {
  segsum_wide<T, VEC, kModeFull, false, true>(
      x, nullptr, offs, n_segments, k, 0, 0, out, blockIdx.x, aux, aux_out);
}

// VEC f32 values as one aligned store of VEC elements of T (at most 16
// bytes), bf16 rounded to nearest even.
template <typename T, int VEC>
__device__ __forceinline__ void store_piece(T* __restrict__ p,
                                            const float (&a)[VEC]) {
  if constexpr (sizeof(T) == 4) {
    store_row(reinterpret_cast<float*>(p), a);
  } else if constexpr (VEC == 1) {
    *reinterpret_cast<unsigned short*>(p) =
        static_cast<unsigned short>(float_to_bf16_bits(a[0]));
  } else {
    unsigned w[VEC / 2];
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i)
      w[i] = float_to_bf16_bits(a[2 * i]) |
             (float_to_bf16_bits(a[2 * i + 1]) << 16);
    if constexpr (VEC == 2) {
      *reinterpret_cast<unsigned*>(p) = w[0];
    } else if constexpr (VEC == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      static_assert(VEC == 8, "a bf16 piece has 1, 2, 4 or 8 elements");
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// VEC consecutive f32 values: 16-byte loads where VEC allows.
template <int VEC>
__device__ __forceinline__ void load_f32(float (&a)[VEC],
                                         const float* __restrict__ p) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
      a[i] = t.x;
      a[i + 1] = t.y;
      a[i + 2] = t.z;
      a[i + 3] = t.w;
    }
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    a[0] = t.x;
    a[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) a[i] = __ldg(p + i);
  }
}

// K4: out[e, c..c+VEC) = live(e) ? g[seg[e], c..c+VEC) : 0 with
// live(e) = 0 <= seg[e] < n_segments; g is f32, out is T. Thread i owns
// piece i of the [E, K / VEC] grid of row pieces, so a warp writes
// consecutive bytes. AUX: the thread of a row's first piece also writes
// aux_out[e] = live(e) ? g_aux[seg[e]] : 0, the cotangent of a second,
// one-column operand of K1 over the same keys, from the same read of
// seg[e] (GAT's two cotangents in one launch).
template <typename T, int VEC, bool AUX>
__global__ void __launch_bounds__(kThreads)
segsum_vjp_gather_kernel(T* __restrict__ out, const float* __restrict__ g,
                         const int* __restrict__ seg, long long n_pieces,
                         int pieces_per_row, int n_segments, int k,
                         T* __restrict__ aux_out,
                         const float* __restrict__ g_aux) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_pieces) return;
  const long long e = i / pieces_per_row;
  const int c = (int)(i - e * pieces_per_row) * VEC;
  const int s = seg[e];
  const bool live = s >= 0 && s < n_segments;
  float acc[VEC];
  float a[1] = {0.f};
  if (live) {
    load_f32(acc, g + (int64_t)s * k + c);
    if (AUX && c == 0) a[0] = __ldg(g_aux + s);  // beside the row's load
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  }
  store_piece<T, VEC>(out + e * k + c, acc);
  if constexpr (AUX) {
    if (c == 0) store_piece<T, 1>(aux_out + e, a);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// Elements per lane for rows of K elements of ``elem_bytes`` bytes read
// from ``in`` and summed into the f32 rows of ``out``: the widest load
// (16 bytes down to one element) whose warp of 32 lanes tiles K; else the
// widest that divides K and leaves at most half the lanes idle; else one
// element. Rows start every K elements, so a load of v elements is
// aligned when K % v == 0 and the base pointer is.
int pick_vec(int k, int elem_bytes, const void* in, const void* out) {
  const int vmax = 16 / elem_bytes;
  auto fits = [&](int v) {
    return k % v == 0 && aligned(in, (uintptr_t)v * elem_bytes) &&
           aligned(out, v >= 4 ? 16 : v * 4);
  };
  for (int v = vmax; v > 1; v >>= 1)
    if (k % (kWarp * v) == 0 && fits(v)) return v;
  for (int v = vmax; v > 1; v >>= 1)
    if (k > 16 * v && fits(v)) return v;
  return 1;
}

// Elements per piece for K4: the widest piece of at most 16 output bytes
// that divides K and that both pointers are aligned to.
int pick_piece(int k, int out_elem_bytes, const void* g, const void* out) {
  for (int v = 16 / out_elem_bytes; v > 1; v >>= 1)
    if (k % v == 0 && aligned(g, v >= 4 ? 16 : v * 4) &&
        aligned(out, (uintptr_t)v * out_elem_bytes))
      return v;
  return 1;
}

// Launch ``Launcher::run<T, VEC>`` for a dtype code and an element count
// per lane; ``ptr`` is the typed pointer, the kernel's first argument.
template <typename Launcher, typename... Args>
void dispatch(int dtype, int vec, dim3 grid, cudaStream_t s, void* ptr,
              Args... args) {
  if (dtype == kBf16) {
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(ptr);
    switch (vec) {
      case 8:
        Launcher::template run<__nv_bfloat16, 8>(grid, s, p, args...);
        break;
      case 4:
        Launcher::template run<__nv_bfloat16, 4>(grid, s, p, args...);
        break;
      case 2:
        Launcher::template run<__nv_bfloat16, 2>(grid, s, p, args...);
        break;
      default:
        Launcher::template run<__nv_bfloat16, 1>(grid, s, p, args...);
    }
  } else {
    float* p = static_cast<float*>(ptr);
    switch (vec) {
      case 4:
        Launcher::template run<float, 4>(grid, s, p, args...);
        break;
      case 2:
        Launcher::template run<float, 2>(grid, s, p, args...);
        break;
      default:
        Launcher::template run<float, 1>(grid, s, p, args...);
    }
  }
}

// K1's kernel for one mode and gather flag; the layout (wide, or narrow
// at the ``lanes`` of lanes_per_row) is picked at run time. Only
// one-element lanes can be narrow (pick_vec gives v > 1 only where
// K / v > 16).
template <int MODE, bool GATHER>
struct LaunchSegsumRows {
  template <typename T, int VEC, int LANES>
  static void launch(dim3 grid, cudaStream_t s, const T* x, const int* rows,
                     const int* offs, int n_segments, int k, int run_rows,
                     int n_rows, float* out) {
    segsum_rows_kernel<T, VEC, MODE, GATHER, LANES><<<grid, kThreads, 0, s>>>(
        x, rows, offs, n_segments, k, run_rows, n_rows, out);
  }

  template <typename T, int VEC>
  static void run(dim3 grid, cudaStream_t s, T* x, const int* rows,
                  const int* offs, int n_segments, int k, int lanes,
                  int run_rows, int n_rows, float* out) {
    if constexpr (VEC == 1) {
      switch (lanes) {
        case 1:
          launch<T, 1, 1>(grid, s, x, rows, offs, n_segments, k, run_rows,
                          n_rows, out);
          return;
        case 2:
          launch<T, 1, 2>(grid, s, x, rows, offs, n_segments, k, run_rows,
                          n_rows, out);
          return;
        case 4:
          launch<T, 1, 4>(grid, s, x, rows, offs, n_segments, k, run_rows,
                          n_rows, out);
          return;
        case 8:
          launch<T, 1, 8>(grid, s, x, rows, offs, n_segments, k, run_rows,
                          n_rows, out);
          return;
        case 16:
          launch<T, 1, 16>(grid, s, x, rows, offs, n_segments, k, run_rows,
                           n_rows, out);
          return;
        default:
          break;
      }
    }
    launch<T, VEC, kWarp>(grid, s, x, rows, offs, n_segments, k, run_rows,
                          n_rows, out);
  }
};

struct LaunchSegsumPair {
  template <typename T, int VEC>
  static void run(dim3 grid, cudaStream_t s, T* x, const void* aux,
                  const int* offs, int n_segments, int k, float* out,
                  float* aux_out) {
    segsum_pair_kernel<T, VEC><<<grid, kThreads, 0, s>>>(
        x, static_cast<const T*>(aux), offs, n_segments, k, out, aux_out);
  }
};

// Lanes that one row of K elements takes at VEC elements per lane: the
// power of two >= ceil(K / VEC), at most a warp (32: the wide layout).
int lanes_per_row(int k, int vec) {
  const int need = (k + vec - 1) / vec;
  int lanes = 1;
  while (lanes < need && lanes < kWarp) lanes <<= 1;
  return lanes;
}

// K1's grid: wide rows 8 segments per block in x and the column chunks
// of 32 * VEC in y; narrow rows 8 x 32 / lanes segments per block, one
// chunk. (0, 0, 0) if it does not fit.
dim3 segsum_grid(int n_segments, int k, int vec) {
  const int lanes = lanes_per_row(k, vec);
  const long long per_block = (long long)kWarpsPerBlock * (kWarp / lanes);
  const long long chunks =
      lanes < kWarp ? 1 : ((long long)k + kWarp * vec - 1) / (kWarp * vec);
  const long long blocks = ((long long)n_segments + per_block - 1) / per_block;
  if (chunks > 65535 || blocks > 2147483647LL) return dim3(0, 0, 0);
  return dim3((unsigned)blocks, (unsigned)chunks);
}

template <bool AUX>
struct LaunchVjpGather {
  template <typename T, int VEC>
  static void run(dim3 grid, cudaStream_t s, T* out, const float* g,
                  const int* seg, long long n_pieces, int pieces_per_row,
                  int n_segments, int k, void* aux_out, const float* g_aux) {
    segsum_vjp_gather_kernel<T, VEC, AUX><<<grid, kThreads, 0, s>>>(
        out, g, seg, n_pieces, pieces_per_row, n_segments, k,
        static_cast<T*>(aux_out), g_aux);
  }
};

bool known_dtype(int dtype) { return dtype == kF32 || dtype == kBf16; }

}  // namespace

extern "C" {

int desco_segment_sum_abi_version() { return 6; }

const char* desco_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out [n_segments, k] f32: out[r] = sum of x[rows[e]] over e in
// [offs[r], offs[r+1]); x [*, k] of ``dtype``; rows int32 (nullptr: the
// identity, x[e]); offs int32 [n_segments + 1].
int desco_sorted_segment_sum(void* x, int dtype, const int* rows,
                             const int* offs, int n_segments, int k,
                             float* out, void* stream) {
  if (n_segments <= 0 || k <= 0) return 0;
  if (!known_dtype(dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = pick_vec(k, dtype == kBf16 ? 2 : 4, x, out);
  const dim3 grid = segsum_grid(n_segments, k, vec);
  if (grid.x == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = lanes_per_row(k, vec);
  if (rows != nullptr) {
    dispatch<LaunchSegsumRows<kModeFull, true>>(
        dtype, vec, grid, s, x, rows, offs, n_segments, k, lanes, 0, 0, out);
  } else {
    dispatch<LaunchSegsumRows<kModeFull, false>>(
        dtype, vec, grid, s, x, rows, offs, n_segments, k, lanes, 0, 0, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1 over identity rows with a second, one-column operand: out as
// desco_sorted_segment_sum over x [E, k], and aux_out [n_segments] f32
// the sums of aux [E] (``dtype`` too) over the same offsets. Wide rows
// (k > 16) carry aux in the same launch; narrow ones are K1 on x, then
// K1 on aux (two launches, the same sums).
int desco_sorted_segment_sum_pair(void* x, void* aux, int dtype,
                                  const int* offs, int n_segments, int k,
                                  float* out, float* aux_out, void* stream) {
  if (n_segments <= 0) return 0;
  if (k <= 0 || !known_dtype(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = pick_vec(k, dtype == kBf16 ? 2 : 4, x, out);
  if (lanes_per_row(k, vec) < kWarp) {
    const int rc = desco_sorted_segment_sum(x, dtype, nullptr, offs,
                                            n_segments, k, out, stream);
    if (rc != 0) return rc;
    return desco_sorted_segment_sum(aux, dtype, nullptr, offs, n_segments, 1,
                                    aux_out, stream);
  }
  const dim3 grid = segsum_grid(n_segments, k, vec);
  if (grid.x == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dispatch<LaunchSegsumPair>(dtype, vec, grid, s, x,
                             static_cast<const void*>(aux), offs, n_segments,
                             k, out, aux_out);
  return static_cast<int>(cudaGetLastError());
}

// ``dtype`` is the output's (the dtype of K1's messages); g is f32.
int desco_segment_sum_vjp_gather(const float* g, const int* seg, int n_edges,
                                 int n_segments, int k, void* out, int dtype,
                                 void* stream) {
  if (n_edges <= 0 || k <= 0) return 0;
  if (!known_dtype(dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = pick_piece(k, dtype == kBf16 ? 2 : 4, g, out);
  const int ppr = k / vec;
  const long long n_pieces = (long long)n_edges * ppr;
  const long long blocks = (n_pieces + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* no_aux = nullptr;
  dispatch<LaunchVjpGather<false>>(dtype, vec, grid, s, out, g, seg,
                                   n_pieces, ppr, n_segments, k, nullptr,
                                   no_aux);
  return static_cast<int>(cudaGetLastError());
}

// The cotangents of desco_sorted_segment_sum_pair's two operands in one
// launch: out [n_edges, k] as desco_segment_sum_vjp_gather from g, and
// aux_out [n_edges] (``dtype`` too) from g_aux [n_segments] f32.
int desco_segment_sum_vjp_gather_pair(const float* g, const float* g_aux,
                                      const int* seg, int n_edges,
                                      int n_segments, int k, void* out,
                                      void* aux_out, int dtype,
                                      void* stream) {
  if (n_edges <= 0) return 0;
  if (k <= 0 || !known_dtype(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = pick_piece(k, dtype == kBf16 ? 2 : 4, g, out);
  const int ppr = k / vec;
  const long long n_pieces = (long long)n_edges * ppr;
  const long long blocks = (n_pieces + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dispatch<LaunchVjpGather<true>>(dtype, vec, grid, s, out, g, seg, n_pieces,
                                  ppr, n_segments, k, aux_out, g_aux);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
