// The typed transform-aggregate of the SHMP target tower, forward and
// backward, for Hopper (sm_90a), plain C interface.
//
// K2' desco_typed_aggregate_fwd replaces desco_tpu's
//     fused_typed_transform_aggregate -> _fused_legacy
//     (desco_tpu/ops/pallas_segment.py:476, :500):
//       out[d] = sum_t A[d, t] @ W_t,  A[d, t] = sum over the type-t edges
//       s -> d of x[s]
//     (aggregate first, then transform: desco_tpu's ``aggregate_first``
//     order, models/shmp_gnn.py:144-177).
// K3' desco_typed_aggregate_bwd + desco_typed_aggregate_dw_reduce replace
//     desco_tpu's _bwd_perm (pallas_segment.py:559-591), the VJP of
//     _fused_perm (:548):
//       U[s, t] = sum over the type-t edges s -> d of g[d]
//       dx[s]   = sum_t U[s, t] @ W_t^T,   dW_t = sum_s x[s]^T U[s, t]
//
// What bounds them on an H100: at the paper width (H = K = 64, T = 6) the
// products (2*N*T*H*K each) on the tensor cores in split TF32 (three
// passes for f32, two for bf16) and the gather of one x or g row per live
// edge from L2 (the tables are 2-4 MB). Neither z = x @ W [T*N, K] nor the
// cotangent sums u [N*T, K] are written to device memory.
//
// Design. A tile is 32 consecutive output rows (destinations for K2',
// sources for K3'). The edge stream is sorted by (row, type), so the T
// runs of one row are one contiguous range; the per-(row, type) offsets
// [rows*T + 1] come from the wrapper (one searchsorted per batch). A
// persistent grid of one 512-thread block per SM walks the tiles. Per
// tile:
//   1. the tile's T*32+1 offsets go to shared memory;
//   2. gather (gather_tile): lane groups own consecutive rows and sum the
//      table rows of each (row, type) run in f32 registers, written once
//      into the shared tile S[t][row] (A for K2', U for K3'). Every run
//      has one owner and a fixed order: the sums are deterministic and use
//      no atomics.
//   3. per type t, mma.sync.m16n8k8 (TF32 in, f32 accumulate) on shared
//      tiles. f32 operands are split, a = hi + lo with hi = a with its 13
//      low mantissa bits cleared, and a*b = hi*hi + hi*lo + lo*hi
//      ("3xTF32"); an operand that came from bf16 is exact in TF32 and is
//      not split (two passes).
//      K2': out[32, K] += A_t @ W_t, written once. Warp-specialized: 8
//      warps gather the next tile into one of two A buffers while 8 warps
//      multiply this one.
//      K3': dx[32, H] += U_t @ W_t^T, written once in x's dtype, and the
//      block's dW_t [H, K] += X_tile^T @ U_t, accumulated over the block's
//      tiles in shared memory (or, where that does not fit, in the block's
//      slice of the partials). All 16 warps gather, then all multiply.
// W is copied into shared memory with cp.async: all T matrices once per
// block where they fit (K2' at the paper width), else a ring of two
// buffers, the next type's copy in flight while this type multiplies.
// K3' writes one [T, HP, KP] f32 partial of dW per block;
// desco_typed_aggregate_dw_reduce sums them in block order (fixed, no
// atomics) and casts to W's dtype.
//
// More types than fit. The shared tiles hold a tile's rows for every
// type, about 17 KB per type for K2' and 9 KB for K3' at H = K = 64 in
// f32: K2' takes at most 11 types at once, K3' 21. Past that (order-4
// typing has 33) a tile's types run in chunks of tc (the host plans pick
// the fewest chunks that fit, split evenly: 4 chunks of 9 for K2', 2 of
// 17 for K3' at T = 33 in f32). Each chunk is gathered into the shared
// tile and multiplied; the output rows (K2') and dx (K3') stay in each
// warp's mma fragments across the chunks and are written once, and dW
// goes to the block's partial in device memory. The types are multiplied
// in the order 0 .. T-1 whatever the chunking, so a chunked run equals an
// unchunked one bit for bit (desco_typed_aggregate_set_chunk_cap makes
// the check possible at a T that fits whole).
//
// Layout contract (checked or arranged by ops/cuda_segment.py): x [n, h8],
// g [n, k8], W [T, h8, k8] contiguous, 16-byte aligned, h8 and k8
// multiples of 8 (the wrapper pads odd widths with zeros), both at most
// 128; dtype code 0 = float32, 1 = bfloat16 for x, g and W alike.
// Outputs take the real widths h <= h8, k <= k8. Every function launches
// on the stream it is given, allocates nothing and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF32 = 0;  // dtype codes of the C interface
constexpr int kBf16 = 1;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 32;      // rows of a tile
constexpr int kUnroll = 4;   // rows in flight per lane group
constexpr int kMaxWidth = 128;

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kVec = 4;          // elements per 16-byte load
  static constexpr bool kExact = false;   // exact in TF32?
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr bool kExact = true;
};

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// ------------------------------------------------------------- primitives
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One operand value as TF32 (hi, lo): split unless it is exact in TF32.
// hi keeps the sign, the exponent and the top 10 mantissa bits (the low
// 13 cleared: a TF32 value); lo = v - hi is exact in f32 and has at most
// 13 significant bits, of which the tensor core reads the top 11, so
// hi + lo carries v to 2^-21 of |v|. Two integer-rate instructions, where
// cvt.rna.tf32.f32 would cost a conversion (quarter rate) per value.
template <bool EXACT>
__device__ __forceinline__ void frag(float v, unsigned& hi, unsigned& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(v);
    lo = 0u;
  } else {
    hi = __float_as_uint(v) & 0xffffe000u;
    lo = __float_as_uint(v - __uint_as_float(hi));
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a*b in split TF32: hi*hi into c, the small cross terms into d (two
// independent chains of dependent mma; the caller adds d to c at the end).
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_split(float (&c)[4], float (&d)[4],
                                          const unsigned (&ahi)[4],
                                          const unsigned (&alo)[4],
                                          const unsigned (&bhi)[2],
                                          const unsigned (&blo)[2]) {
  if constexpr (!A_EXACT) mma_tf32(d, alo, bhi);
  if constexpr (!B_EXACT) mma_tf32(d, ahi, blo);
  mma_tf32(c, ahi, bhi);
}

// Named barriers: ``bar_arrive`` signals without waiting, ``bar_sync``
// waits until ``n`` threads (arrivals and waiters) reached barrier ``id``;
// the pair orders the shared-memory writes before it.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// acc += the VEC elements of one 16-byte row piece.
__device__ __forceinline__ void add16(float (&acc)[4], const uint4& v,
                                      float) {
  acc[0] += __uint_as_float(v.x);
  acc[1] += __uint_as_float(v.y);
  acc[2] += __uint_as_float(v.z);
  acc[3] += __uint_as_float(v.w);
}
__device__ __forceinline__ void add16(float (&acc)[8], const uint4& v,
                                      __nv_bfloat16) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] += __uint_as_float(w[i] << 16);              // low half
    acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);  // high half
  }
}

// --------------------------------------------------------------- gather
// Sum the ``n_runs`` consecutive runs [ro[j], ro[j + 1]) of the edge
// stream into the shared tile: run j goes to slot t of row r, starting at
// (r_first, 0) with t cycling over ``tc`` slots before r steps on. The
// runs are one contiguous edge range, walked by one group of lanes with
// 16-byte loads per lane (column c; ``active`` lanes only), kUnroll rows
// in flight (across run ends) and the next kUnroll indices prefetched;
// each run's sum is written once, empty runs as zeros.
template <typename T>
__device__ __forceinline__ void gather_runs(const T* __restrict__ tc_ptr,
                                            int n_table, int width,
                                            const int* __restrict__ idx,
                                            const int* ro, int n_runs,
                                            int r_first, int tc,
                                            float* s_tile, int ld, int c,
                                            bool active) {
  constexpr int V = Elem<T>::kVec;
  const int t_stride = kBM * ld;
  int r = r_first, t = 0;
  const int hi = ro[n_runs];
  int e = ro[0];
  int ru = 0;       // run of the group
  int nb = ro[1];   // end of run ru
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  auto flush = [&]() {  // write run ru, step to the next
    if (active) {
      float4* d = reinterpret_cast<float4*>(s_tile + t * t_stride +
                                            r * ld + c);
#pragma unroll
      for (int i = 0; i < V / 4; ++i)
        d[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                           acc[4 * i + 3]);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    ++ru;
    if (++t == tc) {
      t = 0;
      ++r;
    }
  };
  int q[kUnroll];
#pragma unroll
  for (int i = 0; i < kUnroll; ++i)
    q[i] = e + i < hi ? min(max(idx[e + i], 0), n_table - 1) : 0;
  while (e < hi) {
    uint4 v[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (active && e + i < hi)
        v[i] = __ldg(reinterpret_cast<const uint4*>(
            tc_ptr + static_cast<int64_t>(q[i]) * width));
    }
    const int e2 = e + kUnroll;
#pragma unroll
    for (int i = 0; i < kUnroll; ++i)
      q[i] = e2 + i < hi ? min(max(idx[e2 + i], 0), n_table - 1) : 0;
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (e + i < hi) {
        while (e + i >= nb) {  // the edge starts a later run
          flush();
          nb = ro[ru + 1];
        }
        add16(acc, v[i], T());
      }
    }
    e = e2;
  }
  while (ru < n_runs) flush();  // the open run and empty ones
}

// S[j][r][c] = sum over e in [offs_s[r*T + t0 + j], offs_s[r*T + t0 + j +
// 1]) of table[clamp(idx[e]), c] for the tile's rows r < kBM, the chunk's
// types t0 + j, j < tc, and c < width (columns [width, ld) are left
// alone), by the ``n_warps`` warps of threads ``tid`` = 0 .. 32*n_warps -
// 1; ``offs_s`` holds the tile's kBM*T + 1 offsets. A group of ``G`` lanes
// owns consecutive rows. With every type in one chunk (tc = T) a group's
// runs are one contiguous edge range, walked at once; a chunk of fewer
// types is one range per row. Every run has one owner and a fixed order:
// the result does not depend on the launch or on the chunking. (Equal
// chunks of the tile's edges per group, with carries for the runs that
// cross chunks, balance long rows better but measured slower on an H100:
// PERF.md.)
template <typename T>
__device__ __forceinline__ void gather_tile(const T* __restrict__ table,
                                            int n_table, int width,
                                            const int* __restrict__ idx,
                                            const int* offs_s, int n_types,
                                            int t0, int tc, float* s_tile,
                                            int ld, int G, int tid,
                                            int n_warps) {
  constexpr int V = Elem<T>::kVec;
  const int lane = tid & 31;
  const int per_warp = 32 / G;
  const int gid = (tid >> 5) * per_warp + lane / G;
  const int n_groups = n_warps * per_warp;
  const int c = (lane % G) * V;
  const bool active = c < width;
  const T* __restrict__ tc_ptr = table + (active ? c : 0);
  // a group owns rows_per consecutive rows
  const int rows_per = (kBM + n_groups - 1) / n_groups;
  const int r_first = gid * rows_per;
  if (r_first >= kBM) return;
  const int r_end = min(r_first + rows_per, kBM);
  if (tc == n_types) {
    gather_runs<T>(tc_ptr, n_table, width, idx, offs_s + r_first * n_types,
                   (r_end - r_first) * n_types, r_first, n_types, s_tile,
                   ld, c, active);
  } else {
    for (int r = r_first; r < r_end; ++r)
      gather_runs<T>(tc_ptr, n_table, width, idx,
                     offs_s + r * n_types + t0, tc, r, tc, s_tile, ld, c,
                     active);
  }
}

// Copy the [HP, KP] tile of one W_t ([h8, k8] in device memory) into
// shared memory with row stride LD; rows >= h8 and columns >= k8 are
// zero-filled. Threads ``tid`` of ``n_threads`` issue the copies.
template <typename T, int HP, int KP, int LD>
__device__ __forceinline__ void load_w(T* dst, const T* __restrict__ w_t,
                                       int h8, int k8, int tid,
                                       int n_threads) {
  constexpr int V = Elem<T>::kVec;
  constexpr int kChunks = KP / V;
  for (int i = tid; i < HP * kChunks; i += n_threads) {
    const int r = i / kChunks;
    const int cc = (i % kChunks) * V;
    const bool in = r < h8 && cc < k8;
    cp_async16(dst + r * LD + cc,
               in ? static_cast<const void*>(w_t + r * k8 + cc)
                  : static_cast<const void*>(w_t),
               in ? 16 : 0);
  }
}

// Tiles of an [M, N] product over W warps: kPerWarp n8-tiles per warp,
// all in one m16 row of tiles (so a warp loads its A fragment once per
// step).
template <int M, int N, int W = kWarps>
struct WarpTiles {
  static constexpr int kTiles = (M / 16) * (N / 8);
  static constexpr int kPerWarp = kTiles >= W ? kTiles / W : 1;
  static_assert((N / 8) % kPerWarp == 0, "a warp's tiles share one row");
};

// ------------------------------------------------------------------ K2'
// Warp-specialized: the producer warps gather tile i+1 into one of two A
// buffers while the consumer warps multiply tile i from the other; named
// barriers hand the buffers over (FULL: gathered, EMPTY: multiplied).
constexpr int kProducerWarps = 8;
constexpr int kConsumerWarps = kWarps - kProducerWarps;
constexpr int kProducerThreads = kProducerWarps * 32;
constexpr int kConsumerThreads = kConsumerWarps * 32;
constexpr int kBarFull = 1;       // + buffer: 1, 2
constexpr int kBarEmpty = 3;      // + buffer: 3, 4
constexpr int kBarProducers = 5;  // the gathering warps among themselves
constexpr int kBarConsumers = 6;  // the multiplying warps among themselves

template <typename T, int HP, int KP>
struct FwdShape {
  static constexpr int kALd = HP + 4;  // f32, conflict-free A fragments
  static constexpr int kWLd = KP + 8;  // conflict-free B fragments
  // a tile's offsets, all T types
  __host__ __device__ static int offs_ints(int n_types) {
    return round16((kBM * n_types + 1) * 4) / 4;
  }
  // an A buffer: the tile's rows for a chunk of tc types
  __host__ __device__ static int a_floats(int tc) { return tc * kBM * kALd; }
  // two offsets and two A buffers, then W
  __host__ __device__ static int w_offset(int n_types, int tc) {
    return 2 * 4 * (offs_ints(n_types) + a_floats(tc));
  }
  __host__ __device__ static int w_bytes(int n_mats) {
    return n_mats * HP * kWLd * static_cast<int>(sizeof(T));
  }
};

// The items of a block are (tile, chunk) pairs: tile i of the block's
// tiles and chunk ch of its types, [ch*tc, min((ch + 1)*tc, T)), in that
// order. The producers gather item it into A buffer it & 1; the consumers
// keep out[32, K] of a tile in registers across its chunks, multiplying
// the types in order 0 .. T-1 as with one chunk, and write it once after
// the last: chunking changes no sum.
template <typename T, int HP, int KP>
__global__ void __launch_bounds__(kThreads, 1)
typed_aggregate_fwd_kernel(const T* __restrict__ x, int n_rows, int h8,
                           const int* __restrict__ src,
                           const int* __restrict__ toffs, int n_nodes,
                           int n_types, const T* __restrict__ w, int k8,
                           float* __restrict__ out, int k, int n_tiles,
                           int w_resident, int G, int tc, int n_chunks) {
  using S = FwdShape<T, HP, KP>;
  using WT = WarpTiles<kBM, KP, kConsumerWarps>;
  constexpr bool kExact = Elem<T>::kExact;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_offs = S::offs_ints(n_types);
  const int n_a = S::a_floats(tc);
  int* offs_buf = reinterpret_cast<int*>(smem);                // [2][n_offs]
  float* a_buf = reinterpret_cast<float*>(offs_buf + 2 * n_offs);  // [2][n_a]
  T* w_s = reinterpret_cast<T*>(smem + S::w_offset(n_types, tc));
  const int warp = threadIdx.x >> 5;
  const int n_seg = n_nodes * n_types;
  // the gather never writes the columns [h8, HP): zero both buffers once
  for (int i = threadIdx.x * 4; i < 2 * n_a; i += kThreads * 4)
    *reinterpret_cast<float4*>(a_buf + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  // this block's tiles: blockIdx.x, + gridDim.x, ...
  const int n_mine =
      (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int n_items = n_mine * n_chunks;

  if (warp < kProducerWarps) {  // ------------------------------ gathering
    const int tid = threadIdx.x;
    for (int it = 0; it < n_items; ++it) {
      const int b = it & 1;
      const int ti = it / n_chunks, t0 = (it - ti * n_chunks) * tc;
      const int row0 = (blockIdx.x + ti * gridDim.x) * kBM;
      int* offs_s = offs_buf + b * n_offs;
      if (it >= 2) bar_sync(kBarEmpty + b, kThreads);  // item it-2 is done
      for (int i = tid; i <= kBM * n_types; i += kProducerThreads)
        offs_s[i] = toffs[min(row0 * n_types + i, n_seg)];
      bar_sync(kBarProducers, kProducerThreads);
      if (offs_s[0] != offs_s[kBM * n_types])
        gather_tile<T>(x, n_rows, h8, src, offs_s, n_types, t0,
                       min(tc, n_types - t0), a_buf + b * n_a, S::kALd, G,
                       tid, kProducerWarps);
      bar_arrive(kBarFull + b, kThreads);
    }
    return;
  }
  // ------------------------------------------------------ multiplying
  const int tid = threadIdx.x - kProducerThreads;
  const int cw = warp - kProducerWarps;
  const int lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wmat = HP * S::kWLd;  // elements of one W_t tile
  if (w_resident) {
    for (int t = 0; t < n_types; ++t)
      load_w<T, HP, KP, S::kWLd>(w_s + t * wmat, w + t * h8 * k8, h8, k8,
                                 tid, kConsumerThreads);
  } else {
    load_w<T, HP, KP, S::kWLd>(w_s, w, h8, k8, tid, kConsumerThreads);
  }
  cp_async_commit();
  if (w_resident) {
    cp_async_wait<0>();
    bar_sync(kBarConsumers, kConsumerThreads);
  }
  int q = 0;  // W copies consumed so far (ring mode)
  const int tile0 = cw * WT::kPerWarp;
  const bool mma_warp = tile0 < WT::kTiles;
  const int mt = tile0 / (KP / 8);
  const int nt0 = tile0 % (KP / 8);
  float acc[WT::kPerWarp][4], acc_x[WT::kPerWarp][4];

  for (int it = 0; it < n_items; ++it) {
    const int b = it & 1;
    const int ti = it / n_chunks, ch = it - ti * n_chunks;
    const int t0 = ch * tc, t1 = min(t0 + tc, n_types);
    const int row0 = (blockIdx.x + ti * gridDim.x) * kBM;
    const int* offs_s = offs_buf + b * n_offs;
    const float* a_s = a_buf + b * n_a;
    bar_sync(kBarFull + b, kThreads);  // item it is gathered
    const bool empty = offs_s[0] == offs_s[kBM * n_types];
    if (ch == 0) {
#pragma unroll
      for (int j = 0; j < WT::kPerWarp; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = acc_x[j][i] = 0.f;
    }

    for (int t = t0; t < t1; ++t) {
      const T* w_t;
      if (w_resident) {
        w_t = w_s + t * wmat;
      } else {
        // the next copy (the next type, or type 0 of the next tile) into
        // the other buffer, then wait for this one
        if (t + 1 < n_types || ti + 1 < n_mine) {
          const int tn = t + 1 < n_types ? t + 1 : 0;
          load_w<T, HP, KP, S::kWLd>(w_s + ((q + 1) & 1) * wmat,
                                     w + tn * h8 * k8, h8, k8, tid,
                                     kConsumerThreads);
        }
        cp_async_commit();
        cp_async_wait<1>();
        bar_sync(kBarConsumers, kConsumerThreads);
        w_t = w_s + (q & 1) * wmat;
      }
      if (!empty && mma_warp) {
        const float* a_t =
            a_s + (t - t0) * kBM * S::kALd + (mt * 16 + g) * S::kALd;
#pragma unroll
        for (int kk = 0; kk < HP; kk += 8) {  // columns >= h8 are zero
          unsigned ahi[4], alo[4];
          frag<false>(a_t[kk + tq], ahi[0], alo[0]);
          frag<false>(a_t[8 * S::kALd + kk + tq], ahi[1], alo[1]);
          frag<false>(a_t[kk + tq + 4], ahi[2], alo[2]);
          frag<false>(a_t[8 * S::kALd + kk + tq + 4], ahi[3], alo[3]);
#pragma unroll
          for (int j = 0; j < WT::kPerWarp; ++j) {
            const int n = (nt0 + j) * 8 + g;
            unsigned bhi[2], blo[2];
            frag<kExact>(to_float(w_t[(kk + tq) * S::kWLd + n]), bhi[0],
                         blo[0]);
            frag<kExact>(to_float(w_t[(kk + tq + 4) * S::kWLd + n]), bhi[1],
                         blo[1]);
            mma_split<false, kExact>(acc[j], acc_x[j], ahi, alo, bhi, blo);
          }
        }
      }
      if (!w_resident) {
        // this buffer is refilled two copies from now
        bar_sync(kBarConsumers, kConsumerThreads);
        ++q;
      }
    }
    if (it + 2 < n_items) bar_arrive(kBarEmpty + b, kThreads);
    if (mma_warp && ch == n_chunks - 1) {
#pragma unroll
      for (int j = 0; j < WT::kPerWarp; ++j) {
        const int col = (nt0 + j) * 8 + 2 * tq;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + mt * 16 + g + 8 * hh;
          if (row >= n_nodes) continue;
          float* o = out + static_cast<int64_t>(row) * k;
          if (col < k) o[col] = acc[j][2 * hh] + acc_x[j][2 * hh];
          if (col + 1 < k)
            o[col + 1] = acc[j][2 * hh + 1] + acc_x[j][2 * hh + 1];
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------------ K3'
template <typename T, int HP, int KP>
struct BwdShape {
  static constexpr int kULd = KP + 4;  // f32
  static constexpr int kXLd = HP + 8;
  static constexpr int kWLd = KP + (sizeof(T) == 4 ? 4 : 8);
  static constexpr int kAccLd = KP + 8;  // f32, shared-memory dW
  __host__ __device__ static int offs_bytes(int n_types) {
    return round16((kBM * n_types + 1) * 4);
  }
  // U for a chunk of tc types
  __host__ __device__ static int u_bytes(int tc) { return tc * kBM * kULd * 4; }
  static constexpr int kXBytes = round16(kBM * kXLd * sizeof(T));
  __host__ __device__ static int w_bytes(int n_mats) {
    return n_mats * HP * kWLd * static_cast<int>(sizeof(T));
  }
  __host__ __device__ static int acc_bytes(int n_types) {
    return n_types * HP * kAccLd * 4;
  }
  __host__ __device__ static int base_bytes(int n_types, int tc) {
    return offs_bytes(n_types) + u_bytes(tc) + kXBytes;
  }
};

template <typename T, int HP, int KP>
__global__ void __launch_bounds__(kThreads, 1)
typed_aggregate_bwd_kernel(const T* __restrict__ gt, int n_nodes, int k8,
                           const int* __restrict__ rows,
                           const int* __restrict__ boffs,
                           const T* __restrict__ x, int n_rows, int h8,
                           const T* __restrict__ w, int n_types,
                           T* __restrict__ dx, int h,
                           float* __restrict__ partial, int n_tiles,
                           int w_resident, int acc_in_smem, int G, int tc,
                           int n_chunks) {
  using S = BwdShape<T, HP, KP>;
  using DX = WarpTiles<kBM, HP>;
  using DW = WarpTiles<HP, KP>;
  constexpr bool kExact = Elem<T>::kExact;
  constexpr int V = Elem<T>::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  int* offs_s = reinterpret_cast<int*>(smem);
  unsigned char* p = smem + S::offs_bytes(n_types);
  float* u_s = reinterpret_cast<float*>(p);
  p += S::u_bytes(tc);
  T* x_s = reinterpret_cast<T*>(p);
  p += S::kXBytes;
  T* w_s = reinterpret_cast<T*>(p);
  p += S::w_bytes(w_resident ? n_types : 2);
  const int acc_ld = acc_in_smem ? S::kAccLd : KP;
  float* dw_acc = acc_in_smem
                      ? reinterpret_cast<float*>(p)
                      : partial + static_cast<int64_t>(blockIdx.x) *
                                      n_types * HP * KP;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int n_seg = n_rows * n_types;
  const int wmat = HP * S::kWLd;

  for (int i = threadIdx.x; i < n_types * HP * acc_ld; i += kThreads)
    dw_acc[i] = 0.f;
  // the gather never writes the columns [k8, KP) of U: zero them once
  for (int i = threadIdx.x * 4; i < tc * kBM * S::kULd; i += kThreads * 4)
    *reinterpret_cast<float4*>(u_s + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  // this block's W copies in order: type j % T for j < n_mine * T
  const int n_mine =
      (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int n_copies = n_mine * n_types;
  // all T matrices where they fit, else a ring of two buffers: copy
  // q + 1 in flight while copy q multiplies
  for (int t = 0; t < (w_resident ? n_types : 1); ++t)
    load_w<T, HP, KP, S::kWLd>(w_s + t * wmat, w + t * h8 * k8, h8, k8,
                               threadIdx.x, kThreads);
  cp_async_commit();
  int q = 0;  // W copies consumed so far

  const int dx0 = warp * DX::kPerWarp;
  const bool dx_warp = dx0 < DX::kTiles;
  const int dx_mt = dx0 / (HP / 8), dx_nt0 = dx0 % (HP / 8);
  const int dw0 = warp * DW::kPerWarp;
  const bool dw_warp = dw0 < DW::kTiles;
  const int dw_mt = dw0 / (KP / 8), dw_nt0 = dw0 % (KP / 8);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kBM;
    __syncthreads();  // the last tile is done with offs_s, u_s and x_s
    for (int i = threadIdx.x; i <= kBM * n_types; i += kThreads)
      offs_s[i] = boffs[min(row0 * n_types + i, n_seg)];
    // the tile's x rows (zeros past n_rows and h8), for dW
    for (int i = threadIdx.x; i < kBM * (HP / V); i += kThreads) {
      const int r = i / (HP / V);
      const int cc = (i % (HP / V)) * V;
      const bool in = row0 + r < n_rows && cc < h8;
      cp_async16(x_s + r * S::kXLd + cc,
                 in ? static_cast<const void*>(
                          x + static_cast<int64_t>(row0 + r) * h8 + cc)
                    : static_cast<const void*>(x),
                 in ? 16 : 0);
    }
    cp_async_commit();
    __syncthreads();
    const bool empty = offs_s[0] == offs_s[kBM * n_types];

    float dxa[DX::kPerWarp][4], dxa_x[DX::kPerWarp][4];
#pragma unroll
    for (int j = 0; j < DX::kPerWarp; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) dxa[j][i] = dxa_x[j][i] = 0.f;

    // the tile's types in chunks of tc (one chunk where U fits all T):
    // gather U of the chunk, then multiply its types in order; dx stays
    // in registers across the chunks and is written once
    for (int t0 = 0; t0 < n_types; t0 += tc) {
      const int t1 = min(t0 + tc, n_types);
      if (t0 > 0) __syncthreads();  // the last chunk is done with u_s
      if (!empty)
        gather_tile<T>(gt, n_nodes, k8, rows, offs_s, n_types, t0, t1 - t0,
                       u_s, S::kULd, G, threadIdx.x, kWarps);
      for (int t = t0; t < t1; ++t) {
        const T* w_t;
        if (w_resident) {
          if (t == t0) {
            cp_async_wait<0>();  // the tile's x rows (and, once, all of W)
            __syncthreads();
          }
          w_t = w_s + t * wmat;
        } else {
          if (q + 1 < n_copies)
            load_w<T, HP, KP, S::kWLd>(w_s + ((q + 1) & 1) * wmat,
                                       w + ((q + 1) % n_types) * h8 * k8, h8,
                                       k8, threadIdx.x, kThreads);
          cp_async_commit();
          cp_async_wait<1>();  // this W_t and the tile's x rows have landed
          __syncthreads();
          w_t = w_s + (q & 1) * wmat;
        }
        const float* u_t = u_s + (t - t0) * kBM * S::kULd;
        if (!empty && dx_warp) {
          // dx[32, HP] += U_t [32, KP] @ W_t^T: A = U_t, B[c][hh] = W_t[hh][c]
          const float* a_t = u_t + (dx_mt * 16 + g) * S::kULd;
#pragma unroll
          for (int kk = 0; kk < KP; kk += 8) {  // columns >= k8 are zero
            unsigned ahi[4], alo[4];
            frag<false>(a_t[kk + tq], ahi[0], alo[0]);
            frag<false>(a_t[8 * S::kULd + kk + tq], ahi[1], alo[1]);
            frag<false>(a_t[kk + tq + 4], ahi[2], alo[2]);
            frag<false>(a_t[8 * S::kULd + kk + tq + 4], ahi[3], alo[3]);
#pragma unroll
            for (int j = 0; j < DX::kPerWarp; ++j) {
              const T* wr = w_t + ((dx_nt0 + j) * 8 + g) * S::kWLd;
              unsigned bhi[2], blo[2];
              frag<kExact>(to_float(wr[kk + tq]), bhi[0], blo[0]);
              frag<kExact>(to_float(wr[kk + tq + 4]), bhi[1], blo[1]);
              mma_split<false, kExact>(dxa[j], dxa_x[j], ahi, alo, bhi, blo);
            }
          }
        }
        if (!empty && dw_warp) {
          // dW_t[HP, KP] += X^T [HP, 32] @ U_t [32, KP]
          float* acc_t = dw_acc + t * HP * acc_ld;
          float c[DW::kPerWarp][4], cx[DW::kPerWarp][4];
#pragma unroll
          for (int j = 0; j < DW::kPerWarp; ++j) {
            const int col = (dw_nt0 + j) * 8 + 2 * tq;
            const float2 lo = *reinterpret_cast<const float2*>(
                acc_t + (dw_mt * 16 + g) * acc_ld + col);
            const float2 hi8 = *reinterpret_cast<const float2*>(
                acc_t + (dw_mt * 16 + g + 8) * acc_ld + col);
            c[j][0] = lo.x;
            c[j][1] = lo.y;
            c[j][2] = hi8.x;
            c[j][3] = hi8.y;
#pragma unroll
            for (int i = 0; i < 4; ++i) cx[j][i] = 0.f;
          }
#pragma unroll
          for (int kk = 0; kk < kBM; kk += 8) {
            const T* xa = x_s + (kk + tq) * S::kXLd + dw_mt * 16 + g;
            unsigned ahi[4], alo[4];
            frag<kExact>(to_float(xa[0]), ahi[0], alo[0]);
            frag<kExact>(to_float(xa[8]), ahi[1], alo[1]);
            frag<kExact>(to_float(xa[4 * S::kXLd]), ahi[2], alo[2]);
            frag<kExact>(to_float(xa[4 * S::kXLd + 8]), ahi[3], alo[3]);
#pragma unroll
            for (int j = 0; j < DW::kPerWarp; ++j) {
              const float* ub =
                  u_t + (kk + tq) * S::kULd + (dw_nt0 + j) * 8 + g;
              unsigned bhi[2], blo[2];
              frag<false>(ub[0], bhi[0], blo[0]);
              frag<false>(ub[4 * S::kULd], bhi[1], blo[1]);
              mma_split<kExact, false>(c[j], cx[j], ahi, alo, bhi, blo);
            }
          }
#pragma unroll
          for (int j = 0; j < DW::kPerWarp; ++j) {
            const int col = (dw_nt0 + j) * 8 + 2 * tq;
            *reinterpret_cast<float2*>(acc_t + (dw_mt * 16 + g) * acc_ld +
                                       col) =
                make_float2(c[j][0] + cx[j][0], c[j][1] + cx[j][1]);
            *reinterpret_cast<float2*>(acc_t + (dw_mt * 16 + g + 8) * acc_ld +
                                       col) =
                make_float2(c[j][2] + cx[j][2], c[j][3] + cx[j][3]);
          }
        }
        if (!w_resident) __syncthreads();  // this buffer is refilled next
        ++q;
      }
    }
    if (dx_warp) {
#pragma unroll
      for (int j = 0; j < DX::kPerWarp; ++j) {
        const int col = (dx_nt0 + j) * 8 + 2 * tq;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + dx_mt * 16 + g + 8 * hh;
          if (row >= n_rows) continue;
          T* o = dx + static_cast<int64_t>(row) * h;
          if (col < h)
            store_as(o + col, dxa[j][2 * hh] + dxa_x[j][2 * hh]);
          if (col + 1 < h)
            store_as(o + col + 1, dxa[j][2 * hh + 1] + dxa_x[j][2 * hh + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (acc_in_smem) {  // the block's dW partial, [T, HP, KP]
    __syncthreads();
    float* dst = partial + static_cast<int64_t>(blockIdx.x) * n_types * HP * KP;
    for (int i = threadIdx.x; i < n_types * HP * KP; i += kThreads) {
      const int rr = i / KP, cc = i % KP;
      dst[i] = dw_acc[rr * acc_ld + cc];
    }
  }
}

// dW[t, hh, c] = sum over blocks b, in order, of partial[b, t, hh, c], for
// hh < h and c < k, cast to T. A block takes 32 outputs; its 8 warps sum
// 8 contiguous ranges of blocks, combined in warp order.
template <typename T>
__global__ void __launch_bounds__(256)
dw_reduce_kernel(const float* __restrict__ partial, int n_blocks,
                 int n_types, int hp, int kp, int h, int k,
                 T* __restrict__ dw) {
  __shared__ float part[8][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t total = static_cast<int64_t>(n_types) * h * k;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  float s = 0.f;
  if (i < total) {
    const int64_t t = i / (static_cast<int64_t>(h) * k);
    const int64_t rem = i - t * h * k;
    const int64_t off = (t * hp + rem / k) * kp + rem % k;
    const int64_t stride = static_cast<int64_t>(n_types) * hp * kp;
    const int per = (n_blocks + 7) / 8;
    const int b1 = min(n_blocks, (warp + 1) * per);
    for (int b = warp * per; b < b1; ++b) s += partial[b * stride + off];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < total) {
    float r = 0.f;
#pragma unroll
    for (int ww = 0; ww < 8; ++ww) r += part[ww][lane];
    store_as(dw + i, r);
  }
}

// ------------------------------------------------------------ host side
constexpr int kMaxSmem = 232448;  // an H100 block's opt-in shared memory

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Allow ``bytes`` of dynamic shared memory for ``kernel`` and return the
// blocks of it an SM holds. ``set_bytes`` and ``cached`` are statics of
// the caller's instantiation, so the calls run once per kernel and size,
// before any graph capture.
template <typename K>
cudaError_t configure(K kernel, int bytes, int* per_sm, int& set_bytes,
                      int& cached) {
  if (bytes != set_bytes) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached, kernel,
                                                      kThreads, bytes);
    if (e != cudaSuccess) return e;
    set_bytes = bytes;
  }
  *per_sm = cached;
  return cudaSuccess;
}

int pow2_width(int w) { return w <= 32 ? 32 : (w <= 64 ? 64 : 128); }

// Lanes per row in the gather: enough 16-byte pieces to cover ``width``,
// a power of two, at most a warp.
int group_lanes(int width, int vec) {
  int g = 1;
  while (g < 32 && g * vec < width) g <<= 1;
  return g;
}

bool shape_ok(int h8, int k8, int n_types) {
  return h8 > 0 && k8 > 0 && h8 % 8 == 0 && k8 % 8 == 0 &&
         h8 <= kMaxWidth && k8 <= kMaxWidth && n_types > 0;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The most types per chunk that the host plans use; 0: as many as fit.
// Set through desco_typed_aggregate_set_chunk_cap (the chunked path can
// then be checked against the unchunked one at the same T).
int g_chunk_cap = 0;

// Chunks of the T types: the fewest chunks whose types fit ``fits``,
// split evenly (tc = ceil(T / n_chunks)); with T in one chunk where it
// fits and the cap allows. False where not even one type fits.
template <typename Fits>
bool plan_chunks(int n_types, Fits fits, int* tc, int* n_chunks) {
  int most = n_types;
  if (g_chunk_cap > 0) most = min(most, g_chunk_cap);
  while (most > 0 && !fits(most)) --most;
  if (most == 0) return false;
  *n_chunks = (n_types + most - 1) / most;
  *tc = (n_types + *n_chunks - 1) / *n_chunks;
  return true;
}

// K2's shared memory, best first: all T types in one chunk with W
// resident (the paper width, T = 6), one chunk with a ring of two W
// buffers, then chunks of the types with the ring (T above 11 at H = K =
// 64 in f32: the 33 types of order-4 typing run in 4 chunks of 9).
template <typename T, int HP, int KP>
int fwd_plan(int n_types, int* bytes, int* w_resident, int* tc,
             int* n_chunks) {
  using S = FwdShape<T, HP, KP>;
  auto need = [&](int c, bool res) {
    return S::w_offset(n_types, c) + S::w_bytes(res ? n_types : 2);
  };
  if (!plan_chunks(n_types, [&](int c) { return need(c, false) <= kMaxSmem; },
                   tc, n_chunks))
    return static_cast<int>(cudaErrorInvalidValue);
  *w_resident = need(*tc, true) <= kMaxSmem ? 1 : 0;
  *bytes = need(*tc, *w_resident);
  return 0;
}

template <typename T, int HP, int KP>
int launch_fwd(const void* x, int n_rows, int h8, const int* src,
               const int* toffs, int n_nodes, int n_types, const void* w,
               int k8, float* out, int k, cudaStream_t s) {
  auto kernel = typed_aggregate_fwd_kernel<T, HP, KP>;
  const int G = group_lanes(h8, Elem<T>::kVec);
  int bytes = 0, resident = 0, tc = 0, n_chunks = 0;
  const int rc = fwd_plan<T, HP, KP>(n_types, &bytes, &resident, &tc,
                                     &n_chunks);
  if (rc != 0) return rc;
  static int set_bytes = -1, cached = 0;
  int per_sm = 0;
  cudaError_t e = configure(kernel, bytes, &per_sm, set_bytes, cached);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_tiles = (n_nodes + kBM - 1) / kBM;
  const int grid = min(n_tiles, max(per_sm, 1) * sm_count());
  kernel<<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(x), n_rows, h8, src, toffs, n_nodes, n_types,
      static_cast<const T*>(w), k8, out, k, n_tiles, resident, G, tc,
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// K3's shared memory, best first: all T types in one chunk with W
// resident and dW in shared memory (the bf16 tower at the paper width);
// one chunk with W through a ring of two (f32); one chunk with dW in the
// partials in device memory; then chunks of the types, with the ring and
// dW in the partials (T above 21 at H = K = 64: the 33 types of order-4
// typing run in 2 chunks of 17). (A ring of three, which fits beside an
// f32 dW, measured slower on an H100.)
template <typename T, int HP, int KP>
int bwd_plan(int n_rows, int n_types, int* bytes, int* w_resident,
             int* acc_in_smem, int* grid, int* tc, int* n_chunks) {
  using S = BwdShape<T, HP, KP>;
  auto need = [&](int c, int res, int acc) {
    return S::base_bytes(n_types, c) + S::w_bytes(res ? n_types : 2) +
           (acc ? S::acc_bytes(n_types) : 0);
  };
  const int choices[3][2] = {{1, 1}, {0, 1}, {0, 0}};
  *bytes = 0;
  const bool whole = g_chunk_cap <= 0 || g_chunk_cap >= n_types;
  for (const auto& c : choices) {
    if (whole && need(n_types, c[0], c[1]) <= kMaxSmem) {
      *bytes = need(n_types, c[0], c[1]);
      *w_resident = c[0];
      *acc_in_smem = c[1];
      *tc = n_types;
      *n_chunks = 1;
      break;
    }
  }
  if (*bytes == 0) {
    if (!plan_chunks(n_types,
                     [&](int c) { return need(c, 0, 0) <= kMaxSmem; }, tc,
                     n_chunks))
      return static_cast<int>(cudaErrorInvalidValue);
    *w_resident = 0;
    *acc_in_smem = 0;
    *bytes = need(*tc, 0, 0);
  }
  static int set_bytes = -1, cached = 0;
  int per_sm = 0;
  cudaError_t e = configure(typed_aggregate_bwd_kernel<T, HP, KP>, *bytes,
                            &per_sm, set_bytes, cached);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_tiles = (n_rows + kBM - 1) / kBM;
  *grid = min(n_tiles, max(per_sm, 1) * sm_count());
  return 0;
}

template <typename T, int HP, int KP>
int launch_bwd(const void* g, int n_nodes, int k8, const int* rows,
               const int* boffs, const void* x, int n_rows, int h8,
               const void* w, int n_types, void* dx, int h, float* partial,
               int n_blocks, cudaStream_t s) {
  int bytes = 0, w_resident = 0, acc_in_smem = 0, grid = 0, tc = 0,
      n_chunks = 0;
  const int rc = bwd_plan<T, HP, KP>(n_rows, n_types, &bytes, &w_resident,
                                     &acc_in_smem, &grid, &tc, &n_chunks);
  if (rc != 0) return rc;
  if (grid != n_blocks) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n_rows + kBM - 1) / kBM;
  typed_aggregate_bwd_kernel<T, HP, KP><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(g), n_nodes, k8, rows, boffs,
      static_cast<const T*>(x), n_rows, h8, static_cast<const T*>(w),
      n_types, static_cast<T*>(dx), h, partial, n_tiles, w_resident,
      acc_in_smem, group_lanes(k8, Elem<T>::kVec), tc, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// Call F::run<T, HP, KP>(args...) for a dtype code and padded widths.
template <typename F, typename... Args>
int dispatch(int dtype, int h8, int k8, Args... args) {
  const int hp = pow2_width(h8), kp = pow2_width(k8);
#define DESCO_KP(T, HP)                                              \
  switch (kp) {                                                      \
    case 32: return F::template run<T, HP, 32>(args...);             \
    case 64: return F::template run<T, HP, 64>(args...);             \
    default: return F::template run<T, HP, 128>(args...);            \
  }
#define DESCO_HP(T)                \
  switch (hp) {                    \
    case 32: DESCO_KP(T, 32)       \
    case 64: DESCO_KP(T, 64)       \
    default: DESCO_KP(T, 128)      \
  }
  if (dtype == kBf16) {
    DESCO_HP(__nv_bfloat16)
  } else {
    DESCO_HP(float)
  }
  return static_cast<int>(cudaErrorInvalidValue);  // not reached
#undef DESCO_HP
#undef DESCO_KP
}

struct Fwd {
  template <typename T, int HP, int KP, typename... A>
  static int run(A... a) { return launch_fwd<T, HP, KP>(a...); }
};
struct Bwd {
  template <typename T, int HP, int KP, typename... A>
  static int run(A... a) { return launch_bwd<T, HP, KP>(a...); }
};
struct BwdBlocks {
  template <typename T, int HP, int KP>
  static int run(int n_rows, int n_types) {
    int bytes = 0, w_res = 0, acc = 0, grid = 0, tc = 0, n_chunks = 0;
    const int rc = bwd_plan<T, HP, KP>(n_rows, n_types, &bytes, &w_res,
                                       &acc, &grid, &tc, &n_chunks);
    return rc != 0 ? -rc : grid;
  }
};
// The types per chunk of K2' (backward = 0) or K3' (backward = 1).
struct ChunkTypes {
  template <typename T, int HP, int KP>
  static int run(int n_types, int backward) {
    int bytes = 0, a = 0, b = 0, grid = 0, tc = 0, n_chunks = 0;
    const int rc = backward ? bwd_plan<T, HP, KP>(1, n_types, &bytes, &a,
                                                  &b, &grid, &tc, &n_chunks)
                            : fwd_plan<T, HP, KP>(n_types, &bytes, &a, &tc,
                                                  &n_chunks);
    return rc != 0 ? -rc : tc;
  }
};

bool known_dtype(int dtype) { return dtype == kF32 || dtype == kBf16; }

}  // namespace

extern "C" {

int desco_typed_aggregate_abi_version() { return 2; }

const char* desco_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K2': out [n_nodes, k] f32. x [n_rows, h8], W [n_types, h8, k8] in one
// dtype; src [E] i32 and toffs [n_nodes*n_types + 1] i32 (the offsets of
// the (dst, type) runs in the sorted edge stream).
int desco_typed_aggregate_fwd(const void* x, int dtype, int n_rows, int h8,
                              const int* src, const int* toffs, int n_nodes,
                              int n_types, const void* w, int k8, float* out,
                              int k, void* stream) {
  if (n_nodes <= 0 || k <= 0) return 0;
  if (!known_dtype(dtype) || !shape_ok(h8, k8, n_types) || n_rows <= 0 ||
      k > k8 || !aligned16(x) || !aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Fwd>(dtype, h8, k8, x, n_rows, h8, src, toffs, n_nodes,
                       n_types, w, k8, out, k,
                       static_cast<cudaStream_t>(stream));
}

// The grid (and so the number of dW partials) of K3' for these widths and
// rows on the current device; negative: minus a CUDA error code.
int desco_typed_aggregate_bwd_blocks(int dtype, int h8, int k8, int n_types,
                                     int n_rows) {
  if (!known_dtype(dtype) || !shape_ok(h8, k8, n_types) || n_rows <= 0)
    return -static_cast<int>(cudaErrorInvalidValue);
  return dispatch<BwdBlocks>(dtype, h8, k8, n_rows, n_types);
}

// The most types per chunk of K2' and K3' (0: as many as fit in shared
// memory, the default). Types are summed in the same order either way, so
// a cap changes no result, only the path that computes it.
void desco_typed_aggregate_set_chunk_cap(int cap) {
  g_chunk_cap = cap > 0 ? cap : 0;
}

// The types per chunk that K2' (backward = 0) or K3' (backward = 1) runs
// for these widths and T on the current device; negative: minus a CUDA
// error code (no chunking fits).
int desco_typed_aggregate_chunk_types(int dtype, int h8, int k8,
                                      int n_types, int backward) {
  if (!known_dtype(dtype) || !shape_ok(h8, k8, n_types))
    return -static_cast<int>(cudaErrorInvalidValue);
  return dispatch<ChunkTypes>(dtype, h8, k8, n_types, backward);
}

// K3': dx [n_rows, h] in the dtype of x, and the per-block dW partials
// [n_blocks, n_types, HP, KP] f32 (HP, KP: h8, k8 rounded up to 32, 64
// or 128). g [n_nodes, k8]; rows [E] i32 (the destination of each edge of
// the (src, type)-sorted stream); boffs [n_rows*n_types + 1] i32.
int desco_typed_aggregate_bwd(const void* g, int dtype, int n_nodes, int k8,
                              const int* rows, const int* boffs,
                              const void* x, int n_rows, int h8,
                              const void* w, int n_types, void* dx, int h,
                              float* partial, int n_blocks, void* stream) {
  if (!known_dtype(dtype) || !shape_ok(h8, k8, n_types) || n_rows <= 0 ||
      n_nodes <= 0 || h > h8 || !aligned16(g) || !aligned16(x) ||
      !aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Bwd>(dtype, h8, k8, g, n_nodes, k8, rows, boffs, x,
                       n_rows, h8, w, n_types, dx, h, partial, n_blocks,
                       static_cast<cudaStream_t>(stream));
}

// dW [n_types, h, k] in dtype (W's) from K3's partials.
int desco_typed_aggregate_dw_reduce(const float* partial, int n_blocks,
                                    int n_types, int hp, int kp, int h,
                                    int k, void* dw, int dtype,
                                    void* stream) {
  const long long total = static_cast<long long>(n_types) * h * k;
  if (total <= 0) return 0;
  if (!known_dtype(dtype) || n_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((total + 31) / 32));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBf16)
    dw_reduce_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        partial, n_blocks, n_types, hp, kp, h, k,
        static_cast<__nv_bfloat16*>(dw));
  else
    dw_reduce_kernel<float><<<grid, 256, 0, s>>>(
        partial, n_blocks, n_types, hp, kp, h, k, static_cast<float*>(dw));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
