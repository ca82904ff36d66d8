// Sorted segment-sum kernels for Hopper (sm_90a), plain C interface.
//
// K1 desco_sorted_segment_sum replaces desco_tpu's Pallas
//    pallas_sorted_segment_sum (desco_tpu/ops/pallas_segment.py:310).
// K2 desco_fused_typed_gather_segsum is the reduction of desco_tpu's
//    fused_typed_transform_aggregate -> _fused_legacy
//    (desco_tpu/ops/pallas_segment.py:476, :500), with the gather fused in.
//
// A sorted segment stream is CSR: the wrapper (ops/cuda_segment.py) finds
// the row offsets with one torch.searchsorted and hands them in. One warp
// owns one segment: its lanes stride the K feature columns with float2 or
// float4 loads, the edges of the segment are read in order, the sum stays
// in f32 registers and is written once. No atomics, no spill row, and the
// result does not depend on the launch (deterministic). Segment ids past
// the last offset (the padding keys) are never visited.
//
// K3 desco_gather_rows_segsum is the reduction of desco_tpu's _bwd_perm
//    (desco_tpu/ops/pallas_segment.py:559), the backward of K2: the edge
//    stream re-ordered by (src, type) is CSR over N*T source-keyed
//    segments, and the cotangent row g[dst] of each edge is gathered
//    inside the reduction, so the [E, K] tensor of gathered cotangents is
//    never written. Most of the N*T segments are empty and are still
//    written (as zeros): that write, not the gather from a cotangent
//    table that stays in L2, is what the card has to move.
// K4 desco_segment_sum_vjp_gather is the backward of K1, desco_tpu's
//    _ssum_ad_bwd (desco_tpu/ops/pallas_segment.py:464): d[e, :] =
//    g[seg[e], :] where 0 <= seg[e] < n_segments, else 0. One thread
//    copies one 16-byte piece of one row; bound by the [E, K] write.
//
// Every function launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr unsigned kFullMask = 0xffffffffu;

template <int VEC>
struct Row {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Row<VEC> load_row(const float* __restrict__ p);

template <>
__device__ __forceinline__ Row<1> load_row<1>(const float* __restrict__ p) {
  Row<1> r;
  r.v[0] = __ldg(p);
  return r;
}

template <>
__device__ __forceinline__ Row<2> load_row<2>(const float* __restrict__ p) {
  const float2 t = __ldg(reinterpret_cast<const float2*>(p));
  Row<2> r;
  r.v[0] = t.x;
  r.v[1] = t.y;
  return r;
}

template <>
__device__ __forceinline__ Row<4> load_row<4>(const float* __restrict__ p) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  Row<4> r;
  r.v[0] = t.x;
  r.v[1] = t.y;
  r.v[2] = t.z;
  r.v[3] = t.w;
  return r;
}

template <int VEC>
__device__ __forceinline__ void add_row(float (&acc)[VEC], const Row<VEC>& r) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] += r.v[i];
}

template <int VEC>
__device__ __forceinline__ void store_row(float* __restrict__ p,
                                          const float (&acc)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) p[i] = acc[i];
}

// K1: out[s, :] = sum of msgs[e, :] for e in [offs[s], offs[s+1]).
// The rows of one segment are contiguous, so each step of the warp reads
// one whole message row (K*4 bytes) in one coalesced request; four rows
// are in flight before the first add.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
segsum_rows_kernel(const float* __restrict__ msgs, const int* __restrict__ offs,
                   int n_segments, int k, float* __restrict__ out) {
  const int seg = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  const int lane = threadIdx.x % kWarp;
  if (seg >= n_segments) return;
  const int lo = offs[seg];
  const int hi = offs[seg + 1];
  for (int c0 = 0; c0 < k; c0 += kWarp * VEC) {
    const int c = c0 + lane * VEC;
    if (c >= k) break;  // no warp-wide operation below: lanes may leave
    const float* __restrict__ col = msgs + c;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    int e = lo;
    for (; e + 4 <= hi; e += 4) {
      const Row<VEC> r0 = load_row<VEC>(col + (int64_t)e * k);
      const Row<VEC> r1 = load_row<VEC>(col + (int64_t)(e + 1) * k);
      const Row<VEC> r2 = load_row<VEC>(col + (int64_t)(e + 2) * k);
      const Row<VEC> r3 = load_row<VEC>(col + (int64_t)(e + 3) * k);
      add_row(acc, r0);
      add_row(acc, r1);
      add_row(acc, r2);
      add_row(acc, r3);
    }
    for (; e < hi; ++e) add_row(acc, load_row<VEC>(col + (int64_t)e * k));
    store_row(out + (int64_t)seg * k + c, acc);
  }
}

// K2: out[d, :] = sum over e in [offs[d], offs[d+1]) of z[typ(e)*N + src(e), :]
// with typ(e) = keys[e] - d*T (= keys[e] mod T inside row d), clipped to
// [0, T) like the JAX gather's mode='clip'. The lanes first decode 32
// edges at once (coalesced key/src loads), then the warp walks them,
// taking each row index by shuffle, so the [E, K] message tensor of the
// unfused path is never written.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
fused_gather_segsum_kernel(const float* __restrict__ z,
                           const int* __restrict__ src,
                           const int* __restrict__ keys,
                           const int* __restrict__ offs, int n_nodes,
                           int n_rows, int n_types, int k,
                           float* __restrict__ out) {
  const int node = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  const int lane = threadIdx.x % kWarp;
  if (node >= n_nodes) return;  // uniform across the warp
  const int lo = offs[node];
  const int hi = offs[node + 1];
  const int key_base = node * n_types;
  // the column loop is warp-uniform: every lane takes part in every
  // shuffle, and only lanes with a column in range load and store
  for (int c0 = 0; c0 < k; c0 += kWarp * VEC) {
    const int c = c0 + lane * VEC;
    const bool active = c < k;
    const float* __restrict__ zc = z + (active ? c : 0);
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int base = lo; base < hi; base += kWarp) {
      const int e = base + lane;
      long long row = 0;
      if (e < hi) {
        int typ = keys[e] - key_base;
        typ = min(max(typ, 0), n_types - 1);
        const int s = min(max(src[e], 0), n_rows - 1);
        row = (long long)typ * n_rows + s;
      }
      const int cnt = min(kWarp, hi - base);
      int j = 0;
      for (; j + 4 <= cnt; j += 4) {
        const long long q0 = __shfl_sync(kFullMask, row, j);
        const long long q1 = __shfl_sync(kFullMask, row, j + 1);
        const long long q2 = __shfl_sync(kFullMask, row, j + 2);
        const long long q3 = __shfl_sync(kFullMask, row, j + 3);
        if (active) {
          const Row<VEC> r0 = load_row<VEC>(zc + q0 * k);
          const Row<VEC> r1 = load_row<VEC>(zc + q1 * k);
          const Row<VEC> r2 = load_row<VEC>(zc + q2 * k);
          const Row<VEC> r3 = load_row<VEC>(zc + q3 * k);
          add_row(acc, r0);
          add_row(acc, r1);
          add_row(acc, r2);
          add_row(acc, r3);
        }
      }
      for (; j < cnt; ++j) {
        const long long q = __shfl_sync(kFullMask, row, j);
        if (active) add_row(acc, load_row<VEC>(zc + q * k));
      }
    }
    if (active) store_row(out + (int64_t)node * k + c, acc);
  }
}

// K3: out[s, :] = sum over e in [offs[s], offs[s+1]) of table[rows[e], :],
// rows clipped to [0, n_rows). K2's walk with the row index read from an
// array instead of decoded from a key: the lanes load 32 row indices at
// once (coalesced), then the warp walks them by shuffle. An empty segment
// writes its zero row.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
gather_rows_segsum_kernel(const float* __restrict__ table,
                          const int* __restrict__ rows,
                          const int* __restrict__ offs, int n_segments,
                          int n_rows, int k, float* __restrict__ out) {
  const int seg = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  const int lane = threadIdx.x % kWarp;
  if (seg >= n_segments) return;  // uniform across the warp
  const int lo = offs[seg];
  const int hi = offs[seg + 1];
  for (int c0 = 0; c0 < k; c0 += kWarp * VEC) {
    const int c = c0 + lane * VEC;
    const bool active = c < k;
    const float* __restrict__ tc = table + (active ? c : 0);
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int base = lo; base < hi; base += kWarp) {
      const int e = base + lane;
      long long row = 0;
      if (e < hi) row = min(max(rows[e], 0), n_rows - 1);
      const int cnt = min(kWarp, hi - base);
      int j = 0;
      for (; j + 4 <= cnt; j += 4) {
        const long long q0 = __shfl_sync(kFullMask, row, j);
        const long long q1 = __shfl_sync(kFullMask, row, j + 1);
        const long long q2 = __shfl_sync(kFullMask, row, j + 2);
        const long long q3 = __shfl_sync(kFullMask, row, j + 3);
        if (active) {
          const Row<VEC> r0 = load_row<VEC>(tc + q0 * k);
          const Row<VEC> r1 = load_row<VEC>(tc + q1 * k);
          const Row<VEC> r2 = load_row<VEC>(tc + q2 * k);
          const Row<VEC> r3 = load_row<VEC>(tc + q3 * k);
          add_row(acc, r0);
          add_row(acc, r1);
          add_row(acc, r2);
          add_row(acc, r3);
        }
      }
      for (; j < cnt; ++j) {
        const long long q = __shfl_sync(kFullMask, row, j);
        if (active) add_row(acc, load_row<VEC>(tc + q * k));
      }
    }
    if (active) store_row(out + (int64_t)seg * k + c, acc);
  }
}

// One aligned 4-, 8- or 16-byte store of a row piece.
__device__ __forceinline__ void store_piece(float* __restrict__ p,
                                            const float (&a)[1]) {
  p[0] = a[0];
}
__device__ __forceinline__ void store_piece(float* __restrict__ p,
                                            const float (&a)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
}
__device__ __forceinline__ void store_piece(float* __restrict__ p,
                                            const float (&a)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}

// K4: out[e, c..c+VEC) = live(e) ? g[seg[e], c..c+VEC) : 0 with
// live(e) = 0 <= seg[e] < n_segments. Thread i owns piece i of the
// [E, K / VEC] grid of row pieces, so a warp writes consecutive bytes.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
segsum_vjp_gather_kernel(const float* __restrict__ g,
                         const int* __restrict__ seg, long long n_pieces,
                         int pieces_per_row, int n_segments, int k,
                         float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_pieces) return;
  const long long e = i / pieces_per_row;
  const int c = (int)(i - e * pieces_per_row) * VEC;
  const int s = seg[e];
  float acc[VEC];
  if (s >= 0 && s < n_segments) {
    const Row<VEC> r = load_row<VEC>(g + (int64_t)s * k + c);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = r.v[j];
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  }
  store_piece(out + e * k + c, acc);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// Lanes per row: float4 when a warp's 128 columns tile K, float2 for 64,
// else the widest vector K and the pointers allow.
int pick_vec(int k, const void* a, const void* b) {
  const bool a16 = aligned(a, 16) && aligned(b, 16);
  const bool a8 = aligned(a, 8) && aligned(b, 8);
  if (k % 128 == 0 && a16) return 4;
  if (k % 64 == 0 && a8) return 2;
  if (k % 4 == 0 && k > 64 && a16) return 4;
  if (k % 2 == 0 && k > 32 && a8) return 2;
  return 1;
}

}  // namespace

extern "C" {

int desco_segment_sum_abi_version() { return 2; }

const char* desco_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int desco_sorted_segment_sum(const float* msgs, const int* offs,
                             int n_segments, int k, float* out,
                             void* stream) {
  if (n_segments <= 0 || k <= 0) return 0;
  const dim3 grid((n_segments + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pick_vec(k, msgs, out)) {
    case 4:
      segsum_rows_kernel<4><<<grid, kThreads, 0, s>>>(msgs, offs, n_segments,
                                                      k, out);
      break;
    case 2:
      segsum_rows_kernel<2><<<grid, kThreads, 0, s>>>(msgs, offs, n_segments,
                                                      k, out);
      break;
    default:
      segsum_rows_kernel<1><<<grid, kThreads, 0, s>>>(msgs, offs, n_segments,
                                                      k, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int desco_fused_typed_gather_segsum(const float* z, const int* src,
                                    const int* keys, const int* offs,
                                    int n_nodes, int n_rows, int n_types,
                                    int k, float* out, void* stream) {
  if (n_nodes <= 0 || k <= 0) return 0;
  const dim3 grid((n_nodes + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pick_vec(k, z, out)) {
    case 4:
      fused_gather_segsum_kernel<4><<<grid, kThreads, 0, s>>>(
          z, src, keys, offs, n_nodes, n_rows, n_types, k, out);
      break;
    case 2:
      fused_gather_segsum_kernel<2><<<grid, kThreads, 0, s>>>(
          z, src, keys, offs, n_nodes, n_rows, n_types, k, out);
      break;
    default:
      fused_gather_segsum_kernel<1><<<grid, kThreads, 0, s>>>(
          z, src, keys, offs, n_nodes, n_rows, n_types, k, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int desco_gather_rows_segsum(const float* table, const int* rows,
                             const int* offs, int n_segments, int n_rows,
                             int k, float* out, void* stream) {
  if (n_segments <= 0 || k <= 0 || n_rows <= 0) return 0;
  const dim3 grid((n_segments + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pick_vec(k, table, out)) {
    case 4:
      gather_rows_segsum_kernel<4><<<grid, kThreads, 0, s>>>(
          table, rows, offs, n_segments, n_rows, k, out);
      break;
    case 2:
      gather_rows_segsum_kernel<2><<<grid, kThreads, 0, s>>>(
          table, rows, offs, n_segments, n_rows, k, out);
      break;
    default:
      gather_rows_segsum_kernel<1><<<grid, kThreads, 0, s>>>(
          table, rows, offs, n_segments, n_rows, k, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int desco_segment_sum_vjp_gather(const float* g, const int* seg, int n_edges,
                                 int n_segments, int k, float* out,
                                 void* stream) {
  if (n_edges <= 0 || k <= 0) return 0;
  // the widest piece that divides K and that both pointers are aligned to
  int vec = 1;
  if (k % 4 == 0 && aligned(g, 16) && aligned(out, 16)) vec = 4;
  else if (k % 2 == 0 && aligned(g, 8) && aligned(out, 8)) vec = 2;
  const int ppr = k / vec;
  const long long n_pieces = (long long)n_edges * ppr;
  const long long blocks = (n_pieces + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4:
      segsum_vjp_gather_kernel<4><<<grid, kThreads, 0, s>>>(
          g, seg, n_pieces, ppr, n_segments, k, out);
      break;
    case 2:
      segsum_vjp_gather_kernel<2><<<grid, kThreads, 0, s>>>(
          g, seg, n_pieces, ppr, n_segments, k, out);
      break;
    default:
      segsum_vjp_gather_kernel<1><<<grid, kThreads, 0, s>>>(
          g, seg, n_pieces, ppr, n_segments, k, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
