// K5: a probe of K1 (the sorted segment-sum) on Hopper, plain C interface.
//
// Replaces desco_tpu's analysis/segsum_inner_ablation.py:178, which times
// stripped variants of the Pallas kernel's inner loop down to its DMA
// floor (window search, one-hot build and MXU matmul removed in turn).
// The CUDA K1 has none of those parts. Its parts are the CSR offsets with
// their ragged per-segment loops, the convert-and-add chain in registers,
// and the row stream itself; the variants strip these in turn. Some are
// wrong as a segment-sum by design; each is a defined function of its
// inputs (tools/segsum_inner_ablation.py states it and holds a plain
// PyTorch version beside it):
//
//   full    the shipped K1 on bf16 rows: the same kernel instantiation as
//           desco_sorted_segment_sum, so bit-equal to it
//   nooffs  no offsets read and no ragged loop: warp w sums the fixed run
//           of rows [w*run, min((w+1)*run, n_rows))
//   noacc   nooffs with the bf16->f32 convert and the adds replaced by an
//           OR of the raw 16-bit patterns; out holds each OR-ed pattern
//           as a number (0..65535)
//   stream  the floor for these bytes: the whole stream read once with
//           grid-stride 16-byte loads OR-folded into a register (one
//           atomicOr per block into ``check`` keeps the loads alive), and
//           the output written as zeros
//
// This file includes segment_sum.cu, so the first three variants are
// instantiations of K1's own kernel template (segsum_rows_kernel<T, VEC,
// MODE, GATHER = false, LANES>) with K1's own load width,
// grid, layout and column split. It is built into a library
// of its own; the copies of K1-K4's C functions it carries are not used.

#include "segment_sum.cu"

namespace {

// 16-byte grid-stride loads, eight in flight per thread, OR-folded; the
// f32 output zeroed with 16-byte stores by the same grid. Each block
// folds its warps' words in shared memory and adds one atomicOr.
__global__ void __launch_bounds__(kThreads)
stream_fold_kernel(const uint4* __restrict__ in, long long n_vec,
                   float4* __restrict__ out, long long n_out_vec,
                   unsigned* __restrict__ check) {
  __shared__ unsigned warp_words[kWarpsPerBlock];
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = tid; i < n_out_vec; i += stride)
    out[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  unsigned f = 0u;
  long long i = tid;
  for (; i + 7 * stride < n_vec; i += 8 * stride) {
    uint4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __ldg(in + i + j * stride);
#pragma unroll
    for (int j = 0; j < 8; ++j) f |= v[j].x | v[j].y | v[j].z | v[j].w;
  }
  for (; i < n_vec; i += stride) {
    const uint4 a = __ldg(in + i);
    f |= a.x | a.y | a.z | a.w;
  }
  f = __reduce_or_sync(kFullMask, f);
  if ((threadIdx.x % kWarp) == 0) warp_words[threadIdx.x / kWarp] = f;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned b = 0u;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) b |= warp_words[w];
    if (b != 0u) atomicOr(check, b);
  }
}

int sm_count() {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess &&
        n > 0)
      cached = n;
    else
      cached = 132;
  }
  return cached;
}

}  // namespace

extern "C" {

int desco_probe_abi_version() { return 1; }

// mode 0 full, 1 nooffs, 2 noacc; msgs bf16 [n_rows, k]; out f32
// [n_segments, k]; ``offs`` is read by mode 0 only.
int desco_probe_segsum(void* msgs, const int* offs, int mode, int n_segments,
                       int k, int run, int n_rows, float* out, void* stream) {
  if (n_segments <= 0 || k <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = pick_vec(k, 2, msgs, out);
  const dim3 grid = segsum_grid(n_segments, k, vec);
  if (grid.x == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = lanes_per_row(k, vec);
  const int* no_rows = nullptr;
  switch (mode) {
    case kModeFull:
      dispatch<LaunchSegsumRows<kModeFull, false>>(
          kBf16, vec, grid, s, msgs, no_rows, offs, n_segments, k, lanes, 0,
          0, out);
      break;
    case kModeNoOffs:
      dispatch<LaunchSegsumRows<kModeNoOffs, false>>(
          kBf16, vec, grid, s, msgs, no_rows, offs, n_segments, k, lanes, run,
          n_rows, out);
      break;
    case kModeNoAcc:
      dispatch<LaunchSegsumRows<kModeNoAcc, false>>(
          kBf16, vec, grid, s, msgs, no_rows, offs, n_segments, k, lanes, run,
          n_rows, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The stream of n_bytes (a multiple of 16, 16-byte aligned) read once and
// OR-folded into check[0] (which the caller zeroes); out (n_out floats, a
// multiple of 4, 16-byte aligned) written as zeros.
int desco_probe_stream(const void* msgs, long long n_bytes, float* out,
                       long long n_out, unsigned* check, void* stream) {
  if (n_bytes % 16 != 0 || n_out % 4 != 0 || !aligned(msgs, 16) ||
      !aligned(out, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_vec = n_bytes / 16;
  const long long n_out_vec = n_out / 4;
  const long long work = n_vec > n_out_vec ? n_vec : n_out_vec;
  if (work <= 0) return 0;
  long long blocks = (work + kThreads - 1) / kThreads;
  // four blocks per SM: eight 16-byte loads a thread take 32 registers,
  // so more would not be resident together
  const long long resident = (long long)sm_count() * 4;
  if (blocks > resident) blocks = resident;
  stream_fold_kernel<<<dim3((unsigned)blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(msgs), n_vec, reinterpret_cast<float4*>(out),
      n_out_vec, check);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
