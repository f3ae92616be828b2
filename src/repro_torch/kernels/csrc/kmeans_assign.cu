// Fused Lloyd step on Hopper (sm_90a), IEEE fp32 distances.
//
// Replaces the TPU kernel src/repro/kernels/kmeans_assign.py
// (kmeans_assign_pallas / _assign_kernel): for points (m,d) and centers
// (k,d) it returns the nearest-center label of every row (int32, ties to
// the lowest index, d^2 = max(||p||^2 + ||c||^2 - 2 p.c, 0) as in the
// reference) plus the per-cluster sums (k,d) and counts (k,) of the rows.
//
// What bounds it on an H100: bytes.  At the main path's shape
// (m = 2^20, k = 8, d = 64) a call reads 268 MB of points and writes 4 MB
// of labels, so the floor is about 80 us at 3.35 TB/s; the k*d FMAs per
// row are a few us of the card's fp32 rate.  Every point is read from
// device memory exactly once.
//
// Design.  The TPU carries sums and counts across a sequential grid;
// Hopper blocks run in no order, so:
//   * pass 1 (assign_partial_kernel) runs a fixed grid of a few blocks per
//     SM.  Each block keeps the k centers (and their norms) in dynamic
//     shared memory, strides over tiles of up to 256 rows, stages a tile
//     in shared memory (coalesced cp.async), and gives each row to one thread for
//     its d^2 and argmin.  The tile's rows are then grouped by label
//     (__match_any_sync ranks within a warp, integer offsets across
//     warps) and one thread per column walks each label's rows in row
//     order, adding in double into the block's own (k,d) partial in
//     device memory.  Counts are integers.  No float atomics anywhere.
//   * pass 2 (reduce_partials_kernel) sums the per-block partials in
//     block order and rounds once to fp32.
// So two runs on one input give bit-identical sums, whatever order the
// blocks ran in.  Rows >= m are masked in the kernel (no padded copy).
// Shared memory holds k*d*4 bytes of centers plus a tile; the wrapper
// raises when even a one-row tile does not fit.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTileRows = kThreads;

struct Layout {
  float* cen;     // (k, d)
  float* c2;      // (k,)
  float* tile;    // (br, d | 1): an odd row stride keeps row-per-thread reads conflict-free
  int* perm;      // (br,) tile rows grouped by label, row order within a label
  int* wcount;    // (kWarps, k) rows of each label in each warp
  int* woff;      // (kWarps, k) offset of each warp within a label's group
  int* tstart;    // (k,) start of each label's group in perm
  int* tcount;    // (k,) rows of each label in the tile
  int* bcount;    // (k,) rows of each label over the block's tiles
};

__host__ __device__ inline size_t fixed_bytes(int k, int d) {
  return sizeof(float) * (static_cast<size_t>(k) * d + k) +
         sizeof(int) * (2 * static_cast<size_t>(kWarps) * k + 3 * static_cast<size_t>(k));
}

__host__ __device__ inline size_t row_bytes(int d) {
  return sizeof(float) * (d | 1) + sizeof(int);
}

__device__ inline Layout carve(char* base, int k, int d, int br) {
  Layout s;
  float* f = reinterpret_cast<float*>(base);
  s.cen = f;
  f += static_cast<size_t>(k) * d;
  s.c2 = f;
  f += k;
  s.tile = f;
  f += static_cast<size_t>(br) * (d | 1);
  int* i = reinterpret_cast<int*>(f);
  s.perm = i;
  i += br;
  s.wcount = i;
  i += kWarps * k;
  s.woff = i;
  i += kWarps * k;
  s.tstart = i;
  i += k;
  s.tcount = i;
  i += k;
  s.bcount = i;
  return s;
}

__global__ void __launch_bounds__(kThreads)
assign_partial_kernel(const float* __restrict__ points,
                      const float* __restrict__ centers,
                      int* __restrict__ labels,
                      double* __restrict__ part_sums,  // (gridDim.x, k, d)
                      int* __restrict__ part_counts,   // (gridDim.x, k)
                      long m, int k, int d, int br) {
  extern __shared__ __align__(16) char smem[];
  const Layout s = carve(smem, k, d, br);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ld = d | 1;
  const long kd = static_cast<long>(k) * d;
  double* my_sums = part_sums + blockIdx.x * kd;

  for (long i = tid; i < kd; i += kThreads) s.cen[i] = centers[i];
  __syncthreads();
  for (int c = tid; c < k; c += kThreads) {
    float acc = 0.f;
    for (int j = 0; j < d; ++j) acc = fmaf(s.cen[c * d + j], s.cen[c * d + j], acc);
    s.c2[c] = acc;
    s.bcount[c] = 0;
  }
  for (int j = tid; j < d; j += kThreads)
    for (int c = 0; c < k; ++c) my_sums[static_cast<long>(c) * d + j] = 0.0;
  __syncthreads();

  const long ntiles = (m + br - 1) / br;
  for (long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long row0 = t * br;
    const int nrows = static_cast<int>(m - row0 < br ? m - row0 : br);
    // one warp per row, lanes along the row (coalesced).  cp.async
    // copies straight into shared memory, so a thread issues all its
    // loads back to back instead of stalling on each one
    const float* src = points + row0 * d;
    for (int r = warp; r < nrows; r += kWarps)
      for (int j = lane; j < d; j += 32)
        __pipeline_memcpy_async(&s.tile[r * ld + j], &src[static_cast<long>(r) * d + j],
                                sizeof(float));
    __pipeline_commit();
    for (int i = tid; i < kWarps * k; i += kThreads) s.wcount[i] = 0;
    __pipeline_wait_prior(0);
    __syncthreads();

    int label = -1;
    if (tid < nrows) {
      const float* p = s.tile + static_cast<long>(tid) * ld;
      float p2 = 0.f;
      for (int j = 0; j < d; ++j) p2 = fmaf(p[j], p[j], p2);
      float best = CUDART_INF_F;
      label = 0;
      for (int c = 0; c < k; ++c) {
        const float* q = s.cen + static_cast<long>(c) * d;
        float dot = 0.f;
        for (int j = 0; j < d; ++j) dot = fmaf(p[j], q[j], dot);
        const float v = fmaxf((p2 + s.c2[c]) - 2.f * dot, 0.f);
        if (v < best) {  // strict: ties keep the lowest index
          best = v;
          label = c;
        }
      }
      labels[row0 + tid] = label;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, label);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (label >= 0 && rank == 0) s.wcount[warp * k + label] = __popc(peers);
    __syncthreads();

    for (int c = tid; c < k; c += kThreads) {
      int run = 0;
      for (int w = 0; w < kWarps; ++w) {
        s.woff[w * k + c] = run;
        run += s.wcount[w * k + c];
      }
      s.tcount[c] = run;
      s.bcount[c] += run;
    }
    __syncthreads();
    if (tid == 0) {
      int run = 0;
      for (int c = 0; c < k; ++c) {
        s.tstart[c] = run;
        run += s.tcount[c];
      }
    }
    __syncthreads();
    if (label >= 0) s.perm[s.tstart[label] + s.woff[warp * k + label] + rank] = tid;
    __syncthreads();

    for (int j = tid; j < d; j += kThreads) {
      for (int c = 0; c < k; ++c) {
        const int n = s.tcount[c];
        if (n == 0) continue;
        const int s0 = s.tstart[c];
        double acc = 0.0;
        for (int q = s0; q < s0 + n; ++q)
          acc += static_cast<double>(s.tile[s.perm[q] * ld + j]);
        my_sums[static_cast<long>(c) * d + j] += acc;
      }
    }
    __syncthreads();  // the next tile overwrites tile, perm and the warp tables
  }

  for (int c = tid; c < k; c += kThreads) part_counts[static_cast<long>(blockIdx.x) * k + c] = s.bcount[c];
}

__global__ void reduce_partials_kernel(const double* __restrict__ part_sums,
                                       const int* __restrict__ part_counts,
                                       float* __restrict__ sums,
                                       float* __restrict__ counts, int nparts,
                                       int k, int d) {
  const long kd = static_cast<long>(k) * d;
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < kd) {
    double acc = 0.0;
    for (int b = 0; b < nparts; ++b) acc += part_sums[b * kd + i];
    sums[i] = static_cast<float>(acc);
  }
  if (i < k) {
    long long n = 0;
    for (int b = 0; b < nparts; ++b) n += part_counts[static_cast<long>(b) * k + i];
    counts[i] = static_cast<float>(n);
  }
}

}  // namespace

// The launch plan for (k, d) on the current device: rows per tile, the
// dynamic shared memory it needs, and the most blocks worth launching
// (resident blocks per SM times SMs).  Returns a cudaError_t;
// cudaErrorInvalidValue when the centers leave no room for a tile.
extern "C" int kmeans_assign_plan(int k, int d, int* br, long long* smem_bytes,
                                  int* max_grid) {
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t fixed = fixed_bytes(k, d);
  if (fixed + row_bytes(d) > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  const size_t rows = (static_cast<size_t>(optin) - fixed) / row_bytes(d);
  *br = static_cast<int>(rows < kMaxTileRows ? rows : kMaxTileRows);
  *smem_bytes = static_cast<long long>(fixed + *br * row_bytes(d));
  err = cudaFuncSetAttribute(assign_partial_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(*smem_bytes));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, assign_partial_kernel, kThreads, static_cast<size_t>(*smem_bytes));
  if (err != cudaSuccess) return err;
  *max_grid = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

// points (m,d), centers (k,d) fp32; labels (m,) int32; part_sums
// (grid,k,d) float64 and part_counts (grid,k) int32 scratch; sums (k,d)
// and counts (k,) fp32.  br and smem_bytes come from kmeans_assign_plan.
extern "C" int kmeans_assign_f32(const void* points, const void* centers,
                                 void* labels, void* part_sums,
                                 void* part_counts, void* sums, void* counts,
                                 long long m, int k, int d, int br,
                                 long long smem_bytes, int grid, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      assign_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  assign_partial_kernel<<<grid, kThreads, static_cast<size_t>(smem_bytes), s>>>(
      static_cast<const float*>(points), static_cast<const float*>(centers),
      static_cast<int*>(labels), static_cast<double*>(part_sums),
      static_cast<int*>(part_counts), static_cast<long>(m), k, d, br);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long n = static_cast<long>(k) * d;
  const int rgrid = static_cast<int>((n + 255) / 256);
  reduce_partials_kernel<<<rgrid, 256, 0, s>>>(
      static_cast<const double*>(part_sums), static_cast<const int*>(part_counts),
      static_cast<float*>(sums), static_cast<float*>(counts), grid, k, d);
  return cudaGetLastError();
}
