// Fused Lloyd step on Hopper (sm_90a), IEEE fp32 distances.
//
// Replaces the TPU kernel src/repro/kernels/kmeans_assign.py
// (kmeans_assign_pallas / _assign_kernel): for points (m,d) and centers
// (k,d) it returns the nearest-center label of every row (int32, ties to
// the lowest index, d^2 = max(||p||^2 + ||c||^2 - 2 p.c, 0) as in the
// reference) plus the per-cluster sums (k,d) and counts (k,) of the rows.
//
// What bounds it on an H100: bytes.  At the Lloyd shape (m = 2^20, k = 8,
// d = 64) a call reads 268 MB of points and writes 4 MB of labels, about
// 81 us at 3.35 TB/s; the k*d FMAs per row are a few us of the fp32 rate.
// At a single route (m = 1) nothing bounds it but the launch.
//
// Two variants, one launch each; the wrapper picks by (m, k, d):
//   * assign_small_kernel (m <= 256 rows that fit in shared memory: the
//     routes).  One block: the rows and the centers staged in shared memory
//     by coalesced loads, one row per thread.  Labels, sums and counts are
//     written directly: no scratch.
//   * assign_stream_kernel (the Lloyd shape).  A persistent grid of at most
//     one block per SM.  Its producer thread streams the block's tiles of
//     up to 256 rows through a ring in shared memory by TMA
//     (row_stream.cuh); 8 distance warps take a row per thread against the
//     centers and their norms in shared memory (broadcast reads) and
//     publish the tile's label masks; 8 summing warps add the tile's rows
//     into the block's partial, then free the stage.  Mask buffers are
//     double-buffered behind mbarriers, so the sums of one tile overlap
//     the distances of the next and the loads of those after it.  With
//     one set of warps doing both in turn, the two phases ran in series
//     and took longer than a tile takes to load
//     (scripts/assign_ablation.py times each part).
// Sums without sorting: a warp's 32 rows publish one bit mask per label
// (__match_any_sync).  Each (label, 64 columns) item belongs to one
// summing warp for the whole call; its lanes walk the label's rows in the
// masks (item_sums), adding 16-byte chunks into doubles, then into the
// block's double partial (in shared memory when it fits, else in the
// block's slot of the scratch).  Counts are popcounts of the same masks.
// At the end every block writes its partial; the last block of each group
// of kGroup blocks to finish (an integer ticket after __threadfence) sums
// its group's partials in block order, and the last group to finish sums
// the groups in group order and rounds once to fp32.  No float atomics:
// the order of every addition is fixed by (m, k, d), the labels and the
// device's SM count, so a repeat run gives bit-identical sums.  The
// tickets return to 0 for the next call.
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_stream.cuh"

using namespace rowstream;

namespace {

constexpr int kSmallThreads = 256;
constexpr int kSmallRows = kSmallThreads;
constexpr int kGroup = 16;  // blocks whose partials one ticket gathers
// assign_stream_kernel: the producer warp, kConsumers distance threads (a
// row each) and kConsumerWarps summing warps
constexpr int kStreamThreads = 32 + 2 * kConsumers;
// the ring's full/empty mbarriers, the two mask buffers' full/empty, a flag
constexpr int kBarBytes = 16 * kMaxStages + 32 + 16;

// Dynamic shared memory of assign_stream_kernel (mirrored by
// kernels/kmeans_assign.py::_stream_bytes), from a 1024-byte aligned base:
// the ring, the mbarriers and a flag, centers, norms, two
// buffers of label masks, counts, and the double partial when smem_part;
// kAlign bytes more for aligning the base.
struct StreamLayout {
  size_t bars, cen, c2, masks, bcount, part, total;
};

__host__ __device__ inline StreamLayout stream_layout(int k, int d, int br, int stages,
                                                      bool smem_part) {
  StreamLayout L;
  size_t off = stages * stage_bytes(d, br);
  L.bars = off;
  off += kBarBytes;
  L.cen = off;
  off = up16(off + 4 * static_cast<size_t>(k) * d);
  L.c2 = off;
  off = up16(off + 4 * static_cast<size_t>(k));
  L.masks = off;
  off = up16(off + 4 * static_cast<size_t>(2) * ((br + 31) / 32) * k);
  L.bcount = off;
  off = up16(off + 4 * static_cast<size_t>(k));
  L.part = off;
  if (smem_part) off = up16(off + 8 * static_cast<size_t>(k) * d);
  L.total = off + kAlign;
  return L;
}

// Dynamic shared memory of assign_small_kernel (mirrored by
// kernels/kmeans_assign.py::_small_bytes): centers, norms, one buffer of
// label masks, then the m staged rows, padded_stride(d) floats apart.
__host__ __device__ inline size_t small_rows_offset(int k, int d) {
  return up16(4 * static_cast<size_t>(k) * d) + up16(4 * static_cast<size_t>(k)) +
         up16(4 * static_cast<size_t>(kSmallRows / 32) * k);
}

__host__ __device__ inline size_t small_bytes(int m, int k, int d) {
  return small_rows_offset(k, d) + 4 * static_cast<size_t>(m) * padded_stride(d);
}

// One item = (label c, 64 columns): lane l of the calling warp takes the
// 16-byte chunk q = 16 * cb + (l % 16) of the rows, its half h = l / 16
// the rows 128h .. 128h+127 as two runs of 64 (the label's bits in the
// masks, masks[g * k + c] for the ngr <= 8 groups of 32 rows).  Each run
// is walked in row order into its own doubles, the runs side by side
// (independent chains of shared-memory reads and adds); then the runs are
// added in run order and the two halves, lower plus upper.  The order of
// every addition is fixed by the labels alone.  rows.chunk(r, q) is the
// float4 of row r's chunk q, for rows up to `last`; lanes whose chunk is
// past the row pass q = 0 and drop the result.  Returns the item's four column sums in `total`
// (the same in both halves).
template <class Rows>
__device__ __forceinline__ void item_sums(const Rows& rows, const unsigned* masks, int ngr,
                                          int last, int k, int c, int q, int lane,
                                          double (&total)[4]) {
  const int h = lane >> 4;
  unsigned long long mk[2];
  double acc[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int g = 4 * h + 2 * s;
    const unsigned lo = g < ngr ? masks[g * k + c] : 0u;
    const unsigned hi = g + 1 < ngr ? masks[(g + 1) * k + c] : 0u;
    mk[s] = static_cast<unsigned long long>(hi) << 32 | lo;
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[s][u] = 0.0;
  }
  // branch-free steps: a run already walked reads a row of the tile (its
  // first, or the last if that is past the tile) and keeps its sums, so
  // both runs' reads are issued before either add
  while (mk[0] | mk[1]) {
    float4 x[2];
    bool live[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      live[s] = mk[s] != 0ull;
      const int b = live[s] ? __ffsll(mk[s]) - 1 : 0;
      mk[s] &= mk[s] - 1;
      const int r = 128 * h + 64 * s + b;
      x[s] = rows.chunk(r < last ? r : last, q);
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const double add[4] = {static_cast<double>(x[s].x), static_cast<double>(x[s].y),
                             static_cast<double>(x[s].z), static_cast<double>(x[s].w)};
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[s][u] = live[s] ? acc[s][u] + add[u] : acc[s][u];
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const double mine = acc[0][u] + acc[1][u];
    const double other = __shfl_xor_sync(0xffffffffu, mine, 16);
    total[u] = h == 0 ? mine + other : other + mine;
  }
}

// The calling warp's 32 rows publish their labels as one mask per label
// (masks[c] for the warp's group; label -1 = no row).
__device__ __forceinline__ void publish_masks(unsigned* group_masks, int k, int label,
                                              int lane) {
  for (int c = lane; c < k; c += 32) group_masks[c] = 0u;
  __syncwarp();
  const unsigned peers = __match_any_sync(0xffffffffu, label);
  if (label >= 0 && (peers & ((1u << lane) - 1u)) == 0u) group_masks[label] = peers;
}

template <bool kVec>
__global__ void __launch_bounds__(kSmallThreads)
assign_small_kernel(const float* __restrict__ points, const float* __restrict__ centers,
                    int* __restrict__ labels, float* __restrict__ sums,
                    float* __restrict__ counts, int m, int k, int d) {
  extern __shared__ __align__(16) char smem[];
  float* cen = reinterpret_cast<float*>(smem);
  float* c2 = reinterpret_cast<float*>(smem + up16(4 * static_cast<size_t>(k) * d));
  unsigned* masks = reinterpret_cast<unsigned*>(
      smem + up16(4 * static_cast<size_t>(k) * d) + up16(4 * static_cast<size_t>(k)));
  float* staged = reinterpret_cast<float*>(smem + small_rows_offset(k, d));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = padded_stride(d);
  const long kd = static_cast<long>(k) * d;
  // every load issued before the first use: one round trip to memory
  for (long i = tid; i < kd; i += kSmallThreads) cen[i] = centers[i];
  // padded columns read as zeros by the item sums
  for (long i = tid; i < static_cast<long>(m) * ld; i += kSmallThreads) {
    const long r = i / ld;
    const int j = static_cast<int>(i - r * ld);
    staged[i] = j < d ? points[r * d + j] : 0.f;
  }
  __syncthreads();
  center_norms(cen, c2, k, d, tid, kSmallThreads);
  __syncthreads();

  int label = -1;
  if (tid < m) {
    label = nearest<kVec>(PlainRow{staged + static_cast<long>(tid) * ld}, cen, c2, k, d);
    labels[tid] = label;
  }
  publish_masks(masks + warp * k, k, label, lane);
  __syncthreads();

  const int ngr = (m + 31) / 32, nq = (d + 3) / 4, ncb = (nq + 15) / 16;
  const PlainRows rows{staged, ld};
  for (int it = warp; it < k * ncb; it += kSmallThreads / 32) {
    const int c = it / ncb, q = (it % ncb) * 16 + (lane & 15);
    double total[4];
    item_sums(rows, masks, ngr, m - 1, k, c, q < nq ? q : 0, lane, total);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (lane < 16 && q < nq && 4 * q + u < d)
        sums[static_cast<long>(c) * d + 4 * q + u] = static_cast<float>(total[u]);
  }
  for (int c = tid; c < k; c += kSmallThreads) {
    int n = 0;
    for (int g = 0; g < ngr; ++g) n += __popc(masks[g * k + c]);
    counts[c] = static_cast<float>(n);
  }
}

// dscratch: (grid + ngroups) * k * d doubles (block partials, then group
// partials); iscratch: (grid + ngroups) * k ints; tickets: ngroups + 1
// zeros.  `rows` is the points' map (row_stream.cuh::encode_rows).
template <bool kSmemPart>
__global__ void __launch_bounds__(kStreamThreads, 1)
assign_stream_kernel(const __grid_constant__ CUtensorMap rows_map,
                     const float* __restrict__ centers, int* __restrict__ labels,
                     double* __restrict__ dscratch, int* __restrict__ iscratch,
                     unsigned* __restrict__ tickets, float* __restrict__ sums,
                     float* __restrict__ counts, long m, int k, int d, int br,
                     int stages) {
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = align_shared(smem_raw);
  const StreamLayout L = stream_layout(k, d, br, stages, kSmemPart);
  char* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kMaxStages;
  uint64_t* mask_full = empty + kMaxStages;   // distances -> sums, per buffer
  uint64_t* mask_empty = mask_full + 2;       // sums -> distances, per buffer
  int* flag = reinterpret_cast<int*>(mask_empty + 2);
  float* cen = reinterpret_cast<float*>(smem + L.cen);
  float* c2 = reinterpret_cast<float*>(smem + L.c2);
  unsigned* mask_bufs = reinterpret_cast<unsigned*>(smem + L.masks);
  int* bcount = reinterpret_cast<int*>(smem + L.bcount);
  const size_t box_bytes = static_cast<size_t>(br) * 128;
  const size_t tile_bytes = stage_bytes(d, br);

  const int tid = threadIdx.x;
  const long kd = static_cast<long>(k) * d;
  const int grid = gridDim.x;
  const int ngroups = (grid + kGroup - 1) / kGroup;
  double* part_sums = dscratch;
  double* group_sums = dscratch + grid * kd;
  int* part_counts = iscratch;
  int* group_counts = iscratch + static_cast<long>(grid) * k;
  double* part = kSmemPart ? reinterpret_cast<double*>(smem + L.part)
                           : part_sums + blockIdx.x * kd;

  for (long i = tid; i < kd; i += kStreamThreads) {
    cen[i] = centers[i];
    part[i] = 0.0;
  }
  for (int c = tid; c < k; c += kStreamThreads) bcount[c] = 0;
  if (tid == 0)
    for (int b = 0; b < 2; ++b) {
      mbar_init(&mask_full[b], kConsumerWarps);
      mbar_init(&mask_empty[b], kConsumerWarps);
    }
  init_ring(full, empty, stages);  // fences the inits, ends in __syncthreads

  // Tile i: the producer loads it into stage i % stages; the distance
  // warps label its rows and publish the label masks into buffer i % 2;
  // the summing warps add its rows into the partial, then free the stage
  // and the mask buffer.  So the sums of tile i overlap the distances of
  // tile i + 1 and the loads of the tiles after it.
  const int ngr_max = (br + 31) / 32, nq = d / 4, ncb = (nq + 15) / 16, items = k * ncb;
  const long ntiles = (m + br - 1) / br;
  if (tid < 32) {
    produce(&rows_map, m, d, br, stages, ring, full, empty);
  } else if (tid < 32 + kConsumers) {
    const int ct = tid - 32, cw = ct >> 5, lane = ct & 31;
    center_norms(cen, c2, k, d, ct, kConsumers);
    consumers_sync();
    int i = 0;
    for (long t = blockIdx.x; t < ntiles; t += grid, ++i) {
      const int s = i % stages, b = i & 1;
      const long row0 = t * br;
      const int nrows = static_cast<int>(m - row0 < br ? m - row0 : br);
      mbar_wait(&full[s], (i / stages) & 1);
      if (i >= 2) mbar_wait(&mask_empty[b], ((i >> 1) - 1) & 1);
      int label = -1;
      if (ct < nrows) {
        label = nearest<true>(SwizzledRow{ring + s * tile_bytes, ct, box_bytes}, cen, c2, k, d);
        labels[row0 + ct] = label;
      }
      if (cw < ngr_max) publish_masks(mask_bufs + (b * ngr_max + cw) * k, k, label, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(&mask_full[b]);
    }
  } else {
    const int at = tid - 32 - kConsumers, aw = at >> 5, lane = at & 31;
    int i = 0;
    for (long t = blockIdx.x; t < ntiles; t += grid, ++i) {
      const int s = i % stages, b = i & 1;
      const long row0 = t * br;
      const int nrows = static_cast<int>(m - row0 < br ? m - row0 : br);
      mbar_wait(&full[s], (i / stages) & 1);
      mbar_wait(&mask_full[b], (i >> 1) & 1);
      const unsigned* masks = mask_bufs + b * ngr_max * k;
      const int ngr = (nrows + 31) / 32;
      const SwizzledRows rows{ring + s * tile_bytes, box_bytes};
      for (int it = aw; it < items; it += kConsumerWarps) {
        const int c = it / ncb, q = (it % ncb) * 16 + (lane & 15);
        double total[4];
        item_sums(rows, masks, ngr, nrows - 1, k, c, q < nq ? q : 0, lane, total);
        if (lane < 16 && q < nq) {
#pragma unroll
          for (int u = 0; u < 4; ++u) part[static_cast<long>(c) * d + 4 * q + u] += total[u];
        }
      }
      for (int c = at; c < k; c += kConsumers) {
        int n = 0;
        for (int g = 0; g < ngr; ++g) n += __popc(masks[g * k + c]);
        bcount[c] += n;
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&empty[s]);
        mbar_arrive(&mask_empty[b]);
      }
    }
  }
  __syncthreads();

  // this block's partial into its slot, then the two-level reduction
  if (kSmemPart)
    for (long i = tid; i < kd; i += kStreamThreads) part_sums[blockIdx.x * kd + i] = part[i];
  for (int c = tid; c < k; c += kStreamThreads) part_counts[static_cast<long>(blockIdx.x) * k + c] = bcount[c];
  __threadfence();
  __syncthreads();
  const int g = blockIdx.x / kGroup;
  const int b0 = g * kGroup;
  const int gsize = grid - b0 < kGroup ? grid - b0 : kGroup;
  if (tid == 0) *flag = atomicAdd(&tickets[g], 1u) == static_cast<unsigned>(gsize - 1);
  __syncthreads();
  if (!*flag) return;
  for (long i = tid; i < kd; i += kStreamThreads) {
    double acc = 0.0;
    for (int b = b0; b < b0 + gsize; ++b) acc += __ldcg(&part_sums[b * kd + i]);
    group_sums[g * kd + i] = acc;
  }
  for (int c = tid; c < k; c += kStreamThreads) {
    int n = 0;
    for (int b = b0; b < b0 + gsize; ++b) n += __ldcg(&part_counts[static_cast<long>(b) * k + c]);
    group_counts[static_cast<long>(g) * k + c] = n;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    tickets[g] = 0u;
    *flag = atomicAdd(&tickets[ngroups], 1u) == static_cast<unsigned>(ngroups - 1);
  }
  __syncthreads();
  if (!*flag) return;
  for (long i = tid; i < kd; i += kStreamThreads) {
    double acc = 0.0;
    for (int q = 0; q < ngroups; ++q) acc += __ldcg(&group_sums[q * kd + i]);
    sums[i] = static_cast<float>(acc);
  }
  for (int c = tid; c < k; c += kStreamThreads) {
    long long n = 0;
    for (int q = 0; q < ngroups; ++q) n += __ldcg(&group_counts[static_cast<long>(q) * k + c]);
    counts[c] = static_cast<float>(n);
  }
  if (tid == 0) tickets[ngroups] = 0u;
}

}  // namespace

// m <= 256 rows: one block writes labels (m,), sums (k,d) and counts (k,).
// Returns a cudaError_t; cudaErrorInvalidValue when m is out of range.
extern "C" int kmeans_assign_small_f32(const void* points, const void* centers,
                                       void* labels, void* sums, void* counts, int m,
                                       int k, int d, void* stream) {
  if (m < 1 || m > kSmallRows || k < 1 || d < 1) return cudaErrorInvalidValue;
  const size_t bytes = small_bytes(m, k, d);
  auto s = static_cast<cudaStream_t>(stream);
  auto kernel = d % 4 == 0 ? assign_small_kernel<true> : assign_small_kernel<false>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<1, kSmallThreads, bytes, s>>>(
      static_cast<const float*>(points), static_cast<const float*>(centers),
      static_cast<int*>(labels), static_cast<float*>(sums), static_cast<float*>(counts),
      m, k, d);
  return cudaGetLastError();
}

// The streaming variant: br rows a tile (a multiple of 8, <= 256),
// `stages` tiles in flight (<= 4), the double partial in shared memory when
// smem_part, on `grid` blocks.  points (m,d) with d % 4 == 0, 16-byte
// aligned.  Scratch as assign_stream_kernel documents.
extern "C" int kmeans_assign_stream_f32(const void* points, const void* centers,
                                        void* labels, void* dscratch, void* iscratch,
                                        void* tickets, void* sums, void* counts,
                                        long long m, int k, int d, int br, int stages,
                                        int smem_part, int grid, void* stream) {
  if (m < 1 || k < 1 || d < 1 || d % 4 != 0 || br < 8 || br > kMaxRows || br % 8 != 0 ||
      stages < 1 || stages > kMaxStages || grid < 1 ||
      (reinterpret_cast<uintptr_t>(points) & 15u) != 0)
    return cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t err = encode_rows(&map, points, m, d, br);
  if (err != cudaSuccess) return err;
  const size_t bytes = stream_layout(k, d, br, stages, smem_part != 0).total;
  auto s = static_cast<cudaStream_t>(stream);
  auto kernel = smem_part ? assign_stream_kernel<true> : assign_stream_kernel<false>;
  err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kStreamThreads, bytes, s>>>(
      map, static_cast<const float*>(centers), static_cast<int*>(labels),
      static_cast<double*>(dscratch), static_cast<int*>(iscratch),
      static_cast<unsigned*>(tickets), static_cast<float*>(sums),
      static_cast<float*>(counts), static_cast<long>(m), k, d, br, stages);
  return cudaGetLastError();
}
