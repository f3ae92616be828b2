// Pairwise squared Euclidean distances on Hopper (sm_90a), IEEE fp32.
//
// Replaces the TPU kernel src/repro/kernels/pairwise_l2.py
// (pairwise_sqdist_pallas / _pairwise_kernel): (m,d) x (k,d) -> (m,k),
// out = ||a||^2 + ||b||^2 - 2 a.b, clamped at >= 0.
//
// What bounds it on an H100: bytes.  At the kmeans++ shape (m = 2^20
// sketch rows, k = 8 centers, d = 64) a call reads 268 MB of a and writes
// 34 MB of output, about 4 flop per byte, so the floor is about 90 us at
// 3.35 TB/s while the fp32 FMA work is a few us.
//
// Two kernels; the wrapper picks by (k, d):
//   * pairwise_stream_kernel (k <= 16, d % 4 == 0: kmeans++ seeding).  The
//     loader of row_stream.cuh: a persistent grid of at most one block per
//     SM, one producer thread loading tiles of rows by TMA into a ring in
//     shared memory (mbarriers), the k centers and their norms in shared
//     memory, one row per consumer thread, its k distances written as
//     float4s (k % 4 == 0) or scalars.  Every distance is a sequential
//     fmaf chain over d, as in kmeans_assign.
//   * pairwise_sqdist_kernel (large k: the kNN tiles, the fusion tests,
//     and every batch of windows).  One block computes a (kBM x kBK)
//     output tile with 256 threads, each holding a 4x4 register
//     micro-tile.  The TPU's sequential third grid axis (the d reduction)
//     becomes a loop inside the block over d in chunks of BD, with the a-
//     and b-chunks staged transposed in shared memory by cp.async.
//     ||a||^2, ||b||^2 and a.b are accumulated over the whole of d and
//     combined once, with the same clamp as the reference, so near-zero
//     distances clamp as there.  Ragged edges of m, k and d are masked in
//     the kernel (zeros are staged), so no padded copy is ever made.
//     Larger k takes more column tiles through grid.y.  The batched entry
//     point (a leading window axis: the LSH bucket windows of the
//     approximate kNN fusion graph, (nb, B, d) x (nb, 3B, d)) runs it with
//     one window per blockIdx.z, each offset by its batch stride.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_stream.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 256;
constexpr int kBK = 16;
constexpr int kBD = 16;
constexpr int kTM = 4;
constexpr int kTN = 4;

__global__ void __launch_bounds__(kThreads)
pairwise_sqdist_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ out, int m, int k, int d,
                       long long sa, long long sb, long long so) {
  static_assert((kBM / kTM) * (kBK / kTN) == kThreads, "tile / thread mismatch");
  constexpr int kRowThreads = kBM / kTM;   // threads along m
  constexpr int kColThreads = kBK / kTN;   // threads along k
  __shared__ float as[kBD][kBM + 1];   // +1: the transposed store is conflict-free
  __shared__ float bs[kBD][kBK + 1];

  a += blockIdx.z * sa;
  b += blockIdx.z * sb;
  out += blockIdx.z * so;
  const int tid = threadIdx.x;
  const int tx = tid % kColThreads;
  const int ty = tid / kColThreads;
  const long row0 = static_cast<long>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBK;

  float ab[kTM][kTN];
  float a2[kTM];
  float b2[kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    a2[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kTN; ++j) ab[i][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kTN; ++j) b2[j] = 0.f;

  for (int d0 = 0; d0 < d; d0 += kBD) {
    // cp.async copies straight into shared memory, so a thread issues
    // all its loads back to back instead of stalling on each one
    for (int idx = tid; idx < kBM * kBD; idx += kThreads) {
      const int r = idx / kBD, c = idx % kBD;
      const long gr = row0 + r;
      const int gc = d0 + c;
      if (gr < m && gc < d)
        __pipeline_memcpy_async(&as[c][r], &a[gr * d + gc], sizeof(float));
      else
        as[c][r] = 0.f;
    }
    for (int idx = tid; idx < kBK * kBD; idx += kThreads) {
      const int r = idx / kBD, c = idx % kBD;
      const int gr = col0 + r;
      const int gc = d0 + c;
      if (gr < k && gc < d)
        __pipeline_memcpy_async(&bs[c][r], &b[static_cast<long>(gr) * d + gc], sizeof(float));
      else
        bs[c][r] = 0.f;
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
#pragma unroll
    for (int dd = 0; dd < kBD; ++dd) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = as[dd][ty + i * kRowThreads];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = bs[dd][tx + j * kColThreads];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a2[i] = fmaf(av[i], av[i], a2[i]);
#pragma unroll
      for (int j = 0; j < kTN; ++j) b2[j] = fmaf(bv[j], bv[j], b2[j]);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) ab[i][j] = fmaf(av[i], bv[j], ab[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long gr = row0 + ty + i * kRowThreads;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gc = col0 + tx + j * kColThreads;
      if (gc >= k) continue;
      const float v = (a2[i] + b2[j]) - 2.f * ab[i][j];
      out[gr * k + gc] = fmaxf(v, 0.f);
    }
  }
}


// Dynamic shared memory of pairwise_stream_kernel (mirrored by
// kernels/pairwise_l2.py::_stream_bytes), from a 1024-byte aligned base:
// the ring, the mbarriers, the centers and their norms; kAlign bytes more
// for aligning the base.
__host__ __device__ inline size_t stream_bars_offset(int d, int br, int stages) {
  return stages * rowstream::stage_bytes(d, br);
}

__host__ __device__ inline size_t stream_bytes(int k, int d, int br, int stages) {
  const size_t cen = stream_bars_offset(d, br, stages) + 16 * rowstream::kMaxStages + 16;
  return rowstream::up16(cen + 4 * static_cast<size_t>(k) * d) +
         rowstream::up16(4 * static_cast<size_t>(k)) + rowstream::kAlign;
}

// KB >= k centers in registers; kVecOut: k % 4 == 0 (float4 stores).
template <int KB, bool kVecOut>
__global__ void __launch_bounds__(rowstream::kThreads, 1)
pairwise_stream_kernel(const __grid_constant__ CUtensorMap rows_map,
                       const float* __restrict__ b, float* __restrict__ out, long m,
                       int k, int d, int br, int stages) {
  using namespace rowstream;
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = align_shared(smem_raw);
  char* ring = smem;
  const size_t bars = stream_bars_offset(d, br, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + bars);
  uint64_t* empty = full + kMaxStages;
  float* cen = reinterpret_cast<float*>(smem + bars + 16 * kMaxStages + 16);
  float* c2 = reinterpret_cast<float*>(
      smem + up16(bars + 16 * kMaxStages + 16 + 4 * static_cast<size_t>(k) * d));
  const size_t box_bytes = static_cast<size_t>(br) * 128;
  const size_t tile_bytes = stage_bytes(d, br);
  const int tid = threadIdx.x;
  const long kd = static_cast<long>(k) * d;
  for (long i = tid; i < kd; i += rowstream::kThreads) cen[i] = b[i];
  init_ring(full, empty, stages);  // ends in __syncthreads

  if (tid < 32) {
    produce(&rows_map, m, d, br, stages, ring, full, empty);
    return;
  }
  const int ct = tid - 32, lane = ct & 31;
  center_norms(cen, c2, k, d, ct, kConsumers);
  consumers_sync();
  const long ntiles = (m + br - 1) / br;
  int i = 0;
  for (long t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
    const int s = i % stages;
    const long row0 = t * br;
    const int nrows = static_cast<int>(m - row0 < br ? m - row0 : br);
    mbar_wait(&full[s], (i / stages) & 1);
    if (ct < nrows) {
      float dot[KB], p2 = 0.f;
      row_dots<KB, true>(SwizzledRow{ring + s * tile_bytes, ct, box_bytes}, cen, 0, k, d,
                         dot, p2, true);
      float v[KB];
#pragma unroll
      for (int cc = 0; cc < KB; ++cc) v[cc] = cc < k ? sqdist(p2, c2[cc], dot[cc]) : 0.f;
      float* o = out + (row0 + ct) * k;
      if constexpr (kVecOut) {
#pragma unroll
        for (int q = 0; q < KB / 4; ++q)
          if (4 * q < k)
            reinterpret_cast<float4*>(o)[q] =
                make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      } else {
#pragma unroll
        for (int cc = 0; cc < KB; ++cc)
          if (cc < k) o[cc] = v[cc];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

template <int KB>
cudaError_t launch_stream(const CUtensorMap& map, const float* b, float* out, long m,
                          int k, int d, int br, int stages, int grid, cudaStream_t s) {
  const size_t bytes = stream_bytes(k, d, br, stages);
  const bool vec_out = k % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
  auto kernel = vec_out ? pairwise_stream_kernel<KB, true> : pairwise_stream_kernel<KB, false>;
  const cudaError_t err = rowstream::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, rowstream::kThreads, bytes, s>>>(map, b, out, m, k, d, br, stages);
  return cudaGetLastError();
}

}  // namespace

// a (m,d), b (k,d), out (m,k): contiguous fp32 device pointers.
// Returns the launch's cudaError_t (0 on success).
extern "C" int pairwise_sqdist_f32(const void* a, const void* b, void* out,
                                   int m, int k, int d, void* stream) {
  if (m <= 0 || k <= 0) return 0;
  const auto* pa = static_cast<const float*>(a);
  const auto* pb = static_cast<const float*>(b);
  auto* po = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if ((k + kBK - 1) / kBK > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kBM - 1) / kBM, (k + kBK - 1) / kBK);
  pairwise_sqdist_kernel<<<grid, kThreads, 0, s>>>(pa, pb, po, m, k, d, 0, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

// a (nb,m,d), b (nb,k,d), out (nb,m,k): contiguous fp32 device pointers,
// at most 65535 windows (grid.z).  Returns the launch's cudaError_t.
extern "C" int pairwise_sqdist_batched_f32(const void* a, const void* b,
                                           void* out, int nb, int m, int k,
                                           int d, void* stream) {
  if (nb <= 0 || m <= 0 || k <= 0) return 0;
  if (nb > 65535 || (k + kBK - 1) / kBK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* pa = static_cast<const float*>(a);
  const auto* pb = static_cast<const float*>(b);
  auto* po = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((m + kBM - 1) / kBM, (k + kBK - 1) / kBK, nb);
  pairwise_sqdist_kernel<<<grid, kThreads, 0, s>>>(
      pa, pb, po, m, k, d, static_cast<long long>(m) * d,
      static_cast<long long>(k) * d, static_cast<long long>(m) * k);
  return static_cast<int>(cudaGetLastError());
}

// The streaming variant: a (m,d) with d % 4 == 0 and a 16-byte aligned,
// b (k,d) with k <= 16, out (m,k); br rows a tile (a multiple of 8,
// <= 256), `stages` tiles in flight (<= 4), on `grid` blocks.  Returns the
// launch's cudaError_t.
extern "C" int pairwise_sqdist_stream_f32(const void* a, const void* b, void* out,
                                          long long m, int k, int d, int br, int stages,
                                          int grid, void* stream) {
  if (m < 1 || k < 1 || k > 16 || d < 1 || d % 4 != 0 || br < 8 || br % 8 != 0 ||
      br > rowstream::kMaxRows || stages < 1 || stages > rowstream::kMaxStages ||
      grid < 1 || (reinterpret_cast<uintptr_t>(a) & 15u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const cudaError_t err = rowstream::encode_rows(&map, a, m, d, br);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* pb = static_cast<const float*>(b);
  auto* po = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const long mm = static_cast<long>(m);
  if (k <= 4) return static_cast<int>(launch_stream<4>(map, pb, po, mm, k, d, br, stages, grid, s));
  if (k <= 8) return static_cast<int>(launch_stream<8>(map, pb, po, mm, k, d, br, stages, grid, s));
  return static_cast<int>(launch_stream<16>(map, pb, po, mm, k, d, br, stages, grid, s));
}
