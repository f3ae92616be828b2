// Pairwise squared Euclidean distances on Hopper (sm_90a), IEEE fp32.
//
// Replaces the TPU kernel src/repro/kernels/pairwise_l2.py
// (pairwise_sqdist_pallas / _pairwise_kernel): (m,d) x (k,d) -> (m,k),
// out = ||a||^2 + ||b||^2 - 2 a.b, clamped at >= 0.
//
// What bounds it on an H100: bytes.  At the main path's shape
// (m = 2^20 sketch rows, k = 8 centers, d = 64) a call reads 268 MB of a
// and writes 34 MB of output, about 4 flop per byte, so the floor is
// about 90 us at 3.35 TB/s while the fp32 FMA work is a few us.
//
// Design: one block computes a (kBM x kBK) output tile with 256 threads,
// each holding a 4x4 register micro-tile.  The TPU's sequential third
// grid axis (the d reduction) becomes a loop inside the block over d in
// chunks of BD, with the a- and b-chunks staged transposed in shared
// memory by cp.async.  ||a||^2, ||b||^2 and a.b are accumulated over the whole of d
// and combined once, with the same clamp as the reference, so near-zero
// distances clamp as there.  Ragged edges of m, k and d are masked in
// the kernel (zeros are staged), so no padded copy is ever made.  One
// tile shape, 256 x 16, sized for the kmeans++ seeding shape (k = 8);
// larger k takes more column tiles through grid.y.
// The batched entry point (a leading window axis: the LSH bucket windows
// of the approximate kNN fusion graph, (nb, B, d) x (nb, 3B, d)) runs the
// same kernel with one window per blockIdx.z, each offset by its batch
// stride; the 2-D entry point is the batch of one.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

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
