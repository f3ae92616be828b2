// Row streaming for Hopper (sm_90a): the loader and the row-distance loop
// shared by the streaming variants of kmeans_assign.cu and pairwise_l2.cu.
//
// A persistent block has one producer warp (warp 0) and consumer warps
// (kConsumers threads take a row each).  Tile t of `br` rows goes to block
// t % gridDim.x.  The producer keeps `stages` tiles in flight in a ring in
// shared memory: for each tile it announces the tile's bytes on the
// stage's `full` mbarrier and issues one TMA load (cp.async.bulk.tensor)
// per 32-column box of the tile (two 32 KB boxes for 256 rows of d = 64),
// so HBM streams while the consumers compute on an earlier stage.  The
// consumers release a stage by arriving on its `empty` mbarrier (one
// arrival per consumer warp).  A bulk copy per row (256 bytes) was
// tried first and measured far slower: the copy engine's cost per
// request, not the bytes, then set the time.
//
// The rows arrive 128-byte swizzled: box b holds columns 32b .. 32b+31
// of the tile's rows, one 128-byte line a row, and the 16-byte chunk q of
// row r sits at chunk position q ^ (r % 8).  A quarter-warp reading the
// same float4 of 8 consecutive rows (row per thread), or a warp reading
// 32 consecutive columns of one row, therefore touches every bank once.
// The TMA fills columns past d and rows past m with zeros.  It needs
// d % 4 == 0 and a 16-byte aligned base, which the wrappers guarantee.
#pragma once

#include <cuda.h>            // CUtensorMap and its enums; libcuda is not linked
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace rowstream {

constexpr int kConsumers = 256;               // one row per consumer thread
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;     // + the producer warp
constexpr int kMaxRows = kConsumers;          // rows per tile, at most
constexpr int kMaxStages = 4;
constexpr int kCB = 8;                        // centers per register block
constexpr int kBoxCols = 32;                  // one 128-byte line a row
constexpr int kAlign = 1024;                  // a 128-byte swizzle atom

// a staged plain row's stride in floats: d rounded up to whole 16-byte
// chunks, an odd number of them (conflict-free float4 reads, row per thread)
__host__ __device__ inline int padded_stride(int d) {
  const int chunks = (d + 3) / 4;
  return 4 * (chunks | 1);
}

__host__ __device__ inline size_t up16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

__host__ __device__ inline int boxes(int d) { return (d + kBoxCols - 1) / kBoxCols; }

// bytes of one stage of `br` rows (br a multiple of 8)
__host__ __device__ inline size_t stage_bytes(int d, int br) {
  return static_cast<size_t>(boxes(d)) * br * 128;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("{\n .reg .b64 state;\n"
               " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n"
               "}\n" :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 state;\n"
               " mbarrier.arrive.shared::cta.b64 state, [%0];\n"
               "}\n" :: "r"(smem_addr(bar)) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred ready;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 ready, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, ready;\n"
                 "}\n" : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                 : "memory");
  }
}

// one box of the 2-D map (columns, rows) at (col, row)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(col), "r"(row) : "memory");
}

// The first kAlign-aligned byte of dynamic shared memory, reached by an
// offset from the __shared__ array itself: a pointer rebuilt from an
// integer loses its address space, and every read through it becomes a
// generic load (measured slower for the distance and sum loops).
__device__ __forceinline__ char* align_shared(char* smem_raw) {
  const uint32_t mis = smem_addr(smem_raw) & (kAlign - 1);
  return smem_raw + ((kAlign - mis) & (kAlign - 1));
}

// the consumers' own barrier (id 1), so the producer never waits on it
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// Thread 0 initialises the ring's barriers; the whole block then syncs.
__device__ inline void init_ring(uint64_t* full, uint64_t* empty, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warp's loop (lane 0 issues): every tile of this block, in
// order.  `ring` is 1024-byte aligned.
__device__ inline void produce(const CUtensorMap* map, long m, int d, int br,
                               int stages, char* ring, uint64_t* full,
                               uint64_t* empty) {
  if ((threadIdx.x & 31) != 0) return;
  const long ntiles = (m + br - 1) / br;
  const int nbox = boxes(d);
  const size_t box_bytes = static_cast<size_t>(br) * 128;
  int i = 0;
  for (long t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
    const int s = i % stages;
    if (i >= stages) mbar_wait(&empty[s], ((i / stages) - 1) & 1);
    mbar_expect_tx(&full[s], static_cast<uint32_t>(nbox * box_bytes));
    char* dst = ring + s * nbox * box_bytes;
    for (int b = 0; b < nbox; ++b)
      tma_load(dst + b * box_bytes, map, &full[s], b * kBoxCols,
               static_cast<int>(t * br));
  }
}

// A staged row r of a swizzled tile (boxes `box_bytes` apart).
struct SwizzledRow {
  const char* tile;
  int r;
  size_t box_bytes;
  __device__ __forceinline__ const char* line(int q) const {
    return tile + (q >> 3) * box_bytes + r * 128;
  }
  __device__ __forceinline__ float4 chunk(int q) const {
    return *reinterpret_cast<const float4*>(line(q) + (((q & 7) ^ (r & 7)) << 4));
  }
};

// A row of plain floats (16-byte aligned where chunk() is used).
struct PlainRow {
  const float* p;
  __device__ __forceinline__ float4 chunk(int q) const {
    return reinterpret_cast<const float4*>(p)[q];
  }
  __device__ __forceinline__ float at(int j) const { return p[j]; }
};

// Row r's chunk q of a whole tile, swizzled (SwizzledRows) or plain rows
// ld floats apart (PlainRows, ld % 4 == 0, 16-byte aligned).
struct SwizzledRows {
  const char* tile;
  size_t box_bytes;
  __device__ __forceinline__ float4 chunk(int r, int q) const {
    return SwizzledRow{tile, r, box_bytes}.chunk(q);
  }
};

struct PlainRows {
  const float* base;
  int ld;
  __device__ __forceinline__ float4 chunk(int r, int q) const {
    return reinterpret_cast<const float4*>(base + static_cast<long>(r) * ld)[q];
  }
};

// A center slot of a register block: slots past k read center k - 1, so
// the block's loads and FMAs carry no branch (a branch around each
// center's load kept ptxas from hoisting the loads, and the latency of
// each shared-memory read was paid in series); their results are dropped.
__device__ __forceinline__ int center(int c, int k) { return c < k ? c : k - 1; }

// ||p||^2 and p.c for the centers c0 .. c0 + KB - 1 (those < k), each a
// sequential fmaf chain over j = 0 .. d-1: the same arithmetic in every
// variant, so a row gets the same distances wherever it is computed.
// kVec: d % 4 == 0 and the centers 16-byte aligned (float4 reads).
template <int KB, bool kVec, class Row>
__device__ __forceinline__ void row_dots(const Row& p, const float* cen, int c0,
                                         int k, int d, float (&dot)[KB],
                                         float& p2, bool want_p2) {
#pragma unroll
  for (int cc = 0; cc < KB; ++cc) dot[cc] = 0.f;
  if (want_p2) p2 = 0.f;
  if constexpr (kVec) {
#pragma unroll 2
    for (int q = 0; q < d / 4; ++q) {
      const float4 x = p.chunk(q);
      if (want_p2) {
        p2 = fmaf(x.x, x.x, p2);
        p2 = fmaf(x.y, x.y, p2);
        p2 = fmaf(x.z, x.z, p2);
        p2 = fmaf(x.w, x.w, p2);
      }
#pragma unroll
      for (int cc = 0; cc < KB; ++cc) {
        const float4 y =
            reinterpret_cast<const float4*>(cen + static_cast<long>(center(c0 + cc, k)) * d)[q];
        dot[cc] = fmaf(x.x, y.x, dot[cc]);
        dot[cc] = fmaf(x.y, y.y, dot[cc]);
        dot[cc] = fmaf(x.z, y.z, dot[cc]);
        dot[cc] = fmaf(x.w, y.w, dot[cc]);
      }
    }
  } else {
    for (int j = 0; j < d; ++j) {
      const float x = p.at(j);
      if (want_p2) p2 = fmaf(x, x, p2);
#pragma unroll
      for (int cc = 0; cc < KB; ++cc)
        dot[cc] = fmaf(x, cen[static_cast<long>(center(c0 + cc, k)) * d + j], dot[cc]);
    }
  }
}

// ||c||^2 of every center into c2, by threads tid of nthreads, each a
// sequential fmaf chain (unrolled, so the reads are issued ahead of it).
__device__ inline void center_norms(const float* cen, float* c2, int k, int d,
                                    int tid, int nthreads) {
  for (int c = tid; c < k; c += nthreads) {
    const float* row = cen + static_cast<long>(c) * d;
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < d; ++j) acc = fmaf(row[j], row[j], acc);
    c2[c] = acc;
  }
}

__device__ __forceinline__ float sqdist(float p2, float c2, float dot) {
  return fmaxf((p2 + c2) - 2.f * dot, 0.f);
}

// Nearest center of row p (ties to the lowest index).
template <bool kVec, class Row>
__device__ inline int nearest(const Row& p, const float* cen, const float* c2,
                              int k, int d) {
  float best = CUDART_INF_F, p2 = 0.f;
  int label = 0;
  for (int c0 = 0; c0 < k; c0 += kCB) {
    float dot[kCB];
    row_dots<kCB, kVec>(p, cen, c0, k, d, dot, p2, c0 == 0);
#pragma unroll
    for (int cc = 0; cc < kCB; ++cc) {
      if (c0 + cc < k) {
        const float v = sqdist(p2, c2[c0 + cc], dot[cc]);
        if (v < best) {  // strict: ties keep the lowest index
          best = v;
          label = c0 + cc;
        }
      }
    }
  }
  return label;
}

// ---------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the CUDA runtime so that
// the library links no libcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// Let `kernel` take `bytes` of dynamic shared memory (past the 48 KB a
// launch gets without asking).
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The map of fp32 rows (m, d) read as boxes of 32 columns x br rows,
// 128-byte swizzled, zero fill past the edges.  Returns a cudaError_t.
inline cudaError_t encode_rows(CUtensorMap* map, const void* ptr, long long m,
                               int d, int br) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(m)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 4};
  const cuuint32_t box[2] = {kBoxCols, static_cast<cuuint32_t>(br)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr),
                        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace rowstream
