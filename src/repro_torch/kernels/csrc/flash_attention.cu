// Block (flash) attention with an online softmax on Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:75,
// flash_attention_pallas (_flash_kernel).  q (b,h,sq,dh), k/v
// (b,hkv,skv,dh) -> o (b,h,sq,dh):
//     s = (q . k) * (1 / sqrt(dh)), query position i + (skv - sq),
//     live keys: kpos < skv, causal kpos <= qpos, window kpos > qpos - window,
//     online softmax with fp32 statistics (m, l) and fp32 accumulation of
//     both products, o = acc / max(l, 1e-30) in q's type.
// A row with no live key comes out as zeros, as in the Pallas kernel.
// GQA reads key/value head h / (h / hkv) in place (the TPU wrapper repeats
// the heads); tiles wholly above the causal diagonal or below the window
// are never visited, and the heaviest query tiles are launched first.
//
// Two kernels, picked by the inputs' type (flash_attention_fwd's dtype):
//
// bfloat16: flash_attention_tc, on the tensor cores.  What bounds it on an
// H100: operations.  At the serving shape (4, 14, 8192, 64) x
// (4, 2, 8192, 64) with a causal window of 4096 the work is 4 dh flop for
// each of 1.41e9 live (q, k) pairs (361 GFLOP: 0.365 ms at the bf16 tensor
// cores' 989 TFLOP/s; the split below makes it 0.55 ms of products) and
// one exponential per pair (1.41e9 at 16 a clock on each of 132 SMs:
// ~0.36 ms), against 134 MB of q, k, v and o (0.04 ms).  The softmax's
// other instructions (max, scale, sum, split: ~7 a pair) are as many again
// on the CUDA cores.  Design:
// * A block of 384 threads owns 128 query rows of one (batch, head):
//   warpgroups 0 and 1 compute 64 rows each, warpgroup 2 loads (one
//   thread issues TMA; `setmaxnreg` moves registers from it to the two
//   others, 40 and 232 a thread).  The two computing warpgroups overlap
//   one's softmax with the other's products as the scheduler finds them.
// * Q arrives once by TMA; K and V tiles of BK keys (128 at dh <= 64, 64
//   above) arrive by TMA into a ring of three stages (two at dh > 192)
//   guarded by mbarriers (full: bytes landed; empty: all 256 consumer
//   threads are done).  The tensor maps are 4-D over (dh, seq, head,
//   batch) with the caller's strides, so the model's transposed views need
//   no copy; head_dim is cut into 64-column chunks of 128-byte rows in the
//   128-byte swizzle that the wgmma descriptors name.  TMA zero-fills rows
//   past sq and skv and columns past dh; the mask still applies kpos < skv.
// * S = Q K^T: wgmma m64nBKk16, bf16 A and B from shared memory (both
//   K-major), fp32 accumulators in registers.  bf16 products are exact in
//   fp32, so this is the reference's fp32 product up to summation order.
// * The online softmax runs on the accumulator fragment: row maxima by
//   quad shuffles, exp2 of logits scaled by log2(e) / sqrt(dh), per-thread
//   partial row sums reduced across the quad once, at the end; only tiles
//   that cross the mask's edge for a warpgroup evaluate the mask, and a
//   tile with no live key for it is skipped.
// * O += P V with P from registers as wgmma's A operand (the accumulator
//   layout of S is the A-fragment layout of P), V MN-major from shared
//   memory, m64n64k16 per 64 head-dim columns.  The reference multiplies
//   the fp32 P: P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi)
//   (|P - P_hi - P_lo| <= 2^-16 P) and both are multiplied by the bf16 V,
//   so P V keeps fp32's accuracy at the cost of a third MMA per tile.  No
//   P tile goes through shared memory.
// * head_dim up to 256 in multiples of 16 (the wrapper pads others, and
//   operands TMA cannot address, into a zero-padded copy).
// scripts/flash_ablation.py times the kernel with each of these parts
// taken out.
//
// float32: flash_attention_kernel, on the CUDA cores (67 TFLOP/s: 5.4 ms at
// best at the serving shape).  One block of 256 threads owns a tile of
// kBQ = 64 query rows of one (batch, head) and walks the key tiles of
// kBK = 64 that hold a live key for one of its rows; the ragged edge is
// masked and zero-filled in shared memory.  A thread holds the logits of
// rows ty*4 + i and columns tx + 16 j (i, j < 4; tx = thread % 16,
// ty = thread / 16), and the output of rows ty*4 + i and head-dim columns
// tx + 16 c (c < DPT, head_dim padded to 16 DPT).  Row maxima and sums
// reduce over the 16 lanes of a row with xor shuffles.  Q and K tiles are
// read as float4 along head_dim (row stride DP + 4 floats, so 8
// consecutive rows fall in distinct banks); P goes through shared memory
// for the second product.
//
// Both take every sum in a fixed order and use no atomics, so a repeat
// run is bit-identical.
#include <cstdint>
#include <cuda.h>            // CUtensorMap and its enums; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;      // the Pallas kernel's NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs0, qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2, os0, os1, os2;
  int h, rep, sq, skv, dh, causal, window;   // window < 0: none
  float scale;
};

// launches of each kernel since the library was loaded: tensor core, CUDA
// core (read by flash_attention_kernel_launches)
long long g_launches[2] = {0, 0};

// ------------------------------------------------ fp32 on the CUDA cores

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kLDP = kBK + 4;          // row stride of the P tile (floats)

template <int DPT>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBQ + 2 * kBK) * (16 * DPT + 4) + kBQ * kLDP);
}

template <int DPT>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  constexpr int DP = 16 * DPT;         // head_dim padded to the layout
  constexpr int LD = DP + 4;           // row stride of Q, K, V tiles
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;                     // [kBK][LD]
  float* Vs = Ks + kBK * LD;                     // [kBK][LD]
  float* Ps = Vs + kBK * LD;                     // [kBQ][kLDP]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  // the last query tiles see the most keys under a causal mask: start them
  // first so the short ones fill the tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hh = bh % p.h;
  const int g = hh / p.rep;
  const float* q = static_cast<const float*>(p.q) + b * p.qs0 + hh * p.qs1;
  const float* k = static_cast<const float*>(p.k) + b * p.ks0 + g * p.ks1;
  const float* v = static_cast<const float*>(p.v) + b * p.vs0 + g * p.vs1;
  float* o = static_cast<float*>(p.o) + b * p.os0 + hh * p.os1;
  const int off = p.skv - p.sq;

  for (int e = threadIdx.x; e < kBQ * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    float x = 0.f;
    if (q0 + r < p.sq && c < p.dh) {
      x = q[static_cast<long long>(q0 + r) * p.qs2 + c];
    }
    Qs[r * LD + c] = x;
  }

  // keys that are live for some row of this tile: [k_lo, k_hi)
  const int qmin = q0 + off;
  const int qmax = min(q0 + kBQ, p.sq) - 1 + off;
  int k_hi = p.skv;
  if (p.causal) k_hi = min(k_hi, qmax + 1);
  int k_lo = 0;
  if (p.window >= 0) k_lo = max(0, qmin - p.window + 1);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }
  const int dh4 = (p.dh + 3) & ~3;

  for (int kt = (k_lo / kBK) * kBK; kt < k_hi; kt += kBK) {
    __syncthreads();   // the last tile's readers are done with Ks, Vs, Ps
    for (int e = threadIdx.x; e < kBK * DP; e += kThreads) {
      const int r = e / DP, c = e % DP;
      float kx = 0.f, vx = 0.f;
      if (kt + r < p.skv && c < p.dh) {
        kx = k[static_cast<long long>(kt + r) * p.ks2 + c];
        vx = v[static_cast<long long>(kt + r) * p.vs2 + c];
      }
      Ks[r * LD + c] = kx;
      Vs[r * LD + c] = vx;
    }
    __syncthreads();

    // s = q . k over head_dim, in order
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < dh4; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + off;
      bool live[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kt + tx + 16 * j;
        bool ok = kpos < p.skv;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window >= 0) ok = ok && kpos > qpos - p.window;
        live[j] = ok;
        s[i][j] = ok ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = live[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += pj;
        Ps[(ty * 4 + i) * kLDP + tx + 16 * j] = pj;
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V, over the tile's keys in order
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            &Ps[(ty * 4 + i) * kLDP + kk]);
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + 16 * c;
        const float v0 = Vs[(kk + 0) * LD + col];
        const float v1 = Vs[(kk + 1) * LD + col];
        const float v2 = Vs[(kk + 2) * LD + col];
        const float v3 = Vs[(kk + 3) * LD + col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c] = fmaf(pv[i].x, v0, acc[i][c]);
          acc[i][c] = fmaf(pv[i].y, v1, acc[i][c]);
          acc[i][c] = fmaf(pv[i].z, v2, acc[i][c]);
          acc[i][c] = fmaf(pv[i].w, v3, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= p.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = tx + 16 * c;
      if (col < p.dh) {
        o[static_cast<long long>(r) * p.os2 + col] = acc[i][c] / den;
      }
    }
  }
}

template <int DPT>
cudaError_t launch_f32(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DPT>();
  static bool configured = false;      // one attribute call per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<DPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((p.sq + kBQ - 1) / kBQ, batch * p.h);
  flash_attention_kernel<DPT><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_f32_dh(const Params& p, int batch, cudaStream_t stream) {
  if (p.dh <= 16) return launch_f32<1>(p, batch, stream);
  if (p.dh <= 32) return launch_f32<2>(p, batch, stream);
  if (p.dh <= 48) return launch_f32<3>(p, batch, stream);
  if (p.dh <= 64) return launch_f32<4>(p, batch, stream);
  if (p.dh <= 128) return launch_f32<8>(p, batch, stream);
  return launch_f32<16>(p, batch, stream);
}

// ----------------------------------------- bf16 on the tensor cores (wgmma)

constexpr int kTcBQ = 128;             // query rows of a block
constexpr int kTcThreads = 384;        // warpgroups 0, 1 compute; 2 loads
constexpr int kRowBytes = 128;         // one swizzled row: 64 bf16 columns

// Shared memory, from a 1024-byte aligned base: Q as NC chunks of
// [kTcBQ][64] bf16, then per stage K and V as NC chunks of [BK][64], then
// the mbarriers (Q, full[kStages], empty[kStages]).  Three stages where
// they fit, two at dh > 192.
template <int NC, int BK>
struct TcSmem {
  static constexpr int kStages = NC == 4 ? 2 : 3;
  static constexpr int kQBytes = NC * kTcBQ * kRowBytes;
  static constexpr int kTileBytes = NC * BK * kRowBytes;   // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kBytes = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n .reg .b64 state;\n"
               " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n"
               "}\n" :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n .reg .b64 state;\n"
               " mbarrier.arrive.shared::cta.b64 state, [%0];\n"
               "}\n" :: "r"(bar) : "memory");
}

// returns once the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred ready;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 ready, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, ready;\n"
                 "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// one box of the 4-D map (dh, seq, head, batch) at the given coordinates
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
         "r"(row), "r"(head), "r"(batch) : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand: 8-row groups 1024 bytes
// apart (SBO).  K-major operands ignore LBO; for the MN-major V the MN
// extent of one instruction (64 columns) is a single swizzle atom, so LBO
// is unused there too and is given the same 1024.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// returns once at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 64, fp32) = [d +] A (64 x 16 bf16) . B (16 x 64 bf16), A and B
// K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred acc;\n setp.ne.b32 acc, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}"
      ", %32, %33, acc, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// the same with B 16 x 128: d is 64 x 128
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred acc;\n setp.ne.b32 acc, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, acc, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16 bf16, four registers a thread) .
// B (16 x 64 bf16, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred acc;\n setp.ne.b32 acc, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, acc, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// One consumer thread's part of a 64-row warpgroup tile: rows a and b
// (r and r + 8 of the warpgroup), and the running softmax state of both.
// Element j of an m64nN accumulator lies in row a if j % 4 < 2 else b, at
// column 8 (j / 4) + 2 (lane % 4) + j % 2.
struct RowState {
  float m_a, m_b;      // running maxima of the log2-scaled logits
  float l_a, l_b;      // this thread's share of the row sums
  int qpos_a, qpos_b;  // query positions
};

// S = Q K^T for one K tile: k16 steps over head_dim, A (the warpgroup's
// 64 Q rows) and B (BK keys) K-major in shared memory
template <int NC, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t q_rows,
                                         uint32_t k_tile, int qk_steps) {
#pragma unroll
  for (int kk = 0; kk < 4 * NC; ++kk) {
    if (kk < qk_steps) {
      const uint32_t a = q_rows + (kk / 4) * kTcBQ * kRowBytes + (kk % 4) * 32;
      const uint32_t b = k_tile + (kk / 4) * BK * kRowBytes + (kk % 4) * 32;
      wgmma_ss(s, sw128_desc(a), sw128_desc(b), kk > 0);
    }
  }
}

// O += P_hi V + P_lo V for one V tile, V MN-major in shared memory
template <int NC, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[NC][32],
                                         const uint32_t (&p_hi)[BK / 16][4],
                                         const uint32_t (&p_lo)[BK / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int t = 0; t < BK / 16; ++t)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint64_t dv = sw128_desc(v_tile + c * BK * kRowBytes +
                                     t * 16 * kRowBytes);
      wgmma_rs(o[c], p_hi[t], dv);
      wgmma_rs(o[c], p_lo[t], dv);
    }
}

// The online softmax of one tile of logits s at keys [kt, kt + BK): the
// mask (where the tile is not wholly live for the warpgroup), the new
// maxima, the factors alpha by which the earlier row sums and output
// shrink, and pr = exp2(s log2(e) / sqrt(dh) - m).  s, the accumulator of
// Q K^T, is only read: where other instructions write a wgmma's
// accumulator, ptxas serializes the wgmmas (its warning C7515), which
// costs more than the registers of pr.
template <int BK>
__device__ __forceinline__ void softmax_tile(const float (&s)[BK / 2],
                                             float (&pr)[BK / 2],
                                             RowState& st, float& alpha_a,
                                             float& alpha_b, const Params& p,
                                             int kt, bool all_live,
                                             float c_log2, int lane) {
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) pr[j] = s[j];
  if (!all_live) {
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int kpos = kt + 8 * (j / 4) + 2 * (lane % 4) + (j % 2);
      const int qpos = (j % 4 < 2) ? st.qpos_a : st.qpos_b;
      bool ok = kpos < p.skv;
      if (p.causal) ok = ok && kpos <= qpos;
      if (p.window >= 0) ok = ok && kpos > qpos - p.window;
      if (!ok) pr[j] = -INFINITY;
    }
  }
  // four partial maxima and sums a row, combined in a fixed order: short
  // dependency chains
  float ma[4], mb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) ma[i] = mb[i] = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    if (j % 4 < 2) ma[(j / 4) % 4] = fmaxf(ma[(j / 4) % 4], pr[j]);
    else mb[(j / 4) % 4] = fmaxf(mb[(j / 4) % 4], pr[j]);
  }
  float mx_a = fmaxf(fmaxf(ma[0], ma[1]), fmaxf(ma[2], ma[3]));
  float mx_b = fmaxf(fmaxf(mb[0], mb[1]), fmaxf(mb[2], mb[3]));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  const float mn_a = fmaxf(st.m_a, mx_a * c_log2);
  const float mn_b = fmaxf(st.m_b, mx_b * c_log2);
  // a row without a live key so far keeps m = -inf: subtract 0 so that its
  // p = exp2(-inf) = 0 and not NaN
  const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
  const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
  alpha_a = ex2(st.m_a - mu_a);
  alpha_b = ex2(st.m_b - mu_b);
  st.m_a = mn_a;
  st.m_b = mn_b;
  float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    pr[j] = ex2(fmaf(pr[j], c_log2, (j % 4 < 2) ? -mu_a : -mu_b));
    if (j % 4 < 2) sa[(j / 4) % 4] += pr[j];
    else sb[(j / 4) % 4] += pr[j];
  }
  st.l_a = st.l_a * alpha_a + ((sa[0] + sa[1]) + (sa[2] + sa[3]));
  st.l_b = st.l_b * alpha_b + ((sb[0] + sb[1]) + (sb[2] + sb[3]));
}

// p = p_hi + p_lo in bf16, in the A-fragment layout of P V: register r of
// k16 step t holds elements 8 t + 2 r and 8 t + 2 r + 1 of s
template <int BK>
__device__ __forceinline__ void split_p(const float (&s)[BK / 2],
                                        uint32_t (&p_hi)[BK / 16][4],
                                        uint32_t (&p_lo)[BK / 16][4]) {
#pragma unroll
  for (int t = 0; t < BK / 16; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = s[8 * t + 2 * r], x1 = s[8 * t + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[t][r] = bits(hi);
      p_lo[t][r] = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
    }
}

template <int NC>
__device__ __forceinline__ void rescale(float (&o)[NC][32], float alpha_a,
                                        float alpha_b) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[c][j] *= (j % 4 < 2) ? alpha_a : alpha_b;
}

// NC: 64-column chunks of head_dim; BK: keys of a K/V tile
template <int NC, int BK>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = TcSmem<NC, BK>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sKV = base + L::kQBytes;              // + stage * kStageBytes
  const uint32_t bar_q = base + L::kBarOffset;
  const uint32_t bar_full = bar_q + 8;                 // + 8 stage
  const uint32_t bar_empty = bar_full + 8 * kStages;   // + 8 stage

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;   // heaviest first
  const int b = blockIdx.y / p.h;
  const int hh = blockIdx.y % p.h;
  const int g = hh / p.rep;
  const int off = p.skv - p.sq;
  // keys that are live for some row of the block: [k_lo, k_hi)
  const int qmin = q0 + off;
  const int qmax = min(q0 + kTcBQ, p.sq) - 1 + off;
  int k_hi = p.skv;
  if (p.causal) k_hi = min(k_hi, qmax + 1);
  int k_lo = 0;
  if (p.window >= 0) k_lo = max(0, qmin - p.window + 1);
  const int kt0 = (k_lo / BK) * BK;
  const int n_tiles = k_hi > kt0 ? (k_hi - kt0 + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int c = 0; c < NC; ++c)
        tma_load(sQ + c * kTcBQ * kRowBytes, &tq, bar_q, c * 64, q0, hh, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        // the first pass over the ring finds every stage free
        mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, L::kStageBytes);
        const uint32_t sK = sKV + s * L::kStageBytes;
        const int kt = kt0 + it * BK;
        for (int c = 0; c < NC; ++c) {
          tma_load(sK + c * BK * kRowBytes, &tk, bar_full + 8 * s, c * 64, kt,
                   g, b);
          tma_load(sK + L::kTileBytes + c * BK * kRowBytes, &tv,
                   bar_full + 8 * s, c * 64, kt, g, b);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    const int r0 = wg * 64 + warp * 16 + lane / 4;   // row a of the block
    RowState st{-INFINITY, -INFINITY, 0.f, 0.f, q0 + r0 + off,
                q0 + r0 + 8 + off};
    const int wq_lo = q0 + wg * 64 + off;      // positions of the warpgroup
    const int wq_hi = wq_lo + 63;
    const float c_log2 = p.scale * 1.4426950408889634f;
    const int qk_steps = p.dh / 16;            // k16 steps of Q K^T
    const uint32_t q_rows = sQ + wg * 64 * kRowBytes;

    float o[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 32; ++j) o[c][j] = 0.f;

    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int kt = kt0 + it * BK;
      const uint32_t stage = sKV + (it % kStages) * L::kStageBytes;
      mbar_wait(bar_full + 8 * (it % kStages), (it / kStages) & 1);
      const bool dead = kt >= p.skv || (p.causal && kt > wq_hi) ||
                        (p.window >= 0 && kt + BK - 1 <= wq_lo - p.window);
      if (!dead) {
        const bool all_live =
            kt + BK <= p.skv && (!p.causal || kt + BK - 1 <= wq_lo) &&
            (p.window < 0 || kt > wq_hi - p.window);
        float s[BK / 2];               // logits of tile it
        wgmma_fence();
        issue_qk<NC, BK>(s, q_rows, stage, qk_steps);
        wgmma_commit();
        wgmma_wait<0>();
        pin(s);
        float pr[BK / 2], alpha_a, alpha_b;
        softmax_tile<BK>(s, pr, st, alpha_a, alpha_b, p, kt, all_live, c_log2,
                         lane);
        uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
        split_p<BK>(pr, p_hi, p_lo);
        rescale<NC>(o, alpha_a, alpha_b);
        wgmma_fence();
        issue_pv<NC, BK>(o, p_hi, p_lo, stage + L::kTileBytes);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NC; ++c) pin(o[c]);
      }
      mbar_arrive(bar_empty + 8 * (it % kStages));
    }

    float l_a = st.l_a, l_b = st.l_b;
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float den_a = fmaxf(l_a, 1e-30f);
    const float den_b = fmaxf(l_b, 1e-30f);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.os0 +
                         hh * p.os1;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int row = q0 + r0 + ((j % 4 < 2) ? 0 : 8);
        const int col = 64 * c + 8 * (j / 4) + 2 * (lane % 4);
        const float den = (j % 4 < 2) ? den_a : den_b;
        if (row < p.sq && col < p.dh) {
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<long long>(row) * p.os2 + col) =
              __floats2bfloat162_rn(o[c][j] / den, o[c][j + 1] / den);
        }
      }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the CUDA runtime so that
// the library links no libcuda
EncodeTiled encode_tiled() {
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

// a map of (dh, seq, head, batch) bf16 over element strides (batch, head,
// seq) read as boxes of 64 columns x `rows`, 128-byte swizzled, zero fill
// past the edges
bool encode_map(EncodeTiled fn, CUtensorMap* map, const void* ptr, int dh,
                int seq, int heads, int batch, long long s_batch,
                long long s_head, long long s_seq, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_seq) * 2,
                                 static_cast<cuuint64_t>(s_head) * 2,
                                 static_cast<cuuint64_t>(s_batch) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC, int BK>
cudaError_t launch_tc(const Params& p, int batch, int hkv,
                      cudaStream_t stream) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode_map(fn, &tq, p.q, p.dh, p.sq, p.h, batch, p.qs0, p.qs1, p.qs2,
                  kTcBQ) ||
      !encode_map(fn, &tk, p.k, p.dh, p.skv, hkv, batch, p.ks0, p.ks1, p.ks2,
                  BK) ||
      !encode_map(fn, &tv, p.v, p.dh, p.skv, hkv, batch, p.vs0, p.vs1, p.vs2,
                  BK))
    return cudaErrorInvalidValue;
  constexpr int bytes = TcSmem<NC, BK>::kBytes;
  static bool configured = false;      // one attribute call per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_tc<NC, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((p.sq + kTcBQ - 1) / kTcBQ, batch * p.h);
  flash_attention_tc<NC, BK><<<grid, kTcThreads, bytes, stream>>>(tq, tk, tv,
                                                                  p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

cudaError_t launch_tc_dh(const Params& p, int batch, int hkv,
                         cudaStream_t stream) {
  // TMA: 16-byte aligned bases and byte strides; the output is written
  // as bf16 pairs
  const long long in_strides[9] = {p.qs0, p.qs1, p.qs2, p.ks0, p.ks1,
                                   p.ks2, p.vs0, p.vs1, p.vs2};
  for (long long s : in_strides)
    if (s <= 0 || s % 8 != 0) return cudaErrorInvalidValue;
  if (p.dh % 16 != 0 || !aligned16(p.q) || !aligned16(p.k) ||
      !aligned16(p.v) || reinterpret_cast<uintptr_t>(p.o) % 4 != 0 ||
      p.os0 % 2 != 0 || p.os1 % 2 != 0 || p.os2 % 2 != 0)
    return cudaErrorInvalidValue;
  if (p.dh <= 64) return launch_tc<1, 128>(p, batch, hkv, stream);
  if (p.dh <= 128) return launch_tc<2, 64>(p, batch, hkv, stream);
  if (p.dh <= 192) return launch_tc<3, 64>(p, batch, hkv, stream);
  return launch_tc<4, 64>(p, batch, hkv, stream);
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) of q, k, v and o in that
// order; head_dim is contiguous in all four.  dtype: 0 float32 (the CUDA-
// core kernel), 1 bfloat16 (the tensor-core kernel, which also needs
// dh % 16 == 0, 16-byte aligned q, k, v and strides that are multiples of
// 8 elements); q, k, v and o share it.  window < 0 means no window.
// Returns a cudaError_t (cudaErrorInvalidValue for shapes the kernel does
// not take).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* strides, int batch, int h,
                                   int hkv, int sq, int skv, int dh,
                                   int causal, int window, float scale,
                                   int dtype, void* stream) {
  if (batch <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || sq <= 0 ||
      skv < 0 || dh <= 0 || dh > 256 ||
      static_cast<long long>(batch) * h > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.qs0 = strides[0]; p.qs1 = strides[1]; p.qs2 = strides[2];
  p.ks0 = strides[3]; p.ks1 = strides[4]; p.ks2 = strides[5];
  p.vs0 = strides[6]; p.vs1 = strides[7]; p.vs2 = strides[8];
  p.os0 = strides[9]; p.os1 = strides[10]; p.os2 = strides[11];
  p.h = h;
  p.rep = h / hkv;
  p.sq = sq;
  p.skv = skv;
  p.dh = dh;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && skv == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = dtype == 0 ? launch_f32_dh(p, batch, s)
                               : launch_tc_dh(p, batch, hkv, s);
  if (err == cudaSuccess) ++g_launches[dtype == 0 ? 1 : 0];
  return static_cast<int>(err);
}

// counts[0]: launches of the tensor-core (bf16) kernel, counts[1]: of the
// CUDA-core (fp32) kernel, since the library was loaded
extern "C" int flash_attention_kernel_launches(long long* counts) {
  counts[0] = g_launches[0];
  counts[1] = g_launches[1];
  return 0;
}
