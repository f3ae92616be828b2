// Block (flash) attention with an online softmax on Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
// flash_attention_pallas (_flash_kernel).  q (b,h,sq,dh), k/v
// (b,hkv,skv,dh) -> o (b,h,sq,dh):
//     s = (q . k) * (1 / sqrt(dh)), query position i + (skv - sq),
//     live keys: kpos < skv, causal kpos <= qpos, window kpos > qpos - window,
//     online softmax with fp32 statistics (m, l) and fp32 accumulation of
//     both products, o = acc / max(l, 1e-30) in q's type.
// A row with no live key comes out as zeros, as in the Pallas kernel.
//
// What bounds it on an H100: operations.  At the serving shape
// (4, 14, 8192, 64) x (4, 2, 8192, 64) with a causal window of 4096 it
// does 4 dh flop for each of 1.41e9 live (q, k) pairs (361 GFLOP) and moves
// 134 MB (q, k, v and o once).  This first version computes both products in fp32 on the CUDA
// cores (67 TFLOP/s: 5.4 ms at best); mma.sync / wgmma on bf16 tiles
// (989 TFLOP/s) is later work, behind its own parity gate.
//
// Design.  One block of 256 threads owns a tile of kBQ = 64 query rows of
// one (batch, head) and walks the key tiles of kBK = 64 that hold a live
// key for one of its rows: tiles wholly above the causal diagonal or below
// the window are never visited (they would leave m, l and acc unchanged:
// p = 0 and alpha = 1).  The TPU grid pads sq and skv to its blocks; here
// the ragged edge is masked and zero-filled in shared memory, and no
// padded copy is made.  GQA reads key/value head h / (h / hkv) in place
// (the TPU wrapper repeats the heads).  q, k, v and o are read and written
// through (batch, head, seq) strides with a contiguous head_dim, so the
// transposes of (b, s, h, dh) that the model produces need no copy.  bf16
// and fp32 inputs are upcast to fp32 on their way into shared memory.
//
// Thread layout: tx = thread % 16, ty = thread / 16.  A thread holds the
// logits of rows ty*4 + i and columns tx + 16 j (i, j < 4), and the output
// of rows ty*4 + i and head-dim columns tx + 16 c (c < DPT, head_dim padded
// to 16 DPT).  Row maxima and sums reduce over the 16 lanes of a row with
// xor shuffles.  Q and K tiles are read as float4 along head_dim (row
// stride DP + 4 floats, so 8 consecutive rows fall in distinct banks);
// P goes through shared memory for the second product.  Every sum is taken
// in a fixed order, so a repeat run is bit-identical.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kLDP = kBK + 4;          // row stride of the P tile (floats)
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

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DPT>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBQ + 2 * kBK) * (16 * DPT + 4) + kBQ * kLDP);
}

template <typename T, int DPT>
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
  const T* q = static_cast<const T*>(p.q) + b * p.qs0 + hh * p.qs1;
  const T* k = static_cast<const T*>(p.k) + b * p.ks0 + g * p.ks1;
  const T* v = static_cast<const T*>(p.v) + b * p.vs0 + g * p.vs1;
  T* o = static_cast<T*>(p.o) + b * p.os0 + hh * p.os1;
  const int off = p.skv - p.sq;

  for (int e = threadIdx.x; e < kBQ * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    float x = 0.f;
    if (q0 + r < p.sq && c < p.dh) {
      x = load_f32(q + static_cast<long long>(q0 + r) * p.qs2 + c);
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
        kx = load_f32(k + static_cast<long long>(kt + r) * p.ks2 + c);
        vx = load_f32(v + static_cast<long long>(kt + r) * p.vs2 + c);
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
        store_f32(o + static_cast<long long>(r) * p.os2 + col,
                  acc[i][c] / den);
      }
    }
  }
}

template <typename T, int DPT>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DPT>();
  static bool configured = false;      // one attribute call per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((p.sq + kBQ - 1) / kBQ, batch * p.h);
  flash_attention_kernel<T, DPT><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const Params& p, int batch, cudaStream_t stream) {
  if (p.dh <= 16) return launch<T, 1>(p, batch, stream);
  if (p.dh <= 32) return launch<T, 2>(p, batch, stream);
  if (p.dh <= 48) return launch<T, 3>(p, batch, stream);
  if (p.dh <= 64) return launch<T, 4>(p, batch, stream);
  if (p.dh <= 128) return launch<T, 8>(p, batch, stream);
  return launch<T, 16>(p, batch, stream);
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) of q, k, v and o in that
// order; head_dim is contiguous in all four.  dtype: 0 float32, 1 bfloat16
// (q, k, v and o share it).  window < 0 means no window.  Returns a
// cudaError_t (cudaErrorInvalidValue for shapes the kernel does not take).
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
  cudaError_t err = dtype == 0 ? launch_dh<float>(p, batch, s)
                               : launch_dh<__nv_bfloat16>(p, batch, s);
  return static_cast<int>(err);
}
