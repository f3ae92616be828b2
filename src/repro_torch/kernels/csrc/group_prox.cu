// Row-wise L2-ball projection (the AMA dual prox) on Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels of src/repro/kernels/group_prox.py:
// group_ball_proj_pallas (_proj_kernel, v (e,d)) and
// group_ball_proj_batched_pallas (_batched_proj_kernel, v (b,e,d)).  Each
// row becomes
//     out[r] = v[r] * (||v[r]|| > radius[r] ? radius[r] / max(||v[r]||, 1e-30) : 1)
// with the radius read through two element strides, so one scalar, one
// radius per edge or one per (batch, edge) needs no broadcast copy.
//
// What bounds it on an H100: bytes.  A row is read once and written once
// (8 d bytes, plus 4 for its radius) for about 3 d flop, so at the convex
// path's (1, 131072, 32) the floor is 34 MB / 3.35 TB/s = 10 us.
//
// Design: a group of G lanes of one warp (G a power of two) owns a row.
// With d % 4 == 0 (and 16-byte aligned rows) every lane loads float4s, so
// at d = 32 a quarter warp covers a row with one 16-byte load per lane and
// a warp streams four 128-byte rows at once.  Each lane keeps up to kHeld
// vectors of its row in registers, sums their squares, the group reduces
// the sum by shuffles, and the lanes write their held vectors scaled; only
// columns beyond kHeld * G vectors (d > 512 with float4s) are read again in
// the write pass.  The TPU pads e to its block with radius 1; here the
// ragged tail is guarded instead (every lane of a warp runs the same
// number of loop trips, so the shuffles stay converged), and no padded
// copy is made.  Row and element offsets are 64-bit: b * e * d passes 2^31
// on the complete graph's lambda ladders.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHeld = 4;

template <int VEC> struct Vec;
template <> struct Vec<1> {
  using T = float;
  __device__ static float sq(float x, float acc) { return fmaf(x, x, acc); }
  __device__ static float scale(float x, float s) { return x * s; }
  __device__ static float zero() { return 0.f; }
};
template <> struct Vec<4> {
  using T = float4;
  __device__ static float sq(float4 x, float acc) {
    acc = fmaf(x.x, x.x, acc);
    acc = fmaf(x.y, x.y, acc);
    acc = fmaf(x.z, x.z, acc);
    return fmaf(x.w, x.w, acc);
  }
  __device__ static float4 scale(float4 x, float s) {
    return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
  }
  __device__ static float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};

template <int VEC, int G>
__global__ void __launch_bounds__(kThreads)
group_ball_proj_kernel(const float* __restrict__ v,
                       const float* __restrict__ radius,
                       float* __restrict__ out, long long rows, long long e,
                       int d, long long rs_b, long long rs_e) {
  using V = Vec<VEC>;
  using T = typename V::T;
  constexpr int kGroups = kThreads / G;      // rows per block per trip
  const int lane = threadIdx.x % G;
  const int group = threadIdx.x / G;
  const int nvec = d / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * kGroups;
  // row0 is the same for every thread of the block, so all lanes of a
  // warp take the same trips and reach the shuffles together
  for (long long row0 = static_cast<long long>(blockIdx.x) * kGroups;
       row0 < rows; row0 += stride) {
    const long long row = row0 + group;
    const bool valid = row < rows;
    const T* src = reinterpret_cast<const T*>(v + (valid ? row : 0) * d);
    T held[kHeld];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < kHeld; ++j) {
      const int k = lane + j * G;
      held[j] = (valid && k < nvec) ? src[k] : V::zero();
      ss = V::sq(held[j], ss);
    }
    for (int k = lane + kHeld * G; valid && k < nvec; k += G)
      ss = V::sq(src[k], ss);
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (!valid) continue;
    const long long bi = row / e;
    const long long ei = row - bi * e;
    const float r = radius[bi * rs_b + ei * rs_e];
    const float n = sqrtf(ss);
    const float s = n > r ? r / fmaxf(n, 1e-30f) : 1.f;
    T* dst = reinterpret_cast<T*>(out + row * d);
#pragma unroll
    for (int j = 0; j < kHeld; ++j) {
      const int k = lane + j * G;
      if (k < nvec) dst[k] = V::scale(held[j], s);
    }
    for (int k = lane + kHeld * G; k < nvec; k += G)
      dst[k] = V::scale(src[k], s);
  }
}

template <int VEC, int G>
cudaError_t launch(const float* v, const float* r, float* o, long long rows,
                   long long e, int d, long long rs_b, long long rs_e,
                   cudaStream_t s) {
  constexpr int kGroups = kThreads / G;
  const long long want = (rows + kGroups - 1) / kGroups;
  const unsigned grid = static_cast<unsigned>(want < (1LL << 30) ? want
                                                                 : (1LL << 30));
  group_ball_proj_kernel<VEC, G><<<grid, kThreads, 0, s>>>(v, r, o, rows, e,
                                                           d, rs_b, rs_e);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t dispatch(int lanes, const float* v, const float* r, float* o,
                     long long rows, long long e, int d, long long rs_b,
                     long long rs_e, cudaStream_t s) {
  switch (lanes) {
    case 1: return launch<VEC, 1>(v, r, o, rows, e, d, rs_b, rs_e, s);
    case 2: return launch<VEC, 2>(v, r, o, rows, e, d, rs_b, rs_e, s);
    case 4: return launch<VEC, 4>(v, r, o, rows, e, d, rs_b, rs_e, s);
    case 8: return launch<VEC, 8>(v, r, o, rows, e, d, rs_b, rs_e, s);
    case 16: return launch<VEC, 16>(v, r, o, rows, e, d, rs_b, rs_e, s);
    default: return launch<VEC, 32>(v, r, o, rows, e, d, rs_b, rs_e, s);
  }
}

}  // namespace

// v, out (b,e,d) contiguous fp32 device pointers; radius fp32, element
// (i, j) at radius[i * rs_b + j * rs_e] (strides 0 broadcast).
// Returns the launch's cudaError_t (0 on success).
extern "C" int group_ball_proj_batched_f32(const void* v, const void* radius,
                                           void* out, long long b, long long e,
                                           int d, long long rs_b,
                                           long long rs_e, void* stream) {
  if (b <= 0 || e <= 0 || d <= 0) return 0;
  const auto* pv = static_cast<const float*>(v);
  const auto* pr = static_cast<const float*>(radius);
  auto* po = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec4 = d % 4 == 0 &&
                    reinterpret_cast<std::uintptr_t>(v) % 16 == 0 &&
                    reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  const int nvec = vec4 ? d / 4 : d;
  int lanes = 1;
  while (lanes < nvec && lanes < 32) lanes *= 2;
  const long long rows = b * e;
  const cudaError_t err =
      vec4 ? dispatch<4>(lanes, pv, pr, po, rows, e, d, rs_b, rs_e, s)
           : dispatch<1>(lanes, pv, pr, po, rows, e, d, rs_b, rs_e, s);
  return static_cast<int>(err);
}

// The unbatched projection: v, out (e,d), radius[j * rs_e].
extern "C" int group_ball_proj_f32(const void* v, const void* radius,
                                   void* out, long long e, int d,
                                   long long rs_e, void* stream) {
  return group_ball_proj_batched_f32(v, radius, out, 1, e, d, 0, rs_e,
                                     stream);
}
