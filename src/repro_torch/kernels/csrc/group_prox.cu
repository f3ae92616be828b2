// Row-wise L2-ball projection (the AMA dual prox) on Hopper (sm_90a), fp32,
// and the two passes over the dual that make one AMA iteration.
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
//
// One AMA iteration (device_convex.py) is two passes over the (b, e, d)
// dual nu, with no edge-sized temporary between them; neither replaces a
// TPU kernel (the reference leaves them to XLA), each replaces PyTorch
// gathers, segment reductions and elementwise ops that wrote the dual out
// several times an iteration:
//   * the gather-back (ama_gather_back_kernel):
//         u[l, n] = a[n] + (sum of nu[l, heads of n]
//                           - sum of nu[l, tails of n])
//     A lane owns one column of one (l, n) and adds the node's head rows,
//     then its tail rows, one after another in run order (through the
//     run's slot order when it has one), as torch.segment_reduce adds
//     them: no atomics, so the same dual gives the same bits on every run,
//     and the bits of the plain version.  That order is kept on purpose:
//     the AMA's stop rule compares a dual step with a threshold about one
//     ulp of a, so where the iterations reach the rounding floor the
//     count of iterations follows the rounding of u; a tree of partial
//     sums (fewer rounding errors) stopped a card solve at m = 256 after
//     137 iterations where the CPU and the reference ran 200.  The order
//     costs no speed: G lanes read a row's G columns (coalesced), and each
//     lane keeps 32 rows' loads in flight (a sum's dependent adds wait on
//     none of them) with the next 32 rows' slots loaded meanwhile: 0.76 ms
//     at (1, 8 386 560, 32) on an H100 (700 W), against 0.78 ms for the
//     tree and 1.09 ms with 16 rows in flight.  Bound by bytes: the dual
//     is read once as heads and once as tails.
//   * the edge pass (group_ball_proj_kernel<..., true>): the prox with the
//     gradient step as its prologue, v = nu - eta * (u[l, i_e] - u[l, j_e])
//     formed in registers from the int32 edge ends and the rows of u (which
//     sit in L2: 512 KB at m = 4096, d = 32) in PyTorch's order of rounded
//     operations (no FMA contraction), projected exactly as the plain
//     instance projects a stored v, and max |out - nu| as its epilogue: a
//     max per block of the values' bits (non-negative floats order as their
//     bits, and a NaN above them all), then one atomicMax a block.  A max
//     is exact in any order, so the result is deterministic.  Bound by
//     bytes: the plain prox's plus 8 bytes of edge ends a row.  What the
//     plain instance's design leaves in the way is latency: a row's u
//     loads wait on its edge ends.  So each thread loads the next trip's
//     edge ends while it works on this one, the grid is the blocks that
//     fit on the card at once (also one atomic a block), and a lane holds
//     one vector of its row, not kHeld: 58-61 registers instead of 76, so
//     four blocks an SM instead of three (columns past the first vector a
//     lane are formed again in the write pass; their squares are added in
//     the plain instance's order, so the bits are the same).  At
//     (1, 8 386 560, 32) the pass went from 1.18 to 0.82-0.85 ms on an
//     H100 (700 W); capping the registers lower spilled and was slower.
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
  // nu - eta * (ui - uj), each operation rounded on its own
  __device__ static float step(float nu, float eta, float ui, float uj) {
    return __fsub_rn(nu, __fmul_rn(eta, __fsub_rn(ui, uj)));
  }
  // max(acc, the bits of |x - y|)
  __device__ static unsigned moved(float x, float y, unsigned acc) {
    return max(acc, __float_as_uint(fabsf(__fsub_rn(x, y))));
  }
};
template <> struct Vec<4> {
  using T = float4;
  using S = Vec<1>;
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
  __device__ static float4 step(float4 nu, float eta, float4 ui, float4 uj) {
    return make_float4(S::step(nu.x, eta, ui.x, uj.x),
                       S::step(nu.y, eta, ui.y, uj.y),
                       S::step(nu.z, eta, ui.z, uj.z),
                       S::step(nu.w, eta, ui.w, uj.w));
  }
  __device__ static unsigned moved(float4 x, float4 y, unsigned acc) {
    acc = S::moved(x.x, y.x, acc);
    acc = S::moved(x.y, y.y, acc);
    acc = S::moved(x.z, y.z, acc);
    return S::moved(x.w, y.w, acc);
  }
};

// The AMA step's operands (the fused instance only): u (b, m, d), the edge
// ends ii, jj (e,) int32, the step size *eta, and where the bits of
// max |out - nu| go.
struct AmaStep {
  const float* u;
  const int* ii;
  const int* jj;
  const float* eta;
  unsigned* moved;
  long long m;
};

// STEP = false: the plain prox of a stored v.  STEP = true: v is the dual
// nu, and the row projected is nu - eta * (u[i] - u[j]) (see the header).
// out may be v itself (the fused step's update in place): a lane reads
// each column it writes before writing it, and a row's norm is summed
// before any of it is written.
template <int VEC, int G, bool STEP>
__global__ void __launch_bounds__(kThreads)
group_ball_proj_kernel(const float* v, const float* __restrict__ radius,
                       float* out, long long rows, long long e,
                       int d, long long rs_b, long long rs_e, AmaStep step) {
  using V = Vec<VEC>;
  using T = typename V::T;
  constexpr int kGroups = kThreads / G;      // rows per block per trip
  const int lane = threadIdx.x % G;
  const int group = threadIdx.x / G;
  const int nvec = d / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * kGroups;
  float eta = 0.f;
  unsigned moved = 0u;                       // bits of this thread's max
  int ci = 0, cj = 0;                        // this trip's edge ends
  if constexpr (STEP) {
    eta = *step.eta;
    const long long first =
        static_cast<long long>(blockIdx.x) * kGroups + group;
    const long long at = first < rows ? first : 0;
    const long long fb = rows == e ? 0 : at / e;
    ci = step.ii[at - fb * e];
    cj = step.jj[at - fb * e];
  }
  // row0 is the same for every thread of the block, so all lanes of a
  // warp take the same trips and reach the shuffles together
  for (long long row0 = static_cast<long long>(blockIdx.x) * kGroups;
       row0 < rows; row0 += stride) {
    const long long row = row0 + group;
    const bool valid = row < rows;
    const long long at = valid ? row : 0;
    const T* src = reinterpret_cast<const T*>(v + at * d);
    const T* ui = nullptr;
    const T* uj = nullptr;
    long long bi = 0, ei = 0;                // the row's rung and edge
    if constexpr (STEP) {
      bi = rows == e ? 0 : at / e;
      ei = at - bi * e;
      ui = reinterpret_cast<const T*>(step.u + (bi * step.m + ci) * d);
      uj = reinterpret_cast<const T*>(step.u + (bi * step.m + cj) * d);
      // the next trip's edge ends, loaded while this trip works
      const long long nxt = row + stride < rows ? row + stride : at;
      const long long nb = rows == e ? 0 : nxt / e;
      ci = step.ii[nxt - nb * e];
      cj = step.jj[nxt - nb * e];
    }
    // the k-th vector of the row to project
    auto load = [&](int k, T& nu) -> T {
      nu = src[k];
      if constexpr (STEP) return V::step(nu, eta, ui[k], uj[k]);
      return nu;
    };
    constexpr int kKeep = STEP ? 1 : kHeld;    // vectors held a lane
    T held[kKeep];
    T nu_held[kKeep];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < kKeep; ++j) {
      const int k = lane + j * G;
      held[j] = nu_held[j] = V::zero();
      if (valid && k < nvec) held[j] = load(k, nu_held[j]);
      ss = V::sq(held[j], ss);
    }
    for (int k = lane + kKeep * G; valid && k < nvec; k += G) {
      T nu;
      ss = V::sq(load(k, nu), ss);
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (!valid) continue;
    if constexpr (!STEP) {
      bi = row / e;
      ei = row - bi * e;
    }
    const float r = radius[bi * rs_b + ei * rs_e];
    const float n = sqrtf(ss);
    const float s = n > r ? r / fmaxf(n, 1e-30f) : 1.f;
    T* dst = reinterpret_cast<T*>(out + row * d);
#pragma unroll
    for (int j = 0; j < kKeep; ++j) {
      const int k = lane + j * G;
      if (k < nvec) {
        const T o = V::scale(held[j], s);
        dst[k] = o;
        if constexpr (STEP) moved = V::moved(o, nu_held[j], moved);
      }
    }
    for (int k = lane + kKeep * G; k < nvec; k += G) {
      T nu;
      const T o = V::scale(load(k, nu), s);
      dst[k] = o;
      if constexpr (STEP) moved = V::moved(o, nu, moved);
    }
  }
  if constexpr (STEP) {
    __shared__ unsigned warp_max[kThreads / 32];
    moved = __reduce_max_sync(0xffffffffu, moved);
    if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = moved;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kThreads / 32; ++w) moved = max(moved, warp_max[w]);
      atomicMax(step.moved, moved);
    }
  }
}

template <int VEC, int G, bool STEP>
cudaError_t launch(const float* v, const float* r, float* o, long long rows,
                   long long e, int d, long long rs_b, long long rs_e,
                   const AmaStep& step, cudaStream_t s) {
  constexpr int kGroups = kThreads / G;
  auto kernel = group_ball_proj_kernel<VEC, G, STEP>;
  long long want = (rows + kGroups - 1) / kGroups;
  if (STEP) {
    // the blocks that fit on the card at once walk all rows, so the max
    // takes one atomic per resident block, not one per row group
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    const long long resident = static_cast<long long>(sms) * per_sm;
    if (resident > 0 && resident < want) want = resident;
  }
  const unsigned grid = static_cast<unsigned>(want < (1LL << 30) ? want
                                                                 : (1LL << 30));
  kernel<<<grid, kThreads, 0, s>>>(v, r, o, rows, e, d, rs_b, rs_e, step);
  return cudaGetLastError();
}

template <int VEC, bool STEP>
cudaError_t dispatch(int lanes, const float* v, const float* r, float* o,
                     long long rows, long long e, int d, long long rs_b,
                     long long rs_e, const AmaStep& st, cudaStream_t s) {
  switch (lanes) {
    case 1: return launch<VEC, 1, STEP>(v, r, o, rows, e, d, rs_b, rs_e, st, s);
    case 2: return launch<VEC, 2, STEP>(v, r, o, rows, e, d, rs_b, rs_e, st, s);
    case 4: return launch<VEC, 4, STEP>(v, r, o, rows, e, d, rs_b, rs_e, st, s);
    case 8: return launch<VEC, 8, STEP>(v, r, o, rows, e, d, rs_b, rs_e, st, s);
    case 16:
      return launch<VEC, 16, STEP>(v, r, o, rows, e, d, rs_b, rs_e, st, s);
    default:
      return launch<VEC, 32, STEP>(v, r, o, rows, e, d, rs_b, rs_e, st, s);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// The lanes a row (or a column chunk) takes: the power of two at or above
// its vectors, at most a warp.
int lanes_for(int nvec) {
  int lanes = 1;
  while (lanes < nvec && lanes < 32) lanes *= 2;
  return lanes;
}

template <bool STEP>
int proj(const void* v, const void* radius, void* out, long long b,
         long long e, int d, long long rs_b, long long rs_e,
         const AmaStep& st, bool vec4, void* stream) {
  const auto* pv = static_cast<const float*>(v);
  const auto* pr = static_cast<const float*>(radius);
  auto* po = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int lanes = lanes_for(vec4 ? d / 4 : d);
  const long long rows = b * e;
  const cudaError_t err =
      vec4 ? dispatch<4, STEP>(lanes, pv, pr, po, rows, e, d, rs_b, rs_e, st, s)
           : dispatch<1, STEP>(lanes, pv, pr, po, rows, e, d, rs_b, rs_e, st,
                               s);
  return static_cast<int>(err);
}

// The sum of rows [p, end) of one segment's run at column `col`, added one
// after another in run order from 0 (the plain version's order): kRun
// rows' loads in flight, and with an order the next kRun rows' slots
// loaded while those rows arrive.
template <bool ORDERED>
__device__ float run_sum(const float* __restrict__ dual,
                         const int* __restrict__ order, long long p,
                         long long end, int d) {
  constexpr int kRun = 32;
  auto slot = [&](long long q) -> int {
    if constexpr (ORDERED) return q < end ? order[q] : 0;
    return static_cast<int>(q);
  };
  auto row = [&](int at) { return dual[static_cast<long long>(at) * d]; };
  int next[kRun];
#pragma unroll
  for (int q = 0; q < kRun; ++q) next[q] = slot(p + q);
  float acc = 0.f;
  for (; p + kRun <= end; p += kRun) {
    float x[kRun];
#pragma unroll
    for (int q = 0; q < kRun; ++q) x[q] = row(next[q]);
#pragma unroll
    for (int q = 0; q < kRun; ++q) next[q] = slot(p + kRun + q);
#pragma unroll
    for (int q = 0; q < kRun; ++q) acc += x[q];
  }
#pragma unroll
  for (int q = 0; q < kRun; ++q)
    if (p + q < end) acc += row(next[q]);
  return acc;
}

// A group of G lanes (a power of two, at most a warp) owns one (l, n) and
// G columns of it; a lane sums its column of the node's head run and of
// its tail run.  No lane waits on another, so a lane past the last column
// leaves at once.
template <int G>
__global__ void __launch_bounds__(kThreads)
ama_gather_back_kernel(const float* __restrict__ a,
                       const float* __restrict__ nu,
                       const long long* __restrict__ head_start,
                       const int* __restrict__ head_order,
                       const long long* __restrict__ tail_start,
                       const int* __restrict__ tail_order,
                       float* __restrict__ u, long long b, long long m,
                       long long e, int d) {
  const int chunks = (d + G - 1) / G;
  const long long group =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (group >= b * m * chunks) return;
  const int col = static_cast<int>(group % chunks) * G + threadIdx.x % G;
  if (col >= d) return;
  const long long seg = group / chunks;      // l * m + n
  const long long l = seg / m;
  const long long n = seg - l * m;
  const float* dual = nu + l * e * d + col;
  const float heads =
      head_order != nullptr
          ? run_sum<true>(dual, head_order, head_start[n], head_start[n + 1], d)
          : run_sum<false>(dual, nullptr, head_start[n], head_start[n + 1], d);
  const float tails =
      tail_order != nullptr
          ? run_sum<true>(dual, tail_order, tail_start[n], tail_start[n + 1], d)
          : run_sum<false>(dual, nullptr, tail_start[n], tail_start[n + 1], d);
  u[seg * d + col] = a[n * d + col] + (heads - tails);
}

template <int G>
cudaError_t launch_gather(const float* a, const float* nu, const long long* hs,
                          const int* ho, const long long* ts, const int* to,
                          float* u, long long b, long long m, long long e,
                          int d, cudaStream_t s) {
  const long long lanes = b * m * ((d + G - 1) / G) * G;
  const long long want = (lanes + kThreads - 1) / kThreads;
  if (want >= (1LL << 31)) return cudaErrorInvalidValue;
  ama_gather_back_kernel<G><<<static_cast<unsigned>(want), kThreads, 0, s>>>(
      a, nu, hs, ho, ts, to, u, b, m, e, d);
  return cudaGetLastError();
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
  const bool vec4 = d % 4 == 0 && aligned16(v) && aligned16(out);
  return proj<false>(v, radius, out, b, e, d, rs_b, rs_e, AmaStep{}, vec4,
                     stream);
}

// The unbatched projection: v, out (e,d), radius[j * rs_e].
extern "C" int group_ball_proj_f32(const void* v, const void* radius,
                                   void* out, long long e, int d,
                                   long long rs_e, void* stream) {
  return group_ball_proj_batched_f32(v, radius, out, 1, e, d, 0, rs_e,
                                     stream);
}

// One AMA edge pass, in place: nu = prox(nu - eta * (u[l, ii[e]] -
// u[l, jj[e]]), radius) over nu (b,e,d), u (b,m,d) contiguous fp32, ii, jj
// (e,) int32, eta one fp32 on the device; `moved` (one fp32) receives
// max |new - nu|.
extern "C" int ama_step_f32(void* nu, const void* radius,
                            long long b, long long e, int d, long long rs_b,
                            long long rs_e, const void* u, long long m,
                            const void* ii, const void* jj, const void* eta,
                            void* moved, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(moved, 0, sizeof(unsigned), s);
  if (err != cudaSuccess || b <= 0 || e <= 0 || d <= 0)
    return static_cast<int>(err);
  const AmaStep st{static_cast<const float*>(u), static_cast<const int*>(ii),
                   static_cast<const int*>(jj), static_cast<const float*>(eta),
                   static_cast<unsigned*>(moved), m};
  const bool vec4 = d % 4 == 0 && aligned16(nu) && aligned16(u);
  return proj<true>(nu, radius, nu, b, e, d, rs_b, rs_e, st, vec4, stream);
}

// u (b,m,d) = a (m,d) + (sum over each node's heads - sum over its tails)
// of nu (b,e,d).  A plan's run of node n is [start[n], start[n + 1]) (int64,
// m + 1 values) of its slot order (int32, e values), or of the slots
// themselves where the order is null.  All fp32 contiguous.
extern "C" int ama_gather_back_f32(const void* a, const void* nu,
                                   const void* head_start,
                                   const void* head_order,
                                   const void* tail_start,
                                   const void* tail_order, void* u,
                                   long long b, long long m, long long e,
                                   int d, void* stream) {
  if (b <= 0 || m <= 0 || d <= 0) return 0;
  const auto* pa = static_cast<const float*>(a);
  const auto* pn = static_cast<const float*>(nu);
  const auto* hs = static_cast<const long long*>(head_start);
  const auto* ho = static_cast<const int*>(head_order);
  const auto* ts = static_cast<const long long*>(tail_start);
  const auto* to = static_cast<const int*>(tail_order);
  auto* pu = static_cast<float*>(u);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (lanes_for(d)) {
    case 1: err = launch_gather<1>(pa, pn, hs, ho, ts, to, pu, b, m, e, d, s);
      break;
    case 2: err = launch_gather<2>(pa, pn, hs, ho, ts, to, pu, b, m, e, d, s);
      break;
    case 4: err = launch_gather<4>(pa, pn, hs, ho, ts, to, pu, b, m, e, d, s);
      break;
    case 8: err = launch_gather<8>(pa, pn, hs, ho, ts, to, pu, b, m, e, d, s);
      break;
    case 16:
      err = launch_gather<16>(pa, pn, hs, ho, ts, to, pu, b, m, e, d, s);
      break;
    default:
      err = launch_gather<32>(pa, pn, hs, ho, ts, to, pu, b, m, e, d, s);
  }
  return static_cast<int>(err);
}
