// Fused SMO iteration for NVIDIA Hopper (sm_90a), with a plain C interface
// loaded through ctypes by dpsvm_tpu_torch/experimental/fused_step.py.
//
// Replaces the Pallas TPU kernel _fused_iter_kernel / fused_update_select
// (dpsvm_tpu/experimental/fused_step.py:55-165) and the XLA scalar prologue
// of fused_smo_body (same file, :193-233).
//
// One SMO iteration is three launches on one stream:
//   prologue_kernel  (1 block)   eta from the two working rows, the
//                                independently clipped alpha pair, lo slot
//                                written before hi, and the pass's scalars
//                                [d_hi, d_lo, gamma, w2_hi, w2_lo, C, 0, 0];
//                                also decides whether this iteration runs
//                                at all (the lax.while_loop condition).
//   pass_kernel      (grid)      one pass over X: both dot products per row,
//                                the RBF epilogue, f += d_hi K_hi + d_lo K_lo
//                                in place, Keerthi-masked scores of the
//                                post-update (alpha, f), and one
//                                (argmin, argmax) partial per block.
//   finalize_kernel  (1 block)   reduces the partials into [i_hi, i_lo],
//                                [b_hi, b_lo] and advances the carry.
//
// What bounds it: per iteration the pass reads X once (n*d*4 bytes in f32,
// n*d*2 in bf16) plus x2, y, alpha, f and writes f: at 60000 x 784 that is
// 188 MB (94 MB) against 4*n*d = 188 MFLOP, far below one flop per byte, so
// HBM bandwidth bounds it and the tensor cores have nothing to do (at two
// rows a wgmma tile would be 97% idle). The design therefore streams X
// with coalesced 16-byte loads, one warp per row, keeps the two working
// rows in shared memory as f32, and accumulates with fp32 FMA.
//
// Order: CUDA blocks run in no order, unlike the TPU grid, whose steps ran
// in sequence and carried the best (value, index) in SMEM. Every reduction
// here compares (value, index) pairs with the lower index winning a tie, so
// the result is the first index whatever the order: the jnp.argmin rule. A
// NaN score wins its extremum (jnp.argmin propagates NaN), so a poisoned f
// surfaces as a non-finite b that the host refuses.
//
// The alpha writes of the prologue must be visible to the pass (the masks
// read the post-update alpha) and the pass must not race them, so the
// prologue is its own launch before the pass on the same stream.
//
// The host never synchronises inside a chunk: the working set stays in the
// device carry `state`, and a device flag turns the launches left in a
// chunk into no-ops once the gap has closed (plus the one trailing
// do-while body) or the chunk's iteration limit is reached.
//
// The only entry point is dpsvm_fused_chunk. The prologue and the pass
// each count the launches whose body ran in a carry word of their own
// (S_RUN_PROLOGUE, S_RUN_PASS); the finalize advances S_NITER. The host
// reads the three in its one poll, so each count is checked against the
// iterations run independently of the others.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

// Carry words (int32; floats as bit patterns). Mirrored in fused_step.py.
enum {
  S_IHI = 0,     // working set for the next body
  S_ILO = 1,
  S_BHI = 2,     // f32 bits
  S_BLO = 3,     // f32 bits
  S_NITER = 4,
  S_ACTIVE = 5,  // this iteration's body runs
  S_TRAIL = 6,   // this body is the trailing do-while body
  S_DONE = 7,    // no more bodies in this chunk
  S_ENTRY = 8,   // n_iter at chunk entry (the progress gate)
  S_RUN_PROLOGUE = 9,   // prologue launches whose body ran, ever
  S_RUN_PASS = 10,      // pass launches whose body ran, ever
};

constexpr float kSentinel = 1.0e9f;
constexpr int kPassThreads = 256;
constexpr int kFinalThreads = 1024;
constexpr int kPrologueThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes of X as f32: 4 floats or 8 bf16.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[e];
    const float2 f = __bfloat1622float2(h);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

// (av, ai) better than (bv, bi) for the argmin / argmax.
__device__ __forceinline__ bool min_better(float av, int ai, float bv, int bi) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an != bn) return an;
  if (!an && av != bv) return av < bv;
  return ai < bi;
}
__device__ __forceinline__ bool max_better(float av, int ai, float bv, int bi) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an != bn) return an;
  if (!an && av != bv) return av > bv;
  return ai < bi;
}

struct Best {
  float up_v; int up_i; float lo_v; int lo_i;
};

__device__ __forceinline__ Best best_init() {
  return Best{INFINITY, INT_MAX, -INFINITY, INT_MAX};
}

__device__ __forceinline__ void best_merge(Best& a, const Best& b) {
  if (min_better(b.up_v, b.up_i, a.up_v, a.up_i)) { a.up_v = b.up_v; a.up_i = b.up_i; }
  if (max_better(b.lo_v, b.lo_i, a.lo_v, a.lo_i)) { a.lo_v = b.lo_v; a.lo_i = b.lo_i; }
}

__device__ __forceinline__ Best warp_merge(Best b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Best o_b;
    o_b.up_v = __shfl_xor_sync(0xffffffffu, b.up_v, o);
    o_b.up_i = __shfl_xor_sync(0xffffffffu, b.up_i, o);
    o_b.lo_v = __shfl_xor_sync(0xffffffffu, b.lo_v, o);
    o_b.lo_i = __shfl_xor_sync(0xffffffffu, b.lo_i, o);
    best_merge(b, o_b);
  }
  return b;
}

// jnp.clip: NaN stays NaN (fminf/fmaxf alone would drop it).
__device__ __forceinline__ float clip0(float v, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), hi);
}

template <typename T>
__global__ void __launch_bounds__(kPassThreads)
pass_kernel(const T* __restrict__ rows, const float* __restrict__ scal,
            const T* __restrict__ x, const float* __restrict__ x2,
            const float* __restrict__ y, const float* __restrict__ alpha,
            float* f, int n, int d, int vec_ok, int4* __restrict__ partials,
            int* state) {
  if (state[S_ACTIVE] == 0) return;
  if (blockIdx.x == 0 && threadIdx.x == 0) state[S_RUN_PASS] += 1;
  extern __shared__ float4 smem4[];
  float* r0 = reinterpret_cast<float*>(smem4);   // working row hi, as f32
  float* r1 = r0 + d;                            // working row lo
  __shared__ Best warp_best[kPassThreads / 32];

  for (int k = threadIdx.x; k < 2 * d; k += blockDim.x) r0[k] = to_f32(rows[k]);
  __syncthreads();

  const float d_hi = scal[0], d_lo = scal[1], gamma = scal[2];
  const float w2_hi = scal[3], w2_lo = scal[4], c = scal[5];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  Best best = best_init();

  // One warp per row; rows visited in increasing order within a warp.
  for (long long j = (long long)blockIdx.x * warps + warp; j < n;
       j += (long long)gridDim.x * warps) {
    const T* xr = x + j * d;
    float s0 = 0.0f, s1 = 0.0f;
    if (vec_ok) {
      constexpr int V = 16 / sizeof(T);
#pragma unroll 4
      for (int k = lane * V; k < d; k += 32 * V) {
        float xv[V];
        load16(xr + k, xv);
#pragma unroll
        for (int e = 0; e < V; e += 4) {
          const float4 a = *reinterpret_cast<const float4*>(r0 + k + e);
          const float4 b = *reinterpret_cast<const float4*>(r1 + k + e);
          s0 = fmaf(xv[e], a.x, s0); s0 = fmaf(xv[e + 1], a.y, s0);
          s0 = fmaf(xv[e + 2], a.z, s0); s0 = fmaf(xv[e + 3], a.w, s0);
          s1 = fmaf(xv[e], b.x, s1); s1 = fmaf(xv[e + 1], b.y, s1);
          s1 = fmaf(xv[e + 2], b.z, s1); s1 = fmaf(xv[e + 3], b.w, s1);
        }
      }
    } else {
      for (int k = lane; k < d; k += 32) {
        const float xv = to_f32(xr[k]);
        s0 = fmaf(xv, r0[k], s0);
        s1 = fmaf(xv, r1[k], s1);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (lane == 0) {
      const float xj = x2[j];
      const float k_hi = expf(-gamma * (xj + w2_hi - 2.0f * s0));
      const float k_lo = expf(-gamma * (xj + w2_lo - 2.0f * s1));
      const float fn = f[j] + d_hi * k_hi + d_lo * k_lo;
      f[j] = fn;
      // Keerthi masks on the post-update (alpha, f); y == 0 is in neither.
      const float a = alpha[j], yj = y[j];
      const bool at0 = a == 0.0f, atc = a == c, pos = yj > 0.0f;
      const bool interior = !at0 && !atc, valid = yj != 0.0f;
      const bool in_up = valid && (interior || (at0 && pos) || (atc && !pos));
      const bool in_low = valid && (interior || (at0 && !pos) || (atc && pos));
      const float f_up = in_up ? fn : kSentinel;
      const float f_low = in_low ? fn : -kSentinel;
      const int jj = (int)j;
      if (min_better(f_up, jj, best.up_v, best.up_i)) { best.up_v = f_up; best.up_i = jj; }
      if (max_better(f_low, jj, best.lo_v, best.lo_i)) { best.lo_v = f_low; best.lo_i = jj; }
    }
  }
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    Best b = warp_best[0];
    for (int w = 1; w < warps; ++w) best_merge(b, warp_best[w]);
    partials[blockIdx.x] = make_int4(__float_as_int(b.up_v), b.up_i,
                                     __float_as_int(b.lo_v), b.lo_i);
  }
}

__global__ void __launch_bounds__(kFinalThreads)
finalize_kernel(const int4* __restrict__ partials, int nblocks, int* state) {
  if (state[S_ACTIVE] == 0) return;
  __shared__ Best warp_best[kFinalThreads / 32];
  Best best = best_init();
  for (int k = threadIdx.x; k < nblocks; k += blockDim.x) {
    const int4 p = partials[k];
    best_merge(best, Best{__int_as_float(p.x), p.y, __int_as_float(p.z), p.w});
  }
  best = warp_merge(best);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    Best b = warp_best[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) best_merge(b, warp_best[w]);
    state[S_IHI] = b.up_i;
    state[S_ILO] = b.lo_i;
    if (!state[S_TRAIL]) {   // the trailing body keeps the converged b's
      state[S_BHI] = __float_as_int(b.up_v);
      state[S_BLO] = __float_as_int(b.lo_v);
    }
    state[S_NITER] += 1;
  }
}

// The scalar prologue of one body. It first applies the chunk's loop
// condition (lax.while_loop cond + the trailing do-while body of
// _run_chunk) and sets S_ACTIVE for the pass and the finalize.
template <typename T>
__global__ void __launch_bounds__(kPrologueThreads)
prologue_kernel(int* state, const T* __restrict__ x, const float* __restrict__ x2,
                const float* __restrict__ y, float* alpha, T* rows, float* scal,
                int d, float c, float gamma, float two_eps, int limit,
                int max_iter, int first) {
  __shared__ int go;
  __shared__ float red[3][kPrologueThreads / 32];
  if (threadIdx.x == 0) {
    if (first) { state[S_ENTRY] = state[S_NITER]; state[S_DONE] = 0; }
    int run = 0, trail = 0;
    if (!state[S_DONE]) {
      const float b_hi = __int_as_float(state[S_BHI]);
      const float b_lo = __int_as_float(state[S_BLO]);
      const int it = state[S_NITER];
      if (b_lo > b_hi + two_eps) {          // gap open (NaN: closed)
        if (it < limit) run = 1; else state[S_DONE] = 1;
      } else {
        const bool progressed = it > state[S_ENTRY] || it == 0;
        if (progressed && it < max_iter) { run = 1; trail = 1; }
        state[S_DONE] = 1;
      }
    }
    state[S_ACTIVE] = run;
    state[S_TRAIL] = trail;
    if (run) state[S_RUN_PROLOGUE] += 1;
    go = run;
  }
  __syncthreads();
  if (!go) return;

  const int ih = state[S_IHI], il = state[S_ILO];
  const T* xh = x + (long long)ih * d;
  const T* xl = x + (long long)il * d;
  float p00 = 0.0f, p11 = 0.0f, p01 = 0.0f;
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    const T hv = xh[k], lv = xl[k];
    rows[k] = hv;
    rows[d + k] = lv;
    const float a = to_f32(hv), b = to_f32(lv);
    p00 = fmaf(a, a, p00); p11 = fmaf(b, b, p11); p01 = fmaf(a, b, p01);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    p00 += __shfl_xor_sync(0xffffffffu, p00, o);
    p11 += __shfl_xor_sync(0xffffffffu, p11, o);
    p01 += __shfl_xor_sync(0xffffffffu, p01, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { red[0][warp] = p00; red[1][warp] = p11; red[2][warp] = p01; }
  __syncthreads();
  if (threadIdx.x != 0) return;
  p00 = p11 = p01 = 0.0f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    p00 += red[0][w]; p11 += red[1][w]; p01 += red[2][w];
  }
  const float x2h = x2[ih], x2l = x2[il];
  const float k_hh = expf(-gamma * (2.0f * x2h - 2.0f * p00));
  const float k_ll = expf(-gamma * (2.0f * x2l - 2.0f * p11));
  const float k_hl = expf(-gamma * (x2h + x2l - 2.0f * p01));
  const float eta = k_hh + k_ll - 2.0f * k_hl;
  const float b_hi = __int_as_float(state[S_BHI]);
  const float b_lo = __int_as_float(state[S_BLO]);
  const float y_hi = y[ih], y_lo = y[il];
  const float a_hi = alpha[ih], a_lo = alpha[il];
  const float s = y_lo * y_hi;
  const float a_lo_u = a_lo + y_lo * (b_hi - b_lo) / eta;
  const float a_hi_u = a_hi + s * (a_lo - a_lo_u);
  const float a_lo_n = clip0(a_lo_u, c);
  const float a_hi_n = clip0(a_hi_u, c);
  alpha[il] = a_lo_n;     // lo before hi: i_hi == i_lo keeps the hi value
  alpha[ih] = a_hi_n;
  scal[0] = (a_hi_n - a_hi) * y_hi;   // deltas from the new values
  scal[1] = (a_lo_n - a_lo) * y_lo;
  scal[2] = gamma;
  scal[3] = x2h;
  scal[4] = x2l;
  scal[5] = c;
  scal[6] = 0.0f;
  scal[7] = 0.0f;
}

size_t pass_smem(int d) { return (size_t)2 * d * sizeof(float); }

template <typename T>
int chunk(void* state, const void* x, const void* x2, const void* y,
          void* alpha, void* f, void* rows, void* scal, void* partials,
          int n, int d, float c, float gamma, float two_eps, int limit,
          int max_iter, int iters, int grid, int vec_ok, cudaStream_t s) {
  const size_t smem = pass_smem(d);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(pass_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  for (int t = 0; t < iters; ++t) {
    prologue_kernel<T><<<1, kPrologueThreads, 0, s>>>(
        (int*)state, (const T*)x, (const float*)x2, (const float*)y,
        (float*)alpha, (T*)rows, (float*)scal, d, c, gamma, two_eps, limit,
        max_iter, t == 0);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    pass_kernel<T><<<grid, kPassThreads, smem, s>>>(
        (const T*)rows, (const float*)scal, (const T*)x, (const float*)x2,
        (const float*)y, (const float*)alpha, (float*)f, n, d, vec_ok,
        (int4*)partials, (int*)state);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    finalize_kernel<<<1, kFinalThreads, 0, s>>>((const int4*)partials, grid,
                                                (int*)state);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" {

// Enqueues `iters` SMO iterations (three launches each) on `stream`.
// dtype: 0 = float32 X, 1 = bfloat16 X. Returns the CUDA error code of the
// launches (0 = success) and never synchronises.
int dpsvm_fused_chunk(int dtype, void* state, const void* x, const void* x2,
                      const void* y, void* alpha, void* f, void* rows,
                      void* scal, void* partials, int n, int d, float c,
                      float gamma, float two_eps, int limit, int max_iter,
                      int iters, int grid, int vec_ok, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype)
    return chunk<__nv_bfloat16>(state, x, x2, y, alpha, f, rows, scal,
                                partials, n, d, c, gamma, two_eps, limit,
                                max_iter, iters, grid, vec_ok, s);
  return chunk<float>(state, x, x2, y, alpha, f, rows, scal, partials, n, d,
                      c, gamma, two_eps, limit, max_iter, iters, grid, vec_ok,
                      s);
}

}  // extern "C"
