// The decomposition's inner subsolve for NVIDIA Hopper (sm_90a), with a
// plain C interface loaded through ctypes by
// dpsvm_tpu_torch/experimental/subsolve_kernel.py.
//
// Replaces the Pallas TPU kernel _subsolve_kernel / pallas_inner_subsolve
// (dpsvm_tpu/experimental/subsolve_kernel.py:45-162): the whole capped WSS2
// SMO subsolve of one decomposition round on the (q, q) block K_WW, in one
// launch.
//
// Per step: i_hi = argmin of the I_up scores, b_hi its value, b_lo the max
// of the I_low scores; the WSS2 partner i_lo = argmax over I_low of
// (f_l - b_hi)^2 / max(K_hh + K_ll - 2 K_hl, 1e-12) where f_l - b_hi > 0;
// eta = max(K_hh + K_ll - 2 K_hl, 1e-12); the alpha pair step with the
// independent or the pairwise clip and per-slot boxes; lo written before hi;
// f += (a_hi' - a_hi) y_hi K[i_hi, :] + (a_lo' - a_lo) y_lo K[i_lo, :].
// A step runs while the PREVIOUS step's stored gap is open and t < step_cap
// (gating on the fresh gap would run one step fewer than the JAX loop).
// (b_hi, b_lo) are seeded from the block's entry extrema, so an
// already-optimal block takes no step and returns its input.
//
// Design. Every step depends on the one before it and does three reductions
// over the q slots, so the subsolve is one thread block of 1024 threads
// that loops on the device: one launch per decomposition round. alpha, f
// and the diagonal of K_WW live in shared memory as f32 for the whole loop,
// with one byte per slot holding its I_up / I_low membership (recomputed
// only for the two slots a step changes). At q = 16384, the largest q the
// config admits, that is 13 * 16384 = 212,992 bytes of dynamic shared
// memory, under the 227 KB a block may have. y, the boxes and the active
// flags stay in device memory and are read once per slot at set-up and for
// the two slots of each step.
//
// What bounds it: each step reads two K rows, 2 * q * 4 bytes (96 KB at
// q = 12288) from device memory; K_WW itself (604 MB at q = 12288) is far
// larger than the 50 MB L2, below q ~ 3500 it fits. The arithmetic is a
// few operations per slot per step, so bytes bound it, and at small q the
// latency of the three block-wide reductions of each step.
//
// Order and rounding. Reductions compare (value, index) pairs and the lower
// index wins a tie, across threads and warps, so the result is the first
// index whatever the order: the jnp.argmin / torch.argmin rule. A NaN wins
// its extremum, as there. Every float operation that the plain PyTorch
// version performs as its own elementwise op is written here as an
// explicitly rounded intrinsic (__fadd_rn, __fmul_rn, __fsub_rn, __fdiv_rn):
// no FMA contraction and IEEE division, so the kernel is bitwise equal to
// the plain version on the same inputs.
//
// The one entry is dpsvm_inner_subsolve. The kernel adds one to runs[0]
// when its body runs and its step count t to runs[1]; the host reads both
// words in its poll, so the runs are held against the rounds and the steps
// against the n_iter the carry added up.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 16384;
constexpr float kSentinel = 1.0e9f;
constexpr float kTau = 1.0e-12f;
constexpr unsigned char kUp = 1, kLow = 2;

// (av, ai) better than (bv, bi) for the argmin / argmax: NaN first, then
// the value, then the lower index.
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

// torch.maximum / torch.minimum: NaN if either operand is NaN.
__device__ __forceinline__ float nmax(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
// torch.clamp(v, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
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

// Block-wide merge; every thread gets the result. part has kWarps + 1
// slots: one per warp, then the result.
__device__ __forceinline__ Best block_merge(Best b, Best* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  b = warp_merge(b);
  if (lane == 0) part[warp] = b;
  __syncthreads();
  if (warp == 0) {
    b = warp_merge(part[lane]);
    if (lane == 0) part[kWarps] = b;
  }
  __syncthreads();
  return part[kWarps];
}

// I_up / I_low membership of one slot (ops/selection.py's masks).
__device__ __forceinline__ unsigned char member(float a, float y, float c,
                                               unsigned char act) {
  const bool at0 = a == 0.0f, atc = a == c, pos = y > 0.0f;
  const bool interior = !at0 && !atc;
  const bool up = act && (interior || (at0 && pos) || (atc && !pos));
  const bool low = act && (interior || (at0 && !pos) || (atc && pos));
  return (up ? kUp : 0) | (low ? kLow : 0);
}

// ops/update.py alpha_pair_step, operation for operation.
__device__ void pair_step(float a_hi, float a_lo, float y_hi, float y_lo,
                          float b_hi, float b_lo_sel, float eta, float c_hi,
                          float c_lo, int pairwise, float* a_hi_n,
                          float* a_lo_n) {
  const float s = __fmul_rn(y_lo, y_hi);
  const float a_lo_u = __fadd_rn(
      a_lo, __fdiv_rn(__fmul_rn(y_lo, __fsub_rn(b_hi, b_lo_sel)), eta));
  if (pairwise) {
    const bool pos = s > 0.0f;
    const float ssum = __fadd_rn(a_lo, a_hi);
    const float diff = __fsub_rn(a_hi, a_lo);
    const float lo_b = nmax(0.0f, pos ? __fsub_rn(ssum, c_hi)
                                      : __fsub_rn(a_lo, a_hi));
    const float hi_b = nmin(c_lo, pos ? ssum
                                      : __fsub_rn(__fadd_rn(a_lo, c_hi), a_hi));
    *a_lo_n = nmin(nmax(a_lo_u, lo_b), hi_b);
    const float hi_at_lo = pos ? (lo_b > 0.0f ? c_hi : ssum)
                               : (lo_b > 0.0f ? 0.0f : diff);
    const float hi_at_hi = pos ? (hi_b < c_lo ? 0.0f : __fsub_rn(ssum, c_lo))
                               : (hi_b < c_lo ? c_hi : __fadd_rn(diff, c_lo));
    *a_hi_n = a_lo_u <= lo_b ? hi_at_lo
              : a_lo_u >= hi_b ? hi_at_hi
              : __fadd_rn(a_hi, __fmul_rn(s, __fsub_rn(a_lo, a_lo_u)));
  } else {
    const float a_hi_u = __fadd_rn(a_hi, __fmul_rn(s, __fsub_rn(a_lo, a_lo_u)));
    *a_lo_n = nmin(clamp_min(a_lo_u, 0.0f), c_lo);
    *a_hi_n = nmin(clamp_min(a_hi_u, 0.0f), c_hi);
  }
}

__global__ void __launch_bounds__(kThreads)
subsolve_kernel(const float* __restrict__ k, const float* __restrict__ y,
                const float* __restrict__ c,
                const unsigned char* __restrict__ act,
                const float* __restrict__ a0, const float* __restrict__ f0,
                float* __restrict__ a_out, float* __restrict__ f_out,
                int* __restrict__ out, int* runs, int q, float two_eps,
                int step_cap, int max_cap, int pairwise) {
  extern __shared__ float smem[];
  float* a = smem;                 // alpha of the q slots
  float* f = a + q;                // the subproblem gradient
  float* kd = f + q;               // diag(K_WW)
  unsigned char* code = reinterpret_cast<unsigned char*>(kd + q);
  __shared__ Best part[kWarps + 1];
  __shared__ float s_coef[2];      // the step's f coefficients
  __shared__ int s_lo;             // the step's i_lo

  const int tid = threadIdx.x;
  if (tid == 0) runs[0] += 1;
  for (int j = tid; j < q; j += kThreads) {
    a[j] = a0[j];
    f[j] = f0[j];
    kd[j] = k[(size_t)j * q + j];
    code[j] = member(a0[j], y[j], c[j], act[j]);
  }
  __syncthreads();

  // Entry extrema: the fresh selection of step 0 and the stored gap.
  Best cur = best_init();
  for (int j = tid; j < q; j += kThreads) {
    const unsigned char cd = code[j];
    const float fj = f[j];
    best_merge(cur, Best{(cd & kUp) ? fj : kSentinel, j,
                         (cd & kLow) ? fj : -kSentinel, j});
  }
  cur = block_merge(cur, part);
  float st_bh = cur.up_v, st_bl = cur.lo_v;

  const int cap = min(max_cap, step_cap);
  int t = 0;
  while (t < cap && st_bl > __fadd_rn(st_bh, two_eps)) {
    const int ih = cur.up_i;
    const float bh = cur.up_v, bl = cur.lo_v;
    const float* rh = k + (size_t)ih * q;
    const float kh = kd[ih];

    // WSS2 partner: argmax of the objective over I_low, first index.
    Best sel = best_init();
    for (int j = tid; j < q; j += kThreads) {
      const bool low = code[j] & kLow;
      const float fl = low ? f[j] : -kSentinel;
      const float bb = __fsub_rn(fl, bh);
      const float aa = clamp_min(
          __fsub_rn(__fadd_rn(kh, kd[j]), __fmul_rn(2.0f, rh[j])), kTau);
      const float obj = (low && bb > 0.0f) ? __fdiv_rn(__fmul_rn(bb, bb), aa)
                                           : -1.0f;
      if (max_better(obj, j, sel.lo_v, sel.lo_i)) { sel.lo_v = obj; sel.lo_i = j; }
    }
    sel = block_merge(sel, part);

    if (tid == 0) {
      const int il = sel.lo_i;
      const float bl_sel = (code[il] & kLow) ? f[il] : -kSentinel;
      const float eta = clamp_min(
          __fsub_rn(__fadd_rn(kh, kd[il]), __fmul_rn(2.0f, rh[il])), kTau);
      const float a_hi = a[ih], a_lo = a[il];
      const float y_hi = y[ih], y_lo = y[il];
      float a_hi_n, a_lo_n;
      pair_step(a_hi, a_lo, y_hi, y_lo, bh, bl_sel, eta, c[ih], c[il],
                pairwise, &a_hi_n, &a_lo_n);
      a[il] = a_lo_n;              // lo then hi: i_hi == i_lo keeps hi
      a[ih] = a_hi_n;
      code[il] = member(a[il], y_lo, c[il], act[il]);
      code[ih] = member(a[ih], y_hi, c[ih], act[ih]);
      s_coef[0] = __fmul_rn(__fsub_rn(a_hi_n, a_hi), y_hi);
      s_coef[1] = __fmul_rn(__fsub_rn(a_lo_n, a_lo), y_lo);
      s_lo = il;
    }
    __syncthreads();

    // f update, and the next step's fresh selection on the new state.
    const float ch = s_coef[0], cl = s_coef[1];
    const float* rl = k + (size_t)s_lo * q;
    cur = best_init();
    for (int j = tid; j < q; j += kThreads) {
      const float fj = __fadd_rn(__fadd_rn(f[j], __fmul_rn(ch, rh[j])),
                                 __fmul_rn(cl, rl[j]));
      f[j] = fj;
      const unsigned char cd = code[j];
      best_merge(cur, Best{(cd & kUp) ? fj : kSentinel, j,
                           (cd & kLow) ? fj : -kSentinel, j});
    }
    cur = block_merge(cur, part);
    st_bh = bh;
    st_bl = bl;
    ++t;
  }

  for (int j = tid; j < q; j += kThreads) {
    a_out[j] = a[j];
    f_out[j] = f[j];
  }
  if (tid == 0) {
    out[0] = __float_as_int(st_bh);
    out[1] = __float_as_int(st_bl);
    out[2] = t;
    runs[1] += t;
  }
}

size_t smem_bytes(int q) { return (size_t)q * (3 * sizeof(float) + 1); }

}  // namespace

extern "C" {

// Enqueues one capped subsolve on `stream`: k (q, q), y, c, a0, f0 (q,)
// float32, act (q,) bytes 0/1; writes a, f (q,) and out = [b_hi bits,
// b_lo bits, t]; adds one to runs[0] and t to runs[1]. Returns the CUDA
// error code of the launch (0 = success) and never synchronises.
int dpsvm_inner_subsolve(const void* k, const void* y, const void* c,
                         const void* act, const void* a0, const void* f0,
                         void* a, void* f, void* out, void* runs, int q,
                         float two_eps, int step_cap, int max_cap,
                         int pairwise, void* stream) {
  if (q < 1 || q > kMaxQ) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(q);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(subsolve_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  subsolve_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)k, (const float*)y, (const float*)c,
      (const unsigned char*)act, (const float*)a0, (const float*)f0,
      (float*)a, (float*)f, (int*)out, (int*)runs, q, two_eps, step_cap,
      max_cap, pairwise);
  return (int)cudaGetLastError();
}

}  // extern "C"
