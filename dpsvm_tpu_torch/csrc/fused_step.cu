// Fused SMO iteration for NVIDIA Hopper (sm_90a), with a plain C interface
// loaded through ctypes by dpsvm_tpu_torch/experimental/fused_step.py.
//
// Replaces the Pallas TPU kernel _fused_iter_kernel / fused_update_select
// (dpsvm_tpu/experimental/fused_step.py:55-165) and the XLA scalar prologue
// of fused_smo_body (same file, :193-233).
//
// One SMO iteration is ONE launch of fused_iter_kernel: one 256-thread
// block per SM (fewer for a small n). Each block:
//   0. before the previous launch of the chunk has finished (programmatic
//      dependent launch; the chunk's first launch waits for the stream in
//      full), starts copying its warps' first unit of X into shared memory
//      with cp.async: X does not change within a chunk, so it may be read
//      early, and the copy overlaps the previous launch's tail and this
//      launch's prologue;
//   1. decides from the carry `state` whether this iteration runs at all
//      (the lax.while_loop condition plus the trailing do-while body);
//   2. computes the scalar prologue itself, redundantly: the two working
//      rows x[i_hi], x[i_lo] into shared memory as f32 (2*d*elem bytes a
//      block, from L2 after the first block), their three dot products in
//      one fixed reduction order (every block gets the same bits), eta,
//      the independently clipped alpha pair and the f deltas;
//   3. streams X in units of 4 rows. 85% of the units are dealt to the
//      warps in turn; the rest are taken one at a time from a device
//      counter, so that warps on SMs that get more bandwidth take more
//      (scripts/fused_phases.py on an H100 80GB HBM3 at 700 W: with all
//      units dealt the last block ends ~2.1 us after the first, with the
//      pool 1.0 us in bf16). Units run in a software pipeline: a unit's
//      loads (its rows' x2, f, alpha and y in 4 lanes, one row each; 3
//      rounds x 4 rows of 16-byte X loads a lane; the chunks of its rows
//      past their last whole 32-lane round, d = 784: 2 of 98 in bf16, 4 of
//      196 in f32, spread over the lanes) are issued before the previous
//      unit's reduction and epilogue, and a pool take one unit ahead. Each
//      lane's slice of the working rows is read from shared memory once
//      per 4 rows. The 8 sums are reduced and scattered over the warp in 9
//      shuffles, and 4 lanes run the epilogue of the 4 rows at once: exp,
//      f += d_hi K_hi + d_lo K_lo in place, the Keerthi masks of the
//      post-update alpha, the (value, index) candidates;
//   4. writes one (argmin, argmax) partial and takes a ticket. The block
//      that takes the last ticket reduces the partials and finalises: the
//      next working set [i_hi, i_lo], [b_hi, b_lo] (unless this is the
//      trailing body), n_iter, the alpha pair (lo slot first, then hi, so
//      i_hi == i_lo keeps the hi value), the chunk-loop words, and resets
//      the ticket and the unit counter for the next launch.
//
// What bounds it: per iteration the pass reads X once (n*d*4 bytes in f32,
// n*d*2 in bf16) plus x2, y, alpha, f and writes f: at 60000 x 784 that is
// 189 MB (95 MB) against 4*n*d = 188 MFLOP, far below one flop per byte, so
// HBM bandwidth bounds it and the tensor cores have nothing to do (at two
// rows a wgmma tile would be 97% idle). fp32 FMA accumulates. The design
// keeps bytes in flight (8 warps an SM, each with a unit's 12 16-byte loads
// a lane outstanding while it finishes the unit before) and leaves no
// serial per-row tail. A d that does not fill 16-byte loads takes the same
// path one element at a time (VEC = false).
//
// Order: CUDA blocks run in no order, unlike the TPU grid, whose steps ran
// in sequence and carried the best (value, index) in SMEM. Every reduction
// here compares (value, index) pairs with the lower index winning a tie, so
// the result is the first index whatever the order and whichever warp took
// a unit: the jnp.argmin rule. A NaN score wins its extremum (jnp.argmin
// propagates NaN), so a poisoned f surfaces as a non-finite b that the host
// refuses. A row's sums do not depend on the warp that took it, so a run
// is reproducible.
//
// The hazard: the masks read the post-update alpha, and alpha changes only
// at rows i_hi and i_lo. No block writes alpha during a launch in which
// another block may still read the old alpha of i_hi or i_lo: every block
// uses its own copy of the new pair for those two rows and alpha from
// memory for the others, and only the last block writes alpha, after every
// block has taken its ticket (a block takes it after its last read). The
// same holds for the carry words the blocks decide from (i_hi, i_lo, b's,
// n_iter, the chunk-loop words): only the last block writes them. The one
// exception is a launch whose body does not run: block 0 then marks the
// chunk done (and records its entry), and a block that reads the mark
// exits just as it would have decided to.
//
// The host never synchronises inside a chunk: the working set stays in the
// device carry `state`, and a device flag turns the launches left in a
// chunk into no-ops once the gap has closed (plus the one trailing
// do-while body) or the chunk's iteration limit is reached.
//
// The only entry point is dpsvm_fused_chunk. Block 0 counts the launches
// whose body ran (S_RUN); the last block advances S_NITER. The host reads
// both in its one poll, so the run count is checked against the
// iterations independently. Block 0 also writes the prologue's rows and
// scalars to the workspace, where nothing in the launch reads them.
//
// Resources (nvcc -Xptxas -v, CUDA 12.8): 180 registers a thread in f32 and
// 193 in bf16 on the vector path, 95 on the scalar path, no spills; one
// 256-thread block (8 of 64 warps) an SM; 55.4 KB of shared memory at
// d = 784 on the vector path. More warps cap the registers below what the
// pipeline holds: at 16 warps (128 registers) it spills and an iteration
// takes 16% (f32) and 24% (bf16) longer (scripts/fused_phases.py, H100
// 80GB HBM3 at 700 W).

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
  S_DONE = 5,    // no more bodies in this chunk
  S_ENTRY = 6,   // n_iter at chunk entry (the progress gate)
  S_RUN = 7,     // launches whose body ran, ever
  S_TICKET = 8,  // blocks finished in the current launch
  S_CURSOR = 9,  // units taken from the shared pool in the current launch
};

constexpr int kWarps = 8;                  // WARPS in fused_step.py
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 4;                  // rows of a unit (GROUP)
constexpr int kStaticShare = 85;           // % dealt in turn (STATIC_SHARE)
constexpr int kUnroll = 3;                 // rounds loaded ahead (UNROLL)
constexpr float kSentinel = 1.0e9f;
constexpr int kGeometryMismatch = -1;      // the caller's smem bytes differ

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A chunk of X: 16 bytes (VEC) or one element, loaded raw and widened to
// f32 where it is used.
template <typename T, bool VEC> struct Chunk;
template <> struct Chunk<float, true> {
  static constexpr int V = 4;
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void widen(const Raw& r, float* o) {
    o[0] = r.x; o[1] = r.y; o[2] = r.z; o[3] = r.w;
  }
};
template <> struct Chunk<__nv_bfloat16, true> {
  static constexpr int V = 8;
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void widen(const Raw& r, float* o) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {          // bf16 -> f32 is exact: a shift
      o[2 * e] = __uint_as_float(w[e] << 16);
      o[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
};
template <typename T> struct Chunk<T, false> {
  static constexpr int V = 1;
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return __ldg(p); }
  static __device__ __forceinline__ void widen(const Raw& r, float* o) {
    o[0] = to_f32(r);
  }
};

// V floats of a working row from shared memory.
template <int V>
__device__ __forceinline__ void row_slice(const float* r, float* w) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      const float4 t = *reinterpret_cast<const float4*>(r + e);
      w[e] = t.x; w[e + 1] = t.y; w[e + 2] = t.z; w[e + 3] = t.w;
    }
  } else {
    w[0] = r[0];
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

// One chunk against both working rows, added to the accumulators of row
// r of the unit (r known only at run time: predicated adds).
template <typename CK>
__device__ __forceinline__ void add_chunk(const typename CK::Raw& raw,
                                          const float* w0p, const float* w1p,
                                          int r, float (&acc)[8]) {
  constexpr int V = CK::V;
  float xv[V], w0[V], w1[V];
  CK::widen(raw, xv);
  row_slice<V>(w0p, w0);
  row_slice<V>(w1p, w1);
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    s0 = fmaf(xv[e], w0[e], s0);
    s1 = fmaf(xv[e], w1[e], s1);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q == r) { acc[2 * q] += s0; acc[2 * q + 1] += s1; }
  }
}

// Sums each of 8 per-lane values over the warp in 9 shuffles (reduce-
// scatter, then a butterfly over the lanes left). Lane l returns the sum
// of value 4 b4 + 2 b3 + b2, where bk is bit k of l.
__device__ __forceinline__ float reduce_scatter8(float (&v)[8], int lane) {
  const bool b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = b4 ? v[i] : v[i + 4];
    const float keep = b4 ? v[i + 4] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = b3 ? v[i] : v[i + 2];
    const float keep = b3 ? v[i + 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float send = b2 ? v[0] : v[1];
  const float keep = b2 ? v[1] : v[0];
  float s = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s;
}

// 16 bytes from global to shared memory without registers (cp.async).
template <typename Raw>
__device__ __forceinline__ void cp_async16(Raw* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The block's ticket: an acquire-release add at device scope, so the
// block's partial is visible before its ticket, and the last block sees
// every partial (read from L2 with __ldcg) after taking its own.
__device__ __forceinline__ int take_ticket(int* p) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;"
               : "=r"(old) : "l"(p) : "memory");
  return old;
}

// Programmatic dependent launch: wait for the previous launch on the
// stream to finish and flush, then let the next one be scheduled onto SMs
// as they free up, so it waits here instead of in the launch queue.
__device__ __forceinline__ void pdl_wait_then_release() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// jnp.clip: NaN stays NaN (fminf/fmaxf alone would drop it).
__device__ __forceinline__ float clip0(float v, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), hi);
}

__host__ __device__ __forceinline__ int padded_d(int d) { return (d + 3) & ~3; }

// Dynamic shared memory: the two working rows as f32, each padded to a
// float4; on the vector path, then, each warp's first trip of X
// (kPreChunks 16-byte chunks).
constexpr int kPreChunks = kUnroll * kGroup * 32;
__host__ __device__ __forceinline__ size_t smem_bytes(int d, bool vec) {
  return sizeof(float) * (size_t)2 * padded_d(d) +
         (vec ? (size_t)kWarps * kPreChunks * 16 : 0);
}

struct Params {
  int* state;
  const void* x;
  const float* x2;
  const float* y;
  float* alpha;
  float* f;
  void* rows;
  float* scal;
  int4* partials;
  int n, d, tail;
  float c, gamma, two_eps;
  int limit, max_iter, first;
};

// The pass's view of one launch: X, the vectors, the working rows in
// shared memory and the prologue's scalars.
template <typename T, bool VEC>
struct Pass {
  using CK = Chunk<T, VEC>;
  using Raw = typename CK::Raw;
  static constexpr int V = CK::V;
  const T* x;
  const float *x2, *y, *alpha;
  float* f;
  const float *r0, *r1;                // working rows hi, lo as f32
  int n, d, full, tail, lane, ih, il;
  float gamma, c, x2h, x2l, d_hi, d_lo, a_hi_n, a_lo_n;

  // Starts copying the lane's slice of the first kUnroll whole rounds of
  // unit u's rows into `pre` (this warp's kUnroll * kGroup * 32 chunks of
  // shared memory), asynchronously (vector path only).
  __device__ __forceinline__ void first_trip(int u, Raw* pre) const {
#pragma unroll
    for (int v = 0; v < kUnroll; ++v) {
      if (v < full) {
#pragma unroll
        for (int r = 0; r < kGroup; ++r)
          cp_async16(pre + (v * kGroup + r) * 32 + lane,
                     row_ptr(u, r) + v * 32 * V);
      }
    }
  }

  __device__ __forceinline__ const T* row_ptr(int u, int r) const {
    return x + (long long)min(u * kGroup + r, n - 1) * d + lane * V;
  }

  // What a unit needs from memory before its dot products: the first trip
  // of whole rounds, the first round of tail chunks (tail chunk idx of the
  // unit: row idx / tail, chunk full * 32 + idx % tail), and, in lanes
  // 8 r, row r's x2, f, alpha and y for the epilogue.
  struct Loads {
    Raw raw[kUnroll][kGroup];
    Raw t_raw;
    float ev[4];
  };

  // Issues unit u's loads; with `pre`, the first trip comes from the
  // early copy instead.
  __device__ __forceinline__ void issue(int u, Loads& l,
                                        const Raw* pre = nullptr) const {
    const int tail_n = kGroup * tail;
    if (lane < tail_n) {
      const int r = lane / tail;
      l.t_raw = CK::load(x + (long long)min(u * kGroup + r, n - 1) * d +
                         (full * 32 + lane - r * tail) * V);
    }
    const int row = u * kGroup + (lane >> 3);
    if ((lane & 7) == 0 && row < n) {
      l.ev[0] = x2[row]; l.ev[1] = f[row]; l.ev[2] = alpha[row]; l.ev[3] = y[row];
    }
    if (pre != nullptr) cp_async_wait_all();
#pragma unroll
    for (int v = 0; v < kUnroll; ++v) {
      if (v < full) {
#pragma unroll
        for (int r = 0; r < kGroup; ++r)
          l.raw[v][r] = pre != nullptr
                            ? pre[(v * kGroup + r) * 32 + lane]
                            : CK::load(row_ptr(u, r) + v * 32 * V);
      }
    }
  }

  __device__ __forceinline__ void fma_trip(int k0,
                                           const Raw (&raw)[kUnroll][kGroup],
                                           float (&acc)[8]) const {
#pragma unroll
    for (int v = 0; v < kUnroll; ++v) {
      if (k0 + v < full) {
        const int col = ((k0 + v) * 32 + lane) * V;
        float w0[V], w1[V];
        row_slice<V>(r0 + col, w0);
        row_slice<V>(r1 + col, w1);
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          float xv[V];
          CK::widen(raw[v][r], xv);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            acc[2 * r] = fmaf(xv[e], w0[e], acc[2 * r]);
            acc[2 * r + 1] = fmaf(xv[e], w1[e], acc[2 * r + 1]);
          }
        }
      }
    }
  }

  // Unit u's dot products with both working rows: the first trip from
  // `l`, the later trips loaded here, then the tail chunks.
  __device__ __forceinline__ void accumulate(int u, const Loads& l,
                                             float (&acc)[8]) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
    fma_trip(0, l.raw, acc);
#pragma unroll 1
    for (int k0 = kUnroll; k0 < full; k0 += kUnroll) {
      Raw raw[kUnroll][kGroup];
#pragma unroll
      for (int v = 0; v < kUnroll; ++v) {
        if (k0 + v < full) {
#pragma unroll
          for (int r = 0; r < kGroup; ++r)
            raw[v][r] = CK::load(row_ptr(u, r) + (k0 + v) * 32 * V);
        }
      }
      fma_trip(k0, raw, acc);
    }
    const int tail_n = kGroup * tail;
    if (lane < tail_n) {
      const int r = lane / tail;
      const int col = (full * 32 + lane - r * tail) * V;
      add_chunk<CK>(l.t_raw, r0 + col, r1 + col, r, acc);
    }
    for (int idx = 32 + lane; idx < tail_n; idx += 32) {   // odd widths only
      const int r = idx / tail;
      const int col = (full * 32 + idx - r * tail) * V;
      add_chunk<CK>(CK::load(x + (long long)min(u * kGroup + r, n - 1) * d +
                             col),
                    r0 + col, r1 + col, r, acc);
    }
  }

  // Unit u's epilogue, 4 rows at once (lane 8 r + 4 w holds side w of row
  // r after the reduction): exp, the f update in place, the Keerthi masks
  // of the post-update alpha, the candidates.
  __device__ __forceinline__ void finish(int u, float (&acc)[8],
                                         const float (&ev)[4],
                                         Best& best) const {
    const float s0 = reduce_scatter8(acc, lane);
    const float s1 = __shfl_down_sync(0xffffffffu, s0, 4);
    const int row = u * kGroup + (lane >> 3);
    if ((lane & 7) != 0 || row >= n) return;
    const float x2v = ev[0], fv = ev[1], av = ev[2], yv = ev[3];
    const float k_hi = expf(-gamma * (x2v + x2h - 2.0f * s0));
    const float k_lo = expf(-gamma * (x2v + x2l - 2.0f * s1));
    const float fn = fv + d_hi * k_hi + d_lo * k_lo;
    f[row] = fn;
    // y == 0 is in neither set. The hi value wins when i_hi == i_lo, as
    // the finalize writes it.
    const float a = row == ih ? a_hi_n : (row == il ? a_lo_n : av);
    const bool at0 = a == 0.0f, atc = a == c, pos = yv > 0.0f;
    const bool interior = !at0 && !atc, valid = yv != 0.0f;
    const bool in_up = valid && (interior || (at0 && pos) || (atc && !pos));
    const bool in_low = valid && (interior || (at0 && !pos) || (atc && pos));
    const float f_up = in_up ? fn : kSentinel;
    const float f_low = in_low ? fn : -kSentinel;
    if (min_better(f_up, row, best.up_v, best.up_i)) { best.up_v = f_up; best.up_i = row; }
    if (max_better(f_low, row, best.lo_v, best.lo_i)) { best.lo_v = f_low; best.lo_i = row; }
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
fused_iter_kernel(Params p) {
  using P = Pass<T, VEC>;
  extern __shared__ float4 smem4[];
  __shared__ int ctl[6];               // run, trail, i_hi, i_lo, n_iter, entry
  __shared__ float red[3][kWarps];
  __shared__ Best wbest[kWarps];
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* state = p.state;
  const int n = p.n, d = p.d, tail = p.tail;
  const T* xg = static_cast<const T*>(p.x);

  // ---- 0. before the previous launch has finished: the units of the pass
  // (kGroup rows; the first kStaticShare % dealt to the warps in turn, the
  // rest taken one at a time from a device counter, so that a warp on a
  // fast SM takes more), and the first trip of this warp's first dealt
  // unit. X never changes, so it may be read before the wait.
  const int full = (d / P::V) >> 5;    // whole 32-chunk rounds per row
  const int units = (n + kGroup - 1) / kGroup;
  const int gwarps = gridDim.x * kWarps;
  const int gw = blockIdx.x * kWarps + warp;
  const int dealt =
      (int)((long long)units * kStaticShare / 100 / gwarps) * gwarps;
  P pass;
  pass.x = xg; pass.n = n; pass.d = d; pass.full = full; pass.tail = tail;
  pass.lane = lane;
  float* r0 = reinterpret_cast<float*>(smem4);     // working row hi, f32
  float* r1 = r0 + padded_d(d);                    // working row lo
  typename P::Raw* pre = reinterpret_cast<typename P::Raw*>(
      r0 + 2 * padded_d(d)) + warp * kPreChunks;
  if (VEC && gw < dealt) pass.first_trip(gw, pre);
  pdl_wait_then_release();

  // ---- 1. the chunk loop's condition
  if (tid == 0) {
    const int nit = state[S_NITER];
    const int done = p.first ? 0 : state[S_DONE];
    const int entry = p.first ? nit : state[S_ENTRY];
    int run = 0, trail = 0;
    if (!done) {
      const float b_hi = __int_as_float(state[S_BHI]);
      const float b_lo = __int_as_float(state[S_BLO]);
      if (b_lo > b_hi + p.two_eps) {        // gap open (NaN: closed)
        run = nit < p.limit;
      } else if ((nit > entry || nit == 0) && nit < p.max_iter) {
        run = 1;
        trail = 1;
      }
      if (blockIdx.x == 0) {
        if (run) {
          state[S_RUN] += 1;
        } else {
          state[S_DONE] = 1;
          if (p.first) state[S_ENTRY] = entry;
        }
      }
    }
    ctl[0] = run;
    ctl[1] = trail;
    ctl[2] = state[S_IHI];
    ctl[3] = state[S_ILO];
    ctl[4] = nit;
    ctl[5] = entry;
  }
  __syncthreads();
  if (!ctl[0]) return;

  // ---- 2. the scalar prologue, the same in every block. The warp's
  // first units from the pool, if it starts there, are taken first, so
  // that the takes overlap the prologue.
  int* cursor = &state[S_CURSOR];
  const bool cur_pool = gw >= dealt, nxt_pool = gw + gwarps >= dealt;
  int got_cur = 0, got_nxt = 0;
  if (lane == 0) {
    if (cur_pool) got_cur = atomicAdd(cursor, 1);
    if (nxt_pool) got_nxt = atomicAdd(cursor, 1);
  }
  const int ih = ctl[2], il = ctl[3];
  const float c = p.c, gamma = p.gamma;
  const float x2h = p.x2[ih], x2l = p.x2[il];
  const float y_hi = p.y[ih], y_lo = p.y[il];
  const float a_hi = p.alpha[ih], a_lo = p.alpha[il];
  const float b_hi = __int_as_float(state[S_BHI]);
  const float b_lo = __int_as_float(state[S_BLO]);
  {
    const T* xh = xg + (long long)ih * d;
    const T* xl = xg + (long long)il * d;
    T* rows_out = static_cast<T*>(p.rows);
    float p00 = 0.0f, p11 = 0.0f, p01 = 0.0f;
    for (int k = tid; k < d; k += kThreads) {
      const T hv = xh[k], lv = xl[k];
      const float a = to_f32(hv), b = to_f32(lv);
      r0[k] = a;
      r1[k] = b;
      if (blockIdx.x == 0) {
        rows_out[k] = hv;
        rows_out[d + k] = lv;
      }
      p00 = fmaf(a, a, p00); p11 = fmaf(b, b, p11); p01 = fmaf(a, b, p01);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      p00 += __shfl_xor_sync(0xffffffffu, p00, o);
      p11 += __shfl_xor_sync(0xffffffffu, p11, o);
      p01 += __shfl_xor_sync(0xffffffffu, p01, o);
    }
    if (lane == 0) { red[0][warp] = p00; red[1][warp] = p11; red[2][warp] = p01; }
  }
  __syncthreads();
  float p00 = 0.0f, p11 = 0.0f, p01 = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {   // one order in every thread and block
    p00 += red[0][w]; p11 += red[1][w]; p01 += red[2][w];
  }
  const float k_hh = expf(-gamma * (2.0f * x2h - 2.0f * p00));
  const float k_ll = expf(-gamma * (2.0f * x2l - 2.0f * p11));
  const float k_hl = expf(-gamma * (x2h + x2l - 2.0f * p01));
  const float eta = k_hh + k_ll - 2.0f * k_hl;
  const float s = y_lo * y_hi;
  const float a_lo_u = a_lo + y_lo * (b_hi - b_lo) / eta;
  const float a_hi_u = a_hi + s * (a_lo - a_lo_u);
  const float a_lo_n = clip0(a_lo_u, c);
  const float a_hi_n = clip0(a_hi_u, c);
  const float d_hi = (a_hi_n - a_hi) * y_hi;   // deltas from the new values
  const float d_lo = (a_lo_n - a_lo) * y_lo;
  if (blockIdx.x == 0 && tid == 0) {
    p.scal[0] = d_hi; p.scal[1] = d_lo; p.scal[2] = gamma;
    p.scal[3] = x2h;  p.scal[4] = x2l;  p.scal[5] = c;
    p.scal[6] = 0.0f; p.scal[7] = 0.0f;
  }

  // ---- 3. the pass
  pass.x2 = p.x2; pass.y = p.y; pass.alpha = p.alpha; pass.f = p.f;
  pass.r0 = r0; pass.r1 = r1; pass.ih = ih; pass.il = il;
  pass.gamma = gamma; pass.c = c; pass.x2h = x2h; pass.x2l = x2l;
  pass.d_hi = d_hi; pass.d_lo = d_lo; pass.a_hi_n = a_hi_n;
  pass.a_lo_n = a_lo_n;
  // Units in a pipeline: the next unit's loads are issued before this
  // one's reduction and epilogue, and the take of the unit after it
  // before this one's dot products.
  Best best = best_init();
  int cur = cur_pool ? dealt + __shfl_sync(0xffffffffu, got_cur, 0) : gw;
  int nxt = nxt_pool ? dealt + __shfl_sync(0xffffffffu, got_nxt, 0)
                     : gw + gwarps;
  typename P::Loads l;
  if (cur < units) pass.issue(cur, l, VEC && !cur_pool ? pre : nullptr);
  while (cur < units) {
    const bool take = nxt < units && nxt + gwarps >= dealt;
    int got = 0;
    if (take && lane == 0) got = atomicAdd(cursor, 1);
    float acc[8];
    pass.accumulate(cur, l, acc);
    float ev[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ev[i] = l.ev[i];
    if (nxt < units) pass.issue(nxt, l);
    pass.finish(cur, acc, ev, best);
    cur = nxt;
    nxt = take ? dealt + __shfl_sync(0xffffffffu, got, 0) : nxt + gwarps;
  }

  // ---- 4. the block's partial, the ticket, and the last block's finalize
  best = warp_merge(best);
  if (lane == 0) wbest[warp] = best;
  __syncthreads();
  if (tid == 0) {
    Best b = wbest[0];
    for (int w = 1; w < kWarps; ++w) best_merge(b, wbest[w]);
    p.partials[blockIdx.x] = make_int4(__float_as_int(b.up_v), b.up_i,
                                       __float_as_int(b.lo_v), b.lo_i);
    is_last = take_ticket(&state[S_TICKET]) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  Best b = best_init();
  for (int k = tid; k < (int)gridDim.x; k += kThreads) {
    const int4 q = __ldcg(&p.partials[k]);
    best_merge(b, Best{__int_as_float(q.x), q.y, __int_as_float(q.z), q.w});
  }
  b = warp_merge(b);
  if (lane == 0) wbest[warp] = b;
  __syncthreads();
  if (tid == 0) {
    b = wbest[0];
    for (int w = 1; w < kWarps; ++w) best_merge(b, wbest[w]);
    const int trail = ctl[1];
    state[S_IHI] = b.up_i;
    state[S_ILO] = b.lo_i;
    if (!trail) {                  // the trailing body keeps the converged b's
      state[S_BHI] = __float_as_int(b.up_v);
      state[S_BLO] = __float_as_int(b.lo_v);
    }
    state[S_NITER] = ctl[4] + 1;
    state[S_ENTRY] = ctl[5];
    state[S_DONE] = trail;
    p.alpha[il] = a_lo_n;          // lo before hi: i_hi == i_lo keeps hi
    p.alpha[ih] = a_hi_n;
    state[S_CURSOR] = 0;
    state[S_TICKET] = 0;
  }
}

template <typename T, bool VEC>
int chunk(Params p, int iters, int grid, size_t smem, cudaStream_t s) {
  p.tail = (p.d / Chunk<T, VEC>::V) % 32;
  if (smem != smem_bytes(p.d, VEC)) return kGeometryMismatch;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(fused_iter_kernel<T, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (int t = 0; t < iters; ++t) {
    p.first = t == 0;
    // The chunk's first launch waits for the stream's earlier work in
    // full: the kernel before it may have written X, which the early copy
    // reads before griddepcontrol.wait.
    cfg.numAttrs = t == 0 ? 0 : 1;
    e = cudaLaunchKernelEx(&cfg, fused_iter_kernel<T, VEC>, p);
    if (e != cudaSuccess || (e = cudaGetLastError()) != cudaSuccess)
      return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" {

// Enqueues `iters` SMO iterations (one launch each) on `stream`.
// dtype: 0 = float32 X, 1 = bfloat16 X; vec: every row of X fills whole,
// aligned 16-byte loads. `grid` and `smem` are the launch geometry of
// fused_step.launch_geometry; -1 if `smem` is not this source's layout.
// Otherwise returns the CUDA error code of the launches (0 = success) and
// never synchronises.
int dpsvm_fused_chunk(int dtype, void* state, const void* x, const void* x2,
                      const void* y, void* alpha, void* f, void* rows,
                      void* scal, void* partials, int n, int d, float c,
                      float gamma, float two_eps, int limit, int max_iter,
                      int iters, int grid, int vec, int smem, void* stream) {
  Params p{(int*)state, x, (const float*)x2, (const float*)y, (float*)alpha,
           (float*)f, rows, (float*)scal, (int4*)partials, n, d, 0, c, gamma,
           two_eps, limit, max_iter, 0};
  cudaStream_t s = (cudaStream_t)stream;
  const size_t sm = (size_t)smem;
  if (dtype)
    return vec ? chunk<__nv_bfloat16, true>(p, iters, grid, sm, s)
               : chunk<__nv_bfloat16, false>(p, iters, grid, sm, s);
  return vec ? chunk<float, true>(p, iters, grid, sm, s)
             : chunk<float, false>(p, iters, grid, sm, s);
}

}  // extern "C"
