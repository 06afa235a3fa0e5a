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
// What bounds it: every step depends on the one before it. A step reads
// two K rows (2 * q * 4 bytes, 96 KB at q = 12288) and does two reductions
// over the q slots, one for the partner and one for the next i_hi, each
// followed by work that needs its result. So a step costs two dependent
// row reads and two dependent reductions; the bytes alone would take
// ~0.03 us. The design cuts the latency of each of the four.
//
// Design. One launch is one thread-block cluster of up to 16 blocks on
// neighbouring SMs (launch_geometry in the wrapper gives its shape; below a
// measured q it is one block). Block r owns the contiguous slots
// [r * slots, (r + 1) * slots); alpha, f, diag(K_WW), y, c and a code byte
// (I_up, I_low, active) of its slots live in its shared memory, 21 bytes a
// slot. Within a block, thread t owns the slot pairs 2 (t + T p) + {0, 1},
// p < PER, for the whole launch: it is the only thread that reads or writes
// them, so a step needs no barrier outside its two reductions.
//
// - Row reads: each thread issues the loads of its pairs of a row (8-byte
//   loads for even q, scalar loads for odd q) as soon as the reduction
//   before names the row, before it uses any. The hi row stays in
//   registers from the partner pass to the f pass; the lo row's loads are
//   in flight while the scalar step runs.
// - Reductions: a (value, index) pair is one 64-bit key whose integer
//   order is the reduction's, so a warp reduces it with two 32-bit redux
//   instructions and takes the winner's payload by shuffles. The warps'
//   records meet in shared memory behind one block barrier; warp 0
//   reduces them and its lanes 0 .. csize-1 store the block's record
//   into slot [rank] of every block's exchange buffer with st.async,
//   which counts the bytes on that block's mbarrier: no barrier across
//   the cluster, only each block's wait for its csize records. Every warp
//   then reduces those records itself, so every block holds the same bits
//   and takes the same branch of the loop condition. The partner exchange
//   and the i_hi exchange use two buffers, so a fast block's next records
//   never overwrite ones a slower block has not read.
// - The records carry what the scalar step needs: the I_up winner its f,
//   index, alpha, y, c and K_jj; the partner its objective, index, alpha,
//   y, c, its I_low score and the clamped eta its pass computed (the same
//   expression as the JAX kernel's eta, so the same bits). Every thread
//   runs the pair step itself; the threads that own i_lo and i_hi write
//   their alpha (lo first) and code byte. No thread reads device memory in
//   the scalar part.
//
// Two earlier versions, measured by scripts/subsolve_phases.py (PERF.md):
// plain stores into the other blocks' shared memory and a cluster barrier
// after a block reduction by shuffle trees (two exchanges 5.3 us of a
// 6.8 us step at q = 12288, cluster 16); and one st.async record per warp
// rather than per block (3.4 us of 4.5 us).
//
// Order and rounding. Reductions compare (value, index) pairs and the lower
// index wins a tie, across lanes, warps and blocks, so the result is the
// first index whatever the order: the jnp.argmin / torch.argmin rule. A NaN
// wins its extremum, as there. Every float operation that the plain
// PyTorch version performs as its own elementwise op is written here as an
// explicitly rounded intrinsic (__fadd_rn, __fmul_rn, __fsub_rn,
// __fdiv_rn): no FMA contraction and IEEE division, so the kernel is
// bitwise equal to the plain version on the same inputs.
//
// The one entry is dpsvm_inner_subsolve. Block 0 adds one to runs[0] when
// the body runs and the step count t to runs[1]; the host reads both words
// in its poll, so the runs are held against the rounds and the steps
// against the n_iter the carry added up.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Timing hooks, empty here: scripts/subsolve_phases.py builds a copy of
// this source that defines them to stamp the phases of each step.
#ifndef PHASE_BEGIN
#define PHASE_BEGIN
#define PHASE(k, v)
#define PHASE_END(t)
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxQ = 16384;
constexpr int kMaxCluster = 16;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxPer = 8;
constexpr int kSlotBytes = 5 * sizeof(float) + 1;   // a, f, diag, y, c, code
constexpr int kGeometryMismatch = -1;     // not launch_geometry's shape
constexpr int kClusterUnschedulable = -2; // no SMs for one such cluster
constexpr unsigned kFull = 0xffffffffu;
constexpr float kSentinel = 1.0e9f;
constexpr float kTau = 1.0e-12f;
constexpr unsigned char kUp = 1, kLow = 2, kAct = 4;

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

// I_up / I_low membership of one slot (ops/selection.py's masks), with the
// slot's active flag kept beside it.
__device__ __forceinline__ unsigned char member(float a, float y, float c,
                                               bool act) {
  const bool at0 = a == 0.0f, atc = a == c, pos = y > 0.0f;
  const bool interior = !at0 && !atc;
  const bool up = act && (interior || (at0 && pos) || (atc && !pos));
  const bool low = act && (interior || (at0 && !pos) || (atc && pos));
  return (up ? kUp : 0) | (low ? kLow : 0) | (act ? kAct : 0);
}

// ops/update.py alpha_pair_step, operation for operation.
__device__ __forceinline__ void pair_step(float a_hi, float a_lo, float y_hi,
                                          float y_lo, float b_hi,
                                          float b_lo_sel, float eta,
                                          float c_hi, float c_lo, int pairwise,
                                          float* a_hi_n, float* a_lo_n) {
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

// A (value, index) pair as one 64-bit key whose unsigned order is the
// reductions' order: NaN first, then the value (-0 == +0), then the lower
// index. key_min orders by increasing value (the argmin), key_max by
// decreasing value (the argmax). No value maps to the NaN's 0 or to the
// empty record's all-ones.
__device__ __forceinline__ unsigned ordered(float v) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ unsigned long long key_min(float v, int j) {
  return ((unsigned long long)(isnan(v) ? 0u : ordered(v)) << 32) | (unsigned)j;
}
__device__ __forceinline__ unsigned long long key_max(float v, int j) {
  return ((unsigned long long)(isnan(v) ? 0u : ~ordered(v)) << 32) | (unsigned)j;
}
__device__ __forceinline__ int key_index(unsigned long long k) {
  return (int)(unsigned)k;
}

// One reduction's record: 48 bytes, three 16-byte stores. The i_hi
// exchange: key = the I_up argmin's key_min, v its score, key2 / v2 the
// I_low max's key_max and score, and a, y, c, x the argmin slot's alpha,
// label, box and K_jj. The partner exchange (PAIR): key = the objective's
// key_max, v2 the slot's I_low score, x its clamped eta; key2 unused.
struct alignas(16) Rec {
  unsigned long long key, key2;
  float v, v2, a, y, c, x, pad0, pad1;
};
static_assert(sizeof(Rec) == 48, "a record is three 16-byte stores");

__device__ __forceinline__ Rec rec_none() {
  return Rec{~0ull, ~0ull, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
}

// The min of a key over the warp, in every lane: two 32-bit reductions.
__device__ __forceinline__ unsigned long long warp_min(unsigned long long k) {
  const unsigned hi = __reduce_min_sync(kFull, (unsigned)(k >> 32));
  const unsigned lo =
      __reduce_min_sync(kFull, (unsigned)(k >> 32) == hi ? (unsigned)k : ~0u);
  return ((unsigned long long)hi << 32) | lo;
}

// The warp's best record, in every lane: the keys' minima and the
// winners' payloads from the lanes that hold them (keys are unique).
template <bool PAIR>
__device__ __forceinline__ Rec warp_best(const Rec& r) {
  Rec w = rec_none();
  w.key = warp_min(r.key);
  const int s = __ffs(__ballot_sync(kFull, r.key == w.key)) - 1;
  w.v = __shfl_sync(kFull, r.v, s);
  w.a = __shfl_sync(kFull, r.a, s);
  w.y = __shfl_sync(kFull, r.y, s);
  w.c = __shfl_sync(kFull, r.c, s);
  w.x = __shfl_sync(kFull, r.x, s);
  if (PAIR) {
    w.v2 = __shfl_sync(kFull, r.v2, s);
  } else {
    w.key2 = warp_min(r.key2);
    const int s2 = __ffs(__ballot_sync(kFull, r.key2 == w.key2)) - 1;
    w.v2 = __shfl_sync(kFull, r.v2, s2);
  }
  return w;
}

template <bool PAIR>
__device__ __forceinline__ void take(Rec& b, const Rec& q) {
  if (q.key < b.key) {
    b.key = q.key; b.v = q.v; b.a = q.a; b.y = q.y; b.c = q.c; b.x = q.x;
    if (PAIR) b.v2 = q.v2;
  }
  if (!PAIR && q.key2 < b.key2) { b.key2 = q.key2; b.v2 = q.v2; }
}

// Shared-memory addresses, mbarriers and stores into another block's
// shared memory (PTX for sm_90).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, unsigned rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}
// The local thread's arrival for the barrier's current phase, which then
// completes once `bytes` more have been stored into this block with it.
__device__ __forceinline__ void mbar_expect(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// 16 bytes into another block's shared memory, counted by its mbarrier.
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t bar,
                                         unsigned a, unsigned b, unsigned c,
                                         unsigned d) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(addr), "r"(a), "r"(b), "r"(c), "r"(d), "r"(bar) : "memory");
}

// Every thread of the cluster arrives; what each did before it is seen by
// every thread after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The cluster-wide reduction of every thread's record r; every thread of
// every block gets the same result. Each warp reduces its records into
// part[warp]; after one block barrier warp 0 reduces those, and its lanes
// 0 .. csize-1 store the block's record into slot [rank] of every block's
// buffer `buf` with st.async, which counts the bytes on that block's
// mbarrier `bar`. Each block waits for its csize records, re-arms the
// barrier for the buffer's next use, and every warp reduces the records
// itself. A block's next records for this buffer come only after every
// block has sent on the other one, which it does after reading this one,
// so no record is overwritten before it is read; part is reused only
// after the wait, so after warp 0 has read it.
template <bool PAIR>
__device__ __forceinline__ Rec exchange(const Rec& r, Rec* part, Rec* buf,
                                        uint32_t bar, unsigned& parity,
                                        int csize, unsigned rank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Rec w = warp_best<PAIR>(r);
  if (lane == 0) part[warp] = w;
  __syncthreads();
  if (warp == 0) {
    w = warp_best<PAIR>(lane < (int)(blockDim.x >> 5) ? part[lane] : rec_none());
    if (lane < csize) {
      const uint32_t dst = map_rank(smem_u32(buf + rank), lane);
      const uint32_t mb = map_rank(bar, lane);
      st_async(dst, mb, (unsigned)w.key, (unsigned)(w.key >> 32),
               (unsigned)w.key2, (unsigned)(w.key2 >> 32));
      st_async(dst + 16, mb, __float_as_uint(w.v), __float_as_uint(w.v2),
               __float_as_uint(w.a), __float_as_uint(w.y));
      st_async(dst + 32, mb, __float_as_uint(w.c), __float_as_uint(w.x), 0u,
               0u);
    }
  }
  mbar_wait(bar, parity);
  parity ^= 1u;
  if (threadIdx.x == 0) mbar_expect(bar, csize * (unsigned)sizeof(Rec));
  return warp_best<PAIR>(lane < csize ? buf[lane] : rec_none());
}

struct Params {
  const float* k;
  const float* y;
  const float* c;
  const unsigned char* act;
  const float* a0;
  const float* f0;
  float* a_out;
  float* f_out;
  int* out;
  int* runs;
  int q;
  int slots;
  float two_eps;
  int step_cap;
  int max_cap;
  int pairwise;
};

// This thread's slots of one K row, all loads issued before any is used:
// pair p holds the row at local slots 2 (tid + T p) + {0, 1}. VEC: q even
// and K 8-byte aligned, so each pair is one 8-byte load.
template <int PER, bool VEC>
__device__ __forceinline__ void load_row(float2 (&r)[PER],
                                         const float* __restrict__ row,
                                         int n_loc, int tid, int nthr) {
#pragma unroll
  for (int pp = 0; pp < PER; ++pp) {
    const int l = 2 * (tid + nthr * pp);
    float2 v = make_float2(0.0f, 0.0f);
    if (VEC) {
      if (l < n_loc) v = __ldg(reinterpret_cast<const float2*>(row + l));
    } else {
      if (l < n_loc) v.x = __ldg(row + l);
      if (l + 1 < n_loc) v.y = __ldg(row + l + 1);
    }
    r[pp] = v;
  }
}

template <int PER, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
subsolve_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // The warps' records, and the exchange buffers, [0] for i_hi and [1]
  // for the partner: one record per block, each buffer with its mbarrier.
  __shared__ Rec part[kMaxWarps];
  __shared__ Rec xbuf[2][kMaxCluster];
  __shared__ __align__(8) unsigned long long xbar[2];
  const int S = p.slots, q = p.q;
  float* a = reinterpret_cast<float*>(smem_raw);   // alpha of the slots
  float* f = a + S;                                // the gradient
  float* kd = f + S;                               // diag(K_WW)
  float* ys = kd + S;
  float* cs = ys + S;
  unsigned char* code = reinterpret_cast<unsigned char*>(cs + S);

  const unsigned rank = cg::this_cluster().block_rank();
  const int csize = (int)cg::this_cluster().num_blocks();
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int base = (int)rank * S;
  const int n_loc = max(0, min(S, q - base));
  const uint32_t bar0 = smem_u32(&xbar[0]), bar1 = smem_u32(&xbar[1]);
  unsigned par0 = 0, par1 = 0;
  PHASE_BEGIN;

  if (tid == 0) {
    const unsigned bytes = csize * (unsigned)sizeof(Rec);
    mbar_init(bar0);
    mbar_init(bar1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(bar0, bytes);
    mbar_expect(bar1, bytes);
    if (rank == 0) p.runs[0] += 1;
  }
  // Set-up: this thread's slots, and the entry extrema's record.
  Rec r = rec_none();
  int best = -1;
#pragma unroll
  for (int pp = 0; pp < PER; ++pp) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int l = 2 * (tid + nthr * pp) + e;
      if (l < n_loc) {
        const int j = base + l;
        const float aj = p.a0[j], yj = p.y[j], cj = p.c[j], fj = p.f0[j];
        const unsigned char cd = member(aj, yj, cj, p.act[j] != 0);
        a[l] = aj;
        f[l] = fj;
        kd[l] = p.k[(size_t)j * q + j];
        ys[l] = yj;
        cs[l] = cj;
        code[l] = cd;
        const float uv = (cd & kUp) ? fj : kSentinel;
        const float lv = (cd & kLow) ? fj : -kSentinel;
        const unsigned long long ku = key_min(uv, j), kl = key_max(lv, j);
        if (ku < r.key) { r.key = ku; r.v = uv; best = l; }
        if (kl < r.key2) { r.key2 = kl; r.v2 = lv; }
      }
    }
  }
  if (best >= 0) { r.a = a[best]; r.y = ys[best]; r.c = cs[best]; r.x = kd[best]; }
  cluster_sync();            // every block's barriers are armed
  Rec cur = exchange<false>(r, part, xbuf[0], bar0, par0, csize, rank);
  float st_bh = cur.v, st_bl = cur.v2;
  PHASE(7, 0.0f);

  const int cap = min(p.max_cap, p.step_cap);
  int t = 0;
  float2 rh[PER], rl[PER];
  while (t < cap && st_bl > __fadd_rn(st_bh, p.two_eps)) {
    const int ih = key_index(cur.key);
    const float bh = cur.v, bl = cur.v2, kh = cur.x;
    load_row<PER, VEC>(rh, p.k + (size_t)ih * q + base, n_loc, tid, nthr);
    PHASE(0, rh[PER - 1].y);

    // WSS2 partner: argmax of the objective over I_low, first index.
    r = rec_none();
    best = -1;
#pragma unroll
    for (int pp = 0; pp < PER; ++pp) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int l = 2 * (tid + nthr * pp) + e;
        if (l < n_loc) {
          const bool low = code[l] & kLow;
          const float fl = low ? f[l] : -kSentinel;
          const float bb = __fsub_rn(fl, bh);
          const float aa = clamp_min(
              __fsub_rn(__fadd_rn(kh, kd[l]),
                        __fmul_rn(2.0f, e ? rh[pp].y : rh[pp].x)), kTau);
          const float obj = (low && bb > 0.0f)
                                ? __fdiv_rn(__fmul_rn(bb, bb), aa) : -1.0f;
          const unsigned long long ko = key_max(obj, base + l);
          if (ko < r.key) { r.key = ko; r.x = aa; r.v2 = fl; best = l; }
        }
      }
    }
    if (best >= 0) { r.a = a[best]; r.y = ys[best]; r.c = cs[best]; }
    PHASE(1, 0.0f);
    const Rec sel = exchange<true>(r, part, xbuf[1], bar1, par1, csize, rank);
    const int il = key_index(sel.key);
    load_row<PER, VEC>(rl, p.k + (size_t)il * q + base, n_loc, tid, nthr);
    PHASE(2, 0.0f);

    // The pair step, in every thread; the owners write alpha, lo first.
    float a_hi_n, a_lo_n;
    pair_step(cur.a, sel.a, cur.y, sel.y, bh, sel.v2, sel.x, cur.c, sel.c,
              p.pairwise, &a_hi_n, &a_lo_n);
    const int l_lo = il - base, l_hi = ih - base;
    bool own_lo = false, own_hi = false;
#pragma unroll
    for (int pp = 0; pp < PER; ++pp) {
      own_lo |= (l_lo >> 1) == tid + nthr * pp;
      own_hi |= (l_hi >> 1) == tid + nthr * pp;
    }
    own_lo = own_lo && l_lo >= 0 && l_lo < n_loc;
    own_hi = own_hi && l_hi >= 0 && l_hi < n_loc;
    if (own_lo) a[l_lo] = a_lo_n;     // lo then hi: i_hi == i_lo keeps hi
    if (own_hi) a[l_hi] = a_hi_n;
    if (own_lo) code[l_lo] = member(a[l_lo], ys[l_lo], cs[l_lo], code[l_lo] & kAct);
    if (own_hi) code[l_hi] = member(a[l_hi], ys[l_hi], cs[l_hi], code[l_hi] & kAct);
    const float ch = __fmul_rn(__fsub_rn(a_hi_n, cur.a), cur.y);
    const float cl = __fmul_rn(__fsub_rn(a_lo_n, sel.a), sel.y);
    PHASE(3, 0.0f);
    PHASE(4, rl[PER - 1].y);

    // f update, and the next step's fresh selection on the new state.
    r = rec_none();
    best = -1;
#pragma unroll
    for (int pp = 0; pp < PER; ++pp) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int l = 2 * (tid + nthr * pp) + e;
        if (l < n_loc) {
          const float fj = __fadd_rn(
              __fadd_rn(f[l], __fmul_rn(ch, e ? rh[pp].y : rh[pp].x)),
              __fmul_rn(cl, e ? rl[pp].y : rl[pp].x));
          f[l] = fj;
          const unsigned char cd = code[l];
          const float uv = (cd & kUp) ? fj : kSentinel;
          const float lv = (cd & kLow) ? fj : -kSentinel;
          const unsigned long long ku = key_min(uv, base + l);
          const unsigned long long kl = key_max(lv, base + l);
          if (ku < r.key) { r.key = ku; r.v = uv; best = l; }
          if (kl < r.key2) { r.key2 = kl; r.v2 = lv; }
        }
      }
    }
    if (best >= 0) { r.a = a[best]; r.y = ys[best]; r.c = cs[best]; r.x = kd[best]; }
    PHASE(5, 0.0f);
    cur = exchange<false>(r, part, xbuf[0], bar0, par0, csize, rank);
    PHASE(6, 0.0f);
    st_bh = bh;
    st_bl = bl;
    ++t;
  }

#pragma unroll
  for (int pp = 0; pp < PER; ++pp) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int l = 2 * (tid + nthr * pp) + e;
      if (l < n_loc) {
        p.a_out[base + l] = a[l];
        p.f_out[base + l] = f[l];
      }
    }
  }
  if (rank == 0 && tid == 0) {
    p.out[0] = __float_as_int(st_bh);
    p.out[1] = __float_as_int(st_bl);
    p.out[2] = t;
    p.runs[1] += t;
  }
  PHASE_END(t);
  cluster_sync();            // no block leaves while it may be written to
}

size_t smem_bytes(int slots) { return (size_t)slots * kSlotBytes; }

// Sets the kernel's attributes, checks that one cluster of this shape can
// be resident, and launches it. The check is made once per shape.
template <int PER, bool VEC>
int launch(const Params& p, int cluster, int threads, size_t smem,
           cudaStream_t s) {
  auto kern = subsolve_kernel<PER, VEC>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static long long checked = -1;           // the last shape found resident
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const long long key = (((long long)dev * 32 + cluster) * 1024 + threads)
                        * (1 << 20) + (long long)smem;
  if (key != checked) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    int active = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (active < 1) return kClusterUnschedulable;
    checked = key;
  }
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool VEC>
int dispatch(const Params& p, int per, int cluster, int threads, size_t smem,
             cudaStream_t s) {
  if (per <= 1) return launch<1, VEC>(p, cluster, threads, smem, s);
  if (per <= 2) return launch<2, VEC>(p, cluster, threads, smem, s);
  if (per <= 4) return launch<4, VEC>(p, cluster, threads, smem, s);
  return launch<kMaxPer, VEC>(p, cluster, threads, smem, s);
}

}  // namespace

extern "C" {

// Enqueues one capped subsolve on `stream`: k (q, q), y, c, a0, f0 (q,)
// float32, act (q,) bytes 0/1; writes a, f (q,) and out = [b_hi bits,
// b_lo bits, t]; adds one to runs[0] and t to runs[1]. `cluster`,
// `threads`, `slots` and `smem` are subsolve_kernel.launch_geometry's
// shape: -1 if they are not this source's layout, -2 if the card cannot
// hold one such cluster. Otherwise returns the CUDA error code of the
// launch (0 = success) and never synchronises.
int dpsvm_inner_subsolve(const void* k, const void* y, const void* c,
                         const void* act, const void* a0, const void* f0,
                         void* a, void* f, void* out, void* runs, int q,
                         float two_eps, int step_cap, int max_cap,
                         int pairwise, int cluster, int threads, int slots,
                         int smem, void* stream) {
  if (q < 1 || q > kMaxQ) return (int)cudaErrorInvalidValue;
  const bool pow2 = cluster > 0 && (cluster & (cluster - 1)) == 0;
  if (!pow2 || cluster > kMaxCluster || threads < 32 || threads % 32 ||
      threads > kMaxThreads || slots < 2 || slots % 2 ||
      (long long)slots * cluster < q || (size_t)smem != smem_bytes(slots))
    return kGeometryMismatch;
  const int per = (slots + 2 * threads - 1) / (2 * threads);
  if (per > kMaxPer) return kGeometryMismatch;
  const Params p{(const float*)k, (const float*)y, (const float*)c,
                 (const unsigned char*)act, (const float*)a0,
                 (const float*)f0, (float*)a, (float*)f, (int*)out,
                 (int*)runs, q, slots, two_eps, step_cap, max_cap, pairwise};
  const bool vec = q % 2 == 0 && ((uintptr_t)k & 7) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  return vec ? dispatch<true>(p, per, cluster, threads, (size_t)smem, s)
             : dispatch<false>(p, per, cluster, threads, (size_t)smem, s);
}

}  // extern "C"
