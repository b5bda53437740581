// Batched sequential block elimination ("scan") of the symmetric
// block-tridiagonal + arrowhead KKT system, hand-written for Hopper (sm_90a),
// f32 and f64.
//
// It replaces no Pallas kernel. It is the card form of the JAX package's
// host-side native solver (ctdirect_tpu/native over csrc/blocktri.cpp) and of
// the two lax.scan loops of ctdirect_tpu/solver/structured_kkt.py::_scan_solve
// (:665), the default kkt_mode="structured" block solve. It computes what the
// port's plain version solver/structured_kkt.py::_scan_solve computes, for a
// batch of independent chains, with the same recurrences:
//   forward, i = 1 .. N-1:
//     C = B_{i-1}^T Ainv_{i-1};  Atil = A_i - C B_{i-1};
//     Etil_i = E_i - C Etil_{i-1};  rtil_i = r_i - C rtil_{i-1};
//     Ainv_i = the Gauss-Jordan inverse of Atil (Ainv_0 that of A_0);
//   border: Ftil = F - sum_i Etil_i^T Ainv_i Etil_i,
//           rbtil = rb - sum_i Etil_i^T Ainv_i rtil_i,
//           xb by a Gauss-Jordan solve of [Ftil | rbtil];
//   back:   x_{N-1} = Ainv_{N-1} rtil_{N-1} - Ainv_{N-1} Etil_{N-1} xb,
//           x_i = Ainv_i ((rtil_i - B_i x_{i+1}) - Etil_i xb).
//
// The arithmetic order is pinned, element by element, to the first form of
// this kernel (and so to the plain version's operations): the Gauss-Jordan
// is solver/kkt.py::_gj_eliminate's (the reference's
// ctdirect_tpu/solver/kkt.py:40-61) on [Atil | I]: per column the pivot is
// the first row of maximal |value| at or below the diagonal, a NaN counting
// as the maximum, as torch.argmax picks it; rows j and p are exchanged
// exactly; row j is divided by its pivot (div_rn: correctly rounded) and
// every other row loses its column-j multiple of it as a product and a
// difference rounded apart (mul_rn, no fused multiply-add). Every product is
// a running sum of fma()s in the order of its index, from 0; the border sums
// are one such running sum over (step, row), as the plain version's einsum
// contracts them. Several structured recipes of the fixture CI and cells of
// the latency lab pass or fail by rounding (ROADMAP.md queue 3), so a faster
// kernel that rounded differently would be a different solver: moving work
// between threads changes no rounding, reordering a sum would.
//
// Contract (batch leading, row-major, contiguous):
//   A (B,N,bs,bs); Bc (B,N-1,bs,bs); E (B,N,bs,wb); F (B,wb,wb); r (B,N,bs);
//   rb (B,wb)  ->  X (B,N,bs), xb (B,wb).
// The caller allocates a workspace of scan_workspace_elems(N, bs, wb, B)
// elements (Ainv_i, Etil_i, rtil_i of every step, for the back sweep).
//
// What bounds it on the H100: a chain is a dependency chain of N steps,
// each a Gauss-Jordan of bs columns in order, so at B = 1 (the compiled
// ct.solve, the cold starts, the lab) the latency of one step bounds it, not
// bytes or operations (N (2bs^2 + bs wb + 2bs) + wb^2 + 2wb elements a chain
// to read; at large B the bytes). A column costs a warp reduction (~47
// cycles a redux.sync), two shared-memory round trips and two __syncwarp;
// the first form paid three CTA-wide barriers a column and ~20 us a step at
// bs 11. The design cuts that latency:
// - Two warps per chain (warp specialisation). The critical warp walks only
//   the recurrence that feeds the next step: C = B^T Ainv, Atil = A - C B and
//   the Gauss-Jordan. The off-path warp trails it by up to a step: Etil_i and
//   rtil_i (one matrix G = [E | r] of wb + 1 columns), Ainv_i G, the border
//   sums and the workspace stores, a task (8 rows of a column) a lane. They
//   hand over C_i and Ainv_i through a ring of D slots in shared memory with
//   mbarriers (full: the critical warp's 32 lanes arrive; empty: the
//   off-path's).
// - A warp-synchronous Gauss-Jordan: lane a owns row a of [Atil | I]. The
//   pivot search is a warp reduction over values each lane holds
//   (redux.sync over the |value|'s bits: a NaN first, then the larger, then
//   the lower row); the exchange moves no data: each lane keeps the logical
//   index of the row it holds, and the lanes holding rows j and p swap their
//   indices; the pivot row goes to a warp-private buffer, is divided by all
//   lanes at once (a column each), and each lane updates its own row,
//   column j+1 first, so that the next pivot's search overlaps the rest.
//   Columns left of the pivot are not updated: they are never read again,
//   and no output depends on them. No CTA-wide barrier inside a step.
// - Widths up to kExactMax (16, every chain of the main path but the widest)
//   are compiled one library each, the kernel specialised to its bs: the
//   rows of [Atil | I] and of C stay in registers, every loop is unrolled
//   with its indices known at compile time (no predicate, no run-time
//   division), a __syncwarp every few terms of a sum bounding the loads in
//   flight (0 spills; 128 registers, f64 at widths 13-16 more). Wider chains (bs <= 32, 64) share a
//   library whose rows live in shared memory (lane a also owns row a + 32).
// - The inputs come a step ahead: A_i and B_{i-1} (critical warp), E_i and
//   r_i (off-path warp) by cp.async at the element's size (4 or 8 bytes:
//   blocks of odd bs are not 16-byte aligned, which TMA's bulk copy needs)
//   into a ring of PD stages; the back sweep's records (Ainv_i, B_i, Etil_i,
//   rtil_i) likewise, BD stages deep.
// - Several chains per CTA for a batch (K = ceil(B / SMs), at most
//   kMaxChains), each in its own slice of shared memory; a chain's
//   arithmetic does not depend on its slot.
// The ring depths D, PD, BD are the largest that fit one chain's shared
// memory (up to 227 KB: D = PD = 1 only at the widest shapes).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWidth = 64;         // cap on bs + wb (the CR kernel's)
constexpr int kChainThreads = 64;     // two warps a chain
constexpr int kMaxChains = 4;         // chains per CTA
constexpr int kDefaultSmem = 49152;   // above this a kernel needs the attribute
constexpr int kSmemLimit = 232448;    // the most a CTA can opt in to on sm_90
constexpr int kExactMax = 16;         // widths up to this one are built one library each

// The library holds the kernels of one width: SCAN_WIDTH = bs (1 ..
// kExactMax) those specialised to that bs, whose rows stay in registers;
// SCAN_WIDTH = 0 those of the wide classes (bs <= 32, 64), which keep them
// in shared memory. The wrapper builds each at its first use (one nvcc a
// width, in parallel where it builds several).
#ifndef SCAN_WIDTH
#define SCAN_WIDTH 0
#endif
static_assert(SCAN_WIDTH >= 0 && SCAN_WIDTH <= kExactMax, "SCAN_WIDTH: 0 or a width up to kExactMax");

// Offsets (elements) of one chain's working arrays in its slice of shared
// memory; the host computes them into the kernel's parameters. The first
// group lives through the whole solve; the forward arrays and the back
// sweep's share the rest (a union: the back sweep starts when both warps
// have left the forward loop).
struct Layout {
  int no, SM, g, SE, ldb;  // strides: odd n, 2n + 1, wb + 1, odd wb, odd wb + 1
  int D, PD, BD;           // handover slots, input stages, back-sweep stages
  int AG, Sg, xs, tv, xb;  // persistent: Ainv_i G_i, [S | sv], x_{i+1}, t, xb
  int M, prow, inA, inB, Cs, As, Gin, Gt;  // forward
  int bk, bkStage, M2, prow2;              // back sweep, border solve
  int elems;
};

inline int odd(int x) { return x | 1; }

inline Layout layout(int n, int w, int D, int PD, int BD) {
  Layout L{};
  L.no = odd(n);
  L.SM = 2 * n + 1;
  L.g = w + 1;
  L.SE = odd(w);
  L.ldb = odd(w + 1);
  L.D = D;
  L.PD = PD;
  L.BD = BD;
  const int nno = n * L.no, ng = n * L.g;
  int o = 0;
  L.AG = o;  o += ng;         // Ainv_i [Etil_i | rtil_i], n x g
  L.Sg = o;  o += w * L.g;    // [sum Etil^T Ainv Etil | sum Etil^T Ainv rtil], w x g
  L.xs = o;  o += n;
  L.tv = o;  o += n;
  L.xb = o;  o += w;
  const int u = o;
  L.M = o;    o += n * L.SM > 32 ? n * L.SM : 32;  // the critical warp's [Atil | I] (bs > 16) or pivot row (bs <= 16)
  L.prow = o; o += 2 * n > 32 ? 2 * n : 32;        // its divided pivot row
  L.inA = o;  o += PD * nno;  // A_i (stride no)
  L.inB = o;  o += PD * n * n;  // B_{i-1}
  L.Cs = o;   o += D * nno;   // C_i (handover)
  L.As = o;   o += D * nno;   // Ainv_i (handover)
  L.Gin = o;  o += PD * ng;   // [E_i | r_i]
  L.Gt = o;   o += 2 * ng;    // [Etil | rtil] of steps i-1 and i (by parity)
  const int fwd = o;
  o = u;
  L.bkStage = 2 * nno + n * L.SE + n;  // Ainv_i, B_i (stride no), Etil_i (stride SE), rtil_i
  L.bk = o;    o += BD * L.bkStage;
  L.M2 = o;    o += w * L.ldb;  // [Ftil | rbtil]
  L.prow2 = o; o += L.g;
  // the border sums' chunks of 8 read up to 7 elements past the last row of
  // G (their sums discarded): a pad keeps that inside the chain's slice
  L.elems = (fwd > o ? fwd : o) + 8;
  return L;
}

bool valid(int N, int bs, int wb, int B) {
  return N >= 1 && bs >= 1 && wb >= 0 && bs + wb <= kMaxWidth && B >= 1;
}

inline int round16(int x) { return (x + 15) & ~15; }

// One chain's slice: its mbarriers (2D + 1 words), then its arrays.
struct Plan {
  Layout L;
  int bar_bytes, chain_bytes;
};

inline Plan plan(int n, int w, int itemsize) {
  static const int prefs[][3] = {{2, 2, 4}, {2, 2, 2}, {2, 1, 2}, {1, 1, 2}, {1, 1, 1}};
  Plan p{};
  for (const auto& d : prefs) {
    p.L = layout(n, w, d[0], d[1], d[2]);
    p.bar_bytes = round16((2 * d[0] + 1) * 8);
    p.chain_bytes = round16(p.bar_bytes + p.L.elems * itemsize);
    if (p.chain_bytes <= kSmemLimit) break;
  }
  return p;
}

// Chains per CTA: enough to give every SM work before any SM gets two, at
// most kMaxChains and what shared memory holds.
inline int chains_per_cta(int B, int chain_bytes, int sms) {
  int k = (B + sms - 1) / sms;
  if (k > kMaxChains) k = kMaxChains;
  if (k > kSmemLimit / chain_bytes) k = kSmemLimit / chain_bytes;
  return k < 1 ? 1 : k;
}

// ---- arithmetic, pinned (see the note above) ----

template <typename T>
__device__ __forceinline__ T mul_rn(T a, T b);
template <>
__device__ __forceinline__ float mul_rn<float>(float a, float b) {
  return __fmul_rn(a, b);
}
template <>
__device__ __forceinline__ double mul_rn<double>(double a, double b) {
  return __dmul_rn(a, b);
}

template <typename T>
__device__ __forceinline__ T absval(T x) {
  return x < T(0) ? -x : x;
}

// a / b rounded to nearest, as div_rn(a, b) = div_apply(a, div_prep(b)): the
// part that depends on b alone is computed once per pivot. In f32 the
// division itself; in f64 without div.rn.f64's slow-path subroutine call
// (which made ptxas keep registers on the stack): an estimate of 1/b
// (rcp.approx.ftz.f64) refined by three Newton steps, the quotient
// corrected once by its remainder (both by fused multiply-adds), where b is
// scaled into [2^-1000, 2^1000) by a power of two first; zeros, infinities
// and NaNs give IEEE's results.
template <typename T>
struct DivPrep;

template <>
struct DivPrep<float> {
  float b;
};

template <>
struct DivPrep<double> {
  double b, bs, y, k;
};

__device__ __forceinline__ DivPrep<float> div_prep(float b) { return {b}; }

__device__ __forceinline__ float div_apply(float a, const DivPrep<float>& d) { return a / d.b; }

__device__ __forceinline__ DivPrep<double> div_prep(double b) {
  DivPrep<double> d;
  d.b = b;
  const double mag = fabs(b);
  d.k = mag < 0x1p-1000 ? 0x1p+1000 : (mag >= 0x1p+1000 ? 0x1p-1000 : 1.0);
  d.bs = b * d.k;  // exact: a power of two within the range
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(d.bs));
  for (int it = 0; it < 3; ++it) y = fma(y, fma(-d.bs, y, 1.0), y);
  d.y = y;
  return d;
}

__device__ __forceinline__ double div_apply(double a, const DivPrep<double>& d) {
  const double b = d.b;
  const bool neg = signbit(a) != signbit(b);
  if (isnan(a) || isnan(b)) return a + b;
  if (isinf(b)) return isinf(a) ? __longlong_as_double(0x7ff8000000000000LL) : (neg ? -0.0 : 0.0);
  if (b == 0.0) return a == 0.0 ? __longlong_as_double(0x7ff8000000000000LL) : (neg ? -CUDART_INF : CUDART_INF);
  if (isinf(a)) return neg ? -CUDART_INF : CUDART_INF;
  const double q = __dmul_rn(a, d.y);
  return __dmul_rn(fma(fma(-d.bs, q, a), d.y, q), d.k);
}

// The pivot order's key of |x| as an unsigned integer: a NaN above every
// number, then the numbers in their order (-0 and +0 equal).
__device__ __forceinline__ unsigned long long pivot_key(float x) {
  const float a = absval(x);
  return isnan(a) ? 0x7fffffffull : (unsigned long long)(__float_as_uint(a) & 0x7fffffffu);
}

__device__ __forceinline__ unsigned long long pivot_key(double x) {
  const double a = absval(x);
  return isnan(a) ? 0x7fffffffffffffffull
                  : ((unsigned long long)__double_as_longlong(a) & 0x7fffffffffffffffull);
}

// f(q) for q = 0 .. n-1 in order, the terms of a running sum: for the
// widths built exactly (NB = n <= kExactMax) the loop is unrolled whole,
// with a __syncwarp every Fence terms, so that the compiler does not hoist
// every load at once (registers): every lane of the warp must call it; for
// the wide classes a loop unrolled by 4.
template <int NB, int Fence, class F>
__device__ __forceinline__ void over_rows(int n, F&& f) {
  if constexpr (NB <= kExactMax) {
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      if (q > 0 && q % Fence == 0) __syncwarp();
      f(q);
    }
  } else {
#pragma unroll 4
    for (int q = 0; q < n; ++q) f(q);
  }
}

// ---- shared-memory plumbing ----

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr(dst)), "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int Pending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(Pending) : "memory");
}

// Wait until at most depth - 1 of this thread's copy groups are in flight
// (depth 1, 2 or 4), then make the warp's copies visible to all its lanes.
__device__ __forceinline__ void cp_wait_depth(int depth) {
  if (depth >= 4) cp_wait<3>();
  else if (depth == 2) cp_wait<1>();
  else cp_wait<0>();
  __syncwarp();
}

// A lane's walk over a rows x W block in steps of 32 elements: its first
// (row, column) and the step's, so that no division runs in the copy loops.
struct Walk {
  int r0, c0, dr, dc;
};

__device__ __forceinline__ Walk walk(int W, int lane) {
  Walk k{0, 0, 0, 0};
  if (W > 0) k = Walk{lane / W, lane % W, 32 / W, 32 % W};
  return k;
}

// Copy a contiguous rows x W block from device memory into shared memory
// with row stride ld (cp.async, one element a copy).
template <typename T>
__device__ __forceinline__ void copy_block(T* dst, int ld, const T* src, int rows, int W, Walk k, int lane) {
  int r = k.r0, c = k.c0;
  const int total = rows * W;
  for (int e = lane; e < total; e += 32) {
    cp_async(dst + r * ld + c, src + e);
    r += k.dr;
    c += k.dc;
    if (c >= W) c -= W, ++r;
  }
}

// ---- the warp's Gauss-Jordan ----

// One row's update at pivot column j, columns from .. cols-1: the divided
// pivot row's entries (the row now holding the pivot) or the row's own less
// pc (its column-j entry) times them. Chunks of 8 columns at compile-time
// positions below CMAX, each chunk's loads before its stores, so that a
// chunk's 8 updates overlap.
template <typename T, int CMAX>
__device__ __forceinline__ void eliminate_row(T* row, const T* prow, T pc, int from, int cols, bool pivot) {
#pragma unroll
  for (int c0 = 0; c0 < CMAX; c0 += 8) {
    if (c0 + 8 <= from || c0 >= cols) continue;
    T rv[8], pv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 + u;
      if (c >= from && c < cols) pv[u] = prow[c], rv[u] = row[c];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 + u;
      if (c >= from && c < cols) row[c] = pivot ? pv[u] : rv[u] - mul_rn(pc, pv[u]);
    }
  }
}

// The pivot of column j among the warp's rows: v[] holds each own row's
// entry in the column, r[] its logical index. Returns logical row x 64 +
// physical row of the first logical row >= j of maximal key (torch.argmax's
// order).
template <typename T, int R>
__device__ __forceinline__ unsigned pivot_search(const T (&v)[R], const int (&r)[R], int rows, int j, int lane) {
  unsigned long long key[R];
  unsigned hi = 0, lo = 0;
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    key[rr] = 0;
    if (lane + 32 * rr < rows && r[rr] >= j) key[rr] = pivot_key(v[rr]) + 1;
    hi = max(hi, (unsigned)(key[rr] >> 32));
  }
  const unsigned mhi = __reduce_max_sync(kFull, hi);
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
    if ((unsigned)(key[rr] >> 32) == mhi) lo = max(lo, (unsigned)key[rr]);
  const unsigned mlo = __reduce_max_sync(kFull, lo);
  const unsigned long long mkey = ((unsigned long long)mhi << 32) | mlo;
  unsigned pk = 0xffffffffu;
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
    if (key[rr] == mkey) pk = min(pk, (unsigned)(r[rr] * 64 + lane + 32 * rr));
  return __reduce_min_sync(kFull, pk);
}

// Gauss-Jordan with partial pivoting on the rows x cols matrix M (row stride
// ld, cols <= CMAX) by one warp: lane l owns physical rows l and l + 32 (R of
// them); r[] returns the logical index of each (the row of the reduced
// matrix it holds). prow: cols elements of scratch. Per column: the pivot
// row divided by all lanes into prow, the holders of rows j and p swap
// their indices, then each lane updates its rows, column j+1 first: the
// search for the next pivot runs on those entries while the lanes update
// the rest. Columns left of the pivot are not updated (never read again).
// Ends with a __syncwarp.
template <typename T, int R, int CMAX>
__device__ __forceinline__ void gj_warp(T* M, int ld, int rows, int cols, T* prow, int lane, int (&r)[R]) {
  T v[R];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int a = lane + 32 * rr;
    r[rr] = a;
    v[rr] = a < rows ? M[a * ld] : T(0);
  }
  unsigned pk = pivot_search(v, r, rows, 0, lane);
  for (int j = 0; j < rows; ++j) {
    const int p = (int)(pk >> 6), ph = (int)(pk & 63);
    // row p (physical ph) divided by its pivot, by all lanes
    const T* rowp = M + ph * ld;
    const DivPrep<T> d = div_prep(rowp[j]);
    for (int c = j + 1 + lane; c < cols; c += 32) prow[c] = div_apply(rowp[c], d);
    // the exchange: the lanes holding rows j and p swap their indices
#pragma unroll
    for (int rr = 0; rr < R; ++rr) r[rr] = r[rr] == j ? p : (r[rr] == p ? j : r[rr]);
    __syncwarp();
    T pc[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int a = lane + 32 * rr;
      if (a < rows && j + 1 < cols) {
        T* row = M + a * ld;
        pc[rr] = row[j];
        v[rr] = r[rr] == j ? prow[j + 1] : row[j + 1] - mul_rn(pc[rr], prow[j + 1]);
        row[j + 1] = v[rr];
      }
    }
    if (j + 1 < rows) pk = pivot_search(v, r, rows, j + 1, lane);
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int a = lane + 32 * rr;
      if (a < rows) eliminate_row<T, CMAX>(M + a * ld, prow, pc[rr], j + 2, cols, r[rr] == j);
    }
    __syncwarp();
  }
}

// One step of the critical warp for the widths built exactly (bs = NB <=
// kExactMax): lane a computes row a of C = B_{i-1}^T Ainv_{i-1} into
// registers and the handover slot, and row a of [Atil | I] into registers
// (the lanes past n compute row n-1 again and store nothing), then the
// warp's Gauss-Jordan runs on the registers: per column the pivot row to
// buf by its holder, divided by all lanes into prow (one column a lane),
// and each lane's update of its own row, column j+1 first: the search for
// the next pivot (pivot_search on each lane's new entry) runs while the
// lanes update the rest. Ainv_i goes to the slot in logical row order.
template <typename T, int NB>
__device__ __forceinline__ void step_regs(const T* Ain, const T* Bin, const T* Ap, T* Cs, T* Ao, T* buf, T* prow,
                                          int no, bool first, int lane) {
  // loads in flight between fences: fewer in f64 at the widest (registers: 0 spills at 128)
  constexpr int n = NB, Fence = sizeof(T) == 4 ? 4 : (NB >= 15 ? 1 : 2);
  const int a = lane, ae = lane < n ? lane : n - 1;
  T rg[2 * NB];
  if (first) {
#pragma unroll
    for (int c = 0; c < n; ++c) rg[c] = Ain[ae * no + c];
  } else {
    // C row a = sum_q B_{i-1}[q][a] Ainv_{i-1}[q][:], in the right half
#pragma unroll
    for (int c = 0; c < n; ++c) rg[n + c] = T(0);
    over_rows<NB, Fence>(n, [&](int q) {
      const T bq = Bin[q * n + ae];
#pragma unroll
      for (int c = 0; c < n; ++c) rg[n + c] = fma(bq, Ap[q * no + c], rg[n + c]);
    });
    if (a < n) {
#pragma unroll
      for (int c = 0; c < n; ++c) Cs[a * no + c] = rg[n + c];
    }
    // Atil row a = A_i[a][:] - sum_q C[a][q] B_{i-1}[q][:], in the left half
#pragma unroll
    for (int c = 0; c < n; ++c) rg[c] = T(0);
    over_rows<NB, Fence>(n, [&](int q) {
#pragma unroll
      for (int c = 0; c < n; ++c) rg[c] = fma(rg[n + q], Bin[q * n + c], rg[c]);
    });
#pragma unroll
    for (int c = 0; c < n; ++c) rg[c] = Ain[ae * no + c] - rg[c];
  }
#pragma unroll
  for (int c = 0; c < n; ++c) rg[n + c] = T(c == a);
  // The column loop is unrolled, so that every register index is known at
  // compile time.
  int r = a;
  unsigned pk;
  {
    const T vv[1] = {rg[0]};
    const int rv[1] = {r};
    pk = pivot_search(vv, rv, n, 0, lane);
  }
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const T v = rg[j];
    const int p = (int)(pk >> 6), ph = (int)(pk & 63);
    if (lane == ph) {
#pragma unroll
      for (int c = j; c < 2 * n; ++c) buf[c] = rg[c];
    }
    __syncwarp();
    const DivPrep<T> d = div_prep(buf[j]);
    if (lane > j && lane < 2 * n) prow[lane] = div_apply(buf[lane], d);
    __syncwarp();
    // in chunks of EC columns, a __syncwarp between (it keeps the compiler
    // from hoisting every load of prow, which would cost registers)
    constexpr int EC = sizeof(T) == 8 && NB >= 15 ? 4 : 8;
    const bool pivot = r == p;
    r = r == j ? p : (r == p ? j : r);
    // column j+1 first: the next pivot search runs while the rest updates
    {
      const T pr = prow[j + 1];
      rg[j + 1] = pivot ? pr : rg[j + 1] - mul_rn(v, pr);
    }
    if (j + 1 < n) {
      const T vv[1] = {rg[j + 1]};
      const int rv[1] = {r};
      pk = pivot_search(vv, rv, n, j + 1, lane);
    }
#pragma unroll
    for (int c0 = 0; c0 < 2 * n; c0 += EC) {
      if (c0 + EC <= j + 2) continue;
#pragma unroll
      for (int c = c0 > j + 2 ? c0 : j + 2; c < c0 + EC && c < 2 * n; ++c) {
        const T pr = prow[c];
        rg[c] = pivot ? pr : rg[c] - mul_rn(v, pr);
      }
      __syncwarp();
    }
  }
  if (a < n) {
#pragma unroll
    for (int c = 0; c < n; ++c) Ao[r * no + c] = rg[n + c];
  }
}

template <typename T>
struct Chain {
  const T *A, *Bc, *E, *F, *r, *rb;
  T *X, *xb, *Ainv, *Etil, *rtil;
  int N, bs, wb, B, K, bar_bytes, chain_bytes;
  Layout L;
};

// ---- the critical warp: C, Atil, the Gauss-Jordan; then xb and the back sweep ----

template <typename T, int NB>
__device__ __forceinline__ void critical_warp(const Chain<T>& ch, T* s, uint64_t* bars, size_t b, int lane) {
  constexpr int R = NB > 32 ? 2 : 1;
  constexpr int CH = NB < 8 ? NB : 8;
  const Layout& L = ch.L;
  const int N = ch.N, n = NB <= kExactMax ? NB : ch.bs, w = ch.wb, g = w + 1, no = L.no, nn = n * n, nno = n * no,
            nw = n * w;
  const Walk wn = walk(n, lane), ww = walk(w, lane);
  T* M = s + L.M;

  auto issue = [&](int i) {  // A_i and B_{i-1} into stage i mod PD
    if (i < N) {
      const int st = i & (L.PD - 1);
      copy_block(s + L.inA + st * nno, no, ch.A + (b * N + i) * (size_t)nn, n, n, wn, lane);
      if (i > 0) {
        T* dB = s + L.inB + st * nn;
        const T* src = ch.Bc + (b * (N - 1) + i - 1) * (size_t)nn;
        for (int e = lane; e < nn; e += 32) cp_async(dB + e, src + e);
      }
    }
    cp_commit();
  };

  if (L.PD == 2) issue(0);
  int hs = 0;         // the handover slot of step i
  unsigned par = 0;   // the parity of its use
  int prev = L.D - 1;  // the slot of step i-1
  for (int i = 0; i < N; ++i) {
    issue(i + L.PD - 1);
    cp_wait_depth(L.PD);
    const int st = i & (L.PD - 1);
    const T* Ain = s + L.inA + st * nno;
    const T* Bin = s + L.inB + st * nn;
    T* Cs = s + L.Cs + hs * nno;
    T* Ao = s + L.As + hs * nno;
    const T* Ap = s + L.As + prev * nno;  // Ainv_{i-1}
    if (i >= L.D) mbar_wait(bars + L.D + hs, par ^ 1u);  // the off-path warp is done with the slot
    if constexpr (NB <= kExactMax) {
      step_regs<T, NB>(Ain, Bin, Ap, Cs, Ao, s + L.M, s + L.prow, no, i == 0, lane);
    } else {
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int a = lane + 32 * rr;
        if (a >= n) continue;
        T* Mrow = M + a * L.SM;
        if (i == 0) {
          for (int c = 0; c < n; ++c) Mrow[c] = Ain[a * no + c];
        } else {
          // C row a = sum_q B_{i-1}[q][a] Ainv_{i-1}[q][:]
          for (int c0 = 0; c0 < n; c0 += CH) {
            T acc[CH];
#pragma unroll
            for (int c = 0; c < CH; ++c) acc[c] = T(0);
#pragma unroll 4
            for (int q = 0; q < n; ++q) {
              const T bq = Bin[q * n + a];
              const T* ar = Ap + q * no + c0;
#pragma unroll
              for (int c = 0; c < CH; ++c)
                if (c0 + c < n) acc[c] = fma(bq, ar[c], acc[c]);
            }
#pragma unroll
            for (int c = 0; c < CH; ++c)
              if (c0 + c < n) Cs[a * no + c0 + c] = acc[c];
          }
          // Atil row a = A_i[a][:] - sum_q C[a][q] B_{i-1}[q][:]
          for (int c0 = 0; c0 < n; c0 += CH) {
            T acc[CH];
#pragma unroll
            for (int c = 0; c < CH; ++c) acc[c] = T(0);
#pragma unroll 4
            for (int q = 0; q < n; ++q) {
              const T cq = Cs[a * no + q];
              const T* br = Bin + q * n + c0;
#pragma unroll
              for (int c = 0; c < CH; ++c)
                if (c0 + c < n) acc[c] = fma(cq, br[c], acc[c]);
            }
#pragma unroll
            for (int c = 0; c < CH; ++c)
              if (c0 + c < n) Mrow[c0 + c] = Ain[a * no + c0 + c] - acc[c];
          }
        }
        for (int c = 0; c < n; ++c) Mrow[n + c] = T(c == a);
      }
      __syncwarp();
      int rl[R];
      gj_warp<T, R, 2 * NB>(M, L.SM, n, 2 * n, s + L.prow, lane, rl);
      // Ainv_i in logical row order into the slot
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int a = lane + 32 * rr;
        if (a < n) {
          const T* src = M + a * L.SM + n;
          T* dst = Ao + rl[rr] * no;
          for (int c = 0; c < n; ++c) dst[c] = src[c];
        }
      }
    }
    __syncwarp();
    mbar_arrive(bars + hs);  // C_i and Ainv_i are in the slot
    prev = hs;
    if (++hs == L.D) hs = 0, par ^= 1u;
  }

  // both warps have left the forward loop: the union is the back sweep's
  mbar_wait(bars + 2 * L.D, 0);
  auto issue_back = [&](int k) {  // the records of step N - 2 - k into stage k mod BD
    const int i = N - 2 - k;
    if (i >= 0) {
      T* st = s + L.bk + (k & (L.BD - 1)) * L.bkStage;
      copy_block(st, no, ch.Ainv + (b * N + i) * (size_t)nn, n, n, wn, lane);
      copy_block(st + nno, no, ch.Bc + (b * (N - 1) + i) * (size_t)nn, n, n, wn, lane);
      copy_block(st + 2 * nno, L.SE, ch.Etil + (b * N + i) * (size_t)nw, n, w, ww, lane);
      for (int a = lane; a < n; a += 32) cp_async(st + 2 * nno + n * L.SE + a, ch.rtil + (b * N + i) * (size_t)n + a);
    }
    cp_commit();
  };
  for (int k = 0; k < L.BD - 1; ++k) issue_back(k);

  const T* AG = s + L.AG;
  T* xb = s + L.xb;
  // xb: the Gauss-Jordan solve of [Ftil | rbtil]
  if (w > 0) {
    T* M2 = s + L.M2;
    const T* Sg = s + L.Sg;
    const T* F = ch.F + b * (size_t)w * w;
    const T* rb = ch.rb + b * (size_t)w;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int a = lane + 32 * rr;
      if (a < w) {
        for (int c = 0; c < w; ++c) M2[a * L.ldb + c] = F[a * w + c] - Sg[a * g + c];
        M2[a * L.ldb + w] = rb[a] - Sg[a * g + w];
      }
    }
    __syncwarp();
    int r2[2];
    gj_warp<T, 2, kMaxWidth>(M2, L.ldb, w, g, s + L.prow2, lane, r2);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int a = lane + 32 * rr;
      if (a < w) {
        const T v = M2[a * L.ldb + w];
        xb[r2[rr]] = v;
        ch.xb[b * w + r2[rr]] = v;
      }
    }
    __syncwarp();
  }
  T* X = ch.X + b * (size_t)N * n;
  T* xs = s + L.xs;
  T* tv = s + L.tv;
  // x_{N-1} = Ainv rtil - (Ainv Etil) xb, from the last step's Ainv G
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int a = lane + 32 * rr;
    if (a < n) {
      T acc = T(0);
      for (int q = 0; q < w; ++q) acc = fma(AG[a * g + q], xb[q], acc);
      const T v = AG[a * g + w] - acc;
      X[(size_t)(N - 1) * n + a] = v;
      xs[a] = v;
    }
  }
  __syncwarp();
  for (int k = 0; k < N - 1; ++k) {
    const int i = N - 2 - k;
    issue_back(k + L.BD - 1);
    cp_wait_depth(L.BD);
    const T* st = s + L.bk + (k & (L.BD - 1)) * L.bkStage;
    const T *As = st, *Bs = st + nno, *Es = st + 2 * nno, *rt = st + 2 * nno + n * L.SE;
    // t = (rtil_i - B_i x_{i+1}) - Etil_i xb
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int a = lane + 32 * rr;
      if (a < n) {
        T bx = T(0), ex = T(0);
#pragma unroll 4
        for (int q = 0; q < n; ++q) bx = fma(Bs[a * no + q], xs[q], bx);
#pragma unroll 4
        for (int q = 0; q < w; ++q) ex = fma(Es[a * L.SE + q], xb[q], ex);
        tv[a] = (rt[a] - bx) - ex;
      }
    }
    __syncwarp();
    // x_i = Ainv_i t (x_{i+1} was read in the phase before)
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int a = lane + 32 * rr;
      if (a < n) {
        T acc = T(0);
#pragma unroll 4
        for (int q = 0; q < n; ++q) acc = fma(As[a * no + q], tv[q], acc);
        X[(size_t)i * n + a] = acc;
        xs[a] = acc;
      }
    }
    __syncwarp();
  }
}

// ---- the off-path warp: [Etil | rtil], Ainv G, the border sums, the workspace ----

// acc[aa] = sum_q X[a0+aa][q] y[q] (rows past n clamped to n-1, their sums
// discarded by the caller) for one column y of a shared matrix (row stride
// ldy), X shared (row stride ldx): CH running sums, each in the order of q
// from 0.
template <typename T, int NB, int CH>
__device__ __forceinline__ void rows_times_column(T (&acc)[CH], const T* X, int ldx, const T* y, int ldy, int a0, int n) {
  constexpr int Fence = sizeof(T) == 8 ? 2 : 8;
  int row[CH];
#pragma unroll
  for (int aa = 0; aa < CH; ++aa) {
    acc[aa] = T(0);
    row[aa] = (a0 + aa < n ? a0 + aa : n - 1) * ldx;
  }
  over_rows<NB, Fence>(n, [&](int q) {
    const T yq = y[q * ldy];
#pragma unroll
    for (int aa = 0; aa < CH; ++aa) acc[aa] = fma(X[row[aa] + q], yq, acc[aa]);
  });
}

// f(a0, c, on) for each task of a chunks x g grid (rows a0 .. a0+CH-1 of
// column c), a task a lane in turn; every lane runs the same number of
// rounds (on = false: no task, a0 = c = 0, nothing to store), so that the
// tasks may hold a __syncwarp.
template <int CH, class F>
__device__ __forceinline__ void for_tasks(int chunks, int g, Walk wg, int lane, F&& f) {
  int k = wg.r0, c = wg.c0;
  for (int t = lane; t < ((chunks * g + 31) & ~31); t += 32) {
    const bool on = t < chunks * g;
    f(on ? k * CH : 0, on ? c : 0, on);
    k += wg.dr;
    c += wg.dc;
    if (c >= g) c -= g, ++k;
  }
}

template <typename T, int NB>
__device__ __forceinline__ void offpath_warp(const Chain<T>& ch, T* s, uint64_t* bars, size_t b, int lane) {
  constexpr int CH = NB < 8 ? NB : 8;
  const Layout& L = ch.L;
  const int N = ch.N, n = NB <= kExactMax ? NB : ch.bs, w = ch.wb, g = w + 1, no = L.no, nn = n * n, nw = n * w, ng = n * g,
            nno = n * no;
  const Walk wn = walk(n, lane), ww = walk(w, lane), wg = walk(g, lane);
  const int chunks_n = (n + CH - 1) / CH, chunks_w = (w + CH - 1) / CH;
  T* AG = s + L.AG;
  T* Sg = s + L.Sg;

  auto issue = [&](int i) {  // [E_i | r_i] into stage i mod PD
    if (i < N) {
      T* Gi = s + L.Gin + (i & (L.PD - 1)) * ng;
      copy_block(Gi, g, ch.E + (b * N + i) * (size_t)nw, n, w, ww, lane);
      for (int a = lane; a < n; a += 32) cp_async(Gi + a * g + w, ch.r + (b * N + i) * (size_t)n + a);
    }
    cp_commit();
  };

  for (int c = lane; c < g; c += 32)
    for (int a = 0; a < w; ++a) Sg[a * g + c] = T(0);
  if (L.PD == 2) issue(0);
  int hs = 0;
  unsigned par = 0;
  for (int i = 0; i < N; ++i) {
    issue(i + L.PD - 1);
    cp_wait_depth(L.PD);
    mbar_wait(bars + hs, par);  // C_i and Ainv_i
    const T* Gi = s + L.Gin + (i & (L.PD - 1)) * ng;
    const T* Gp = s + L.Gt + ((i - 1) & 1) * ng;
    T* Gn = s + L.Gt + (i & 1) * ng;
    const T* Cs = s + L.Cs + hs * nno;
    const T* Ao = s + L.As + hs * nno;
    // G_i = [E_i | r_i] - C_i G_{i-1}, then Ainv_i G_i: tasks of 8 rows of a column
    for_tasks<CH>(chunks_n, g, wg, lane, [&](int a0, int c, bool on) {
      T acc[CH];
      if (i > 0) rows_times_column<T, NB, CH>(acc, Cs, no, Gp + c, g, a0, n);
#pragma unroll
      for (int aa = 0; aa < CH; ++aa)
        if (on && a0 + aa < n) Gn[(a0 + aa) * g + c] = i > 0 ? Gi[(a0 + aa) * g + c] - acc[aa] : Gi[(a0 + aa) * g + c];
    });
    __syncwarp();
    for_tasks<CH>(chunks_n, g, wg, lane, [&](int a0, int c, bool on) {
      T acc[CH];
      rows_times_column<T, NB, CH>(acc, Ao, no, Gn + c, g, a0, n);
#pragma unroll
      for (int aa = 0; aa < CH; ++aa)
        if (on && a0 + aa < n) AG[(a0 + aa) * g + c] = acc[aa];
    });
    // the step's records to the workspace (coalesced): Ainv_i, then after the
    // __syncwarp Etil_i and rtil_i
    T* Aw = ch.Ainv + (b * N + i) * (size_t)nn;
    {
      int r = wn.r0, c = wn.c0;
      for (int e = lane; e < nn; e += 32) {
        Aw[e] = Ao[r * no + c];
        r += wn.dr;
        c += wn.dc;
        if (c >= n) c -= n, ++r;
      }
    }
    mbar_arrive(bars + L.D + hs);  // done with the slot
    if (++hs == L.D) hs = 0, par ^= 1u;
    __syncwarp();  // Ainv_i G_i complete
    T* Ew = ch.Etil + (b * N + i) * (size_t)nw;
    {
      int r = ww.r0, c = ww.c0;
      for (int e = lane; e < nw; e += 32) {
        Ew[e] = Gn[r * g + c];
        r += ww.dr;
        c += ww.dc;
        if (c >= w) c -= w, ++r;
      }
    }
    T* rw = ch.rtil + (b * N + i) * (size_t)n;
    for (int a = lane; a < n; a += 32) rw[a] = Gn[a * g + w];
    // the border sums, carried on over this step's rows: [S | sv][a][c] +=
    // sum_q Etil_i[q][a] (Ainv_i G_i)[q][c]
    for_tasks<CH>(chunks_w, g, wg, lane, [&](int a0, int c, bool on) {
      constexpr int Fence = sizeof(T) == 8 ? 2 : 8;
      T acc[CH];
#pragma unroll
      for (int aa = 0; aa < CH; ++aa) acc[aa] = a0 + aa < w ? Sg[(a0 + aa) * g + c] : T(0);
      over_rows<NB, Fence>(n, [&](int q) {
        const T ag = AG[q * g + c];
#pragma unroll
        for (int aa = 0; aa < CH; ++aa) acc[aa] = fma(Gn[q * g + a0 + aa], ag, acc[aa]);
      });
#pragma unroll
      for (int aa = 0; aa < CH; ++aa)
        if (on && a0 + aa < w) Sg[(a0 + aa) * g + c] = acc[aa];
    });
  }
  mbar_arrive(bars + 2 * L.D);  // the border sums and the workspace are complete
}

// NB: bs itself up to kExactMax, else the width class (bs <= NB). Two CTAs
// of kMaxChains chains an SM (128 registers a thread: cart-pole's batch of
// 1,024 in one wave), but for f64 at widths 13 to 16, whose register rows
// would spill at 128: one CTA an SM there.
template <typename T, int NB>
__global__ void __launch_bounds__(kChainThreads * kMaxChains, sizeof(T) == 8 && NB >= 13 && NB <= kExactMax ? 1 : 2)
    scan_kernel(Chain<T> ch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, slot = warp >> 1;
  unsigned char* base = smem_raw + slot * ch.chain_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base);
  T* s = reinterpret_cast<T*>(base + ch.bar_bytes);
  if ((warp & 1) == 0 && lane == 0) {
    for (int d = 0; d < ch.L.D; ++d) {
      mbar_init(bars + d, 32);         // full: the critical warp's lanes
      mbar_init(bars + ch.L.D + d, 32);  // empty: the off-path warp's
    }
    mbar_init(bars + 2 * ch.L.D, 32);  // the off-path warp is done
  }
  __syncthreads();
  const size_t b = (size_t)blockIdx.x * ch.K + slot;
  if (b >= (size_t)ch.B) return;
  if ((warp & 1) == 0)
    critical_warp<T, NB>(ch, s, bars, b, lane);
  else
    offpath_warp<T, NB>(ch, s, bars, b, lane);
}

template <typename T>
const void* kernel_for(int bs) {
#if SCAN_WIDTH > 0
  return bs == SCAN_WIDTH ? (const void*)scan_kernel<T, SCAN_WIDTH> : nullptr;
#else
  if (bs <= kExactMax) return nullptr;
  return bs <= 32 ? (const void*)scan_kernel<T, 32> : (const void*)scan_kernel<T, 64>;
#endif
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms > 0 ? sms : 132;
}

template <typename T>
int launch(const T* A, const T* Bc, const T* E, const T* F, const T* r, const T* rb, T* X, T* xb, T* work,
           int N, int bs, int wb, int B, void* stream) {
  if (!valid(N, bs, wb, B)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(bs, wb, (int)sizeof(T));
  if (p.chain_bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  const int K = chains_per_cta(B, p.chain_bytes, sm_count());
  const int smem = K * p.chain_bytes;
  const void* fn = kernel_for<T>(bs);
  if (!fn) return (int)cudaErrorInvalidDeviceFunction;  // another width's library
  if (smem > kDefaultSmem) {  // per launch: the attribute belongs to the current device
    const int rc = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc) return rc;
  }
  const size_t nB = B, nN = N;
  Chain<T> ch{A, Bc, E, F, r, rb, X, xb, work, nullptr, nullptr, N, bs, wb, B, K, p.bar_bytes, p.chain_bytes, p.L};
  ch.Etil = ch.Ainv + nB * nN * bs * bs;
  ch.rtil = ch.Etil + nB * nN * bs * wb;
  void* args[] = {&ch};
  const int rc = (int)cudaLaunchKernel(fn, dim3((B + K - 1) / K), dim3(kChainThreads * K), args, (size_t)smem,
                                       static_cast<cudaStream_t>(stream));
  return rc ? rc : (int)cudaGetLastError();
}

template <typename T>
int resident_chains(int bs, int wb, int B) {
  if (!valid(1, bs, wb, B)) return -1;
  const Plan p = plan(bs, wb, (int)sizeof(T));
  if (p.chain_bytes > kSmemLimit) return -1;
  const int K = chains_per_cta(B, p.chain_bytes, sm_count());
  const int smem = K * p.chain_bytes;
  const void* fn = kernel_for<T>(bs);
  if (!fn || (smem > kDefaultSmem && cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kChainThreads * K, (size_t)smem)) return -1;
  return blocks * K;
}

}  // namespace

extern "C" {

// Elements (of the kernel's dtype) of the workspace the caller allocates.
size_t scan_workspace_elems(int N, int bs, int wb, int B) {
  return (size_t)B * N * ((size_t)bs * bs + (size_t)bs * wb + bs);
}

// Dynamic shared memory bytes of one chain (a CTA holds up to kMaxChains of
// them), or -1 for a shape the kernel does not take.
long long scan_smem_bytes(int bs, int wb, int itemsize) {
  if (!valid(1, bs, wb, 1) || (itemsize != 4 && itemsize != 8)) return -1;
  const Plan p = plan(bs, wb, itemsize);
  return p.chain_bytes > kSmemLimit ? -1 : (long long)p.chain_bytes;
}

// Chains a CTA holds at batch B on the current device, and the chains that
// can be resident on one SM at once (the occupancy calculator's CTAs x
// chains per CTA); -1 on a shape the kernel does not take or an error.
int scan_launch_shape(int bs, int wb, int B, int itemsize, int* chains_per_cta_out, int* resident_out) {
  if (!valid(1, bs, wb, B) || (itemsize != 4 && itemsize != 8)) return -1;
  const Plan p = plan(bs, wb, itemsize);
  if (p.chain_bytes > kSmemLimit) return -1;
  *chains_per_cta_out = chains_per_cta(B, p.chain_bytes, sm_count());
  *resident_out = itemsize == 4 ? resident_chains<float>(bs, wb, B) : resident_chains<double>(bs, wb, B);
  return *resident_out < 0 ? -1 : 0;
}

// Each returns 0 when the solve's one launch was issued, else its cudaError_t.
int scan_solve_f32(const float* A, const float* Bc, const float* E, const float* F, const float* r,
                   const float* rb, float* X, float* xb, float* work, int N, int bs, int wb, int B,
                   void* stream) {
  return launch<float>(A, Bc, E, F, r, rb, X, xb, work, N, bs, wb, B, stream);
}

int scan_solve_f64(const double* A, const double* Bc, const double* E, const double* F,
                   const double* r, const double* rb, double* X, double* xb, double* work, int N,
                   int bs, int wb, int B, void* stream) {
  return launch<double>(A, Bc, E, F, r, rb, X, xb, work, N, bs, wb, B, stream);
}

}  // extern "C"
