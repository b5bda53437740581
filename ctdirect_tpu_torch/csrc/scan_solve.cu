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
// The Gauss-Jordan is solver/kkt.py::_gj_eliminate's (the reference's
// ctdirect_tpu/solver/kkt.py:40-61): per column the pivot is the first row of
// maximal |value| at or below the diagonal, a NaN counting as the maximum, as
// torch.argmax and jnp.argmax pick it; rows j and p are exchanged exactly
// (not the one-hot form row_p + (row_j - row_p) of the CR kernel, which
// follows pallas_cr.py); row j is divided by its pivot and every other row
// loses its column-j multiple of it, as a product and a difference rounded
// apart (no fused multiply-add), as the plain version's elementwise ops do.
// Products are running sums of fused multiply-adds, one output element
// each, in the order of their index, as a plain matrix product runs them;
// the border sums are one such running sum over (step, row), as the plain
// version's einsum contracts them. (A form that added each step's term with
// a compensation (Neumaier) was more exact and no better for the solves
// that use it: PERF.md.)
//
// Contract (batch leading, row-major, contiguous):
//   A (B,N,bs,bs); Bc (B,N-1,bs,bs); E (B,N,bs,wb); F (B,wb,wb); r (B,N,bs);
//   rb (B,wb)  ->  X (B,N,bs), xb (B,wb).
// The caller allocates a workspace of scan_workspace_elems(N, bs, wb, B)
// elements (Ainv_i, Etil_i, rtil_i of every step, for the back sweep).
//
// Design (simple first): one launch per solve, one CTA of kThreads threads
// per chain, which walks its chain: the O(N) depth is the algorithm's. A
// step's working blocks live in dynamic shared memory (Ainv_{i-1}, B_{i-1},
// C, the augmented [Atil | I], Etil_{i-1} and Etil_i, rtil_{i-1} and rtil_i,
// Ainv_i Etil_i and Ainv_i rtil_i, the border sums, the pivot row and
// column; `Layout`), at most 167 KB in f64 (bs = 64, wb = 0). Each step
// streams Ainv_i, Etil_i and rtil_i to the workspace; the back sweep reads
// them again. Threads share every product
// and every elimination column (one output element per thread); the pivot
// search is one warp's shuffle arg-max; a __syncthreads separates the
// phases (3 per elimination column: search, exchange, eliminate). No thread
// holds an array that grows with the width. (A form with one barrier per
// elimination column, each thread owning a column, and the next step's
// blocks loaded a phase ahead ran 0.92-1.04x this one's speed on the H100:
// not kept.)
//
// What bounds it on the H100: bytes at large batch (each input read once and
// each output written once: N(2bs^2 + bs wb + 2bs) + wb^2 + 2wb elements a
// chain, the workspace's write and read on top), the dependency depth at
// B = 1: N steps of bs elimination columns each, in order, on one SM.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWidth = 64;        // cap on bs + wb (the CR kernel's)
constexpr int kThreads = 128;        // threads per chain
constexpr int kDefaultSmem = 49152;  // above this a kernel needs the attribute

__host__ __device__ inline size_t imax(size_t a, size_t b) { return a > b ? a : b; }

// Offsets (elements) of the working arrays in one chain's CTA's shared
// memory, and their total. The host computes them into the kernel's
// parameters: the kernel reads them from the constant bank where it uses
// them, and no register holds them across the chain's loop.
struct Layout {
  int Ap, Bm, C, M, E2, AE, r2, Ar, xs, S, sv, prow, pcol, pv, total;
};

inline Layout layout(int n, int w) {
  Layout L;
  L.Ap = 0;                                 // Ainv_{i-1}, n x n
  L.Bm = L.Ap + n * n;                      // B_{i-1}, n x n
  L.C = L.Bm + n * n;                       // n x n
  L.M = L.C + n * n;                        // [Atil | I] (n x 2n), later [Ftil | rbtil] (w x (w+1))
  L.E2 = L.M + (int)imax(2 * n * n, w * (w + 1));  // Etil_i and Etil_{i-1} (by the parity of i), 2 x n x w
  L.AE = L.E2 + 2 * n * w;                  // Ainv_i Etil_i, n x w
  L.r2 = L.AE + n * w;                      // rtil_i and rtil_{i-1}, 2 x n
  L.Ar = L.r2 + 2 * n;                      // Ainv_i rtil_i, n
  L.xs = L.Ar + n;                          // the back sweep's x_{i+1}, n
  L.S = L.xs + n;                           // sum Etil^T Ainv Etil, w x w
  L.sv = L.S + w * w;                       // sum Etil^T Ainv rtil, w
  L.prow = L.sv + w;                        // pivot row, max(2n, w+1)
  L.pcol = L.prow + (int)imax(2 * n, w + 1);  // pivot column, max(n, w)
  L.pv = L.pcol + (int)imax(n, w);          // the pivot and the diagonal entry it displaces
  L.total = L.pv + 2;
  return L;
}

bool valid(int N, int bs, int wb, int B) {
  return N >= 1 && bs >= 1 && wb >= 0 && bs + wb <= kMaxWidth && B >= 1;
}

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

// Is (a, ia) before (b, ib) in torch.argmax's order: a NaN first, then the
// larger value, then the lower index.
template <typename T>
__device__ __forceinline__ bool before(T a, int ia, T b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

// a / b rounded to nearest. In f32 the division itself; in f64 without
// div.rn.f64's slow-path subroutine call, which made ptxas keep the
// elimination's registers on the stack: an estimate of 1/b
// (rcp.approx.ftz.f64) refined by three Newton steps, the quotient
// corrected once by its remainder (both by fused multiply-adds), where b is
// scaled into [2^-1000, 2^1000) by a power of two first; zeros,
// infinities and NaNs give IEEE's results.
__device__ __forceinline__ float div_rn(float a, float b) { return a / b; }

__device__ __forceinline__ double div_rn(double a, double b) {
  const bool neg = signbit(a) != signbit(b);
  if (isnan(a) || isnan(b)) return a + b;
  if (isinf(b)) return isinf(a) ? __longlong_as_double(0x7ff8000000000000LL) : (neg ? -0.0 : 0.0);
  if (b == 0.0) return a == 0.0 ? __longlong_as_double(0x7ff8000000000000LL) : (neg ? -CUDART_INF : CUDART_INF);
  if (isinf(a)) return neg ? -CUDART_INF : CUDART_INF;
  const double mag = fabs(b);
  const double k = mag < 0x1p-1000 ? 0x1p+1000 : (mag >= 0x1p+1000 ? 0x1p-1000 : 1.0);
  const double bs = b * k;  // exact: a power of two within the range
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(bs));
  for (int it = 0; it < 3; ++it) y = fma(y, fma(-bs, y, 1.0), y);
  const double q = a * y;
  return fma(fma(-bs, q, a), y, q) * k;
}

template <typename T>
__device__ __forceinline__ T absval(T x) {
  return x < T(0) ? -x : x;
}

// Gauss-Jordan with partial pivoting on the n x m row-major matrix M in
// shared memory (every thread of the CTA calls it; prow m, pcol n and pv 2
// elements of scratch). Leaves the reduced matrix in M. Three phases a
// column: the pivot search (one warp); the exact exchange of rows j and p
// with the pivot row divided by its pivot, and column j as it stands after
// the exchange (these read and write disjoint entries); the elimination.
// Inlined at both calls: a call would save registers to a stack frame.
template <typename T>
__device__ __forceinline__ void gj(T* M, int n, int m, T* prow, T* pcol, T* pv, int* piv_row) {
  const int tid = threadIdx.x, lane = tid & 31;
  for (int j = 0; j < n; ++j) {
    if (tid < 32) {
      T best = T(0);
      int p = n;
      for (int i = j + lane; i < n; i += 32) {
        const T a = absval(M[i * m + j]);
        if (p == n || before(a, i, best, p)) best = a, p = i;
      }
      for (int off = 16; off > 0; off >>= 1) {
        const T ob = __shfl_xor_sync(kFull, best, off);
        const int op = __shfl_xor_sync(kFull, p, off);
        if (op < n && (p == n || before(ob, op, best, p))) best = ob, p = op;
      }
      if (lane == 0) {
        *piv_row = p;
        pv[0] = M[p * m + j];
        pv[1] = M[j * m + j];
      }
    }
    __syncthreads();
    const int p = *piv_row;
    const T piv = pv[0];
    for (int i = tid; i < n; i += kThreads)
      if (i != j) pcol[i] = (i == p) ? pv[1] : M[i * m + j];
    for (int c = tid; c < m; c += kThreads) {
      const T rowj = M[j * m + c], rowp = M[p * m + c];
      M[p * m + c] = rowj;
      prow[c] = div_rn(rowp, piv);
    }
    __syncthreads();
    for (int idx = tid; idx < n * m; idx += kThreads) {
      const int i = idx / m, c = idx - i * m;
      M[idx] = (i == j) ? prow[c] : M[idx] - mul_rn(pcol[i], prow[c]);
    }
    __syncthreads();
  }
}

template <typename T>
struct Chain {
  const T *A, *Bc, *E, *F, *r, *rb;
  T *X, *xb, *Ainv, *Etil, *rtil;
  int N, bs, wb;
  Layout L;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) scan_kernel(Chain<T> ch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int piv_row;
  T* s = reinterpret_cast<T*>(smem_raw);
  const int N = ch.N, n = ch.bs, w = ch.wb, nn = n * n, nw = n * w, tid = threadIdx.x;
  const size_t b = blockIdx.x;
  // block i of a per-step array of this chain (elements per block: m)
  auto at = [=](auto* base, int i, int m) { return base + (b * N + i) * (size_t)m; };
  T* M = s + ch.L.M;

  for (int k = tid; k < w * w; k += kThreads) s[ch.L.S + k] = T(0);
  for (int k = tid; k < w; k += kThreads) s[ch.L.sv + k] = T(0);

  for (int i = 0; i < N; ++i) {
    T* En = s + ch.L.E2 + (i & 1) * nw;       // Etil_i
    T* Ep = s + ch.L.E2 + (~i & 1) * nw;      // Etil_{i-1}
    T* rn = s + ch.L.r2 + (i & 1) * n;        // rtil_i
    T* rp = s + ch.L.r2 + (~i & 1) * n;       // rtil_{i-1}
    const T* Ai = at(ch.A, i, nn);
    const T* Ei = at(ch.E, i, nw);
    const T* ri = at(ch.r, i, n);
    if (i == 0) {
      for (int k = tid; k < 2 * nn; k += kThreads) {
        const int a = k / (2 * n), c = k - a * 2 * n;
        M[k] = c < n ? Ai[a * n + c] : T(c - n == a);
      }
      for (int k = tid; k < nw; k += kThreads) En[k] = Ei[k];
      for (int k = tid; k < n; k += kThreads) rn[k] = ri[k];
    } else {
      const T* Bi = ch.Bc + (b * (N - 1) + (i - 1)) * (size_t)nn;
      T *Bm = s + ch.L.Bm, *C = s + ch.L.C, *Ap = s + ch.L.Ap;
      for (int k = tid; k < nn; k += kThreads) Bm[k] = Bi[k];
      __syncthreads();
      // C = B_{i-1}^T Ainv_{i-1}
      for (int k = tid; k < nn; k += kThreads) {
        const int a = k / n, c = k - a * n;
        T acc = T(0);
        for (int q = 0; q < n; ++q) acc += Bm[q * n + a] * Ap[q * n + c];
        C[k] = acc;
      }
      __syncthreads();
      // Atil = A_i - C B_{i-1} into [Atil | I]; Etil_i; rtil_i
      for (int k = tid; k < 2 * nn; k += kThreads) {
        const int a = k / (2 * n), c = k - a * 2 * n;
        if (c < n) {
          T acc = T(0);
          for (int q = 0; q < n; ++q) acc += C[a * n + q] * Bm[q * n + c];
          M[k] = Ai[a * n + c] - acc;
        } else {
          M[k] = T(c - n == a);
        }
      }
      for (int k = tid; k < nw; k += kThreads) {
        const int a = k / w, c = k - a * w;
        T acc = T(0);
        for (int q = 0; q < n; ++q) acc += C[a * n + q] * Ep[q * w + c];
        En[k] = Ei[k] - acc;
      }
      for (int a = tid; a < n; a += kThreads) {
        T acc = T(0);
        for (int q = 0; q < n; ++q) acc += C[a * n + q] * rp[q];
        rn[a] = ri[a] - acc;
      }
    }
    __syncthreads();
    gj(M, n, 2 * n, s + ch.L.prow, s + ch.L.pcol, s + ch.L.pv, &piv_row);
    // Ainv_i (the right half of M), Ainv_i Etil_i, Ainv_i rtil_i; the
    // step's records to the workspace
    {
      T *Ap = s + ch.L.Ap, *AE = s + ch.L.AE, *Ar = s + ch.L.Ar;
      T* Ainv = at(ch.Ainv, i, nn);
      T* Etil = at(ch.Etil, i, nw);
      T* rtil = at(ch.rtil, i, n);
      for (int k = tid; k < nn; k += kThreads) {
        const int a = k / n, c = k - a * n;
        const T v = M[a * 2 * n + n + c];
        Ap[k] = v;
        Ainv[k] = v;
      }
      for (int k = tid; k < nw; k += kThreads) {
        const int a = k / w, c = k - a * w;
        T acc = T(0);
        for (int q = 0; q < n; ++q) acc += M[a * 2 * n + n + q] * En[q * w + c];
        AE[k] = acc;
        Etil[k] = En[k];
      }
      for (int a = tid; a < n; a += kThreads) {
        T acc = T(0);
        for (int q = 0; q < n; ++q) acc += M[a * 2 * n + n + q] * rn[q];
        Ar[a] = acc;
        rtil[a] = rn[a];
      }
    }
    __syncthreads();
    // the border sums, carried on over this step's rows
    {
      const T *AE = s + ch.L.AE, *Ar = s + ch.L.Ar;
      for (int k = tid; k < w * w; k += kThreads) {
        const int a = k / w, c = k - a * w;
        T acc = s[ch.L.S + k];
        for (int q = 0; q < n; ++q) acc += En[q * w + a] * AE[q * w + c];
        s[ch.L.S + k] = acc;
      }
      for (int a = tid; a < w; a += kThreads) {
        T acc = s[ch.L.sv + a];
        for (int q = 0; q < n; ++q) acc += En[q * w + a] * Ar[q];
        s[ch.L.sv + a] = acc;
      }
    }
    __syncthreads();
  }

  // xb: the Gauss-Jordan solve of [Ftil | rbtil]; it stays in M's last column
  if (w > 0) {
    const T* F = ch.F + b * (size_t)w * w;
    const T* rb = ch.rb + b * (size_t)w;
    for (int k = tid; k < w * (w + 1); k += kThreads) {
      const int a = k / (w + 1), c = k - a * (w + 1);
      M[k] = c < w ? F[a * w + c] - s[ch.L.S + a * w + c] : rb[a] - s[ch.L.sv + a];
    }
    __syncthreads();
    gj(M, w, w + 1, s + ch.L.prow, s + ch.L.pcol, s + ch.L.pv, &piv_row);
    for (int a = tid; a < w; a += kThreads) ch.xb[b * w + a] = M[a * (w + 1) + w];
  }
  __syncthreads();
  T* X = ch.X + b * (size_t)N * n;
  T* xs = s + ch.L.xs;
  // x_{N-1} = Ainv rtil - (Ainv Etil) xb, from the last step's AE and Ar
  for (int a = tid; a < n; a += kThreads) {
    T acc = T(0);
    for (int q = 0; q < w; ++q) acc += s[ch.L.AE + a * w + q] * M[q * (w + 1) + w];
    xs[a] = s[ch.L.Ar + a] - acc;
    X[(size_t)(N - 1) * n + a] = xs[a];
  }
  __syncthreads();
  for (int i = N - 2; i >= 0; --i) {
    // Ainv_i, B_i, Etil_i, rtil_i from the workspace; t = (rtil_i - B_i x_{i+1}) - Etil_i xb
    T *Ap = s + ch.L.Ap, *Bm = s + ch.L.Bm, *Et = s + ch.L.E2, *rt = s + ch.L.r2, *tv = s + ch.L.Ar;
    const T* Ainv = at(ch.Ainv, i, nn);
    const T* Bi = ch.Bc + (b * (N - 1) + i) * (size_t)nn;
    const T* Etil = at(ch.Etil, i, nw);
    const T* rtil = at(ch.rtil, i, n);
    for (int k = tid; k < nn; k += kThreads) {
      Ap[k] = Ainv[k];
      Bm[k] = Bi[k];
    }
    for (int k = tid; k < nw; k += kThreads) Et[k] = Etil[k];
    for (int a = tid; a < n; a += kThreads) rt[a] = rtil[a];
    __syncthreads();
    for (int a = tid; a < n; a += kThreads) {
      T bx = T(0), ex = T(0);
      for (int q = 0; q < n; ++q) bx += Bm[a * n + q] * xs[q];
      for (int q = 0; q < w; ++q) ex += Et[a * w + q] * M[q * (w + 1) + w];
      tv[a] = (rt[a] - bx) - ex;
    }
    __syncthreads();
    for (int a = tid; a < n; a += kThreads) {  // x_i (x_{i+1} was read in the phase before)
      T acc = T(0);
      for (int q = 0; q < n; ++q) acc += Ap[a * n + q] * tv[q];
      X[(size_t)i * n + a] = acc;
      xs[a] = acc;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const T* A, const T* Bc, const T* E, const T* F, const T* r, const T* rb, T* X, T* xb, T* work,
           int N, int bs, int wb, int B, void* stream) {
  if (!valid(N, bs, wb, B)) return (int)cudaErrorInvalidValue;
  const Layout L = layout(bs, wb);
  const int smem = (int)(L.total * sizeof(T));
  if (smem > kDefaultSmem) {  // per launch: the attribute belongs to the current device
    const int rc = (int)cudaFuncSetAttribute((const void*)scan_kernel<T>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc) return rc;
  }
  const size_t nB = B, nN = N;
  Chain<T> ch{A, Bc, E, F, r, rb, X, xb, work, nullptr, nullptr, N, bs, wb, L};
  ch.Etil = ch.Ainv + nB * nN * bs * bs;
  ch.rtil = ch.Etil + nB * nN * bs * wb;
  scan_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(ch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements (of the kernel's dtype) of the workspace the caller allocates.
size_t scan_workspace_elems(int N, int bs, int wb, int B) {
  return (size_t)B * N * ((size_t)bs * bs + (size_t)bs * wb + bs);
}

// Dynamic shared memory bytes of one chain's CTA, or -1 for a shape the
// kernel does not take.
long long scan_smem_bytes(int bs, int wb, int itemsize) {
  if (!valid(1, bs, wb, 1)) return -1;
  return (long long)layout(bs, wb).total * itemsize;
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
