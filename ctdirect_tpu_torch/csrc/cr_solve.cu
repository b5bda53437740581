// Batched block cyclic reduction (CR) of the symmetric block-tridiagonal +
// arrowhead KKT system, hand-written for Hopper (sm_90a), f32 and f64.
//
// Replaces the TPU kernel ctdirect_tpu/solver/pallas_cr.py::cr_solve_lanes_pallas
// (body _cr_kernel, helper _gj_inverse) and computes what it computes, in the
// same elimination order: per level a pivoted Gauss-Jordan inverse of the odd
// blocks (pivot = first row of maximal |value|), Schur updates of the even
// blocks, couplings, border columns and rhs, the border updates
// F -= Eo^T Ao^-1 Eo and rb -= Eo^T Ao^-1 ro; then a dense (bs+wb) pivoted
// Gauss-Jordan root solve; then back-substitution down the levels.
//
// Layout: lane-minor, batch last, exactly as the Python wrapper and the plain
// PyTorch version (solver/lanes.py::cr_solve_lanes) hold it:
//   A, Bp (P,bs,bs,B); E (P,bs,wb,B); F (wb,wb,B); r (P,bs,B); rb (wb,B)
//   -> X (P,bs,B), xb (wb,B).   P is a power of two (padded by the caller).
//
// Design (the simple one, right first): one thread per instance (lane b),
// looping over the levels. Global arrays stay lane-minor, so the 32 threads
// of a warp touch 32 neighbouring words on every access. The thread first
// copies its lane into a workspace (the inputs stay untouched) and reduces it
// in place with a stride that doubles per level: A_o^-1 overwrites A_o, and
// Br, Eo, ro stay put at the odd slots, which no later level writes; only Bl
// is saved aside, because B_new takes its slot. The small Gauss-Jordan
// working matrix lives in a per-thread array with a compile-time cap
// (bs + wb <= 16, <= 32 or <= 48: three instantiations). The array G[CAP][2*CAP]
// sits in local memory; its frame grows with CAP^2 (CAP=48 in f64: ~37 KB per
// thread), and the CUDA runtime reserves that frame for every thread that can
// be resident on the card.
//
// What bounds it on the H100: at the MPC tick shape (P=128, bs=5, wb=7,
// B=512, f64) the block data is ~47 MB (A, Bp 13.1 MB each, E 18.4 MB,
// r 2.6 MB); the kernel reads it once, writes and re-reads the workspace copy
// and the Bl saves, ~0.15 GB of traffic in all, i.e. ~45 us at 3.35 TB/s.
// This design is far from that floor: B=512 threads fill 4 blocks of 128 on
// 132 SMs, and each thread walks ~P dependent small-matrix steps, so it is
// latency-bound, not bandwidth-bound. Parallelizing within an instance (a
// warp per instance, or the chain across threads) is later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxWidth = 48;  // cap on bs + wb

template <typename T>
__device__ __forceinline__ T absval(T x) {
  return x < T(0) ? -x : x;
}

// Pivoted Gauss-Jordan on the n x w augmented matrix held in G.
template <typename T, int CAP>
__device__ void gj_eliminate(T (&G)[CAP][2 * CAP], int n, int w) {
  for (int j = 0; j < n; ++j) {
    int p = j;
    T best = absval(G[j][j]);
    for (int i = j + 1; i < n; ++i) {
      const T a = absval(G[i][j]);
      if (a > best) {
        best = a;
        p = i;
      }
    }
    if (p != j) {
      for (int c = 0; c < w; ++c) {
        const T t = G[j][c];
        G[j][c] = G[p][c];
        G[p][c] = t;
      }
    }
    const T piv = G[j][j];
    for (int c = 0; c < w; ++c) G[j][c] = G[j][c] / piv;
    for (int i = 0; i < n; ++i) {
      if (i == j) continue;
      const T f = G[i][j];
      for (int c = 0; c < w; ++c) G[i][c] -= f * G[j][c];
    }
  }
}

template <typename T, int CAP>
__global__ void __launch_bounds__(kThreads)
cr_solve_kernel(const T* __restrict__ A, const T* __restrict__ Bp,
                const T* __restrict__ E, const T* __restrict__ F,
                const T* __restrict__ r, const T* __restrict__ rb,
                T* __restrict__ X, T* __restrict__ xb, T* __restrict__ work,
                int P, int bs, int wb, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t nB = (size_t)B;

  // workspace: Aw, Bw (P,bs,bs,B); Ew (P,bs,wb,B); rw (P,bs,B); Fw (wb,wb,B);
  // rbw (wb,B); Bl saves (P,bs,bs,B) — see cr_workspace_elems
  const size_t blk = (size_t)P * bs * bs * nB;
  T* Aw = work;
  T* Bw = Aw + blk;
  T* Ew = Bw + blk;
  T* rw = Ew + (size_t)P * bs * wb * nB;
  T* Fw = rw + (size_t)P * bs * nB;
  T* rbw = Fw + (size_t)wb * wb * nB;
  T* Bl = rbw + (size_t)wb * nB;

  // lane-minor offsets of this thread's elements
  auto ab = [=](int p, int i, int j) { return (((size_t)p * bs + i) * bs + j) * nB + b; };
  auto eb = [=](int p, int i, int w) { return (((size_t)p * bs + i) * wb + w) * nB + b; };
  auto rv = [=](int p, int i) { return ((size_t)p * bs + i) * nB + b; };
  auto fb = [=](int v, int w) { return ((size_t)v * wb + w) * nB + b; };
  auto bv = [=](int w) { return (size_t)w * nB + b; };

  for (int p = 0; p < P; ++p) {
    for (int i = 0; i < bs; ++i) {
      for (int j = 0; j < bs; ++j) {
        Aw[ab(p, i, j)] = A[ab(p, i, j)];
        Bw[ab(p, i, j)] = Bp[ab(p, i, j)];
      }
      for (int w = 0; w < wb; ++w) Ew[eb(p, i, w)] = E[eb(p, i, w)];
      rw[rv(p, i)] = r[rv(p, i)];
    }
  }
  for (int v = 0; v < wb; ++v) {
    for (int w = 0; w < wb; ++w) Fw[fb(v, w)] = F[fb(v, w)];
    rbw[bv(v)] = rb[bv(v)];
  }

  T G[CAP][2 * CAP];
  T tmp[CAP];

  // ---- up-sweep: level with stride s has P/s active blocks (at multiples
  // of s); eliminate the odd ones (o = (2j+1)s) into the even ones ----
  int save_off = 0;  // index of this level's first Bl save
  for (int s = 1; s < P; s <<= 1) {
    const int H = P / (2 * s);
    for (int jj = 0; jj < H; ++jj) {
      const int e = 2 * jj * s, o = e + s, en = e + 2 * s;
      const bool has_next = jj + 1 < H;
      const int sv = save_off + jj;

      // A_o^-1 (into G's right half, and over A_o in the workspace)
      for (int i = 0; i < bs; ++i) {
        for (int c = 0; c < bs; ++c) {
          G[i][c] = Aw[ab(o, i, c)];
          G[i][bs + c] = (i == c) ? T(1) : T(0);
        }
      }
      gj_eliminate<T, CAP>(G, bs, 2 * bs);
      for (int i = 0; i < bs; ++i)
        for (int c = 0; c < bs; ++c) Aw[ab(o, i, c)] = G[i][bs + c];
      for (int i = 0; i < bs; ++i)
        for (int c = 0; c < bs; ++c) Bl[ab(sv, i, c)] = Bw[ab(e, i, c)];

      // even block e, row by row of CL = Bl A_o^-1:
      // A_e -= CL Bl^T, E_e -= CL Eo, r_e -= CL ro, B_e = -CL Br
      for (int i = 0; i < bs; ++i) {
        for (int c = 0; c < bs; ++c) {
          T acc = T(0);
          for (int k = 0; k < bs; ++k) acc += Bl[ab(sv, i, k)] * G[k][bs + c];
          tmp[c] = acc;
        }
        for (int k2 = 0; k2 < bs; ++k2) {
          T acc = T(0);
          for (int c = 0; c < bs; ++c) acc += tmp[c] * Bl[ab(sv, k2, c)];
          Aw[ab(e, i, k2)] -= acc;
        }
        for (int w = 0; w < wb; ++w) {
          T acc = T(0);
          for (int c = 0; c < bs; ++c) acc += tmp[c] * Ew[eb(o, c, w)];
          Ew[eb(e, i, w)] -= acc;
        }
        {
          T acc = T(0);
          for (int c = 0; c < bs; ++c) acc += tmp[c] * rw[rv(o, c)];
          rw[rv(e, i)] -= acc;
        }
        // the last active coupling pairs with the chain end: zero
        for (int k2 = 0; k2 < bs; ++k2) {
          T acc = T(0);
          if (has_next)
            for (int c = 0; c < bs; ++c) acc += tmp[c] * Bw[ab(o, c, k2)];
          Bw[ab(e, i, k2)] = -acc;
        }
      }

      // next even block en, row by row of CR = Br^T A_o^-1:
      // A_en -= CR Br, E_en -= CR Eo, r_en -= CR ro
      if (has_next) {
        for (int i = 0; i < bs; ++i) {
          for (int c = 0; c < bs; ++c) {
            T acc = T(0);
            for (int k = 0; k < bs; ++k) acc += Bw[ab(o, k, i)] * G[k][bs + c];
            tmp[c] = acc;
          }
          for (int k2 = 0; k2 < bs; ++k2) {
            T acc = T(0);
            for (int c = 0; c < bs; ++c) acc += tmp[c] * Bw[ab(o, c, k2)];
            Aw[ab(en, i, k2)] -= acc;
          }
          for (int w = 0; w < wb; ++w) {
            T acc = T(0);
            for (int c = 0; c < bs; ++c) acc += tmp[c] * Ew[eb(o, c, w)];
            Ew[eb(en, i, w)] -= acc;
          }
          T acc = T(0);
          for (int c = 0; c < bs; ++c) acc += tmp[c] * rw[rv(o, c)];
          rw[rv(en, i)] -= acc;
        }
      }

      // border: F -= Eo^T A_o^-1 Eo, rb -= Eo^T A_o^-1 ro
      for (int w = 0; w < wb; ++w) {
        for (int i = 0; i < bs; ++i) {
          T acc = T(0);
          for (int k = 0; k < bs; ++k) acc += G[i][bs + k] * Ew[eb(o, k, w)];
          tmp[i] = acc;
        }
        for (int v = 0; v < wb; ++v) {
          T acc = T(0);
          for (int i = 0; i < bs; ++i) acc += Ew[eb(o, i, v)] * tmp[i];
          Fw[fb(v, w)] -= acc;
        }
      }
      for (int i = 0; i < bs; ++i) {
        T acc = T(0);
        for (int k = 0; k < bs; ++k) acc += G[i][bs + k] * rw[rv(o, k)];
        tmp[i] = acc;
      }
      for (int v = 0; v < wb; ++v) {
        T acc = T(0);
        for (int i = 0; i < bs; ++i) acc += Ew[eb(o, i, v)] * tmp[i];
        rbw[bv(v)] -= acc;
      }
    }
    save_off += H;
  }

  // ---- root: [[A0, E0], [E0^T, F]] [x0; xb] = [r0; rb] ----
  const int n = bs + wb;
  for (int i = 0; i < bs; ++i) {
    for (int c = 0; c < bs; ++c) G[i][c] = Aw[ab(0, i, c)];
    for (int w = 0; w < wb; ++w) G[i][bs + w] = Ew[eb(0, i, w)];
    G[i][n] = rw[rv(0, i)];
  }
  for (int v = 0; v < wb; ++v) {
    for (int c = 0; c < bs; ++c) G[bs + v][c] = Ew[eb(0, c, v)];
    for (int w = 0; w < wb; ++w) G[bs + v][bs + w] = Fw[fb(v, w)];
    G[bs + v][n] = rbw[bv(v)];
  }
  gj_eliminate<T, CAP>(G, n, n + 1);
  for (int i = 0; i < bs; ++i) X[rv(0, i)] = G[i][n];
  for (int v = 0; v < wb; ++v) xb[bv(v)] = G[bs + v][n];

  // ---- down-sweep: x_o = A_o^-1 (ro - Bl^T x_e - Br x_{e+1} - Eo xb) ----
  for (int s = P / 2; s >= 1; s >>= 1) {
    const int H = P / (2 * s);
    save_off -= H;
    for (int jj = 0; jj < H; ++jj) {
      const int e = 2 * jj * s, o = e + s, en = e + 2 * s;
      const bool has_next = jj + 1 < H;
      const int sv = save_off + jj;
      for (int i = 0; i < bs; ++i) {
        T a1 = T(0), a2 = T(0), a3 = T(0);
        for (int k = 0; k < bs; ++k) a1 += Bl[ab(sv, k, i)] * X[rv(e, k)];
        if (has_next)
          for (int k = 0; k < bs; ++k) a2 += Bw[ab(o, i, k)] * X[rv(en, k)];
        for (int w = 0; w < wb; ++w) a3 += Ew[eb(o, i, w)] * xb[bv(w)];
        tmp[i] = ((rw[rv(o, i)] - a1) - a2) - a3;
      }
      for (int i = 0; i < bs; ++i) {
        T acc = T(0);
        for (int k = 0; k < bs; ++k) acc += Aw[ab(o, i, k)] * tmp[k];
        X[rv(o, i)] = acc;
      }
    }
  }
}

template <typename T>
int launch(const T* A, const T* Bp, const T* E, const T* F, const T* r,
           const T* rb, T* X, T* xb, T* work, int P, int bs, int wb, int B,
           void* stream) {
  if (P < 1 || (P & (P - 1)) != 0 || bs < 1 || wb < 0 || B < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + kThreads - 1) / kThreads), block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = bs + wb;
  if (n <= 16) {
    cr_solve_kernel<T, 16><<<grid, block, 0, st>>>(A, Bp, E, F, r, rb, X, xb,
                                                    work, P, bs, wb, B);
  } else if (n <= 32) {
    cr_solve_kernel<T, 32><<<grid, block, 0, st>>>(A, Bp, E, F, r, rb, X, xb,
                                                    work, P, bs, wb, B);
  } else if (n <= kMaxWidth) {
    cr_solve_kernel<T, 48><<<grid, block, 0, st>>>(A, Bp, E, F, r, rb, X, xb,
                                                    work, P, bs, wb, B);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements (of the kernel's dtype) of the workspace the caller allocates.
size_t cr_workspace_elems(int P, int bs, int wb, int B) {
  const size_t blk = (size_t)P * bs * bs * B;
  return 3 * blk + (size_t)P * bs * wb * B + (size_t)P * bs * B +
         (size_t)wb * wb * B + (size_t)wb * B;
}

int cr_max_width() { return kMaxWidth; }

// Each returns the cudaError_t of the launch (0 = launched).
int cr_solve_f32(const float* A, const float* Bp, const float* E,
                 const float* F, const float* r, const float* rb, float* X,
                 float* xb, float* work, int P, int bs, int wb, int B,
                 void* stream) {
  return launch<float>(A, Bp, E, F, r, rb, X, xb, work, P, bs, wb, B, stream);
}

int cr_solve_f64(const double* A, const double* Bp, const double* E,
                 const double* F, const double* r, const double* rb, double* X,
                 double* xb, double* work, int P, int bs, int wb, int B,
                 void* stream) {
  return launch<double>(A, Bp, E, F, r, rb, X, xb, work, P, bs, wb, B, stream);
}

}  // extern "C"
