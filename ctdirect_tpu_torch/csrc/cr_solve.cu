// Batched block cyclic reduction (CR) of the symmetric block-tridiagonal +
// arrowhead KKT system, hand-written for Hopper (sm_90a), f32 and f64.
//
// Replaces the TPU kernel ctdirect_tpu/solver/pallas_cr.py::cr_solve_lanes_pallas
// (body _cr_kernel, helper _gj_inverse) and computes what it and the plain
// version solver/lanes.py::cr_solve_lanes compute, with the same recurrences:
// per level a pivoted Gauss-Jordan inverse of the odd blocks (pivot = first
// row of maximal |value|, as torch.argmax picks it), Schur updates of the
// even blocks, couplings, border columns and rhs, the border updates
// F -= Eo^T Ao^-1 Eo and rb -= Eo^T Ao^-1 ro; then a dense (bs+wb) pivoted
// Gauss-Jordan root solve; then back-substitution down the levels.
//
// Contract (lane-minor, batch last, as the wrapper and the plain version hold it):
//   A, Bp (P,bs,bs,B); E (P,bs,wb,B); F (wb,wb,B); r (P,bs,B); rb (wb,B)
//   -> X (P,bs,B), xb (wb,B).   P is a power of two (padded by the caller).
//
// Design: level-parallel. One solve is a sequence of launches on the caller's
// stream, with no host synchronisation (the plan: cr_plan below):
//   pack      tiled transpose of the inputs into a block-major workspace, one
//             instance after the other, so that one block is contiguous;
//   per level (stride s, H = P/2s odd blocks per instance):
//     up_odd  one warp per (instance, odd block): loads A_o, its couplings,
//             border columns and rhs into shared memory, inverts A_o by a
//             warp-wide pivoted Gauss-Jordan (lanes over columns, the pivot by
//             a warp-shuffle arg-max with the first-index tie-break), writes
//             its own (left) even block's update in place, and the right
//             even block's update and its border terms into a scratch record;
//     up_even one warp per (instance, even block): adds the right-neighbour
//             term from the scratch record, after the left term, in the plain
//             version's order; the warp of even block 0 reduces the border
//             terms of the level in a fixed order. Every block has one writer
//             per launch: no atomics, and the result does not depend on the
//             schedule;
//   root      one warp per instance: the dense (bs+wb) pivoted Gauss-Jordan;
//   down      per level, one warp per (instance, odd block);
//   unpack    tiled transpose of the solution back to the lane-minor layout.
// That is 3 + 3 log2(P) launches (27 at P = 256). Every working array lives
// in dynamic shared memory sized per launch (6 bs^2 + 2 bs wb + 3 bs elements
// per warp for up_odd, (n+1)n + n for the root); no thread holds an array
// that grows with the width, so nothing spills to local memory. The width
// bs + wb is capped at 64 (kMaxWidth): at 64 one up_odd warp needs at most
// 198 KB of f64 shared memory, inside a block's 227 KB.
//
// What bounds it on the H100 (counting each input read once and each output
// written once): P(2bs^2 + bs wb + 2bs) + wb^2 + 2wb elements per instance. At
// the MPC tick (P=128, bs=5, wb=7, B=512) that is 50.1 MB in f64 (15 us at
// 3.35 TB/s) and 25.0 MB in f32 (7.5 us): bytes bound it. The operations the
// reduction needs are about 12 bs^3 + 6 bs^2 wb + 2 bs wb^2 per odd block (an
// inverse and five block products) and a dense root solve; at one instance
// (B = 1) they are few, and the floor is the dependency depth: log2(P)
// levels of a bs-column pivoted elimination, one warp each, plus the launches.

#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>
#include <vector>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWidth = 64;         // cap on bs + wb
constexpr int kMaxSmem = 232448;      // dynamic shared memory one block may use
constexpr int kDefaultSmem = 49152;   // above this a kernel needs the attribute
constexpr long long kSmallGrid = 2048;  // fewer warps than this: one warp per block
constexpr int kTile = 32, kTileRows = 8;

enum Kind { kPack = 0, kUpOdd = 1, kUpEven = 2, kRoot = 3, kDown = 4, kUnpack = 5 };

struct Shape {
  int P, bs, wb, B;
};

// One launch of the plan.
struct Launch {
  int kind;
  long long blocks;
  int threads, smem;
  int s, H, save_off;
};

// The block-major workspace: per instance, its P blocks in a row.
template <typename T>
struct Work {
  T *A, *Bc, *Bl, *E, *r, *X, *F, *rb, *xb, *scr;
};

// Up to six (rows x cols) row-major matrices to transpose in one launch.
template <typename T>
struct Transposes {
  const T* in[6];
  T* out[6];
  long long rows[6], cols[6];
  int count;
};

__host__ __device__ inline size_t scr_record(int bs, int wb) {
  return (size_t)bs * bs + (size_t)bs * wb + bs + (size_t)wb * wb + wb;
}

// Shared-memory elements per warp of up_odd and of the root solve.
__host__ __device__ inline size_t up_odd_elems(int bs, int wb) {
  return 6 * (size_t)bs * bs + 2 * (size_t)bs * wb + 3 * (size_t)bs;
}
__host__ __device__ inline size_t root_elems(int bs, int wb) {
  return (size_t)(bs + wb) * (bs + wb + 1) + (bs + wb);
}

template <typename T>
__device__ __forceinline__ T absval(T x) {
  return x < T(0) ? -x : x;
}

// Pivoted Gauss-Jordan on the n x w row-major matrix G (leading dimension
// ld) by one warp: lanes over columns; fcol (n elements) holds the column
// being eliminated. The pivot is the first row of maximal |value| at or
// below the diagonal, as torch.argmax picks it.
template <typename T>
__device__ void warp_gj(T* G, int ld, int n, int w, T* fcol, int lane) {
  for (int j = 0; j < n; ++j) {
    T best = T(-1);
    int p = n;
    for (int i = j + lane; i < n; i += 32) {
      const T a = absval(G[i * ld + j]);
      if (a > best) {
        best = a;
        p = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const T ob = __shfl_xor_sync(kFull, best, off);
      const int op = __shfl_xor_sync(kFull, p, off);
      if (ob > best || (ob == best && op < p)) {
        best = ob;
        p = op;
      }
    }
    if (p >= n) p = j;  // a column of NaNs: keep the diagonal
    if (p != j) {
      for (int c = lane; c < w; c += 32) {
        const T t = G[j * ld + c];
        G[j * ld + c] = G[p * ld + c];
        G[p * ld + c] = t;
      }
      __syncwarp();
    }
    const T piv = G[j * ld + j];
    for (int i = lane; i < n; i += 32) fcol[i] = (i == j) ? T(0) : G[i * ld + j];
    __syncwarp();
    for (int c = lane; c < w; c += 32) {
      const T rj = G[j * ld + c] / piv;
      G[j * ld + c] = rj;
      for (int i = 0; i < n; ++i)
        if (i != j) G[i * ld + c] -= fcol[i] * rj;
    }
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(kTile * kTileRows) transpose_kernel(Transposes<T> t) {
  __shared__ T tile[kTile][kTile + 1];
  const int m = blockIdx.z;
  const long long rows = t.rows[m], cols = t.cols[m];
  const long long c0 = (long long)blockIdx.x * kTile;
  if (c0 >= cols) return;
  const T* in = t.in[m];
  T* out = t.out[m];
  for (long long r0 = (long long)blockIdx.y * kTile; r0 < rows; r0 += (long long)gridDim.y * kTile) {
    for (int k = threadIdx.y; k < kTile; k += kTileRows) {
      const long long r = r0 + k, c = c0 + threadIdx.x;
      if (r < rows && c < cols) tile[k][threadIdx.x] = in[r * cols + c];
    }
    __syncthreads();
    for (int k = threadIdx.y; k < kTile; k += kTileRows) {
      const long long c = c0 + k, r = r0 + threadIdx.x;
      if (r < rows && c < cols) out[c * rows + r] = tile[threadIdx.x][k];
    }
    __syncthreads();
  }
}

// The warp's item (instance b, block j of the level); false past the end.
__device__ __forceinline__ bool warp_item(long long items, int H, int& b, int& j) {
  const long long item = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (item >= items) return false;
  b = (int)(item / H);
  j = (int)(item % H);
  return true;
}

template <typename T>
__global__ void up_odd(Work<T> w, Shape sh, int s, int H, int save_off) {
  int b, j;
  if (!warp_item((long long)sh.B * H, H, b, j)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, bs = sh.bs, wb = sh.wb;
  const int bb = bs * bs, be = bs * wb, ld = 2 * bs;
  T* G = reinterpret_cast<T*>(smem_raw) + (threadIdx.x >> 5) * up_odd_elems(bs, wb);
  T* Blm = G + bs * ld;
  T* Brm = Blm + bb;
  T* CL = Brm + bb;
  T* CR = CL + bb;
  T* Eo = CR + bb;
  T* AiE = Eo + be;
  T* ro = AiE + be;
  T* Air = ro + bs;
  T* fcol = Air + bs;

  const int e = 2 * j * s, o = e + s;
  const bool has_next = j + 1 < H;
  const size_t inst = (size_t)b * sh.P;
  T* Ao_g = w.A + (inst + o) * bb;
  T* Ae_g = w.A + (inst + e) * bb;
  T* Be_g = w.Bc + (inst + e) * bb;
  const T* Bo_g = w.Bc + (inst + o) * bb;
  T* Ee_g = w.E + (inst + e) * be;
  const T* Eo_g = w.E + (inst + o) * be;
  T* re_g = w.r + (inst + e) * bs;
  const T* ro_g = w.r + (inst + o) * bs;
  T* save_g = w.Bl + (inst + save_off + j) * bb;
  T* rec = w.scr + ((size_t)b * (sh.P / 2) + j) * scr_record(bs, wb);
  T *dA = rec, *dE = rec + bb, *dr = dE + be, *dF = dr + bs, *drb = dF + wb * wb;

  for (int t = lane; t < bb; t += 32) {
    const int i = t / bs, c = t % bs;
    G[i * ld + c] = Ao_g[t];
    G[i * ld + bs + c] = (i == c) ? T(1) : T(0);
    const T bl = Be_g[t];
    Blm[t] = bl;
    save_g[t] = bl;  // Bl, for the down-sweep (its slot takes the new coupling)
    Brm[t] = Bo_g[t];
  }
  for (int t = lane; t < be; t += 32) Eo[t] = Eo_g[t];
  for (int t = lane; t < bs; t += 32) ro[t] = ro_g[t];
  __syncwarp();

  warp_gj(G, ld, bs, ld, fcol, lane);
  const T* Ai = G + bs;  // A_o^-1, row stride ld

  // A_o^-1 over A_o; CL = Bl A_o^-1, CR = Br^T A_o^-1
  for (int t = lane; t < bb; t += 32) {
    const int i = t / bs, k = t % bs;
    T cl = T(0), cr = T(0);
    for (int c = 0; c < bs; ++c) {
      cl += Blm[i * bs + c] * Ai[c * ld + k];
      cr += Brm[c * bs + i] * Ai[c * ld + k];
    }
    Ao_g[t] = Ai[i * ld + k];
    CL[t] = cl;
    CR[t] = cr;
  }
  __syncwarp();

  // own even block: A_e -= CL Bl^T, B_e = -CL Br (zero at the chain end);
  // the next even block's A term CR Br goes to the record
  for (int t = lane; t < bb; t += 32) {
    const int i = t / bs, k = t % bs;
    T a = T(0), bn = T(0), ar = T(0);
    for (int c = 0; c < bs; ++c) {
      a += CL[i * bs + c] * Blm[k * bs + c];
      bn += CL[i * bs + c] * Brm[c * bs + k];
      ar += CR[i * bs + c] * Brm[c * bs + k];
    }
    Ae_g[t] -= a;
    Be_g[t] = has_next ? -bn : T(0);
    if (has_next) dA[t] = ar;
  }
  // E_e -= CL Eo (CR Eo to the record); A_o^-1 Eo for the border
  for (int t = lane; t < be; t += 32) {
    const int i = t / wb, v = t % wb;
    T el = T(0), er = T(0), ae = T(0);
    for (int c = 0; c < bs; ++c) {
      const T x = Eo[c * wb + v];
      el += CL[i * bs + c] * x;
      er += CR[i * bs + c] * x;
      ae += Ai[i * ld + c] * x;
    }
    Ee_g[t] -= el;
    if (has_next) dE[t] = er;
    AiE[t] = ae;
  }
  for (int i = lane; i < bs; i += 32) {
    T rl = T(0), rr = T(0), ar = T(0);
    for (int c = 0; c < bs; ++c) {
      rl += CL[i * bs + c] * ro[c];
      rr += CR[i * bs + c] * ro[c];
      ar += Ai[i * ld + c] * ro[c];
    }
    re_g[i] -= rl;
    if (has_next) dr[i] = rr;
    Air[i] = ar;
  }
  __syncwarp();

  // border terms Eo^T A_o^-1 Eo and Eo^T A_o^-1 ro
  for (int t = lane; t < wb * wb; t += 32) {
    const int v = t / wb, x = t % wb;
    T f = T(0);
    for (int i = 0; i < bs; ++i) f += Eo[i * wb + v] * AiE[i * wb + x];
    dF[t] = f;
  }
  for (int v = lane; v < wb; v += 32) {
    T g = T(0);
    for (int i = 0; i < bs; ++i) g += Eo[i * wb + v] * Air[i];
    drb[v] = g;
  }
}

template <typename T>
__global__ void up_even(Work<T> w, Shape sh, int s, int H) {
  int b, j;
  if (!warp_item((long long)sh.B * H, H, b, j)) return;
  const int lane = threadIdx.x & 31, bs = sh.bs, wb = sh.wb;
  const int bb = bs * bs, be = bs * wb;
  const size_t rs = scr_record(bs, wb);
  const T* recs = w.scr + (size_t)b * (sh.P / 2) * rs;
  if (j > 0) {
    // the right-neighbour term of odd block j-1, after the left term
    const size_t inst = (size_t)b * sh.P, e = 2 * (size_t)j * s;
    const T* rec = recs + (j - 1) * rs;
    T* Ae = w.A + (inst + e) * bb;
    T* Ee = w.E + (inst + e) * be;
    T* re = w.r + (inst + e) * bs;
    for (int t = lane; t < bb; t += 32) Ae[t] -= rec[t];
    for (int t = lane; t < be; t += 32) Ee[t] -= rec[bb + t];
    for (int t = lane; t < bs; t += 32) re[t] -= rec[bb + be + t];
    return;
  }
  // even block 0's warp: the level's border terms, summed in block order
  const size_t off = (size_t)bb + be + bs;
  T* F = w.F + (size_t)b * wb * wb;
  T* rb = w.rb + (size_t)b * wb;
  for (int t = lane; t < wb * wb; t += 32) {
    T acc = T(0);
    for (int q = 0; q < H; ++q) acc += recs[q * rs + off + t];
    F[t] -= acc;
  }
  for (int v = lane; v < wb; v += 32) {
    T acc = T(0);
    for (int q = 0; q < H; ++q) acc += recs[q * rs + off + wb * wb + v];
    rb[v] -= acc;
  }
}

template <typename T>
__global__ void root_solve(Work<T> w, Shape sh) {
  int b, j;
  if (!warp_item(sh.B, 1, b, j)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, bs = sh.bs, wb = sh.wb, n = bs + wb, ld = n + 1;
  T* G = reinterpret_cast<T*>(smem_raw) + (threadIdx.x >> 5) * root_elems(bs, wb);
  T* fcol = G + n * ld;
  const size_t inst = (size_t)b * sh.P;
  const T* A0 = w.A + inst * bs * bs;
  const T* E0 = w.E + inst * bs * wb;
  const T* r0 = w.r + inst * bs;
  const T* F = w.F + (size_t)b * wb * wb;
  const T* rb = w.rb + (size_t)b * wb;
  // [[A0, E0, r0], [E0^T, F, rb]]
  for (int t = lane; t < n * ld; t += 32) {
    const int i = t / ld, c = t % ld;
    T x;
    if (i < bs)
      x = c < bs ? A0[i * bs + c] : (c < n ? E0[i * wb + c - bs] : r0[i]);
    else
      x = c < bs ? E0[c * wb + i - bs] : (c < n ? F[(i - bs) * wb + c - bs] : rb[i - bs]);
    G[t] = x;
  }
  __syncwarp();
  warp_gj(G, ld, n, ld, fcol, lane);
  for (int i = lane; i < n; i += 32) {
    if (i < bs)
      w.X[inst * bs + i] = G[i * ld + n];
    else
      w.xb[(size_t)b * wb + i - bs] = G[i * ld + n];
  }
}

// x_o = A_o^-1 (r_o - Bl^T x_e - Br x_{e+1} - Eo xb)
template <typename T>
__global__ void down(Work<T> w, Shape sh, int s, int H, int save_off) {
  int b, j;
  if (!warp_item((long long)sh.B * H, H, b, j)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, bs = sh.bs, wb = sh.wb, bb = bs * bs;
  T* rhs = reinterpret_cast<T*>(smem_raw) + (threadIdx.x >> 5) * bs;
  const int e = 2 * j * s, o = e + s;
  const bool has_next = j + 1 < H;
  const size_t inst = (size_t)b * sh.P;
  const T* Bl = w.Bl + (inst + save_off + j) * bb;
  const T* Br = w.Bc + (inst + o) * bb;
  const T* Eo = w.E + (inst + o) * bs * wb;
  const T* ro = w.r + (inst + o) * bs;
  const T* Ai = w.A + (inst + o) * bb;
  const T* xe = w.X + (inst + e) * bs;
  const T* xn = w.X + (inst + e + 2 * s) * bs;
  const T* xb = w.xb + (size_t)b * wb;
  for (int i = lane; i < bs; i += 32) {
    T a1 = T(0), a2 = T(0), a3 = T(0);
    for (int k = 0; k < bs; ++k) a1 += Bl[k * bs + i] * xe[k];
    if (has_next)
      for (int k = 0; k < bs; ++k) a2 += Br[i * bs + k] * xn[k];
    for (int v = 0; v < wb; ++v) a3 += Eo[i * wb + v] * xb[v];
    rhs[i] = ((ro[i] - a1) - a2) - a3;
  }
  __syncwarp();
  T* xo = w.X + (inst + o) * bs;
  for (int i = lane; i < bs; i += 32) {
    T acc = T(0);
    for (int k = 0; k < bs; ++k) acc += Ai[i * bs + k] * rhs[k];
    xo[i] = acc;
  }
}

bool valid(const Shape& sh) {
  return sh.P >= 1 && (sh.P & (sh.P - 1)) == 0 && sh.bs >= 1 && sh.wb >= 0 && sh.B >= 1 &&
         sh.bs + sh.wb <= kMaxWidth;
}

size_t workspace_elems(const Shape& sh) {
  const size_t P = sh.P, bs = sh.bs, wb = sh.wb, B = sh.B;
  return B * (3 * P * bs * bs + P * bs * wb + 2 * P * bs + wb * wb + 2 * wb + (P / 2) * scr_record(sh.bs, sh.wb));
}

// One launch of warp-per-item work: one warp per block below kSmallGrid
// items (spread over the SMs), else 4, fewer if shared memory says so.
Launch warp_launch(int kind, long long items, size_t warp_bytes, int s, int H, int save_off) {
  int wpb = items >= kSmallGrid ? 4 : 1;
  while (wpb > 1 && wpb * warp_bytes > (size_t)kMaxSmem) wpb >>= 1;
  return Launch{kind, (items + wpb - 1) / wpb, 32 * wpb, (int)(wpb * warp_bytes), s, H, save_off};
}

long long transpose_blocks(long long max_rows, long long max_cols, int count) {
  long long gy = (max_rows + kTile - 1) / kTile;
  if (gy > 65535) gy = 65535;
  return ((max_cols + kTile - 1) / kTile) * gy * count;
}

std::vector<Launch> plan(const Shape& sh, int itemsize) {
  std::vector<Launch> out;
  const long long P = sh.P, bs = sh.bs, wb = sh.wb, B = sh.B;
  // pack: A, Bp, r, and E, F, rb where wb > 0; unpack: X, and xb where wb > 0
  const long long pack_rows = wb > 0 ? std::max(P * bs * std::max(bs, wb), wb * wb) : P * bs * bs;
  out.push_back(Launch{kPack, transpose_blocks(pack_rows, B, wb > 0 ? 6 : 3), kTile * kTileRows, 0, 0, 0, 0});
  int save_off = 0;
  for (int s = 1; s < sh.P; s <<= 1) {
    const int H = sh.P / (2 * s);
    out.push_back(warp_launch(kUpOdd, B * H, up_odd_elems(sh.bs, sh.wb) * itemsize, s, H, save_off));
    out.push_back(warp_launch(kUpEven, B * H, 0, s, H, save_off));
    save_off += H;
  }
  out.push_back(warp_launch(kRoot, B, root_elems(sh.bs, sh.wb) * itemsize, 0, 1, 0));
  for (int s = sh.P / 2; s >= 1; s >>= 1) {
    const int H = sh.P / (2 * s);
    save_off -= H;
    out.push_back(warp_launch(kDown, B * H, (size_t)bs * itemsize, s, H, save_off));
  }
  out.push_back(Launch{kUnpack, transpose_blocks(B, std::max(P * bs, wb), wb > 0 ? 2 : 1), kTile * kTileRows, 0,
                       0, 0, 0});
  return out;
}

template <typename T>
int run_transposes(const Transposes<T>& t, cudaStream_t st) {
  long long max_rows = 0, max_cols = 0;
  for (int m = 0; m < t.count; ++m) {
    if (t.rows[m] > max_rows) max_rows = t.rows[m];
    if (t.cols[m] > max_cols) max_cols = t.cols[m];
  }
  long long gy = (max_rows + kTile - 1) / kTile;
  if (gy > 65535) gy = 65535;
  const dim3 grid((unsigned)((max_cols + kTile - 1) / kTile), (unsigned)gy, t.count);
  transpose_kernel<T><<<grid, dim3(kTile, kTileRows), 0, st>>>(t);
  return (int)cudaGetLastError();
}

template <typename K>
int shared_attribute(K kernel, int smem) {
  if (smem <= kDefaultSmem) return 0;
  return (int)cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T>
int launch(const T* A, const T* Bp, const T* E, const T* F, const T* r, const T* rb, T* X, T* xb,
           T* work, int P, int bs, int wb, int B, void* stream, int* launched) {
  *launched = 0;
  const Shape sh{P, bs, wb, B};
  if (!valid(sh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t nP = P, nB = B;
  Work<T> w;
  w.A = work;
  w.Bc = w.A + nB * nP * bs * bs;
  w.Bl = w.Bc + nB * nP * bs * bs;
  w.E = w.Bl + nB * nP * bs * bs;
  w.r = w.E + nB * nP * bs * wb;
  w.X = w.r + nB * nP * bs;
  w.F = w.X + nB * nP * bs;
  w.rb = w.F + nB * wb * wb;
  w.xb = w.rb + nB * wb;
  w.scr = w.xb + nB * wb;

  int rc = 0;
  for (const Launch& l : plan(sh, (int)sizeof(T))) {
    const dim3 grid((unsigned)l.blocks), block(l.threads);
    switch (l.kind) {
      case kPack: {
        // lane-minor (rows, B) -> block-major (B, rows)
        Transposes<T> t{};
        auto add = [&](const T* in, T* out, long long rows) {
          t.in[t.count] = in, t.out[t.count] = out, t.rows[t.count] = rows, t.cols[t.count] = B;
          ++t.count;
        };
        add(A, w.A, (long long)P * bs * bs);
        add(Bp, w.Bc, (long long)P * bs * bs);
        add(r, w.r, (long long)P * bs);
        if (wb > 0) {
          add(E, w.E, (long long)P * bs * wb);
          add(F, w.F, (long long)wb * wb);
          add(rb, w.rb, wb);
        }
        rc = run_transposes(t, st);
        break;
      }
      case kUpOdd:
        rc = shared_attribute(up_odd<T>, l.smem);
        if (!rc) {
          up_odd<T><<<grid, block, l.smem, st>>>(w, sh, l.s, l.H, l.save_off);
          rc = (int)cudaGetLastError();
        }
        break;
      case kUpEven:
        up_even<T><<<grid, block, 0, st>>>(w, sh, l.s, l.H);
        rc = (int)cudaGetLastError();
        break;
      case kRoot:
        rc = shared_attribute(root_solve<T>, l.smem);
        if (!rc) {
          root_solve<T><<<grid, block, l.smem, st>>>(w, sh);
          rc = (int)cudaGetLastError();
        }
        break;
      case kDown:
        down<T><<<grid, block, l.smem, st>>>(w, sh, l.s, l.H, l.save_off);
        rc = (int)cudaGetLastError();
        break;
      case kUnpack: {
        // block-major (B, P bs) and (B, wb) -> lane-minor
        Transposes<T> t{};
        t.in[0] = w.X, t.out[0] = X, t.rows[0] = B, t.cols[0] = (long long)P * bs, t.count = 1;
        if (wb > 0) t.in[1] = w.xb, t.out[1] = xb, t.rows[1] = B, t.cols[1] = wb, t.count = 2;
        rc = run_transposes(t, st);
        break;
      }
    }
    if (rc) return rc;
    ++*launched;
  }
  return 0;
}

}  // namespace

extern "C" {

// Elements (of the kernel's dtype) of the workspace the caller allocates.
size_t cr_workspace_elems(int P, int bs, int wb, int B) {
  return workspace_elems(Shape{P, bs, wb, B});
}

// The launch plan of one solve: writes (kind, blocks, threads, shared bytes)
// per launch into out (4 * max_launches long longs) and returns the number
// of launches, or -1 for a shape the kernel does not take.
int cr_plan(int P, int bs, int wb, int B, int itemsize, long long* out, int max_launches) {
  const Shape sh{P, bs, wb, B};
  if (!valid(sh)) return -1;
  const std::vector<Launch> ls = plan(sh, itemsize);
  if ((int)ls.size() > max_launches) return -1;
  for (size_t i = 0; i < ls.size(); ++i) {
    out[4 * i] = ls[i].kind;
    out[4 * i + 1] = ls[i].blocks;
    out[4 * i + 2] = ls[i].threads;
    out[4 * i + 3] = ls[i].smem;
  }
  return (int)ls.size();
}

// Each returns 0 when every launch of the solve was issued, else the first
// failing launch's cudaError_t; *launched counts the launches issued.
int cr_solve_f32(const float* A, const float* Bp, const float* E, const float* F, const float* r,
                 const float* rb, float* X, float* xb, float* work, int P, int bs, int wb, int B,
                 void* stream, int* launched) {
  return launch<float>(A, Bp, E, F, r, rb, X, xb, work, P, bs, wb, B, stream, launched);
}

int cr_solve_f64(const double* A, const double* Bp, const double* E, const double* F,
                 const double* r, const double* rb, double* X, double* xb, double* work, int P,
                 int bs, int wb, int B, void* stream, int* launched) {
  return launch<double>(A, Bp, E, F, r, rb, X, xb, work, P, bs, wb, B, stream, launched);
}

}  // extern "C"
