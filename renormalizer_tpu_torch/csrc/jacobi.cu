// Symmetric eigensolver by parallel-ordered cyclic Jacobi, for Hopper.
//
// Replaces the Pallas TPU kernel `_jacobi_factory.<locals>.kernel`
// (renormalizer_tpu/ops/jacobi.py:115-233, pallas_call at 238-260), which
// the truncation path uses for the Rayleigh-Ritz Gram eigh.  Same contract:
//   * input: B real symmetric n x n matrices, n even (the wrapper pads with
//     exact zeros; a zero off-diagonal gives an identity rotation, so the
//     padding never mixes with the real block);
//   * each round rotates the n/2 disjoint pairs (top[i], bot[i]) with the
//     Rutishauser formula and the same `tiny` guard as jacobi.py:166-177,
//     then re-pairs them by the round-robin tournament
//     top' = [t0, b0, t1..t_{m-2}], bot' = [b1..b_{m-1}, t_{m-1}];
//     n-1 rounds form a sweep, after which the pairing is the identity again;
//   * at least `sweeps` sweeps, then more while the off-diagonal Frobenius
//     norm squared exceeds eps^2 ||A||_F^2, up to `max_sweeps`;
//   * outputs: the diagonal (unsorted eigenvalues), the eigenvectors as the
//     columns of V (column k belongs to w[k]) and the relative off-diagonal
//     residual sqrt(max(off, 0) / (||A||^2 + tol2)).
// The TPU kernel moves data to re-pair; here the tournament permutes a
// pair-index table in shared memory (double-buffered) and the data stays.
// As on the TPU, the off-diagonal norm is total - diagonal, summed in the
// working type: at convergence it sits at the rounding level of ||A||^2, so
// the extra sweeps run only while a solve is visibly unconverged.
//
// Design (simple first): one CTA per matrix; the grid is the batch.  A and
// V stay in global memory, resident in L2: an f32 Gram at n = 288 is 332 KB,
// over the 227 KB of shared memory a CTA can use before V is counted.  A
// round is three passes separated by __syncthreads(): (1) the n/2 (c, s)
// pairs into shared memory, (2) the row rotations, (3) the column
// rotations and the V update.
//
// What bounds it on an H100: every round streams ~3 n^2 elements through
// L2 twice (read and write) from ONE SM, plus three block barriers, and a
// solve is (n-1) x sweeps rounds; with batch-many CTAs only batch-many of
// the 132 SMs work.  A later version would keep A and V on chip across a
// 2-4 CTA cluster (distributed shared memory), fuse the row and column
// passes into one pass over 2x2 blocks, and split one solve over more SMs.

#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kIlp = 4;  // independent items per thread per step

template <typename T> struct Num;
template <> struct Num<float> {
  __device__ static float tiny() { return FLT_MIN; }
  __device__ static float eps() { return FLT_EPSILON; }
  __device__ static float sqrt_(float x) { return sqrtf(x); }
  __device__ static float abs_(float x) { return fabsf(x); }
};
template <> struct Num<double> {
  __device__ static double tiny() { return DBL_MIN; }
  __device__ static double eps() { return DBL_EPSILON; }
  __device__ static double sqrt_(double x) { return sqrt(x); }
  __device__ static double abs_(double x) { return fabs(x); }
};

// Block-wide sum; every thread gets the result.  `red` holds 33 slots.
template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // earlier readers of red[32] are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// Off-diagonal Frobenius norm squared (total - diagonal); the diagonal part
// goes to *diag.
template <typename T>
__device__ T off_diag2(const T* a, int n, T* red, T* diag) {
  T tot = T(0), dg = T(0);
  for (int k = threadIdx.x; k < n * n; k += blockDim.x) tot += a[k] * a[k];
  for (int i = threadIdx.x; i < n; i += blockDim.x) dg += a[i * n + i] * a[i * n + i];
  tot = block_sum(tot, red);
  dg = block_sum(dg, red);
  *diag = dg;
  return tot - dg;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
jacobi_kernel(T* __restrict__ a_all, T* __restrict__ v_all,
              T* __restrict__ w_all, T* __restrict__ resid_all,
              int n, int sweeps, int max_sweeps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m = n / 2;
  T* cs = reinterpret_cast<T*>(smem_raw);  // c at [0, m), s at [m, 2m)
  T* red = cs + 2 * m;                      // 33 reduction slots
  int* pairs = reinterpret_cast<int*>(red + 33);  // 2 buffers x (top, bot)

  T* a = a_all + (size_t)blockIdx.x * n * n;
  T* v = v_all + (size_t)blockIdx.x * n * n;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int k = tid; k < n * n; k += nt) v[k] = (k / n == k % n) ? T(1) : T(0);
  for (int i = tid; i < m; i += nt) {
    pairs[i] = i;
    pairs[m + i] = m + i;
  }

  T diag0;
  const T off0 = off_diag2(a, n, red, &diag0);  // its barriers order the init
  const T norm2 = off0 + diag0;
  const T eps = Num<T>::eps(), tiny = Num<T>::tiny();
  const T tol2 = eps * eps * norm2;

  int cur = 0;
  int isweep = 0;
  T off = off0 + T(1);
  while (isweep < sweeps || (off > tol2 && isweep < max_sweeps)) {
    for (int round = 0; round < n - 1; ++round) {
      const int* top = pairs + cur * n;
      const int* bot = top + m;
      int* ntop = pairs + (cur ^ 1) * n;
      int* nbot = ntop + m;
      // pass 1: rotation angles; re-pair into the other buffer
      for (int i = tid; i < m; i += nt) {
        const int p = top[i], q = bot[i];
        const T app = a[p * n + p], aqq = a[q * n + q], apq = a[p * n + q];
        const bool safe = Num<T>::abs_(apq) > tiny;
        const T theta = (aqq - app) / (safe ? T(2) * apq : T(1));
        const T sgn = theta >= T(0) ? T(1) : T(-1);
        const T t = sgn / (Num<T>::abs_(theta) +
                           Num<T>::sqrt_(T(1) + theta * theta));
        const T c = T(1) / Num<T>::sqrt_(T(1) + t * t);
        cs[i] = safe ? c : T(1);
        cs[m + i] = safe ? t * c : T(0);
        ntop[i] = i == 0 ? top[0] : (i == 1 ? bot[0] : top[i - 1]);
        nbot[i] = i == m - 1 ? top[m - 1] : bot[i + 1];
      }
      __syncthreads();
      // pass 2: rows p, q <- (c p - s q, s p + c q); item k = (pair, col)
      for (int k0 = tid; k0 < m * n; k0 += nt * kIlp) {
        T ap[kIlp], aq[kIlp];
        int ip[kIlp], iq[kIlp], ii[kIlp];
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
          const int k = k0 + u * nt;
          ii[u] = -1;
          if (k < m * n) {
            const int i = k / n, j = k - i * n;
            ii[u] = i;
            ip[u] = top[i] * n + j;
            iq[u] = bot[i] * n + j;
            ap[u] = a[ip[u]];
            aq[u] = a[iq[u]];
          }
        }
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
          if (ii[u] < 0) continue;
          const T c = cs[ii[u]], s = cs[m + ii[u]];
          a[ip[u]] = c * ap[u] - s * aq[u];
          a[iq[u]] = s * ap[u] + c * aq[u];
        }
      }
      __syncthreads();
      // pass 3: columns p, q of A and V; item k = (row, pair)
      for (int k0 = tid; k0 < m * n; k0 += nt * kIlp) {
        T ap[kIlp], aq[kIlp], vp[kIlp], vq[kIlp];
        int ip[kIlp], iq[kIlp], ii[kIlp];
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
          const int k = k0 + u * nt;
          ii[u] = -1;
          if (k < m * n) {
            const int r = k / m, i = k - r * m;
            ii[u] = i;
            ip[u] = r * n + top[i];
            iq[u] = r * n + bot[i];
            ap[u] = a[ip[u]];
            aq[u] = a[iq[u]];
            vp[u] = v[ip[u]];
            vq[u] = v[iq[u]];
          }
        }
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
          if (ii[u] < 0) continue;
          const T c = cs[ii[u]], s = cs[m + ii[u]];
          a[ip[u]] = ap[u] * c - aq[u] * s;
          a[iq[u]] = ap[u] * s + aq[u] * c;
          v[ip[u]] = vp[u] * c - vq[u] * s;
          v[iq[u]] = vp[u] * s + vq[u] * c;
        }
      }
      __syncthreads();
      cur ^= 1;
    }
    T diag;
    off = off_diag2(a, n, red, &diag);
    ++isweep;
  }

  T* w = w_all + (size_t)blockIdx.x * n;
  for (int i = tid; i < n; i += nt) w[i] = a[i * n + i];
  if (tid == 0) resid_all[blockIdx.x] = Num<T>::sqrt_((off > T(0) ? off : T(0)) / (norm2 + tol2));
}

template <typename T>
int launch(void* a, void* v, void* w, void* resid, int batch, int n,
           int sweeps, int max_sweeps, void* stream) {
  const int m = n / 2;
  // at most the default 48 KB of dynamic shared memory: ops/jacobi.py
  // rejects the sizes that would need more
  const size_t smem = (2 * m + 33) * sizeof(T) + 2 * n * sizeof(int);
  jacobi_kernel<T><<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (T*)a, (T*)v, (T*)w, (T*)resid, n, sweeps, max_sweeps);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  `a` is the padded (batch, n, n)
// working copy and is overwritten; `v` (batch, n, n), `w` (batch, n) and
// `resid` (batch,) are outputs.  Returns cudaGetLastError() after the launch.
extern "C" int reno_jacobi_eigh_f32(void* a, void* v, void* w, void* resid,
                                    int batch, int n, int sweeps,
                                    int max_sweeps, void* stream) {
  return launch<float>(a, v, w, resid, batch, n, sweeps, max_sweeps, stream);
}

extern "C" int reno_jacobi_eigh_f64(void* a, void* v, void* w, void* resid,
                                    int batch, int n, int sweeps,
                                    int max_sweeps, void* stream) {
  return launch<double>(a, v, w, resid, batch, n, sweeps, max_sweeps, stream);
}
