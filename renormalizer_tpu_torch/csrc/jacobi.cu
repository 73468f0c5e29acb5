// Symmetric eigensolver by block Jacobi, for Hopper.
//
// Replaces the Pallas TPU kernel `_jacobi_factory.<locals>.kernel`
// (renormalizer_tpu/ops/jacobi.py:115-260, pallas_call at 238), the
// truncation path's Rayleigh-Ritz Gram eigh.  Same contract: B real
// symmetric n x n matrices in; the unsorted diagonal (eigenvalues), the
// eigenvector columns V, the relative off-diagonal residual and the sweep
// count out.  ops/jacobi.py holds the plain twin, step for step.
//
// Algorithm.  n is padded (by the wrapper, with exact zeros) to a multiple
// of kW = 32 and cut into 2k blocks of kB = 16.  A round pairs the blocks
// by the round-robin tournament (2k - 1 rounds form a sweep):
//   1. each pair P = (I, J) solves its 32 x 32 subproblem
//      [[A_II, A_IJ], [A_JI, A_JJ]] by scalar parallel Jacobi in shared
//      memory (one sweep of 31 rounds, none while no entry is above the
//      threshold: at the same block sweep count this beats sweeps to
//      convergence 2.4x on an H100) and yields the orthogonal Q_P;
//   2. every off-diagonal tile takes A[P, P'] <- Q_P^T A[P, P'] Q_P' (P < P'
//      computed, the transpose written to the mirror tile), the diagonal
//      tiles take the subproblems' results (made symmetric from their upper
//      triangles), and V[:, P'] <- V[:, P'] Q_P'.  A tile's new value needs
//      only its old value and two Qs, so all tiles update at once.
// A rotation of (p, q) runs only while |a_pq| > eps sqrt|a_pp| sqrt|a_qq|
// + eps ||A||_F / n + tiny and sets a_pq to exactly 0; Q accumulates in the
// form p <- p - s (q + tau p), which keeps c - 1 = -s tau where c rounds to
// 1, so Q stays orthogonal.  From sweep `sweeps` on, the solve stops after
// the first sweep that leaves every off-diagonal entry at or below the
// threshold (tested entry by entry; resid is the off-diagonal norm summed
// directly, not total - diagonal), or at `max_sweeps`.
//
// Design.  One thread-block cluster per matrix (up to 16 CTAs of 256
// threads, non-portable size, checked with cudaOccupancyMaxActiveClusters):
// the hardware cluster barrier separates step 1 from step 2 and step 2
// from the next round, two barriers per round.  A and V stay in global
// memory, resident in L2 (an f32 (2, 288, 288) problem is 1.3 MB of the
// 50 MB L2; cross-CTA data is read and written with .cg, at L2); the
// subproblems, the tiles and the Qs live in shared memory.  Each CTA has two
// 128-thread solver groups (named barriers 1 and 2), so a 16-CTA cluster
// solves up to 32 subproblems of a round at once; step 2 deals the tiles
// round-robin over the cluster's CTAs, fetching the next tile into
// registers while it multiplies the current one.  Tile products are
// 32 x 32 x 32 in full FP32 (or FP64) FMA on the CUDA cores: no TF32.
//
// What bounds it on an H100: not bytes (a few MB per solve, from L2) nor
// FP32 operations (tens of MFLOP per solve against 67 TFLOP/s), but the
// serial chain: sweeps x (2k - 1) rounds, each two cluster barriers, one
// subproblem solve (31 dependent scalar rounds of two named barriers each,
// the larger part of a round) and the tile products of the busiest CTA.
// The design cuts the chain from the scalar kernel's 287 rounds per sweep
// at n = 288 to 17, computes each rotation once per round, and spreads a
// round over up to 16 SMs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kB = 16;                   // block width
constexpr int kW = 2 * kB;               // subproblem and tile width
constexpr int kLd = kW + 1;              // tile row stride in shared memory
constexpr int kLd4 = kW + 4;             // row stride of a tile read 4-wide
constexpr int kTile = kW * kW;
constexpr int kThreads = 256;
constexpr int kGroup = 128;              // threads of one subproblem solver
constexpr int kGroups = kThreads / kGroup;
constexpr int kMaxBlocks = 512;          // block-index table: n <= 8192
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;          // device ordinals set up per process
constexpr int kSlots = 3;                // per CTA: off^2, violation, norm^2
constexpr int kSolverElems = 4 * kW * kLd + 5 * kB + kW;    // S, S', Q, Q', rotations
constexpr int kUpdateElems = 2 * kW * kLd4 + 2 * kW * kLd;   // L, Ut, R, X
constexpr int kWorkElems = kGroups * kSolverElems > kUpdateElems
                               ? kGroups * kSolverElems : kUpdateElems;

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

template <typename T>
struct Args {
  T* a;          // (batch, n, n) padded working copy, overwritten
  T* v;          // (batch, n, n) eigenvector columns
  T* w;          // (batch, n) diagonal
  T* resid;      // (batch,)
  int* nsweeps;  // (batch,)
  T* work;       // (batch, k * kTile + kMaxCluster * kSlots) scratch
  int n, sweeps, max_sweeps;
};

__device__ __forceinline__ void group_sync(int bar) {
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(kGroup) : "memory");
}

// OR of `pred` over one solver group; doubles as the group's barrier.
__device__ __forceinline__ bool group_or(bool pred, int bar) {
  int out;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t"
      "setp.ne.u32 p, %1, 0;\n\t"
      "bar.red.or.pred q, %2, %3, p;\n\t"
      "selp.u32 %0, 1, 0, q;\n\t}"
      : "=r"(out)
      : "r"((unsigned)pred), "r"(bar), "r"(kGroup)
      : "memory");
  return out != 0;
}

// Block-wide sum; every thread gets the result.  `red` holds 33 slots.
template <typename T>
__device__ T block_sum(T x, T* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // earlier readers of red[32] are done
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < (int)(blockDim.x >> 5) ? red[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  return red[32];
}

template <typename T>
__device__ __forceinline__ T threshold(T app, T aqq, T flr) {
  return Num<T>::eps() * Num<T>::sqrt_(Num<T>::abs_(app)) *
             Num<T>::sqrt_(Num<T>::abs_(aqq)) + flr;
}

template <typename T> struct Rot { T c, s, t; bool on; };

// Rutishauser rotation zeroing a_pq, or the identity (t = 0) below the
// threshold.
template <typename T>
__device__ __forceinline__ Rot<T> rotation(T app, T aqq, T apq, T flr) {
  Rot<T> r;
  r.on = Num<T>::abs_(apq) > threshold(app, aqq, flr);
  const T theta = (aqq - app) / (r.on ? T(2) * apq : T(1));
  const T t = (theta >= T(0) ? T(1) : T(-1)) /
              (Num<T>::abs_(theta) + Num<T>::sqrt_(T(1) + theta * theta));
  r.t = r.on ? t : T(0);
  r.c = T(1) / Num<T>::sqrt_(T(1) + r.t * r.t);
  r.s = r.t * r.c;
  return r;
}

// Where one round of the 32-wide scalar tournament moves position x (pair
// l rotates positions l and l + 16; top' = [t0, b0, t1..t14],
// bot' = [b1..b15, t15]); 31 rounds bring every position back.
__device__ __forceinline__ int dest(int x) {
  if (x < kB) return x == 0 ? 0 : (x == kB - 1 ? kW - 1 : x + 1);
  return x == kB ? 1 : x - 1;
}

__device__ __forceinline__ int block_row(int bi, int bj, int r) {
  return r < kB ? bi * kB + r : bj * kB + r - kB;
}

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}
__device__ __forceinline__ void load4(const double* p, double (&o)[4]) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  const double2 y = *reinterpret_cast<const double2*>(p + 2);
  o[0] = x.x; o[1] = x.y; o[2] = y.x; o[3] = y.y;
}
__device__ __forceinline__ void store4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(double* p, const double (&o)[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(o[0], o[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(o[2], o[3]);
}

// Step 1 for one pair of blocks (bi, bj), by one 128-thread group: load the
// subproblem, rotate it to (near) diagonal, write it back into A and its Q
// into `qout`.
template <typename T>
__device__ void solve_pair(T* __restrict__ a, T* __restrict__ qout, int n,
                           int bi, int bj, T* sm, int gt, int bar, T flr) {
  // S, S' at sm + {0, 1} * kBuf and Q, Q' at sm + {2, 3} * kBuf; then the
  // round's 16 rotations (c, s, t, tau, on) and sqrt|diagonal|
  constexpr int kBuf = kW * kLd;
  T* rot = sm + 4 * kBuf;
  T* sd = rot + 5 * kB;
  group_sync(bar);  // the group's previous subproblem is written out
  for (int e = gt; e < kTile; e += kGroup) {
    const int r = e / kW, c = e % kW;
    sm[r * kLd + c] =
        __ldcg(a + (size_t)block_row(bi, bj, r) * n + block_row(bi, bj, c));
    sm[2 * kBuf + r * kLd + c] = r == c ? T(1) : T(0);
  }
  group_sync(bar);
  int cur = 0;
  const int pi = gt >> 3, pj0 = (gt & 7) * 2;
  // one sweep, only if some entry is above the threshold
  if (gt < kW) sd[gt] = Num<T>::sqrt_(Num<T>::abs_(sm[gt * kLd + gt]));
  group_sync(bar);
  bool any = false;
  for (int e = gt; e < kTile; e += kGroup) {
    const int r = e / kW, c = e % kW;
    if (r != c)
      any |= Num<T>::abs_(sm[r * kLd + c]) > Num<T>::eps() * sd[r] * sd[c] + flr;
  }
  if (group_or(any, bar)) {
    for (int round = 0; round < kW - 1; ++round) {
      const T* s = sm + cur * kBuf;
      T* sn = sm + (cur ^ 1) * kBuf;
      const T* q = sm + (2 + cur) * kBuf;
      T* qn = sm + (2 + (cur ^ 1)) * kBuf;
      if (gt < kB) {  // pair gt rotates positions (gt, gt + 16)
        const Rot<T> r = rotation(s[gt * kLd + gt], s[(gt + kB) * kLd + gt + kB],
                                  s[gt * kLd + gt + kB], flr);
        rot[gt] = r.c;
        rot[kB + gt] = r.s;
        rot[2 * kB + gt] = r.t;
        rot[3 * kB + gt] = r.s / (T(1) + r.c);
        rot[4 * kB + gt] = r.on ? T(1) : T(0);
      }
      group_sync(bar);
      const T ci = rot[pi], si = rot[kB + pi];
      const int dp = dest(pi), dq = dest(pi + kB);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int pj = pj0 + u;
        const T cj = rot[pj], sj = rot[kB + pj], tau = rot[3 * kB + pj];
        // the 2 x 2 block (pi, pj): rows by pair pi, then columns by pair pj
        const T x00 = s[pi * kLd + pj], x01 = s[pi * kLd + pj + kB];
        const T x10 = s[(pi + kB) * kLd + pj], x11 = s[(pi + kB) * kLd + pj + kB];
        const T y00 = ci * x00 - si * x10, y01 = ci * x01 - si * x11;
        const T y10 = si * x00 + ci * x10, y11 = si * x01 + ci * x11;
        T z00 = y00 * cj - y01 * sj, z01 = y00 * sj + y01 * cj;
        T z10 = y10 * cj - y11 * sj, z11 = y10 * sj + y11 * cj;
        if (pi == pj) {  // the rotated pair: exact diagonal, zero a_pq
          const T t = rot[2 * kB + pi];
          z00 = x00 - t * x01;
          z11 = x11 + t * x01;
          if (rot[4 * kB + pi] != T(0)) z01 = z10 = T(0);
        }
        const int ep = dest(pj), eq = dest(pj + kB);
        sn[dp * kLd + ep] = z00;
        sn[dp * kLd + eq] = z01;
        sn[dq * kLd + ep] = z10;
        sn[dq * kLd + eq] = z11;
        // columns pj, pj + 16 of Q, rows pi and pi + 16
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = pi + h * kB;
          const T qp = q[r * kLd + pj], qq = q[r * kLd + pj + kB];
          qn[r * kLd + ep] = qp - sj * (qq + tau * qp);
          qn[r * kLd + eq] = qq + sj * (qp - tau * qq);
        }
      }
      group_sync(bar);
      cur ^= 1;
    }
  }
  const T* s = sm + cur * kBuf;
  const T* q = sm + (2 + cur) * kBuf;
  for (int e = gt; e < kTile; e += kGroup) {
    const int r = e / kW, c = e % kW;
    __stcg(a + (size_t)block_row(bi, bj, r) * n + block_row(bi, bj, c),
           r <= c ? s[r * kLd + c] : s[c * kLd + r]);
    __stcg(qout + e, q[r * kLd + c]);
  }
}

// One step-2 job: an upper tile of A (both Qs, then the mirror) or a
// 32-row tile of V (the right Q only).
struct Job {
  bool is_a;
  int p, pp;  // pair of the rows (A) or 32-row group (V); pair of the columns
};

__device__ __forceinline__ Job job_of(int j, int k) {
  const int na = k * (k - 1) / 2;
  Job job;
  job.is_a = j < na;
  if (job.is_a) {
    int p = 0;
    while (j >= k - 1 - p) { j -= k - 1 - p; ++p; }
    job.p = p;
    job.pp = p + 1 + j;
  } else {
    j -= na;
    job.p = j / k;
    job.pp = j % k;
  }
  return job;
}

template <typename T>
struct Operands { T x[4], l[4], r[4]; };

template <typename T>
__device__ __forceinline__ void fetch(Operands<T>& o, const Job& job,
                                      const T* a, const T* v, const T* qs,
                                      const int* top, const int* bot, int n) {
  const int c = threadIdx.x & 31, r0 = threadIdx.x >> 5;
  const int gc = block_row(top[job.pp], bot[job.pp], c);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = r0 + 8 * m, e = r * kW + c;
    if (job.is_a) {
      o.x[m] = __ldcg(a + (size_t)block_row(top[job.p], bot[job.p], r) * n + gc);
      o.l[m] = __ldcg(qs + (size_t)job.p * kTile + e);
    } else {
      o.x[m] = __ldcg(v + (size_t)(job.p * kW + r) * n + gc);
    }
    o.r[m] = __ldcg(qs + (size_t)job.pp * kTile + e);
  }
}

// Step 2 for this CTA's share of the round's jobs.
template <typename T>
__device__ void update_tiles(T* a, T* v, const T* qs, const int* top,
                             const int* bot, int n, int k, int rank, int cs,
                             T* sm) {
  T* ls = sm;                        // Q_P, row stride kLd4
  T* ut = ls + kW * kLd4;            // (Q_P^T X)^T or V tile^T, stride kLd4
  T* rs = ut + kW * kLd4;            // Q_P'
  T* xs = rs + kW * kLd;             // A tile, then the result
  const int tid = threadIdx.x, lane = tid & 31, w4 = (tid >> 5) * 4;
  const int njobs = k * (k - 1) / 2 + k * k;
  int j = rank;
  if (j >= njobs) return;
  Operands<T> o;
  Job job = job_of(j, k);
  fetch(o, job, a, v, qs, top, bot, n);
  for (; j < njobs; j += cs) {
    __syncthreads();  // the previous job is done with shared memory
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = (tid >> 5) + 8 * m;
      if (job.is_a) {
        ls[r * kLd4 + lane] = o.l[m];
        xs[r * kLd + lane] = o.x[m];
      } else {
        ut[lane * kLd4 + r] = o.x[m];
      }
      rs[r * kLd + lane] = o.r[m];
    }
    __syncthreads();
    const Job now = job;
    if (j + cs < njobs) {  // next job's loads fly during this job's math
      job = job_of(j + cs, k);
      fetch(o, job, a, v, qs, top, bot, n);
    }
    T acc[4];
    if (now.is_a) {  // ut <- (Q_P^T X)^T: rows w4..w4+3, column lane
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[m] = T(0);
#pragma unroll 8
      for (int r = 0; r < kW; ++r) {
        T l4[4];
        load4(ls + r * kLd4 + w4, l4);
        const T x = xs[r * kLd + lane];
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[m] += l4[m] * x;
      }
      store4(ut + lane * kLd4 + w4, acc);
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[m] = T(0);
#pragma unroll 8
    for (int c = 0; c < kW; ++c) {
      T u4[4];
      load4(ut + c * kLd4 + w4, u4);
      const T r = rs[c * kLd + lane];
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[m] += u4[m] * r;
    }
    const int gc = block_row(top[now.pp], bot[now.pp], lane);
    if (now.is_a) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = w4 + m;
        __stcg(a + (size_t)block_row(top[now.p], bot[now.p], i) * n + gc, acc[m]);
        xs[i * kLd + lane] = acc[m];
      }
      __syncthreads();
      // the mirror tile A[P', P] = Y^T, written row by row
      const int gr = block_row(top[now.p], bot[now.p], lane);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int c = w4 + m;
        __stcg(a + (size_t)block_row(top[now.pp], bot[now.pp], c) * n + gr,
               xs[lane * kLd + c]);
      }
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        __stcg(v + (size_t)(now.p * kW + w4 + m) * n + gc, acc[m]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) jacobi_kernel(Args<T> p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int mat = blockIdx.x / cs;
  const int n = p.n, k = n / kW, tid = threadIdx.x;
  const size_t nn = (size_t)n * n;
  T* a = p.a + mat * nn;
  T* v = p.v + mat * nn;
  T* qs = p.work + (size_t)mat * (k * kTile + kMaxCluster * kSlots);
  T* part = qs + (size_t)k * kTile;  // [kMaxCluster][kSlots]

  extern __shared__ __align__(16) unsigned char smem[];
  int* tab = reinterpret_cast<int*>(smem);  // [2][kMaxBlocks]: top | bot
  T* red = reinterpret_cast<T*>(smem + 2 * kMaxBlocks * sizeof(int));
  T* work = red + 64;

  const size_t stride = (size_t)cs * kThreads;
  T s2 = T(0);
  for (size_t e = (size_t)rank * kThreads + tid; e < nn; e += stride) {
    const T x = __ldcg(a + e);
    s2 += x * x;
    __stcg(v + e, (e / n == e % n) ? T(1) : T(0));
  }
  for (int i = tid; i < 2 * k; i += kThreads) tab[i] = i;
  s2 = block_sum(s2, red);
  if (tid == 0) __stcg(part + rank * kSlots + 2, s2);
  cluster.sync();
  T norm2 = T(0);
  for (int r = 0; r < cs; ++r) norm2 += __ldcg(part + r * kSlots + 2);
  const T flr = Num<T>::eps() * Num<T>::sqrt_(norm2) / T(n) + Num<T>::tiny();

  const int group = tid / kGroup, gt = tid % kGroup;
  int cur = 0, isweep = 0;
  T off = T(0);
  for (;;) {
    for (int round = 0; round < 2 * k - 1; ++round) {
      const int* top = tab + cur * kMaxBlocks;
      const int* bot = top + k;
      for (int pr = rank * kGroups + group; pr < k; pr += cs * kGroups)
        solve_pair(a, qs + (size_t)pr * kTile, n, top[pr], bot[pr],
                   work + group * kSolverElems, gt, 1 + group, flr);
      cluster.sync();
      update_tiles(a, v, qs, top, bot, n, k, rank, cs, work);
      if (k > 1) {  // round-robin re-pairing into the other table
        int* ntop = tab + (cur ^ 1) * kMaxBlocks;
        int* nbot = ntop + k;
        for (int i = tid; i < k; i += kThreads) {
          ntop[i] = i == 0 ? top[0] : (i == 1 ? bot[0] : top[i - 1]);
          nbot[i] = i == k - 1 ? top[k - 1] : bot[i + 1];
        }
        cur ^= 1;
      }
      cluster.sync();
    }
    ++isweep;
    if (isweep >= p.sweeps) {
      T offp = T(0);
      bool viol = false;
      for (size_t e = (size_t)rank * kThreads + tid; e < nn; e += stride) {
        const int r = (int)(e / n), c = (int)(e % n);
        if (r < c) {
          const T x = __ldcg(a + e);
          offp += T(2) * x * x;
          viol |= Num<T>::abs_(x) > threshold(__ldcg(a + (size_t)r * (n + 1)),
                                              __ldcg(a + (size_t)c * (n + 1)),
                                              flr);
        }
      }
      offp = block_sum(offp, red);
      viol = __syncthreads_or(viol);
      if (tid == 0) {
        __stcg(part + rank * kSlots, offp);
        __stcg(part + rank * kSlots + 1, viol ? T(1) : T(0));
      }
      cluster.sync();
      off = T(0);
      bool any = false;
      for (int r = 0; r < cs; ++r) {
        off += __ldcg(part + r * kSlots);
        any |= __ldcg(part + r * kSlots + 1) != T(0);
      }
      if (!any || isweep >= p.max_sweeps) break;
    }
  }

  T* w = p.w + (size_t)mat * n;
  for (int i = rank * kThreads + tid; i < n; i += cs * kThreads)
    w[i] = __ldcg(a + (size_t)i * (n + 1));
  if (rank == 0 && tid == 0) {
    p.resid[mat] = Num<T>::sqrt_(off / (norm2 + Num<T>::tiny()));
    p.nsweeps[mat] = isweep;
  }
}

template <typename T>
size_t smem_bytes() {
  return 2 * kMaxBlocks * sizeof(int) + (64 + kWorkElems) * sizeof(T);
}

// Cluster size for a batch of n x n solves: enough CTAs for every
// subproblem of a round (two per CTA) and about four step-2 jobs each, at
// most 16, then halved until cudaOccupancyMaxActiveClusters finds room.
// Returns the size, or minus a CUDA error code.
template <typename T>
int cluster_size(int batch, int n) {
  // cudaFuncSetAttribute acts on the current device only: set up once per
  // device ordinal
  static bool ready[kMaxDevices] = {};
  const size_t smem = smem_bytes<T>();
  int dev = 0;
  cudaError_t st = cudaGetDevice(&dev);
  if (st != cudaSuccess) return -(int)st;
  if (dev < 0 || dev >= kMaxDevices) return -(int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    st = cudaFuncSetAttribute(
        jacobi_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (st == cudaSuccess)
      st = cudaFuncSetAttribute(jacobi_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
    if (st != cudaSuccess) return -(int)st;
    ready[dev] = true;
  }
  const int k = n / kW, jobs = k * (k - 1) / 2 + k * k;
  int cs = (k + kGroups - 1) / kGroups;
  if ((jobs + 3) / 4 > cs) cs = (jobs + 3) / 4;
  if (cs > kMaxCluster) cs = kMaxCluster;
  for (;; cs = cs > 8 ? 8 : cs / 2) {
    if (cs <= 1) return 1;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cs;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(batch * cs);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&clusters, jacobi_kernel<T>, &cfg);
    if (err == cudaSuccess && clusters > 0) return cs;
    cudaGetLastError();  // a refused size is not this launch's error
  }
}

template <typename T>
int launch(void* a, void* v, void* w, void* resid, void* nsweeps, void* work,
           int batch, int n, int sweeps, int max_sweeps, void* stream) {
  if (n % kW != 0 || n / kB > kMaxBlocks || batch < 1) return (int)cudaErrorInvalidValue;
  const int cs = cluster_size<T>(batch, n);
  if (cs < 0) return -cs;
  Args<T> args{(T*)a, (T*)v, (T*)w, (T*)resid, (int*)nsweeps, (T*)work,
               n, sweeps, max_sweeps};
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(batch * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<T>();
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, jacobi_kernel<T>, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  `a` is the padded (batch, n, n)
// working copy and is overwritten; `v` (batch, n, n), `w` (batch, n),
// `resid` (batch,) and `nsweeps` (batch,) int32 are outputs; `work` is
// (batch, n / 32 * 1024 + 48) scratch of the same type.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int reno_jacobi_eigh_f32(void* a, void* v, void* w, void* resid,
                                    void* nsweeps, void* work, int batch, int n,
                                    int sweeps, int max_sweeps, void* stream) {
  return launch<float>(a, v, w, resid, nsweeps, work, batch, n, sweeps,
                       max_sweeps, stream);
}

extern "C" int reno_jacobi_eigh_f64(void* a, void* v, void* w, void* resid,
                                    void* nsweeps, void* work, int batch, int n,
                                    int sweeps, int max_sweeps, void* stream) {
  return launch<double>(a, v, w, resid, nsweeps, work, batch, n, sweeps,
                        max_sweeps, stream);
}
