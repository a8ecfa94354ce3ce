// Density-fitted exchange contracted with general densities, for Hopper
// (sm_90a), FP64.
//
// No TPU kernel of cctpu computes this: it replaces the XLA einsum of
// cctpu/ints/df.py::DFJK._k_of (cocc=None), the exchange of a density that
// has no occupied factor (the TDDFT transition densities, the CPHF
// response densities; any D, not assumed symmetric). For B [naux, nao, nao]
// and D [nset, nao, nao] it computes
//     K[s] = sum_p B[p] D[s] B[p]^T      (einsum "pik,skl,pjl->sij")
// with no symmetry of B[p] or D[s] assumed.
//
// Bound: B is read once (naux*nao^2*8 bytes, 171 MB at phenol 6-31G*)
// against 4*nao flops per element of B and density: compute-bound from one
// density on (phenol: 0.051 ms of bytes, 0.141 ms of FP64 at 67 TFLOP/s
// per density). So the design keeps the FP64 tensor cores (Hopper's
// wgmma has no FP64 form; mma.sync.m16n8k16 issues at the m16n8k4 rate,
// ops/bench_mma.py) fed and moves nothing per aux row that the products
// do not need:
//
//   * Output-stationary K. Block (group, s, panel) owns the column panel
//     K[s][:, J] (J: nj 8-column tiles) for one of `groups` contiguous aux
//     ranges and keeps it in registers over the whole range; it is written
//     once, at the end, into the group's partial. Per aux row p:
//       A. V = D[s] B[p][J, :]^T  ([Mp, |J|]: V[k][j] = sum_l D[k][l]
//          B[p][j][l]), in nh chunks of rows, each held in registers over
//          the l range and then stored to shared memory as V^T;
//       B. K[s][:, J] += B[p] V   (sum over k).
//     Every element of K[s] comes from one block per group and is summed
//     over p in row order, then over k in tile order; the groups' partials
//     are added in group order (dfc::partial_sum). No float atomics: repeat
//     calls are bitwise equal, and a density's K does not depend on the
//     other densities of the call (the plan does not take nset).
//   * Tiles sized to nao (ops/plan.py::k_dm_plan). Both products run over
//     16-row tiles of all Mp = 16 ceil(nao/16) rows, the panel's 8-column
//     tiles and 16-deep steps, so the only padding is to 16 rows, 8
//     columns and a depth of 16 (5 % at nao 110, 10 % at 198, against
//     28 % and 43 % for fixed 64 x 128 panels). The 8 warps form a 2 x 4
//     grid: warp w works on column group w % 4, so each tensor-core
//     sub-partition holds one group of columns, and its two warps split
//     the row tiles; a warp holds up to MTK (MTW) x NT accumulator tiles.
//     Its K tile is 64 x 16 (variant a), 112 x 16 (b) or 192 x 8 (c),
//     narrower than 64 x 32: a B fragment feeds MTK products, an A
//     fragment only NT (2, or 1 in c). The registers set this: a warp
//     keeps its K tile over the whole aux range and a V chunk's tile
//     beside it, and a 64 x 32 tile of each would take 128 registers a
//     thread apiece, more than the 255 with the fragments and indices
//     (variant b already spills). The loads cost about a tenth at phenol
//     (a build without them, PERF.md section 6).
//     One m16n8k16 takes a whole staged tile's depth; its contraction
//     index runs over the tile's 16 columns in the order in which each
//     lane's four are contiguous, so a fragment is 16-byte loads.
//   * Asynchronous staging. B[p]'s tiles (and, where D[s] is not resident,
//     D[s]'s) arrive through a ring of `stages` jobs of jt tiles of 16
//     columns (jt 2 where two fit, else 1), one barrier per job; the
//     copies of the jobs ahead run under the products. A job is either an
//     A job (D[s]'s chunk rows and the panel's rows of B[p], columns
//     l0..l0+16 jt-1) or a B job (all rows of B[p], columns k0..). A
//     barrier costs the warps some hundred cycles (the products of a tile
//     take about 900 on the busiest sub-partition at phenol), so two tiles
//     a job save half of it where the ring still fits. TMA = true (nao
//     even, 16 <= nao <= 256, B and D 16-byte aligned): one thread asks
//     the copy engine for each tile as one tensor-copy box with the
//     128-byte swizzle (zeros past the tensor's edge), reported to the
//     stage's mbarrier. TMA = false: cp.async of 8 bytes into padded rows
//     (cp_stride).
//   * D[s] stays in shared memory for the block's whole range where it fits
//     beside the rest (DRES: variant "a", nao <= 128), loaded once by
//     cp.async; otherwise its tiles stream from L2 with B's.
//   * B from device memory about once: blocks are numbered panel fastest,
//     then density, then group, so the blocks of one aux group (all
//     densities and panels) run together and read B's rows from L2 after
//     the first.
//
// What still holds it back (ops/bench_k_dm.py, and builds without the
// products or without the fragment loads, PERF.md section 6): the fixed
// cost of each job around its products (the wait, the barrier, the
// copies' issue), some hundred cycles, which two tiles a job halve where
// they fit; the busiest sub-partition carries 1 / 0.875 (phenol) and 1 / 0.893
// (aspirin) of the mean; V in two chunks spills some registers at nao >
// 128. Without the products the copies and loads take about half of the
// time; D[s] streamed per row and B[p] read once per panel are most of
// the copies.
//
// C interface (bound with ctypes): pointers and the stream are void*; the
// plan's integers come from ops/plan.py::k_dm_plan (KDM_PLAN_INTS), and a
// plan that is inconsistent, or whose shared memory (recomputed here) is
// not the plan's or exceeds the card's cap, returns cudaErrorInvalidValue.
// Kw is the groups' partials [groups, nset, nao, nao]. The return value is
// cudaGetLastError() after the launches (or the first failing call's code).

#include <stdint.h>

#include "df_async.cuh"
#include "df_common.cuh"

namespace {

using dfc::cp_async8;
using dfc::cp_async_commit;
using dfc::cp_async_wait;
using dfc::fence_proxy_async;
using dfc::mbar_expect_tx;
using dfc::mbar_init;
using dfc::mbar_wait;
using dfc::mma16816;
using dfc::swizzled;
using dfc::tma_load_3d;

constexpr int kT = 256;              // threads: 8 warps, a 2 x 4 grid
constexpr int kKt = 16;              // columns of a tile: one mma deep
constexpr int kHeaderBytes = 1024;   // the mbarriers; aligns the tiles

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Row stride of a cp.async job's tiles: jt tiles of kKt columns, plus 2
// (2 mod 4 doubles: a quarter-warp's 16-byte loads from two rows fall into
// different banks).
__host__ __device__ inline int cp_stride(int jt) { return jt * kKt + 2; }

// Doubles of one stage of the ring: an A job's tiles (D[s]'s chunk rows
// unless D is resident, then the panel's rows of B[p]) or a B job's (all
// Mp rows of B[p]), jt tiles wide, rows of cp_stride(jt) doubles (tensor
// copies use jt * kKt of them); a multiple of 1024 bytes, so that every
// tile starts where the 128-byte swizzle expects.
__host__ __device__ inline int stage_doubles(int nao, int nj, int nh,
                                             bool dres, int jt) {
  const int mt = cdiv(nao, 16), lh = 16 * cdiv(mt, nh);
  const int a = 8 * nj + (dres ? 0 : lh), b = 16 * mt;
  return cdiv(cp_stride(jt) * (a > b ? a : b), 128) * 128;
}

// Dynamic shared memory of kdm_mma, in bytes (ops/plan.py::k_dm_smem_bytes
// has the same sum): header, ring, V^T [8 nj][Mp + 2], resident D
// [Mp][Mp + 2].
size_t kdm_smem_bytes(int nao, int nj, int nh, int stages, bool dres,
                      int jt) {
  const size_t mp = 16 * static_cast<size_t>(cdiv(nao, 16));
  return kHeaderBytes +
         8 * (static_cast<size_t>(stages) *
                  stage_doubles(nao, nj, nh, dres, jt) +
              8 * nj * (mp + 2) + (dres ? mp * (mp + 2) : 0));
}

// Copy rows [row0, row0 + R) x columns [k0, k0 + 16 ntile) (ntile 1 or
// 2) of the row-major nao x nao matrix src into rows of ldc doubles (zeros
// past the matrix) by cp.async of 8 bytes.
__device__ __forceinline__ void copy_tile(double* dst,
                                          const double* __restrict__ src,
                                          int row0, int R, int k0, int ntile,
                                          int ldc, int nao) {
  const int lg = ntile == 2 ? 5 : 4;  // log2 of the columns
  for (int e = threadIdx.x; e < (R << lg); e += kT) {
    const int r = e >> lg, c = e & ((1 << lg) - 1);
    const bool ok = row0 + r < nao && k0 + c < nao;
    cp_async8(dst + r * ldc + c,
              ok ? src + static_cast<size_t>(row0 + r) * nao + k0 + c : src,
              ok ? 8 : 0);
  }
}

// Elements (r, c) and (r, c + 1), c even, of a job's staged tiles of R
// rows: a tensor copy's (one box of rows of kKt, 128-byte swizzle, per
// tile) or a cp.async one (rows of ldc).
template <bool TMA>
__device__ __forceinline__ double2 tile2(const double* tile, int R, int ldc,
                                         int r, int c) {
  return *reinterpret_cast<const double2*>(
      tile + (TMA ? (c >> 4) * R * kKt + swizzled(r, c & (kKt - 1), kKt)
                  : r * ldc + c));
}

// The same of a row-major array with row stride ld (even).
__device__ __forceinline__ double2 arr2(const double* a, int ld, int r,
                                        int c) {
  return *reinterpret_cast<const double2*>(a + r * ld + c);
}

// The mma's contraction index runs over the 16 columns of a tile in the
// order in which lane t's four are contiguous (logical t + 4q is column
// 4t + q of the tile, for A and B alike): an A fragment is two 16-byte
// loads from each of its rows r and r + 8, a B fragment two from its row.
// Within a quarter-warp (rows g, g + 1) the loads fall into different
// banks: a tensor copy's swizzle moves odd rows' chunks by one, and the
// padded strides (2 mod 4 doubles) by half a chunk pair.
__device__ __forceinline__ void frag_a(double (&a)[8], double2 x0, double2 x1,
                                       double2 y0, double2 y1) {
  a[0] = x0.x; a[2] = x0.y; a[4] = x1.x; a[6] = x1.y;  // row r
  a[1] = y0.x; a[3] = y0.y; a[5] = y1.x; a[7] = y1.y;  // row r + 8
}

__device__ __forceinline__ void frag_b(double (&b)[4], double2 x0,
                                       double2 x1) {
  b[0] = x0.x; b[1] = x0.y; b[2] = x1.x; b[3] = x1.y;
}

// acc[m][n] += A_m B_n for the warp's first mcnt row tiles and ncnt column
// tiles, one m16n8k16 each: B's fragments given, A's loaded by
// load_a(a, m).
template <int MT, int NT, class LoadA>
__device__ __forceinline__ void tile_products(double (&acc)[MT][NT][4],
                                              const double (&bf)[NT][4],
                                              int mcnt, int ncnt,
                                              LoadA load_a) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < mcnt) {
      double a[8];
      load_a(a, m);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < ncnt) mma16816(acc[m][n], a, bf[n]);
      }
    }
  }
}

// One block: panel J of K[s] over one aux group (see the note above).
// MTK / MTW: the most 16-row tiles of K / of a V chunk a warp holds; NT:
// the most 8-column tiles.
template <bool TMA, bool DRES, int MTK, int MTW, int NT>
__global__ void __launch_bounds__(kT, 1)
kdm_mma(const double* __restrict__ B, const double* __restrict__ D,
        int naux, int nao, int nset, int nj, int nh, int jt, int stages,
        int rows_per_group, double* __restrict__ Kw,
        const __grid_constant__ CUtensorMap map_bj,
        const __grid_constant__ CUtensorMap map_ball,
        const __grid_constant__ CUtensorMap map_d) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int ldc = cp_stride(jt);               // a cp.async job's row stride
  const int ldt = TMA ? jt * kKt : ldc;        // doubles a staged row takes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wmi = warp >> 2, wni = warp & 3;
  const size_t n2 = static_cast<size_t>(nao) * nao;
  const int mt = cdiv(nao, 16), Mp = 16 * mt;
  const int n8 = cdiv(nao, 8);
  const int npanel = cdiv(n8, nj);
  const int Rj = 8 * nj;
  const int nkt = cdiv(nao, kKt);
  const int njt = cdiv(nkt, jt);  // jobs per pass over the columns
  const int mc = cdiv(mt, nh), Lh = 16 * mc;  // m-tiles, rows of a V chunk
  const int ld = Mp + 2;                      // V^T's and D's row stride

  const int panel = blockIdx.x % npanel;
  const int s = (blockIdx.x / npanel) % nset;
  const int grp = blockIdx.x / (npanel * nset);
  const int j0 = panel * Rj;
  const int nj_here = min(nj, n8 - panel * nj);  // n-tiles of this panel
  // this warp's n-tiles (group wni of the panel's) and K's m-tiles
  const int NTr = cdiv(nj_here, 4);
  const int n_lo = wni * NTr;
  const int ncnt = max(0, min(NTr, nj_here - n_lo));
  const int MTKr = cdiv(mt, 2);
  const int mk_lo = wmi * MTKr;
  const int mkcnt = max(0, min(MTKr, mt - mk_lo));

  // the stages' mbarriers, which count a job's tensor-copy bytes
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem_raw);
  const int stage_len = stage_doubles(nao, nj, nh, DRES, jt);
  double* ring = reinterpret_cast<double*>(smem_raw + kHeaderBytes);
  double* Vt = ring + static_cast<size_t>(stages) * stage_len;  // [Rj][ld]
  double* Dr = Vt + static_cast<size_t>(Rj) * ld;  // DRES: [Mp][ld]
  const double* Ds = D + static_cast<size_t>(s) * n2;

  const int p0 = grp * rows_per_group;
  const int nrows = min(naux, p0 + rows_per_group) - p0;
  const int njobs = nrows * (nh + 1) * njt;

  // The copies of the next job, in job order, into its stage of the ring:
  // per aux row, the A jobs of chunks 0..nh-1 (l tiles 0..nkt-1 each, jt
  // a job), then the B jobs (k tiles 0..nkt-1). With TMA one thread, the
  // first of the last warp (which has the fewest tiles), keeps the cursor
  // and asks for the boxes. With cp.async every thread copies its share
  // and a group is committed either way, so that the group count stays in
  // step with the job count.
  int l_job = 0, l_r = 0, l_h = 0, l_t = 0, l_st = 0;
  auto load_next = [&]() {
    if (l_job < njobs) {
      const int k0 = l_t * jt * kKt;
      const int ntile = min(jt, nkt - l_t * jt);
      const int p = p0 + l_r;
      double* st = ring + static_cast<size_t>(l_st) * stage_len;
      double* bj = st + (DRES ? 0 : Lh * ldt);  // the A job's rows of B[p]
      if constexpr (TMA) {
        unsigned long long* bar = full + l_st;
        const int rows = l_h < nh ? Rj + (DRES ? 0 : Lh) : Mp;
        mbar_expect_tx(bar, 8u * kKt * rows * ntile);
        for (int b = 0; b < ntile; ++b) {
          const int kb = k0 + b * kKt;
          if (l_h < nh) {
            if (!DRES) tma_load_3d(st + b * Lh * kKt, &map_d, kb, l_h * Lh, s,
                                   bar);
            tma_load_3d(bj + b * Rj * kKt, &map_bj, kb, j0, p, bar);
          } else {
            tma_load_3d(st + b * Mp * kKt, &map_ball, kb, 0, p, bar);
          }
        }
      } else {
        const double* Bp = B + static_cast<size_t>(p) * n2;
        if (l_h < nh) {
          if (!DRES) copy_tile(st, Ds, l_h * Lh, Lh, k0, ntile, ldc, nao);
          copy_tile(bj, Bp, j0, Rj, k0, ntile, ldc, nao);
        } else {
          copy_tile(st, Bp, 0, Mp, k0, ntile, ldc, nao);
        }
      }
      ++l_job;
      if (++l_st == stages) l_st = 0;
      if (++l_t == njt) {
        l_t = 0;
        if (++l_h > nh) {
          l_h = 0;
          ++l_r;
        }
      }
    }
    if constexpr (!TMA) cp_async_commit();
  };
  const bool producer = !TMA || tid == kT - 32;

  if constexpr (TMA) {
    if (tid == 0) {
      for (int i = 0; i < stages; ++i) mbar_init(full + i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    fence_proxy_async();
    __syncthreads();
  }
  if constexpr (DRES) {
    // D[s] for the whole range, rows of ld, zeros past nao (the first
    // committed group: complete before job 0)
    for (int e = tid; e < Mp * Mp; e += kT) {
      const int k = e / Mp, l = e - k * Mp;
      const bool ok = k < nao && l < nao;
      cp_async8(Dr + k * ld + l,
                ok ? Ds + static_cast<size_t>(k) * nao + l : Ds, ok ? 8 : 0);
    }
    cp_async_commit();
  }
  if (producer)
    for (int i = 0; i < stages - 1; ++i) load_next();
  if constexpr (TMA && DRES) cp_async_wait(0);  // job 0's barrier publishes

  // Wait for the next job's tiles; once every thread is past the barrier,
  // the previous job's stage is free for the copies of the job stages - 1
  // ahead. Returns the job's stage.
  int c_st = 0;
  unsigned c_par = 0;
  auto next_job = [&]() {
    if constexpr (TMA) {
      mbar_wait(full + c_st, c_par);
      fence_proxy_async();  // this thread is done with the stage that the
                            // next tensor copies overwrite
    } else {
      cp_async_wait(stages - 2);
    }
    __syncthreads();
    if (producer) load_next();
    const double* st = ring + static_cast<size_t>(c_st) * stage_len;
    if (++c_st == stages) {
      c_st = 0;
      c_par ^= 1;
    }
    return st;
  };

  double kacc[MTK][NT][4] = {};
  for (int r = 0; r < nrows; ++r) {
    // A. V = D[s] B[p][J, :]^T, chunk by chunk of rows
    for (int h = 0; h < nh; ++h) {
      const int mch = min(mc, mt - h * mc);
      const int MTWr = cdiv(mch, 2);
      const int mw_lo = wmi * MTWr;
      const int mwcnt = max(0, min(MTWr, mch - mw_lo));
      double vacc[MTW][NT][4] = {};
      for (int lt = 0; lt < njt; ++lt) {
        const double* st = next_job();
        const double* bj = st + (DRES ? 0 : Lh * ldt);
        for (int kt = 0; kt < min(jt, nkt - lt * jt); ++kt) {
          const int c = kt * kKt + 4 * t;  // this lane's columns of the job
          // B fragments: B[p][j][l], j the panel's row
          double bf[NT][4];
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if (n < ncnt) {
              const int row = (n_lo + n) * 8 + g;
              frag_b(bf[n], tile2<TMA>(bj, Rj, ldc, row, c),
                     tile2<TMA>(bj, Rj, ldc, row, c + 2));
            }
          }
          // A fragments: D[s][k][l], k the chunk's row
          tile_products(vacc, bf, mwcnt, ncnt, [&](double (&a)[8], int m) {
            const int row = (mw_lo + m) * 16 + g;
            if constexpr (DRES) {
              const int kr = h * Lh + row, l = lt * jt * kKt + c;
              frag_a(a, arr2(Dr, ld, kr, l), arr2(Dr, ld, kr, l + 2),
                     arr2(Dr, ld, kr + 8, l), arr2(Dr, ld, kr + 8, l + 2));
            } else {
              frag_a(a, tile2<TMA>(st, Lh, ldc, row, c),
                     tile2<TMA>(st, Lh, ldc, row, c + 2),
                     tile2<TMA>(st, Lh, ldc, row + 8, c),
                     tile2<TMA>(st, Lh, ldc, row + 8, c + 2));
            }
          });
        }
      }
      // the chunk's rows of V, as columns of V^T (read after the next
      // job's barrier; the readers of the previous row's V passed this
      // row's first barrier)
#pragma unroll
      for (int m = 0; m < MTW; ++m) {
        if (m < mwcnt) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if (n < ncnt) {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int k = h * Lh + (mw_lo + m) * 16 + g + 8 * (q >> 1);
                const int j = (n_lo + n) * 8 + 2 * t + (q & 1);
                Vt[j * ld + k] = vacc[m][n][q];
              }
            }
          }
        }
      }
    }
    // B. K[s][:, J] += B[p] V
    for (int lt = 0; lt < njt; ++lt) {
      const double* st = next_job();
      for (int kt = 0; kt < min(jt, nkt - lt * jt); ++kt) {
        const int k0 = (lt * jt + kt) * kKt, c = kt * kKt + 4 * t;
        double bf[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n < ncnt) {
            const int row = (n_lo + n) * 8 + g;
            frag_b(bf[n], arr2(Vt, ld, row, k0 + 4 * t),
                   arr2(Vt, ld, row, k0 + 4 * t + 2));
          }
        }
        tile_products(kacc, bf, mkcnt, ncnt, [&](double (&a)[8], int m) {
          const int row = (mk_lo + m) * 16 + g;
          frag_a(a, tile2<TMA>(st, Mp, ldc, row, c),
                 tile2<TMA>(st, Mp, ldc, row, c + 2),
                 tile2<TMA>(st, Mp, ldc, row + 8, c),
                 tile2<TMA>(st, Mp, ldc, row + 8, c + 2));
        });
      }
    }
  }

  // the block's panel, once, into its group's partial of K[s]
  double* Kb = Kw + (static_cast<size_t>(grp) * nset + s) * n2;
#pragma unroll
  for (int m = 0; m < MTK; ++m) {
    if (m < mkcnt) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < ncnt) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = (mk_lo + m) * 16 + g + 8 * (q >> 1);
            const int j = j0 + (n_lo + n) * 8 + 2 * t + (q & 1);
            if (i < nao && j < nao)
              Kb[static_cast<size_t>(i) * nao + j] = kacc[m][n][q];
          }
        }
      }
    }
  }
}

// The instantiations of ops/plan.py::KDM_VARIANTS, by id.
struct Variant {
  int mt_max, mtk, mtw, nt;
  bool dres;
};
constexpr Variant kVariants[3] = {
    {8, 4, 4, 2, true}, {14, 7, 4, 2, false}, {24, 12, 4, 1, false}};

template <bool TMA, bool DRES, int MTK, int MTW, int NT>
cudaError_t launch(const double* B, const double* D, int naux, int nao,
                   int nset, int nj, int nh, int jt, int stages, int groups,
                   int rows, size_t smem, double* Kw, cudaStream_t st) {
  const int mt = cdiv(nao, 16);
  CUtensorMap map_bj = {}, map_ball = {}, map_d = {};
  if (TMA) {
    cudaError_t err = dfc::make_tensor_map(&map_bj, B, 3, nao, nao, naux,
                                           kKt, 8 * nj);
    if (err == cudaSuccess)
      err = dfc::make_tensor_map(&map_ball, B, 3, nao, nao, naux, kKt,
                                 16 * mt);
    if (err == cudaSuccess && !DRES)
      err = dfc::make_tensor_map(&map_d, D, 3, nao, nao, nset, kKt,
                                 16 * cdiv(mt, nh));
    if (err != cudaSuccess) return err;
  }
  auto kernel = kdm_mma<TMA, DRES, MTK, MTW, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long nblk =
      static_cast<long long>(groups) * nset * cdiv(cdiv(nao, 8), nj);
  kernel<<<static_cast<unsigned>(nblk), kT, smem, st>>>(
      B, D, naux, nao, nset, nj, nh, jt, stages, rows, Kw, map_bj, map_ball,
      map_d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int df_k_dm_f64(const void* B, const void* D, int naux, int nao, int nset,
                int variant, int nj, int nh, int jt, int stages, int groups,
                int rows, int tma, int smem_bytes, void* Kw, void* K,
                void* stream) {
  if (naux < 1 || nao < 1 || nset < 1 || variant < 0 || variant > 2 ||
      nj < 1 || nh < 1 || jt < 1 || jt > 2 || stages < 2 || stages > 4 ||
      groups < 1 ||
      rows < 1 || static_cast<long long>(groups) * rows < naux ||
      static_cast<long long>(groups - 1) * rows >= naux)
    return static_cast<int>(cudaErrorInvalidValue);
  const Variant& v = kVariants[variant];
  const int mt = cdiv(nao, 16), mc = cdiv(mt, nh);
  // the variant holds the plan's tiles, every chunk has rows, tensor copies
  // only where B's rows are 16-byte multiples and the boxes fit
  if (mt > v.mt_max || cdiv(mt, 2) > v.mtk || cdiv(mc, 2) > v.mtw ||
      cdiv(nj, 4) > v.nt || nj > cdiv(nao, 8) || (nh - 1) * mc >= mt ||
      (tma && (nao % 2 != 0 || nao < kKt || nao > 256)))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t cap = 0;
  cudaError_t err = dfc::smem_optin(&cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = kdm_smem_bytes(nao, nj, nh, stages, v.dres, jt);
  if (smem != static_cast<size_t>(smem_bytes) || smem > cap)
    return static_cast<int>(cudaErrorInvalidValue);
  const double* b = static_cast<const double*>(B);
  const double* d = static_cast<const double*>(D);
  double* kw = static_cast<double*>(Kw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool use_tma = tma && reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(D) % 16 == 0;
#define KDM_LAUNCH(DRES, MTK, MTW, NT)                                     \
  (use_tma ? launch<true, DRES, MTK, MTW, NT>(b, d, naux, nao, nset, nj,   \
                                              nh, jt, stages, groups, rows, \
                                              smem, kw, st)                \
           : launch<false, DRES, MTK, MTW, NT>(b, d, naux, nao, nset, nj,  \
                                               nh, jt, stages, groups,     \
                                               rows, smem, kw, st))
  if (variant == 0)
    err = KDM_LAUNCH(true, 4, 4, 2);
  else if (variant == 1)
    err = KDM_LAUNCH(false, 7, 4, 2);
  else
    err = KDM_LAUNCH(false, 12, 4, 1);
#undef KDM_LAUNCH
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(nset) * nao * nao;
  err = dfc::launch_partial_sum<double>(kw, groups, total, nao, 0,
                                        static_cast<double*>(K), st);
  return static_cast<int>(err);
}

}  // extern "C"
