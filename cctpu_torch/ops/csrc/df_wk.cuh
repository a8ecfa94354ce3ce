// Device code shared by the DF exchange kernels (sm_90a): the streaming
// W_p = (B[p] C)^T / K = sum_p W_p^T W_p pass, optionally fused with the
// Coulomb pass jp[p] = sum_ij B[p,i,j] D[i,j], J = sum_p jp[p] B[p]
// (WITH_J). df_jk_fused.cu instantiates it with J (the closed-shell fused
// J+K), df_k.cu without (exchange only, one call per spin).
//
// Two kernels, chosen by the plan that ops/plan.py::wk_plan makes and the
// C entries check (launch_wk below):
//
// wk_mma (FP64): both products run on the FP64 tensor cores
// (mma.sync.m16n8k4.f64: Hopper's wgmma has no FP64 form, and m8n8k4
// issues at half the rate, ops/bench_mma.py).
//   * Each block owns a contiguous aux range. B[p] arrives in column tiles
//     [rows, kt] into a ring of `stages` tiles, each with the matching
//     [kt, nocc] tile of C; the copies of the tiles ahead run under the
//     products of the current one; one barrier per tile.
//   * TMA = true (nao even, B 16-byte aligned, kt 8 or 16): one thread asks
//     the copy engine for a tile as one or two boxes of a tensor copy
//     (cp.async.bulk.tensor, zeros past the tensor's edge) and for the C
//     tile, which pack_c laid out tile by tile beforehand, as one bulk
//     copy; an mbarrier per stage counts their bytes. The engine writes a
//     tile's rows of 64 or 128 bytes with its swizzle, and the fragments'
//     rows are taken in an order (tile_row) in which a half-warp's four
//     rows fall into different banks under it.
//   * TMA = false (odd nao, or B not aligned): cp.async, 16 or 8 bytes a
//     thread, into tiles stored as [kt/4][rows][4], which the fragments
//     (lane -> row lane/4, k lane%4, for A and for B alike) read as 32
//     consecutive doubles per warp. Each thread keeps its place in a tile
//     and the block a cursor over the jobs, so that issuing costs no
//     division. A cp.async's issue waits until the memory system takes it
//     and queues with the products' shared-memory loads: with it for B, a
//     quarter to a half of a block's clocks went into issuing copies
//     (bench_wk.py --profile), and copies and products did not overlap.
//   * The warps form a wm x wn grid over the 16x8 tiles of
//     W_p^T [nao, nocc]. A warp keeps its (up to MTM x NTM) accumulators
//     in registers over the whole k range and writes them to shared
//     memory once per aux row (rows of stride nocc8 + 4, 4 mod 8: read
//     without bank conflicts). Where one pass cannot hold all of W_p^T it
//     is computed in row panels (B's rows of a panel are read once).
//   * W_p^T is alive only between a row's last tile and the next row's
//     first. Where the ring beside it would be too short to cover
//     device-memory latency (C16H34: W_p^T takes 180 KB of the 227), the
//     ring shares its shared memory (alias) and starts empty at every aux
//     row; else the ring runs on across the rows.
//   * K += W_p^T-rows x W_p^T-rows on 16x16 super-tiles (two 16x8 mma
//     tiles: 4 fragment loads for 2 mma) of the upper triangle, dealt to
//     the warps round-robin by a walk over the triangle (no table, no
//     sqrt). With KREG > 0 a warp keeps its super-tiles in registers for
//     the block's whole aux range (nao <= 112); else the block's partial K
//     lives in device memory in tile order (512-byte tiles, coalesced),
//     read and written once per aux row, the read issued before the
//     products.
//   * With J, the ring also stages the same tile of D beside each tile of
//     B (from L2, by the same copies), and jp[p] is accumulated from the
//     two tiles in shared memory after they land. With the partial J in
//     shared memory the block then adds jp[p] B[p] there (the row again,
//     from L2). Where it does not fit the kernel stores jp[p], and j_pass
//     computes J = sum_p jp[p] B[p] in a second pass over B with no
//     partials at all: a per-block partial J in device memory would be
//     read and written once per aux row.
//   * wk_sum adds the per-block partials in block order and mirrors K's
//     lower triangle. No float atomics: repeat calls are bitwise equal.
//
// wk_partial (FP64 and FP32): FMA loops on 4x4 register micro-tiles. It
// runs every FP32 call (there is no true-FP32 tensor-core path) and the
// FP64 shapes whose W_p does not fit in shared memory (W_p in a per-block
// slab in device memory).

#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include <type_traits>

#include "df_common.cuh"

namespace dfk {

using dfc::kThreads;
constexpr int kMaxWarps = kThreads / 32;  // wk_mma runs 8 or 16 warps
constexpr int kR = 4;  // register micro-tile edge of wk_partial
constexpr int kU = 4;  // elements per thread and step of the J sweep
// wk_mma's shared memory starts with kHeader doubles (the warps' jp shares
// and the stages' mbarriers): 1024 bytes, the alignment that the swizzled
// tiles of the tensor copies after it need
constexpr int kHeader = 128;

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// First index of row I in the row-major upper triangle (J >= I) of an
// nt x nt tile grid.
__host__ __device__ inline int tri_row_start(int I, int nt) {
  return I * nt - I * (I - 1) / 2;
}

// ---------------------------------------------------------------------
// wk_mma
// ---------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(double* smem, const double* g,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(g), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async8(double* smem, const double* g,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(g), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n of the committed groups are pending (n < 3).
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0) {
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else if (n == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::);
  } else {
    asm volatile("cp.async.wait_group 2;\n" ::);
  }
}

// mbarrier and tensor-copy (TMA) primitives. A tensor copy brings a box of
// a tensor in device memory into shared memory; one thread issues it, the
// copy engine runs it (zeros where the box leaves the tensor) and reports
// its bytes to an mbarrier. Unlike cp.async, its issue does not wait for
// the memory system, and it does not queue with the products' loads.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE_%=;\n"
      "bra WAIT_%=;\n"
      "DONE_%=:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(double* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(double* dst, const CUtensorMap* map,
                                            int c0, int c1,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) of contiguous
// device memory, by the same engine.
__device__ __forceinline__ void bulk_load(double* dst, const double* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's earlier shared-memory accesses before later tensor
// copies into the same memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Where element (row, k) of a tile of kt = 8 or 16 columns lies that a
// tensor copy wrote with the 64- or 128-byte swizzle (rows of kt doubles,
// the 16-byte chunks of a row exchanged by bits of the row number).
__device__ __forceinline__ int swizzled(int row, int k, int kt) {
  const int off = row * kt + k;  // in doubles: bits 1.. are the chunk
  return off ^ (((off >> 4) & (kt == 16 ? 7 : 3)) << 1);
}

// Which row of its 8 (and, 8 further on, of its other 8) lane group g of
// an mma reads from such a tile, and so writes of W_p^T: the rows of a
// 16-row tile may go to the fragment's rows in any order, and in this one
// the four rows that a half-warp reads together fall into different
// banks under the swizzle (rows 0, 2, 4, 6 with 128 bytes, 0, 1, 4, 5 with
// 64), where rows 0-3 collide two by two.
__device__ __forceinline__ int tile_row(int g, int kt) {
  return kt == 16 ? ((g & 3) << 1) | (g >> 2)
                  : (g & 1) | ((g & 2) << 1) | ((g & 4) >> 1);
}

// c[16x8] += a[16x4] b[4x8]. A lane (g = lane / 4, t = lane % 4) holds
// a0 = a[g][t], a1 = a[g + 8][t], b = b[t][g] and
// c[i] = c[g + 8 (i / 2)][2t + i % 2]. The FP64 tensor cores' full rate on
// the H100; m8n8k4 issues at half of it (ops/bench_mma.py).
__device__ __forceinline__ void mma1684(double (&c)[4], double a0, double a1,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// Move (I2, off) to the row of the upper triangle of an mt2 x mt2 grid
// that holds the entry `off` places after (I2, I2); false past the end.
// The entry is then (I2, I2 + off).
__device__ __forceinline__ bool tri_walk(int& I2, int& off, int mt2) {
  while (I2 < mt2 && off >= mt2 - I2) {
    off -= mt2 - I2;
    ++I2;
  }
  return I2 < mt2;
}

// c[jb] += rows [16 I2, 16 I2 + 16) x rows [16 J2 + 8 jb, + 8) of
// W_p^T W_p^T^T, depth round_up(nocc, 4): the 16x16 super-tile (I2, J2) of
// K as two 16x8 tiles. Rows from 8 * mt8 on do not exist: their products
// are left out or come out as zeros.
__device__ __forceinline__ void k_super(const double* Wt, int ldw, int I2,
                                        int J2, int mt8, int nocc, int g,
                                        int t, double (&c)[2][4]) {
  const bool va1 = 2 * I2 + 1 < mt8, vb1 = 2 * J2 + 1 < mt8;
  const double* wa = Wt + static_cast<size_t>(I2 * 16 + g) * ldw + t;
  const double* wb = Wt + static_cast<size_t>(J2 * 16 + g) * ldw + t;
  const int ksteps = (nocc + 3) >> 2;
#pragma unroll 2
  for (int kk = 0; kk < ksteps; ++kk) {
    const double a0 = wa[kk * 4];
    const double a1 = va1 ? wa[8 * ldw + kk * 4] : 0.0;
    const double b0 = wb[kk * 4];
    const double b1 = vb1 ? wb[8 * ldw + kk * 4] : 0.0;
    mma1684(c[0], a0, a1, b0);
    if (vb1) mma1684(c[1], a0, a1, b1);
  }
}

// Where lane (g, t) keeps the super-tile's accumulators c[jb][2 ia + x] in
// a partial K: 8x8 tile (ia, jb) at 64 * (2 ia + jb), row g, columns 2t + x.
__device__ __forceinline__ void k_store(double* kb, const double (&c)[2][4]) {
#pragma unroll
  for (int ia = 0; ia < 2; ++ia)
#pragma unroll
    for (int jb = 0; jb < 2; ++jb)
      *reinterpret_cast<double2*>(kb + (2 * ia + jb) * 64) =
          make_double2(c[jb][2 * ia], c[jb][2 * ia + 1]);
}

// Parts of wk_mma that ops/bench_wk.py's ablation builds leave out
// (-DWK_ABLATE=bits; the results are then wrong, only the time is read).
#ifndef WK_ABLATE
#define WK_ABLATE 0
#endif
constexpr int kNoW = 1, kNoK = 2, kNoJp = 4, kNoJ = 8, kNoKw = 16;

// With -DWK_PROFILE thread 0 of every block sums the clocks it spends in
// each phase and leaves them in the first doubles of its partial K (the
// results are then wrong): ops/bench_wk.py --profile reads them.
#ifdef WK_PROFILE
#define WK_TICK(i)                          \
  {                                         \
    const long long now_ = clock64();       \
    prof_[i] += now_ - last_;               \
    last_ = now_;                           \
  }
#else
#define WK_TICK(i)
#endif

template <bool WITH_J, bool TMA, int NTH, int MTM, int NTM, int KREG>
__global__ void __launch_bounds__(NTH)
wk_mma(const double* __restrict__ B, const double* __restrict__ D,
       const double* __restrict__ C, int naux, int nao, int nocc,
       int rows_per_blk, int kt, int stages, int wm, int mt_panel,
       int j_in_smem, int alias, int vec16, double* __restrict__ Jw,
       double* __restrict__ Kw, const double* __restrict__ Cp,
       const __grid_constant__ CUtensorMap map_b,
       const __grid_constant__ CUtensorMap map_d) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  constexpr int kW = NTH / 32;     // warps
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int gw = TMA ? tile_row(g, kt) : g;  // its row of a tile of W_p^T
  const int blk = blockIdx.x;
  const size_t n2 = static_cast<size_t>(nao) * nao;
  const int mt8 = (nao + 7) / 8;   // 8-row tiles of W_p^T
  const int mt = (nao + 15) / 16;  // 16-row mma tiles, super-tiles of K
  const int nt = (nocc + 7) / 8;   // 8-column tiles of W_p^T
  const int nc8 = nt * 8;
  const int ldw = nc8 + 4;
  const int R = mt_panel * 16;     // rows of a B tile
  const int npanel = (mt + mt_panel - 1) / mt_panel;
  const int nkt = (nao + kt - 1) / kt;
  const int wn = kW / wm;
  const int wmi = warp % wm, wni = warp / wm;
  const int MT = (mt_panel + wm - 1) / wm;  // <= MTM
  const int NT = (nt + wn - 1) / wn;        // <= NTM
  const int ntri = mt * (mt + 1) / 2;

  double* red = reinterpret_cast<double*>(smem_raw);       // [kMaxWarps]
  unsigned long long* full =     // [4]: a stage's tensor copies are done
      reinterpret_cast<unsigned long long*>(red + kMaxWarps);
  // the ring of tiles, then W_p^T [mt8 * 8, ldw], or (alias) both in the
  // same place: W_p^T is written after a row's last tile is consumed and
  // read before the next row's first tile is asked for
  const size_t wt_len = static_cast<size_t>(mt8) * 8 * ldw;
  const size_t ring_len =
      static_cast<size_t>(stages) * kt * ((WITH_J ? 2 : 1) * R + nc8);
  double* Bs = red + kHeader;                              // [stages][R*kt]
  double* Ds = Bs + static_cast<size_t>(stages) * R * kt;  // as Bs, with J
  double* Cs = Ds + (WITH_J ? static_cast<size_t>(stages) * R * kt : 0);
  double* Wt = alias ? Bs : Bs + ring_len;                 // Cs: [st.][nc8*kt]
  double* Jsm = Bs + (alias ? max(wt_len, ring_len) : wt_len + ring_len);

  const int p0 = blk * rows_per_blk;
  const int nrows = min(naux, p0 + rows_per_blk) - p0;
  const int jobs_per_row = npanel * nkt;
  const int njobs = nrows * jobs_per_row;
  // with the partial J in shared memory Jw is [nblk, nao, nao]; else it
  // takes jp [naux] for j_pass
  double* Jg = WITH_J && j_in_smem ? Jw + static_cast<size_t>(blk) * n2
                                   : nullptr;
  double* Kb = Kw + static_cast<size_t>(blk) * ntri * 256;

  // Start the copies of the next (aux row, panel, k-tile) job, in job order,
  // into its stage of the ring, unless it lies past job_end; commits a
  // group either way, so that the group count stays in step with the job
  // count. The cursor (l_*) and each thread's place in a tile are kept, not
  // derived per job: the loop below has no division.
  int job_end = alias ? jobs_per_row : njobs;  // no copies past this job
  int l_job = 0, l_r = 0, l_mp = 0, l_ki = 0, l_st = 0;
  const int hs = 31 - __clz(vec16 ? kt >> 1 : kt);  // chunks a row, log2
  const int b_i0 = tid >> hs;                      // this thread's first row
  const int b_k = (tid & ((1 << hs) - 1)) << (vec16 ? 1 : 0);  // its column
  const int b_di = NTH >> hs;                      // rows a step (NTH >= 32)
  const int b_dst = ((b_k >> 2) * R + b_i0) * 4 + (b_k & 3);
  const int c_k0 = tid / nc8, c_a0 = tid - c_k0 * nc8;  // its C element
  const int c_dk = NTH / nc8, c_da = NTH - c_dk * nc8;
  // With TMA, one thread asks for the B tile (and the D tile) as one or two
  // boxes of tensor copies instead, reported to the stage's mbarrier: the
  // first of the last warp, which has the fewest accumulator tiles (the
  // issue takes some hundred clocks, which a warp with a full share of the
  // products would make every other warp wait for at the next barrier).
  const int box_rows = R > 256 ? R / 2 : R;   // a box has at most 256 rows
  auto load_next = [&]() {
    if (l_job < job_end) {
      const int k0 = l_ki * kt;
      const int i_base = l_mp * R;
      const double* Bp = B + static_cast<size_t>(p0 + l_r) * n2;
      double* dst = Bs + static_cast<size_t>(l_st) * R * kt + b_dst;
      double* cs = Cs + static_cast<size_t>(l_st) * nc8 * kt;
      const bool k_ok = k0 + b_k < nao;
      if constexpr (TMA) {
        if (tid == NTH - 32) {
          unsigned long long* bar = full + l_st;
          double* bs = Bs + static_cast<size_t>(l_st) * R * kt;
          mbar_expect_tx(bar, static_cast<unsigned>(kt) * 8 *
                                  ((WITH_J ? 2 : 1) * R + nc8));
          // the C tile in one piece: pack_c laid C out tile by tile
          bulk_load(cs, Cp + static_cast<size_t>(l_ki) * kt * nc8,
                    static_cast<unsigned>(kt) * nc8 * 8, bar);
          for (int i = 0; i < R; i += box_rows) {
            tma_load_3d(bs + i * kt, &map_b, k0, i_base + i, p0 + l_r, bar);
            if (WITH_J)
              tma_load_2d(bs + (Ds - Bs) + i * kt, &map_d, k0, i_base + i,
                          bar);
          }
        }
      } else {
        // the tile of B[p], and with J the same tile of D (at Ds - Bs from it)
        const size_t g_off =
            static_cast<size_t>(i_base + b_i0) * nao + k0 + b_k;
        const double* src = Bp + g_off;
        const double* dsrc = WITH_J ? D + g_off : nullptr;
        const ptrdiff_t d_dst = Ds - Bs;
        const size_t src_step = static_cast<size_t>(b_di) * nao;
        for (int i = b_i0; i < R; i += b_di, src += src_step, dst += b_di * 4) {
          const bool ok = k_ok && i_base + i < nao;
          if (vec16) {
            cp_async16(dst, ok ? src : Bp, ok ? 16 : 0);
            if (WITH_J) cp_async16(dst + d_dst, ok ? dsrc : D, ok ? 16 : 0);
          } else {
            cp_async8(dst, ok ? src : Bp, ok ? 8 : 0);
            if (WITH_J) cp_async8(dst + d_dst, ok ? dsrc : D, ok ? 8 : 0);
          }
          if (WITH_J) dsrc += src_step;
        }
        for (int k = c_k0, a = c_a0; k < kt;) {
          const bool ok = k0 + k < nao && a < nocc;
          cp_async8(cs + ((k >> 2) * nc8 + a) * 4 + (k & 3),
                    ok ? C + static_cast<size_t>(k0 + k) * nocc + a : C,
                    ok ? 8 : 0);
          k += c_dk;
          a += c_da;
          if (a >= nc8) {
            a -= nc8;
            ++k;
          }
        }
      }
      ++l_job;
      if (++l_st == stages) l_st = 0;
      if (++l_ki == nkt) {
        l_ki = 0;
        if (++l_mp == npanel) {
          l_mp = 0;
          ++l_r;
        }
      }
    }
    if constexpr (!TMA) cp_async_commit();
  };

  if constexpr (TMA) {
    if (tid == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(full + s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    fence_proxy_async();
    __syncthreads();
  }
  for (int s = 0; s < stages - 1; ++s) load_next();
  if (WITH_J && j_in_smem)
    for (size_t e = tid; e < n2; e += NTH) Jsm[e] = 0.0;

  constexpr int KR = KREG > 0 ? KREG : 1;
  double kacc[KR][2][4] = {};

#ifdef WK_PROFILE
  long long prof_[8] = {}, last_ = clock64();
#endif
  // the job and the stage the products are at, and the parity of the
  // stage's mbarrier
  int job = 0, c_st = 0;
  unsigned c_par = 0;
  for (int r = 0; r < nrows; ++r) {
    const double* Bp = B + static_cast<size_t>(p0 + r) * n2;
    double jp_part = 0.0;
    if (alias && r > 0) {
      if constexpr (TMA) fence_proxy_async();
      __syncthreads();  // the previous row's W_p^T has been read
      job_end = (r + 1) * jobs_per_row;
      for (int s = 0; s < stages - 1; ++s) load_next();
    }
    for (int mp = 0; mp < npanel; ++mp) {
      // 16-row tiles of this panel that exist
      const int m_left = min(mt_panel, mt - mp * mt_panel);
      double acc[MTM][NTM][4] = {};
      for (int ki = 0; ki < nkt; ++ki, ++job) {
        WK_TICK(7)
        if constexpr (TMA) {
          mbar_wait(full + c_st, c_par);
          fence_proxy_async();  // this thread is done with the stage that
                                // the next tensor copies overwrite
        } else {
          cp_async_wait(stages - 2);
        }
        WK_TICK(0)
        __syncthreads();  // this job's tiles have landed for every thread;
                          // the previous job's stage is free
        WK_TICK(1)
        load_next();
        WK_TICK(2)
        const double* bs = Bs + static_cast<size_t>(c_st) * R * kt;
        const double* cs = Cs + static_cast<size_t>(c_st) * nc8 * kt;
        if (++c_st == stages) {
          c_st = 0;
          c_par ^= 1;
        }
        const int k0 = ki * kt;
        const int ksteps = (min(kt, nao - k0) + 3) >> 2;
        // W_p^T[i, a] += sum_k B[p, i, k] C[k, a]  (= B[p] C: exact for
        // any B, symmetric or not)
        if (!(WK_ABLATE & kNoW)) {
          for (int kk = 0; kk < ksteps; ++kk) {
            double bf[NTM];
#pragma unroll
            for (int n = 0; n < NTM; ++n) {
              const int a_t = wni * NT + n;
              if (n < NT && a_t < nt)
                bf[n] = cs[(kk * nc8 + a_t * 8 + g) * 4 + t];
            }
#pragma unroll
            for (int m = 0; m < MTM; ++m) {
              const int m_t = wmi * MT + m;
              if (m < MT && m_t < m_left) {
                double a0, a1;
                if constexpr (TMA) {
                  const int row = m_t * 16 + gw;
                  a0 = bs[swizzled(row, kk * 4 + t, kt)];
                  a1 = bs[swizzled(row + 8, kk * 4 + t, kt)];
                } else {
                  const double* ap = bs + (kk * R + m_t * 16 + g) * 4 + t;
                  a0 = ap[0];
                  a1 = ap[32];
                }
#pragma unroll
                for (int n = 0; n < NTM; ++n)
                  if (n < NT && wni * NT + n < nt)
                    mma1684(acc[m][n], a0, a1, bf[n]);
              }
            }
          }
        }
        WK_TICK(3)
        if (WITH_J && !(WK_ABLATE & kNoJp)) {
          // this tile's share of jp[p] = sum_ik B[p, i, k] D[i, k], from
          // the two tiles in shared memory (their zero fill adds nothing)
          const double2* b2 = reinterpret_cast<const double2*>(bs);
          const double2* d2 = reinterpret_cast<const double2*>(
              Ds + (bs - Bs));
          // (every element of the two tiles lies at the same place in
          // both, whatever the layout)
          const int n2el = TMA ? R * kt / 2 : ksteps * R * 2;
          for (int s = tid; s < n2el; s += NTH) {
            const double2 bv = b2[s], dv = d2[s];
            jp_part += bv.x * dv.x + bv.y * dv.y;
          }
        }
      }
      // the panel's W_p^T tiles, once per aux row (the readers of the
      // previous row's W_p^T passed a barrier in the loop above)
      if (alias) __syncthreads();  // the ring's last tile has been read
#pragma unroll
      for (int m = 0; m < MTM; ++m) {
        const int m_t = wmi * MT + m;
        if (m < MT && m_t < m_left) {
          const int row = (mp * mt_panel + m_t) * 16 + gw;
#pragma unroll
          for (int n = 0; n < NTM; ++n) {
            const int a_t = wni * NT + n;
            if (n < NT && a_t < nt) {
              double* w = Wt + static_cast<size_t>(row) * ldw + a_t * 8 + 2 * t;
              *reinterpret_cast<double2*>(w) =
                  make_double2(acc[m][n][0], acc[m][n][1]);
              if (row + 8 < mt8 * 8)
                *reinterpret_cast<double2*>(w + 8 * ldw) =
                    make_double2(acc[m][n][2], acc[m][n][3]);
            }
          }
        }
      }
    }
    double jp = 0.0;
    if (WITH_J) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        jp_part += __shfl_xor_sync(0xffffffffu, jp_part, o);
      if (lane == 0) red[warp] = jp_part;
    }
    WK_TICK(4)
    __syncthreads();  // W_p^T (and the warps' jp shares) are complete
    WK_TICK(5)
    if (WITH_J) {
      for (int w = 0; w < kW; ++w) jp += red[w];
      if (!j_in_smem && tid == 0) Jw[p0 + r] = jp;
    }

    // K += W_p^T-rows(I2) x W_p^T-rows(J2) on the 16x16 super-tiles
    // (I2, J2 >= I2) of the upper triangle, dealt round-robin to the warps
    if (!(WK_ABLATE & kNoK)) {
      if constexpr (KREG > 0) {
        int I2 = 0, off = warp;
#pragma unroll
        for (int s = 0; s < KREG; ++s, off += kW) {
          if (!tri_walk(I2, off, mt)) break;
          k_super(Wt, ldw, I2, I2 + off, mt8, nocc, g, t, kacc[s]);
        }
      } else {
        int I2 = 0, off = warp;
        for (int idx = warp; idx < ntri; idx += kW, off += kW) {
          tri_walk(I2, off, mt);
          double* kb = Kb + static_cast<size_t>(idx) * 256 + g * 8 + 2 * t;
          // the partial's old value: asked for before the products, added
          // after them
          double c[2][4] = {};
          double old[2][4] = {};
          if (r > 0 && !(WK_ABLATE & kNoKw)) {
#pragma unroll
            for (int ia = 0; ia < 2; ++ia)
#pragma unroll
              for (int jb = 0; jb < 2; ++jb) {
                const double2 v = *reinterpret_cast<const double2*>(
                    kb + (2 * ia + jb) * 64);
                old[jb][2 * ia] = v.x;
                old[jb][2 * ia + 1] = v.y;
              }
          }
          k_super(Wt, ldw, I2, I2 + off, mt8, nocc, g, t, c);
#pragma unroll
          for (int jb = 0; jb < 2; ++jb)
#pragma unroll
            for (int x = 0; x < 4; ++x) c[jb][x] += old[jb][x];
          if (!(WK_ABLATE & kNoKw) || r == nrows - 1) k_store(kb, c);
        }
      }
    }

    WK_TICK(6)
    if (WITH_J && j_in_smem && !(WK_ABLATE & kNoJ)) {
      // J += jp[p] B[p]: the row again (from L2), all loads of a step
      // issued before the first is used
      constexpr int kJS = 2 * kU;
      for (size_t e0 = tid; e0 < n2; e0 += kJS * NTH) {
        double b[kJS];
#pragma unroll
        for (int u = 0; u < kJS; ++u) {
          const size_t e = e0 + static_cast<size_t>(u) * NTH;
          b[u] = e < n2 ? Bp[e] : 0.0;
        }
#pragma unroll
        for (int u = 0; u < kJS; ++u) {
          const size_t e = e0 + static_cast<size_t>(u) * NTH;
          if (e < n2) Jsm[e] += jp * b[u];
        }
      }
    }
  }

  if constexpr (KREG > 0) {
    int I2 = 0, off = warp;
#pragma unroll
    for (int s = 0; s < KREG; ++s, off += kW) {
      if (!tri_walk(I2, off, mt)) break;
      k_store(Kb + static_cast<size_t>(warp + s * kW) * 256 + g * 8 + 2 * t,
              kacc[s]);
    }
  }
  if (WITH_J && j_in_smem) {
    __syncthreads();
    for (size_t e = tid; e < n2; e += NTH) Jg[e] = Jsm[e];
  }
#ifdef WK_PROFILE
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < 8; ++i) Kb[i] = static_cast<double>(prof_[i]);
#endif
}

// The sums over wk_mma's per-block partials, in block order b = 0, 1, ...,
// nblk - 1, with kSumU loads issued at a time. Elements [0, nao^2): K[i, j]
// from the partials that hold the 16x16 super-tiles of the upper triangle
// as four 8x8 tiles each (kstride doubles a block); an element under the
// tile diagonal is read at its transpose. With Jw not null, elements
// [nao^2, 2 nao^2): J from the partials Jw [nblk, nao, nao].
constexpr int kSumU = 16;
__global__ void wk_sum(const double* __restrict__ Kw,
                       const double* __restrict__ Jw, int nblk,
                       size_t kstride, int nao, int mt,
                       double* __restrict__ K, double* __restrict__ J) {
  const size_t n2 = static_cast<size_t>(nao) * nao;
  const size_t total = Jw != nullptr ? 2 * n2 : n2;
  const size_t step = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += step) {
    const double* src;
    size_t bstride;
    double* dst;
    if (e < n2) {
      int i = static_cast<int>(e / nao);
      int j = static_cast<int>(e - static_cast<size_t>(i) * nao);
      if ((i >> 3) > (j >> 3)) {
        const int tmp = i;
        i = j;
        j = tmp;
      }
      const int I = i >> 3, J8 = j >> 3;
      const size_t sup = tri_row_start(I >> 1, mt) + ((J8 >> 1) - (I >> 1));
      src = Kw + (sup * 4 + (I & 1) * 2 + (J8 & 1)) * 64 + (i & 7) * 8 +
            (j & 7);
      bstride = kstride;
      dst = K + e;
    } else {
      src = Jw + (e - n2);
      bstride = n2;
      dst = J + (e - n2);
    }
    double s = 0.0;
    for (int b0 = 0; b0 < nblk; b0 += kSumU) {
      double v[kSumU];
#pragma unroll
      for (int u = 0; u < kSumU; ++u)
        v[u] = b0 + u < nblk ? src[static_cast<size_t>(b0 + u) * bstride] : 0.0;
#pragma unroll
      for (int u = 0; u < kSumU; ++u) s += v[u];
    }
    *dst = s;
  }
}

// J[e] = sum over p = 0, 1, ..., naux - 1, in that order, of jp[p] B[p, e]:
// the Coulomb matrix as a second pass over B, for the shapes whose partial
// J does not fit in shared memory (a per-block partial in device memory
// would be read and written once per aux row). A thread owns one element
// and has kSumU loads in flight; neighbouring threads read neighbouring
// elements.
__global__ void j_pass(const double* __restrict__ B,
                       const double* __restrict__ jp, int naux, size_t n2,
                       double* __restrict__ J) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n2) return;
  const double* src = B + e;
  double s = 0.0;
  for (int q0 = 0; q0 < naux; q0 += kSumU) {
    double v[kSumU];
#pragma unroll
    for (int u = 0; u < kSumU; ++u)
      v[u] = q0 + u < naux ? src[static_cast<size_t>(q0 + u) * n2] : 0.0;
#pragma unroll
    for (int u = 0; u < kSumU; ++u)
      if (q0 + u < naux) s += jp[q0 + u] * v[u];
  }
  J[e] = s;
}

// Dynamic shared memory of wk_mma, in bytes (ops/plan.py has the same sum).
inline size_t mma_smem_bytes(int nao, int nocc, int kt, int stages,
                             int mt_panel, int j_in_smem, int alias,
                             bool with_j) {
  const size_t mt8 = (nao + 7) / 8, nc8 = round_up(nocc, 8);
  const size_t wt = mt8 * 8 * (nc8 + 4);
  const size_t ring = static_cast<size_t>(stages) * kt *
                      ((with_j ? 2 : 1) * mt_panel * 16 + nc8);
  return 8 * (kHeader + (alias ? (wt > ring ? wt : ring) : wt + ring) +
              (j_in_smem ? static_cast<size_t>(nao) * nao : 0));
}

// C [nao, nocc] tile by tile in the order wk_mma keeps a C tile in shared
// memory ([nkt][kt / 4][nc8][4], zeros past nao and nocc), so that a tile
// is one contiguous piece for the copy engine.
__global__ void pack_c(const double* __restrict__ C, int nao, int nocc,
                       int kt, int nc8, int nkt, double* __restrict__ Cp) {
  const int total = nkt * kt * nc8;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const int tile = e / (kt * nc8), idx = e - tile * (kt * nc8);
    const int a = (idx >> 2) % nc8;
    const int k = tile * kt + ((idx >> 2) / nc8) * 4 + (idx & 3);
    Cp[e] = k < nao && a < nocc ? C[static_cast<size_t>(k) * nocc + a] : 0.0;
  }
}

// The tensor map of a row-major f64 tensor of rank 2 or 3 (dims fastest
// first: columns, rows, slices) for boxes of box_cols x box_rows (x 1) with
// the swizzle of box_cols * 8 bytes (64 or 128).
inline cudaError_t make_tensor_map(CUtensorMap* map, const double* base,
                                   int rank, int ncols, int nrows, int nslices,
                                   int box_cols, int box_rows) {
  typedef CUresult (*Encode)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  // cuTensorMapEncodeTiled lives in libcuda, which the library is not
  // linked against: looked up once in the copy the process has loaded
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    void* fn = lib != nullptr ? dlsym(lib, "cuTensorMapEncodeTiled") : nullptr;
    if (fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(ncols),
                              static_cast<cuuint64_t>(nrows),
                              static_cast<cuuint64_t>(nslices)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(ncols) * 8,
      static_cast<cuuint64_t>(ncols) * static_cast<cuuint64_t>(nrows) * 8};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, static_cast<cuuint32_t>(rank),
      const_cast<double*>(base), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_cols == 16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool WITH_J, bool TMA, int NTH, int MTM, int NTM, int KREG>
cudaError_t launch_mma(const double* B, const double* D, const double* C,
                       int naux, int nao, int nocc, int nblk,
                       int rows_per_blk, int kt, int stages, int wm,
                       int mt_panel, int j_in_smem, int alias, int vec16,
                       size_t smem, double* Jw, double* Kw, double* Cp,
                       cudaStream_t s) {
  constexpr int kW = NTH / 32;
  const int mt = (nao + 15) / 16, nt = (nocc + 7) / 8;
  if (wm < 1 || wm > kW || kW % wm != 0) return cudaErrorInvalidValue;
  const int wn = kW / wm;
  if ((mt_panel + wm - 1) / wm > MTM || (nt + wn - 1) / wn > NTM ||
      (KREG > 0 && mt * (mt + 1) / 2 > kW * KREG))
    return cudaErrorInvalidValue;
  CUtensorMap map_b = {}, map_d = {};
  cudaError_t err;
  if (TMA) {
    const int R = mt_panel * 16;
    const int box_rows = R > 256 ? R / 2 : R;
    if ((kt != 8 && kt != 16) || !vec16 || box_rows > 256 || Cp == nullptr)
      return cudaErrorInvalidValue;
    const int nc8 = round_up(nocc, 8), nkt = (nao + kt - 1) / kt;
    pack_c<<<(nkt * kt * nc8 + 255) / 256, 256, 0, s>>>(C, nao, nocc, kt, nc8,
                                                       nkt, Cp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = make_tensor_map(&map_b, B, 3, nao, nao, naux, kt, box_rows);
    if (err != cudaSuccess) return err;
    if (WITH_J) {
      err = make_tensor_map(&map_d, D, 2, nao, nao, 1, kt, box_rows);
      if (err != cudaSuccess) return err;
    }
  }
  auto kernel = wk_mma<WITH_J, TMA, NTH, MTM, NTM, KREG>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<nblk, NTH, smem, s>>>(B, D, C, naux, nao, nocc, rows_per_blk, kt,
                                 stages, wm, mt_panel, j_in_smem, alias,
                                 vec16, Jw, Kw, Cp, map_b, map_d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// wk_partial
// ---------------------------------------------------------------------
//
// Layout (all in units of T): ldw = round_up(nao, kR) and
// ldc = round_up(nocc, kR) pad W, B rows and C columns with zeros so that
// every micro-tile is full; the padding never reaches J or K.

template <typename T, bool WITH_J>
__global__ void __launch_bounds__(kThreads)
wk_partial(const T* __restrict__ B, const T* __restrict__ D,
           const T* __restrict__ C, int naux, int nao, int nocc,
           int rows_per_blk, int kt, int w_in_smem, T* __restrict__ Jw,
           T* __restrict__ Kw, T* __restrict__ Wslab) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldw = round_up(nao, kR);
  const int ldc = round_up(nocc, kR);
  // B[p] column tile [ldw, kt], row stride kt + 1 (odd: consecutive rows
  // fall in different banks)
  const int ldb = kt + 1;
  T* red = reinterpret_cast<T*>(smem_raw);          // [kThreads]
  T* Bs = red + kThreads;                           // [ldw, ldb]
  T* Cs = Bs + static_cast<size_t>(ldw) * ldb;      // [kt, ldc]
  T* Wsm = Cs + static_cast<size_t>(kt) * ldc;      // [ldc, ldw] if in smem

  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const size_t n2 = static_cast<size_t>(nao) * nao;
  const int nw = ldc * ldw;
  T* W = w_in_smem ? Wsm : Wslab + static_cast<size_t>(blk) * nw;
  T* Jb = WITH_J ? Jw + static_cast<size_t>(blk) * n2 : nullptr;
  T* Kb = Kw + static_cast<size_t>(blk) * n2;
  const bool whole = kt >= nao;  // B[p] fully staged: read once
  const int n_at = ldc / kR, n_it = ldw / kR;
  const int n_tri = n_it * (n_it + 1) / 2;

  for (size_t e = tid; e < n2; e += kThreads) {
    if (WITH_J) Jb[e] = T(0);
    Kb[e] = T(0);
  }
  // zero padding rows of Bs and padding columns of Cs once: the loads
  // below never write them
  for (int e = tid; e < (ldw - nao) * ldb; e += kThreads)
    Bs[static_cast<size_t>(nao) * ldb + e] = T(0);
  for (int e = tid; e < kt * ldc; e += kThreads) Cs[e] = T(0);

  const int p0 = blk * rows_per_blk;
  const int p1 = min(naux, p0 + rows_per_blk);
  for (int p = p0; p < p1; ++p) {
    const T* Bp = B + static_cast<size_t>(p) * n2;
    __syncthreads();  // previous row's readers of W/Bs are done
    for (int e = tid; e < nw; e += kThreads) W[e] = T(0);
    T jp_part = T(0);
    for (int k0 = 0; k0 < nao; k0 += kt) {
      const int kn = min(kt, nao - k0);
      __syncthreads();  // W zeroed / previous tile consumed
      for (int e = tid; e < nao * kn; e += kThreads) {
        const int i = e / kn;
        const int k = e - i * kn;
        const size_t g = static_cast<size_t>(i) * nao + k0 + k;
        const T b = Bp[g];
        Bs[i * ldb + k] = b;
        if (WITH_J) jp_part += b * D[g];
      }
      for (int e = tid; e < kn * nocc; e += kThreads) {
        const int k = e / nocc;
        const int a = e - k * nocc;
        Cs[k * ldc + a] = C[static_cast<size_t>(k0 + k) * nocc + a];
      }
      __syncthreads();
      // W[a, i] += sum_k B[p, i, k0 + k] * C[k0 + k, a]  (= (B[p] C)^T:
      // exact for any B, symmetric or not), kR x kR (a, i) per thread
      for (int e = tid; e < n_at * n_it; e += kThreads) {
        const int a0 = (e % n_at) * kR;
        const int i0 = (e / n_at) * kR;
        T acc[kR][kR] = {};
        for (int k = 0; k < kn; ++k) {
          T bv[kR], cv[kR];
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            bv[r] = Bs[(i0 + r) * ldb + k];
            cv[r] = Cs[k * ldc + a0 + r];
          }
#pragma unroll
          for (int s = 0; s < kR; ++s)
#pragma unroll
            for (int r = 0; r < kR; ++r) acc[s][r] += cv[s] * bv[r];
        }
#pragma unroll
        for (int s = 0; s < kR; ++s)
#pragma unroll
          for (int r = 0; r < kR; ++r)
            W[(a0 + s) * ldw + i0 + r] += acc[s][r];
      }
    }
    if (WITH_J) {
      T jp[1] = {jp_part};
      dfc::block_sum<T, 1>(jp, red);  // its barriers also publish W
      // J += jp[p] B[p]
      for (size_t e = tid; e < n2; e += kThreads) {
        const int i = static_cast<int>(e / nao);
        const int j = static_cast<int>(e - static_cast<size_t>(i) * nao);
        Jb[e] += jp[0] * (whole ? Bs[i * ldb + j] : Bp[e]);
      }
    } else {
      __syncthreads();  // publish W
    }
    // K += W_p^T W_p on the tiles (I, J >= I) of the upper triangle;
    // the final sum mirrors the rest
    for (int e = tid; e < n_tri; e += kThreads) {
      int I = static_cast<int>(
          (2.0 * n_it + 1.0 -
           sqrt((2.0 * n_it + 1.0) * (2.0 * n_it + 1.0) - 8.0 * e)) / 2.0);
      while (I > 0 && tri_row_start(I, n_it) > e) --I;
      while (tri_row_start(I + 1, n_it) <= e) ++I;
      const int i0 = I * kR;
      const int j0 = (I + e - tri_row_start(I, n_it)) * kR;
      T acc[kR][kR] = {};
      for (int a = 0; a < ldc; ++a) {
        T wi[kR], wj[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          wi[r] = W[a * ldw + i0 + r];
          wj[r] = W[a * ldw + j0 + r];
        }
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int c = 0; c < kR; ++c) acc[r][c] += wi[r] * wj[c];
      }
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < kR; ++c) {
          const int i = i0 + r, j = j0 + c;
          if (i < nao && j < nao)
            Kb[static_cast<size_t>(i) * nao + j] += acc[r][c];
        }
    }
  }
}

// Dynamic shared memory of wk_partial, in bytes (ops/plan.py has the same
// sum).
inline size_t fma_smem_bytes(size_t es, int nao, int nocc, int kt,
                             int w_in_smem) {
  const size_t ldw = round_up(nao, kR), ldc = round_up(nocc, kR);
  return es * (kThreads + ldw * (kt + 1) + static_cast<size_t>(kt) * ldc +
               (w_in_smem ? ldc * ldw : 0));
}

// ---------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------

// The plan of ops/plan.py::wk_plan, as the C entries take it.
struct Plan {
  int kind;       // 1: wk_mma (FP64 only), 0: wk_partial
  int variant;    // wk_mma: the instantiation (ops/plan.py::VARIANTS)
  int kt, stages, wm, mt_panel, w_in_smem, j_in_smem;
  int alias;      // wk_mma: the ring of tiles shares W_p^T's shared memory
  int tma;        // wk_mma: tiles by tensor copies (kt 8 or 16, B aligned)
  int smem_bytes;
};

// Launch the partial pass and the fixed-order sums of the partials on
// ``stream``. The plan is checked, not chosen, here: a plan that is
// inconsistent, or whose shared memory (recomputed from its fields)
// differs from plan.smem_bytes or exceeds the device's cap, returns
// cudaErrorInvalidValue. Without J, D, Jw and J are unused (pass null).
// Returns cudaGetLastError() (or the first failing runtime call's code).
template <typename T, bool WITH_J>
int launch_wk(const void* B, const void* D, const void* C, int naux,
              int nao, int nocc, int nblk, int rows_per_blk, Plan pl,
              int vec16, void* Jw, void* Kw, void* Wslab, void* J, void* K,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t cap = 0;
  cudaError_t err = dfc::smem_optin(&cap);
  if (err != cudaSuccess) return err;
  const size_t n2 = static_cast<size_t>(nao) * nao;
  if (pl.kind == 1) {
    if constexpr (std::is_same<T, double>::value) {
      if (pl.kt < 4 || pl.kt > 32 || (pl.kt & (pl.kt - 1)) != 0 ||
          pl.stages < 2 || pl.stages > 4 || pl.mt_panel < 1 || !pl.w_in_smem ||
          (pl.alias && (nao + 15) / 16 > pl.mt_panel) ||
          (pl.j_in_smem && !WITH_J))
        return cudaErrorInvalidValue;
      const size_t smem = mma_smem_bytes(nao, nocc, pl.kt, pl.stages,
                                         pl.mt_panel, pl.j_in_smem, pl.alias,
                                         WITH_J);
      if (smem != static_cast<size_t>(pl.smem_bytes) || smem > cap)
        return cudaErrorInvalidValue;
      const double* b = static_cast<const double*>(B);
      const double* d = static_cast<const double*>(D);
      const double* c = static_cast<const double*>(C);
      double* jw = static_cast<double*>(Jw);
      double* kw = static_cast<double*>(Kw);
      // the variants of ops/plan.py::VARIANTS: threads, MTM, NTM, KREG
      // tensor copies where the plan allows them and B (and D) are aligned
#define DFK_LAUNCH_MMA(NTH, MTM, NTM, KREG)                                 \
  (pl.tma && vec16                                                          \
       ? launch_mma<WITH_J, true, NTH, MTM, NTM, KREG>(                     \
             b, d, c, naux, nao, nocc, nblk, rows_per_blk, pl.kt,           \
             pl.stages, pl.wm, pl.mt_panel, pl.j_in_smem, pl.alias, vec16,  \
             smem, jw, kw, static_cast<double*>(Wslab), s)                  \
       : launch_mma<WITH_J, false, NTH, MTM, NTM, KREG>(                    \
             b, d, c, naux, nao, nocc, nblk, rows_per_blk, pl.kt,           \
             pl.stages, pl.wm, pl.mt_panel, pl.j_in_smem, pl.alias, vec16,  \
             smem, jw, kw, nullptr, s))
      if (pl.variant == 0)
        err = DFK_LAUNCH_MMA(512, 2, 2, 2);
      else if (pl.variant == 1)
        err = DFK_LAUNCH_MMA(256, 5, 5, 0);
      else
        err = cudaErrorInvalidValue;
#undef DFK_LAUNCH_MMA
      if (err != cudaSuccess) return err;
      const int mt = (nao + 15) / 16;
      const size_t kstride = static_cast<size_t>(mt) * (mt + 1) / 2 * 256;
      const int threads = 256;
      const bool j_sum = WITH_J && pl.j_in_smem;
      size_t blocks = ((j_sum ? 2 : 1) * n2 + threads - 1) / threads;
      if (blocks > 8192) blocks = 8192;
      wk_sum<<<static_cast<int>(blocks), threads, 0, s>>>(
          kw, j_sum ? jw : nullptr, nblk, kstride, nao, mt,
          static_cast<double*>(K), static_cast<double*>(J));
      err = cudaGetLastError();
      if (err != cudaSuccess || !WITH_J || pl.j_in_smem) return err;
      j_pass<<<static_cast<int>((n2 + threads - 1) / threads), threads, 0,
               s>>>(b, jw, naux, n2, static_cast<double*>(J));
      return cudaGetLastError();
    } else {
      return cudaErrorInvalidValue;
    }
  }
  if (pl.kind != 0 || pl.kt < 1 || pl.kt > nao || pl.j_in_smem)
    return cudaErrorInvalidValue;
  const size_t smem =
      fma_smem_bytes(sizeof(T), nao, nocc, pl.kt, pl.w_in_smem);
  if (smem != static_cast<size_t>(pl.smem_bytes) || smem > cap)
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(wk_partial<T, WITH_J>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  wk_partial<T, WITH_J><<<nblk, kThreads, smem, s>>>(
      static_cast<const T*>(B), static_cast<const T*>(D),
      static_cast<const T*>(C), naux, nao, nocc, rows_per_blk, pl.kt,
      pl.w_in_smem, static_cast<T*>(Jw), static_cast<T*>(Kw),
      static_cast<T*>(Wslab));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (WITH_J) {
    err = dfc::launch_partial_sum<T>(static_cast<const T*>(Jw), nblk, n2, nao,
                                     0, static_cast<T*>(J), s);
    if (err != cudaSuccess) return err;
  }
  // K partials hold the upper kR-tile triangle only
  return dfc::launch_partial_sum<T>(static_cast<const T*>(Kw), nblk, n2, nao,
                                    kR, static_cast<T*>(K), s);
}

}  // namespace dfk
