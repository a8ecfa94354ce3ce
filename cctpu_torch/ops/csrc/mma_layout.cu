// Test kernels for the FP64 tensor-core instructions (mma.sync ... .f64):
// their fragment layouts and their issue rates. Not on any path of the
// port; tests/test_torch_gpu.py and ops/bench_mma.py call them.
//
// Layouts, lane (g = lane / 4, t = lane % 4):
//   m8n8k4   a[g][t]; b[t][g]; c[g][2t], c[g][2t+1]
//   m16n8kK  (K = 4, 8, 16) a_i = a[g + 8 (i % 2)][t + 4 (i / 2)];
//            b_i = b[t + 4 i][g];
//            c_i = c[g + 8 (i / 2)][2t + i % 2]
//            (K = 4 through df_wk.cuh's mma1684, which wk_mma is built on)
//
// C interface (bound with ctypes): a [M, K], b [K, 8], c [M, 8] are
// row-major device arrays; shape is 884, 1684, 1688 or 16816.

#include "df_wk.cuh"

namespace {

__device__ __forceinline__ void mma884(double (&c)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

template <int KK>
__device__ __forceinline__ void mma16(double (&c)[4], const double (&a)[KK / 2],
                                      const double (&b)[KK / 4]) {
  if constexpr (KK == 4) {
    dfk::mma1684(c, a[0], a[1], b[0]);
  } else if constexpr (KK == 8) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
          "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
}

__global__ void layout884(const double* a, const double* b, double* c) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double acc[2] = {0.0, 0.0};
  mma884(acc, a[g * 4 + t], b[t * 8 + g]);
  c[g * 8 + 2 * t] = acc[0];
  c[g * 8 + 2 * t + 1] = acc[1];
}

template <int KK>
__global__ void layout16(const double* a, const double* b, double* c) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double af[KK / 2], bf[KK / 4], acc[4] = {};
#pragma unroll
  for (int i = 0; i < KK / 2; ++i)
    af[i] = a[(g + 8 * (i % 2)) * KK + t + 4 * (i / 2)];
#pragma unroll
  for (int i = 0; i < KK / 4; ++i) bf[i] = b[(t + 4 * i) * 8 + g];
  mma16<KK>(acc, af, bf);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    c[(g + 8 * (i / 2)) * 8 + 2 * t + i % 2] = acc[i];
}

constexpr int kChains = 8;  // independent accumulators per warp

// Every warp issues iters x kChains independent mma of the shape and adds
// its accumulators into out (so the work cannot be dropped).
template <int SHAPE>
__global__ void __launch_bounds__(512) rate(int iters, double* out) {
  const double x = 1.0 + 1e-9 * threadIdx.x;
  double s = 0.0;
  if constexpr (SHAPE == 884) {
    double acc[kChains][2] = {};
    for (int it = 0; it < iters; ++it)
#pragma unroll
      for (int c = 0; c < kChains; ++c) mma884(acc[c], x, x);
#pragma unroll
    for (int c = 0; c < kChains; ++c) s += acc[c][0] + acc[c][1];
  } else {
    constexpr int KK = SHAPE == 1684 ? 4 : SHAPE == 1688 ? 8 : 16;
    double acc[kChains][4] = {};
    double af[KK / 2], bf[KK / 4];
#pragma unroll
    for (int i = 0; i < KK / 2; ++i) af[i] = x + i;
#pragma unroll
    for (int i = 0; i < KK / 4; ++i) bf[i] = x - i;
    for (int it = 0; it < iters; ++it)
#pragma unroll
      for (int c = 0; c < kChains; ++c) mma16<KK>(acc[c], af, bf);
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  }
  if (s == 12345.678) out[0] = s;
}

}  // namespace

extern "C" {

int mma_layout_f64(int shape, const void* a, const void* b, void* c,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* pa = static_cast<const double*>(a);
  const double* pb = static_cast<const double*>(b);
  double* pc = static_cast<double*>(c);
  if (shape == 884) layout884<<<1, 32, 0, s>>>(pa, pb, pc);
  else if (shape == 1684) layout16<4><<<1, 32, 0, s>>>(pa, pb, pc);
  else if (shape == 1688) layout16<8><<<1, 32, 0, s>>>(pa, pb, pc);
  else if (shape == 16816) layout16<16><<<1, 32, 0, s>>>(pa, pb, pc);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// nblk blocks of `warps` warps (at most 16), iters x 8 mma a warp; flops
// of the launch: nblk * warps * iters * 8 * 2 * M * 8 * K.
int mma_rate_f64(int shape, int nblk, int warps, int iters, void* out,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* po = static_cast<double*>(out);
  const int th = 32 * warps;
  if (warps < 1 || warps > 16) return cudaErrorInvalidValue;
  if (shape == 884) rate<884><<<nblk, th, 0, s>>>(iters, po);
  else if (shape == 1684) rate<1684><<<nblk, th, 0, s>>>(iters, po);
  else if (shape == 1688) rate<1688><<<nblk, th, 0, s>>>(iters, po);
  else if (shape == 16816) rate<16816><<<nblk, th, 0, s>>>(iters, po);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
