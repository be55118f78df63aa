// The block-Thomas sweep (K6) for Hopper (sm_90a): one launch runs one
// whole serial sweep of the btd direct solve,
//
//   forward  (reverse = 0):  y_i = g_i - A_i y_{i-1},  y_{-1} = 0
//   backward (reverse = 1):  x_i = g_i - A_i x_{i+1},  x_{n} = 0
//
// over n row blocks A_i of Bt x Bt (V = Sinv L forward, W = Sinv U
// backward).  Plain C entry points, loaded with ctypes by
// vf_fem_tpu_torch/ops/kernels.py, which also holds the plain PyTorch
// version (btd_sweep_reference).
//
// No TPU kernel is replaced: the JAX package runs the sweeps as lax.scan
// (vf_fem_tpu/solvers/btd.py:298-312), which XLA compiles into one loop.
// In eager PyTorch each row would cost ~4 launches (cast, matvec, cast,
// subtract), ~750 per solve; here the whole chain is one launch.
//
// Rounding is the plain version's: the carried vector is cast to the
// factor type (f64 -> bf16 through f32, as torch's .to() rounds), the
// products accumulate in f32 for bf16 factors (in the factor type
// otherwise), and the sum is cast back to the vector type before the
// subtraction, which is rounded on its own (__dsub_rn / __fsub_rn, never
// contracted into an FMA).  Each row's dot products are summed in a fixed
// order (per lane along its 16-byte chunks, then an xor-shuffle tree), so
// the kernel differs from the plain matvec only within the bound on
// dot-product order (ops.dot_order_bound).
//
// Design (simple and right first): one CTA of 1024 threads per sweep.
// The carried vector, cast to the factor type, sits in shared memory
// (double-buffered, one __syncthreads() per row).  One warp per group of
// rows reads A_i along the row with 16-byte loads (coalesced), keeping up
// to 8 loads per lane in flight, and the next row block is prefetched
// into L2 while the current one is reduced (A does not depend on the
// recurrence).  Bound: one SM's load bandwidth, not HBM: at 23.7k dofs a
// sweep streams 93 blocks of 256 x 256 (12.2 MB in bf16, 48.8 MB in f64)
// through one SM.  Prefetching with TMA or spreading each row over a
// thread-block cluster is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kChunksInFlight = 8;  // 16-byte loads per lane per batch

template <typename TA>
struct Acc {
  using type = TA;
};
template <>
struct Acc<__nv_bfloat16> {
  using type = float;
};

__device__ __forceinline__ float to_acc(__nv_bfloat16 a) {
  return __bfloat162float(a);
}
__device__ __forceinline__ float to_acc(float a) { return a; }
__device__ __forceinline__ double to_acc(double a) { return a; }

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

// the carried vector in the factor type
template <typename TA, typename TV>
__device__ __forceinline__ TA to_factor(TV v);
template <>
__device__ __forceinline__ __nv_bfloat16 to_factor<__nv_bfloat16, double>(
    double v) {
  return __float2bfloat16_rn(__double2float_rn(v));
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_factor<__nv_bfloat16, float>(
    float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ double to_factor<double, double>(double v) {
  return v;
}
template <>
__device__ __forceinline__ float to_factor<float, float>(float v) {
  return v;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

template <typename TA, typename TV, int BT>
__global__ void __launch_bounds__(kThreads, 1)
    btd_sweep_kernel(const TA* __restrict__ A, const TV* __restrict__ g,
                     TV* __restrict__ out, int n, int reverse) {
  using AccT = typename Acc<TA>::type;
  constexpr int VEC = 16 / sizeof(TA);     // entries per 16-byte chunk
  constexpr int CPR = BT / VEC;            // chunks per row
  constexpr int CPL = (CPR + 31) / 32;     // chunks per lane per row
  constexpr int RB = CPL >= kChunksInFlight ? 1 : kChunksInFlight / CPL;
  constexpr long long kBlock = static_cast<long long>(BT) * BT;
  constexpr int kLines = static_cast<int>(kBlock * sizeof(TA) / 128);

  __shared__ __align__(16) TA xs[2][BT];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < BT; k += kThreads) xs[0][k] = to_factor<TA, TV>(TV(0));
  __syncthreads();

  int cur = 0;
  for (int s = 0; s < n; ++s) {
    const int i = reverse ? n - 1 - s : s;
    const TA* Ai = A + i * kBlock;
    const TV* gi = g + static_cast<long long>(i) * BT;
    TV* oi = out + static_cast<long long>(i) * BT;
    if (s + 1 < n) {
      const char* next =
          reinterpret_cast<const char*>(A + (reverse ? i - 1 : i + 1) * kBlock);
      for (int l = threadIdx.x; l < kLines; l += kThreads)
        prefetch_l2(next + static_cast<long long>(l) * 128);
    }
    const uint4* x4 = reinterpret_cast<const uint4*>(xs[cur]);
    TA* xn = xs[cur ^ 1];

    // batches of RB rows per warp: rows k0 + u * kWarps, u < RB
    for (int k0 = warp; k0 < BT; k0 += kWarps * RB) {
      uint4 a[RB][CPL];
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        const int k = k0 + u * kWarps;
        const uint4* row = reinterpret_cast<const uint4*>(Ai + k * BT);
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int ch = lane + 32 * c;
          a[u][c] = (k < BT && ch < CPR) ? __ldg(row + ch)
                                          : make_uint4(0u, 0u, 0u, 0u);
        }
      }
      // lane u keeps g of row u of the batch
      const int ku = k0 + lane * kWarps;
      const TV g_mine = (lane < RB && ku < BT) ? gi[ku] : TV(0);
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        const int k = k0 + u * kWarps;
        if (k >= BT) break;  // uniform across the warp
        AccT acc = AccT(0);
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int ch = lane + 32 * c;
          if (ch < CPR) {
            const uint4 xv4 = x4[ch];
            const TA* av = reinterpret_cast<const TA*>(&a[u][c]);
            const TA* xv = reinterpret_cast<const TA*>(&xv4);
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              acc = fma_rn(to_acc(av[v]), to_acc(xv[v]), acc);
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == u) {
          const TV y = sub_rn(g_mine, static_cast<TV>(acc));
          oi[k] = y;
          xn[k] = to_factor<TA, TV>(y);
        }
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

template <typename TA, typename TV, int BT>
int launch_bt(const void* A, const void* g, void* out, int n, int reverse,
              void* stream) {
  btd_sweep_kernel<TA, TV, BT><<<1, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TA*>(A), static_cast<const TV*>(g),
      static_cast<TV*>(out), n, reverse);
  return static_cast<int>(cudaGetLastError());
}

// Bt = h * 128 for the block-banded plans of b = 128 (h = 1 .. 4)
template <typename TA, typename TV>
int launch_sweep(const void* A, const void* g, void* out, int n, int bt,
                 int reverse, void* stream) {
  if (n == 0) return 0;
  switch (bt) {
    case 128:
      return launch_bt<TA, TV, 128>(A, g, out, n, reverse, stream);
    case 256:
      return launch_bt<TA, TV, 256>(A, g, out, n, reverse, stream);
    case 384:
      return launch_bt<TA, TV, 384>(A, g, out, n, reverse, stream);
    case 512:
      return launch_bt<TA, TV, 512>(A, g, out, n, reverse, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Each entry point returns the cudaError_t of its launch (0 on success).
// Suffix: factor type, vector type.
extern "C" {

int vf_btd_sweep_bf16_f64(const void* A, const void* g, void* out, int n,
                          int bt, int reverse, void* stream) {
  return launch_sweep<__nv_bfloat16, double>(A, g, out, n, bt, reverse,
                                             stream);
}

int vf_btd_sweep_bf16_f32(const void* A, const void* g, void* out, int n,
                          int bt, int reverse, void* stream) {
  return launch_sweep<__nv_bfloat16, float>(A, g, out, n, bt, reverse,
                                            stream);
}

int vf_btd_sweep_f64_f64(const void* A, const void* g, void* out, int n,
                         int bt, int reverse, void* stream) {
  return launch_sweep<double, double>(A, g, out, n, bt, reverse, stream);
}

int vf_btd_sweep_f32_f32(const void* A, const void* g, void* out, int n,
                         int bt, int reverse, void* stream) {
  return launch_sweep<float, float>(A, g, out, n, bt, reverse, stream);
}

}  // extern "C"
