// The block-Thomas sweep (K6) and its transpose (K6T) for Hopper
// (sm_90a).  K6T is described after K6's kernel.  One launch of K6 runs one
// whole serial sweep of the btd direct solve,
//
//   forward  (reverse = 0):  y_i = g_i - A_i y_{i-1},  y_{-1} = 0
//   backward (reverse = 1):  x_i = g_i - A_i x_{i+1},  x_{n} = 0
//
// over n row blocks A_i of Bt x Bt (V = Sinv L forward, W = Sinv U
// backward).  Plain C entry points, loaded with ctypes by
// vf_fem_tpu_torch/ops/kernels.py, which also holds the plain PyTorch
// version (btd_sweep_reference) and the launch plan (sweep_plan, a copy of
// make_plan in cluster.cuh that the CPU tests read).
//
// No TPU kernel is replaced: the JAX package runs the sweeps as lax.scan
// (vf_fem_tpu/solvers/btd.py:298-312), which XLA compiles into one loop.
//
// Rounding is the plain version's: the carried vector is cast to the
// factor type (f64 -> bf16 through f32, as torch's .to() rounds), the
// products accumulate in f32 for bf16 factors (in the factor type
// otherwise), and the sum is cast back to the vector type before the
// subtraction, which is rounded on its own (__dsub_rn / __fsub_rn, never
// contracted into an FMA).  Each row's dot product is summed inside one
// warp in a fixed order: lane l takes the 16-byte chunks l + 32 c of the
// row and sums along them (c, then the entries of a chunk, by FMA), then
// an xor-shuffle tree from 16 to 1 adds the lanes.  That order is the one
// of the single-CTA kernel this one replaces, so the two are bit-equal,
// and both differ from the plain matvec only within the bound on
// dot-product order (ops.dot_order_bound).
//
// What bounds it: the factors do not depend on the carried vector, so
// their bytes (93 x 256 x 256 at 23.7k dofs: 12.2 MB in bf16, 48.8 MB in
// f64; 3.6 / 14.6 us at 3.35 TB/s) can stream ahead of the recurrence;
// only the Bt-entry carried vector is serial, and each row block costs at
// least one exchange of it between the SMs that share the work.
//
// Design: one thread-block cluster of C CTAs (16 for f64 factors, 8
// otherwise, on neighbouring SMs) per sweep, launched with
// cudaLaunchKernelEx.
// - CTA r owns rows [r R, (r+1) R) of every A_i (R = Bt / C): a
//   contiguous slice of A_i.  Its producer warp streams the slices, in
//   stages of RS rows, through a ring of shared-memory slots with 1-D
//   cp.async.bulk copies completed on "full" mbarriers; the consumer warps
//   release each slot on its "empty" mbarrier.  The ring holds as many
//   stages as fit in 227 KB, so the factor stream runs ahead of the chain
//   and no factor load sits on it.
// - Each consumer warp takes RPW rows of each stage (RPW x sizeof(factor)
//   is a whole 32-bit word) against x_{i-1}, which every CTA holds in its
//   own shared memory in the factor type.  Lane p < C then pushes
//   the warp's entries of x_i into CTA p with st.async, whose bytes count
//   on CTA p's mbarrier for that buffer (Bt x sizeof(factor) bytes a
//   phase), so no cluster-scope fence sits on the chain: a CTA starts row
//   block i + 1 when all Bt entries of x_i have landed in it.
// - The carried vector is double-buffered (x_i in buffer i & 1).  Why a
//   store of x_{i+1} into buffer (i+1) & 1 of a CTA can never overwrite
//   x_{i-1} while that CTA still reads it: a CTA computes x_{i+1} only
//   after all of x_i has reached it, and every warp of every CTA pushes
//   its last entries of x_i only after its own last reads of x_{i-1} in
//   row block i (its dot products, on which the pushed values depend).
//   The same chain orders the mbarrier phases: bytes of x_{i+1} reach a
//   CTA only after its phase of x_{i-1} on that buffer has completed
//   (bytes that come before the CTA arms the phase leave its transaction
//   count negative until it does).
// - The last row block pushes nothing, so after its wait for x_{n-2} no
//   store is in flight into a CTA; a final cluster barrier keeps every CTA
//   resident until all are done.
// A refused launch (no room for the cluster, the shared memory, or a
// cluster size other than make_plan's) returns its error: there is no
// fallback.  btd_exchange_probe.cu times the exchange alone.

#include "cluster.cuh"

namespace {

using namespace vf_btd;

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

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename TA, typename TV, int BT>
__global__ void __launch_bounds__(Geometry<TA, BT>::THREADS, 1)
    btd_sweep_kernel(const TA* __restrict__ A, const TV* __restrict__ g,
                     TV* __restrict__ out, int n, int reverse) {
  using G = Geometry<TA, BT>;
  using AccT = typename Acc<TA>::type;
  constexpr int VEC = 16 / sizeof(TA);  // entries per 16-byte chunk
  constexpr int CPR = BT / VEC;         // chunks per row
  constexpr int CPL = (CPR + 31) / 32;  // chunks per lane per row
  constexpr long long kBlock = static_cast<long long>(BT) * BT;

  extern __shared__ __align__(128) unsigned char smem[];
  TA* ring = reinterpret_cast<TA*>(smem);                   // NST stages
  TA* xs = reinterpret_cast<TA*>(smem + G::XS_OFFSET);      // [2][BT]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BAR_OFFSET);
  uint64_t* empty = full + G::NST;
  uint64_t* xready = empty + G::NST;  // [2]: x_i complete in xs[i & 1]

  const unsigned rank = cluster_rank();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::NST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, G::W);
    }
    // one local arrival (the arming below) and Bt entries' bytes a phase
    for (int b = 0; b < 2; ++b) mbar_init(xready + b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int k = threadIdx.x; k < 2 * BT; k += G::THREADS) xs[k] = to_factor<TA, TV>(TV(0));
  // every CTA's barriers and buffers are ready before any peer touches them
  cluster_sync_all();

  if (warp == G::W) {
    // producer: stage t holds rows [rank R + sub RS, + RS) of row block s
    if (lane == 0) {
      const int total = n * G::SPB;
      for (int t = 0; t < total; ++t) {
        const int st = t % G::NST;
        if (t >= G::NST) mbar_wait<false>(empty + st, ((t / G::NST) - 1) & 1);
        const int s = t / G::SPB;
        const int sub = t - s * G::SPB;
        const int i = reverse ? n - 1 - s : s;
        const TA* src = A + i * kBlock +
                        static_cast<long long>(rank * G::R + sub * G::RS) * BT;
        mbar_arrive_expect_tx(full + st, G::STAGE_BYTES);
        bulk_load(ring + st * G::RS * BT, src, G::STAGE_BYTES, full + st);
      }
    }
    __syncwarp();
  } else {
    for (int s = 0; s < n; ++s) {
      const int i = reverse ? n - 1 - s : s;
      const int rb = s & 1;  // x_i goes to xs[rb]; x_{i-1} is in xs[rb ^ 1]
      const bool push = s + 1 < n;
      // arm xready[rb] for x_i: its phase for x_{i-2} completed before this
      // thread's wait in the previous row block; peers' bytes may land first
      if (push && threadIdx.x == 0)
        mbar_arrive_expect_tx(xready + rb, BT * static_cast<unsigned>(sizeof(TA)));
      // g of this warp's rows, loaded before the wait (off the chain)
      TV gv[G::SPB][G::RPW];
      const TV* gi = g + static_cast<long long>(i) * BT;
#pragma unroll
      for (int sub = 0; sub < G::SPB; ++sub)
#pragma unroll
        for (int u = 0; u < G::RPW; ++u)
          gv[sub][u] = gi[rank * G::R + sub * G::RS + warp * G::RPW + u];
      if (s > 0) mbar_wait<true>(xready + (rb ^ 1), ((s - 1) >> 1) & 1);
      const uint4* x4 = reinterpret_cast<const uint4*>(xs + (rb ^ 1) * BT);

#pragma unroll
      for (int sub = 0; sub < G::SPB; ++sub) {
        const int t = s * G::SPB + sub;
        const int st = t % G::NST;
        mbar_wait<false>(full + st, (t / G::NST) & 1);
        const TA* rows = ring + (st * G::RS + warp * G::RPW) * BT;
        AccT acc[G::RPW];
#pragma unroll
        for (int u = 0; u < G::RPW; ++u) {
          const uint4* row = reinterpret_cast<const uint4*>(rows + u * BT);
          acc[u] = AccT(0);
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const int ch = lane + 32 * c;
            if (ch < CPR) {
              const uint4 a4 = row[ch];
              const uint4 xv4 = x4[ch];
              const TA* av = reinterpret_cast<const TA*>(&a4);
              const TA* xv = reinterpret_cast<const TA*>(&xv4);
#pragma unroll
              for (int v = 0; v < VEC; ++v)
                acc[u] = fma_rn(to_acc(av[v]), to_acc(xv[v]), acc[u]);
            }
          }
        }
        // the xor tree leaves every row's sum in every lane
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
          for (int u = 0; u < G::RPW; ++u)
            acc[u] = acc[u] + __shfl_xor_sync(0xffffffffu, acc[u], off);
        if (lane == 0) mbar_arrive(empty + st);  // the slot has been read

        const int k0 = rank * G::R + sub * G::RS + warp * G::RPW;
        TV y[G::RPW];
        TA yf[G::RPW];
#pragma unroll
        for (int u = 0; u < G::RPW; ++u) {
          y[u] = sub_rn(gv[sub][u], static_cast<TV>(acc[u]));
          yf[u] = to_factor<TA, TV>(y[u]);
          if (lane == u) out[static_cast<long long>(i) * BT + k0 + u] = y[u];
        }
        if (push) {
          uint32_t w[G::WORDS];
          to_words<G::RPW>(yf, w);
          push_words<G::C, G::WORDS, false>(w, xs + rb * BT + k0, xready + rb, lane);
        }
      }
    }
  }
  // no CTA leaves while a peer may still read from or write into the cluster
  cluster_sync_all();
}

template <typename TA, typename TV, int BT>
int launch_sweep_bt(const void* A, const void* g, void* out, int n, int reverse,
                    int cluster, void* stream) {
  using G = Geometry<TA, BT>;
  if (cluster != G::C) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = btd_sweep_kernel<TA, TV, BT>;
  static const cudaError_t attr_err = set_attributes(kernel, G::SMEM, G::C);
  if (attr_err != cudaSuccess) return static_cast<int>(attr_err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(G::THREADS, G::SMEM, G::C, stream, cfg, attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TA*>(A),
                                       static_cast<const TV*>(g), static_cast<TV*>(out),
                                       n, reverse);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TV>
int launch_sweep(const void* A, const void* g, void* out, int n, int bt,
                 int reverse, int cluster, void* stream) {
  if (n == 0) return 0;
#define VF_SWEEP_CALL(BT) \
  launch_sweep_bt<TA, TV, BT>(A, g, out, n, reverse, cluster, stream)
  VF_BT_SWITCH(VF_SWEEP_CALL)
#undef VF_SWEEP_CALL
}

// ---------------------------------------------------------------------------
// K6T, the transposed sweep of the btd adjoint solve (btd_solve_t): one
// launch runs one whole serial sweep over the stored blocks, transposed and
// shifted by one block inside the kernel,
//
//   forward  (reverse = 0):  y_i = g_i - A_{i-1}^T y_{i-1},  y_0 = g_0
//   backward (reverse = 1):  x_i = g_i - A_{i+1}^T x_{i+1},  x_{n-1} = g_{n-1}
//
// (W forward, V backward), so no transposed or shifted copy of the factors
// is made.  No TPU kernel is replaced: the JAX package runs these sweeps as
// lax.scan (vf_fem_tpu/solvers/btd.py:340-358).  The plain version is
// ops.kernels.btd_sweep_t_reference.
//
// Rounding follows K6's rule (the carried vector in the factor type, f32
// sums for bf16 factors, the sum cast to the vector type before the
// subtraction, rounded on its own).  Entry j of A^T y sums down column j:
// thread t of the CTA takes column c = t % R of the CTA's R columns and
// rows q, q + G, q + 2G, ... (q = t / R, G = THREADS / R groups), summing
// by FMA in that order; then thread c adds the G group sums in group order.
// Another order than the plain matvec's, within the bound on dot-product
// order (ops.dot_order_bound); fixed, so the result is the same run to run.
//
// What bounds it: the same bytes as K6 (each block read once) and the same
// serial chain of n row blocks with one exchange of the carried vector
// each.  Design: K6's cluster (C CTAs, 16 for f64 factors, 8 otherwise) and
// K6's exchange, unchanged: CTA r owns output entries [r R, (r+1) R) and
// pushes them into every CTA's copy of the carried vector with st.async on
// that buffer's mbarrier.  Where K6 reads a contiguous row slice of A_i,
// CTA r reads the (Bt x R) column box of the block: lanes take adjacent
// columns, so each row's R entries are one coalesced segment.  This first
// version keeps the box in registers instead of a TMA ring: each thread
// issues its loads of the next row block's box right after its dot
// products, before it waits for the next carried vector, so the loads run
// under the exchange.  A CTA is R G threads (G the most row groups, a power
// of two, up to 512 threads: 512 at Bt = 256); the group sums meet in
// shared memory after one __syncthreads a row block.
//
// Why the partial sums can be reused without a second barrier: a thread
// writes row block s + 1's partial sum only after the wait for all of x_s,
// which needs this CTA's own entries of x_s, pushed by the threads that
// read row block s's partial sums after reading them.  The double-buffered
// carried vector is safe by K6's argument: a peer's entries of x_{s+1}
// come after it received this CTA's entries of x_s, which are pushed after
// the __syncthreads that follows every read of x_{s-1} here.

// the most row groups, a power of two, with at most 512 threads a CTA
__host__ __device__ constexpr int t_groups(int r) {
  int g = 1;
  while (2 * g * r <= 512) g *= 2;
  return g;
}

template <typename TA, int BT>
struct TGeometry {
  static constexpr int ES = static_cast<int>(sizeof(TA));
  static constexpr int C = cluster_size(ES);
  static constexpr int R = BT / C;          // output entries a CTA
  static constexpr int G = t_groups(R);     // row groups
  static constexpr int THREADS = R * G;
  static constexpr int RPT = BT / G;        // rows of a box a thread
  static_assert(BT % C == 0 && BT % G == 0 && THREADS % 32 == 0, "no partition");
  static_assert(R % 2 == 0, "output entries are pushed in pairs");
};

template <typename TA, typename TV, int BT>
__global__ void __launch_bounds__(TGeometry<TA, BT>::THREADS, 1)
    btd_sweep_t_kernel(const TA* __restrict__ A, const TV* __restrict__ g,
                       TV* __restrict__ out, int n, int reverse) {
  using G = TGeometry<TA, BT>;
  using AccT = typename Acc<TA>::type;
  constexpr long long kBlock = static_cast<long long>(BT) * BT;

  __shared__ __align__(16) unsigned char xs_bytes[2 * BT * sizeof(TA)];
  __shared__ __align__(16) AccT part[G::THREADS];   // group sums, [group][column]
  __shared__ __align__(8) uint64_t xready[2];
  TA* xs = reinterpret_cast<TA*>(xs_bytes);         // x_i in xs[(s & 1) * BT]

  const unsigned rank = cluster_rank();
  const int t = threadIdx.x;
  const int c = t % G::R;
  const int q = t / G::R;
  const int col = static_cast<int>(rank) * G::R + c;  // this thread's column
  if (t == 0) {
    for (int b = 0; b < 2; ++b) mbar_init(xready + b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync_all();

  // the box of step s: block s - 1 (forward) or n - s (backward)
  TA a[G::RPT];
  auto load_box = [&](int s) {
    const TA* blk = A + static_cast<long long>(reverse ? n - s : s - 1) * kBlock;
#pragma unroll
    for (int m = 0; m < G::RPT; ++m)
      a[m] = blk[static_cast<long long>(q + m * G::G) * BT + col];
  };
  if (n > 1) load_box(1);

  // the lanes of this thread's warp that own output entries (t < R)
  const int owners = G::R - 32 * (t >> 5);
  const unsigned mask = owners >= 32 ? 0xffffffffu : ((1u << (owners & 31)) - 1u);
  for (int s = 0; s < n; ++s) {
    const int i = reverse ? n - 1 - s : s;
    const int rb = s & 1;
    const bool push = s + 1 < n;
    if (push && t == 0)
      mbar_arrive_expect_tx(xready + rb, BT * static_cast<unsigned>(sizeof(TA)));
    TV gv = TV(0);
    if (t < G::R) gv = g[static_cast<long long>(i) * BT + col];
    AccT sum = AccT(0);
    if (s > 0) {
      mbar_wait<true>(xready + (rb ^ 1), ((s - 1) >> 1) & 1);
      const TA* x = xs + (rb ^ 1) * BT;
      AccT acc = AccT(0);
#pragma unroll
      for (int m = 0; m < G::RPT; ++m)
        acc = fma_rn(to_acc(a[m]), to_acc(x[q + m * G::G]), acc);
      if (push) load_box(s + 1);  // under the exchange of x_s
      part[t] = acc;
      __syncthreads();
      if (t < G::R) {
        sum = part[c];
        for (int k = 1; k < G::G; ++k) sum = sum + part[k * G::R + c];
      }
    }
    if (t < G::R) {
      const TV y = s > 0 ? sub_rn(gv, static_cast<TV>(sum)) : gv;
      out[static_cast<long long>(i) * BT + col] = y;
      if (push) {
        const TA yf = to_factor<TA, TV>(y);
        const unsigned dst = smem_addr(xs + rb * BT + col);
        const unsigned bar = smem_addr(xready + rb);
        if constexpr (G::ES == 2) {
          const unsigned bits = __bfloat16_as_ushort(yf);
          const unsigned next = __shfl_down_sync(mask, bits, 1);
          if ((c & 1) == 0) {
            const uint32_t w = bits | (next << 16);
            for (int p = 0; p < G::C; ++p)
              st_async_word(map_rank(dst, p), w, map_rank(bar, p));
          }
        } else {
          uint32_t w[G::ES / 4];
          to_words<1>(&yf, w);
          for (int p = 0; p < G::C; ++p) {
            const unsigned d = map_rank(dst, p);
            const unsigned b = map_rank(bar, p);
#pragma unroll
            for (int j = 0; j < G::ES / 4; ++j) st_async_word(d + 4 * j, w[j], b);
          }
        }
      }
    }
  }
  // no CTA leaves while a peer may still write into it
  cluster_sync_all();
}

template <typename TA, typename TV, int BT>
int launch_sweep_t_bt(const void* A, const void* g, void* out, int n, int reverse,
                      int cluster, void* stream) {
  using G = TGeometry<TA, BT>;
  if (cluster != G::C) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = btd_sweep_t_kernel<TA, TV, BT>;
  static const cudaError_t attr_err = set_attributes(kernel, 0, G::C);
  if (attr_err != cudaSuccess) return static_cast<int>(attr_err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(G::THREADS, 0, G::C, stream, cfg, attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TA*>(A),
                                       static_cast<const TV*>(g), static_cast<TV*>(out),
                                       n, reverse);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TV>
int launch_sweep_t(const void* A, const void* g, void* out, int n, int bt,
                   int reverse, int cluster, void* stream) {
  if (n == 0) return 0;
#define VF_SWEEP_T_CALL(BT) \
  launch_sweep_t_bt<TA, TV, BT>(A, g, out, n, reverse, cluster, stream)
  VF_BT_SWITCH(VF_SWEEP_T_CALL)
#undef VF_SWEEP_T_CALL
}

}  // namespace

// Each entry point returns the cudaError_t of its launch (0 on success).
// Suffix: factor type, vector type.  `cluster` is the launch plan's
// (ops.kernels.sweep_plan); any other is refused.
extern "C" {

#define VF_SWEEP_ENTRY(NAME, TA, TV)                                          \
  int NAME(const void* A, const void* g, void* out, int n, int bt, int reverse, \
           int cluster, void* stream) {                                         \
    return launch_sweep<TA, TV>(A, g, out, n, bt, reverse, cluster, stream);    \
  }

VF_SWEEP_ENTRY(vf_btd_sweep_bf16_f64, __nv_bfloat16, double)
VF_SWEEP_ENTRY(vf_btd_sweep_bf16_f32, __nv_bfloat16, float)
VF_SWEEP_ENTRY(vf_btd_sweep_f64_f64, double, double)
VF_SWEEP_ENTRY(vf_btd_sweep_f32_f32, float, float)

#undef VF_SWEEP_ENTRY

// K6T: the same arguments as K6's entry points
#define VF_SWEEP_T_ENTRY(NAME, TA, TV)                                          \
  int NAME(const void* A, const void* g, void* out, int n, int bt, int reverse, \
           int cluster, void* stream) {                                         \
    return launch_sweep_t<TA, TV>(A, g, out, n, bt, reverse, cluster, stream);  \
  }

VF_SWEEP_T_ENTRY(vf_btd_sweep_t_bf16_f64, __nv_bfloat16, double)
VF_SWEEP_T_ENTRY(vf_btd_sweep_t_bf16_f32, __nv_bfloat16, float)
VF_SWEEP_T_ENTRY(vf_btd_sweep_t_f64_f64, double, double)
VF_SWEEP_T_ENTRY(vf_btd_sweep_t_f32_f32, float, float)

#undef VF_SWEEP_T_ENTRY

// make_plan(es, bt) into out[0 .. 9) in the order of its fields, for the
// comparison with ops.kernels.sweep_plan; refuses a width or element size
// the sweep is not built for
int vf_btd_sweep_plan(int es, int bt, int* out) {
  if ((es != 2 && es != 4 && es != 8) ||
      (bt != 128 && bt != 256 && bt != 384 && bt != 512))
    return static_cast<int>(cudaErrorInvalidValue);
  const vf_btd::Plan p = vf_btd::make_plan(es, bt);
  const int v[9] = {p.cluster, p.rows_per_cta, p.rows_per_warp, p.warps, p.stage_rows,
                    p.stages_per_block, p.ring, p.smem, p.threads};
  for (int k = 0; k < 9; ++k) out[k] = v[k];
  return 0;
}

}  // extern "C"
