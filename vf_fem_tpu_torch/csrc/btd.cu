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
// least one exchange of it between the SMs that share the work.  At the
// 3D width (36 x 1280 x 1280 at 45.8k dofs: 118 MB in bf16, 472 MB in f64;
// 35 / 141 us) the bytes, not the chain, set the bound, and one cluster's
// SMs share the whole stream.
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
//   and no factor load sits on it; where a stage of one row a warp for
//   16 warps would leave a single slot (f64 factors at Bt = 1280), the
//   plan takes fewer warps, so smaller stages, and keeps two.
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

#include <cuda.h>

#include <mutex>

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
// (W forward, V backward).  No TPU kernel is replaced: the JAX package runs
// these sweeps as lax.scan (vf_fem_tpu/solvers/btd.py:340-358).  The plain
// version is ops.kernels.btd_sweep_t_reference.
//
// What bounds it: K6's bytes (each block read once; 12.2 MB of bf16 factors
// at 23.7k dofs, 3.6 us at 3.35 TB/s) and K6's serial chain of n row blocks
// with one exchange of the carried vector each (0.30 us a bf16 row block on
// an H100 alone, btd_exchange_probe.cu), which no design removes.  So the
// factors stream ahead of the chain, and between the wait for x_{s-1} and
// the push of x_s a thread does only its FMAs, a few shuffles and the push.
//
// Design: K6's cluster (C CTAs, 16 for f64 factors, 8 otherwise) and K6's
// exchange, unchanged.  CTA r owns output entries [r R, (r+1) R), so it reads
// the (Bt x R) column box [., r R : (r+1) R) of each block: R ES bytes of
// every row (ES the factor size), cut into 16-byte chunks of VEC = 16 / ES
// columns.
// - A producer warp streams the boxes, in stages of SR rows (<= 256),
//   through a ring of shared-memory slots on "full" / "empty" mbarriers, as
//   K6 does, by TMA: the factors are one 2-D tensor map (n Bt rows of Bt,
//   cuTensorMapEncodeTiled looked up by cudaGetDriverEntryPoint, passed as
//   a __grid_constant__ parameter and encoded once per factors and width),
//   whose boxes are SWB bytes of SR rows, SWB the widest of 128, 64 and 32
//   that divides a box row (one box a stage at Bt = 256), swizzled over
//   SWB (chunk j of row k lands at j ^ (bits 7.. of k SWB)), so the 8 lanes
//   of a quarter warp reading one chunk of 8 consecutive rows hit 8
//   different bank groups.  The ring holds as many stages as fit in 227 KB
//   (make_t_plan; ops.sweep_t_plan).
// - Consumer warp w owns chunk w, VEC columns.  Lane l takes rows l, l + 32,
//   ... of each stage: it loads them from the slot into registers (converted
//   to the accumulation type) and releases the slot before the wait for
//   x_{s-1}, so no factor load sits on the chain.  After the wait it sums
//   its rows by FMA in row order, one sum a column, then the warp adds its
//   lanes: a reduce-scatter over lane bits 16, 8, ... (each level halves the
//   columns a lane keeps) and an xor tree over the bits left, so column c of
//   the chunk ends in lanes [c, c + 1) * 32 / VEC.  A column's sum never
//   leaves its warp: no block barrier and no serial sum on the chain.
// - The warp's four 32-bit words of x_s (its 16-byte chunk in the factor
//   type) are gathered by shuffles so that lane l holds word l & 3 and
//   pushes it with st.async into CTAs l / 4 (+ 8), counted on that CTA's
//   mbarrier for the buffer (Bt ES bytes a phase).
// - Rounding is K6's rule: the carried vector in the factor type, f32 sums
//   for bf16 factors, the sum cast to the vector type before the
//   subtraction, rounded on its own.  The order (rows within a lane, then
//   the fixed lane tree) differs from the plain matvec's only within the
//   bound on dot-product order (ops.dot_order_bound), and is the same every
//   launch.
//
// Why a push never overwrites a carried vector still being read: the
// double-buffered x_{s+1} goes to buffer (s + 1) & 1, which holds x_{s-1}.
// A CTA computes x_{s+1} only after all of x_s has reached it, and every
// warp of every CTA pushes its entries of x_s only after its own reads of
// x_{s-1} (its FMAs, on which the pushed values depend).  The mbarrier
// phases follow by K6's argument: thread 0 arms buffer s & 1 for x_s at the
// start of row block s, after its own wait for x_{s-2} on that buffer, and
// bytes of x_s reach a CTA only after that CTA's phase for x_{s-2} has
// completed (bytes that come before the arming leave the transaction count
// negative until it).  The last row block pushes nothing; a final cluster
// barrier keeps every CTA resident until all are done.
//
// Measured on an H100 (PERF.md section 6; kernel_turns.py), 93 row blocks
// of 256: 0.056 ms with bf16 factors and 0.076 ms with f64, against 0.082
// and 0.110 ms for the kernel this one replaced (the box in registers, a
// 512-thread __syncthreads and a serial 16-term shared-memory sum each row
// block).  Two producers measured slower while this design was tried: 1-D
// cp.async.bulk copies of each box row (one copy an instruction; they kept
// the ring empty, an order of magnitude slower) and unswizzled boxes one
// 16-byte chunk wide (as fast with bf16 factors, slower with f32 and f64,
// whose stages have twice the bytes, as if the TMA spent about the same
// time on a box row whatever its width).
//
// Not taken: a transposed and shifted copy of V and W made by btd_factor, so
// that K6 itself could run the adjoint sweeps.  It would add 2 x 12.2 MB of
// bf16 at 23.7k dofs (4x that at 94.8k) to every run with gradients and
// change btd_factor, for a kernel whose chain, not its bytes, sets its time.

// K6T's launch plan for one (factor element size, Bt); mirrored by
// ops.kernels.sweep_t_plan (vf_btd_sweep_t_plan returns it)
struct TPlan {
  int cluster;           // C CTAs (cluster_size, as K6)
  int cols_per_cta;      // R = Bt / C output entries a CTA
  int warps;             // W consumer warps: the 16-byte chunks of R entries
  int stage_rows;        // SR box rows a ring slot (<= 256)
  int stages_per_block;  // SPB = Bt / SR
  int box_bytes;         // the inner width of a tensor-map box (its swizzle span)
  int ring;              // slots
  int smem;              // dynamic shared memory bytes
  int threads;           // (W + 1) * 32
};

__host__ __device__ constexpr TPlan make_t_plan(int es, int bt) {
  TPlan p{};
  p.cluster = cluster_size(es);
  p.cols_per_cta = bt / p.cluster;
  const int row_bytes = p.cols_per_cta * es;
  p.warps = row_bytes / 16;
  p.stage_rows = bt <= 256 ? bt : bt / 2;
  p.stages_per_block = bt / p.stage_rows;
  p.box_bytes = row_bytes % 128 == 0 ? 128 : row_bytes % 64 == 0 ? 64 : 32;
  const int stage_bytes = p.stage_rows * row_bytes;
  const int room = (kSmemLimit - 1024 - 2 * bt * es - kBarBytes) / stage_bytes;
  p.ring = room < kMaxStages ? room : kMaxStages;
  p.smem = 1024 + p.ring * stage_bytes + 2 * bt * es + kBarBytes;
  p.threads = (p.warps + 1) * 32;
  return p;
}

template <typename TA, int BT>
struct TGeometry {
  static constexpr int ES = static_cast<int>(sizeof(TA));
  static constexpr TPlan P = make_t_plan(ES, BT);
  static constexpr int C = P.cluster;
  static constexpr int R = P.cols_per_cta;
  static constexpr int W = P.warps;
  static constexpr int SR = P.stage_rows;
  static constexpr int SPB = P.stages_per_block;
  static constexpr int SWB = P.box_bytes;
  static constexpr int NST = P.ring;
  static constexpr int SMEM = P.smem;
  static constexpr int THREADS = P.threads;
  static constexpr int RB = R * ES;            // bytes of a box row
  static constexpr int BOXES = RB / SWB;       // tensor-map boxes a stage
  static constexpr int CPB = SWB / 16;         // 16-byte chunks a box row
  static constexpr int VEC = 16 / ES;          // columns a warp owns
  static constexpr int LV = VEC == 8 ? 3 : VEC == 4 ? 2 : 1;  // log2(VEC)
  static constexpr int RPL = SR / 32;          // rows a lane takes a stage
  static constexpr int STAGE_BYTES = SR * RB;
  static constexpr int XS_OFFSET = NST * STAGE_BYTES;
  static constexpr int BAR_OFFSET = XS_OFFSET + 2 * BT * ES;
  static_assert(C * R == BT && W * 16 == RB && SPB * SR == BT && SR % 32 == 0 && SR <= 256,
                "no partition");
  static_assert(RB % SWB == 0 && SR * SWB % 1024 == 0 && BOXES <= 32, "no box layout");
  static_assert(C == 8 || C == 16, "four words of a warp pushed into C CTAs by 32 lanes");
  static_assert(NST >= 2 && SMEM <= kSmemLimit, "ring does not fit");

  // byte offset of chunk w of box row k in a slot: box w / CPB holds SR rows
  // of SWB bytes, chunk j = w % CPB of row k at j ^ (bits 7.. of k SWB),
  // the TMA's swizzle of that span
  __device__ static int offset(int k, int w) {
    const int j = w % CPB;
    return (w / CPB) * SR * SWB + k * SWB + 16 * (j ^ ((k * SWB >> 7) & (CPB - 1)));
  }
};

// one box of the 2-D tensor map: columns [c0, c0 + SWB / ES), rows [r0, r0 + SR)
__device__ __forceinline__ void tensor_load(void* dst, const CUtensorMap* map, int c0,
                                            int r0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(smem_addr(bar))
      : "memory");
}

// The sum of v[c] over the warp's 32 lanes for the column c = lane >> (5 -
// LV) this lane ends with (every lane of the column's group holds it): a
// reduce-scatter over lane bits 16, 8, ... (LV levels), then an xor tree
// over the 5 - LV bits left.
template <int VEC, int LV, typename T>
__device__ __forceinline__ T warp_column_sum(T (&v)[VEC], int lane) {
#pragma unroll
  for (int lev = 0; lev < LV; ++lev) {
    const int h = VEC >> (lev + 1);
    const int d = 16 >> lev;
    const bool up = (lane & d) != 0;
#pragma unroll
    for (int q = 0; q < h; ++q) {
      const T keep = up ? v[q + h] : v[q];
      const T send = up ? v[q] : v[q + h];
      v[q] = keep + __shfl_xor_sync(0xffffffffu, send, d);
    }
  }
  T r = v[0];
#pragma unroll
  for (int d = 16 >> LV; d > 0; d >>= 1) r = r + __shfl_xor_sync(0xffffffffu, r, d);
  return r;
}

// word m (0..3) of the warp's 16-byte chunk of x_s in the factor type, from
// the lanes that hold its columns (word m of bf16 is columns 2m, 2m + 1; of
// f32 column m; of f64 half m & 1 of column m / 2)
__device__ __forceinline__ uint32_t chunk_word(__nv_bfloat16 y, int m) {
  const unsigned b = __bfloat16_as_ushort(y);
  const unsigned lo = __shfl_sync(0xffffffffu, b, 8 * m);
  const unsigned hi = __shfl_sync(0xffffffffu, b, 8 * m + 4);
  return lo | (hi << 16);
}
__device__ __forceinline__ uint32_t chunk_word(float y, int m) {
  return __shfl_sync(0xffffffffu, __float_as_uint(y), 8 * m);
}
__device__ __forceinline__ uint32_t chunk_word(double y, int m) {
  const unsigned lo = __shfl_sync(0xffffffffu, static_cast<unsigned>(__double2loint(y)),
                                  16 * (m >> 1));
  const unsigned hi = __shfl_sync(0xffffffffu, static_cast<unsigned>(__double2hiint(y)),
                                  16 * (m >> 1));
  return (m & 1) ? hi : lo;
}

template <typename TA, typename TV, int BT>
__global__ void __launch_bounds__(TGeometry<TA, BT>::THREADS, 1)
    btd_sweep_t_kernel(const __grid_constant__ CUtensorMap map, const TV* __restrict__ g,
                       TV* __restrict__ out, int n, int reverse) {
  using G = TGeometry<TA, BT>;
  using AccT = typename Acc<TA>::type;
  constexpr int VEC = G::VEC;

  // the ring's boxes at a 1024-byte boundary (the swizzle's period)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* ring = smem;                            // NST stages
  TA* xs = reinterpret_cast<TA*>(smem + G::XS_OFFSET);   // [2][BT]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BAR_OFFSET);
  uint64_t* empty = full + G::NST;
  uint64_t* xready = empty + G::NST;  // [2]: x_s complete in xs[s & 1]

  const unsigned rank = cluster_rank();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::NST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, G::W);
    }
    for (int b = 0; b < 2; ++b) mbar_init(xready + b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA's barriers are ready before any peer pushes into them
  cluster_sync_all();

  if (warp == G::W) {
    // producer: stage t holds box rows [sub SR, + SR) of row block s = t /
    // SPB + 1, whose block is s - 1 (forward) or n - s (backward)
    const int total = (n - 1) * G::SPB;
    for (int t = 0; t < total; ++t) {
      const int st = t % G::NST;
      if (lane == 0) {
        if (t >= G::NST) mbar_wait<false>(empty + st, ((t / G::NST) - 1) & 1);
        mbar_arrive_expect_tx(full + st, G::SR * G::RB);
      }
      __syncwarp();
      const int s = t / G::SPB + 1;
      const int sub = t - (s - 1) * G::SPB;
      const long long row0 = static_cast<long long>(reverse ? n - s : s - 1) * BT + sub * G::SR;
      unsigned char* slot = ring + st * G::STAGE_BYTES;
      if (lane < G::BOXES)
        tensor_load(slot + lane * G::SR * G::SWB, &map,
                    static_cast<int>(rank) * G::R + lane * (G::SWB / G::ES),
                    static_cast<int>(row0), full + st);
    }
    __syncwarp();
  } else {
    const int colw = static_cast<int>(rank) * G::R + warp * VEC;  // the warp's first column
    const int col = colw + (lane >> (5 - G::LV));                  // this lane's column
    const bool writer = (lane & ((32 >> G::LV) - 1)) == 0;
    for (int s = 0; s < n; ++s) {
      const int i = reverse ? n - 1 - s : s;
      const int rb = s & 1;  // x_s goes to xs[rb]; x_{s-1} is in xs[rb ^ 1]
      const bool push = s + 1 < n;
      if (push && threadIdx.x == 0)
        mbar_arrive_expect_tx(xready + rb, BT * static_cast<unsigned>(sizeof(TA)));
      const TV gv = g[static_cast<long long>(i) * BT + col];  // before the wait
      TV y = gv;
      if (s > 0) {
        // this lane's rows of the box, from the ring, before the wait
        AccT a[G::SPB][G::RPL][VEC];
#pragma unroll
        for (int sub = 0; sub < G::SPB; ++sub) {
          const int t = (s - 1) * G::SPB + sub;
          const int st = t % G::NST;
          mbar_wait<false>(full + st, (t / G::NST) & 1);
          const unsigned char* slot = ring + st * G::STAGE_BYTES;
#pragma unroll
          for (int j = 0; j < G::RPL; ++j) {
            const int k = lane + 32 * j;
            const uint4 q = *reinterpret_cast<const uint4*>(slot + G::offset(k, warp));
            const TA* av = reinterpret_cast<const TA*>(&q);
#pragma unroll
            for (int v = 0; v < VEC; ++v) a[sub][j][v] = to_acc(av[v]);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + st);  // the slot has been read
        }
        mbar_wait<true>(xready + (rb ^ 1), ((s - 1) >> 1) & 1);
        const TA* x = xs + (rb ^ 1) * BT;
        AccT acc[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = AccT(0);
#pragma unroll
        for (int sub = 0; sub < G::SPB; ++sub)
#pragma unroll
          for (int j = 0; j < G::RPL; ++j) {
            const AccT xk = to_acc(x[sub * G::SR + lane + 32 * j]);
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[v] = fma_rn(a[sub][j][v], xk, acc[v]);
          }
        y = sub_rn(gv, static_cast<TV>(warp_column_sum<VEC, G::LV>(acc, lane)));
      }
      if (writer) out[static_cast<long long>(i) * BT + col] = y;
      if (push) {
        const int m = lane & 3;  // lane l pushes word l & 3 into CTAs l / 4 (+ 8)
        const uint32_t w = chunk_word(to_factor<TA, TV>(y), m);
        const unsigned dst = smem_addr(xs + rb * BT + colw) + 4 * m;
        const unsigned bar = smem_addr(xready + rb);
#pragma unroll
        for (int p = lane >> 2; p < G::C; p += 8)
          st_async_word(map_rank(dst, p), w, map_rank(bar, p));
      }
    }
  }
  // no CTA leaves while a peer may still write into it
  cluster_sync_all();
}

// cuTensorMapEncodeTiled, looked up at run time (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

template <typename TA>
constexpr CUtensorMapDataType map_type() {
  return sizeof(TA) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                         : sizeof(TA) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT64;
}

// The factors (n Bt rows of Bt) as a 2-D tensor map with boxes of SWB
// bytes by SR rows, swizzled over SWB, encoded once per (address, n, Bt,
// type) and kept: the map depends on nothing else, and btd_solve_t
// launches K6T on the same factors many times.  A refused encoding
// returns cudaErrorInvalidValue.
template <typename TA, int BT>
int tensor_map(const void* A, int n, CUtensorMap* out) {
  using G = TGeometry<TA, BT>;
  struct Entry {
    const void* ptr;
    int n, bt, es;
    CUtensorMap map;
  };
  constexpr int kEntries = 16;
  static std::mutex mu;
  static Entry cache[kEntries] = {};
  static int next = 0;
  static EncodeTiled encode = nullptr;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.ptr == A && e.n == n && e.bt == BT && e.es == G::ES) {
      *out = e.map;
      return 0;
    }
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(err != cudaSuccess ? err : cudaErrorSymbolNotFound);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(BT), static_cast<cuuint64_t>(n) * BT};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(BT) * G::ES};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(G::SWB / G::ES),
                             static_cast<cuuint32_t>(G::SR)};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swizzle = G::SWB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : G::SWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  Entry& e = cache[next];
  const CUresult res = encode(&e.map, map_type<TA>(), 2, const_cast<void*>(A), dims, strides,
                              box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) {
    e.ptr = nullptr;
    return static_cast<int>(cudaErrorInvalidValue);
  }
  e.ptr = A;
  e.n = n;
  e.bt = BT;
  e.es = G::ES;
  next = (next + 1) % kEntries;
  *out = e.map;
  return 0;
}

template <typename TA, typename TV, int BT>
int launch_sweep_t_bt(const void* A, const void* g, void* out, int n, int reverse,
                      int cluster, void* stream) {
  using G = TGeometry<TA, BT>;
  if (cluster != G::C) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = btd_sweep_t_kernel<TA, TV, BT>;
  static const cudaError_t attr_err = set_attributes(kernel, G::SMEM, G::C);
  if (attr_err != cudaSuccess) return static_cast<int>(attr_err);
  CUtensorMap map{};  // n = 1 reads no block
  if (n > 1) {
    const int err = tensor_map<TA, BT>(A, n, &map);
    if (err != 0) return err;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(G::THREADS, G::SMEM, G::C, stream, cfg, attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, map, static_cast<const TV*>(g),
                                       static_cast<TV*>(out), n, reverse);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TV>
int launch_sweep_t(const void* A, const void* g, void* out, int n, int bt,
                   int reverse, int cluster, void* stream) {
  if (n == 0) return 0;
#define VF_SWEEP_T_CALL(BT) \
  launch_sweep_t_bt<TA, TV, BT>(A, g, out, n, reverse, cluster, stream)
  VF_BT_T_SWITCH(VF_SWEEP_T_CALL)
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
      (bt != 128 && bt != 256 && bt != 384 && bt != 512 && bt != 1280))
    return static_cast<int>(cudaErrorInvalidValue);
  const vf_btd::Plan p = vf_btd::make_plan(es, bt);
  const int v[9] = {p.cluster, p.rows_per_cta, p.rows_per_warp, p.warps, p.stage_rows,
                    p.stages_per_block, p.ring, p.smem, p.threads};
  for (int k = 0; k < 9; ++k) out[k] = v[k];
  return 0;
}

// make_t_plan(es, bt) into out[0 .. 9) in the order of its fields, for the
// comparison with ops.kernels.sweep_t_plan
int vf_btd_sweep_t_plan(int es, int bt, int* out) {
  if ((es != 2 && es != 4 && es != 8) ||
      (bt != 128 && bt != 256 && bt != 384 && bt != 512))
    return static_cast<int>(cudaErrorInvalidValue);
  const TPlan p = make_t_plan(es, bt);
  const int v[9] = {p.cluster, p.cols_per_cta, p.warps, p.stage_rows, p.stages_per_block,
                    p.box_bytes, p.ring, p.smem, p.threads};
  for (int k = 0; k < 9; ++k) out[k] = v[k];
  return 0;
}

}  // extern "C"
