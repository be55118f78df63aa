// The Krylov path's kernels for Hopper (sm_90a): the element-by-element
// matvec (K3), the block-banded matvec (K4) and the fused Newmark update
// (K5).  Plain C entry points, loaded with ctypes by
// vf_fem_tpu_torch/ops/kernels.py, which also holds the plain PyTorch
// version of each.
//
// K3 replaces vf_fem_tpu/ops/pallas_kernels.py:_ebe_matvec_kernel.  The TPU
// kernel runs one batched (256 elements) small matmul on the MXU per grid
// step over element vectors gathered by its caller.  Here one thread owns
// one output (element e, row i) and reads x through the element dof map
// itself, folding in that gather: y[e, i] = sum_j J[e, i, j] x[dofs[e, j]],
// summed in j order, no atomics.  Bound: bytes.  At 23.7k dofs J is
// 23319 x 36 x 8 B = 6.7 MB in f64, a few microseconds of HBM time; the
// launch dominates.
//
// K4 replaces vf_fem_tpu/ops/pallas_kernels.py:_bsb_matvec_kernel.  The
// TPU kernel keeps the whole padded x in VMEM and streams every dense
// 128 x 128 block of the band through the MXU.  The band is almost all
// zeros: at 23.7k dofs, 326,410 of its 15,237,120 entries can be nonzero
// (2x2 vertex blocks, 1-18 a row), so streaming it (122 MB in f64) costs
// 28x the bytes the product needs.  Here the kernel reads only the plan's
// pattern (solvers/bsb.py: MatvecPattern), CSR by output row, each entry an
// int32 offset into its block row's band that gives both the value's
// address and x's column.  Bound: bytes, nnz * (sizeof(T) + 4) + (ndof + 1)
// * 4 + 2 * ndof * sizeof(T): 4.39 MB in f64 at 23.7k, 1.31 us at 3.35 TB/s.
// The values lie 16 B to a 32 B sector (a vertex block's two rows are two
// band rows apart), so the bytes the card moves are about twice that.
//
// One CTA owns 64 consecutive rows (they lie in one block row n) and stages
// x's window of that block row, columns [(n - h) * 128, (n + h + 1) * 128),
// zero outside [0, ndof), in shared memory: one cp.async.bulk (TMA 1-D) on
// an mbarrier for its 16-byte aligned part, plain loads for the rest.  A
// group of G = 4 lanes owns a row: lane l takes the row's entries l, l + G,
// l + 2G, ... (its offsets and band values are loaded into registers before
// the wait for the window), sums their products in that order, and the G
// partial sums meet in a fixed xor tree; lane 0 writes y once.  No atomics;
// every product and sum is rounded separately (_rn: no FMA contraction), so
// tests/bsb_emulation.py reproduces it bit for bit.  64 rows and 4 lanes
// with the bulk copy were the fastest of 32/64/128 rows, 4/8 lanes and the
// window by bulk copy or by plain loads on an H100 (PERF.md section 6).
//
// K5 replaces vf_fem_tpu/ops/pallas_kernels.py:_newmark_kernel and is the
// step's boundary: from u1, u0, v0, a0 one launch writes v1, a1 and the next
// step's Newmark predictor u_next = (u1 + dtp v1) + c a1 (dtp the next
// step's dt, c = dtp * dtp / 2), which SolidModel._predictor takes in place
// of four eager kernels.  Its coefficients are formed on the host in
// double, exactly as the plain version forms them, once per run as a table
// of a row a step, rounded to the working type on the device; the kernel
// takes its row's address (so a CUDA graph of the step reads each step's
// row, not the dt it was captured with) and loads it after
// griddepcontrol.wait; every product and sum is rounded separately
// (__dmul_rn / __fmul_rn and kin): no contraction to FMA, so all three
// outputs are the plain version's bit for bit.  Bound: bytes (seven
// vectors, 1.33 MB in f64 at 23.7k dofs, 0.4 us at 3.35 TB/s); the launch
// costs more than the body.  Loads and stores are 16
// bytes wide (double2 / float4) over the span where all seven vectors
// share one 16-byte phase (the wrapper allocates the outputs in u1's
// phase), with scalar entries before and after it; inputs of mixed
// phases take the scalar loop throughout.  A grid-stride loop over
// at most four CTAs an SM, 128 threads a CTA.  Launched with programmatic
// dependent launch (cudaLaunchKernelEx, programmatic stream
// serialization), which a CUDA graph captures: the kernel waits on
// griddepcontrol.wait before its first global access (it cannot know which
// of its inputs the kernel before it writes) and signals
// griddepcontrol.launch_dependents after its loads, so back-to-back
// launches overlap; that took 0.4-0.6 us off its ~1.7 us in a graph of
// 200 launches on an H100 (PERF.md section 6).

// K5T is K5's backward (no TPU kernel: the JAX package differentiates
// equations/newmark.py's relations with its step).  With V, A the
// cotangents of v1, a1 (the predictor u_next is not differentiated: the
// Newton guess it seeds carries no sensitivity), one launch writes
//   ub1 = c1 V + c4 A,  ub0 = -ub1,  vb0 = -(c2 V + dt (c4 A)),
//   ab0 = -(c3 V + c5 A)
// and the row's cotangent, six sums over the entries (sum V du, -sum V v0,
// -sum V a0, sum A (du - dt v0), -sum A a0, -sum (c4 A) v0 with du = u1 -
// u0) and two zeros.  The vector cotangents are rounded as the plain
// version (ops.kernels.newmark_update_t_reference) rounds them, _rn
// throughout, so they are its bits; the row's sums differ from its sums
// only in order.  Bound: bytes (six vectors in, four out; 1.90 MB in f64
// at 23.7k dofs, 0.57 us at 3.35 TB/s); at these sizes the launch and the
// reduction's latency cost more than the bytes.  K5's design: programmatic
// dependent launch (griddepcontrol.wait before the first global access,
// the row's included; launch_dependents after the loads), 16-byte loads
// and stores where all ten vectors share one 16-byte phase (the wrapper
// allocates the outputs in u1's), scalar entries elsewhere.  A grid-stride
// loop over at most one CTA an SM (kNewmarkTMaxCtas at most), 256 threads
// a CTA; each CTA adds its six sums by an xor tree in each warp and then
// the warps in order, writes them to its row of its slot's partial sums
// and takes a ticket from the slot's arrival counter (atom.acq_rel.gpu
// after the block barrier); the CTA that takes the last adds the rows in
// CTA order (lane l of warp j rows l, l + 32, ... of entry j, all loads
// issued before the first sum, then an xor tree), whatever the order of
// arrival, and sets the counter back to zero.  No float atomics: the row's
// cotangent, on which the gradient with respect to the step sizes rests,
// has the same bits every launch and every graph replay.
//
// A slot (a counter and kNewmarkTMaxCtas rows of partial sums in static
// device memory, zero at load and left at zero by every launch) holds one
// launch at a time.  That rests on two conditions, which ops.kernels keeps
// by giving out the slots: launches that share a slot are ordered, and
// each one's griddepcontrol.wait, before its first touch of the slot,
// waits for the one before to end.  Eager launches take the slot of their
// (device, stream); launches captured into a CUDA graph take the slot of
// their (device, stream, capture), since a graph may be replayed on any
// stream, beside eager work or other graphs, but never beside itself, and
// within one capture the launches on one stream are chained.
//
// K3T and K4T are the transposed operators of the 'cg' and 'bsb' adjoint
// solves (no TPU kernel: the JAX package transposes with XLA,
// vf_fem_tpu/fem/assembly.py:255-278 and vf_fem_tpu/solvers/bsb.py:168-188).
//
// K3T: y[e, i] = sum_j J[e, j, i] x[dofs[e, j]], K3 with the column of
// J[e] in place of its row: one thread an output (e, i), summing in j
// order, so the threads of a warp read J[e, j, i..i+5] side by side for
// each j.  Bound: bytes, as K3 (6.7 MB of J in f64 at 23.7k).
//
// K4T: y = A^T x over the band's pattern, CSR by output column
// (solvers/bsb.py: matvec_pattern_t; the diag_ones entries of the
// Dirichlet rows included).  An entry is one int32, its offset into the
// band of its source row r's block row (as K4's offsets are into the band
// of their row's), from which the column c and the offset give r itself:
// m = off / B^2 is the block column, so r's block row is c / B - m + h and
// r = (c / B - m + h) B + (off / B) % B.  So an entry costs K4's bytes,
// nnz (sizeof(T) + 4) + (ndof + 1) 4 + 2 ndof sizeof(T): 4.39 MB in f64 at
// 23.7k, 1.31 us at 3.35 TB/s.  K4's design carried to the transpose: one
// CTA owns 64 consecutive columns (they lie in one block column cb, whose
// source rows lie in block rows [cb - h, cb + h]) and stages x's window of
// those rows in shared memory as K4 stages its own (one cp.async.bulk on an
// mbarrier for the 16-byte aligned part, plain loads for the rest, zero
// outside [0, ndof)).  A group of G = 4 lanes owns a column, as in K4: lane
// l takes the column's entries l, l + G, ... (rows ascending), its first
// kBsbTRegs / G offsets and band values (every entry of a column at 23.7k
// dofs, which has 3-18) loaded into registers before the wait for the
// window, sums their products in that order, and the G partial sums meet in
// K4's fixed xor tree.  Every product and sum is rounded separately (_rn),
// from 0: no atomics, the same bits every launch, and
// tests/bsb_emulation.py:emulate_bsb_matvec_t reproduces it.  Measured on
// an H100 (PERF.md section 6; kernel_turns.py): 0.0032 ms in f64 at 23.7k
// dofs, against 0.0044 ms for the kernel this one replaced (a thread a
// column, 256 a CTA, x read from device memory, three dependent loads an
// entry).  While this design was tried, 4 lanes a column beat 2 and 1 (1
// keeps the replaced kernel's CSR order, and was hardly faster than it): a
// column's entries lie in as many band rows, so the lanes of a group read
// the offsets side by side and split the scattered value loads.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;
// threads a K5 CTA: with programmatic dependent launch, faster than 256 in
// three of four shapes on an H100 (PERF.md section 6)
constexpr int kNewmarkThreads = 128;
constexpr int kBsbB = 128;     // block size of the block-banded plan
constexpr int kBsbTile = 64;   // rows a K4 CTA
constexpr int kBsbLanes = 4;   // lanes a row (ops.kernels.BSB_LANES)
constexpr int kBsbRegs = 8;    // entries a K4 lane holds in registers a pass
constexpr int kBsbTRegs = 20;  // entries of a K4T column held in registers (1-18 at 23.7k)
constexpr int kBsbShift = 14;  // log2(kBsbB * kBsbB): an offset's block column
static_assert(1 << kBsbShift == kBsbB * kBsbB && kBsbB % kBsbTile == 0,
              "B must be 128, a CTA's rows within one block row");

template <typename T>
__global__ void ebe_matvec_kernel(const T* __restrict__ J,
                                  const T* __restrict__ x,
                                  const long long* __restrict__ dofs,
                                  T* __restrict__ y, int nld,
                                  long long total) {
  long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= total) return;
  long long e = t / nld;
  const T* row = J + t * nld;  // J[e, i, :]
  const long long* d = dofs + e * nld;
  T acc = T(0);
  for (int j = 0; j < nld; ++j) acc += row[j] * x[d[j]];
  y[t] = acc;
}

template <typename T>
__global__ void ebe_matvec_t_kernel(const T* __restrict__ J,
                                    const T* __restrict__ x,
                                    const long long* __restrict__ dofs,
                                    T* __restrict__ y, int nld,
                                    long long total) {
  long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= total) return;
  long long e = t / nld;
  const int i = static_cast<int>(t - e * nld);
  const T* col = J + e * nld * nld + i;  // J[e, :, i]
  const long long* d = dofs + e * nld;
  T acc = T(0);
  for (int j = 0; j < nld; ++j) acc += col[j * nld] * x[d[j]];
  y[t] = acc;
}

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}

__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// K4's window lands on one mbarrier, used for one phase a launch
__device__ __forceinline__ void bulk_stage(void* dst, const void* src,
                                           unsigned bytes, uint64_t* bar) {
  const unsigned b = smem_addr(bar);
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], %1;\n"
      "fence.mbarrier_init.release.cluster;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %2;\n" ::"r"(b),
      "r"(1u), "r"(bytes)
      : "memory");
  if (bytes > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(b)
        : "memory");
}

__device__ __forceinline__ void wait_first_phase(uint64_t* bar) {
  const unsigned addr = smem_addr(bar);
  unsigned ok = 0;
  while (!ok) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(addr)
        : "memory");
  }
}

// y[r] = sum over the pattern's entries k of row r (in CSR order) of
// band_n[off[k]] * x[(n + m - h) * B + q], n = r / B, m = off[k] / B^2,
// q = off[k] % B, band_n = blocks + n * nb * B^2.
template <typename T>
__global__ void __launch_bounds__(kBsbTile * kBsbLanes)
    bsb_matvec_kernel(const T* __restrict__ blocks, const T* __restrict__ x,
                      const int* __restrict__ ptr, const int* __restrict__ off,
                      T* __restrict__ y, int ndof, int nb, int h) {
  constexpr int G = kBsbLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* xw = reinterpret_cast<T*>(smem + 16);  // (nb * B,) x window
  const int r0 = blockIdx.x * kBsbTile;
  const int n = r0 / kBsbB;
  const int c0 = (n - h) * kBsbB;  // the window's first column (may be < 0)
  const int wlen = nb * kBsbB;
  const int lo = max(c0, 0);
  const int hi = min(c0 + wlen, ndof);  // columns [lo, hi) are in x
  // [lo, lo + nbulk) by one bulk copy (lo is a multiple of B, so both ends
  // are 16-byte aligned given an aligned x); the rest by loads
  constexpr int kVec = 16 / sizeof(T);
  const int nbulk = (hi - lo) / kVec * kVec;
  if (threadIdx.x == 0) bulk_stage(xw + (lo - c0), x + lo, nbulk * sizeof(T), bar);
  for (int k = threadIdx.x; k < wlen; k += blockDim.x) {
    const int c = c0 + k;
    if (c < lo || c >= lo + nbulk) xw[k] = c < hi && c >= lo ? __ldg(x + c) : T(0);
  }

  const int row = r0 + static_cast<int>(threadIdx.x) / G;
  const int lane = threadIdx.x % G;
  int k0 = 0, k1 = 0;
  if (row < ndof) {
    k0 = __ldg(ptr + row) + lane;
    k1 = __ldg(ptr + row + 1);
  }
  const T* band = blocks + static_cast<long long>(n) * nb * kBsbB * kBsbB;
  // the lane's first kBsbRegs entries: offsets, then values, in flight
  // while the window lands
  int o[kBsbRegs];
  T v[kBsbRegs];
#pragma unroll
  for (int s = 0; s < kBsbRegs; ++s)
    o[s] = k0 + s * G < k1 ? __ldg(off + k0 + s * G) : -1;
#pragma unroll
  for (int s = 0; s < kBsbRegs; ++s) v[s] = o[s] >= 0 ? __ldg(band + o[s]) : T(0);
  __syncthreads();
  wait_first_phase(bar);

  T acc = T(0);
#pragma unroll
  for (int s = 0; s < kBsbRegs; ++s)
    if (o[s] >= 0)
      acc = add_rn(acc, mul_rn(v[s], xw[(o[s] >> kBsbShift) * kBsbB + (o[s] & (kBsbB - 1))]));
  for (int k = k0 + kBsbRegs * G; k < k1; k += G) {  // rows longer than that
    const int ok = __ldg(off + k);
    acc = add_rn(acc, mul_rn(__ldg(band + ok), xw[(ok >> kBsbShift) * kBsbB + (ok & (kBsbB - 1))]));
  }
#pragma unroll
  for (int d = G / 2; d > 0; d >>= 1)
    acc = add_rn(acc, __shfl_xor_sync(0xffffffffu, acc, d, G));
  if (lane == 0 && row < ndof) y[row] = acc;
}

// y[c] = sum over the transposed pattern's entries k of column c (rows
// ascending) of band_n[off[k]] * x[n * B + (off[k] / B) % B], n = c / B -
// off[k] / B^2 + h the source row's block row, band_n = blocks + n nb B^2,
// summed in K4's order on the column's entries (G lanes, xor tree).  A
// CTA's 64 columns lie in one block column cb, so their source rows lie in
// block rows [cb - h, cb + h]: x's window is K4's, staged the same way.
template <typename T>
__global__ void __launch_bounds__(kBsbTile * kBsbLanes)
    bsb_matvec_t_kernel(const T* __restrict__ blocks, const T* __restrict__ x,
                        const int* __restrict__ ptr, const int* __restrict__ off,
                        T* __restrict__ y, int ndof, int nb, int h) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* xw = reinterpret_cast<T*>(smem + 16);  // (nb * B,) x window
  const int c0 = blockIdx.x * kBsbTile;
  const int cb = c0 / kBsbB;
  const int r0 = (cb - h) * kBsbB;  // the window's first row (may be < 0)
  const int wlen = nb * kBsbB;
  const int lo = max(r0, 0);
  const int hi = min(r0 + wlen, ndof);  // rows [lo, hi) are in x
  constexpr int kVec = 16 / sizeof(T);
  const int nbulk = (hi - lo) / kVec * kVec;
  if (threadIdx.x == 0) bulk_stage(xw + (lo - r0), x + lo, nbulk * sizeof(T), bar);
  for (int k = threadIdx.x; k < wlen; k += blockDim.x) {
    const int r = r0 + k;
    if (r < lo || r >= lo + nbulk) xw[k] = r < hi && r >= lo ? __ldg(x + r) : T(0);
  }

  constexpr int G = kBsbLanes;
  constexpr int kRegs = kBsbTRegs / G;
  const int c = c0 + static_cast<int>(threadIdx.x) / G;
  const int lane = threadIdx.x % G;
  int k0 = 0, k1 = 0;
  if (c < ndof) {
    k0 = __ldg(ptr + c) + lane;
    k1 = __ldg(ptr + c + 1);
  }
  // an entry's band position m = o / B^2 puts its row in window block 2h - m
  const long long band0 = static_cast<long long>(cb + h) * nb << kBsbShift;
  const long long band_step = static_cast<long long>(nb) << kBsbShift;
  // the lane's first kRegs entries (every entry of a column at 23.7k
  // dofs): offsets, then values, in flight while the window lands
  int o[kRegs];
  T v[kRegs];
#pragma unroll
  for (int s = 0; s < kRegs; ++s) o[s] = k0 + s * G < k1 ? __ldg(off + k0 + s * G) : -1;
#pragma unroll
  for (int s = 0; s < kRegs; ++s)
    v[s] = o[s] >= 0 ? __ldg(blocks + band0 - (o[s] >> kBsbShift) * band_step + o[s]) : T(0);
  __syncthreads();
  wait_first_phase(bar);

  T acc = T(0);
#pragma unroll
  for (int s = 0; s < kRegs; ++s)
    if (o[s] >= 0)
      acc = add_rn(acc, mul_rn(v[s], xw[(2 * h - (o[s] >> kBsbShift)) * kBsbB +
                                        ((o[s] >> 7) & (kBsbB - 1))]));
  for (int k = k0 + kRegs * G; k < k1; k += G) {  // columns longer than that
    const int ok = __ldg(off + k);
    const T vk = __ldg(blocks + band0 - (ok >> kBsbShift) * band_step + ok);
    acc = add_rn(acc, mul_rn(vk, xw[(2 * h - (ok >> kBsbShift)) * kBsbB + ((ok >> 7) & (kBsbB - 1))]));
  }
#pragma unroll
  for (int d = G / 2; d > 0; d >>= 1)
    acc = add_rn(acc, __shfl_xor_sync(0xffffffffu, acc, d, G));
  if (lane == 0 && c < ndof) y[c] = acc;
}

// K5's coefficients: a row of eight values of the working type T in device
// memory, in the order of equations/newmark.py:coefficients: c1 =
// gamma/beta/dt, c2 = gamma/beta - 1, c3 = dt (gamma/2/beta - 1), c4 =
// 1/beta/dt^2, c5 = 1/2/beta - 1, dt, the predictor's dtp and c = 0.5 dtp
// dtp -- the plain version's expressions in double, formed on the host once
// per run (a row a step) and rounded to T by the caller, as the plain
// version rounds a Python float.  The row is in T, not in double, so that
// no conversion waits on its loads before the vectors' loads start (a
// double row cost an f32 launch 0.13-0.25 us on an H100, PERF.md
// section 6).
template <typename T>
struct NewmarkRow {
  T c1, c2, c3, c4, c5, dt, dtp, c;
  // read after griddepcontrol.wait, like every other global load: the row
  // may be written by the kernel this launch depends on
  __device__ explicit NewmarkRow(const T* __restrict__ row)
      : c1(__ldg(row)), c2(__ldg(row + 1)), c3(__ldg(row + 2)), c4(__ldg(row + 3)),
        c5(__ldg(row + 4)), dt(__ldg(row + 5)), dtp(__ldg(row + 6)), c(__ldg(row + 7)) {}
};

// v1 = c1 (u1 - u0) - c2 v0 - c3 a0;  a1 = c4 ((u1 - u0) - dt v0) - c5 a0;
// u_next = (u1 + dtp v1) + c a1
template <typename T>
__device__ __forceinline__ void newmark_entry(const NewmarkRow<T>& k, T u1,
                                              T u0, T v0, T a0, T& v1, T& a1,
                                              T& un) {
  const T du = sub_rn(u1, u0);
  v1 = sub_rn(sub_rn(mul_rn(k.c1, du), mul_rn(k.c2, v0)), mul_rn(k.c3, a0));
  a1 = sub_rn(mul_rn(k.c4, sub_rn(du, mul_rn(k.dt, v0))), mul_rn(k.c5, a0));
  un = add_rn(add_rn(u1, mul_rn(k.dtp, v1)), mul_rn(k.c, a1));
}

// 16 bytes of T, as one vector load or store
template <typename T>
union Pack16;
template <>
union Pack16<double> {
  double2 v;
  double s[2];
};
template <>
union Pack16<float> {
  float4 v;
  float s[4];
};

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Entries [head, head + nvec * V) in 16-byte vectors (V = 16 / sizeof(T)),
// the rest one at a time.
template <typename T>
__global__ void __launch_bounds__(kNewmarkThreads)
    newmark_kernel(const T* __restrict__ u1, const T* __restrict__ u0,
                   const T* __restrict__ v0, const T* __restrict__ a0,
                   T* __restrict__ v1, T* __restrict__ a1, T* __restrict__ un,
                   long long n, long long head, const T* __restrict__ coefs) {
  constexpr int V = 16 / sizeof(T);
  using P = Pack16<T>;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long nvec = (n - head) / V;
  const long long body_end = head + nvec * V;
  const long long nscalar = head + (n - body_end);
  grid_dependency_wait();  // before the first global access
  const NewmarkRow<T> k(coefs);
  for (long long i = t; i < nvec; i += step) {
    const long long e = head + i * V;
    P x1, x0, y0, z0, y1, z1, w1;
    x1.v = *reinterpret_cast<const decltype(x1.v)*>(u1 + e);
    x0.v = *reinterpret_cast<const decltype(x0.v)*>(u0 + e);
    y0.v = *reinterpret_cast<const decltype(y0.v)*>(v0 + e);
    z0.v = *reinterpret_cast<const decltype(z0.v)*>(a0 + e);
    launch_dependents();
#pragma unroll
    for (int j = 0; j < V; ++j)
      newmark_entry(k, x1.s[j], x0.s[j], y0.s[j], z0.s[j], y1.s[j], z1.s[j], w1.s[j]);
    *reinterpret_cast<decltype(y1.v)*>(v1 + e) = y1.v;
    *reinterpret_cast<decltype(z1.v)*>(a1 + e) = z1.v;
    *reinterpret_cast<decltype(w1.v)*>(un + e) = w1.v;
  }
  for (long long i = t; i < nscalar; i += step) {
    const long long e = i < head ? i : body_end + (i - head);
    newmark_entry(k, u1[e], u0[e], v0[e], a0[e], v1[e], a1[e], un[e]);
  }
}

unsigned grid_for(long long total, int threads) {
  return static_cast<unsigned>((total + threads - 1) / threads);
}

// SMs of the current device, read once
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
        n > 0)
      sms = n;
    else
      return 132;
  }
  return sms;
}

template <typename T>
int launch_ebe(const void* J, const void* x, const void* dofs, void* y,
               int ne, int nld, void* stream) {
  long long total = static_cast<long long>(ne) * nld;
  if (total == 0) return 0;
  ebe_matvec_kernel<T><<<grid_for(total, kThreads), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(J), static_cast<const T*>(x),
      static_cast<const long long*>(dofs), static_cast<T*>(y), nld, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ebe_t(const void* J, const void* x, const void* dofs, void* y,
                 int ne, int nld, void* stream) {
  long long total = static_cast<long long>(ne) * nld;
  if (total == 0) return 0;
  ebe_matvec_t_kernel<T><<<grid_for(total, kThreads), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(J), static_cast<const T*>(x),
      static_cast<const long long*>(dofs), static_cast<T*>(y), nld, total);
  return static_cast<int>(cudaGetLastError());
}

// the x window of K4 and K4T: B entries for each of the nb band positions
template <typename T, typename Kernel>
cudaError_t window_smem(Kernel kernel, int nb, size_t* smem) {
  *smem = 16 + static_cast<size_t>(nb) * kBsbB * sizeof(T);
  if (*smem <= 48 * 1024) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(*smem));
  if (err != cudaSuccess) cudaGetLastError();  // clear it: the next launch's check reads it
  return err;
}

template <typename T>
int launch_bsb_t(const void* blocks, const void* x, const void* ptr,
                 const void* off, void* y, int ndof, int nb, int h,
                 void* stream) {
  if (ndof == 0) return 0;
  size_t smem = 0;
  const cudaError_t err = window_smem<T>(bsb_matvec_t_kernel<T>, nb, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bsb_matvec_t_kernel<T><<<(ndof + kBsbTile - 1) / kBsbTile, kBsbTile * kBsbLanes, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(blocks), static_cast<const T*>(x),
      static_cast<const int*>(ptr), static_cast<const int*>(off),
      static_cast<T*>(y), ndof, nb, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bsb(const void* blocks, const void* x, const void* ptr,
               const void* off, void* y, int ndof, int nb, int h,
               void* stream) {
  if (ndof == 0) return 0;
  size_t smem = 0;
  const cudaError_t err = window_smem<T>(bsb_matvec_kernel<T>, nb, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bsb_matvec_kernel<T><<<(ndof + kBsbTile - 1) / kBsbTile, kBsbTile * kBsbLanes, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(blocks), static_cast<const T*>(x),
      static_cast<const int*>(ptr), static_cast<const int*>(off),
      static_cast<T*>(y), ndof, nb, h);
  return static_cast<int>(cudaGetLastError());
}

// The scalar entries before the span where the vector at `first` and all
// of `others` are 16-byte aligned (every entry when their phases differ)
// Whether `first` and all of `others` share one 16-byte phase, a whole
// number of T's
template <typename T>
bool same_phase(const void* first, std::initializer_list<const void*> others) {
  const uintptr_t phase = reinterpret_cast<uintptr_t>(first) % 16;
  bool same = phase % sizeof(T) == 0;
  for (const void* p : others) same = same && reinterpret_cast<uintptr_t>(p) % 16 == phase;
  return same;
}

template <typename T>
long long vector_head(const void* first, std::initializer_list<const void*> others,
                      long long n) {
  const uintptr_t phase = reinterpret_cast<uintptr_t>(first) % 16;
  return same_phase<T>(first, others)
             ? std::min<long long>(n, static_cast<long long>((16 - phase) % 16 / sizeof(T)))
             : n;
}

// trips of the longer of the 16-byte loop over [head, n) and the scalar one
template <typename T>
long long vector_work(long long n, long long head) {
  constexpr long long V = 16 / sizeof(T);
  return std::max((n - head) / V, head + (n - head) % V);
}

// a launch of `grid` CTAs with programmatic stream serialization (used in
// place: cfg points at attr)
struct PdlLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr = {};
  PdlLaunch(long long grid, int threads, void* stream) {
    cfg.gridDim = dim3(static_cast<unsigned>(grid));
    cfg.blockDim = dim3(threads);
    cfg.stream = static_cast<cudaStream_t>(stream);
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// cudaLaunchKernelEx's result; a refused launch's error is cleared, since
// the next launch's check reads it
int checked_launch(cudaError_t err) {
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_newmark(const void* u1, const void* u0, const void* v0,
                   const void* a0, void* v1, void* a1, void* un, long long n,
                   const void* coefs, void* stream) {
  if (n == 0) return 0;
  const long long head = vector_head<T>(u1, {u0, v0, a0, v1, a1, un}, n);
  PdlLaunch l(std::min<long long>(grid_for(vector_work<T>(n, head), kNewmarkThreads),
                                  4LL * sm_count()),
              kNewmarkThreads, stream);
  return checked_launch(cudaLaunchKernelEx(
      &l.cfg, newmark_kernel<T>, static_cast<const T*>(u1),
      static_cast<const T*>(u0), static_cast<const T*>(v0),
      static_cast<const T*>(a0), static_cast<T*>(v1), static_cast<T*>(a1),
      static_cast<T*>(un), n, head, static_cast<const T*>(coefs)));
}

// ---- K5T: K5's backward ----------------------------------------------------

constexpr int kRowSums = 6;             // nonzero entries of the row's cotangent
constexpr int kNewmarkTThreads = 256;   // threads a CTA
constexpr int kNewmarkTMaxCtas = 132;   // CTAs a launch at most (an H100's SMs)
constexpr int kNewmarkTSlots = 1024;    // slots a device (ops.kernels.NEWMARK_T_SLOTS)

// The slots: an arrival counter and the CTAs' partial sums each (read as
// T, f32 or f64).  Static device memory is zero when the module loads,
// and the last CTA of a launch sets its counter back to zero, so no
// allocation, fill or capture ever touches them.
__device__ unsigned g_newmark_t_tickets[kNewmarkTSlots];
__device__ double g_newmark_t_partials[kNewmarkTSlots][kNewmarkTMaxCtas * kRowSums];

template <typename T>
struct NewmarkTArgs {
  const T* vb1;  // the cotangents of v1, a1
  const T* ab1;
  const T* u1;  // K5's inputs
  const T* u0;
  const T* v0;
  const T* a0;
  const T* coefs;
  T* ub1;  // the cotangents of u1, u0, v0, a0
  T* ub0;
  T* vb0;
  T* ab0;
  T* row_bar;  // the row's: 8 entries
};

// one entry's four cotangents and its terms of the row's six sums
template <typename T>
__device__ __forceinline__ void newmark_t_entry(const NewmarkRow<T>& k, T V, T A, T u1, T u0,
                                                T v0, T a0, T& ub1, T& ub0, T& vb0, T& ab0,
                                                T (&acc)[kRowSums]) {
  const T du = sub_rn(u1, u0);
  const T c4a = mul_rn(k.c4, A);
  ub1 = add_rn(mul_rn(k.c1, V), c4a);
  ub0 = -ub1;
  vb0 = -add_rn(mul_rn(k.c2, V), mul_rn(k.dt, c4a));
  ab0 = -add_rn(mul_rn(k.c3, V), mul_rn(k.c5, A));
  acc[0] = add_rn(acc[0], mul_rn(V, du));
  acc[1] = add_rn(acc[1], mul_rn(V, v0));
  acc[2] = add_rn(acc[2], mul_rn(V, a0));
  acc[3] = add_rn(acc[3], mul_rn(A, sub_rn(du, mul_rn(k.dt, v0))));
  acc[4] = add_rn(acc[4], mul_rn(A, a0));
  acc[5] = add_rn(acc[5], mul_rn(c4a, v0));
}

template <typename T>
__device__ __forceinline__ void newmark_t_pass(const NewmarkTArgs<T>& a, long long n,
                                               long long head, long long t, long long step,
                                               T (&acc)[kRowSums]);

// The vector cotangents of this thread's entries in a grid-stride loop:
// 16-byte vectors over [head, head + nvec * V) (V = 16 / sizeof(T)), the
// rest one at a time; the thread's terms of the six sums added in the
// order its entries come.  Called after griddepcontrol.wait.
template <typename T>
__device__ __forceinline__ void newmark_t_pass(const NewmarkTArgs<T>& a, long long n,
                                               long long head, T (&acc)[kRowSums]) {
  newmark_t_pass(a, n, head, blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x,
                 static_cast<long long>(gridDim.x) * blockDim.x, acc);
}

// the same over the entries t, t + step, ... (of the vectors, or of one
// variant's: a's pointers moved to its first entry)
template <typename T>
__device__ __forceinline__ void newmark_t_pass(const NewmarkTArgs<T>& a, long long n,
                                               long long head, long long t, long long step,
                                               T (&acc)[kRowSums]) {
  constexpr int V = 16 / sizeof(T);
  using P = Pack16<T>;
  using W = decltype(P::v);
  const long long nvec = (n - head) / V;
  const long long body_end = head + nvec * V;
  const long long nscalar = head + (n - body_end);
  const NewmarkRow<T> k(a.coefs);
  for (long long i = t; i < nvec; i += step) {
    const long long e = head + i * V;
    P gv, ga, x1, x0, y0, z0, o1, o0, ov, oa;
    gv.v = __ldg(reinterpret_cast<const W*>(a.vb1 + e));
    ga.v = __ldg(reinterpret_cast<const W*>(a.ab1 + e));
    x1.v = __ldg(reinterpret_cast<const W*>(a.u1 + e));
    x0.v = __ldg(reinterpret_cast<const W*>(a.u0 + e));
    y0.v = __ldg(reinterpret_cast<const W*>(a.v0 + e));
    z0.v = __ldg(reinterpret_cast<const W*>(a.a0 + e));
    launch_dependents();
#pragma unroll
    for (int j = 0; j < V; ++j)
      newmark_t_entry(k, gv.s[j], ga.s[j], x1.s[j], x0.s[j], y0.s[j], z0.s[j], o1.s[j],
                      o0.s[j], ov.s[j], oa.s[j], acc);
    *reinterpret_cast<W*>(a.ub1 + e) = o1.v;
    *reinterpret_cast<W*>(a.ub0 + e) = o0.v;
    *reinterpret_cast<W*>(a.vb0 + e) = ov.v;
    *reinterpret_cast<W*>(a.ab0 + e) = oa.v;
  }
  for (long long i = t; i < nscalar; i += step) {
    const long long e = i < head ? i : body_end + (i - head);
    newmark_t_entry(k, __ldg(a.vb1 + e), __ldg(a.ab1 + e), __ldg(a.u1 + e), __ldg(a.u0 + e),
                    __ldg(a.v0 + e), __ldg(a.a0 + e), a.ub1[e], a.ub0[e], a.vb0[e], a.ab0[e],
                    acc);
  }
}

// The CTA's six sums: an xor tree in each warp, then the warps in order;
// thread j < 6 returns sum j
template <typename T>
__device__ __forceinline__ T newmark_t_cta_sum(T (&acc)[kRowSums]) {
  __shared__ T warp_sums[kNewmarkTThreads / 32][kRowSums];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < kRowSums; ++j)
      acc[j] = add_rn(acc[j], __shfl_xor_sync(0xffffffffu, acc[j], off));
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int j = 0; j < kRowSums; ++j) warp_sums[threadIdx.x >> 5][j] = acc[j];
  __syncthreads();
  T sum = T(0);
  if (threadIdx.x < kRowSums) {
    sum = warp_sums[0][threadIdx.x];
    for (int w = 1; w < kNewmarkTThreads / 32; ++w) sum = add_rn(sum, warp_sums[w][threadIdx.x]);
  }
  return sum;
}

// entry j of the row's cotangent from its sum (the signs of the transpose)
template <typename T>
__device__ __forceinline__ T row_entry(int j, T sum) {
  return j == 1 || j == 2 || j == 4 || j == 5 ? -sum : sum;
}

// a ticket: release (the CTA's partial sums, ordered before it by the
// block barrier) and acquire (the other CTAs' partial sums) at gpu scope
__device__ __forceinline__ unsigned take_ticket(unsigned* counter) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.add.u32 %0, [%1], 1;" : "=r"(old) : "l"(counter) : "memory");
  return old;
}

template <typename T>
__global__ void __launch_bounds__(kNewmarkTThreads)
    newmark_t_kernel(NewmarkTArgs<T> a, int slot, long long n, long long head) {
  __shared__ bool last;
  grid_dependency_wait();  // before the first global access, the row's and the slot's included
  T acc[kRowSums] = {};
  newmark_t_pass(a, n, head, acc);
  const T sum = newmark_t_cta_sum(acc);
  T* partial = reinterpret_cast<T*>(g_newmark_t_partials[slot]);
  if (threadIdx.x < kRowSums) partial[blockIdx.x * kRowSums + threadIdx.x] = sum;
  __syncthreads();
  unsigned* counter = &g_newmark_t_tickets[slot];
  if (threadIdx.x == 0) last = take_ticket(counter) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // warp j adds entry j: lane l the CTAs l, l + 32, ... in order (every
  // load issued before the first sum), then an xor tree
  constexpr int kPer = (kNewmarkTMaxCtas + 31) / 32;
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < kRowSums; j += kNewmarkTThreads / 32) {
    T v[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const unsigned b = lane + 32 * q;
      v[q] = b < gridDim.x ? __ldcg(partial + b * kRowSums + j) : T(0);
    }
    T s = T(0);
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      if (lane + 32 * q < gridDim.x) s = add_rn(s, v[q]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = add_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    if (lane == 0) a.row_bar[j] = row_entry(j, s);
  }
  if (threadIdx.x == 0) {
    a.row_bar[kRowSums] = T(0);  // dtp and c: u_next is not differentiated
    a.row_bar[kRowSums + 1] = T(0);
    *counter = 0u;  // the slot's next launch waits for this one to end
  }
}

template <typename T>
int launch_newmark_t(const NewmarkTArgs<T>& a, int slot, long long n, void* stream) {
  if (n == 0 || slot < 0 || slot >= kNewmarkTSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long head = vector_head<T>(
      a.u1, {a.vb1, a.ab1, a.u0, a.v0, a.a0, a.ub1, a.ub0, a.vb0, a.ab0}, n);
  PdlLaunch l(std::min<long long>(grid_for(vector_work<T>(n, head), kNewmarkTThreads),
                                  std::min(sm_count(), kNewmarkTMaxCtas)),
              kNewmarkTThreads, stream);
  return checked_launch(cudaLaunchKernelEx(&l.cfg, newmark_t_kernel<T>, a, slot, n, head));
}

// K5T over a batch of B variants, (B, n) vectors under one row: CTA b is
// variant b (the grid's variant axis), its threads stride over the
// variant's n entries as newmark_t_pass, and the CTA's six sums
// (newmark_t_cta_sum) are the variant's row, written to row_bar[8 b ..]:
// each is one ordered sum, whatever the order in which the CTAs run, and
// no CTA waits for another (no ticket, no slot).  `same`: the ten vectors
// share one 16-byte phase (so does each variant's span of them); a
// variant's scalar head is then its own entries before its first 16-byte
// boundary.
template <typename T>
__global__ void __launch_bounds__(kNewmarkTThreads)
    newmark_t_batch_kernel(NewmarkTArgs<T> a, long long n, bool same) {
  const long long off = blockIdx.x * n;
  NewmarkTArgs<T> v = a;
  v.vb1 += off; v.ab1 += off; v.u1 += off; v.u0 += off; v.v0 += off; v.a0 += off;
  v.ub1 += off; v.ub0 += off; v.vb0 += off; v.ab0 += off;
  const long long lead =
      static_cast<long long>((16 - reinterpret_cast<uintptr_t>(v.u1) % 16) % 16 / sizeof(T));
  const long long head = same && lead < n ? lead : n;
  grid_dependency_wait();  // before the first global access, the row's included
  T acc[kRowSums] = {};
  newmark_t_pass(v, n, head, threadIdx.x, blockDim.x, acc);
  const T sum = newmark_t_cta_sum(acc);
  T* row = a.row_bar + blockIdx.x * static_cast<long long>(kRowSums + 2);
  if (threadIdx.x < kRowSums) row[threadIdx.x] = row_entry(static_cast<int>(threadIdx.x), sum);
  else if (threadIdx.x < kRowSums + 2) row[threadIdx.x] = T(0);  // dtp and c
}

template <typename T>
int launch_newmark_t_batch(const NewmarkTArgs<T>& a, long long batch, long long n,
                           void* stream) {
  if (n <= 0 || batch <= 0 || batch > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // one phase for all ten vectors (a variant's span moves them all alike)
  const bool same =
      same_phase<T>(a.u1, {a.vb1, a.ab1, a.u0, a.v0, a.a0, a.ub1, a.ub0, a.vb0, a.ab0});
  PdlLaunch l(batch, kNewmarkTThreads, stream);
  return checked_launch(cudaLaunchKernelEx(&l.cfg, newmark_t_batch_kernel<T>, a, n, same));
}

template <typename T>
NewmarkTArgs<T> newmark_t_args(const void* vb1, const void* ab1, const void* u1,
                               const void* u0, const void* v0, const void* a0,
                               const void* coefs, void* ub1, void* ub0, void* vb0, void* ab0,
                               void* row_bar) {
  return {static_cast<const T*>(vb1), static_cast<const T*>(ab1), static_cast<const T*>(u1),
          static_cast<const T*>(u0),  static_cast<const T*>(v0),  static_cast<const T*>(a0),
          static_cast<const T*>(coefs), static_cast<T*>(ub1), static_cast<T*>(ub0),
          static_cast<T*>(vb0), static_cast<T*>(ab0), static_cast<T*>(row_bar)};
}

}  // namespace

// Each entry point returns the cudaError_t of its launch (0 on success).
extern "C" {

int vf_ebe_matvec_f32(const void* J, const void* x, const void* dofs,
                      void* y, int ne, int nld, void* stream) {
  return launch_ebe<float>(J, x, dofs, y, ne, nld, stream);
}

int vf_ebe_matvec_f64(const void* J, const void* x, const void* dofs,
                      void* y, int ne, int nld, void* stream) {
  return launch_ebe<double>(J, x, dofs, y, ne, nld, stream);
}

int vf_bsb_matvec_f32(const void* blocks, const void* x, const void* ptr,
                      const void* off, void* y, int ndof, int nb, int h,
                      void* stream) {
  return launch_bsb<float>(blocks, x, ptr, off, y, ndof, nb, h, stream);
}

int vf_bsb_matvec_f64(const void* blocks, const void* x, const void* ptr,
                      const void* off, void* y, int ndof, int nb, int h,
                      void* stream) {
  return launch_bsb<double>(blocks, x, ptr, off, y, ndof, nb, h, stream);
}

int vf_ebe_matvec_t_f32(const void* J, const void* x, const void* dofs,
                        void* y, int ne, int nld, void* stream) {
  return launch_ebe_t<float>(J, x, dofs, y, ne, nld, stream);
}

int vf_ebe_matvec_t_f64(const void* J, const void* x, const void* dofs,
                        void* y, int ne, int nld, void* stream) {
  return launch_ebe_t<double>(J, x, dofs, y, ne, nld, stream);
}

// ptr, off: the transposed pattern (CSR by output column)
int vf_bsb_matvec_t_f32(const void* blocks, const void* x, const void* ptr,
                        const void* off, void* y, int ndof, int nb, int h,
                        void* stream) {
  return launch_bsb_t<float>(blocks, x, ptr, off, y, ndof, nb, h, stream);
}

int vf_bsb_matvec_t_f64(const void* blocks, const void* x, const void* ptr,
                        const void* off, void* y, int ndof, int nb, int h,
                        void* stream) {
  return launch_bsb_t<double>(blocks, x, ptr, off, y, ndof, nb, h, stream);
}

// v1, a1, un: the three outputs, n entries each; coefs: the device address
// of the row of eight coefficients (NewmarkRow), of the vectors' type
int vf_newmark_f32(const void* u1, const void* u0, const void* v0,
                   const void* a0, void* v1, void* a1, void* un, long long n,
                   const void* coefs, void* stream) {
  return launch_newmark<float>(u1, u0, v0, a0, v1, a1, un, n, coefs, stream);
}

int vf_newmark_f64(const void* u1, const void* u0, const void* v0,
                   const void* a0, void* v1, void* a1, void* un, long long n,
                   const void* coefs, void* stream) {
  return launch_newmark<double>(u1, u0, v0, a0, v1, a1, un, n, coefs, stream);
}

// K5T: the cotangents vb1, ab1 and K5's inputs in; ub1, ub0, vb0, ab0 (n
// entries each) and row_bar (8) out; slot: the launch's counter and partial
// sums, [0, 1024), ordered after every other launch on it (ops.kernels)
int vf_newmark_t_f32(const void* vb1, const void* ab1, const void* u1, const void* u0,
                     const void* v0, const void* a0, const void* coefs, void* ub1,
                     void* ub0, void* vb0, void* ab0, void* row_bar, int slot, long long n,
                     void* stream) {
  return launch_newmark_t<float>(
      newmark_t_args<float>(vb1, ab1, u1, u0, v0, a0, coefs, ub1, ub0, vb0, ab0, row_bar), slot,
      n, stream);
}

int vf_newmark_t_f64(const void* vb1, const void* ab1, const void* u1, const void* u0,
                     const void* v0, const void* a0, const void* coefs, void* ub1,
                     void* ub0, void* vb0, void* ab0, void* row_bar, int slot, long long n,
                     void* stream) {
  return launch_newmark_t<double>(
      newmark_t_args<double>(vb1, ab1, u1, u0, v0, a0, coefs, ub1, ub0, vb0, ab0, row_bar), slot,
      n, stream);
}

// K5T over a batch: vb1 .. a0 and ub1 .. ab0 (B, n) row-major, row_bar
// (B, 8); one launch, a CTA a variant
int vf_newmark_t_batch_f32(const void* vb1, const void* ab1, const void* u1, const void* u0,
                           const void* v0, const void* a0, const void* coefs, void* ub1,
                           void* ub0, void* vb0, void* ab0, void* row_bar, long long batch,
                           long long n, void* stream) {
  return launch_newmark_t_batch<float>(
      newmark_t_args<float>(vb1, ab1, u1, u0, v0, a0, coefs, ub1, ub0, vb0, ab0, row_bar),
      batch, n, stream);
}

int vf_newmark_t_batch_f64(const void* vb1, const void* ab1, const void* u1, const void* u0,
                           const void* v0, const void* a0, const void* coefs, void* ub1,
                           void* ub0, void* vb0, void* ab0, void* row_bar, long long batch,
                           long long n, void* stream) {
  return launch_newmark_t_batch<double>(
      newmark_t_args<double>(vb1, ab1, u1, u0, v0, a0, coefs, ub1, ub0, vb0, ab0, row_bar),
      batch, n, stream);
}

// *id: the id of the CUDA graph capture that stream takes part in, 0 when
// it is not capturing
int vf_capture_id(void* stream, unsigned long long* id) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  *id = 0;
  const cudaError_t err =
      cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, id);
  if (status != cudaStreamCaptureStatusActive) *id = 0;
  return static_cast<int>(err);
}

}  // extern "C"
