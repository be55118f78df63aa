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
// K5 replaces vf_fem_tpu/ops/pallas_kernels.py:_newmark_kernel.  One thread
// per entry reads u1, u0, v0, a0 and writes v1, a1; (dt, gamma, beta) come
// by value.  The coefficients are formed in double as the plain version
// forms them on the host, then rounded to the working type, and every
// product and sum is rounded separately (__dmul_rn / __fmul_rn and kin):
// no contraction to FMA, so the kernel reproduces the plain version's
// rounding.  Bound: bytes (six vectors), launch-dominated at these sizes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBsbB = 128;     // block size of the block-banded plan
constexpr int kBsbTile = 64;   // rows a K4 CTA
constexpr int kBsbLanes = 4;   // lanes a row (ops.kernels.BSB_LANES)
constexpr int kBsbRegs = 8;    // entries a K4 lane holds in registers a pass
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

// v1 = c1 (u1 - u0) - c2 v0 - c3 a0;  a1 = c4 ((u1 - u0) - dt v0) - c5 a0
// with c1 = gamma/beta/dt, c2 = gamma/beta - 1, c3 = dt (gamma/2/beta - 1),
// c4 = 1/beta/dt^2, c5 = 1/2/beta - 1 -- the plain version's expressions.
template <typename T>
__global__ void newmark_kernel(const T* __restrict__ u1,
                               const T* __restrict__ u0,
                               const T* __restrict__ v0,
                               const T* __restrict__ a0, T* __restrict__ v1,
                               T* __restrict__ a1, long long n, double dt,
                               double gamma, double beta) {
  long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= n) return;
  const T c1 = static_cast<T>(__ddiv_rn(__ddiv_rn(gamma, beta), dt));
  const T c2 = static_cast<T>(__dsub_rn(__ddiv_rn(gamma, beta), 1.0));
  const T c3 = static_cast<T>(
      __dmul_rn(dt, __dsub_rn(__ddiv_rn(__ddiv_rn(gamma, 2.0), beta), 1.0)));
  const T c4 = static_cast<T>(__ddiv_rn(__ddiv_rn(1.0, beta),
                                        __dmul_rn(dt, dt)));
  const T c5 = static_cast<T>(__dsub_rn(__ddiv_rn(__ddiv_rn(1.0, 2.0), beta),
                                        1.0));
  const T tdt = static_cast<T>(dt);
  const T du = sub_rn(u1[t], u0[t]);
  v1[t] = sub_rn(sub_rn(mul_rn(c1, du), mul_rn(c2, v0[t])), mul_rn(c3, a0[t]));
  a1[t] = sub_rn(mul_rn(c4, sub_rn(du, mul_rn(tdt, v0[t]))), mul_rn(c5, a0[t]));
}

unsigned grid_for(long long total, int threads) {
  return static_cast<unsigned>((total + threads - 1) / threads);
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
int launch_bsb(const void* blocks, const void* x, const void* ptr,
               const void* off, void* y, int ndof, int nb, int h,
               void* stream) {
  if (ndof == 0) return 0;
  const size_t smem = 16 + static_cast<size_t>(nb) * kBsbB * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bsb_matvec_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch's check reads it
      return static_cast<int>(err);
    }
  }
  bsb_matvec_kernel<T><<<(ndof + kBsbTile - 1) / kBsbTile, kBsbTile * kBsbLanes, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(blocks), static_cast<const T*>(x),
      static_cast<const int*>(ptr), static_cast<const int*>(off),
      static_cast<T*>(y), ndof, nb, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_newmark(const void* u1, const void* u0, const void* v0,
                   const void* a0, void* v1, void* a1, long long n,
                   double dt, double gamma, double beta, void* stream) {
  if (n == 0) return 0;
  newmark_kernel<T><<<grid_for(n, kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u1), static_cast<const T*>(u0),
      static_cast<const T*>(v0), static_cast<const T*>(a0),
      static_cast<T*>(v1), static_cast<T*>(a1), n, dt, gamma, beta);
  return static_cast<int>(cudaGetLastError());
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

int vf_newmark_f32(const void* u1, const void* u0, const void* v0,
                   const void* a0, void* v1, void* a1, long long n,
                   double dt, double gamma, double beta, void* stream) {
  return launch_newmark<float>(u1, u0, v0, a0, v1, a1, n, dt, gamma, beta,
                               stream);
}

int vf_newmark_f64(const void* u1, const void* u0, const void* v0,
                   const void* a0, void* v1, void* a1, long long n,
                   double dt, double gamma, double beta, void* stream) {
  return launch_newmark<double>(u1, u0, v0, a0, v1, a1, n, dt, gamma, beta,
                                stream);
}

}  // extern "C"
