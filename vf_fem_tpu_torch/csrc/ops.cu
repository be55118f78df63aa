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
// TPU kernel keeps the whole padded x in VMEM and streams tiles of block
// rows through the MXU.  Here one CTA owns one block row n: it loads its
// x window (nb * 128 values, zero outside [0, ndof)) into shared memory, so
// no padded copy of x is built in HBM, and one warp per output row i reads
// blocks[n, m, i, :] along j (coalesced) and reduces across the warp with
// xor shuffles in a fixed order.  Bound: bytes.  Each call streams the
// block array once (nblk * nb * 128^2 values: 122 MB in f64 at 23.7k dofs,
// ~36 us at 3.35 TB/s); x and y are a few hundred KB.
//
// K5 replaces vf_fem_tpu/ops/pallas_kernels.py:_newmark_kernel.  One thread
// per entry reads u1, u0, v0, a0 and writes v1, a1; (dt, gamma, beta) come
// by value.  The coefficients are formed in double as the plain version
// forms them on the host, then rounded to the working type, and every
// product and sum is rounded separately (__dmul_rn / __fmul_rn and kin):
// no contraction to FMA, so the kernel reproduces the plain version's
// rounding.  Bound: bytes (six vectors), launch-dominated at these sizes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBsbThreads = 512;  // 16 warps per block row
constexpr int kBsbB = 128;        // block size of the block-banded plan

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

// y[n*B + i] = sum_m sum_j blocks[n, m, i, j] * x[(n - h + m)*B + j]
template <typename T>
__global__ void bsb_matvec_kernel(const T* __restrict__ blocks,
                                  const T* __restrict__ x,
                                  T* __restrict__ y, int ndof, int nb,
                                  int h) {
  extern __shared__ unsigned char smem_raw[];
  T* xw = reinterpret_cast<T*>(smem_raw);  // (nb * B,) x window
  const int n = blockIdx.x;
  const long long c0 = static_cast<long long>(n - h) * kBsbB;
  for (int k = threadIdx.x; k < nb * kBsbB; k += blockDim.x) {
    long long c = c0 + k;
    xw[k] = (c >= 0 && c < ndof) ? x[c] : T(0);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const T* bn = blocks + static_cast<long long>(n) * nb * kBsbB * kBsbB;
  for (int i = warp; i < kBsbB; i += nwarps) {
    T acc = T(0);
    for (int m = 0; m < nb; ++m) {
      const T* row = bn + (static_cast<long long>(m) * kBsbB + i) * kBsbB;
      const T* xm = xw + m * kBsbB;
#pragma unroll
      for (int j = lane; j < kBsbB; j += 32) acc += row[j] * xm[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    long long r = static_cast<long long>(n) * kBsbB + i;
    if (lane == 0 && r < ndof) y[r] = acc;
  }
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
int launch_bsb(const void* blocks, const void* x, void* y, int ndof,
               int nblk, int nb, int h, void* stream) {
  if (nblk == 0) return 0;
  size_t smem = static_cast<size_t>(nb) * kBsbB * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bsb_matvec_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bsb_matvec_kernel<T><<<nblk, kBsbThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(blocks), static_cast<const T*>(x),
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

int vf_bsb_matvec_f32(const void* blocks, const void* x, void* y, int ndof,
                      int nblk, int nb, int h, void* stream) {
  return launch_bsb<float>(blocks, x, y, ndof, nblk, nb, h, stream);
}

int vf_bsb_matvec_f64(const void* blocks, const void* x, void* y, int ndof,
                      int nblk, int nb, int h, void* stream) {
  return launch_bsb<double>(blocks, x, y, ndof, nblk, nb, h, stream);
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
