// Banded gather (K1) and scatter-add (K2) of the residual cell pass, for
// Hopper (sm_90a).  Plain C entry points, loaded with ctypes by
// vf_fem_tpu_torch/fem/banded.py, which also holds the plain PyTorch
// versions of both and the description of the plan arrays.
//
// Replaces the TPU kernels vf_fem_tpu/fem/banded.py:_gather_kernel and
// vf_fem_tpu/fem/banded.py:_scatter_kernel.  Those build a one-hot selector
// on chip and run it through the MXU only because the TPU has no gather;
// here each thread does a direct indexed load.
//
// What bounds them on this card: the data are tiny.  At M5 size (C = 11
// channels, 480 vertices, nvert_pad = 512) F is 11 x 512 x 8 B = 45 KB and
// the locals 3 x 11 x 1024 x 8 B = 270 KB, a fraction of a microsecond of
// HBM time: both kernels are bound by launch latency.  The design keeps each
// to a single launch with no second pass, no atomics and no shared memory,
// one thread per output element, with the cell (K1) or vertex (K2) index
// innermost so that loads of the index arrays and all stores coalesce.
//
// K2 is deterministic: each output (channel, vertex) is summed by one thread
// over a host-built CSR list of the (slot, cell) entries that add into it,
// in a fixed order.  Atomics would make f64 sums depend on launch order,
// and the trajectory goldens are held at 1e-8.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// out[v, c, cell] = F[c, base[g] + delta[g, v, j]] for cell = g * gc + j;
// 0 where delta == w (a padding slot) or where the column lies beyond F's
// nF columns (the zero padding of F up to nvert_pad).
template <typename T>
__global__ void banded_gather_kernel(const T* __restrict__ F,
                                     const int* __restrict__ base,
                                     const int* __restrict__ delta,
                                     T* __restrict__ out, int C, int nv,
                                     int gc, int w, int nF, int ncpad,
                                     long long total) {
  long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= total) return;
  int cell = static_cast<int>(t % ncpad);
  long long r = t / ncpad;
  int c = static_cast<int>(r % C);
  int v = static_cast<int>(r / C);
  int g = cell / gc;
  int j = cell - g * gc;
  int d = delta[(static_cast<long long>(g) * nv + v) * gc + j];
  int col = base[g] + d;
  T val = T(0);
  if (d < w && col < nF) val = F[static_cast<long long>(c) * nF + col];
  out[t] = val;
}

// out[c, n] = sum over k in [ptr[n], ptr[n+1]) of loc[v, c, cell], where
// idx[k] = v * ncpad + cell, in CSR order.
template <typename T>
__global__ void banded_scatter_kernel(const T* __restrict__ loc,
                                      const int* __restrict__ ptr,
                                      const int* __restrict__ idx,
                                      T* __restrict__ out, int C, int ncpad,
                                      int n_out) {
  long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= static_cast<long long>(C) * n_out) return;
  int n = static_cast<int>(t % n_out);
  int c = static_cast<int>(t / n_out);
  T acc = T(0);
  for (int k = ptr[n]; k < ptr[n + 1]; ++k) {
    int s = idx[k];
    int v = s / ncpad;
    int cell = s - v * ncpad;
    acc += loc[(static_cast<long long>(v) * C + c) * ncpad + cell];
  }
  out[t] = acc;
}

template <typename T>
int launch_gather(const void* F, const void* base, const void* delta,
                  void* out, int C, int nv, int ngroups, int gc, int w,
                  int nF, void* stream) {
  int ncpad = ngroups * gc;
  long long total = static_cast<long long>(nv) * C * ncpad;
  if (total == 0) return 0;
  unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  banded_gather_kernel<T><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(F), static_cast<const int*>(base),
      static_cast<const int*>(delta), static_cast<T*>(out), C, nv, gc, w, nF,
      ncpad, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scatter(const void* loc, const void* ptr, const void* idx,
                   void* out, int C, int ncpad, int n_out, void* stream) {
  long long total = static_cast<long long>(C) * n_out;
  if (total == 0) return 0;
  unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  banded_scatter_kernel<T><<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(loc), static_cast<const int*>(ptr),
      static_cast<const int*>(idx), static_cast<T*>(out), C, ncpad, n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point returns the cudaError_t of its launch (0 on success).
extern "C" {

int vf_banded_gather_f32(const void* F, const void* base, const void* delta,
                         void* out, int C, int nv, int ngroups, int gc, int w,
                         int nF, void* stream) {
  return launch_gather<float>(F, base, delta, out, C, nv, ngroups, gc, w, nF,
                              stream);
}

int vf_banded_gather_f64(const void* F, const void* base, const void* delta,
                         void* out, int C, int nv, int ngroups, int gc, int w,
                         int nF, void* stream) {
  return launch_gather<double>(F, base, delta, out, C, nv, ngroups, gc, w,
                               nF, stream);
}

int vf_banded_scatter_f32(const void* loc, const void* ptr, const void* idx,
                          void* out, int C, int ncpad, int n_out,
                          void* stream) {
  return launch_scatter<float>(loc, ptr, idx, out, C, ncpad, n_out, stream);
}

int vf_banded_scatter_f64(const void* loc, const void* ptr, const void* idx,
                          void* out, int C, int ncpad, int n_out,
                          void* stream) {
  return launch_scatter<double>(loc, ptr, idx, out, C, ncpad, n_out, stream);
}

}  // extern "C"
