// Banded gather (K1) and scatter-add (K2) of the residual cell pass, for
// Hopper (sm_90a).  Plain C entry points, loaded with ctypes by
// vf_fem_tpu_torch/fem/banded.py, which also holds the plain PyTorch
// versions of both, the description of the plan arrays and the choice of
// channels per CTA.
//
// Replaces the TPU kernels vf_fem_tpu/fem/banded.py:_gather_kernel and
// vf_fem_tpu/fem/banded.py:_scatter_kernel.  Those copy each group's vertex
// window into VMEM and build a one-hot selector through the MXU, because
// the TPU has no gather.  Here the window is staged in shared memory and
// read by index.
//
// What bounds them on this card: bytes, and at these sizes the launch.  At
// 23.7k dofs (C = 11 gathered channels, 92 groups of 256 cells, window 384)
// K1 moves 7.55 MB (6.22 MB of locals out, 1.05 MB of F, 0.28 MB of
// offsets): 2.25 us at 3.35 TB/s.  K2 (C = 2) moves 1.65 MB: 0.49 us.
//
// K1: one CTA per (group g, chunk of channels; the host splits a group's
// channels only as far as needed for its CTAs to cover the card).  It
// stages the window F[c, base_g : base_g + w] of its channels in shared
// memory, one cp.async per entry (F's rows need not be 16-byte aligned)
// with columns past F's nF zero-filled, each channel's row completed on
// its own mbarrier.  While they land, each thread loads the offset of its
// (slot, cell) once; then it writes its chunk's channels from shared
// memory, each as soon as its row is in, coalesced along cells, zero where
// delta == w (a padding slot).  Gathers are copies: exact.
//
// K2 is the same design turned around.  One CTA per (tile of output rows,
// channel) stages the locals of every group that adds into its tile,
// loc[v, c, g*gc : (g+1)*gc] (contiguous and 16-byte aligned rows), with
// 1-D cp.async.bulk copies on one mbarrier.  Each thread then
// sums its row over a host-built CSR list of the (slot, cell) entries that
// add into it, read from shared memory, in the list's fixed order, so its
// sums are those of an atomic-free one-thread-per-row scatter, bit for
// bit.  Atomics would make f64 sums depend on launch order, and the
// trajectory goldens are held at 1e-8.
//
// Both take their plan arguments as one struct built once per plan on the
// host, and the per-call sizes as ints.
//
// Stacked plans (the DOF-sharded step, parallel/ddstep.py): `shards` plans
// of equal shape, each array with a leading shard axis, run in one launch,
// the shard in blockIdx.z.  A shard's CTAs read its own base and offsets
// and its own rows of F / loc and out; the scatter's CSR lists are the
// shards' lists one after another, its row pointers offset into them.
// This is the counterpart of the JAX package's traced-plan variants
// banded_gather_t / banded_scatter_t (vf_fem_tpu/fem/banded.py:445, 470),
// which reach the same two TPU kernels.  One shard is the single plan.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSmem = 227 * 1024;  // Hopper's opt-in shared memory per CTA
constexpr int kMaxThreads = 1024;

// the plan arguments of one gather pattern (see fem/banded.py: _GatherArgs)
struct GatherArgs {
  const int* base;   // (ngroups,) window starts
  const int* delta;  // (ngroups, nv, gc) offsets into the window
  int nv, ngroups, gc, w;
};

// the plan arguments of one scatter pattern (see fem/banded.py: _ScatterArgs)
struct ScatterArgs {
  const int* ptr;   // (nvert_pad + 1,) CSR row pointers
  const int* lidx;  // (nnz,) entries as offsets into their tile's staged slab
  const int* glo;   // (ntiles,) first group a tile stages
  const int* ngt;   // (ntiles,) groups a tile stages
  int nv, gc, ncpad, tile;
  int nptr, ntiles;  // a shard's row pointers (nvert_pad + 1) and tiles
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's first phase
__device__ __forceinline__ void mbar_wait_first(uint64_t* bar) {
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

// copy one sizeof(T)-byte entry into shared memory, or zero-fill it when
// `keep` is false (no byte is read then)
template <typename T>
__device__ __forceinline__ void cp_async_entry(T* dst, const T* src, bool keep) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
               "l"(src), "n"(sizeof(T)), "r"(keep ? static_cast<int>(sizeof(T)) : 0)
               : "memory");
}

// arrive on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the bytes ahead of the staged entries: one mbarrier per staged row
// (gather) or one (scatter), rounded up to 16
__host__ __device__ constexpr int bar_bytes(int bars) { return (bars * 8 + 15) / 16 * 16; }

// out[v, c, cell] = F[c, base[g] + delta[g, v, j]] for cell = g * gc + j;
// 0 where delta == w (a padding slot) or where the column lies beyond F's
// nF columns (the zero padding of F up to nvert_pad).  CTA (g, y) handles
// channels [y * cpb, min(C, (y + 1) * cpb)); channel c's window lands on
// its own mbarrier, so its stores start while later channels still load.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    banded_gather_kernel(const T* __restrict__ F, T* __restrict__ out,
                         GatherArgs a, int C, int nF, int cpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  T* win = reinterpret_cast<T*>(smem + bar_bytes(cpb));  // [nc][w]
  const int g = blockIdx.x;
  const int c0 = blockIdx.y * cpb;
  const int nc = min(cpb, C - c0);
  const int npairs = a.nv * a.gc;
  const long long ncpad = static_cast<long long>(a.ngroups) * a.gc;
  {  // this CTA's shard
    const long long sh = blockIdx.z;
    F += sh * C * nF;
    out += sh * a.nv * C * ncpad;
    a.base += sh * a.ngroups;
    a.delta += sh * a.ngroups * npairs;
  }
  for (int c = threadIdx.x; c < nc; c += blockDim.x) mbar_init(bars + c, blockDim.x);
  __syncthreads();

  const int base = a.base[g];
  for (int c = 0; c < nc; ++c) {
    const T* Fc = F + static_cast<long long>(c0 + c) * nF;
    for (int k = threadIdx.x; k < a.w; k += blockDim.x) {
      const int col = base + k;
      cp_async_entry(win + c * a.w + k, Fc + (col < nF ? col : 0), col < nF);
    }
    cp_async_arrive(bars + c);
  }

  // one pass for each blockDim.x (slot, cell) pairs of the group (one pass
  // where nv * gc <= 1024); the offset is loaded once, while rows land
  const int* delta = a.delta + static_cast<long long>(g) * npairs;
  for (int p0 = 0; p0 < npairs; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool live = p < npairs;
    const int d = live ? __ldg(delta + p) : a.w;
    const int v = p / a.gc;
    T* o = out + (static_cast<long long>(v) * C + c0) * ncpad +
           static_cast<long long>(g) * a.gc + (p - v * a.gc);
    for (int c = 0; c < nc; ++c) {
      mbar_wait_first(bars + c);
      if (live) o[c * ncpad] = d < a.w ? win[c * a.w + d] : T(0);
    }
  }
}

// out[c, n] = sum over k in [ptr[n], ptr[n+1]) of loc[v, c, cell] for the
// entry (v, cell) of k, in CSR order, read from the staged slab: the slab of
// tile t of channel c holds, for each group gi < ngt[t] (group glo[t] + gi)
// and slot v, the row loc[v, c, g*gc : (g+1)*gc] at
// (gi * nv + v) * gc, and lidx[k] = (gi * nv + v) * gc + j.  CTA (t, c)
// handles rows [t * tile, (t + 1) * tile) of channel c.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    banded_scatter_kernel(const T* __restrict__ loc, T* __restrict__ out,
                          ScatterArgs a, int C, int n_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t& bar = *reinterpret_cast<uint64_t*>(smem);
  T* slab = reinterpret_cast<T*>(smem + bar_bytes(1));
  const int t = blockIdx.x;
  const int c = blockIdx.y;
  {  // this CTA's shard
    const long long sh = blockIdx.z;
    loc += sh * a.nv * C * a.ncpad;
    out += sh * C * n_out;
    a.ptr += sh * a.nptr;
    a.glo += sh * a.ntiles;
    a.ngt += sh * a.ntiles;
  }
  const int glo = a.glo[t];
  const int ngt = a.ngt[t];
  const int rows = ngt * a.nv;
  const unsigned row_bytes = a.gc * sizeof(T);
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) mbar_arrive_expect_tx(&bar, rows * row_bytes);
    __syncwarp();
    for (int r = threadIdx.x; r < rows; r += 32) {
      const int gi = r / a.nv;
      const int v = r - gi * a.nv;
      const T* src = loc + (static_cast<long long>(v) * C + c) * a.ncpad +
                     static_cast<long long>(glo + gi) * a.gc;
      bulk_load(slab + static_cast<long long>(r) * a.gc, src, row_bytes, &bar);
    }
  }

  const int n = t * a.tile + threadIdx.x;
  const bool live = threadIdx.x < a.tile && n < n_out;
  const int k0 = live ? __ldg(a.ptr + n) : 0;  // in flight during the copies
  const int k1 = live ? __ldg(a.ptr + n + 1) : 0;
  mbar_wait_first(&bar);
  if (!live) return;
  T acc = T(0);
  for (int k = k0; k < k1; ++k) acc += slab[__ldg(a.lidx + k)];
  out[static_cast<long long>(c) * n_out + n] = acc;
}

// Allow `Kernel` up to kMaxSmem bytes of dynamic shared memory (once) and
// launch it with `smem` bytes of it; returns the cudaError_t.
template <auto Kernel, typename... Args>
int launch(dim3 grid, int threads, long long smem, void* stream, Args... args) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (smem > kMaxSmem || threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  Kernel<<<grid, threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gather(const void* F, void* out, const GatherArgs* a, int C, int nF,
                  int cpb, int shards, void* stream) {
  if (a->ngroups == 0 || C == 0) return 0;
  if (cpb < 1 || shards < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int npairs = a->nv * a->gc;
  const int threads = npairs < kMaxThreads ? (npairs + 31) / 32 * 32 : kMaxThreads;
  const dim3 grid(a->ngroups, (C + cpb - 1) / cpb, shards);
  return launch<banded_gather_kernel<T>>(grid, threads,
                bar_bytes(cpb) + static_cast<long long>(cpb) * a->w * sizeof(T), stream,
                static_cast<const T*>(F), static_cast<T*>(out), *a, C, nF, cpb);
}

template <typename T>
int launch_scatter(const void* loc, void* out, const ScatterArgs* a, int C,
                   int n_out, int max_ngt, int shards, void* stream) {
  if (n_out == 0 || C == 0) return 0;
  if (shards < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_out + a->tile - 1) / a->tile, C, shards);
  return launch<banded_scatter_kernel<T>>(
      grid, (a->tile + 31) / 32 * 32,
      bar_bytes(1) + static_cast<long long>(max_ngt) * a->nv * a->gc * sizeof(T),
      stream, static_cast<const T*>(loc), static_cast<T*>(out), *a, C, n_out);
}

}  // namespace

// Each entry point returns the cudaError_t of its launch (0 on success).
// `cpb` is the number of channels each gather CTA stages; `max_ngt` the
// most groups a scatter tile stages (of any shard); `shards` the plans
// stacked (1 for a single plan).
extern "C" {

int vf_banded_gather_f32(const void* F, void* out, const void* args, int C,
                         int nF, int cpb, int shards, void* stream) {
  return launch_gather<float>(F, out, static_cast<const GatherArgs*>(args), C,
                              nF, cpb, shards, stream);
}

int vf_banded_gather_f64(const void* F, void* out, const void* args, int C,
                         int nF, int cpb, int shards, void* stream) {
  return launch_gather<double>(F, out, static_cast<const GatherArgs*>(args), C,
                               nF, cpb, shards, stream);
}

int vf_banded_scatter_f32(const void* loc, void* out, const void* args, int C,
                          int n_out, int max_ngt, int shards, void* stream) {
  return launch_scatter<float>(loc, out, static_cast<const ScatterArgs*>(args),
                               C, n_out, max_ngt, shards, stream);
}

int vf_banded_scatter_f64(const void* loc, void* out, const void* args, int C,
                          int n_out, int max_ngt, int shards, void* stream) {
  return launch_scatter<double>(loc, out, static_cast<const ScatterArgs*>(args),
                                C, n_out, max_ngt, shards, stream);
}

}  // extern "C"
