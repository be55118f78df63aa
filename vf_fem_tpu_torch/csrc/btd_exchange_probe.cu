// The exchange of K6's carried vector alone (a measurement, not a kernel of
// any path; chip_smoke.py loads and times it): one launch is one cluster of
// K6's plan (cluster.cuh) for factors of type TA and row blocks of Bt, and
// row block s pushes, from each consumer warp's rows, the entries of the
// previous block's vector it holds into every CTA, as K6 pushes x_s:
// either as K6 does (st.async counted on the receivers' mbarriers) or with
// plain remote stores and one barrier.cluster (release / acquire) a row
// block.
//
// Each CTA starts with only its own rows of the vector, entry k holding the
// bit pattern k + 1, and every row block passes the vector on unchanged, so
// after n >= 2 row blocks every CTA's copy of x_{n-2} holds k + 1 in entry
// k for all Bt entries only if every push landed in the right CTA at the
// right offset.  The kernel writes that copy to sink (cluster x Bt).

#include "cluster.cuh"

namespace {

using namespace vf_btd;

__device__ __forceinline__ __nv_bfloat16 seed(int k, __nv_bfloat16*) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(k + 1));
}
__device__ __forceinline__ double seed(int k, double*) {
  return __longlong_as_double(static_cast<long long>(k + 1));
}

template <typename TA, int BT, bool kBarrier>
__global__ void __launch_bounds__(Geometry<TA, BT>::W * 32, 1)
    exchange_probe_kernel(TA* __restrict__ sink, int n) {
  using G = Geometry<TA, BT>;
  __shared__ __align__(16) TA xs[2 * BT];
  __shared__ uint64_t xready[2];
  const unsigned rank = cluster_rank();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) mbar_init(xready + b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // x_{-1} (buffer 1): this CTA's own rows only
  for (int k = threadIdx.x; k < 2 * BT; k += G::W * 32) {
    const int row = k - BT;
    const bool own = row >= static_cast<int>(rank) * G::R &&
                     row < static_cast<int>(rank + 1) * G::R;
    xs[k] = own ? seed(row, xs) : TA{};
  }
  cluster_sync_all();
  for (int s = 0; s < n; ++s) {
    const int rb = s & 1;
    const bool push = s + 1 < n;
    if (!kBarrier) {
      if (push && threadIdx.x == 0)
        mbar_arrive_expect_tx(xready + rb, BT * static_cast<unsigned>(sizeof(TA)));
      if (s > 0) mbar_wait<true>(xready + (rb ^ 1), ((s - 1) >> 1) & 1);
    }
    if (push) {
#pragma unroll
      for (int sub = 0; sub < G::SPB; ++sub) {
        const int k0 = rank * G::R + sub * G::RS + warp * G::RPW;
        TA v[G::RPW];
#pragma unroll
        for (int u = 0; u < G::RPW; ++u) v[u] = xs[(rb ^ 1) * BT + k0 + u];
        uint32_t w[G::WORDS];
        to_words<G::RPW>(v, w);
        push_words<G::C, G::WORDS, kBarrier>(w, xs + rb * BT + k0, xready + rb, lane);
      }
    }
    if (kBarrier) cluster_sync_all();
  }
  // x_{n-2}, in buffer n & 1: complete here after the last row block's wait
  for (int k = threadIdx.x; k < BT; k += G::W * 32)
    sink[rank * BT + k] = xs[(n & 1) * BT + k];
  cluster_sync_all();
}

template <typename TA, int BT>
int launch_probe_bt(void* sink, int n, int barrier, void* stream) {
  using G = Geometry<TA, BT>;
  auto kernel = barrier ? exchange_probe_kernel<TA, BT, true>
                        : exchange_probe_kernel<TA, BT, false>;
  cudaError_t err = set_attributes(kernel, 0, G::C);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(G::W * 32, 0, G::C, stream, cfg, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<TA*>(sink), n);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA>
int launch_probe(void* sink, int n, int bt, int barrier, void* stream) {
  if (n < 2) return static_cast<int>(cudaErrorInvalidValue);
#define VF_PROBE_CALL(BT) launch_probe_bt<TA, BT>(sink, n, barrier, stream)
  VF_BT_SWITCH(VF_PROBE_CALL)
#undef VF_PROBE_CALL
}

}  // namespace

// n >= 2 row blocks of pushes of a Bt-entry vector of the factor type
// (suffix) across K6's cluster for that type, into `sink` (cluster x Bt
// entries); barrier != 0 takes plain remote stores and barrier.cluster.
// Returns the cudaError_t of the launch.
extern "C" {

int vf_btd_exchange_probe_bf16(void* sink, int n, int bt, int barrier, void* stream) {
  return launch_probe<__nv_bfloat16>(sink, n, bt, barrier, stream);
}

int vf_btd_exchange_probe_f64(void* sink, int n, int bt, int barrier, void* stream) {
  return launch_probe<double>(sink, n, bt, barrier, stream);
}

}  // extern "C"
