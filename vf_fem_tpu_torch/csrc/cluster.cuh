// What K6 and K6T (btd.cu) and the measurement of their exchange
// (btd_exchange_probe.cu) share: K6's launch plan (K6T's is make_t_plan in
// btd.cu), the PTX of thread-block clusters, mbarriers and distributed
// shared memory, and the cluster launch.  cuda_build hashes this header
// into every source's build.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace vf_btd {

constexpr int kSmemLimit = 232448;  // Hopper's opt-in shared memory a CTA
constexpr int kMaxWarps = 16;       // consumer warps a CTA
constexpr int kMaxStages = 16;      // ring slots
constexpr int kBarBytes = (2 * kMaxStages + 2) * 8;

// CTAs a cluster for factors of `es` bytes: the faster of 8 and 16 at 93 row
// blocks of 256 on an H100 (PERF.md section 6 records the comparison)
__host__ __device__ constexpr int cluster_size(int es) { return es == 8 ? 16 : 8; }

// bytes of an entry of the carried vector for factors of `es` bytes: the
// factor type, except for fp8 factors, whose products take the vector in
// bf16 (never quantized to fp8: the vector is the solve's residual)
__host__ __device__ constexpr int carry_size(int es) { return es == 1 ? 2 : es; }

// The launch plan of one (factor element size, Bt); mirrored by
// ops.kernels.sweep_plan (vf_btd_sweep_plan returns it for the comparison).
struct Plan {
  int cluster;           // C CTAs
  int rows_per_cta;      // R = Bt / C
  int rows_per_warp;     // RPW: a whole 32-bit word of the carried vector
  int warps;             // W consumer warps (one producer warp besides)
  int stage_rows;        // RS = W * RPW rows a ring slot
  int stages_per_block;  // SPB = R / RS
  int ring;              // slots
  int smem;              // dynamic shared memory bytes
  int threads;           // (W + 1) * 32
};

// ring slots of `rows` rows of Bt entries that fit beside the carried
// vector's two buffers and the mbarriers
__host__ __device__ constexpr int ring_room(int es, int bt, int rows) {
  return (kSmemLimit - 2 * bt * carry_size(es) - kBarBytes) / (rows * bt * es);
}

__host__ __device__ constexpr Plan make_plan(int es, int bt) {
  Plan p{};
  p.cluster = cluster_size(es);
  p.rows_per_cta = bt / p.cluster;
  const int xes = carry_size(es);
  p.rows_per_warp = xes < 4 ? 4 / xes : 1;
  const int units = p.rows_per_cta / p.rows_per_warp;
  // the most warps, up to kMaxWarps, that divide the units and leave a ring
  // of at least two slots, so that the factor stream runs ahead of the chain
  // (at Bt = 1280 in f64, 16 rows a slot would leave one: 10 rows leave two)
  int w = 1;
  for (int d = 1; d <= kMaxWarps && d <= units; ++d)
    if (units % d == 0 && ring_room(es, bt, d * p.rows_per_warp) >= 2) w = d;
  p.warps = w;
  p.stage_rows = w * p.rows_per_warp;
  p.stages_per_block = p.rows_per_cta / p.stage_rows;
  const int stage_bytes = p.stage_rows * bt * es;
  const int room = ring_room(es, bt, p.stage_rows);
  p.ring = room < kMaxStages ? room : kMaxStages;
  p.smem = p.ring * stage_bytes + 2 * bt * xes + kBarBytes;
  p.threads = (w + 1) * 32;
  return p;
}

template <typename TA, int BT>
struct Geometry {
  static constexpr int ES = static_cast<int>(sizeof(TA));
  static constexpr int XES = carry_size(ES);  // bytes of a carried entry
  static constexpr Plan P = make_plan(ES, BT);
  static constexpr int C = P.cluster;
  static constexpr int R = P.rows_per_cta;
  static constexpr int RPW = P.rows_per_warp;
  static constexpr int W = P.warps;
  static constexpr int RS = P.stage_rows;
  static constexpr int SPB = P.stages_per_block;
  static constexpr int NST = P.ring;
  static constexpr int SMEM = P.smem;
  static constexpr int THREADS = P.threads;
  static constexpr int STAGE_BYTES = RS * BT * ES;
  static constexpr int XS_OFFSET = NST * STAGE_BYTES;
  static constexpr int BAR_OFFSET = XS_OFFSET + 2 * BT * XES;
  static constexpr int WORDS = RPW * XES / 4;  // words a lane pushes a stage
  static_assert(BT % C == 0 && R % RPW == 0 && R % RS == 0, "no row partition");
  static_assert(NST >= 2 && SMEM <= kSmemLimit, "ring does not fit");
  static_assert(C <= 32 && RPW * XES % 4 == 0, "bad push");
};

// the carried vector's values v[0 .. N) as little-endian 32-bit words
template <int N>
__device__ __forceinline__ void to_words(const __nv_bfloat16* v, uint32_t* w) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j)
    w[j] = static_cast<uint32_t>(__bfloat16_as_ushort(v[2 * j])) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(v[2 * j + 1])) << 16);
}
template <int N>
__device__ __forceinline__ void to_words(const float* v, uint32_t* w) {
#pragma unroll
  for (int j = 0; j < N; ++j) w[j] = __float_as_uint(v[j]);
}
template <int N>
__device__ __forceinline__ void to_words(const double* v, uint32_t* w) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    w[2 * j] = static_cast<uint32_t>(__double2loint(v[j]));
    w[2 * j + 1] = static_cast<uint32_t>(__double2hiint(v[j]));
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// the shared::cluster address of `addr` (a shared::cta address) in CTA `rank`
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

template <bool kClusterScope>
__device__ __forceinline__ bool mbar_try_wait(unsigned addr, unsigned parity) {
  unsigned ok;
  if constexpr (kClusterScope) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(addr), "r"(parity)
        : "memory");
  } else {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(addr), "r"(parity)
        : "memory");
  }
  return ok != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// wait for the completion of the phase of parity `parity`; a wait that
// lasts seconds is a fault of the kernel, and traps rather than hangs
template <bool kClusterScope>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned spins = 0;
  unsigned long long t0 = 0;
  while (!mbar_try_wait<kClusterScope>(addr, parity)) {
    if ((++spins & 0xFFFFu) == 0) {
      const unsigned long long now = global_ns();
      if (t0 == 0) {
        t0 = now;
      } else if (now - t0 > 2000000000ull) {
        __trap();
      }
    }
  }
}

// store one 32-bit word at `remote` (a shared::cluster address) and count
// its 4 bytes on the mbarrier `bar` of the same CTA (shared::cluster)
__device__ __forceinline__ void st_async_word(unsigned remote, uint32_t word,
                                              unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
          remote),
      "r"(word), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_cluster_word(unsigned remote, uint32_t word) {
  asm volatile("st.shared::cluster.b32 [%0], %1;\n" ::"r"(remote), "r"(word) : "memory");
}

// lane p < C pushes `words` into CTA p at `dst` (a shared::cta address in
// the pusher's own layout, which every CTA shares), counted on `bar`;
// kBarrier: plain remote stores, ordered by a cluster barrier instead
template <int C, int WORDS, bool kBarrier>
__device__ __forceinline__ void push_words(const uint32_t* w, const void* dst,
                                           uint64_t* bar, int lane) {
  if (lane >= C) return;
  const unsigned d = map_rank(smem_addr(dst), lane);
  if constexpr (kBarrier) {
#pragma unroll
    for (int j = 0; j < WORDS; ++j) st_cluster_word(d + 4 * j, w[j]);
  } else {
    const unsigned b = map_rank(smem_addr(bar), lane);
#pragma unroll
    for (int j = 0; j < WORDS; ++j) st_async_word(d + 4 * j, w[j], b);
  }
}

// `copies` clusters (1 by default) of `cluster` CTAs of `threads` threads;
// cluster k is CTAs [k cluster, (k + 1) cluster) of the grid
inline void cluster_config(int threads, int smem, int cluster, void* stream,
                           cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                           int copies = 1) {
  cfg = {};
  cfg.gridDim = dim3(cluster * copies, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

// the kernel's attributes: its dynamic shared memory and, above 8 CTAs,
// the non-portable cluster size
template <typename Kernel>
cudaError_t set_attributes(Kernel kernel, int smem, int cluster) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

}  // namespace vf_btd

// Bt = h * 128 for the block-banded plans of b = 128, the widths K6 and K6T
// (btd.cu) are built for: h = 1 .. 4 (the 2D meshes; 2Bt of the complex
// embedding at h = 1, 2) and h = 10 (the 45.8k-dof extruded 3D mesh).
#define VF_BT_SWITCH(CALL)                                   \
  switch (bt) {                                              \
    case 128: return CALL(128);                              \
    case 256: return CALL(256);                              \
    case 384: return CALL(384);                              \
    case 512: return CALL(512);                              \
    case 1280: return CALL(1280);                            \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
