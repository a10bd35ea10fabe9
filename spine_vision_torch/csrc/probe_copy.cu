// HBM streaming probes: what a copy of device memory reaches on this card, by
// mechanism. Each kernel plays the part of one TPU mechanism that the
// scripts/probe_copy_bw*.py series timed:
//
//   copy_tiled   plain tiled loads and stores, a CTA per tile of rows, per
//                element or 16 bytes a thread (BlockSpec auto-pipelining:
//                probe_copy_bw.py::make_copy :36, probe_copy_bw2.py::auto_copy
//                :52 and its wide view, probe_copy_bw3.py::auto_copy :40)
//   copy_staged  a ring of S slots in shared memory filled by cp.async and
//                drained by stores, each thread its own 16-byte vectors (the
//                manual DMA ring through VMEM: probe_copy_bw2.py::manual_copy
//                :100, probe_copy_bw4.py::vmem_copy :84, and the double
//                buffering of probe_copy_bw5.py::emitpipe_copy :255)
//   copy_bulk    cp.async.bulk global -> shared with an mbarrier per slot,
//                then cp.async.bulk shared -> global, S slots a CTA, issued
//                by one thread: the copy engine, TMA's bulk form (the
//                HBM->HBM DMAs: probe_copy_bw2.py::hbm_dma_copy :122,
//                probe_copy_bw4.py::hbm_copy :124; split over two streams of
//                high and low priority, the DMA priorities of
//                probe_copy_bw5.py::vmem_prio_copy :140 and hbm_prio_split
//                :232, which Hopper has no per-copy counterpart of)
//   read_only    the same bulk ring without the write back; each CTA folds
//                every row r of its tiles into token row r mod 8 in f32, in
//                order, and a second pass adds the CTAs' sums in order, so
//                the token depends on every byte read
//                (probe_copy_bw5.py::read_only :85)
//   write_only   a seed row broadcast over the output, by plain 16-byte
//                stores or by cp.async.bulk from a shared slot
//                (probe_copy_bw5.py::write_only :187)
//   inc_copy     y = x + 1 in bf16 over two payloads, in one launch or two
//                (probe_copy_bw6.py::_copy_call :66)
//
// All of them are bound by device memory: they do no arithmetic worth the
// name, and the least time is the bytes read and written over 3.35 TB/s.
// cp.async.bulk needs 16-byte aligned addresses and sizes (the wrappers
// check) and sm_90.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int BAR_BYTES = 128;  // the mbarriers sit ahead of the slots

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
// Make the barriers' initialisation (and any shared-memory stores before it)
// visible to the bulk copies, which run in the async proxy.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// bytes from global to shared; completion is counted on the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// bytes from shared to global, in the thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until at most N of the thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// --- copy_tiled: CTA b copies units [b * per_cta, (b + 1) * per_cta). ---
template <typename V>
__global__ void __launch_bounds__(THREADS) copy_tiled(const V* __restrict__ x,
                                                      V* __restrict__ y, long long n,
                                                      long long per_cta) {
  const long long base = (long long)blockIdx.x * per_cta;
  const long long end = min(base + per_cta, n);
  for (long long i = base + threadIdx.x; i < end; i += (long long)THREADS * UNROLL) {
    V r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long j = i + (long long)u * THREADS;
      if (j < end) r[u] = x[j];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long j = i + (long long)u * THREADS;
      if (j < end) y[j] = r[u];
    }
  }
}

// --- copy_staged: tiles of slot_vec 16-byte vectors, CTA b taking tiles
// b, b + grid, ...; a thread cp.asyncs its own vectors of a tile into the
// tile's slot and later stores those same vectors, so no barrier is needed:
// cp.async.wait_group S-1 says the thread's oldest tile has landed.
template <int S>
__global__ void __launch_bounds__(THREADS) copy_staged(const uint4* __restrict__ x,
                                                       uint4* __restrict__ y, long long nvec,
                                                       int slot_vec) {
  extern __shared__ __align__(16) uint4 ring[];
  const long long ntiles = (nvec + slot_vec - 1) / slot_vec;
  auto load = [&](long long tile, int slot) {
    const long long base = tile * slot_vec;
    const int n = (int)min((long long)slot_vec, nvec - base);
    for (int v = threadIdx.x; v < n; v += THREADS)
      svt::cp_async16(reinterpret_cast<svt::bf16*>(ring + (size_t)slot * slot_vec + v),
                      reinterpret_cast<const svt::bf16*>(x + base + v));
  };
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const long long tile = blockIdx.x + (long long)s * gridDim.x;
    if (tile < ntiles) load(tile, s);
    svt::cp_async_commit();
  }
  int slot = 0;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 1) : "memory");
    const long long base = tile * slot_vec;
    const int n = (int)min((long long)slot_vec, nvec - base);
    for (int v = threadIdx.x; v < n; v += THREADS) y[base + v] = ring[(size_t)slot * slot_vec + v];
    const long long next = tile + (long long)S * gridDim.x;
    if (next < ntiles) load(next, slot);
    svt::cp_async_commit();
    slot = slot + 1 == S ? 0 : slot + 1;
  }
  svt::cp_async_wait_all();
}

// --- copy_bulk: one thread a CTA drives S slots of slot_bytes; tile i's
// store is issued when its load lands, and its slot is refilled (with tile
// i + S) once the next tile's store is under way and tile i's store has read
// the slot.
__global__ void copy_bulk(const char* __restrict__ x, char* __restrict__ y, long long nbytes,
                          int slot_bytes, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;
  const uint32_t bars = smem_addr(smem);
  const uint32_t slots = bars + BAR_BYTES;
  const long long ntiles = (nbytes + slot_bytes - 1) / slot_bytes;
  for (int s = 0; s < S; ++s) bar_init(bars + 8 * s);
  fence_async_shared();
  auto load = [&](long long i) {  // the CTA's i-th tile into slot i % S
    const long long tile = blockIdx.x + i * gridDim.x;
    if (tile >= ntiles) return;
    const long long off = tile * slot_bytes;
    const uint32_t bytes = (uint32_t)min((long long)slot_bytes, nbytes - off);
    const int s = (int)(i % S);
    bar_expect(bars + 8 * s, bytes);
    bulk_load(slots + (uint32_t)s * slot_bytes, x + off, bytes, bars + 8 * s);
  };
  for (int i = 0; i < S; ++i) load(i);
  for (long long i = 0;; ++i) {
    const long long tile = blockIdx.x + i * gridDim.x;
    if (tile >= ntiles) break;
    const int s = (int)(i % S);
    bar_wait(bars + 8 * s, (uint32_t)((i / S) & 1));
    const long long off = tile * slot_bytes;
    bulk_store(y + off, slots + (uint32_t)s * slot_bytes,
               (uint32_t)min((long long)slot_bytes, nbytes - off));
    if (i >= 1) {
      bulk_wait_read<1>();  // tile i - 1's store has read its slot
      load(i - 1 + S);
    }
  }
  bulk_wait_all();
}

// --- read_only: the bulk ring without the write back. All threads wait for
// a tile, add each of its 8-row groups in turn (8 * C values, f32) to their
// sums, and meet at a barrier before thread 0 refills the slot. A thread owns
// PAIRS bf16 pairs of the token (C = 64 * PAIRS), so its loop has no
// predicates, and each pair's sum takes the groups in order. CTA b owns the
// contiguous tiles [b * per_cta, (b + 1) * per_cta) and writes its sums to
// part[b]. tile_rows is a multiple of 8 and M of tile_rows (the wrapper
// checks).
template <int PAIRS>
__global__ void __launch_bounds__(THREADS) read_only(const svt::bf16* __restrict__ x,
                                                     float2* __restrict__ part, long long M,
                                                     int tile_rows, long long per_cta, int S) {
  constexpr int C = 64 * PAIRS;
  constexpr int TOKEN_PAIRS = 4 * C;  // 8 rows of C values, in pairs
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = smem_addr(smem);
  const __nv_bfloat162* slots = reinterpret_cast<const __nv_bfloat162*>(smem + BAR_BYTES);
  const uint32_t slots_addr = bars + BAR_BYTES;
  const long long ntiles = M / tile_rows;
  const long long first = (long long)blockIdx.x * per_cta;
  const long long count = max(0LL, min(per_cta, ntiles - first));
  const int slot_pairs = tile_rows * C / 2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) bar_init(bars + 8 * s);
    fence_async_shared();
  }
  __syncthreads();
  auto load = [&](long long i) {
    if (i >= count) return;
    const long long row0 = (first + i) * tile_rows;
    const int s = (int)(i % S);
    bar_expect(bars + 8 * s, (uint32_t)slot_pairs * 4);
    bulk_load(slots_addr + (uint32_t)s * slot_pairs * 4, x + row0 * C, (uint32_t)slot_pairs * 4,
              bars + 8 * s);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < S; ++i) load(i);
  float2 acc[PAIRS];
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) acc[j] = make_float2(0.f, 0.f);
  for (long long i = 0; i < count; ++i) {
    const int s = (int)(i % S);
    bar_wait(bars + 8 * s, (uint32_t)((i / S) & 1));
    const __nv_bfloat162* tile = slots + (size_t)s * slot_pairs + threadIdx.x;
#pragma unroll 4
    for (int g = 0; g < slot_pairs; g += TOKEN_PAIRS) {
#pragma unroll
      for (int j = 0; j < PAIRS; ++j) {
        const float2 v = __bfloat1622float2(tile[g + j * THREADS]);
        acc[j].x += v.x;
        acc[j].y += v.y;
      }
    }
    __syncthreads();  // every thread is done with slot s
    if (threadIdx.x == 0) load(i + S);
  }
#pragma unroll
  for (int j = 0; j < PAIRS; ++j)
    part[(size_t)blockIdx.x * TOKEN_PAIRS + threadIdx.x + j * THREADS] = acc[j];
}

// token[e] = sum over b = 0, 1, ... of part[b][e], in that order.
__global__ void token_sum(const float* __restrict__ part, float* __restrict__ token, int P,
                          int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  // Unrolled, the loads run ahead; the additions keep their order.
#pragma unroll 16
  for (int b = 0; b < P; ++b) s += part[(size_t)b * n + e];
  token[e] = s;
}

// --- write_only: out[m, c] = seed[0, c] over M rows. ---
__global__ void __launch_bounds__(THREADS) write_stores(const uint4* __restrict__ seed,
                                                        uint4* __restrict__ y, long long nvec,
                                                        int row_vec) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < nvec; i += stride)
    y[i] = seed[i % row_vec];
}

// A shared slot of tile_rows copies of the seed row, stored by one thread
// over the CTA's tiles with at most 8 bulk stores in flight.
__global__ void __launch_bounds__(THREADS) write_bulk(const uint4* __restrict__ seed,
                                                      char* __restrict__ y, long long nbytes,
                                                      int row_vec, int slot_bytes) {
  extern __shared__ __align__(128) uint4 slot[];
  for (int v = threadIdx.x; v < slot_bytes / 16; v += THREADS) slot[v] = seed[v % row_vec];
  fence_async_shared();
  __syncthreads();
  if (threadIdx.x != 0) return;
  const long long ntiles = (nbytes + slot_bytes - 1) / slot_bytes;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long off = tile * slot_bytes;
    bulk_store(y + off, smem_addr(slot), (uint32_t)min((long long)slot_bytes, nbytes - off));
    bulk_wait_read<7>();
  }
  bulk_wait_all();
}

// --- inc_copy: ya = xa + 1 (and yb = xb + 1 where xb is given) in bf16
// arithmetic (f32 sum rounded once). With dep, each value also adds
// 0 * dep[0]: a data dependence on an earlier launch's output. ---
__global__ void __launch_bounds__(THREADS) inc_copy(const uint4* __restrict__ xa,
                                                    uint4* __restrict__ ya,
                                                    const uint4* __restrict__ xb,
                                                    uint4* __restrict__ yb, long long nvec,
                                                    const svt::bf16* __restrict__ dep) {
  const long long total = xb ? 2 * nvec : nvec;
  const float zero = dep ? 0.f * __bfloat162float(dep[0]) : 0.f;
  const long long base = (long long)blockIdx.x * THREADS * UNROLL + threadIdx.x;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long i = base + (long long)u * THREADS;
    if (i >= total) continue;
    const bool second = i >= nvec;
    uint4 v = second ? xb[i - nvec] : xa[i];
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(p[k]);
      p[k] = __floats2bfloat162_rn(f.x + 1.f + zero, f.y + 1.f + zero);
    }
    if (second)
      yb[i - nvec] = v;
    else
      ya[i] = v;
  }
}

int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename V>
int launch_tiled(const void* x, void* y, long long n, long long per_cta, cudaStream_t s) {
  copy_tiled<V><<<(unsigned)((n + per_cta - 1) / per_cta), THREADS, 0, s>>>((const V*)x, (V*)y,
                                                                          n, per_cta);
  return (int)cudaGetLastError();
}

template <int S>
int launch_staged(const void* x, void* y, long long nvec, int slot_vec, int grid,
                  cudaStream_t s) {
  const size_t smem = (size_t)S * slot_vec * 16;
  int err = set_smem((const void*)copy_staged<S>, smem);
  if (err) return err;
  copy_staged<S><<<grid, THREADS, smem, s>>>((const uint4*)x, (uint4*)y, nvec, slot_vec);
  return (int)cudaGetLastError();
}

template <int PAIRS>
int launch_read_only(const void* x, void* part, void* token, long long M, int tile_rows,
                     long long per_cta, int S, int grid, cudaStream_t s) {
  const size_t smem = BAR_BYTES + (size_t)S * tile_rows * 64 * PAIRS * 2;
  int err = set_smem((const void*)read_only<PAIRS>, smem);
  if (err) return err;
  read_only<PAIRS><<<grid, THREADS, smem, s>>>((const svt::bf16*)x, (float2*)part, M, tile_rows,
                                                per_cta, S);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int n = 8 * 64 * PAIRS;
  token_sum<<<(n + 255) / 256, 256, 0, s>>>((const float*)part, (float*)token, grid, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Persistent grid of a probe kernel: the card's SMs times the CTAs of
// `threads` threads and `smem` bytes of dynamic shared memory that fit on
// one (kind 0 copy_staged<2>, 1 copy_bulk, 2 read_only<2>, 3 write_bulk; the
// stage count of copy_staged and the width of read_only do not change their
// occupancy for a given smem).
extern "C" int svt_probe_grid(int kind, int threads, long long smem) {
  const void* fns[] = {(const void*)copy_staged<2>, (const void*)copy_bulk,
                       (const void*)read_only<2>, (const void*)write_bulk};
  if (kind < 0 || kind > 3) return -1;
  if (set_smem(fns[kind], (size_t)smem)) return -1;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fns[kind], threads, (size_t)smem))
    return -1;
  return sms * per_sm;
}

// y = x over n units of `unit` bytes (1, 2, 4 or 16), per_cta units a CTA.
extern "C" int svt_probe_copy_tiled(const void* x, void* y, long long n, long long per_cta,
                                    int unit, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (unit) {
    case 1: return launch_tiled<uint8_t>(x, y, n, per_cta, s);
    case 2: return launch_tiled<uint16_t>(x, y, n, per_cta, s);
    case 4: return launch_tiled<float>(x, y, n, per_cta, s);
    case 16: return launch_tiled<uint4>(x, y, n, per_cta, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// y = x over nvec 16-byte vectors through S slots of slot_vec vectors.
extern "C" int svt_probe_copy_staged(const void* x, void* y, long long nvec, int slot_vec,
                                     int S, int grid, void* stream) {
  if (nvec == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (S) {
    case 2: return launch_staged<2>(x, y, nvec, slot_vec, grid, s);
    case 3: return launch_staged<3>(x, y, nvec, slot_vec, grid, s);
    case 4: return launch_staged<4>(x, y, nvec, slot_vec, grid, s);
    case 8: return launch_staged<8>(x, y, nvec, slot_vec, grid, s);
    case 12: return launch_staged<12>(x, y, nvec, slot_vec, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// y = x over nbytes (a multiple of 16) through S (<= 16) bulk slots of
// slot_bytes (a multiple of 16) a CTA.
extern "C" int svt_probe_copy_bulk(const void* x, void* y, long long nbytes, int slot_bytes,
                                   int S, int grid, void* stream) {
  if (nbytes == 0) return 0;
  if (nbytes % 16 || slot_bytes % 16 || S < 1 || S > 16) return (int)cudaErrorInvalidValue;
  const size_t smem = BAR_BYTES + (size_t)S * slot_bytes;
  int err = set_smem((const void*)copy_bulk, smem);
  if (err) return err;
  copy_bulk<<<grid, 32, smem, (cudaStream_t)stream>>>((const char*)x, (char*)y, nbytes,
                                                      slot_bytes, S);
  return (int)cudaGetLastError();
}

// token [8, C] f32 = in-order sums of the 8-row groups of x [M, C] bf16
// (C = 64, 128, 256, 512 or 1024; whole tiles of tile_rows, a multiple of 8;
// S <= 16 slots), grid CTAs of per_cta consecutive tiles each; part is
// [grid, 8, C] f32 scratch.
extern "C" int svt_probe_read_only(const void* x, void* part, void* token, long long M, int C,
                                   int tile_rows, long long per_cta, int S, int grid,
                                   void* stream) {
  if (tile_rows < 8 || tile_rows % 8 || M % tile_rows || S < 1 || S > 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 64: return launch_read_only<1>(x, part, token, M, tile_rows, per_cta, S, grid, s);
    case 128: return launch_read_only<2>(x, part, token, M, tile_rows, per_cta, S, grid, s);
    case 256: return launch_read_only<4>(x, part, token, M, tile_rows, per_cta, S, grid, s);
    case 512: return launch_read_only<8>(x, part, token, M, tile_rows, per_cta, S, grid, s);
    case 1024: return launch_read_only<16>(x, part, token, M, tile_rows, per_cta, S, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// y [nbytes / row_bytes, row] = the first row of seed (row_vec 16-byte
// vectors), by plain stores (bulk 0) or bulk stores from a slot of
// slot_bytes (bulk 1, a whole number of rows).
extern "C" int svt_probe_write_only(const void* seed, void* y, long long nbytes, int row_vec,
                                    int bulk, int slot_bytes, int grid, void* stream) {
  if (nbytes == 0) return 0;
  if (nbytes % (16LL * row_vec)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!bulk) {
    write_stores<<<grid, THREADS, 0, s>>>((const uint4*)seed, (uint4*)y, nbytes / 16, row_vec);
    return (int)cudaGetLastError();
  }
  if (slot_bytes % (16 * row_vec)) return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)write_bulk, (size_t)slot_bytes);
  if (err) return err;
  write_bulk<<<grid, THREADS, slot_bytes, s>>>((const uint4*)seed, (char*)y, nbytes, row_vec,
                                               slot_bytes);
  return (int)cudaGetLastError();
}

// ya = xa + 1 and, with xb, yb = xb + 1, over n bf16 values each (n a
// multiple of 8); dep (may be null) as inc_copy above.
extern "C" int svt_probe_inc_copy(const void* xa, void* ya, const void* xb, void* yb,
                                  long long n, const void* dep, void* stream) {
  if (n == 0) return 0;
  if (n % 8) return (int)cudaErrorInvalidValue;
  const long long nvec = n / 8;
  const long long total = xb ? 2 * nvec : nvec;
  const long long per = (long long)THREADS * UNROLL;
  inc_copy<<<(unsigned)((total + per - 1) / per), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)xa, (uint4*)ya, (const uint4*)xb, (uint4*)yb, nvec,
      (const svt::bf16*)dep);
  return (int)cudaGetLastError();
}
