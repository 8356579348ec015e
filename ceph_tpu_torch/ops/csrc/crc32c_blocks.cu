// crc32c (Castagnoli, reflected 0x82F63B78, ceph's seed convention: the
// caller's seed, no final xor) of every fixed-size block of a buffer (K2).
//
// Replaces: ceph_tpu/ops/crc32c.py `_crc_blocks_jit` (:95-107). The TPU
// program treats each block's crc as an affine GF(2) map: bit-planes of the
// block times the (8*bs, 32) bitmatrix L on the int8 matrix unit, & 1,
// pack 32 bits, XOR the seed constant.
//
// The algebra: the block is cut into 32 segments of seg = ceil(bs/32)
// bytes, one a lane of the block's warp. Each lane runs a table crc with
// init 0 over its segment, then advances it over the bytes that follow the
// segment by multiplying with Z^(bs - end) (Z: the 32x32 GF(2) "one zero
// byte" operator; the 32 columns of each lane's power come from the host).
// crc_0 is linear, so the advanced values XOR to crc_0 of the block: the
// warp reduces its lanes with __shfl_xor_sync and XORs the seed constant
// crc(seed, zero block).
//
// What bounded the first design (one warp per block, 8 warps per CTA, the
// flat [4][256] tables in shared memory): every table lookup is one 32-bit
// word per input byte at an index that depends on the data, so the 32
// lanes of a warp hit random banks and each lookup instruction replays
// about 3.5 times. One lookup per byte then gives about 32 bytes per 3.5
// cycles per SM, ~2.1 TB/s on 132 SMs at ~1.75 GHz before any other
// cost; it ran at 1.42 TB/s (0.1887 ms for 2^16 x 4 KiB on an H100 SXM,
// 42.6% of the 3.35 TB/s HBM bound). Each lane also read its own 128-byte
// run 16 bytes at a time, so a warp load touched 32 lines.
//
// This design:
// - Bank-private tables: the slice-by-4 tables are laid out
//   [slice][entry][lane] (4 x 256 x 32 words, 128 KiB of dynamic shared
//   memory), so lane l always reads bank l and no lookup conflicts. Each
//   CTA expands the flat 4 KiB tables into this layout once. They start on
//   a 32 KiB boundary of the shared window, so a lookup's address is one
//   shift and one mask-and-or of the crc, with the slice in the load's
//   immediate offset (14 instructions for 4 bytes, 4 of them lookups).
// - Persistent CTAs: one CTA of kWarps warps per SM (the tables leave room
//   for one), grid = min(SM count, B), so the expansion is paid once per
//   SM. In pass p warp w of CTA c takes block p * grid * kWarps + w * grid
//   + c: a launch of a few hundred blocks spreads over every SM instead of
//   filling a few. Each CTA issues all of its expansion loads before its
//   stores.
// - Coalesced reads: on the 16-byte path each warp copies the coming
//   rounds of its segments (kQ 16-byte words a lane at most) into shared
//   memory with cp.async, 16 bytes a lane on neighbouring addresses,
//   kStages - 1 rounds ahead of the round its lanes hash (the first while
//   the tables are expanded); the words of a lane's row are XOR-swizzled so
//   that the lanes' 16-byte reads and the copies' writes hit all banks.
// - Each lane keeps its segment's 32 advance columns in registers.
// The 16-byte path needs bs a multiple of 512 and a 16-byte aligned base;
// otherwise every lane reads its segment byte by byte from device memory
// (any bs, including bs < 32). All offsets are 64-bit: 2^20 blocks of
// 4 KiB are 2^32 bytes.
//
// What bounds it now: at 2^16 x 4 KiB it runs at 76-84% of the HBM bound
// on the card (H100 SXM; the spread is between runs, not within one),
// near the rate a torch sum over the same bytes reaches. Staging deeper (3-4 rounds) and hashing two blocks per
// warp did not raise it; more warps per SM did, a little, and the tables
// leave room for 16 with two 2 KiB stages each. What is left is the
// dependent chain of lookups per lane across 16 warps, and the memory
// system. At a few hundred blocks a launch takes ~5 us on the card, most
// of it launch, the 128 KiB expansion and one round trip to memory;
// splitting a block over 2 or 4 warps saved ~0.25 us at 256 blocks and
// lost at 1024 and more, so a block has one warp. PERF.md has the
// measurements behind each of these.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;                    // warps per CTA, one CTA per SM
constexpr int kThreads = kWarps * 32;
constexpr int kQ = 4;                         // most 16-byte words a lane stages per round
constexpr int kStages = 2;                    // rounds staged per warp (kStages - 1 ahead)
constexpr int kTableWords = 4 * 256 * 32;     // [slice][entry][lane]
constexpr int kStageWords = 32 * kQ;          // uint4 per warp and stage
constexpr size_t kStagingBytes = (size_t)kWarps * kStages * kStageWords * 16;
// staging, then the tables at the next 32 KiB boundary of the shared
// window (at most 32 KiB - 16 further on)
constexpr size_t kSmemBytes = kStagingBytes + 0x7ff0 + kTableWords * 4;
static_assert(kQ == 1 || kQ == 2 || kQ == 4 || kQ == 8, "kQ: a power of 2 <= 8");
static_assert(kSmemBytes <= 232448, "over the 227 KiB a CTA may use");
constexpr int kMaxDevices = 64;

// One table word: `addr` is a shared-window address, kOff a byte offset.
template <unsigned kOff>
__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm("ld.shared.u32 %0, [%1+%2];" : "=r"(v) : "r"(addr), "n"(kOff));
  return v;
}

// Entry e of slice s for this lane lies at byte s*32768 + e*128 + lane*4
// of the tables. The tables start on a 32 KiB boundary of the shared
// window, so with tb = their address | lane*4 (bits 7-14 clear) a byte of
// the crc becomes an address in two operations: shift, then mask-and-or.
__device__ __forceinline__ uint32_t step1(uint32_t tb, uint32_t c) {
  return lds<0>(((c << 7) & 0x7f80u) | tb) ^ (c >> 8);
}

__device__ __forceinline__ uint32_t step4(uint32_t tb, uint32_t c) {
  return lds<0x18000>(((c << 7) & 0x7f80u) | tb) ^
         lds<0x10000>(((c >> 1) & 0x7f80u) | tb) ^
         lds<0x8000>(((c >> 9) & 0x7f80u) | tb) ^
         lds<0>(((c >> 17) & 0x7f80u) | tb);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Advance the lane's crc_0 by its segment's Z power, XOR the warp's lanes
// and the seed constant, and store.
__device__ __forceinline__ void finish(const uint32_t (&adv)[32], uint32_t crc,
                                       long long blk, long long nblocks,
                                       int lane, uint32_t cst, long long* out) {
  uint32_t r = 0u;
#pragma unroll
  for (int bit = 0; bit < 32; ++bit) r ^= adv[bit] & (0u - ((crc >> bit) & 1u));
#pragma unroll
  for (int off = 16; off; off >>= 1) r ^= __shfl_xor_sync(0xffffffffu, r, off);
  if (lane == 0 && blk < nblocks) out[blk] = (long long)(r ^ cst);
}

__global__ void __launch_bounds__(kThreads, 1)
crc32c_blocks_kernel(const uint8_t* __restrict__ data, long long nblocks,
                     long long bs,
                     const uint32_t* __restrict__ tables,   // [4][256]
                     const uint32_t* __restrict__ advance,  // [32 bit][32 lane]
                     uint32_t cst, long long* __restrict__ out, int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint4* staging = reinterpret_cast<uint4*>(smem);
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t t0 = (s0 + (uint32_t)kStagingBytes + 0x7fffu) & ~0x7fffu;
  uint4* T = reinterpret_cast<uint4*>(smem + (t0 - s0));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // pass p gives this warp block p * stride + mine
  const long long stride = (long long)gridDim.x * kWarps;
  const long long passes = (nblocks + stride - 1) / stride;
  const long long mine = (long long)warp * gridDim.x + blockIdx.x;
  const long long seg = (bs + 31) / 32;
  uint32_t adv[32];
#pragma unroll
  for (int bit = 0; bit < 32; ++bit) adv[bit] = advance[bit * 32 + lane];
  const uint32_t tb = t0 | (uint32_t)(lane << 2);

  // 16-byte path: seg = bs / 32 is a multiple of 16. A round stages q
  // words of each of the warp's 32 segments: copy k = i*32 + lane moves word
  // m = k % q of segment L = k / q, so neighbouring lanes read neighbouring
  // addresses, into slot L*q + (m ^ sw(L)) of the stage, sw(L) = (L >>
  // (3 - log2 q)) & (q - 1): any 8 lanes' 16-byte slots then fall in 8
  // distinct groups of 4 banks. Lane L reads its q words from there.
  const long long words = seg / 16;
  int lq = 0;                                      // q: the largest power of
  while ((2 << lq) <= kQ && words % (2 << lq) == 0) ++lq;   // 2 <= kQ
  const int q = 1 << lq;                                     // dividing words
  const long long rounds = words / q;
  uint4* stage = staging + (size_t)warp * kStages * kStageWords;

  long long ig = 0, ir = 0;                        // the next round to stage
  int ibuf = 0;
  auto stage_next = [&]() {
    const long long blk = ig * stride + mine;
    if (ig < passes && blk < nblocks) {
      const uint8_t* src = data + blk * bs + ir * q * 16;
      uint4* dst = stage + ibuf * kStageWords;
      for (int i = 0; i < q; ++i) {
        const int k = i * 32 + lane, L = k >> lq, m = k & (q - 1);
        const int sw = (L >> (3 - lq)) & (q - 1);
        cp_async16(dst + L * q + (m ^ sw), src + (long long)L * seg + m * 16);
      }
    }
    cp_async_commit();
    ibuf = ibuf + 1 == kStages ? 0 : ibuf + 1;
    if (++ir == rounds) {
      ir = 0;
      ++ig;
    }
  };

  if (vec)             // the first rounds arrive while the tables are expanded
    for (int i = 0; i < kStages - 1; ++i) stage_next();

  // uint4 i holds words 4i..4i+3: entry i >> 3 of the flat tables, for 4
  // lanes. All of a thread's loads are issued before its stores.
  {
    constexpr int kFill = kTableWords / 4 / kThreads;
    static_assert(kFill * kThreads * 4 == kTableWords, "whole fill rounds");
    uint32_t v[kFill];
#pragma unroll
    for (int j = 0; j < kFill; ++j)
      v[j] = __ldg(tables + ((threadIdx.x + j * kThreads) >> 3));
#pragma unroll
    for (int j = 0; j < kFill; ++j)
      T[threadIdx.x + j * kThreads] = make_uint4(v[j], v[j], v[j], v[j]);
  }

  __syncthreads();

  if (!vec) {  // any bs and base: each lane reads its segment byte by byte
    long long start = (long long)lane * seg;
    if (start > bs) start = bs;
    long long end = start + seg;
    if (end > bs) end = bs;
    for (long long g = 0; g < passes; ++g) {
      const long long blk = g * stride + mine;
      uint32_t crc = 0u;
      if (blk < nblocks) {
        const uint8_t* p = data + blk * bs;
        for (long long i = start; i < end; ++i)
          crc = step1(tb, crc ^ p[i]);
      }
      finish(adv, crc, blk, nblocks, lane, cst, out);
    }
    return;
  }

  int buf = 0;
  const int sw = (lane >> (3 - lq)) & (q - 1);
  for (long long g = 0; g < passes; ++g) {
    const long long blk = g * stride + mine;
    uint32_t crc = 0u;
    for (long long r = 0; r < rounds; ++r) {
      stage_next();   // into the stage every lane finished with last round
      cp_async_wait<kStages - 1>();
      __syncwarp();
      if (blk < nblocks) {
        const uint4* w = stage + buf * kStageWords + lane * q;
#pragma unroll
        for (int m = 0; m < kQ; ++m) {
          if (m >= q) break;
          const uint4 v = w[m ^ sw];
          crc = step4(tb, crc ^ v.x);
          crc = step4(tb, crc ^ v.y);
          crc = step4(tb, crc ^ v.z);
          crc = step4(tb, crc ^ v.w);
        }
      }
      __syncwarp();
      buf = buf + 1 == kStages ? 0 : buf + 1;
    }
    finish(adv, crc, blk, nblocks, lane, cst, out);
  }
  cp_async_wait<0>();
}

int g_sms[kMaxDevices];           // SM count by device, 0 until read
bool g_smem_set[kMaxDevices];     // the dynamic shared memory limit raised

cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < kMaxDevices && g_sms[dev] > 0) {
    *sms = g_sms[dev];
    return cudaSuccess;
  }
  rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess && dev < kMaxDevices) g_sms[dev] = *sms;
  return rc;
}

}  // namespace

extern "C" {

// out[b] (int64 holding a uint32) = crc32c of block b of data (nblocks, bs),
// one warp a block. `tables` are the flat slice-by-4 tables [4][256],
// `advance` the [32 bit][32 lane] columns of Z^(bs - end of the lane's
// segment) for segments of ceil(bs / 32) bytes, `cst` = crc(seed, bs zero
// bytes). Runs on the current device and
// `stream`; returns the first CUDA error of reading the device, raising
// its shared-memory limit, or the launch.
int crc32c_blocks_run(const void* data, long long nblocks, long long bs,
                      const void* tables, const void* advance,
                      long long cst, void* out, void* stream) {
  if (nblocks <= 0) return (int)cudaSuccess;
  if (bs <= 0) return (int)cudaErrorInvalidValue;
  int sms = 0, dev = 0;
  cudaError_t rc = device_sms(&sms);
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess && !(dev < kMaxDevices && g_smem_set[dev])) {
    rc = cudaFuncSetAttribute(crc32c_blocks_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kSmemBytes);
    if (rc == cudaSuccess && dev < kMaxDevices) g_smem_set[dev] = true;
  }
  if (rc != cudaSuccess) return (int)rc;
  const unsigned grid = (unsigned)(nblocks < sms ? nblocks : sms);
  const int vec = bs % 512 == 0 && (uintptr_t)data % 16 == 0;
  crc32c_blocks_kernel<<<grid, kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), nblocks, bs,
      static_cast<const uint32_t*>(tables),
      static_cast<const uint32_t*>(advance), (uint32_t)cst,
      static_cast<long long*>(out), vec);
  return (int)cudaGetLastError();
}

const char* crc32c_blocks_strerror(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"
