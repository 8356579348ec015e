// crc32c (Castagnoli, reflected 0x82F63B78, ceph's seed convention: the
// caller's seed, no final xor) of every fixed-size block of a buffer (K2).
//
// Replaces: ceph_tpu/ops/crc32c.py `_crc_blocks_jit` (:95-107). The TPU
// program treats each block's crc as an affine GF(2) map: bit-planes of the
// block times the (8*bs, 32) bitmatrix L on the int8 matrix unit, & 1,
// pack 32 bits, XOR the seed constant.
//
// What bounds it on an H100: device-memory bytes. It reads B*bs bytes and
// writes 8 per block; at bs = 4096 the table form below does about 2
// integer operations and one shared-memory lookup per byte.
//
// Design: one warp per block. Lane l takes the contiguous segment
// [l*seg, min((l+1)*seg, bs)) with seg = ceil(bs/32), so any block size
// works and the last segments may be short or empty. Each lane runs a
// table crc with init 0 over its segment (slice-by-4 on 16-byte loads when
// bs is a multiple of 512 and the buffer is 16-byte aligned, else byte by
// byte), then advances it over the bytes that follow its segment by
// multiplying with Z^(bs - end), Z being the 32x32 GF(2) "one zero byte"
// operator; the 32 columns of each lane's Z power are computed on the host.
// crc_0 is linear, so the warp XOR-reduces the advanced values with
// __shfl_xor_sync and lane 0 XORs the seed constant crc(seed, zero block).
// The tables (4 KiB) and the advance columns (4 KiB, laid out [bit][lane]
// so a warp's reads fall in 32 distinct banks) live in shared memory. All
// offsets are 64-bit: 2^20 blocks of 4 KiB are 2^32 bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

// Four bytes at once: T is the slice-by-4 tables [4][256], flattened.
__device__ __forceinline__ uint32_t step4(const uint32_t* T, uint32_t c) {
  return T[768 + (c & 0xffu)] ^ T[512 + ((c >> 8) & 0xffu)] ^
         T[256 + ((c >> 16) & 0xffu)] ^ T[c >> 24];
}

__global__ void __launch_bounds__(kWarps * 32)
crc32c_blocks_kernel(const uint8_t* __restrict__ data, long long nblocks,
                     long long bs, long long seg,
                     const uint32_t* __restrict__ tables,   // [4][256]
                     const uint32_t* __restrict__ advance,  // [32 bit][32 lane]
                     uint32_t cst, long long* __restrict__ out, int vec) {
  __shared__ uint32_t T[4 * 256];
  __shared__ uint32_t A[32 * 32];
  for (int t = threadIdx.x; t < 1024; t += blockDim.x) {
    T[t] = tables[t];
    A[t] = advance[t];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long blk = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (blk >= nblocks) return;  // whole warp: blk is uniform across it

  long long start = (long long)lane * seg;
  if (start > bs) start = bs;
  long long end = start + seg;
  if (end > bs) end = bs;
  const uint8_t* p = data + blk * bs;
  uint32_t crc = 0u;
  long long i = start;
  if (vec) {
    for (; i + 16 <= end; i += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
      crc = step4(T, crc ^ v.x);
      crc = step4(T, crc ^ v.y);
      crc = step4(T, crc ^ v.z);
      crc = step4(T, crc ^ v.w);
    }
  }
  for (; i < end; ++i) crc = T[(crc ^ p[i]) & 0xffu] ^ (crc >> 8);

  uint32_t r = 0u;
#pragma unroll
  for (int bit = 0; bit < 32; ++bit)
    r ^= (0u - ((crc >> bit) & 1u)) & A[bit * 32 + lane];
#pragma unroll
  for (int off = 16; off; off >>= 1) r ^= __shfl_xor_sync(0xffffffffu, r, off);
  if (lane == 0) out[blk] = (long long)(r ^ cst);
}

}  // namespace

extern "C" {

// out[b] (int64 holding a uint32) = crc32c of block b of data (nblocks, bs).
// `tables` are the slice-by-4 tables, `advance` the per-lane Z^(bs - end)
// columns for seg = ceil(bs / 32), `cst` = crc(seed, bs zero bytes).
// Returns cudaGetLastError() after the launch.
int crc32c_blocks_run(const void* data, long long nblocks, long long bs,
                      const void* tables, const void* advance,
                      long long cst, void* out, void* stream) {
  if (nblocks <= 0) return (int)cudaSuccess;
  if (bs <= 0) return (int)cudaErrorInvalidValue;
  const long long seg = (bs + 31) / 32;
  const int vec = bs % 512 == 0 && (uintptr_t)data % 16 == 0;
  const long long blocks = (nblocks + kWarps - 1) / kWarps;
  crc32c_blocks_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), nblocks, bs, seg,
      static_cast<const uint32_t*>(tables),
      static_cast<const uint32_t*>(advance), (uint32_t)cst,
      static_cast<long long*>(out), vec);
  return (int)cudaGetLastError();
}

const char* crc32c_blocks_strerror(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"
