// GF(2^8) matrix apply over byte streams: out[s][i] = XOR_j M[i][j] * data[s][j]
// for every stripe s and byte column, the erasure-code hot path (K1).
//
// Replaces: ceph_tpu/ops/rs_codec.py `_apply_bitmatrix_jit` (:55-71) and
// `_apply_bitmatrix_batched_jit` (:74-92), one kernel for both (batch 1 for
// the first). The TPU program expands bytes into 8 bit-planes in device
// memory, contracts them with the (8r, 8k) GF(2) bitmatrix on the int8
// matrix unit and repacks.
//
// What bounds it on an H100: device-memory bytes. A stripe batch reads
// b*k*N bytes and writes b*r*N; at k=8, r=3 the bit-matrix contraction is
// 2*24*64 = 3072 int8 operations per column, 279 per byte moved, below the
// 590 int8 operations per byte where the tensor cores would become the
// limit. This SWAR design spends about 9 plain 32-bit integer operations
// per byte moved instead (3 per mask, 1 fused AND-XOR per output row), so
// at the SMs' integer rate it may sit above the memory bound; moving the
// contraction onto int8 mma is the way past that.
//
// Design: the planes never leave registers. Each thread owns 16 byte
// columns (4 words) of one stripe, or 4 columns on the byte path. For each
// input row j it loads the word w_j and builds, per bit c, the SWAR mask
// ((w_j >> c) & 0x01010101) * 0xFF, i.e. 0xFF in every byte whose bit c is
// set. Output row i accumulates mask & splat(P[i][j][c]) by XOR, where
// P[i][j][c] = M[i][j] * 2^c in GF(2^8) is bitmatrix column j*8+c packed
// over rows i*8..i*8+7. The splatted P lives in shared memory and is read
// by every lane of a warp at one address (a broadcast). One block handles
// RG <= 4 output rows (grid.y walks the row groups), so the accumulators
// stay in registers for any r. 16-byte loads and stores are used only when
// N and both base pointers allow them for every row; otherwise, for ragged
// N, every row goes through the byte path, which masks the ragged edge.
// All offsets are 64-bit.
//
// K3, the sharded encode's parity-plus-checksum step, has its own kernel
// in gf_bitmatrix_csum.cu.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;

template <int RG, bool VEC>
__global__ void __launch_bounds__(kThreads)
gf_bitmatrix_kernel(const uint8_t* __restrict__ data,    // (b, k, n)
                    const uint8_t* __restrict__ packed,  // (r, k, 8)
                    uint8_t* __restrict__ out,           // (b, r, n)
                    long long b, long long k, long long n, long long r) {
  extern __shared__ uint32_t splat[];  // [k * 8][RG]
  const long long row0 = (long long)blockIdx.y * RG;
  for (long long t = threadIdx.x; t < k * 8 * RG; t += blockDim.x) {
    const long long g = t % RG;
    const long long jc = t / RG;  // j * 8 + c
    const long long row = row0 + g;
    const uint32_t v = row < r ? packed[row * k * 8 + jc] : 0u;
    splat[t] = v * 0x01010101u;
  }
  __syncthreads();

  constexpr int W = VEC ? 4 : 1;            // 32-bit words per item
  constexpr long long kCols = 4 * W;        // byte columns per item
  const long long per_stripe = (n + kCols - 1) / kCols;
  const long long items = b * per_stripe;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       it < items; it += stride) {
    const long long s = it / per_stripe;
    const long long col = (it - s * per_stripe) * kCols;
    const uint8_t* src = data + s * k * n + col;

    uint32_t acc[RG][W];
#pragma unroll
    for (int g = 0; g < RG; ++g)
#pragma unroll
      for (int q = 0; q < W; ++q) acc[g][q] = 0u;

    for (long long j = 0; j < k; ++j) {
      uint32_t w[W];
      if constexpr (VEC) {
        const uint4 v = *reinterpret_cast<const uint4*>(src + j * n);
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
      } else {
        uint32_t x = 0u;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < n) x |= (uint32_t)src[j * n + q] << (8 * q);
        w[0] = x;
      }
      const uint32_t* pj = splat + j * 8 * RG;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int q = 0; q < W; ++q) {
          const uint32_t mask = ((w[q] >> c) & 0x01010101u) * 0xFFu;
#pragma unroll
          for (int g = 0; g < RG; ++g) acc[g][q] ^= mask & pj[c * RG + g];
        }
      }
    }

#pragma unroll
    for (int g = 0; g < RG; ++g) {
      const long long row = row0 + g;
      if (row >= r) break;
      uint8_t* dst = out + (s * r + row) * n + col;
      if constexpr (VEC) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < n) dst[q] = (uint8_t)(acc[g][0] >> (8 * q));
      }
    }
  }
}

template <int RG>
cudaError_t launch(const uint8_t* data, const uint8_t* packed, uint8_t* out,
                   long long b, long long k, long long n, long long r,
                   bool vec, cudaStream_t stream) {
  const long long cols = vec ? 16 : 4;
  const long long items = b * ((n + cols - 1) / cols);
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid((unsigned)blocks, (unsigned)((r + RG - 1) / RG));
  const size_t smem = (size_t)k * 8 * RG * sizeof(uint32_t);
  if (vec)
    gf_bitmatrix_kernel<RG, true><<<grid, kThreads, smem, stream>>>(
        data, packed, out, b, k, n, r);
  else
    gf_bitmatrix_kernel<RG, false><<<grid, kThreads, smem, stream>>>(
        data, packed, out, b, k, n, r);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (b, r, n) = packed-bitmatrix (r, k, 8) applied to data (b, k, n), all
// uint8, contiguous, on the device of `stream` (K1). k <= 255 keeps the
// shared table under 32 KiB. Returns cudaGetLastError() after the launch.
int gf_bitmatrix_apply(const void* data, const void* packed, void* out,
                       long long b, long long k, long long n, long long r,
                       void* stream) {
  if (b <= 0 || n <= 0 || r <= 0) return (int)cudaSuccess;
  if (k <= 0 || k > 255) return (int)cudaErrorInvalidValue;
  const bool vec = n % 16 == 0 && (uintptr_t)data % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* p = static_cast<const uint8_t*>(packed);
  auto* o = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (r >= 4 ? 4 : (int)r) {
    case 1: return (int)launch<1>(d, p, o, b, k, n, r, vec, st);
    case 2: return (int)launch<2>(d, p, o, b, k, n, r, vec, st);
    case 3: return (int)launch<3>(d, p, o, b, k, n, r, vec, st);
    default: return (int)launch<4>(d, p, o, b, k, n, r, vec, st);
  }
}

const char* gf_bitmatrix_strerror(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"
