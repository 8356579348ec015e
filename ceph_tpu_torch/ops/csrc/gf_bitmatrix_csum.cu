// K3: the sharded encode's per-device step, parity plus checksum, in one
// launch.
//
// Replaces: ceph_tpu/parallel/mesh.py `_encode_local` (:54) and the
// checksum beside it in `sharded_encode_fn` (:96-97): one device's partial
// encode over its slice of the (zero-padded) parity rows, out (b, r, N) =
// packed bitmatrix (r, k, 8) applied to data (b, k, N) over GF(2), plus
// sum(out * 2654435761) mod 2^32, which the mesh then sums over devices
// (the TPU program's `psum`).
//
// What bounds it on an H100: device-memory bytes, b*k*N read and b*r*N
// written (184.5 MB at (16,8,1 MiB) -> (16,3,1 MiB), 0.0551 ms at 3.35
// TB/s). K1's loop form, which K3 used to share, builds a byte mask per
// input bit, ((w >> c) & 0x01010101) * 0xFF, and ANDs it with the splatted
// operand per output row: 39 operations of the integer ALU pipe and 8
// IMADs per input word at r=3 (SASS), a ceiling of 0.080 ms at 64 ALU
// lanes a clock per SM, 132 SMs and 1.98 GHz, above the bytes' 0.0551.
//
// Design:
// - The contraction moves half its work to the FMA pipe. b_c = (w >> c) &
//   0x01010101 holds 0 or 1 in each byte lane, so b_c * P, with P <= 255
//   the packed operand byte, carries nothing across lanes and equals
//   mask & splat(P): one IMAD per (bit, output row, word), and a 3-input
//   LOP3 folds two products into the accumulator. At r=3 that is 27 ALU
//   and 25 FMA-pipe instructions per input word (SASS), which the two
//   pipes issue side by side: 0.054 ms at full issue.
// - Latency: the kernel is bound by how many warps hide its dependent
//   chains and loads, so it keeps registers down (at most 85: 24 warps an
//   SM) and keeps loads ahead: each thread contracts kRows input rows
//   while the next kRows (of this item, or the first of its next item)
//   are in flight. The row index is clamped to k - 1 instead of tested,
//   so no load waits behind a branch; rows past k meet zero operands.
//   The main path's k = 8 is an instantiation of its own (KK = 8): the
//   row loop unrolls completely and the walk counters are 32-bit.
// - One launch per call, persistent CTAs. The grid is min(SMs x CTAs per
//   SM, work); each thread walks its items with a grid stride, carrying
//   its stripe and column block so the walk divides nothing per item. The
//   operand table is built once per CTA in shared memory and read as one
//   broadcast LDS.128 per (row, bit). Row groups of up to 4 output rows
//   are grid.y over the same walk, so accumulators stay in registers for
//   any r.
// - The checksum: each thread adds the bytes it writes with __dp4a into
//   one register, each CTA reduces those into one partial in scratch, and
//   the last CTA to take a ticket (threadfence reduction) sums the
//   partials, multiplies by 2654435761, writes the 0-d int64 result and
//   resets the ticket for the next launch on the stream. Unsigned
//   arithmetic wraps mod 2^32 and multiplication distributes over it, so
//   the result is exact in any order. Bytes past a ragged N are zero in
//   the accumulators and add nothing; padding rows (all-zero matrix rows)
//   are computed, written and add nothing.
// - Memory: a thread owns 16 byte columns of one stripe (one 16-byte load
//   per input row, neighbouring lanes on neighbouring columns). N not a
//   multiple of 16, or a base off 16-byte alignment, takes the byte path
//   (4 columns a thread, the ragged edge masked). All offsets are 64-bit.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;                // input rows a chunk
constexpr int kStep = 2 * kRows;        // a chunk and the next in flight
constexpr uint32_t kCsumMul = 2654435761u;
constexpr uint32_t kLanes = 0x01010101u;

// acc[g][q] ^= input word w[q] of row j contracted with P[g][j][c] for the
// 8 bits c: pj holds the row's 8 table entries.
template <int RG, int W>
__device__ __forceinline__ void contract(uint32_t (&acc)[RG][W],
                                         const uint32_t (&w)[W],
                                         const uint4* pj) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint4 p4 = pj[c];
    const uint32_t p[4] = {p4.x, p4.y, p4.z, p4.w};
    uint32_t bit[W];
#pragma unroll
    for (int q = 0; q < W; ++q) bit[q] = (w[q] >> c) & kLanes;  // 0 or 1
#pragma unroll
    for (int g = 0; g < RG; ++g)
#pragma unroll
      for (int q = 0; q < W; ++q) acc[g][q] ^= bit[q] * p[g];
  }
}

// Row j of the item, j clamped to k - 1: rows past k meet zero operands,
// and a load without a condition can be issued ahead of the contraction.
template <bool VEC>
__device__ __forceinline__ void load_row(uint32_t (&w)[VEC ? 4 : 1],
                                         const uint8_t* src, long long j,
                                         long long k, long long n,
                                         long long col) {
  const uint8_t* row = src + (j < k ? j : k - 1) * n;
  if constexpr (VEC) {
    const uint4 v = *reinterpret_cast<const uint4*>(row);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    uint32_t x = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (col + q < n) x |= (uint32_t)row[q] << (8 * q);
    w[0] = x;
  }
}

template <bool VEC>
__device__ __forceinline__ void load_chunk(uint32_t (&w)[kRows][VEC ? 4 : 1],
                                           const uint8_t* src, long long j0,
                                           long long k, long long n,
                                           long long col) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) load_row<VEC>(w[i], src, j0 + i, k, n, col);
}

// KK: k known at compile time (the main path's 8), or 0 for any k <= 255.
template <int RG, bool VEC, int KK>
__global__ void __launch_bounds__(kThreads, 3)
gf_bitmatrix_csum_kernel(const uint8_t* __restrict__ data,    // (b, k, n)
                         const uint8_t* __restrict__ packed,  // (r, k, 8)
                         uint8_t* __restrict__ out,           // (b, r, n)
                         long long b_arg, long long k_arg, long long n,
                         long long r,
                         uint32_t* __restrict__ scratch,  // ticket, partials
                         long long* __restrict__ result) {    // 0-d int64
  // walk counters: 32-bit where the host has checked that they fit
  using Idx = std::conditional_t<KK != 0, unsigned, long long>;
  const long long k = KK ? KK : k_arg;
  const Idx b = (Idx)b_arg;

  // (j, c) -> the operands P of this CTA's row group, 4 lanes (RG used),
  // zero past r and for rows j >= k up to a whole number of kStep
  extern __shared__ uint4 tab[];
  const long long row0 = (long long)blockIdx.y * RG;
  const long long kpad = (k + kStep - 1) / kStep * kStep;
  for (long long t = threadIdx.x; t < kpad * 8; t += kThreads) {
    uint32_t v[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const long long row = row0 + g;
      v[g] = g < RG && row < r && t < k * 8 ? packed[row * k * 8 + t] : 0u;
    }
    tab[t] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();

  constexpr int W = VEC ? 4 : 1;            // 32-bit words per item
  constexpr long long kCols = 4 * W;        // byte columns per item
  const Idx per_stripe = (Idx)((n + kCols - 1) / kCols);
  const Idx first = (Idx)blockIdx.x * kThreads + threadIdx.x;
  const Idx stride = (Idx)gridDim.x * kThreads;
  Idx s = first / per_stripe, cb = first - s * per_stripe;
  const Idx ds = stride / per_stripe, dcb = stride - ds * per_stripe;
  uint32_t bsum = 0u;                       // bytes written, mod 2^32
  uint32_t wa[kRows][W], wb[kRows][W];      // this chunk, the next
  if (s < b)
    load_chunk<VEC>(wa, data + (long long)s * k * n + (long long)cb * kCols,
                    0, k, n, (long long)cb * kCols);
  while (s < b) {
    const long long col = (long long)cb * kCols;
    const uint8_t* src = data + (long long)s * k * n + col;
    // the thread's next item, whose first rows load during the last chunk
    Idx s2 = s + ds, cb2 = cb + dcb;
    if (cb2 >= per_stripe) {
      cb2 -= per_stripe;
      ++s2;
    }
    const bool more_items = s2 < b;
    const long long col2 = more_items ? (long long)cb2 * kCols : col;
    const uint8_t* src2 =
        more_items ? data + (long long)s2 * k * n + col2 : src;

    uint32_t acc[RG][W];
#pragma unroll
    for (int g = 0; g < RG; ++g)
#pragma unroll
      for (int q = 0; q < W; ++q) acc[g][q] = 0u;
    for (long long j0 = 0; j0 < k; j0 += kStep) {
      load_chunk<VEC>(wb, src, j0 + kRows, k, n, col);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        contract<RG, W>(acc, wa[i], tab + (j0 + i) * 8);
      const bool more_rows = j0 + kStep < k;
      load_chunk<VEC>(wa, more_rows ? src : src2, more_rows ? j0 + kStep : 0,
                      k, n, more_rows ? col : col2);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        contract<RG, W>(acc, wb[i], tab + (j0 + kRows + i) * 8);
    }

#pragma unroll
    for (int g = 0; g < RG; ++g) {
      const long long row = row0 + g;
      if (row >= r) break;
      uint8_t* dst = out + ((long long)s * r + row) * n + col;
      if constexpr (VEC) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < n) dst[q] = (uint8_t)(acc[g][0] >> (8 * q));
      }
#pragma unroll
      for (int q = 0; q < W; ++q) bsum = __dp4a(acc[g][q], kLanes, bsum);
    }
    s = s2;
    cb = cb2;
  }

  // the CTA's partial, then the ticket; the last CTA sums the partials
  __shared__ uint32_t warp_sums[kThreads / 32];
  __shared__ bool last;
  const unsigned nblocks = gridDim.x * gridDim.y;
  const unsigned bid = blockIdx.y * gridDim.x + blockIdx.x;
  uint32_t* partials = scratch + 1;
  bsum = __reduce_add_sync(0xffffffffu, bsum);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = bsum;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t total = 0u;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
    partials[bid] = total;
    __threadfence();                        // the partial before the ticket
    last = atomicAdd(scratch, 1u) == nblocks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  uint32_t sum = 0u;
  for (unsigned i = threadIdx.x; i < nblocks; i += kThreads)
    sum += __ldcg(partials + i);
  sum = __reduce_add_sync(0xffffffffu, sum);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t total = 0u;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
    *result = (long long)(total * kCsumMul);
    *scratch = 0u;                          // the ticket, for the next launch
  }
}

template <int RG, bool VEC, int KK>
cudaError_t launch(const uint8_t* data, const uint8_t* packed, uint8_t* out,
                   long long b, long long k, long long n, long long r,
                   uint32_t* scratch, long long slots, long long* result,
                   cudaStream_t stream) {
  const long long cols = VEC ? 16 : 4;
  const long long items = b * ((n + cols - 1) / cols);
  const long long groups = (r + RG - 1) / RG;
  const size_t smem = (size_t)((k + kStep - 1) / kStep * kStep) * 8 *
                      sizeof(uint4);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gf_bitmatrix_csum_kernel<RG, VEC, KK>, kThreads, smem);
  if (rc != cudaSuccess) return rc;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1) / groups;
  const long long work = (items + kThreads - 1) / kThreads;
  if (blocks > work) blocks = work;
  if (blocks > slots / groups) blocks = slots / groups;
  if (blocks < 1) blocks = 1;
  if (groups > 65535 || blocks * groups > slots) return cudaErrorInvalidValue;
  gf_bitmatrix_csum_kernel<RG, VEC, KK>
      <<<dim3((unsigned)blocks, (unsigned)groups), kThreads, smem, stream>>>(
          data, packed, out, b, k, n, r, scratch, result);
  return cudaGetLastError();
}

template <int RG, bool VEC>
cudaError_t run(const uint8_t* data, const uint8_t* packed, uint8_t* out,
                long long b, long long k, long long n, long long r,
                uint32_t* scratch, long long slots, long long* result,
                cudaStream_t stream) {
  // the k = 8 instantiation walks with 32-bit counters: twice the item
  // count plus the grid stride must stay below 2^32
  const long long items = b * ((n + (VEC ? 15 : 3)) / (VEC ? 16 : 4));
  if (k == 8 && 2 * (items + slots * kThreads) < (1LL << 32))
    return launch<RG, VEC, 8>(data, packed, out, b, k, n, r, scratch, slots,
                              result, stream);
  return launch<RG, VEC, 0>(data, packed, out, b, k, n, r, scratch, slots,
                            result, stream);
}

}  // namespace

extern "C" {

// K3: out (b, r, n) = packed bitmatrix (r, k, 8) applied to data (b, k, n),
// all uint8 and contiguous, and *result (one int64) = the sum of every
// byte written, times 2654435761, mod 2^32; one kernel launch on `stream`,
// on the current device, which must hold every pointer. scratch: `slots`
// + 1 uint32, word 0 zero before the first launch on `stream` (each launch
// leaves it zero), slots >= ceil(r / 4). k <= 255 keeps the operand table
// under 32 KiB of shared memory. Requires b, n, r >= 1. Returns
// cudaGetLastError() after the launch.
int gf_bitmatrix_csum_run(const void* data, const void* packed, void* out,
                          long long b, long long k, long long n, long long r,
                          void* scratch, long long slots, void* result,
                          void* stream) {
  if (b <= 0 || n <= 0 || r <= 0 || k <= 0 || k > 255)
    return (int)cudaErrorInvalidValue;
  const bool vec = n % 16 == 0 && (uintptr_t)data % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* p = static_cast<const uint8_t*>(packed);
  auto* o = static_cast<uint8_t*>(out);
  auto* sc = static_cast<uint32_t*>(scratch);
  auto* res = static_cast<long long*>(result);
  auto st = static_cast<cudaStream_t>(stream);
#define K3_RUN(RG)                                                            \
  return (int)(vec ? run<RG, true>(d, p, o, b, k, n, r, sc, slots, res, st)   \
                   : run<RG, false>(d, p, o, b, k, n, r, sc, slots, res, st))
  switch (r >= 4 ? 4 : (int)r) {
    case 1: K3_RUN(1);
    case 2: K3_RUN(2);
    case 3: K3_RUN(3);
    default: K3_RUN(4);
  }
#undef K3_RUN
}

const char* gf_bitmatrix_csum_strerror(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"
