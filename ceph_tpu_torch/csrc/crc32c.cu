// CRC32C per row on Hopper: the erasure-code scrub checksums.
//
// Replaces ceph_tpu/ops/pallas_ec.py:_crc_kernel.  crc[n] = CRC32C of
// row n with Ceph's raw seed 0, no inversion, reflected polynomial
// 0x82F63B78 (ops/crc32c.py).
//
// Bound: device memory, N*L bytes read.  The TPU kernel carried a
// running state across sequential grid steps (acc <- A_tile*acc ^
// fold).  Hopper blocks run in any order, so the row is cut into
// kSeg-byte segments and CRC linearity stitches them back:
//     crc(A || B) = adv_|B| * crc(A)  ^  crc(B)      (seed 0, GF(2))
// where adv_n is the 32x32 GF(2) matrix that advances a CRC state over n
// zero bytes (ops/crc32c.py:advance_matrix, built on the host and passed
// in as 32 column words).
//   * pass 1: one warp per segment.  Each lane folds a contiguous
//     kLane-byte slice with slicing-by-8 tables in shared memory, then
//     five shuffle steps combine the lanes' CRCs with adv_128 ...
//     adv_2048;
//   * pass 2: one thread per row chains its segment CRCs with adv_4096
//     and writes the result to out[(n / per) * stride + offset + n % per],
//     so data and parity rows of a stripe batch land in one (B, k+m)
//     array without a concatenation copy.
// A row whose length is not a multiple of kSeg is treated as front-
// padded with zeros: from seed 0 leading zeros leave the CRC at 0, so the
// padding never has to exist in memory.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 4096;            // bytes per segment (one warp)
constexpr int kLane = kSeg / 32;      // bytes per lane
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSliceWords = 8 * 256;  // slicing-by-8 tables
constexpr int kAdvLevels = 6;         // adv_128 * 2^i, i = 0..5 (4096 last)
constexpr int kTableWords = kSliceWords + kAdvLevels * 32;
constexpr long long kMaxBlocks = 132 * 8;

__device__ __forceinline__ uint32_t advance(const uint32_t* cols,
                                            uint32_t x) {
  uint32_t y = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) y ^= (0u - ((x >> i) & 1u)) & cols[i];
  return y;
}

__device__ __forceinline__ uint32_t slice8(const uint32_t* T, uint32_t crc,
                                           uint32_t lo, uint32_t hi) {
  crc ^= lo;
  return T[7 * 256 + (crc & 0xff)] ^ T[6 * 256 + ((crc >> 8) & 0xff)] ^
         T[5 * 256 + ((crc >> 16) & 0xff)] ^ T[4 * 256 + (crc >> 24)] ^
         T[3 * 256 + (hi & 0xff)] ^ T[2 * 256 + ((hi >> 8) & 0xff)] ^
         T[1 * 256 + ((hi >> 16) & 0xff)] ^ T[hi >> 24];
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
crc_segments_kernel(const uint8_t* __restrict__ rows, long long L, int nseg,
                    long long pad, long long nwork,
                    uint32_t* __restrict__ seg_crc,
                    const uint32_t* __restrict__ tables) {
  __shared__ uint32_t s_tab[kTableWords];
  for (int i = threadIdx.x; i < kTableWords; i += blockDim.x)
    s_tab[i] = tables[i];
  __syncthreads();
  const uint32_t* adv = s_tab + kSliceWords;
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * kWarps;
  for (long long wk = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       wk < nwork; wk += step) {
    const long long row = wk / nseg;
    const int seg = (int)(wk - row * nseg);
    // this lane's slice in padded coordinates, shifted to the real row
    const long long a0 = (long long)seg * kSeg + lane * kLane - pad;
    const uint8_t* base = rows + row * L;
    uint32_t crc = 0;
    if (kVec) {
      // pad and L are multiples of 16 here: a piece is all pad or all data
#pragma unroll
      for (int q = 0; q < kLane / 16; ++q) {
        const long long a = a0 + 16 * q;
        if (a < 0) continue;
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(base + a));
        crc = slice8(s_tab, crc, v.x, v.y);
        crc = slice8(s_tab, crc, v.z, v.w);
      }
    } else {
      for (int t = 0; t < kLane; ++t) {
        const long long a = a0 + t;
        if (a < 0) continue;
        crc = (crc >> 8) ^ s_tab[(crc ^ base[a]) & 0xff];
      }
    }
    // combine lanes pairwise: lane i (a run of s lanes) absorbs lane i+s
#pragma unroll
    for (int lvl = 0, s = 1; lvl < 5; ++lvl, s <<= 1) {
      const uint32_t other = __shfl_down_sync(0xffffffffu, crc, s);
      if ((lane & (2 * s - 1)) == 0) crc = advance(adv + lvl * 32, crc) ^ other;
    }
    if (lane == 0) seg_crc[wk] = crc;
  }
}

__global__ void __launch_bounds__(kThreads)
crc_combine_kernel(const uint32_t* __restrict__ seg_crc, int N, int nseg,
                   uint32_t* __restrict__ out, int per, int stride,
                   int offset, const uint32_t* __restrict__ tables) {
  __shared__ uint32_t s_adv[32];
  if (threadIdx.x < 32)
    s_adv[threadIdx.x] = tables[kSliceWords + (kAdvLevels - 1) * 32 +
                                threadIdx.x];
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const uint32_t* seg = seg_crc + (long long)n * nseg;
  uint32_t crc = seg[0];
  for (int s = 1; s < nseg; ++s) crc = advance(s_adv, crc) ^ seg[s];
  out[(long long)(n / per) * stride + offset + n % per] = crc;
}

}  // namespace

// rows (N, L) uint8 -> out[(n / per) * stride + offset + n % per] uint32
// on `stream`.  seg_scratch holds N * ceil(L / 4096) uint32; tables holds
// the slicing-by-8 tables then the column words of adv_128 ... adv_4096.
// Returns the launches' cudaError_t.
extern "C" int ceph_crc32c_rows(const void* rows, int N, long long L,
                                void* seg_scratch, void* out, int per,
                                int stride, int offset, const void* tables,
                                void* stream) {
  if (N == 0 || L == 0) return 0;  // nothing to launch
  const int nseg = (int)((L + kSeg - 1) / kSeg);
  const long long pad = (long long)nseg * kSeg - L;
  const long long nwork = (long long)N * nseg;
  const bool vec = L % 16 == 0 && (uintptr_t)rows % 16 == 0;
  long long blocks = (nwork + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(rows);
  auto* seg = static_cast<uint32_t*>(seg_scratch);
  const auto* tab = static_cast<const uint32_t*>(tables);
  if (vec)
    crc_segments_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        in, L, nseg, pad, nwork, seg, tab);
  else
    crc_segments_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        in, L, nseg, pad, nwork, seg, tab);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  crc_combine_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      seg, N, nseg, static_cast<uint32_t*>(out), per, stride, offset, tab);
  return (int)cudaGetLastError();
}
