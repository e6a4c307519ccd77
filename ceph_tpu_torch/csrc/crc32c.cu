// CRC32C per row on Hopper: the erasure-code scrub checksums.
//
// Replaces ceph_tpu/ops/pallas_ec.py:_crc_kernel.  crc[n] = CRC32C of
// row n with Ceph's raw seed 0, no inversion, reflected polynomial
// 0x82F63B78 (ops/crc32c.py).  The TPU kernel carried a running state
// across sequential grid steps (acc <- A_tile*acc ^ fold); Hopper blocks
// run in any order, so rows are cut into 4 KiB segments and CRC
// linearity stitches them back (crc_seg.cuh has the algebra and the
// table block).
//
// Bound: device memory, N*L bytes read.  What held the first version
// back was not memory: each lane loaded its own contiguous 128 bytes
// straight from device memory (every warp load touched 32 lines), its
// slicing-by-8 lookups met ~3.5-way shared-memory bank conflicts, the
// lane tree ran 5 x 32 dependent select-XORs, and one thread per row
// chained the segment CRCs serially.  This design:
//   * pass 1 (segments): a persistent block stages groups of 8 segments
//     in shared memory with coalesced 16-byte cp.async loads (zero-filled
//     where a segment reaches into the front padding); each warp folds
//     its 512-byte range of all 8 at once on the tensor cores
//     (crc_seg.cuh), and the 8 ranges join by XOR;
//   * pass 2 (chain): one warp per row.  Lane l chains a run of 2^p
//     consecutive segment CRCs (runs aligned to the row's end, so the
//     empty runs sit in front, where zeros are neutral), and a 5-level
//     shuffle tree combines the runs with adv_{4096*2^(p+i)}.  The row's
//     CRC goes to out[(n / per) * stride + offset + n % per], so data and
//     parity rows of a stripe batch land in one (B, k+m) array.
// Each pass is an entry point of its own (ceph_crc32c_segments,
// ceph_crc32c_chain), so each is counted and timed on its own; a row CRC
// is the two in turn.  gf_encode.cu's fused mode writes pass-1 segment
// CRCs itself, and the encode path then runs only pass 2.
#include <cstdint>
#include <cuda_runtime.h>

#include "crc_seg.cuh"

namespace {

using namespace crcseg;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSegSmem =
    (kSmemWords + kWarps * kCols) * 4 + (size_t)kCols * kStride;
static_assert(kThreads * 16 == kSeg, "one 16-byte piece per thread");
static_assert(kWarps == kRanges, "one warp per 512-byte range");

// Pass 1.  Group g = segments [g*kCols, (g+1)*kCols) of the flattened
// (row, segment) order; a block stages every gridDim.x-th group (several
// blocks share an SM, so one block's loads overlap another's folds).
// Warp w folds bytes [512w, 512w + 512) of all 8 segments on the tensor
// cores, and warp 0 joins the 8 ranges.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
crc_segments_kernel(const uint8_t* __restrict__ rows, long long L, int nseg,
                    long long pad, long long nwork,
                    uint32_t* __restrict__ seg_crc,
                    const uint32_t* __restrict__ tables) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* s_tab = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_part = s_tab + kSmemWords;
  uint8_t* s_seg = reinterpret_cast<uint8_t*>(s_part + kWarps * kCols);
  for (int i = threadIdx.x; i < kSmemWords; i += kThreads)
    s_tab[i] = tables[i];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long ngroups = (nwork + kCols - 1) / kCols;
  for (long long g = blockIdx.x; g < ngroups; g += gridDim.x) {
    __syncthreads();  // tables in place; the last group is done with smem
    for (int n = 0; n < kCols; ++n) {
      const long long wk = g * kCols + n;
      if (wk >= nwork) break;
      const long long row = wk / nseg;
      // the segment's first byte, in real row coordinates
      const long long a0 = (wk - row * nseg) * kSeg - pad;
      const uint8_t* base = rows + row * L;
      uint8_t* dst = s_seg + n * kStride;
      if (kVec) {
        // pad and L are multiples of 16: a piece is all pad or all data
        const int x = threadIdx.x * 16;
        const long long at = a0 + x;
        cp_async16(dst + x, at >= 0 ? base + at : base,
                   at >= 0 ? 16 : 0);
      } else {
        for (int x = threadIdx.x; x < kSeg; x += kThreads) {
          const long long at = a0 + x;
          dst[x] = at >= 0 ? base[at] : 0;
        }
      }
    }
    if (kVec) cp_async_wait_all();
    __syncthreads();
    const int col = lane >> 2;  // the segment this lane loads
    const uint8_t* seg =
        g * kCols + col < nwork ? s_seg + col * kStride : nullptr;
    const uint32_t part = fold_range8(seg, warp, s_tab, lane);
    if (lane < kCols) s_part[warp * kCols + lane] = part;
    __syncthreads();
    if (warp == 0) {
      const uint32_t crc = join_ranges(s_part, lane);
      if (lane < kCols && g * kCols + lane < nwork)
        seg_crc[g * kCols + lane] = crc;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
crc_chain_kernel(const uint32_t* __restrict__ seg_crc, long long N, int nseg,
                 int p, uint32_t* __restrict__ out, int per, int stride,
                 int offset, const uint32_t* __restrict__ tables) {
  const long long n = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const uint32_t* chain = tables + kChain;  // adv_4096 * 2^e
  const uint32_t* seg = seg_crc + n * nseg;
  if (nseg == 1) {  // a one-segment row: its segment CRC is the CRC
    if (lane == 0) out[(n / per) * stride + offset + n % per] = seg[0];
    return;
  }
  const int run = 1 << p;
  const int lead = (32 << p) - nseg;  // empty segments in front
  uint32_t crc = 0;
  for (int t = 0; t < run; ++t) {
    const int s = lane * run + t - lead;
    if (s >= 0) crc = advance_ldg(chain, crc) ^ __ldg(seg + s);
  }
#pragma unroll
  for (int lvl = 0, s = 1; lvl < 5; ++lvl, s <<= 1) {
    const uint32_t other = __shfl_down_sync(0xffffffffu, crc, s);
    if ((lane & (2 * s - 1)) == 0)
      crc = advance_ldg(chain + (p + lvl) * kNibWords, crc) ^ other;
  }
  if (lane == 0) out[(n / per) * stride + offset + n % per] = crc;
}

int chain_runs(int nseg) {
  int p = 0;
  while ((32 << p) < nseg) ++p;
  return p;
}

}  // namespace

// seg_crc (N * nseg uint32 segment CRCs, row-major) -> out[(n / per) *
// stride + offset + n % per] uint32 on `stream`: pass 2.  nseg may be at
// most 32 * 2^15.  Returns the launch's cudaError_t.
extern "C" int ceph_crc32c_chain(const void* seg_crc, long long N,
                                 int nseg, void* out, int per, int stride,
                                 int offset, const void* tables,
                                 void* stream) {
  if (N == 0) return 0;  // nothing to launch
  const int p = chain_runs(nseg);
  if (p + 4 >= kChainLevels) return (int)cudaErrorInvalidValue;
  const long long blocks = (N + kWarps - 1) / kWarps;
  crc_chain_kernel<<<(unsigned)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(seg_crc), N, nseg, p,
      static_cast<uint32_t*>(out), per, stride, offset,
      static_cast<const uint32_t*>(tables));
  return (int)cudaGetLastError();
}

// rows (N, L) uint8 -> seg_crc (N * ceil(L / 4096) uint32, row-major)
// on `stream`: pass 1 alone; ceph_crc32c_chain then makes row CRCs.
// tables is the block of crc_seg.cuh.  Returns the launch's cudaError_t.
extern "C" int ceph_crc32c_segments(const void* rows, long long N,
                                    long long L, void* seg_crc,
                                    const void* tables, void* stream) {
  if (N == 0 || L == 0) return 0;  // nothing to launch
  const int nseg = (int)((L + kSeg - 1) / kSeg);
  const long long pad = (long long)nseg * kSeg - L;
  const long long nwork = N * nseg;
  const bool vec = L % 16 == 0 && (uintptr_t)rows % 16 == 0;
  auto* kernel =
      vec ? &crc_segments_kernel<true> : &crc_segments_kernel<false>;
  int blocks = 0;
  cudaError_t err = persistent_blocks(kernel, kThreads, kSegSmem,
                                      (nwork + kCols - 1) / kCols, &blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, kSegSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), L, nseg, pad, nwork,
      static_cast<uint32_t*>(seg_crc), static_cast<const uint32_t*>(tables));
  return (int)cudaGetLastError();
}

// A strided copy of `height` runs of `width` bytes, the runs `spitch`
// bytes apart at src and `dpitch` bytes apart at dst, in either direction
// between host and device memory (cudaMemcpyDefault), on `stream`: how
// the mesh functions move one member's chunk-length slice of a batch up
// or its parity slice down without a host copy.  Asynchronous for pinned
// host memory.  Returns the copy's cudaError_t.
extern "C" int ceph_copy_2d(void* dst, long long dpitch, const void* src,
                            long long spitch, long long width,
                            long long height, void* stream) {
  if (width == 0 || height == 0) return 0;  // nothing to copy
  return (int)cudaMemcpy2DAsync(dst, (size_t)dpitch, src, (size_t)spitch,
                                (size_t)width, (size_t)height,
                                cudaMemcpyDefault,
                                static_cast<cudaStream_t>(stream));
}
