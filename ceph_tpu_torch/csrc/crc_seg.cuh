// CRC32C of 4 KiB segments staged in shared memory, on the tensor cores;
// shared by crc32c.cu (the scrub CRC) and gf_encode.cu (its fused
// encode+CRC mode).
//
// CRC convention: Ceph's raw seed 0, no inversion, reflected polynomial
// 0x82F63B78 (ops/crc32c.py).  A row is cut into kSeg-byte segments,
// counted from its end: a row whose length is not a multiple of kSeg is
// front-padded with zeros, which leave a seed-0 CRC at 0, so the padding
// never has to exist in device memory.  CRC linearity stitches pieces
// back together:
//     crc(A || B) = adv_|B| * crc(A)  ^  crc(B)
// where adv_n is the 32x32 GF(2) matrix that advances a CRC state over n
// zero bytes (ops/crc32c.py:advance_matrix).  The host passes each adv_n
// as 8 nibble tables of 16 words (column sums of the matrix over the 16
// values of each 4-bit slice of the state), so one advance is 8 table
// lookups instead of 32 dependent select-XORs.
//
// The fold.  From seed 0 the CRC of a 512-byte range is a GF(2)
// product, crc = M * bits(range), with M = the 32 x 4096 message matrix
// (ops/crc32c.py:message_matrix(512)).  This is the TPU kernel's
// formulation (it ran the product on the MXU); here it runs on the
// tensor cores as a 1-bit matrix product, mma.sync m16n8k256 .b1 with AND
// + POPC, whose popcount parity is the GF(2) sum.  A warp folds one
// 512-byte range of 8 segments at once: A = M in 2 row tiles x 16
// K-slices of 256 bits, read from shared memory as one 16-byte fragment
// per lane per mma; B = the raw bytes, 128 a lane, no bit unpacking; D's
// parity bits come back through 8 ballots.  The range CRC is then
// advanced over the rest of the segment (adv_{512 j}), so the 8 warps'
// ranges join by XOR.  A slicing-by-8 fold on this card was bound by
// shared-memory bank conflicts (~3.5 lanes of a warp on the busiest
// bank, one lookup a byte); the tensor-core fold spends a few dozen
// instructions per KiB, 8 of them mma.
//
// Fragment layouts (PTX ISA, mma.m16n8k256 .b1; g = lane >> 2, t = lane &
// 3, bit i of a register is element i):
//   A (16 x 256, row): a0 row g, k = 32t + i; a1 row g + 8, same k;
//                      a2 row g, k = 128 + 32t + i; a3 row g + 8, same k
//   B (256 x 8, col):  b0 k = 32t + i, b1 k = 128 + 32t + i; column g
//   D (16 x 8, s32):   d0, d1 row g, columns 2t, 2t + 1; d2, d3 row g + 8
// Lane (g, t) loads bytes [128k + 32t, 128k + 32t + 32) of its column
// g's range as words w[k][0..7] (k = 0..3), and K-slice s = 4k + s' takes
// b0 = w[k][2s'], b1 = w[k][2s' + 1]; the host builds A's registers to
// match (ops/cuda_ec.py:crc_mma_fragments).
//
// Table block (uint32 words, ops/cuda_ec.py:crc_tables):
//   [0, 4096)        A fragments: lane l's a0..a3 for row tile T and
//                    K-slice s at ((T * 16 + s) * 32 + l) * 4
//   then 7 x 128     adv_{512 j}, j = 1..7 (range tails)
//                    -- the kSmemWords words a fold reads from shared
//                    memory
//   then 20 x 128    adv_4096 * 2^e, e = 0..19 (segment chain, read from
//                    global memory by crc32c.cu's chain pass)
//
// Staged segments sit in shared memory kStride bytes apart.
#pragma once
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include <cuda_runtime.h>

namespace crcseg {

constexpr int kSeg = 4096;                 // bytes per segment
constexpr int kBlock = 128;                // bytes a lane group loads
// staged bytes per segment: 16 past a multiple of 128, so the 8 segments
// a warp folds at once start 16 bytes apart modulo the 32 banks and its
// 16-byte loads meet no bank conflicts
constexpr int kStride = kSeg + 16;
constexpr int kCols = 8;                   // segments folded by one mma
constexpr int kRange = 512;                // bytes of a segment per warp
constexpr int kRanges = kSeg / kRange;
constexpr int kSlices = kRange * 8 / 256;  // K-slices of a range
constexpr int kNibWords = 8 * 16;          // one advance matrix
constexpr int kChainLevels = 20;           // adv_4096 * 2^e
constexpr int kAFrag = 0;                  // 2 x kSlices x 32 lanes x 4
constexpr int kAdvTail = kAFrag + 2 * kSlices * 32 * 4;  // tail j: +(j-1)
constexpr int kSmemWords = kAdvTail + (kRanges - 1) * kNibWords;
constexpr int kChain = kSmemWords;         // offset of the chain advances
constexpr int kTableWords = kChain + kChainLevels * kNibWords;

__device__ __forceinline__ uint32_t advance(const uint32_t* nib, uint32_t x) {
  uint32_t y = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) y ^= nib[i * 16 + ((x >> (4 * i)) & 15u)];
  return y;
}

__device__ __forceinline__ uint32_t advance_ldg(const uint32_t* nib,
                                                uint32_t x) {
  uint32_t y = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    y ^= __ldg(nib + i * 16 + ((x >> (4 * i)) & 15u));
  return y;
}

__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bits 4g + t (g = 0..7) of w, as a byte
__device__ __forceinline__ uint32_t gather4(uint32_t w, int t) {
  uint32_t x = (w >> t) & 0x11111111u;
  x = (x | (x >> 3)) & 0x03030303u;
  x = (x | (x >> 6)) & 0x000F000Fu;
  return (x | (x >> 12)) & 0xFFu;
}

// Warp `range`'s share of the CRCs (seed 0) of 8 staged segments: the CRC
// of bytes [512 range, 512 range + 512), advanced over the bytes after
// them, so XOR over the 8 ranges gives the segment CRC.  `seg` is this
// lane's segment (lane >> 2; shared memory, 16-byte aligned; nullptr:
// zeros), `tab` the first kSmemWords words of the table block in shared
// memory.  Lane l gets segment l & 7.
__device__ __forceinline__ uint32_t fold_range8(const uint8_t* seg,
                                                int range,
                                                const uint32_t* tab,
                                                int lane) {
  const int t = lane & 3;
  uint32_t w[kRange / kBlock][8];
#pragma unroll
  for (int k = 0; k < kRange / kBlock; ++k) {
    uint4 u0 = make_uint4(0, 0, 0, 0), u1 = u0;
    if (seg != nullptr) {
      const uint8_t* p = seg + range * kRange + k * kBlock + 32 * t;
      u0 = *reinterpret_cast<const uint4*>(p);
      u1 = *reinterpret_cast<const uint4*>(p + 16);
    }
    w[k][0] = u0.x; w[k][1] = u0.y; w[k][2] = u0.z; w[k][3] = u0.w;
    w[k][4] = u1.x; w[k][5] = u1.y; w[k][6] = u1.z; w[k][7] = u1.w;
  }
  // two accumulators per row tile (even and odd slices) halve the chain
  // of dependent products; their popcounts add
  int d[2][2][4] = {};
  const uint4* frag = reinterpret_cast<const uint4*>(tab + kAFrag) + lane;
#pragma unroll
  for (int s = 0; s < kSlices; ++s)
#pragma unroll
    for (int tile = 0; tile < 2; ++tile) {
      const uint4 f = frag[(tile * kSlices + s) * 32];
      const uint32_t a[4] = {f.x, f.y, f.z, f.w};
      mma_b1(d[tile][s & 1], a, w[s >> 2][2 * (s & 3)],
             w[s >> 2][2 * (s & 3) + 1]);
    }
  // segment n = 2tn + e: CRC bit 16 tile + 8h + g is the parity of
  // d[tile][.][2h + e] in lane 4g + tn
  const int n = lane & 7, tn = n >> 1, e = n & 1;
  uint32_t crc = 0;
#pragma unroll
  for (int tile = 0; tile < 2; ++tile)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * h;
      const uint32_t x0 = __ballot_sync(
          0xffffffffu, (d[tile][0][j] + d[tile][1][j]) & 1);
      const uint32_t x1 = __ballot_sync(
          0xffffffffu, (d[tile][0][j + 1] + d[tile][1][j + 1]) & 1);
      crc |= gather4(e ? x1 : x0, tn) << (16 * tile + 8 * h);
    }
  const int tail = kRanges - 1 - range;  // ranges after this one
  return tail ? advance(tab + kAdvTail + (tail - 1) * kNibWords, crc) : crc;
}

// Segment CRCs from the 8 ranges' shares, part[range * kCols + n]: lane
// l gets segment l & 7's.
__device__ __forceinline__ uint32_t join_ranges(const uint32_t* part,
                                                int lane) {
  const int n = lane & (kCols - 1);
  uint32_t crc = 0;
#pragma unroll
  for (int r = 0; r < kRanges; ++r) crc ^= part[r * kCols + n];
  return crc;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Blocks for a persistent grid of `kernel` with `smem` bytes of dynamic
// shared memory over `work` items: the SMs times the blocks one SM holds.
// Shared memory above the 48 KiB default is granted per kernel and
// device on request.  Both the grant and the occupancy query run once
// per (kernel, device, smem) and are cached, so a launch pays a map
// lookup on the host, not four runtime queries.  The grant only ever
// grows, so a cached size stays granted.
inline cudaError_t persistent_grid(const void* kernel, int threads,
                                   size_t smem, long long work, int* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, long long> grids;
  static std::map<std::pair<const void*, int>, size_t> granted;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(kernel, dev, smem);
  auto it = grids.find(key);
  if (it == grids.end()) {
    size_t& have = granted[std::make_pair(kernel, dev)];
    if (smem > 48 * 1024 && smem > have) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      have = smem;
    }
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    it = grids.emplace(key, (long long)sms * per_sm).first;
  }
  *blocks = (int)(work < it->second ? work : it->second);
  return cudaSuccess;
}

template <typename K>
inline cudaError_t persistent_blocks(K kernel, int threads, size_t smem,
                                     long long work, int* blocks) {
  return persistent_grid(reinterpret_cast<const void*>(kernel), threads,
                         smem, work, blocks);
}

}  // namespace crcseg
