// GF(2^8) matrix x chunks on Hopper: erasure encode and rebuild decode,
// and the fused encode + scrub-CRC pass.
//
// Replaces ceph_tpu/ops/pallas_ec.py:_encode_kernel.  out[b, i, :] =
// XOR_j M[i][j] * data[b, j, :] over GF(2^8) with polynomial 0x11D, for
// an (r, c) matrix: r = m parity rows to encode, r = |want| rows to
// rebuild from c = |present| surviving chunks.
//
// Bound: device memory.  The pass reads B*c*L bytes and writes B*r*L.
// The first version was bound by the load/store unit instead: it took
// the log of every input byte and an exp per output row, 4 random
// shared-memory byte lookups per input byte at k=8 m=3, and each thread
// walked its k chunks 1 MiB apart with dependent loads.  A second design,
// one lookup per input byte into packed 4-row product tables (uint32
// T[j][x] with M[r0+rr][j]*x in byte rr), quartered the lookups but
// measured as still lookup-bound on the H100 (flat in r = 1..4, +60% at
// r = 8; PERF.md): random bytes put ~3.5 lanes of a warp on one bank.
// This design takes the products off shared memory altogether:
//   * byte-permute products (the GPU form of ISA-L's PSHUFB nibble
//     tables): x*a = a*(x & 7) ^ a*(x & 0x38) ^ a*(x & 0xc0), and each
//     term is a lookup in an 8- or 4-entry byte table, which one PRMT does
//     for 4 input bytes at once from two registers.  The host builds, per
//     (row, column), the three tables in 5 words (ops/cuda_ec.py:
//     gf_params); a thread loads them with broadcast shared-memory reads,
//     builds the PRMT selectors of each pair of input words once (each
//     selector serves two bytes of both words), and spends 3 PRMTs and 2
//     XORs per word per output row: about 6 integer operations per input
//     byte at m=3, and no bank conflicts.  The Pallas kernel's bit
//     planes on the MXU would only multiply register traffic here, and a
//     bit-sliced LOP3 form costs more operations per byte;
//   * plain mode: each thread owns 16 bytes of one stripe's chunk axis,
//     loads them from up to 8 columns at once into registers (all loads
//     in flight together, coalesced 16 bytes a thread) and produces them
//     for 4 output rows per pass over the columns.  Staging through
//     shared memory measured slower here: it buys nothing when every
//     thread reads only its own bytes;
//   * shapes: on 16-byte aligned rows, a matrix of at most 4 rows and 8
//     columns (every encode with k <= 8, m <= 4, every rebuild of up to 4
//     chunks from up to 8) runs a kernel compiled for its (c, r), with
//     its loops unrolled; other matrices and ragged rows run the kernel
//     that takes c and r at run time.  The fixed shapes measured 10-20%
//     faster at k=8 m=3: with c and r at run time the kernel needs ~100
//     and ~115 registers and an SM holds 2 blocks of it, not 4 and 3
//     (plain, fused); capping its registers spilled (PERF.md);
//   * fused mode (ceph_gf_encode_crc): a persistent block takes one
//     (stripe, 4 KiB segment) at a time and stages its c data segments
//     in shared memory with coalesced 16-byte cp.async loads (zero-filled
//     where a segment reaches into the front padding; segments are
//     counted from the row's end, as crc32c.cu counts them).  The parity
//     segments go to shared memory as well as to device memory, and the
//     block folds the segment CRCs of all c+r rows from there
//     (crc_seg.cuh), so the data is read from device memory once and the
//     parity is never read back.  crc32c.cu's chain pass then turns
//     segment CRCs into row CRCs.  At the 4 KiB stripe unit an item is a
//     whole stripe.
// L of any size works: an unaligned row takes byte loads and stores.
#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

#include "crc_seg.cuh"

namespace {

using crcseg::kSeg;
using crcseg::kStride;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;     // output rows accumulated per pass
constexpr int kCols = 8;      // input columns loaded together
constexpr int kTabWords = 8;  // per (row, column): A0 A1 B0 B1 C + pad
static_assert(kWarps == crcseg::kRanges, "one warp per CRC range");
static_assert(kThreads * 16 == kSeg, "one 16-byte piece per thread");

// acc[rr] ^= M[r0+rr][j] * u for rr < nr: gf_tab (in shared memory) is
// (r, c, kTabWords) uint32; for coefficient a, bytes v of A, B and C are
// a*v, a*(v << 3) (v < 8) and a*(v << 6) (v < 4).  The words of u go in
// pairs (wa, wb): one PRMT selector holds the 3-bit indices of two bytes
// of each, so the products come out interleaved, acc[2p] = bytes 0, 1 and
// acc[2p + 1] = bytes 2, 3 of wa and wb alternately; unpair() restores
// the order once all columns are in.
__device__ __forceinline__ void gf_column(const uint32_t* gf_tab, int c,
                                          int r0, int nr, int j,
                                          const uint4& u,
                                          uint32_t (&acc)[kGroup][4]) {
  const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
  uint32_t sa[2], sb[2], sc[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint32_t wa = wd[2 * p], wb = wd[2 * p + 1];
    sa[p] = (wa & 0x07070707u) | ((wb & 0x07070707u) << 4);
    sb[p] = ((wa >> 3) & 0x07070707u) | ((wb << 1) & 0x70707070u);
    sc[p] = ((wa >> 6) & 0x03030303u) | ((wb >> 2) & 0x30303030u);
  }
#pragma unroll
  for (int rr = 0; rr < kGroup; ++rr) {
    if (rr >= nr) break;
    const uint32_t* t = gf_tab + ((r0 + rr) * c + j) * kTabWords;
    const uint4 ab = *reinterpret_cast<const uint4*>(t);
    const uint32_t tc = t[4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h)  // __byte_perm reads the low 16 bits
        acc[rr][2 * p + h] ^= __byte_perm(ab.x, ab.y, sa[p] >> (16 * h)) ^
                              __byte_perm(ab.z, ab.w, sb[p] >> (16 * h)) ^
                              __byte_perm(tc, 0, sc[p] >> (16 * h));
  }
}

// gf_column's interleaved accumulators back to word order
__device__ __forceinline__ void unpair(uint32_t (&w)[4]) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint32_t x = w[2 * p], y = w[2 * p + 1];
    w[2 * p] = __byte_perm(x, y, 0x6420);
    w[2 * p + 1] = __byte_perm(x, y, 0x7531);
  }
}

template <bool kVec>
__device__ __forceinline__ uint4 load16(const uint8_t* p, int n) {
  if (kVec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int t = 0; t < 16; ++t)
    if (t < n) w[t >> 2] |= uint32_t(p[t]) << (8 * (t & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool kVec>
__device__ __forceinline__ void store16(uint8_t* p, int n,
                                        const uint32_t (&w)[4]) {
  if (kVec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int t = 0; t < 16; ++t)
      if (t < n) p[t] = uint8_t(w[t >> 2] >> (8 * (t & 3)));
  }
}

__device__ __forceinline__ void load_tables(uint32_t* dst,
                                            const uint32_t* src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// Plain mode: item idx = (stripe b, 16-byte piece) over a persistent grid.
// kC, kR fix (c, r) at compile time (0: taken from the arguments).
template <bool kVec, int kC, int kR>
__global__ void __launch_bounds__(kThreads)
gf_direct_kernel(const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                 const uint32_t* __restrict__ gf_tab, int r_arg, int c_arg,
                 long long L, long long nvec, long long total) {
  const int r = kR ? kR : r_arg, c = kC ? kC : c_arg;
  extern __shared__ __align__(16) uint32_t s_gf[];
  load_tables(s_gf, gf_tab, r * c * kTabWords);
  __syncthreads();
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * kThreads) {
    const long long b = idx / nvec;
    const long long off = (idx - b * nvec) * 16;
    const int n = (int)(L - off < 16 ? L - off : 16);
    const uint8_t* in = data + b * c * L + off;
    uint8_t* o = out + b * r * L + off;
    for (int r0 = 0; r0 < r; r0 += kGroup) {
      const int nr = r - r0 < kGroup ? r - r0 : kGroup;
      uint32_t acc[kGroup][4] = {};
      for (int j0 = 0; j0 < c; j0 += kCols) {
        uint4 u[kCols];
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj)
          if (j0 + jj < c) u[jj] = load16<kVec>(in + (j0 + jj) * L, n);
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj)
          if (j0 + jj < c) gf_column(s_gf, c, r0, nr, j0 + jj, u[jj], acc);
      }
#pragma unroll
      for (int rr = 0; rr < kGroup; ++rr)
        if (rr < nr) {
          unpair(acc[rr]);
          store16<kVec>(o + (r0 + rr) * L, n, acc[rr]);
        }
    }
  }
}

// Fused mode: item w = (stripe b, segment s) over a persistent grid;
// segment s covers the real bytes [s*4096 - pad, (s+1)*4096 - pad) of
// each row.  Shared memory: tables | CRC tables | range CRCs | parity (r
// segments) | data (c segments).  Several blocks share an SM, so one
// block's loads overlap another's products and folds.
template <bool kVec, int kC, int kR>
__global__ void __launch_bounds__(kThreads)
gf_fused_kernel(const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                const uint32_t* __restrict__ gf_tab, int r_arg, int c_arg,
                long long L, int nseg, long long pad, long long nwork,
                const uint32_t* __restrict__ crc_tab,
                uint32_t* __restrict__ seg_crc) {
  const int r = kR ? kR : r_arg, c = kC ? kC : c_arg;
  extern __shared__ __align__(16) uint8_t smem[];
  const int ntab = r * c * kTabWords;
  const int ngroups = (c + r + crcseg::kCols - 1) / crcseg::kCols;
  uint32_t* s_gf = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_crc = s_gf + ntab;
  uint32_t* s_part = s_crc + crcseg::kSmemWords;
  uint8_t* s_par = reinterpret_cast<uint8_t*>(
      s_part + ngroups * kWarps * crcseg::kCols);
  uint8_t* s_data = s_par + r * kStride;
  load_tables(s_gf, gf_tab, ntab);
  load_tables(s_crc, crc_tab, crcseg::kSmemWords);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int x = 16 * threadIdx.x;  // this thread's 16 bytes of a segment

  for (long long w = blockIdx.x; w < nwork; w += gridDim.x) {
    const long long b = w / nseg;
    const int s = (int)(w - b * nseg);
    const long long at = (long long)s * kSeg - pad + x;  // real offset
    const uint8_t* in = data + b * c * L;
    __syncthreads();  // tables in place; the last item is done with smem
    if (kVec) {
      // pad is a multiple of 16: a piece is all pad or all data
      for (int j = 0; j < c; ++j)
        crcseg::cp_async16(s_data + j * kStride + x,
                           at >= 0 ? in + j * L + at : in, at >= 0 ? 16 : 0);
      crcseg::cp_async_wait_all();
    } else {
      for (int j = 0; j < c; ++j)
#pragma unroll
        for (int t = 0; t < 16; ++t)
          s_data[j * kStride + x + t] =
              at + t >= 0 ? in[j * L + at + t] : 0;
    }
    __syncthreads();
    uint8_t* o = out + b * r * L;
    for (int r0 = 0; r0 < r; r0 += kGroup) {
      const int nr = r - r0 < kGroup ? r - r0 : kGroup;
      uint32_t acc[kGroup][4] = {};
      for (int j0 = 0; j0 < c; j0 += kCols) {
        uint4 u[kCols];
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj)
          if (j0 + jj < c)
            u[jj] = *reinterpret_cast<const uint4*>(
                s_data + (j0 + jj) * kStride + x);
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj)
          if (j0 + jj < c) gf_column(s_gf, c, r0, nr, j0 + jj, u[jj], acc);
      }
#pragma unroll
      for (int rr = 0; rr < kGroup; ++rr) {
        if (rr >= nr) break;
        const int row = r0 + rr;
        unpair(acc[rr]);
        *reinterpret_cast<uint4*>(s_par + row * kStride + x) =
            make_uint4(acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]);
        if (kVec) {
          if (at >= 0) store16<true>(o + row * L + at, 16, acc[rr]);
        } else {
#pragma unroll
          for (int t = 0; t < 16; ++t)
            if (at + t >= 0)
              o[row * L + at + t] = uint8_t(acc[rr][t >> 2] >> (8 * (t & 3)));
        }
      }
    }
    __syncthreads();
    // segment CRCs of the c + r rows, 8 rows per tensor-core fold: warp w
    // folds bytes [512w, 512w + 512), then a warp per 8 rows joins them
    for (int q = 0; q < ngroups; ++q) {
      const int row = q * crcseg::kCols + (lane >> 2);
      const uint8_t* src = row < c       ? s_data + row * kStride
                           : row < c + r ? s_par + (row - c) * kStride
                                         : nullptr;
      const uint32_t part = crcseg::fold_range8(src, warp, s_crc, lane);
      if (lane < crcseg::kCols)
        s_part[(q * kWarps + warp) * crcseg::kCols + lane] = part;
    }
    __syncthreads();
    for (int q = warp; q < ngroups; q += kWarps) {
      const uint32_t crc =
          crcseg::join_ranges(s_part + q * kWarps * crcseg::kCols, lane);
      const int row = q * crcseg::kCols + lane;
      if (lane < crcseg::kCols && row < c + r)
        seg_crc[(b * (c + r) + row) * nseg + s] = crc;
    }
  }
}

using DirectFn = void (*)(const uint8_t*, uint8_t*, const uint32_t*, int,
                         int, long long, long long, long long);
using FusedFn = void (*)(const uint8_t*, uint8_t*, const uint32_t*, int,
                         int, long long, int, long long, long long,
                         const uint32_t*, uint32_t*);

// The kernels compiled for (c, r) = (i / kGroup + 1, i % kGroup + 1).
template <int... I>
DirectFn direct_fixed(int i, std::integer_sequence<int, I...>) {
  static const DirectFn table[] = {
      &gf_direct_kernel<true, I / kGroup + 1, I % kGroup + 1>...};
  return table[i];
}

template <int... I>
FusedFn fused_fixed(int i, std::integer_sequence<int, I...>) {
  static const FusedFn table[] = {
      &gf_fused_kernel<true, I / kGroup + 1, I % kGroup + 1>...};
  return table[i];
}

constexpr auto kFixed = std::make_integer_sequence<int, kCols * kGroup>{};

// Whether a kernel compiled for (c, r) serves the call: 16-byte aligned
// rows and a matrix of at most kGroup x kCols.
bool fixed_shape(bool vec, int r, int c) {
  return vec && r <= kGroup && c <= kCols;
}

}  // namespace

// data (B, c, L) uint8 -> out (B, r, L) uint8 on `stream`, plain mode.
// gf_tables: the product tables above.  Returns the launch's cudaError_t.
extern "C" int ceph_gf_encode(const void* data, void* out,
                              const void* gf_tables, int B, int r, int c,
                              long long L, void* stream) {
  if (B == 0 || r == 0 || L == 0) return 0;  // nothing to launch
  const bool vec = L % 16 == 0 && (uintptr_t)data % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const DirectFn kernel =
      fixed_shape(vec, r, c) ? direct_fixed((c - 1) * kGroup + r - 1, kFixed)
      : vec                  ? &gf_direct_kernel<true, 0, 0>
                             : &gf_direct_kernel<false, 0, 0>;
  const size_t smem = (size_t)r * c * kTabWords * 4;
  const long long nvec = (L + 15) / 16, total = (long long)B * nvec;
  int blocks = 0;
  cudaError_t err = crcseg::persistent_blocks(
      kernel, kThreads, smem, (total + kThreads - 1) / kThreads, &blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<uint8_t*>(out),
      static_cast<const uint32_t*>(gf_tables), r, c, L, nvec, total);
  return (int)cudaGetLastError();
}

// The fused mode: as ceph_gf_encode, and seg_crc receives the segment
// CRCs of the c data rows then the r parity rows of each stripe,
// (B, c + r, ceil(L / 4096)) uint32, for ceph_crc32c_chain.  crc_tables
// is crc_seg.cuh's block.  Returns the launch's cudaError_t.
extern "C" int ceph_gf_encode_crc(const void* data, void* out,
                                  const void* gf_tables, int B, int r, int c,
                                  long long L, const void* crc_tables,
                                  void* seg_crc, void* stream) {
  if (B == 0 || r == 0 || L == 0) return 0;  // nothing to launch
  const bool vec = L % 16 == 0 && (uintptr_t)data % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const FusedFn kernel =
      fixed_shape(vec, r, c) ? fused_fixed((c - 1) * kGroup + r - 1, kFixed)
      : vec                  ? &gf_fused_kernel<true, 0, 0>
                             : &gf_fused_kernel<false, 0, 0>;
  const int nseg = (int)((L + kSeg - 1) / kSeg);
  const long long pad = (long long)nseg * kSeg - L;
  const long long nwork = (long long)B * nseg;
  const int ngroups = (c + r + crcseg::kCols - 1) / crcseg::kCols;
  const size_t smem =
      (size_t)r * c * kTabWords * 4 +
      (crcseg::kSmemWords + ngroups * kWarps * crcseg::kCols) * 4 +
      (size_t)(r + c) * kStride;
  int blocks = 0;
  cudaError_t err =
      crcseg::persistent_blocks(kernel, kThreads, smem, nwork, &blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<uint8_t*>(out),
      static_cast<const uint32_t*>(gf_tables), r, c, L, nseg, pad, nwork,
      static_cast<const uint32_t*>(crc_tables),
      static_cast<uint32_t*>(seg_crc));
  return (int)cudaGetLastError();
}
