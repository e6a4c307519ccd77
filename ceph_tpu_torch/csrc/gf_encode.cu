// GF(2^8) matrix x chunks on Hopper: erasure encode and rebuild decode.
//
// Replaces ceph_tpu/ops/pallas_ec.py:_encode_kernel.  out[b, i, :] =
// XOR_j M[i][j] * data[b, j, :] over GF(2^8) with polynomial 0x11D, for
// an (r, c) matrix: r = m parity rows to encode, r = |want| rows to
// rebuild from c = |present| surviving chunks.
//
// Bound: device memory.  The pass reads B*c*L bytes and writes B*r*L,
// and does a few integer operations per byte, far below the card's
// integer rate.  The Pallas kernel expanded every byte to 8 bit planes
// so the product could run on the TPU's matrix unit; here that would
// only multiply register traffic, so the kernel works on bytes:
//   * each thread owns 16 contiguous bytes (one uint4) of one stripe's
//     chunk axis and produces them for all r outputs, so every input
//     byte is read from device memory once per pass over kRowTile
//     output rows, with 16-byte coalesced loads and stores;
//   * a GF(2^8) product is exp[log a + log x] with the log/exp tables
//     (768 bytes) and the matrix's logs in shared memory; the log of
//     each input byte is taken once and reused for every output row;
//     log 255 marks a zero byte or a zero coefficient;
//   * a ragged tail (L not a multiple of 16, or unaligned rows) runs
//     the same code with byte loads and stores masked to the row.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 4;        // output rows accumulated per input pass
constexpr int kZeroLog = 255;      // log sentinel: zero byte / coefficient
constexpr int kTables = 768;       // log[256] then exp[512]
constexpr long long kMaxBlocks = 132 * 16;

template <bool kVec>
__device__ __forceinline__ void load16(const uint8_t* p, int n,
                                       uint32_t w[4]) {
  if (kVec) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = 0;
#pragma unroll
    for (int t = 0; t < 16; ++t)
      if (t < n) w[t >> 2] |= uint32_t(p[t]) << (8 * (t & 3));
  }
}

template <bool kVec>
__device__ __forceinline__ void store16(uint8_t* p, int n,
                                        const uint32_t w[4]) {
  if (kVec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int t = 0; t < 16; ++t)
      if (t < n) p[t] = uint8_t(w[t >> 2] >> (8 * (t & 3)));
  }
}

// params: log[256] | exp[512] | log of M, row-major (r, c)
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gf_encode_kernel(const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                 const uint8_t* __restrict__ params, int r, int c,
                 long long L, long long nvec, long long total) {
  extern __shared__ uint8_t smem[];
  const uint8_t* s_log = smem;
  const uint8_t* s_exp = smem + 256;
  const uint8_t* s_mlog = smem + kTables;
  const int nparams = kTables + r * c;
  for (int i = threadIdx.x; i < nparams; i += blockDim.x) smem[i] = params[i];
  __syncthreads();

  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += step) {
    const long long b = idx / nvec;
    const long long off = (idx - b * nvec) * 16;
    const int n = (int)(L - off < 16 ? L - off : 16);
    const uint8_t* in = data + b * c * L + off;
    uint8_t* o = out + b * r * L + off;
    for (int r0 = 0; r0 < r; r0 += kRowTile) {
      uint32_t acc[kRowTile][4];
#pragma unroll
      for (int rr = 0; rr < kRowTile; ++rr)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[rr][q] = 0;
      for (int j = 0; j < c; ++j) {
        uint32_t w[4];
        load16<kVec>(in + j * L, n, w);
        uint8_t lg[16];
#pragma unroll
        for (int t = 0; t < 16; ++t)
          lg[t] = s_log[(w[t >> 2] >> (8 * (t & 3))) & 0xff];
#pragma unroll
        for (int rr = 0; rr < kRowTile; ++rr) {
          if (r0 + rr >= r) break;
          const int la = s_mlog[(r0 + rr) * c + j];
          if (la == kZeroLog) continue;
#pragma unroll
          for (int t = 0; t < 16; ++t) {
            const int l = lg[t];
            const uint32_t p = l == kZeroLog ? 0u : uint32_t(s_exp[l + la]);
            acc[rr][t >> 2] ^= p << (8 * (t & 3));
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowTile; ++rr)
        if (r0 + rr < r) store16<kVec>(o + (r0 + rr) * L, n, acc[rr]);
    }
  }
}

}  // namespace

// data (B, c, L) uint8 -> out (B, r, L) uint8 on `stream`; params as
// above (kTables + r*c bytes, at most 48 KiB in all).  Returns the
// launch's cudaError_t.
extern "C" int ceph_gf_encode(const void* data, void* out, const void* params,
                              int B, int r, int c, long long L,
                              void* stream) {
  const long long nvec = (L + 15) / 16;
  const long long total = (long long)B * nvec;
  if (total == 0 || r == 0) return 0;  // nothing to launch
  const bool vec = L % 16 == 0 && (uintptr_t)data % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const size_t shmem = kTables + (size_t)r * c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  const auto* p = static_cast<const uint8_t*>(params);
  if (vec)
    gf_encode_kernel<true><<<(unsigned)blocks, kThreads, shmem, s>>>(
        in, o, p, r, c, L, nvec, total);
  else
    gf_encode_kernel<false><<<(unsigned)blocks, kThreads, shmem, s>>>(
        in, o, p, r, c, L, nvec, total);
  return (int)cudaGetLastError();
}
