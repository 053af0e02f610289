// Chunked multilinear MAC over Mersenne-31: one tag per chunk of words.
//
// Replaces the Pallas kernel mac_tags_words (src/repro/kernels/tree_mac/
// kernel.py:53, body _mac_kernel).  For item n, row r and chunk c of cw
// words w_j:
//
//   tag = canon( sum_j mulmod(fold(w_j) + 1, key[n, j])
//                + mulmod(pos + 1, key[n, 0]) )  mod 2^31 - 1,
//   pos = canon((((row0 + r) * n_chunks + c) * 0x9E3779B1) mod 2^32),
//
// row0 the item's first row (0 unless the launch is a slab of rows of a
// larger item, below), all in uint32 arithmetic as in the reference.
//
// Unlike the Pallas kernel, cw is any positive divisor of the row's word
// count (block_tags picks the smallest chunk count that divides it: cw = 2
// for granite's unembed rows of 24,578 words), and the keys are per item
// (page MAC keys are bound to each page's nonce).  Rows of 16-bit elements
// of odd width end in a half-used word whose high half reads as zero.
//
// What bounds it on the H100: every ciphertext byte is read once and every
// tag written once, at 3.35 TB/s; the arithmetic is a few integer
// operations a word.  So the design is about the loads:
//
// - The buffer is read as a stream of aligned 16-byte vectors (its base is
//   16-byte aligned, ops.py sees to it).  A row of odd-width 16-bit
//   elements starts 2 bytes into a 4-byte word every other row; its words
//   are rebuilt with a funnel shift of two aligned words, the second taken
//   from the next lane's vector by a shuffle.  The row's last word keeps
//   its zero high half and never takes the next row's first element.
// - Three paths, chosen by the launcher from (cw, row width):
//   small (cw <= 8): a lane owns the chunks that start in its vector (two
//     at cw = 2), reads their words from its own and the next lanes'
//     vectors and writes its tags as one 8- or 16-byte store where they are
//     aligned; no reduction across lanes;
//   wide (cw = 32 ... 512, rows of whole words): chunks lie back to back,
//     G = cw / 16 lanes take a chunk, each 4 vectors (4 loads in flight)
//     at fixed word positions, so its 16 keys stay in registers for every
//     chunk the warp visits; a shuffle tree over the G lanes;
//   general (any other cw or alignment): a group of lanes per chunk, keys
//     read per word, the same aligned vectors and funnel shift.
// - Indices within a launch's item are 32-bit: an item holds fewer than
//   2^31 words.  The wrapper (kernels/tree_mac/ops.py) launches a larger
//   item (moonshot's stacked expert w_gate at 24 layers: 2.21 G words) as
//   slabs of rows, each under that limit and starting 16-byte aligned,
//   passing each slab's first row as row0: only the chunk positions see
//   it, so the tags are those of one launch over the whole item.  Only a
//   row's base offset is 64-bit, and a multiplication.  Rows and chunks
//   come from blockIdx and loop counters, and every division is by a
//   compile-time constant.
// - Lazy sums: a word w < 2^32 times a canonical key <= 2^31 - 2 is under
//   2^63 - 2^33, so two products and an accumulator below 5 * 2^31 stay
//   under 2^64 - 2^33 without a fold; one fold (a == (a & p) + (a >> 31)
//   mod p) then brings any uint64 back below 5 * 2^31.  The accumulators
//   start below that too (the sum of up to 16 keys is folded first).  The
//   small and wide paths multiply the raw word and add the sum of the keys
//   once, since sum_j (w_j + 1) k_j = sum_j w_j k_j + sum_j k_j and
//   fold(w) + 1 == w + 1 mod p.  Every step is exact mod p, so the
//   canonical tag is the reference's.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kMaxGridY = 65535;
constexpr int kSmallVectors = 4;                 // per lane and segment
constexpr int kSegment = 32 * kSmallVectors;     // vectors of a warp
constexpr int kWideBlocksPerSm = 4;

// Below 5 * 2^31 and congruent mod p, for any uint64: 2^31 == 1 mod p.
__device__ __forceinline__ uint64_t fold31(uint64_t a) {
  return (a & repro::kP31) + (a >> 31);
}

// The canonical residue of any uint64.
__device__ __forceinline__ uint32_t canon64(uint64_t a) {
  a = (a & repro::kP31) + (a >> 31);   // < 2^31 + 2^33
  a = (a & repro::kP31) + (a >> 31);   // < 2^31 + 8
  return repro::canon(static_cast<uint32_t>(a));
}

// The tag of a chunk from its sum (< 5 * 2^31), its index and key 0.
__device__ __forceinline__ uint32_t finish(uint64_t sum, uint32_t i,
                                           uint32_t k0) {
  const uint32_t pos = repro::canon(i * repro::kPosMix);
  return canon64(sum + static_cast<uint64_t>(pos + 1u) * k0);
}

__device__ __forceinline__ uint4 shfl4(uint4 v, int src) {
  return make_uint4(__shfl_sync(0xFFFFFFFFu, v.x, src),
                    __shfl_sync(0xFFFFFFFFu, v.y, src),
                    __shfl_sync(0xFFFFFFFFu, v.z, src),
                    __shfl_sync(0xFFFFFFFFu, v.w, src));
}

// Row r of item n starts rb bytes into the buffer: at word a_r of vector
// rb / 16, shifted by sh bits (16 for a 16-bit row that starts at an odd
// element).
struct Row {
  const uint4* v;
  uint32_t a_r, sh, lv_last;
};

__device__ __forceinline__ Row row_at(const uint4* x, uint32_t n,
                                      uint32_t n_rows, uint32_t r,
                                      uint64_t row_bytes, uint32_t words) {
  const uint64_t rb = (static_cast<uint64_t>(n) * n_rows + r) * row_bytes;
  Row row;
  row.v = x + (rb >> 4);
  row.a_r = static_cast<uint32_t>(rb >> 2) & 3u;
  row.sh = static_cast<uint32_t>(rb & 2u) << 3;
  row.lv_last = (row.a_r + words - 1u) >> 2;
  return row;
}

// small: a warp takes kSegment vectors of a row; lane l of step u holds
// vector 32 u + l and owns the chunks whose first word lies in it.  Their
// words reach 3 + CW words past the vector's start, into the next one
// (lane l + 1) and, for CW > 4, the one after (lane l + 2).
template <int CW>
__global__ void __launch_bounds__(kThreads) mac_small_kernel(
    const uint4* __restrict__ x, const uint32_t* __restrict__ keys,
    uint32_t* __restrict__ tags, uint32_t n_rows, uint64_t row_bytes,
    uint32_t words, uint32_t n_chunks, bool odd16, uint32_t row0) {
  const int lane = threadIdx.x & 31;
  const uint32_t n = blockIdx.z;
  const uint32_t lv0 = (blockIdx.x * kWarps + threadIdx.x / 32) * kSegment;
  uint32_t key[CW];
  uint64_t ksum = 0;
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    key[j] = repro::canon(__ldg(keys + n * CW + j));
    ksum += key[j];
  }
  ksum = fold31(ksum);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (uint32_t r = blockIdx.y; r < n_rows; r += gridDim.y) {
    const Row row = row_at(x, n, n_rows, r, row_bytes, words);
    if (lv0 > row.lv_last) continue;   // the whole warp
    uint32_t* trow = tags + (static_cast<uint64_t>(n) * n_rows + r) * n_chunks;
    const uint32_t ibase = (row0 + r) * n_chunks;
    uint4 v[kSmallVectors];
#pragma unroll
    for (int u = 0; u < kSmallVectors; ++u) {
      const uint32_t lv = lv0 + 32 * u + lane;
      v[u] = lv <= row.lv_last ? __ldg(row.v + lv) : zero;
    }
    // the two vectors after the segment, for lanes 30 and 31 of the last step
    uint4 x1 = zero, x2 = zero;
    if ((lane == 31 || (CW > 4 && lane == 30)) && lv0 + kSegment <= row.lv_last)
      x1 = __ldg(row.v + lv0 + kSegment);
    if (CW > 4 && lane == 31 && lv0 + kSegment + 1 <= row.lv_last)
      x2 = __ldg(row.v + lv0 + kSegment + 1);
#pragma unroll
    for (int u = 0; u < kSmallVectors; ++u) {
      const bool more = u + 1 < kSmallVectors;
      const uint4 next = v[more ? u + 1 : u];
      // lane l takes lane l + 1's vector; lane 31 lane 0's of the next step
      uint4 n1 = shfl4(more && lane == 0 ? next : v[u], (lane + 1) & 31);
      if (!more && lane == 31) n1 = x1;
      uint4 n2 = zero;
      if (CW > 4) {
        n2 = shfl4(more && lane < 2 ? next : v[u], (lane + 2) & 31);
        if (!more && lane == 30) n2 = x1;
        if (!more && lane == 31) n2 = x2;
      }
      const uint32_t w[12] = {v[u].x, v[u].y, v[u].z, v[u].w, n1.x, n1.y,
                              n1.z,   n1.w,   n2.x,   n2.y,   n2.z, n2.w};
      const int off0 =
          static_cast<int>(4u * (lv0 + 32 * u + lane)) - static_cast<int>(row.a_r);
      uint32_t tg[4] = {0u, 0u, 0u, 0u};
      bool ok[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int off = off0 + p;   // the word's index in the row
        ok[p] = off >= 0 && off < static_cast<int>(words) && off % CW == 0;
        if (!ok[p]) continue;
        uint64_t acc = ksum;
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          uint32_t wd = __funnelshift_r(w[p + j], w[p + j + 1], row.sh);
          if (odd16 && off + j == static_cast<int>(words) - 1) wd &= 0xFFFFu;
          acc = static_cast<uint64_t>(wd) * key[j] + acc;
          if (j & 1) acc = fold31(acc);
        }
        tg[p] = finish(fold31(acc), ibase + off / CW, key[0]);
      }
      // chunk c of the first start in the vector; the others follow it
      const int first = ((-off0) % CW + CW) % CW;
      const int c = (off0 + first) / CW;
      const bool f0 = first == 0;   // cw 2: the pair (0, 2) or (1, 3)
      if (CW == 1 && ok[0] && ok[3] &&
          (reinterpret_cast<uintptr_t>(trow + c) & 15u) == 0) {
        *reinterpret_cast<uint4*>(trow + c) = make_uint4(tg[0], tg[1], tg[2], tg[3]);
      } else if (CW == 2 && (f0 ? ok[0] && ok[2] : ok[1] && ok[3]) &&
                 (reinterpret_cast<uintptr_t>(trow + c) & 7u) == 0) {
        *reinterpret_cast<uint2*>(trow + c) =
            f0 ? make_uint2(tg[0], tg[2]) : make_uint2(tg[1], tg[3]);
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (ok[p]) trow[(off0 + p) / CW] = tg[p];
      }
    }
  }
}

// wide: chunk i of an item is vectors [i cw/4, (i+1) cw/4); lane lg of its
// group of G reads vectors lg + G u (u < 4), always at the same word
// positions of the chunk, so it keeps those 16 keys and their sum.  Its
// position index is pos0 + i (pos0 = row0 * n_chunks mod 2^32).
template <int G>
__global__ void __launch_bounds__(kThreads) mac_wide_kernel(
    const uint4* __restrict__ x, const uint32_t* __restrict__ keys,
    uint32_t* __restrict__ tags, uint32_t chunks, uint32_t pos0) {
  constexpr uint32_t kVecs = 4 * G;   // vectors of a chunk (cw = 16 G)
  constexpr uint32_t kPerWarp = 32 / G;
  const int lane = threadIdx.x & 31;
  const uint32_t lg = lane % G;
  const uint32_t n = blockIdx.y;
  const uint4* kv = reinterpret_cast<const uint4*>(keys + n * (4 * kVecs));
  uint32_t k[16];
  uint64_t ksum = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const uint4 t = __ldg(kv + lg + G * u);
    k[4 * u] = repro::canon(t.x);
    k[4 * u + 1] = repro::canon(t.y);
    k[4 * u + 2] = repro::canon(t.z);
    k[4 * u + 3] = repro::canon(t.w);
#pragma unroll
    for (int q = 0; q < 4; ++q) ksum += k[4 * u + q];
  }
  ksum = fold31(ksum);
  const uint4* xi = x + static_cast<uint64_t>(n) * chunks * kVecs;
  uint32_t* ti = tags + static_cast<uint64_t>(n) * chunks;
  const uint32_t warp = blockIdx.x * kWarps + threadIdx.x / 32;
  const uint32_t stride = gridDim.x * kWarps * kPerWarp;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (uint32_t i0 = warp * kPerWarp; i0 < chunks; i0 += stride) {
    const uint32_t i = i0 + lane / G;
    const bool valid = i < chunks;
    uint4 d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      d[u] = valid ? __ldg(xi + i * kVecs + lg + G * u) : zero;
    uint64_t acc = ksum;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc = static_cast<uint64_t>(d[u].x) * k[4 * u] + acc;
      acc = fold31(static_cast<uint64_t>(d[u].y) * k[4 * u + 1] + acc);
      acc = static_cast<uint64_t>(d[u].z) * k[4 * u + 2] + acc;
      acc = fold31(static_cast<uint64_t>(d[u].w) * k[4 * u + 3] + acc);
    }
    uint32_t s = canon64(acc);
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      s = repro::fold32(s + __shfl_xor_sync(0xFFFFFFFFu, s, o));
    if (lg == 0 && valid) ti[i] = finish(s, pos0 + i, k[0]);
  }
}

// general: a group of G lanes per chunk reads the vectors that hold it,
// lane lg those lg, lg + G, ...; key j is read for word j.
template <int G>
__global__ void __launch_bounds__(kThreads) mac_general_kernel(
    const uint4* __restrict__ x, const uint32_t* __restrict__ keys,
    uint32_t* __restrict__ tags, uint32_t n_rows, uint64_t row_bytes,
    uint32_t words, uint32_t n_chunks, uint32_t cw, bool odd16,
    uint32_t row0) {
  const int lane = threadIdx.x & 31;
  const uint32_t lg = lane % G;
  const uint32_t c = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  if (c >= n_chunks) return;   // whole groups leave together
  const unsigned gmask =
      G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u) << (lane & ~(G - 1));
  const uint32_t n = blockIdx.z;
  const uint32_t* kp = keys + static_cast<uint64_t>(n) * cw;
  const uint32_t k0 = repro::canon(__ldg(kp));
  for (uint32_t r = blockIdx.y; r < n_rows; r += gridDim.y) {
    const Row row = row_at(x, n, n_rows, r, row_bytes, words);
    // the chunk's first word, counted from the row's first vector
    const uint32_t c0 = row.a_r + c * cw;
    const uint32_t lv1 = (c0 + cw - 1u) >> 2;
    uint64_t acc = 0;
    for (uint32_t lvb = c0 >> 2; lvb <= lv1; lvb += G) {
      const uint32_t lv = lvb + lg;
      const bool valid = lv <= lv1;
      const uint4 d = valid ? __ldg(row.v + lv) : make_uint4(0u, 0u, 0u, 0u);
      uint32_t nx = __shfl_down_sync(gmask, d.x, 1, G);
      if (row.sh && valid && (lg == G - 1 || lv == lv1))
        nx = lv + 1 <= row.lv_last ? __ldg(row.v + lv + 1).x : 0u;
      const uint32_t w[5] = {d.x, d.y, d.z, d.w, nx};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = static_cast<int>(4u * lv + q) - static_cast<int>(c0);
        if (!valid || j < 0 || j >= static_cast<int>(cw)) continue;
        uint32_t wd = __funnelshift_r(w[q], w[q + 1], row.sh);
        if (odd16 && c * cw + j == words - 1u) wd &= 0xFFFFu;
        acc = fold31(static_cast<uint64_t>(repro::fold32(wd) + 1u) *
                         __ldg(kp + j) + acc);
      }
    }
    uint32_t s = canon64(acc);
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      s = repro::fold32(s + __shfl_xor_sync(gmask, s, o, G));
    if (lg == 0)
      tags[(static_cast<uint64_t>(n) * n_rows + r) * n_chunks + c] =
          finish(s, (row0 + r) * n_chunks + c, k0);
  }
}

using RowKernel = void (*)(const uint4*, const uint32_t*, uint32_t*,
                          uint32_t, uint64_t, uint32_t, uint32_t, bool,
                          uint32_t);
using GeneralKernel = void (*)(const uint4*, const uint32_t*, uint32_t*,
                               uint32_t, uint64_t, uint32_t, uint32_t,
                               uint32_t, bool, uint32_t);
using WideKernel = void (*)(const uint4*, const uint32_t*, uint32_t*,
                            uint32_t, uint32_t);

// by cw - 1; by log2(G) - 1 for G = 2 ... 32
constexpr RowKernel kSmall[] = {
    mac_small_kernel<1>, mac_small_kernel<2>, mac_small_kernel<3>,
    mac_small_kernel<4>, mac_small_kernel<5>, mac_small_kernel<6>,
    mac_small_kernel<7>, mac_small_kernel<8>};
constexpr GeneralKernel kGeneral[] = {
    mac_general_kernel<2>, mac_general_kernel<4>, mac_general_kernel<8>,
    mac_general_kernel<16>, mac_general_kernel<32>};
constexpr WideKernel kWide[] = {mac_wide_kernel<2>, mac_wide_kernel<4>,
                                mac_wide_kernel<8>, mac_wide_kernel<16>,
                                mac_wide_kernel<32>};

int log2_floor(uint32_t v) { return 31 - __builtin_clz(v); }

}  // namespace

// x: N x R x E elements of elem_bytes (2 or 4), contiguous, 16-byte
// aligned; a row is W = ceil(E * elem_bytes / 4) words, W % cw == 0 and
// R * W < 2^31.  keys: uint32[N, cw] canonical, 16-byte aligned.  tags:
// uint32[N, R, W / cw].  row0: the rows' index in their items (a slab of
// a larger item starts at row0; else 0).  Returns cudaGetLastError().
extern "C" int mac_tags_launch(const void* x, const void* keys, void* tags,
                               int64_t n_items, int64_t n_rows,
                               int64_t n_elems, int elem_bytes, int cw,
                               uint32_t row0, void* stream) {
  const uint64_t row_bytes = static_cast<uint64_t>(n_elems) * elem_bytes;
  const uint32_t words = static_cast<uint32_t>((row_bytes + 3) / 4);
  const uint32_t nc = words / cw;
  const uint32_t N = static_cast<uint32_t>(n_items);
  const uint32_t R = static_cast<uint32_t>(n_rows);
  const bool odd16 = elem_bytes == 2 && (n_elems & 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* xv = static_cast<const uint4*>(x);
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  uint32_t* t = static_cast<uint32_t*>(tags);
  dim3 grid(1, R < kMaxGridY ? R : kMaxGridY, N);
  if (cw <= 8) {
    // vectors a row may touch, in segments of a warp, 8 warps a block
    const uint32_t segs = (((words + 2) >> 2) + kSegment) / kSegment;
    grid.x = (segs + kWarps - 1) / kWarps;
    kSmall[cw - 1]<<<grid, kThreads, 0, s>>>(xv, k, t, R, row_bytes, words,
                                             nc, odd16, row0);
  } else if (row_bytes % 4 == 0 && cw >= 32 && cw <= 512 && !(cw & (cw - 1))) {
    // G = cw / 16 lanes a chunk; a grid-stride loop over the item's chunks
    const int g = log2_floor(cw / 16);
    const uint32_t chunks = R * nc, per_warp = 32u >> g;
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const uint32_t need =
        ((chunks + per_warp - 1) / per_warp + kWarps - 1) / kWarps;
    const uint32_t wave = (sms * kWideBlocksPerSm + N - 1) / N;
    const dim3 wide(need < wave ? need : wave, N);
    kWide[g - 1]<<<wide, kThreads, 0, s>>>(xv, k, t, chunks, row0 * nc);
  } else {
    // G = the largest power of two <= cw / 4, from 2 to 32
    int g = log2_floor(static_cast<uint32_t>(cw) / 4);
    g = g < 1 ? 1 : (g > 5 ? 5 : g);
    grid.x = (nc + (kThreads >> g) - 1) / (kThreads >> g);
    kGeneral[g - 1]<<<grid, kThreads, 0, s>>>(
        xv, k, t, R, row_bytes, words, nc, static_cast<uint32_t>(cw), odd16,
        row0);
  }
  return static_cast<int>(cudaGetLastError());
}
