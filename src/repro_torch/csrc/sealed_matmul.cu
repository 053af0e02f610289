// Sealed matrix product: C = unseal(A_ct) @ unseal(B_ct), with every MAC
// chunk of both operands verified once.
//
// Replaces the Pallas kernel sealed_matmul (src/repro/kernels/sealed_matmul/
// kernel.py:118, body _sealed_matmul_kernel, helpers _unseal_tile_bf16 and
// _tile_tags).  A is uint16[M, K] and B uint16[K, N]: the bits of bf16
// ciphertext, sealed in the shaped lattice (core/cipher.py seal_bits), so
// element (r, c) of either is XORed with half c % 2 of word (c / 2) % 2 of
// threefry2x32(tensor key, (r, c / 4)).  C is bf16[M, N], the f32 sum of
// products rounded once.  The data format is fixed: M, K, N are multiples
// of 256, every row of A and B is tagged in chunks of 256 bf16 (128 words,
// tags_a uint32[M, K/256], tags_b uint32[K, N/256]), and bad int32[M/256,
// N/256] counts, for output tile (i, j), the mismatched chunks of A's rows
// 256i..256i+255 plus those of B's chunk column j: what the Pallas grid
// counts when its step (i, j, k) checks the tiles it fetches.
//
// What bounds it on the H100: the keystream.  The plaintext may not reach
// device memory, so every block regenerates the keystream of the tiles it
// multiplies: 74 integer operations per Threefry block of four bf16, and
// 18.5 M K N (1/(BN CN) + 1/(BM CM)) operations in all for BM x BN output
// tiles in clusters of CM x CN blocks.  The rotates (SHF) and XORs (LOP3)
// issue only on the ALU pipe; ptxas issues most of the 32 adds as IMAD on
// the FMA pipe beside them.
//
// Design.  A block owns a 128 x 256 output tile and walks K in stages of
// 64 through a ring of three plaintext stages in shared memory: A K-major
// and B N-major (wgmma's transposed B), both in the 128-byte swizzle the
// wgmma descriptors name.  Blocks run in clusters of CM along M x CN along
// N (the largest of 4, 2 and of 2, 1 that divide the grid, chosen per
// launch).  The CN blocks of a cluster row share their A stage and the CM
// blocks of a cluster column their B stage: each block decrypts 1/CN of
// the A stage and 1/CM of the B stage and writes the plaintext into every
// block that shares it, its own share with plain shared stores and the
// peers' with st.async, which completes bytes on the peer's "full"
// mbarrier.  So each keystream word is made once per cluster, not once
// per block, and plaintext exists only in registers and the cluster's
// shared memory.  Ciphertext comes in by cp.async one stage ahead, into a
// ring of two slots, each thread fetching the units it decrypts.
//
// The block is warp-specialised (setmaxnreg): two wgmma warpgroups (184
// registers a thread, 128 of them f32 accumulators) each multiply a
// 64 x 256 half with wgmma m64n256k16, and one decrypting warpgroup (136
// registers) makes most of the keystream without ever waiting on the
// tensor cores.  The wgmma warps, idle while the tensor cores run, decrypt
// two units (four Threefry blocks) of the next stage each.  A stage's
// buffer is reused once both wgmma warpgroups of every block that reads it
// have arrived on the writer's "empty" mbarrier.  A block leaves only
// after a last cluster barrier, when no peer writes into it any more.
// Measured on the card: the decrypting warps bound the kernel (one warp
// per scheduler issues their Threefry chains, and the peers' bytes cost
// DSMEM bandwidth); clusters of 4 x 2 are the fastest of the four shapes.
// Verification is a first pass, one warp per 128-word chunk (16-byte
// loads, exact M31 sums, warp-shuffle combine), that counts mismatches per
// A row tile and per B chunk column with atomics; the product's block
// whose rows start a 256-tile adds the two counts into bad.  So each chunk
// is verified once, not once per output tile as in the Pallas kernel.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kTile = 256;         // bad grid tile and MAC chunk, in bf16
constexpr int kChunkWords = kTile / 2;
constexpr int BM = 128, BN = 256, BK = 64;
constexpr int kMmaThreads = 256;   // two wgmma warpgroups
constexpr int kDecThreads = 128;   // one decrypting warpgroup
constexpr int kThreads = kMmaThreads + kDecThreads;
// registers a thread after setmaxnreg: 2 x 128 x 184 + 128 x 136 = 64,512,
// the 168 x 384 the launch holds
constexpr int kMmaRegs = 184, kDecRegs = 136;
constexpr int A_BYTES = BM * BK * 2;             // 16 KB, [128 rows][128 B]
constexpr int B_BYTES = BK * BN * 2;             // 32 KB, [4][64 k][128 B]
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int kStages = 3;         // plaintext ring
constexpr int A_UNITS = BM * BK / 8;   // 16-byte units (two Threefry blocks)
constexpr int B_UNITS = BK * BN / 8;

// A block's share of a stage: UA_TOT 16-byte units of A (its rows of the
// cluster row's A stage) and UB_TOT of B (its k-rows of the cluster
// column's B stage), numbered v = 0.. (A first).  Each wgmma thread
// decrypts MU of them, units v = j * 256 + thread (all of A), and each
// decrypting thread UD, units v = 256 MU + j * 128 + thread.  Unit v's
// ciphertext sits at v * 16 bytes of a slot (two slots in a ring).
template <int CM, int CN>
struct Share {
  static constexpr int UA_TOT = A_UNITS / CN;
  static constexpr int UB_TOT = B_UNITS / CM;
  static constexpr int U_TOT = UA_TOT + UB_TOT;
  static constexpr int MU = 2;
  static constexpr int UD = (U_TOT - kMmaThreads * MU) / kDecThreads;
  static_assert(kMmaThreads * MU <= UA_TOT && UD * kDecThreads ==
                U_TOT - kMmaThreads * MU, "units divide among threads");
  // units whose keystream a decrypting thread makes together: 2 G
  // independent Threefry chains
  static constexpr int G = UD % 8 == 0   ? 8
                           : UD % 6 == 0 ? 6
                           : UD % 4 == 0 ? 4
                                         : 2;
  static_assert(UD % G == 0, "units come in groups");
  static constexpr int CT_BYTES = U_TOT * 16;
  // bytes of a stage that the cluster's other blocks write into this one
  static constexpr int PEER_BYTES = STAGE_BYTES - CT_BYTES;
  static constexpr int BAR_OFF = kStages * STAGE_BYTES + 2 * CT_BYTES;
  // plaintext ring, ciphertext ring, full[kStages] and empty[kStages]
  // mbarriers, and slack for 1024-byte alignment
  static constexpr int SMEM = BAR_OFF + 2 * kStages * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in bits 0-15
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The shared-memory address of this block's ``addr`` in cluster block rank.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// 16 bytes into a cluster block's shared memory; the write completes 16
// bytes of the transaction count of that block's mbarrier ``bar``.
__device__ __forceinline__ void st_async(uint32_t addr, uint4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32"
      " [%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Arrive on the mbarrier at shared::cluster address ``bar`` (any block).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// Wait for the phase of parity ``parity`` to complete.  The loop is in PTX
// so that the kernel's control flow stays straight for the wgmma register
// analysis; a barrier that never completes (a fault) traps after 2^26
// polls instead of hanging the card, and the launch fails.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.eq.u32 p, n, 0x4000000;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}"
      :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d[64 x 256] += A[64 x 16] (K-major) * B[16 x 256] (N-major, transposed)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16\n"
      "{ %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Units v = FIRST + j * STRIDE + idx (j < NU) of this block's share of a
// stage: A row and column of unit v in the cluster row's A stage, or k-row
// and column of B, in 16-byte (8 bf16) units.
template <int CM, int CN>
__device__ __forceinline__ bool unit_is_a(int v) {
  return v < Share<CM, CN>::UA_TOT;
}

template <int CM, int CN>
__device__ __forceinline__ int unit_index(int v, int cm, int cn) {
  using S = Share<CM, CN>;
  return unit_is_a<CM, CN>(v) ? cn * S::UA_TOT + v
                              : cm * S::UB_TOT + (v - S::UA_TOT);
}

// Copy units (FIRST, STRIDE, NU; idx) of stage k0 into the ciphertext slot
// at shared address ``slot`` (cp.async, one group).
template <int CM, int CN, int FIRST, int STRIDE, int NU>
__device__ __forceinline__ void fetch_units(
    const uint16_t* __restrict__ a, const uint16_t* __restrict__ b, int K,
    int N, int row0, int col0, int k0, int cm, int cn, int idx,
    uint32_t slot) {
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const int v = FIRST + j * STRIDE + idx;
    const int u = unit_index<CM, CN>(v, cm, cn);
    const uint16_t* src =
        unit_is_a<CM, CN>(FIRST + j * STRIDE)
            ? a + static_cast<int64_t>(row0 + u / 8) * K + k0 + 8 * (u % 8)
            : b + static_cast<int64_t>(k0 + u / 32) * N + col0 + 8 * (u % 32);
    cp_async16(slot + v * 16, src);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Decrypt units (FIRST, STRIDE, NU; idx) of stage k0 from the ciphertext
// slot into the plaintext stage at byte offset ``stage`` of every block
// sharing them: peer_a[x] (the CN blocks of this cluster row) and
// peer_b[y] (the CM blocks of this cluster column) are their shared-memory
// bases, ``base`` this block's own.  A write to a peer completes bytes on
// its mbarrier at offset ``full`` (st.async); a write here is a plain
// shared store, and each warp arrives on the local barrier once it is
// done.  The keystream of G units (2 G independent Threefry chains, which
// the scheduler interleaves to hide the pipes' latency) is made before
// their ciphertext is read.
template <int CM, int CN, int FIRST, int STRIDE, int NU, int G>
__device__ __forceinline__ void decrypt_units(
    int row0, int col0, int k0, int cm, int cn, int idx, uint32_t ka0,
    uint32_t ka1, uint32_t kb0, uint32_t kb1, uint32_t slot,
    uint32_t stage, uint32_t base, uint32_t full,
    const uint32_t (&peer_a)[CN], const uint32_t (&peer_b)[CM]) {
#pragma unroll
  for (int g = 0; g < NU; g += G) {
    uint32_t ks[G][4];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const bool is_a = unit_is_a<CM, CN>(FIRST + (g + j) * STRIDE);
      const int u = unit_index<CM, CN>(FIRST + (g + j) * STRIDE + idx, cm, cn);
      const uint32_t row = is_a ? static_cast<uint32_t>(row0 + u / 8)
                                : static_cast<uint32_t>(k0 + u / 32);
      const uint32_t blk =
          is_a ? static_cast<uint32_t>(k0 / 4 + 2 * (u % 8))
               : static_cast<uint32_t>(col0 / 4 + 2 * (u % 32));
      ks[j][0] = row;
      ks[j][1] = blk;
      ks[j][2] = row;
      ks[j][3] = blk + 1u;
      repro::threefry2x32(is_a ? ka0 : kb0, is_a ? ka1 : kb1, ks[j][0],
                          ks[j][1]);
      repro::threefry2x32(is_a ? ka0 : kb0, is_a ? ka1 : kb1, ks[j][2],
                          ks[j][3]);
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int v = FIRST + (g + j) * STRIDE + idx;
      const uint4 ct = ld_shared16(slot + v * 16);
      const uint4 w = make_uint4(ct.x ^ ks[j][0], ct.y ^ ks[j][1],
                                 ct.z ^ ks[j][2], ct.w ^ ks[j][3]);
      const int u = unit_index<CM, CN>(v, cm, cn);
      if (unit_is_a<CM, CN>(FIRST + (g + j) * STRIDE)) {
        const int r = u / 8, q = u % 8;
        const uint32_t off = stage + r * 128 + ((q ^ (r & 7)) << 4);
#pragma unroll
        for (int x = 0; x < CN; ++x) {
          if (x == cn) st_shared16(base + off, w);
          else st_async(peer_a[x] + off, w, peer_a[x] + full);
        }
      } else {
        const int r = u / 32, q = u % 32;
        const uint32_t off = stage + A_BYTES + (q >> 3) * (BK * 128) +
                             r * 128 + (((q & 7) ^ (r & 7)) << 4);
#pragma unroll
        for (int y = 0; y < CM; ++y) {
          if (y == cm) st_shared16(base + off, w);
          else st_async(peer_b[y] + off, w, peer_b[y] + full);
        }
      }
    }
  }
  __syncwarp();
  if (idx % 32 == 0) mbar_arrive(base + full);
}

template <int CM, int CN>
__global__ void __launch_bounds__(kThreads, 1)
sealed_matmul_kernel(const uint16_t* __restrict__ a,
                     const uint16_t* __restrict__ b,
                     const uint32_t* __restrict__ key_a,
                     const uint32_t* __restrict__ key_b,
                     const int* __restrict__ cnt_a,
                     const int* __restrict__ cnt_b,
                     __nv_bfloat16* __restrict__ c, int* __restrict__ bad,
                     int M, int K, int N) {
  using S = Share<CM, CN>;
  extern __shared__ uint8_t smem_raw[];
  // shared memory: kStages plaintext stages, two ciphertext slots, then
  // the mbarriers.  full[b] completes when the stage in buffer b is whole:
  // the peers' bytes have landed (st.async against one arrive with their
  // count) and each warp here has written its share; empty[b]
  // when both wgmma warpgroups of every block this block writes into have
  // finished with buffer b.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = S::BAR_OFF, empty0 = S::BAR_OFF + kStages * 8;
  const int tid = threadIdx.x;
  const int cn = blockIdx.x % CN, cm = blockIdx.y % CM;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int nk = K / BK;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(base + full0 + 8 * i, 1 + kThreads / 32);
      mbar_init(base + empty0 + 8 * i, 2 * (CM + CN - 1));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < kStages && i < nk; ++i)
      mbar_expect_tx(base + full0 + 8 * i, S::PEER_BYTES);
  }
  // every block of the cluster runs, its barriers set, before any write
  cluster_arrive();
  cluster_wait();
  const uint32_t ka0 = key_a[0], ka1 = key_a[1];
  const uint32_t kb0 = key_b[0], kb1 = key_b[1];
  // cluster block rank = x + y * CN
  uint32_t peer_a[CN], peer_b[CM];
#pragma unroll
  for (int x = 0; x < CN; ++x) peer_a[x] = map_rank(base, x + cm * CN);
#pragma unroll
  for (int y = 0; y < CM; ++y) peer_b[y] = map_rank(base, cn + y * CN);
  const uint32_t ct0 = base + kStages * STAGE_BYTES;

  if (tid >= kMmaThreads) {
    // The decrypting warpgroup: its units of stage t into buffer
    // t % kStages once every block they go to has released that buffer
    // (stage t - 3), while the ciphertext of stage t + 1 is in flight.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(kDecRegs));
    const int p = tid - kMmaThreads;
    constexpr int F = kMmaThreads * S::MU;
    fetch_units<CM, CN, F, kDecThreads, S::UD>(a, b, K, N, row0, col0, 0, cm,
                                               cn, p, ct0);
    for (int t = 0; t < nk; ++t) {
      if (t + 1 < nk) {
        fetch_units<CM, CN, F, kDecThreads, S::UD>(
            a, b, K, N, row0, col0, (t + 1) * BK, cm, cn, p,
            ct0 + ((t + 1) & 1) * S::CT_BYTES);
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
      }
      const int nb = t % kStages;
      if (t >= kStages)
        mbar_wait(base + empty0 + 8 * nb, (t / kStages + 1) & 1);
      decrypt_units<CM, CN, F, kDecThreads, S::UD, S::G>(
          row0, col0, t * BK, cm, cn, p, ka0, ka1, kb0, kb1,
          ct0 + (t & 1) * S::CT_BYTES, nb * STAGE_BYTES, base, full0 + 8 * nb,
          peer_a, peer_b);
    }
    // no block leaves while a peer's writes may still be in flight to it
    cluster_arrive();
    cluster_wait();
    return;
  }

  // The wgmma warpgroups: stage s once it is whole; while the tensor cores
  // run, their own units of stage s + 1 (with stage s + 2's ciphertext in
  // flight); then stage s - 1 is finished and released in every block that
  // writes here (this cluster row and column).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(kMmaRegs));
  const int wg = tid / 128;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  fetch_units<CM, CN, 0, kMmaThreads, S::MU>(a, b, K, N, row0, col0, 0, cm,
                                             cn, tid, ct0);
  if (nk > 1) {
    fetch_units<CM, CN, 0, kMmaThreads, S::MU>(a, b, K, N, row0, col0, BK,
                                               cm, cn, tid, ct0 + S::CT_BYTES);
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  }
  decrypt_units<CM, CN, 0, kMmaThreads, S::MU, S::MU>(
      row0, col0, 0, cm, cn, tid, ka0, ka1, kb0, kb1, ct0, 0, base,
      full0, peer_a, peer_b);
  for (int s = 0; s < nk; ++s) {
    const bool fetch = s + 2 < nk;
    if (fetch) {
      fetch_units<CM, CN, 0, kMmaThreads, S::MU>(
          a, b, K, N, row0, col0, (s + 2) * BK, cm, cn, tid,
          ct0 + (s & 1) * S::CT_BYTES);
    }
    const int buf = s % kStages;
    mbar_wait(base + full0 + 8 * buf, (s / kStages) & 1);
    // the plaintext came through the generic proxy; wgmma reads it
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (tid == 0 && s + kStages < nk)
      mbar_expect_tx(base + full0 + 8 * buf, S::PEER_BYTES);
    const uint32_t st = base + buf * STAGE_BYTES;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      // A: 64 rows of this warpgroup, k advanced 32 bytes inside the
      // swizzle atom; B: 16 k-rows (two 8-row groups) further per step
      wgmma_m64n256k16(acc,
                       gmma_desc(st + wg * 64 * 128 + j * 32, 16, 1024),
                       gmma_desc(st + A_BYTES + j * 16 * 128, BK * 128,
                                 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    fence_acc(acc);
    if (s + 1 < nk) {
      if (fetch) {
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
      }
      const int nb = (s + 1) % kStages;
      if (s + 1 >= kStages)
        mbar_wait(base + empty0 + 8 * nb, ((s + 1) / kStages + 1) & 1);
      decrypt_units<CM, CN, 0, kMmaThreads, S::MU, S::MU>(
          row0, col0, (s + 1) * BK, cm, cn, tid, ka0, ka1, kb0, kb1,
          ct0 + ((s + 1) & 1) * S::CT_BYTES, nb * STAGE_BYTES, base,
          full0 + 8 * nb, peer_a, peer_b);
    }
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_acc(acc);
    if (tid % 128 == 0 && s >= 1 && s + 2 < nk) {
      const uint32_t bar = base + empty0 + 8 * ((s - 1) % kStages);
#pragma unroll
      for (int x = 0; x < CN; ++x)
        mbar_arrive_cluster(map_rank(bar, x + cm * CN));
#pragma unroll
      for (int y = 0; y < CM; ++y)
        if (y != cm) mbar_arrive_cluster(map_rank(bar, cn + y * CN));
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(acc);

  // epilogue: fragment (4j + e) of thread (warp w, lane l) is row
  // 16w + l/4 (+8 for e >= 2), column 8j + 2(l%4) + e%2; one bf16 rounding
  const int w = (tid % 128) / 32, lane = tid % 32;
  const int64_t r = row0 + wg * 64 + w * 16 + lane / 4;
  __nv_bfloat16* c0 = c + r * N + col0 + 2 * (lane % 4);
  __nv_bfloat16* c8 = c0 + 8 * static_cast<int64_t>(N);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    *reinterpret_cast<uint32_t*>(c0 + 8 * j) =
        pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(c8 + 8 * j) =
        pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
  if (tid == 0 && row0 % kTile == 0) {
    bad[(row0 / kTile) * (N / kTile) + col0 / kTile] =
        cnt_a[row0 / kTile] + cnt_b[col0 / kTile];
  }
  cluster_arrive();
  cluster_wait();
}

// One warp per 128-word chunk of x (n_rows rows of row_words words): the
// chunk tag of tree_mac.cu, compared with tags[r * n_chunks + c]; a
// mismatch counts into cnt[r / 256] (by_row, operand A) or cnt[c] (B).
__global__ void verify_chunks_kernel(const uint16_t* __restrict__ x,
                                     const uint32_t* __restrict__ tags,
                                     const uint32_t* __restrict__ keys,
                                     int64_t n_rows, int n_chunks,
                                     int64_t row_words, int by_row,
                                     int* __restrict__ cnt) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (i >= n_rows * n_chunks) return;  // whole warps leave together
  const int64_t r = i / n_chunks;
  const int ch = static_cast<int>(i - r * n_chunks);
  const uint4 w = reinterpret_cast<const uint4*>(
      x + 2 * (r * row_words + static_cast<int64_t>(ch) * kChunkWords))[lane];
  const uint4 k = reinterpret_cast<const uint4*>(keys)[lane];
  uint64_t acc = 0;
  acc += repro::mulmod(repro::fold32(repro::fold32(w.x) + 1u), k.x);
  acc += repro::mulmod(repro::fold32(repro::fold32(w.y) + 1u), k.y);
  acc += repro::mulmod(repro::fold32(repro::fold32(w.z) + 1u), k.z);
  acc += repro::mulmod(repro::fold32(repro::fold32(w.w) + 1u), k.w);
  acc = (acc & repro::kP31) + (acc >> 31);
  acc = (acc & repro::kP31) + (acc >> 31);
  uint32_t s = static_cast<uint32_t>(acc);
  for (int off = 16; off > 0; off >>= 1) {
    s = repro::addmod(s, __shfl_down_sync(0xFFFFFFFFu, s, off));
  }
  if (lane == 0) {
    const uint32_t pos =
        repro::canon(static_cast<uint32_t>(i) * repro::kPosMix);
    const uint32_t tag =
        repro::canon(repro::addmod(s, repro::mulmod(pos + 1u, keys[0])));
    if (tag != tags[i]) atomicAdd(cnt + (by_row ? r / kTile : ch), 1);
  }
}

template <int CM, int CN>
cudaError_t launch_product(const uint16_t* a, const uint16_t* b,
                           const uint32_t* key_a, const uint32_t* key_b,
                           const int* cnt_a, const int* cnt_b,
                           __nv_bfloat16* c, int* bad, int M, int K, int N,
                           cudaStream_t s) {
  auto kernel = sealed_matmul_kernel<CM, CN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Share<CM, CN>::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CN;
  attr[0].val.clusterDim.y = CM;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / BN, M / BM);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Share<CM, CN>::SMEM;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a, b, key_a, key_b, cnt_a, cnt_b,
                            c, bad, M, K, N);
}

}  // namespace

// a uint16[M, K], b uint16[K, N], c bf16[M, N], bad int32[M/256, N/256],
// all contiguous, a and b 16-byte aligned; M, K, N multiples of 256.
// key_a, key_b uint32[2] tensor keys; tags_a uint32[M, K/256], tags_b
// uint32[K, N/256] and mkeys uint32[128] canonical MAC keys (read only
// when verify).  counts: int32[M/256 + N/256] scratch.  cm in {2, 4}
// must divide M/128 (even, as M is a multiple of 256) and cn in {1, 2}
// divide N/256: the cluster's extent along M and N.  Returns the first CUDA error of the launches (a refused
// cluster shape or shared-memory size included).
extern "C" int sealed_matmul_launch(const void* a, const void* b,
                                    const void* tags_a, const void* tags_b,
                                    const void* key_a, const void* key_b,
                                    const void* mkeys, void* c, void* bad,
                                    void* counts, int M, int K, int N,
                                    int cm, int cn, int verify,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((M / BM) % cm || (N / BN) % cn)
    return static_cast<int>(cudaErrorInvalidValue);
  int* cnt_a = static_cast<int*>(counts);
  int* cnt_b = cnt_a + M / kTile;
  cudaError_t err = cudaMemsetAsync(
      counts, 0, sizeof(int) * (M / kTile + N / kTile), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (verify) {
    const uint32_t* mk = static_cast<const uint32_t*>(mkeys);
    const int64_t warps_a = static_cast<int64_t>(M) * (K / kTile);
    verify_chunks_kernel<<<static_cast<unsigned>((warps_a * 32 + 255) / 256),
                           256, 0, s>>>(
        static_cast<const uint16_t*>(a), static_cast<const uint32_t*>(tags_a),
        mk, M, K / kTile, K / 2, 1, cnt_a);
    const int64_t warps_b = static_cast<int64_t>(K) * (N / kTile);
    verify_chunks_kernel<<<static_cast<unsigned>((warps_b * 32 + 255) / 256),
                           256, 0, s>>>(
        static_cast<const uint16_t*>(b), static_cast<const uint32_t*>(tags_b),
        mk, K, N / kTile, N / 2, 0, cnt_b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto* ua = static_cast<const uint16_t*>(a);
  const auto* ub = static_cast<const uint16_t*>(b);
  const auto* kpa = static_cast<const uint32_t*>(key_a);
  const auto* kpb = static_cast<const uint32_t*>(key_b);
  auto* cc = static_cast<__nv_bfloat16*>(c);
  auto* bb = static_cast<int*>(bad);
#define REPRO_LAUNCH(CM_, CN_)                                              \
  if (cm == CM_ && cn == CN_)                                               \
    err = launch_product<CM_, CN_>(ua, ub, kpa, kpb, cnt_a, cnt_b, cc, bb,  \
                                   M, K, N, s);
  err = cudaErrorInvalidValue;
  REPRO_LAUNCH(4, 2) REPRO_LAUNCH(4, 1) REPRO_LAUNCH(2, 2) REPRO_LAUNCH(2, 1)
#undef REPRO_LAUNCH
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the product kernel in clusters of cm x cn (0 for
// a shape it does not take): for the build report.
extern "C" int sealed_matmul_smem_bytes(int cm, int cn) {
  if (cm == 4 && cn == 2) return Share<4, 2>::SMEM;
  if (cm == 4 && cn == 1) return Share<4, 1>::SMEM;
  if (cm == 2 && cn == 2) return Share<2, 2>::SMEM;
  if (cm == 2 && cn == 1) return Share<2, 1>::SMEM;
  return 0;
}
