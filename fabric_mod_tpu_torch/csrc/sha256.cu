// SHA-256 of the verify core's raw-message lanes, written by hand for Hopper
// (sm_90a).  One kernel replaces fabric_mod_tpu/ops/sha256.py sha256_blocks
// (:81), which the JAX package runs as a jitted lax.scan in front of the
// verify core on the fused hash->verify path (FABRIC_MOD_TPU_FUSED_HASH) and
// the port's plain version (ops/sha256.py) runs as ~4.2k torch ops per
// 64-byte block of the bucket's longest message:
//
//   sha256_e_kernel  for every lane whose kFlagHasMsg is set in the verify
//                    core's packed buffer (ops/p256_core.py), FIPS 180-4 over
//                    the lane's pre-padded big-endian message words
//                    (bccsp/der.pack_messages: n x max_blocks x 16 uint32, the
//                    lane's own nblocks of them real), written as the
//                    buffer's e rows: the digest's 8 little-endian 32-bit
//                    words, word k = the digest's big-endian word 7 - k (the
//                    order ops/p256.py digest_words_le gives).  Lanes without
//                    a message keep their e rows, so the prologue then reads
//                    the e rows of every lane unchanged.
//
// What bounds it on this card: the chain, not operations.  A call has at
// most a few thousand lanes, and a lane's blocks are one chain of dependent
// rounds (Merkle-Damgard), so a call lasts as long as its longest lane's 64
// x nblocks rounds, however idle the rest of the card is.  A round's chain
// is e -> S1(e) -> e' (three SHF into a LOP3 into an add) and the same from
// a, and a dependent instruction of a full warp takes ~5.8 cycles; besides,
// Hopper's integer ALU takes a warp instruction in two cycles (16 lanes a
// scheduler), so one warp that expands the schedule and runs the rounds of
// its lanes (~22 ALU instructions a round) dispatches at ~44 cycles a round
// before its chain matters.  The design:
//
//  1. Warp specialisation.  A thread block holds kLanes lanes, one consumer
//     warp and one producer warp, which another scheduler of the SM
//     dispatches.  The producer loads each lane's next 64-byte block (four
//     16-byte loads, a block ahead of use), expands the schedule and writes
//     the block's 64 K_t + W_t into a ring in shared memory (kRingDepth
//     slots); the consumer runs only the rounds.  Full and empty named
//     barriers (bar.arrive / bar.sync, both warps) hand the slots over.
//     Both warps loop to the block's longest lane (a warp max of nblocks
//     over the same lanes), so a short lane only predicates off or computes
//     what it drops, and every barrier is met.  Ring layout (ring_offset):
//     column c of a slot's quad row q (rounds 4q..4q+3) at slot * 64 * cols
//     + q * 4 * cols + 4 * c words, so a warp's 16-byte loads and stores of
//     one quad row are contiguous.
//  2. The consumer's round at its short chain, two threads a lane
//     (sha256_rounds): one the e-side of each round, the other the a-side
//     two rounds behind, trading their new words by one shuffle a round.
//     d + h + KW is formed off the chain (h_t = e_{t-3} and d_t = a_{t-3}
//     are known three rounds ahead) and each sum is written so that the
//     compiler cannot re-associate it onto the chain (add3, and_xor,
//     mad_u32), so a thread dispatches 8 ALU and 2 FMA instructions a round
//     on a chain of 3.
//  3. The geometry is fixed from a sweep measured on an H100 (PERF.md §6):
//     16 lanes a block (2048 lanes put one block on each of 128 SMs) and
//     one producer warp.  8 or 32 lanes, a second producer warp and one
//     thread a lane (adds on the ALU or on the FMA pipe) read the same or
//     slower; the consumer, not the geometry, sets the time.
//
// Out-of-range nblocks are clamped to [0, max_blocks], as the plain
// version's `i < nblocks` over the plane's blocks does.
//
// The per-lane code is plain C++ under a host compiler (no __CUDACC__):
// sha256_schedule_block (the producer's part) and sha256_rounds (the
// consumer's), over ring_offset's layout, which the tests build with g++
// and compose through a ring as the kernel does (the pair's two threads in
// lockstep, their shuffle a swap), against hashlib, the plain PyTorch
// sha256_blocks and the JAX reference.  Only the kernel and the launcher
// need nvcc.

#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#define __device__
#define __forceinline__ inline
#define __constant__
#endif

namespace {

// the verify core's packed buffer (csrc/p256_core.cu kRow*, kFlag*)
constexpr int kRowE = 0;
constexpr int kRowFlags = 40;
constexpr uint32_t kFlagHasMsg = 8u;
// ring slots a lane, each a block's 64 K_t + W_t words
constexpr int kRingDepth = 4;
// lanes a thread block; the consumer's lane i is its threads 2i (role 0)
// and 2i + 1 (role 1), with a ring column each
constexpr int kLanes = 16;
constexpr int kCols = 2 * kLanes;
static_assert(kCols == 32, "the pair fills its warp");

__constant__ uint32_t kK[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u};

__constant__ uint32_t kH0[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                                0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
#ifdef __CUDACC__
    return __funnelshift_r(x, x, n);
#else
    return (x >> n) | (x << (32 - n));
#endif
}

__device__ __forceinline__ uint32_t small_sigma0(uint32_t x) {
    return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3);
}
__device__ __forceinline__ uint32_t small_sigma1(uint32_t x) {
    return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10);
}

// x + y + z, added in this order as one IADD3 and kept as written: the
// device compiler cannot re-associate it onto the chain.
__device__ __forceinline__ uint32_t add3(uint32_t x, uint32_t y, uint32_t z) {
#ifdef __CUDACC__
    uint32_t r;
    asm("{\n\t.reg .u32 t;\n\tadd.u32 t, %1, %2;\n\tadd.u32 %0, t, %3;\n\t}"
        : "=r"(r) : "r"(x), "r"(y), "r"(z));
    return r;
#else
    return x + y + z;
#endif
}

// x * m + y on the FMA pipe (IMAD), m a value the compiler cannot see.
__device__ __forceinline__ uint32_t mad_u32(uint32_t x, uint32_t m, uint32_t y) {
#ifdef __CUDACC__
    uint32_t r;
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(m), "r"(y));
    return r;
#else
    return x * m + y;
#endif
}

// (x & u) ^ z as one LOP3 whatever the compiler makes of u and z, so that
// a single logic instruction stands between x and the round's last add.
__device__ __forceinline__ uint32_t and_xor(uint32_t x, uint32_t u, uint32_t z) {
#ifdef __CUDACC__
    uint32_t r;
    asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(r) : "r"(x), "r"(u), "r"(z));
    return r;
#else
    return (x & u) ^ z;
#endif
}

// Four consecutive words (16-byte aligned) in and out.
__device__ __forceinline__ void load_quad(const uint32_t* p, uint32_t q[4]) {
#ifdef __CUDACC__
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    q[0] = v.x;
    q[1] = v.y;
    q[2] = v.z;
    q[3] = v.w;
#else
    for (int i = 0; i < 4; ++i) q[i] = p[i];
#endif
}

__device__ __forceinline__ void store_quad(uint32_t* p, const uint32_t q[4]) {
#ifdef __CUDACC__
    *reinterpret_cast<uint4*>(p) = make_uint4(q[0], q[1], q[2], q[3]);
#else
    for (int i = 0; i < 4; ++i) p[i] = q[i];
#endif
}

// The ring: kRingDepth slots, each 16 quad rows (a quad: the K_t + W_t of
// rounds 4q..4q+3) of `cols` columns.  Column c of slot `slot` starts at
// ring + ring_offset(slot, c, cols), its quads 4 x cols words apart, so the
// warp's 16-byte loads and stores of one quad row are contiguous.
__device__ __forceinline__ std::size_t ring_offset(int slot, int col, int cols) {
    return (std::size_t)slot * 64 * cols + (std::size_t)col * 4;
}

constexpr std::size_t ring_words(int cols) {
    return (std::size_t)kRingDepth * 64 * cols;
}

// The producer's part of a compression (FIPS 180-4 6.2.2 step 1): a block's
// 16 big-endian words to the 64 K_t + W_t that the rounds add, written as 16
// quads `quad_stride` words apart (4: a plain kw[64]; 4 x cols: a column of
// a ring slot).
__device__ __forceinline__ void sha256_schedule_block(const uint32_t block[16], uint32_t* kw,
                                                      int quad_stride = 4) {
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = block[i];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
        uint32_t out[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int t = 4 * q + r;
            if (t >= 16)
                w[t & 15] += small_sigma0(w[(t - 15) & 15]) + w[(t - 7) & 15] +
                             small_sigma1(w[(t - 2) & 15]);
            out[r] = kK[t] + w[t & 15];
        }
        store_quad(kw + q * quad_stride, out);
    }
}

// The consumer: two threads a lane, in one instruction stream.  Role 0
// holds e, f, g, h and runs each round's e-side, e' = (d + h + KW) + S1(e)
// + Ch(e, f, g); role 1 holds a, b, c, d and runs the a-side two rounds
// behind, a' = (e' - d) + S0(a) + Maj(a, b, c).  What differs between the
// roles is data: the rotations of S; Ch(x, y, z) = (x & (y ^ z)) ^ z and
// Maj(x, y, z) = (x & (y ^ z)) ^ (y & z), the last term z & (y | m); the
// first sum q + x3 * sgn + K', q the partner's word of two rounds ago (role
// 0: a_{t-3} = d_t; role 1: e_{r+1}), K' = KW for role 0 and 0 for role 1
// (its ring column holds zeros).  One shuffle a round trades the new words.
// A round is 3 SHF + 4 LOP3 + 1 IADD3 on the ALU and 2 IMAD.
struct Pair {
    uint32_t x0, x1, x2, x3;  // e, f, g, h (role 0); a, b, c, d (role 1)
    uint32_t q1, q2;          // the partner's words of one and two rounds ago
    uint32_t r1, r2, r3;      // S1's rotations 6, 11, 25, or S0's 2, 13, 22
    uint32_t m;               // ~0 (Ch) or 0 (Maj)
    uint32_t sgn;             // 1 (+h) or ~0 (-d)
};

// One step; `one` is 1, a kernel argument, so that the first sum's add
// stays an IMAD on the FMA pipe.
__device__ __forceinline__ uint32_t pair_round(Pair& p, uint32_t kw, uint32_t one) {
    const uint32_t y = mad_u32(p.q2, one, mad_u32(p.x3, p.sgn, kw));
    const uint32_t s = rotr(p.x0, p.r1) ^ rotr(p.x0, p.r2) ^ rotr(p.x0, p.r3);
    const uint32_t u = p.x1 ^ p.x2, z = p.x2 & (p.x1 | p.m);
    const uint32_t out = add3(y, s, and_xor(p.x0, u, z));
    p.x3 = p.x2;
    p.x2 = p.x1;
    p.x1 = p.x0;
    p.x0 = out;
    return out;
}

__device__ __forceinline__ void pair_keep(Pair& p, const Pair& keep, bool cond) {
    p.x0 = cond ? keep.x0 : p.x0;
    p.x1 = cond ? keep.x1 : p.x1;
    p.x2 = cond ? keep.x2 : p.x2;
    p.x3 = cond ? keep.x3 : p.x3;
}

// Role 1's ring column: zeros, so that its K' is 0.
__device__ __forceinline__ void pair_zero_column(uint32_t* col, int quad_stride) {
    const uint32_t zero[4] = {0u, 0u, 0u, 0u};
    for (int slot = 0; slot < kRingDepth; ++slot)
        for (int q = 0; q < 16; ++q) store_quad(col + slot * 16 * quad_stride + q * quad_stride, zero);
}

// The consumer's part of a compression (FIPS 180-4 6.2.2 steps 2-4): one
// block's 64 rounds through kN threads of pairs held by one caller.  The
// card runs one (kN = 1; its partner is the next lane of the warp, xchg a
// shuffle), the host tests run a pair in lockstep (kN = 2, xchg swaps their
// words).  w: each thread's four state words (role 0: s[4..7], role 1:
// s[0..3]), added to when `live`; kw: its ring column, quads quad_stride
// apart.  All threads run every round, so that every shuffle has its
// partner.
template <int kN, class Xchg>
__device__ __forceinline__ void sha256_rounds(uint32_t (&w)[kN][4],
                                              const uint32_t* const (&kw)[kN], int quad_stride,
                                              const int (&role)[kN], const bool (&live)[kN],
                                              uint32_t one, Xchg xchg) {
    Pair p[kN];
    uint32_t send[kN], recv[kN], k4[kN][4];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
        p[i].x0 = w[i][0];
        p[i].x1 = w[i][1];
        p[i].x2 = w[i][2];
        p[i].x3 = w[i][3];
        p[i].r1 = role[i] ? 2 : 6;
        p[i].r2 = role[i] ? 13 : 11;
        p[i].r3 = role[i] ? 22 : 25;
        p[i].m = role[i] ? 0u : ~0u;
        p[i].sgn = role[i] ? ~0u : 1u;
        send[i] = p[i].x3;
        load_quad(kw[i], k4[i]);
    }
    // role 0's d for rounds 0 and 1: role 1's d and c
    xchg(send, recv);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
        p[i].q2 = recv[i];
        send[i] = p[i].x2;
    }
    xchg(send, recv);
#pragma unroll
    for (int i = 0; i < kN; ++i) p[i].q1 = recv[i];
    // rounds 0 and 1: role 1 keeps its words and sends its b, then its a
    // (role 0's d for rounds 2 and 3)
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int i = 0; i < kN; ++i) {
            const Pair keep = p[i];
            const uint32_t out = pair_round(p[i], k4[i][t], one);
            pair_keep(p[i], keep, role[i] != 0);
            send[i] = role[i] ? (t == 0 ? keep.x1 : keep.x0) : out;
        }
        xchg(send, recv);
#pragma unroll
        for (int i = 0; i < kN; ++i) {
            p[i].q2 = p[i].q1;
            p[i].q1 = recv[i];
        }
    }
    // rounds 2..63 of role 0, 0..61 of role 1
#pragma unroll
    for (int t = 2; t < 64; ++t) {
#pragma unroll
        for (int i = 0; i < kN; ++i) {
            if ((t & 3) == 0) load_quad(kw[i] + (t >> 2) * quad_stride, k4[i]);
            send[i] = pair_round(p[i], k4[i][t & 3], one);
        }
        xchg(send, recv);
#pragma unroll
        for (int i = 0; i < kN; ++i) {
            p[i].q2 = p[i].q1;
            p[i].q1 = recv[i];
        }
    }
    // role 1's rounds 62 and 63; role 0 keeps its words
#pragma unroll
    for (int i = 0; i < kN; ++i) {
        const Pair keep = p[i];
        pair_round(p[i], 0u, one);
        p[i].q2 = p[i].q1;
        pair_round(p[i], 0u, one);
        pair_keep(p[i], keep, role[i] == 0);
        if (live[i]) {
            w[i][0] += p[i].x0;
            w[i][1] += p[i].x1;
            w[i][2] += p[i].x2;
            w[i][3] += p[i].x3;
        }
    }
}

// A lane's blocks: -1 when it carries no message (its e rows stay), else
// its nblocks clamped to [0, max_blocks].  packed: the verify core's
// kRows x n buffer (int32 bit patterns).
__device__ __forceinline__ int lane_blocks(int lane, int n, const int32_t* nblocks,
                                           int max_blocks, const uint32_t* packed) {
    if (!(packed[(std::size_t)kRowFlags * n + lane] & kFlagHasMsg)) return -1;
    const int nb = nblocks[lane];
    return nb < 0 ? 0 : (nb > max_blocks ? max_blocks : nb);
}

__device__ __forceinline__ void init_state(uint32_t s[8]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = kH0[k];
}

// The digest as the lane's e rows: word k = the big-endian word 7 - k.
__device__ __forceinline__ void write_e(const uint32_t s[8], int lane, int n, uint32_t* packed) {
#pragma unroll
    for (int k = 0; k < 8; ++k) packed[(std::size_t)(kRowE + k) * n + lane] = s[7 - k];
}

}  // namespace

#ifdef __CUDACC__

namespace {

// the consumer warp and the producer warp
constexpr int kThreads = 64;
// named barriers: slot s is full at kBarFull + s, empty at kBarEmpty + s
// (0 is __syncthreads'); each joins both warps
constexpr int kBarFull = 1;
constexpr int kBarEmpty = kBarFull + kRingDepth;
// a thread block's dynamic shared memory: the ring
constexpr int kRingBytes = (int)(ring_words(kCols) * sizeof(uint32_t));
static_assert(kRingBytes <= 48 * 1024, "the ring fits the default dynamic shared memory");

__device__ __forceinline__ void bar_sync(int id) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

struct ShflXchg {
    __device__ __forceinline__ void operator()(const uint32_t (&send)[1], uint32_t (&recv)[1]) const {
        recv[0] = __shfl_xor_sync(0xffffffffu, send[0], 1);
    }
};

}  // namespace

// kLanes lanes a thread block, warp 0 the consumer, warp 1 the producer.
// words: (n, max_blocks, 16) uint32, 16-byte aligned; dynamic shared memory
// kRingBytes; one: 1.
__global__ void __launch_bounds__(kThreads) sha256_e_kernel(
        const uint32_t* __restrict__ words, const int32_t* __restrict__ nblocks, int max_blocks,
        uint32_t* __restrict__ packed, int n, uint32_t one) {
    extern __shared__ __align__(16) uint32_t ring[];
    const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
    // the consumer's threads 2i and 2i + 1 and the producer's thread i
    // serve the block's lane i
    const int in_block = warp == 0 ? t >> 1 : t;
    const int lane = blockIdx.x * kLanes + in_block;
    const int own = (in_block < kLanes && lane < n)
                            ? lane_blocks(lane, n, nblocks, max_blocks, packed)
                            : -1;
    const int nb = own < 0 ? 0 : own;
    // both warps read the same lanes, so both loop to one length
    const int nmax = __reduce_max_sync(0xffffffffu, nb);
    constexpr int qs = 4 * kCols;
    if (warp == 0) {
        uint32_t* col = ring + ring_offset(0, t, kCols);
        const int role = t & 1;
        if (role) pair_zero_column(col, qs);
        uint32_t s[8];
        init_state(s);
        uint32_t w[1][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) w[0][k] = s[(role ? 0 : 4) + k];
        const int roles[1] = {role};
        for (int j = 0; j < nmax; ++j) {
            const int slot = j % kRingDepth;
            bar_sync(kBarFull + slot);
            const uint32_t* const kw[1] = {col + slot * 64 * kCols};
            const bool live[1] = {j < nb};
            sha256_rounds<1>(w, kw, qs, roles, live, one, ShflXchg());
            __syncwarp();
            if (j + kRingDepth < nmax) bar_arrive(kBarEmpty + slot);
        }
        if (own >= 0) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int row = role ? 7 - k : 3 - k;
                packed[(std::size_t)(kRowE + row) * n + lane] = w[0][k];
            }
        }
        return;
    }
    // the producer: its lane's blocks in order into role 0's column, each
    // loaded a block ahead
    uint32_t* col = ring + ring_offset(0, in_block < kLanes ? 2 * in_block : 0, kCols);
    const uint4* src =
            reinterpret_cast<const uint4*>(words) + (std::size_t)(own >= 0 ? lane : 0) * max_blocks * 4;
    uint4 cur[4], nxt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cur[i] = nxt[i] = make_uint4(0u, 0u, 0u, 0u);
    if (nb > 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) cur[i] = __ldg(src + i);
    }
    for (int j = 0; j < nmax; ++j) {
        const int slot = j % kRingDepth;
        if (j + 1 < nb) {
#pragma unroll
            for (int i = 0; i < 4; ++i) nxt[i] = __ldg(src + (std::size_t)(j + 1) * 4 + i);
        }
        if (j >= kRingDepth) bar_sync(kBarEmpty + slot);
        if (j < nb) {
            const uint32_t blk[16] = {cur[0].x, cur[0].y, cur[0].z, cur[0].w,
                                      cur[1].x, cur[1].y, cur[1].z, cur[1].w,
                                      cur[2].x, cur[2].y, cur[2].z, cur[2].w,
                                      cur[3].x, cur[3].y, cur[3].z, cur[3].w};
            sha256_schedule_block(blk, col + slot * 64 * kCols, qs);
        }
        __syncwarp();
        bar_arrive(kBarFull + slot);
#pragma unroll
        for (int i = 0; i < 4; ++i) cur[i] = nxt[i];
    }
}

// Launch on `stream`.  words: (n, max_blocks, 16) uint32, 16-byte aligned;
// nblocks: (n,) int32; packed: (kRows, n) int32, its e rows written in
// place.  Allocates nothing; returns the launch's cudaError_t.
extern "C" int sha256_e_launch(const void* words, const void* nblocks, int max_blocks,
                               void* packed, int n, void* stream) {
    if (n <= 0) return 0;
    sha256_e_kernel<<<(n + kLanes - 1) / kLanes, kThreads, kRingBytes,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(words), static_cast<const int32_t*>(nblocks), max_blocks,
            static_cast<uint32_t*>(packed), n, 1u);
    return static_cast<int>(cudaGetLastError());
}

// The launch geometry, for the report: lanes a thread block, producer
// warps and the ring's slots (a block's dynamic shared memory is
// *ring_bytes).
extern "C" int sha256_e_geometry(int* lanes, int* producers, int* ring_depth, int* ring_bytes) {
    *lanes = kLanes;
    *producers = 1;
    *ring_depth = kRingDepth;
    *ring_bytes = kRingBytes;
    return 0;
}

#endif  // __CUDACC__
