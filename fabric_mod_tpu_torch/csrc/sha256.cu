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
// What bounds it on this card: operations, ~1,400 32-bit instructions for
// each real 64-byte block (the message schedule and 64 rounds, a rotate one
// funnel shift, ch, maj and a 3-way xor one LOP3 each), against 64 bytes
// read; but a call has at most a few thousand lanes, and each lane's blocks
// are one chain of dependent rounds.  The design keeps that chain short and
// pays no padding:
//
//  1. One thread a lane, looping over its OWN nblocks, not the plane's
//     max_blocks: a short message costs its own blocks only, and the
//     plane's padding is never read.
//  2. The 16-word schedule window and the eight working words live in
//     registers (the 64 rounds are unrolled, so every index is a
//     constant); K is in constant memory, read at constant offsets;
//     rotates are funnel shifts.  A block's 16 words come in as four
//     16-byte loads.
//  3. Lanes per block = width / SMs within [1, 32] (as the verify core's
//     prologue), so a 2048-lane call runs one small block on every SM
//     instead of a few full ones on a few SMs.  A warp runs to its longest
//     lane.
//
// Out-of-range nblocks are clamped to [0, max_blocks], as the plain
// version's `i < nblocks` over the plane's blocks does.
//
// The per-lane code is plain C++ under a host compiler (no __CUDACC__): the
// tests build it with g++ and hold it against hashlib and the plain PyTorch
// sha256_blocks.  Only the kernel and the launcher need nvcc.

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

// A block's 16 big-endian words (the plane holds each as its uint32 value).
__device__ __forceinline__ void load_block(const uint32_t* p, uint32_t w[16]) {
#ifdef __CUDACC__
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint4 v = __ldg(q + i);
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
    }
#else
    for (int i = 0; i < 16; ++i) w[i] = p[i];
#endif
}

// One compression of `block` into the state s[8] (FIPS 180-4 6.2.2), the
// schedule kept as a rolling window of 16 words.
__device__ __forceinline__ void compress(uint32_t s[8], const uint32_t* block) {
    uint32_t w[16];
    load_block(block, w);
    uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
    uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
    for (int t = 0; t < 64; ++t) {
        uint32_t wt;
        if (t < 16) {
            wt = w[t];
        } else {
            const uint32_t x15 = w[(t - 15) & 15], x2 = w[(t - 2) & 15];
            const uint32_t s0 = rotr(x15, 7) ^ rotr(x15, 18) ^ (x15 >> 3);
            const uint32_t s1 = rotr(x2, 17) ^ rotr(x2, 19) ^ (x2 >> 10);
            wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
            w[t & 15] = wt;
        }
        const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
        const uint32_t ch = (e & f) ^ (~e & g);
        const uint32_t t1 = h + S1 + ch + kK[t] + wt;
        const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
        const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
        const uint32_t t2 = S0 + maj;
        h = g;
        g = f;
        f = e;
        e = d + t1;
        d = c;
        c = b;
        b = a;
        a = t1 + t2;
    }
    s[0] += a;
    s[1] += b;
    s[2] += c;
    s[3] += d;
    s[4] += e;
    s[5] += f;
    s[6] += g;
    s[7] += h;
}

// One lane: hash its own blocks and write its e rows, or leave them when the
// lane carries no message.  words: n x max_blocks x 16; packed: the verify
// core's kRows x n buffer (int32 bit patterns).
__device__ __forceinline__ void sha256_e_lane(int lane, int n, const uint32_t* words,
                                              const int32_t* nblocks, int max_blocks,
                                              uint32_t* packed) {
    if (!(packed[(std::size_t)kRowFlags * n + lane] & kFlagHasMsg)) return;
    int nb = nblocks[lane];
    nb = nb < 0 ? 0 : (nb > max_blocks ? max_blocks : nb);
    uint32_t s[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = kH0[k];
    const uint32_t* p = words + (std::size_t)lane * max_blocks * 16;
    for (int blk = 0; blk < nb; ++blk) compress(s, p + (std::size_t)blk * 16);
#pragma unroll
    for (int k = 0; k < 8; ++k) packed[(std::size_t)(kRowE + k) * n + lane] = s[7 - k];
}

}  // namespace

#ifdef __CUDACC__

constexpr int kMaxLanesPerBlock = 32;

__global__ void __launch_bounds__(kMaxLanesPerBlock) sha256_e_kernel(
        const uint32_t* __restrict__ words, const int32_t* __restrict__ nblocks,
        int max_blocks, uint32_t* __restrict__ packed, int n) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    sha256_e_lane(lane, n, words, nblocks, max_blocks, packed);
}

// Lanes per block: n spread over the SMs, at most a warp's worth.
static int sha256_lanes_per_block(int n) {
    int dev = 0, sms = 1;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        sms = 1;
    const int per = n / (sms > 0 ? sms : 1);
    return per < 1 ? 1 : (per > kMaxLanesPerBlock ? kMaxLanesPerBlock : per);
}

// Launch on `stream`.  words: (n, max_blocks, 16) uint32, 16-byte aligned;
// nblocks: (n,) int32; packed: (kRows, n) int32, its e rows written in place.
// Allocates nothing; returns the cudaError_t of the launch.
extern "C" int sha256_e_launch(const void* words, const void* nblocks, int max_blocks,
                               void* packed, int n, void* stream) {
    if (n <= 0) return 0;
    const int per = sha256_lanes_per_block(n);
    sha256_e_kernel<<<(n + per - 1) / per, per, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), static_cast<const int32_t*>(nblocks), max_blocks,
        static_cast<uint32_t*>(packed), n);
    return static_cast<int>(cudaGetLastError());
}

// The lanes per block the launcher picks for a width of n (for the report).
extern "C" int sha256_e_geometry(int n) { return sha256_lanes_per_block(n); }

#endif  // __CUDACC__
