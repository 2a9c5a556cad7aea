// The verify core around the Shamir ladder, written by hand for Hopper
// (sm_90a).  Two kernels replace the prologue and the epilogue of
// fabric_mod_tpu/ops/p256.py _verify_core_impl (:516), which the JAX
// package runs inside one jitted device program (verify_core :570,
// verify_core_fused :601) and the port's plain version runs as ~36k
// torch ops per call:
//
//   verify_prologue_kernel  w = s^-1 mod n; u1 = e*w and u2 = r*w mod n,
//                           fully reduced; their 4-bit window planes, most
//                           significant window first (ops/p256.py
//                           windows_msb_first); key_ok: the key is on the
//                           curve y^2 = x^3 - 3x + b (mod p) and is not
//                           (0, 0)
//   verify_epilogue_kernel  from the ladder's canonical X, Z:
//                           ok = range_ok & pre_ok & key_ok & Z != 0 &
//                           (X == r*Z or (rn_lt_p and X == (r+n)*Z)) mod p
//
// Inputs come in one packed int32 buffer of kRows x n (lane axis last, so
// a row is contiguous): the digest e, r, s, qx, qy as 8 little-endian
// 32-bit words each, then one row of flags (kFlagRangeOk, kFlagPreOk,
// kFlagRnLtP).  The host fills it from the byte planes in one copy
// (ops/p256_core.py).  The raw-message path hands the prologue the digest
// words that SHA-256 computed on the card in place of the buffer's e rows.
//
// What bounds them on this card: neither bytes (~680 bytes a lane in and
// out of the prologue) nor operations (a few thousand word products a
// lane), but one lane's chain of dependent steps.  The main path calls
// the prologue at 1 lane (the MCS check of a block), ~16 (an ingress
// cohort) and 2048 (a validator bucket): too few lanes to hide latency,
// so every width pays the chain.  The design shortens the chain and
// takes work off it:
//
//  1. The inverse mod n by divsteps (Bernstein-Yang safegcd, variable
//     time: a verify runs on public data).  A Fermat chain over n - 2 is
//     ~320 dependent products mod n; safegcd is at most 25 and in practice
//     ~18-19 batches of 30 divsteps on the low words, each batch's 2x2
//     matrix then applied to 9-limb values.  No table, no run-time
//     indexed array: every value lives in registers.
//  2. A lane is a group of kGroup = 2 threads.  Rank 0 inverts s while
//     rank 1 checks the key mod p (5 products, off the inversion's chain);
//     they meet once in shared memory, then each computes one of u1, u2
//     and writes its plane.  The ranks sit in different warps of the
//     block (warp g holds rank g of up to 32 lanes), so the inversion and
//     the key check never diverge inside a warp, and each rank's stores
//     cover 32 consecutive lanes of a row.  Two threads, not more: the
//     divsteps are one sequential chain, and past the key check and one
//     of the two final products there is nothing independent to hand out.
//  3. Lanes per block = width / SMs within [1, 32], so a 2048-lane call
//     runs 137 blocks of 15 lanes over all 132 SMs, and a 16-lane call 16
//     blocks of one lane.  A warp runs to its slowest lane's batch count.
//
// The epilogue tests X == r'*Z (mod p) as r'*Z*R^-1 == X*R^-1: three
// independent Montgomery products mod p (p256_field.cuh), one thread a
// lane.
//
// Arithmetic mod n outside the inversion is a generic Montgomery product
// (CIOS over 8 x 32-bit words, n0' = -n^-1 mod 2^32, R = 2^256): n has no
// special form, unlike p.
//
// Padding lanes are all zeros: s = 0 (and s = n, reduced mod n on the way
// into the Montgomery domain) inverts to 0 after one batch, and range_ok
// masks the lane.  An off-curve key still gives window planes and runs the
// ladder; key_ok masks it.
//
// The per-lane and per-rank code is plain C++ under a host compiler (no
// __CUDACC__): each intrinsic has a host twin (__ffs -> __builtin_ctz), a
// group's ranks run in turn (FOR_MY_RANKS), and the tests build it with g++
// and hold it against Python ints and the plain PyTorch prologue and
// epilogue.  Only the kernels and the launchers need nvcc.

#include "p256_field.cuh"
#include "divsteps.cuh"

namespace {

// the packed input buffer: rows of n int32 words (uint32 bit patterns)
constexpr int kRowE = 0, kRowR = 8, kRowS = 16, kRowQx = 24, kRowQy = 32;
constexpr int kRowFlags = 40;
constexpr int kRows = 41;
constexpr uint32_t kFlagRangeOk = 1u, kFlagPreOk = 2u, kFlagRnLtP = 4u;
static_assert(kRowE == 0 && kRowFlags + 1 == kRows, "the packed buffer's layout");

// the group order n, little-endian words
__constant__ uint32_t kN[8] = {
    0xFC632551u, 0xF3B9CAC2u, 0xA7179E84u, 0xBCE6FAADu,
    0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u, 0xFFFFFFFFu};
// R^2 mod n (R = 2^256): to-Montgomery multiplier mod n
__constant__ uint32_t kR2N[8] = {
    0xBE79EEA2u, 0x83244C95u, 0x49BD6FA6u, 0x4699799Cu,
    0x2B6BEC59u, 0x2845B239u, 0xF3D95620u, 0x66E12D94u};
// b * R mod p: the curve's b in Montgomery form mod p
__constant__ uint32_t kBM[8] = {
    0x29C4BDDFu, 0xD89CDF62u, 0x78843090u, 0xACF005CDu,
    0xF7212ED6u, 0xE5A220ABu, 0x04874834u, 0xDC30061Du};
// n0' = -n^-1 mod 2^32
constexpr uint32_t kN0Inv = 0xEE00BC4Fu;

// --- Arithmetic mod n -----------------------------------------------------

// Montgomery product a*b*2^-256 mod n (CIOS).  Needs a < 2^256 and b < n;
// gives a value < n.  After the last row t < (a*b + m*n) / 2^256 < 2n, and
// after every row t < 2^257, so t is 9 words with a top word of 0 or 1
// (t[9] holds the row's carry before the reduction shifts it down); one
// masked subtraction of n then reduces fully.
__device__ __forceinline__ Fe fn_mul(const Fe& a, const Fe& b) {
    uint32_t t[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) t[k] = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            c += (uint64_t)t[j] + (uint64_t)a.v[j] * b.v[i];
            t[j] = (uint32_t)c;
            c >>= 32;
        }
        c += t[8];
        t[8] = (uint32_t)c;
        t[9] = (uint32_t)(c >> 32);
        const uint32_t m = t[0] * kN0Inv;
        c = ((uint64_t)t[0] + (uint64_t)m * kN[0]) >> 32;
#pragma unroll
        for (int j = 1; j < 8; ++j) {
            c += (uint64_t)t[j] + (uint64_t)m * kN[j];
            t[j - 1] = (uint32_t)c;
            c >>= 32;
        }
        c += t[8];
        t[7] = (uint32_t)c;
        t[8] = t[9] + (uint32_t)(c >> 32);
    }
    Fe d, out;
    uint64_t borrow = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const uint64_t s = (uint64_t)t[k] - kN[k] - borrow;
        d.v[k] = (uint32_t)s;
        borrow = (s >> 63) & 1u;
    }
    // t < n exactly when the subtraction borrows out of the top word
    const uint32_t keep = (t[8] < borrow) ? 0xFFFFFFFFu : 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) out.v[k] = (t[k] & keep) | (d.v[k] & ~keep);
    return out;
}

// The 4-bit window w (0 = most significant) of a little-endian value
__device__ __forceinline__ uint32_t nibble(const uint32_t* v, int w) {
    return (v[7 - (w >> 3)] >> (28 - 4 * (w & 7))) & 15u;
}

// --- The inverse mod n by divsteps (divsteps.cuh) -------------------------

// n in 30-bit limbs, and n^-1 mod 2^30
__constant__ int32_t kN30[9] = {
    0x3C632551, 0x0EE72B0B, 0x3179E84F, 0x39BEAB69, 0x3FFFFFBC,
    0x3FFFFFFF, 0x00000FFF, 0x3FFFC000, 0x0000FFFF};
constexpr uint32_t kNInv30 = 0x11FF43B1u;
// R^3 mod n: fn_mul(x^-1, R^3) = x^-1 * R^2, the inverse of a Montgomery value
__constant__ uint32_t kR3N[8] = {
    0x0B65A624u, 0xAC8EBEC9u, 0x0C0555C9u, 0x111F28AEu,
    0x6BA5E93Fu, 0x2543B924u, 0x6407BE65u, 0x503A54E7u};

// x^-1 mod n for x < n (plain values; 0 -> 0)
__device__ __forceinline__ Fe fn_inv_plain(const Fe& x) {
    Fe r;
    modinv_var(x.v, kN30, kNInv30, r.v);
    return r;
}

// The inverse in the Montgomery domain mod n (a = x*R < n): x^-1 * R,
// 0 -> 0
__device__ __forceinline__ Fe fn_inv(const Fe& a) {
    return fn_mul(fn_inv_plain(a), fe_load_const(kR3N));
}

// --- Helpers ----------------------------------------------------------------

__device__ __forceinline__ Fe ld_words(const uint32_t* src, int row, int lane, int n) {
    Fe f;
#pragma unroll
    for (int k = 0; k < 8; ++k) f.v[k] = src[(std::size_t)(row + k) * n + lane];
    return f;
}

__device__ __forceinline__ bool fe_eq(const Fe& a, const Fe& b) {
    uint32_t d = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) d |= a.v[k] ^ b.v[k];
    return d == 0u;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
    uint32_t d = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) d |= a.v[k];
    return d == 0u;
}

// --- Per-lane code ------------------------------------------------------------

// A lane of the prologue is a group of kGroup threads, each in its own
// warp of the block (see the kernel).  On the card each thread runs its
// own rank; on the host one call runs every rank in turn and block_sync
// is a no-op.
constexpr int kGroup = 2;

#ifdef __CUDA_ARCH__
#define FOR_MY_RANKS(rank, g) \
    for (int g = (rank), g##_once = 1; g##_once; g##_once = 0)
__device__ __forceinline__ void block_sync() { __syncthreads(); }
#else
#define FOR_MY_RANKS(rank, g) for (int g = 0; g < kGroup; ++g)
__device__ __forceinline__ void block_sync() {}
#endif

// the key: y^2 == x^3 - 3x + b (mod p), and not (0, 0) (mod p)
__device__ __forceinline__ bool key_check(const Fe& qx, const Fe& qy) {
    const Fe r2 = fe_load_const(kR2);
    const Fe xm = fe_mul(qx, r2);
    const Fe ym = fe_mul(qy, r2);
    const Fe x3 = fe_mul(fe_sqr(xm), xm);
    const Fe rhs = fe_add(fe_sub(x3, fe_add(fe_add(xm, xm), xm)), fe_load_const(kBM));
    return fe_eq(fe_sqr(ym), rhs) && !(fe_is_zero(xm) && fe_is_zero(ym));
}

__device__ __forceinline__ void store_windows(const Fe& u, int32_t* out, int lane, int n) {
#pragma unroll
    for (int w = 0; w < 64; ++w) out[(std::size_t)w * n + lane] = (int32_t)nibble(u.v, w);
}

// One lane of the prologue, as the group's ranks.  e: the digest rows (8 x
// n words: the packed buffer itself, or SHA-256's output on the raw-message
// path); packed: the kRows x n buffer.  Rank 0 inverts s (w = s^-1 * R mod
// n) into the lane's exchange slot while rank 1 checks the key; after the
// sync rank 0 writes the 64 window values of u1 = e*w and rank 1 those of
// u2 = r*w (64 x n int32, most significant window first).  A thread that
// holds no lane (live false) still reaches the sync.
__device__ __forceinline__ void prologue_group(int rank, bool live, int lane, int n,
                                               const uint32_t* e, const uint32_t* packed,
                                               int32_t* u1w, int32_t* u2w, uint8_t* key_ok,
                                               Fe* w_slot) {
    FOR_MY_RANKS(rank, g) {
        if (!live) continue;
        if (g == 0) {
            const Fe s = ld_words(packed, kRowS, lane, n);
            *w_slot = fn_inv(fn_mul(s, fe_load_const(kR2N)));   // s = n -> 0 -> 0
        } else {
            key_ok[lane] = (uint8_t)key_check(ld_words(packed, kRowQx, lane, n),
                                              ld_words(packed, kRowQy, lane, n));
        }
    }
    block_sync();
    FOR_MY_RANKS(rank, g) {
        if (!live) continue;
        // a plain value times a Montgomery one is the plain product, reduced
        const Fe a = g == 0 ? ld_words(e, 0, lane, n) : ld_words(packed, kRowR, lane, n);
        store_windows(fn_mul(a, *w_slot), g == 0 ? u1w : u2w, lane, n);
    }
}

// One lane of the epilogue.  X, Z: the ladder's canonical non-Montgomery
// output words (8 x n).  Writes the lane's verdict (0 or 1).  X == r'*Z
// (mod p) is tested as r'*Z*R^-1 == X*R^-1: three independent products,
// each with its second operand below p (Z, 1).
__device__ __forceinline__ void epilogue_lane(int lane, int n, const uint32_t* X,
                                              const uint32_t* Z, const uint32_t* packed,
                                              const uint8_t* key_ok, uint8_t* ok) {
    const Fe x = ld_words(X, 0, lane, n);
    const Fe z = ld_words(Z, 0, lane, n);
    const Fe r = ld_words(packed, kRowR, lane, n);
    const uint32_t flags = packed[(std::size_t)kRowFlags * n + lane];
    Fe one = fe_zero();
    one.v[0] = 1u;
    // r + n; it wraps only where rn_lt_p is false, and then goes unused
    Fe rn;
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        c += (uint64_t)r.v[k] + kN[k];
        rn.v[k] = (uint32_t)c;
        c >>= 32;
    }
    const Fe xr = fe_mul(x, one);
    const bool ok_r = fe_eq(fe_mul(r, z), xr);
    const bool ok_rn = (flags & kFlagRnLtP) && fe_eq(fe_mul(rn, z), xr);
    const bool live = (flags & kFlagRangeOk) && (flags & kFlagPreOk) && key_ok[lane];
    ok[lane] = (uint8_t)(live && !fe_is_zero(z) && (ok_r || ok_rn));
}

}  // namespace

#ifdef __CUDACC__

// The prologue's block: kGroup warps, warp g holding rank g of up to 32
// lanes.  Each rank runs the same code across its warp (no divergence
// between the inversion and the key check), and the ranks of a lane meet
// in shared memory at one __syncthreads.  The wrapper picks the lanes per
// block so that a call spreads over every SM.
constexpr int kWarp = 32;
constexpr int kPrologueThreads = kGroup * kWarp;
constexpr int kThreads = 64;

__global__ void __launch_bounds__(kPrologueThreads) verify_prologue_kernel(
        const uint32_t* __restrict__ e, const uint32_t* __restrict__ packed,
        int32_t* __restrict__ u1w, int32_t* __restrict__ u2w,
        uint8_t* __restrict__ key_ok, int n, int lanes_per_block) {
    __shared__ Fe w[kWarp];
    const int slot = threadIdx.x % kWarp;
    const int lane = blockIdx.x * lanes_per_block + slot;
    const bool live = slot < lanes_per_block && lane < n;
    prologue_group(threadIdx.x / kWarp, live, lane, n, e, packed, u1w, u2w, key_ok, &w[slot]);
}

__global__ void __launch_bounds__(kThreads) verify_epilogue_kernel(
        const uint32_t* __restrict__ X, const uint32_t* __restrict__ Z,
        const uint32_t* __restrict__ packed, const uint8_t* __restrict__ key_ok,
        uint8_t* __restrict__ ok, int n) {
    const int lane = blockIdx.x * kThreads + threadIdx.x;
    if (lane >= n) return;
    epilogue_lane(lane, n, X, Z, packed, key_ok, ok);
}

// Lanes per prologue block: n spread over the SMs (at least one block per
// SM where n allows), at most a warp's worth.
static int prologue_lanes_per_block(int n) {
    int dev = 0, sms = 1;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        sms = 1;
    const int per = n / (sms > 0 ? sms : 1);
    return per < 1 ? 1 : (per > kWarp ? kWarp : per);
}

// Launch the prologue on `stream`.  e: (8, n) digest words; packed:
// (kRows, n); u1w, u2w: (64, n) int32 out; key_ok: (n,) bytes out.
// Allocates nothing; returns the cudaError_t of the launch.
extern "C" int p256_core_prologue_launch(const void* e, const void* packed, void* u1w,
                                         void* u2w, void* key_ok, int n, void* stream) {
    if (n <= 0) return 0;
    const int per = prologue_lanes_per_block(n);
    verify_prologue_kernel<<<(n + per - 1) / per, kPrologueThreads, 0,
                             reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(e), static_cast<const uint32_t*>(packed),
        static_cast<int32_t*>(u1w), static_cast<int32_t*>(u2w),
        static_cast<uint8_t*>(key_ok), n, per);
    return static_cast<int>(cudaGetLastError());
}

// Launch the epilogue on `stream`.  X, Z: (8, n) ladder output words;
// packed: (kRows, n); key_ok: (n,) bytes; ok: (n,) bytes out.
extern "C" int p256_core_epilogue_launch(const void* X, const void* Z, const void* packed,
                                         const void* key_ok, void* ok, int n, void* stream) {
    if (n <= 0) return 0;
    verify_epilogue_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                             reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(X), static_cast<const uint32_t*>(Z),
        static_cast<const uint32_t*>(packed), static_cast<const uint8_t*>(key_ok),
        static_cast<uint8_t*>(ok), n);
    return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
