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
// (ops/p256_core.py).  The raw-message path hands K1 the digest words
// that SHA-256 computed on the card in place of the buffer's e rows.
//
// Arithmetic mod n is a generic Montgomery product (CIOS over 8 x 32-bit
// words, n0' = -n^-1 mod 2^32, R = 2^256): n has no special form, unlike
// p.  The inversion is Fermat over the fixed exponent n - 2 in 4-bit
// windows: a table of a^0..a^15 (14 products), then 252 squarings and one
// product per non-zero window.  The window values are those of the
// constant exponent, so no branch depends on data.  The key check and the
// epilogue use the ladder's P-256 field code (p256_field.cuh).
//
// What bounds them on this card: operations.  The prologue is ~330
// products mod n (each 136 32-bit word products) per lane against ~680
// bytes per lane in and out; the epilogue is 4 products mod p.  One
// thread runs one lane, so at the main path's width (2048 lanes) the time
// is one lane's chain of dependent products; a later design can spread
// the inversion's chain over several threads as the ladder does.
//
// Padding lanes are all zeros: s = 0 inverts to 0 (0^(n-2) = 0), which
// neither traps nor loops, and range_ok masks the lane.  An off-curve key
// still gives window planes and runs the ladder; key_ok masks it.
//
// The per-lane code is plain C++ under a host compiler (no __CUDACC__),
// so the tests build it with g++ and hold it against Python ints and the
// plain PyTorch prologue and epilogue.  Only the kernels and the
// launchers need nvcc.

#include "p256_field.cuh"

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
// n - 2: the Fermat exponent
__constant__ uint32_t kNm2[8] = {
    0xFC63254Fu, 0xF3B9CAC2u, 0xA7179E84u, 0xBCE6FAADu,
    0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u, 0xFFFFFFFFu};
// R^2 mod n (R = 2^256): to-Montgomery multiplier mod n
__constant__ uint32_t kR2N[8] = {
    0xBE79EEA2u, 0x83244C95u, 0x49BD6FA6u, 0x4699799Cu,
    0x2B6BEC59u, 0x2845B239u, 0xF3D95620u, 0x66E12D94u};
// R mod n: Montgomery one mod n
__constant__ uint32_t kOneN[8] = {
    0x039CDAAFu, 0x0C46353Du, 0x58E8617Bu, 0x43190552u,
    0x00000000u, 0x00000000u, 0xFFFFFFFFu, 0x00000000u};
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

// a^(n-2) in the Montgomery domain mod n (a < n): the inverse, 0 -> 0
__device__ __forceinline__ Fe fn_inv(const Fe& a) {
    Fe tab[16];
    tab[0] = fe_load_const(kOneN);
    tab[1] = a;
#pragma unroll 1
    for (int k = 2; k < 16; ++k) tab[k] = fn_mul(tab[k - 1], a);
    Fe acc = tab[nibble(kNm2, 0)];
#pragma unroll 1
    for (int w = 1; w < 64; ++w) {
#pragma unroll 1
        for (int q = 0; q < 4; ++q) acc = fn_mul(acc, acc);
        const uint32_t e = nibble(kNm2, w);    // the exponent's, not data
        if (e != 0u) acc = fn_mul(acc, tab[e]);
    }
    return acc;
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

// One lane of the prologue.  e: the digest rows (8 x n words: the packed
// buffer itself, or SHA-256's output on the raw-message path); packed:
// the kRows x n buffer.  Writes the lane's 64 window values of u1 and u2
// (64 x n int32, most significant window first) and key_ok (0 or 1).
__device__ __forceinline__ void prologue_lane(int lane, int n, const uint32_t* e,
                                              const uint32_t* packed, int32_t* u1w,
                                              int32_t* u2w, uint8_t* key_ok) {
    const Fe ev = ld_words(e, 0, lane, n);
    const Fe r = ld_words(packed, kRowR, lane, n);
    const Fe s = ld_words(packed, kRowS, lane, n);
    const Fe w_m = fn_inv(fn_mul(s, fe_load_const(kR2N)));   // s^-1 * R mod n
    // a plain value times a Montgomery one is the plain product
    const Fe u1 = fn_mul(ev, w_m);
    const Fe u2 = fn_mul(r, w_m);
#pragma unroll
    for (int w = 0; w < 64; ++w) {
        u1w[(std::size_t)w * n + lane] = (int32_t)nibble(u1.v, w);
        u2w[(std::size_t)w * n + lane] = (int32_t)nibble(u2.v, w);
    }
    // the key: y^2 == x^3 - 3x + b (mod p), and not (0, 0) (mod p)
    const Fe r2 = fe_load_const(kR2);
    const Fe xm = fe_mul(ld_words(packed, kRowQx, lane, n), r2);
    const Fe ym = fe_mul(ld_words(packed, kRowQy, lane, n), r2);
    const Fe x3 = fe_mul(fe_sqr(xm), xm);
    const Fe rhs = fe_add(fe_sub(x3, fe_add(fe_add(xm, xm), xm)), fe_load_const(kBM));
    const bool on_curve = fe_eq(fe_sqr(ym), rhs);
    key_ok[lane] = (uint8_t)(on_curve && !(fe_is_zero(xm) && fe_is_zero(ym)));
}

// One lane of the epilogue.  X, Z: the ladder's canonical non-Montgomery
// output words (8 x n).  Writes the lane's verdict (0 or 1).
__device__ __forceinline__ void epilogue_lane(int lane, int n, const uint32_t* X,
                                              const uint32_t* Z, const uint32_t* packed,
                                              const uint8_t* key_ok, uint8_t* ok) {
    const Fe x = ld_words(X, 0, lane, n);
    const Fe z = ld_words(Z, 0, lane, n);
    const Fe r = ld_words(packed, kRowR, lane, n);
    const uint32_t flags = packed[(std::size_t)kRowFlags * n + lane];
    const Fe r2 = fe_load_const(kR2);
    // fe_mul(c, R^2) = c*R mod p for any c < 2^256; times Z (plain) = c*Z
    const bool ok_r = fe_eq(fe_mul(fe_mul(r, r2), z), x);
    // r + n; it wraps only where rn_lt_p is false, and then goes unused
    Fe rn;
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        c += (uint64_t)r.v[k] + kN[k];
        rn.v[k] = (uint32_t)c;
        c >>= 32;
    }
    const bool ok_rn = (flags & kFlagRnLtP) && fe_eq(fe_mul(fe_mul(rn, r2), z), x);
    const bool live = (flags & kFlagRangeOk) && (flags & kFlagPreOk) && key_ok[lane];
    ok[lane] = (uint8_t)(live && !fe_is_zero(z) && (ok_r || ok_rn));
}

}  // namespace

#ifdef __CUDACC__

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads) verify_prologue_kernel(
        const uint32_t* __restrict__ e, const uint32_t* __restrict__ packed,
        int32_t* __restrict__ u1w, int32_t* __restrict__ u2w,
        uint8_t* __restrict__ key_ok, int n) {
    const int lane = blockIdx.x * kThreads + threadIdx.x;
    if (lane >= n) return;
    prologue_lane(lane, n, e, packed, u1w, u2w, key_ok);
}

__global__ void __launch_bounds__(kThreads) verify_epilogue_kernel(
        const uint32_t* __restrict__ X, const uint32_t* __restrict__ Z,
        const uint32_t* __restrict__ packed, const uint8_t* __restrict__ key_ok,
        uint8_t* __restrict__ ok, int n) {
    const int lane = blockIdx.x * kThreads + threadIdx.x;
    if (lane >= n) return;
    epilogue_lane(lane, n, X, Z, packed, key_ok, ok);
}

// Launch the prologue on `stream`.  e: (8, n) digest words; packed:
// (kRows, n); u1w, u2w: (64, n) int32 out; key_ok: (n,) bytes out.
// Allocates nothing; returns the cudaError_t of the launch.
extern "C" int p256_core_prologue_launch(const void* e, const void* packed, void* u1w,
                                         void* u2w, void* key_ok, int n, void* stream) {
    if (n <= 0) return 0;
    verify_prologue_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                             reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(e), static_cast<const uint32_t*>(packed),
        static_cast<int32_t*>(u1w), static_cast<int32_t*>(u2w),
        static_cast<uint8_t*>(key_ok), n);
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
