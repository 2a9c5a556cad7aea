// FP256BN field and tower arithmetic for the idemix pairing kernels
// (fp256bn_pairing.cu).
//
// p = 0xfffffffffffcf0cd46e5f25eee71a49f0cdc65fb12980a82d3292ddbaed33013 (the
// BN curve of idemix, 256 bits).  An Fp element is 8 x uint32 little-endian
// words in Montgomery form with R = 2^256.  The product is a generic CIOS
// Montgomery product (64 word products for a*b, 8 for the quotient digits,
// 64 for m*p): p has no special form, so p256_field.cuh's closed-form
// reduction does not apply.  p's top word is 0xffffffff, so there is no
// headroom for lazy reduction: every product, add and subtract returns a
// value below p, and equality is equality of words.
//
// The tower is the reference's (fabric_mod_tpu/ops/fp256bn_dev.py and the
// host fabric_mod_tpu_torch/idemix/fp256bn.py), formula for formula:
//   Fp2  = Fp[i]/(i^2 + 1)       Karatsuba product (3 Fp products)
//   Fp6  = Fp2[v]/(v^3 - xi)     xi = 1 + i; 6 Fp2 products (18 Fp)
//   Fp12 = Fp6[w]/(w^2 - v)      Karatsuba over Fp6 (54 Fp); the square 36
// with the sparse line multiply (42 Fp products), the Frobenius map with
// its five constants, and the inverse through f6_inv and f2_inv with one
// Fp inversion (Fermat, p - 2, square-and-multiply as the plain limb
// code's pow_static: 256 squares and 151 products).
//
// Everything here is plain C++ (no inline PTX; the one intrinsic, the
// thread group's barrier, is left out under a host compiler), so g++ builds
// it as it stands: the tests hold each operation against Python ints and
// the JAX reference.  Outside
// __CUDACC__ every Fp product also raises a counter (fp_products), which
// the tests read to count the products a lane needs; the card never
// counts.

#pragma once

#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define BN_NOINLINE __noinline__
#else
#define __device__
#define __forceinline__ inline
#define __constant__
#define BN_NOINLINE
#endif

namespace {

struct Fp {
    uint32_t v[8];
};
struct Fp2 {
    Fp c[2];          // c[0] + c[1]*i
};
struct Fp6 {
    Fp2 c[3];         // c[0] + c[1]*v + c[2]*v^2
};
struct Fp12 {
    Fp6 c[2];         // c[0] + c[1]*w
};

// p, little-endian words
__constant__ uint32_t kBnP[8] = {
    0xAED33013u, 0xD3292DDBu, 0x12980A82u, 0x0CDC65FBu,
    0xEE71A49Fu, 0x46E5F25Eu, 0xFFFCF0CDu, 0xFFFFFFFFu};
// p - 2: the Fermat inverse's exponent
__constant__ uint32_t kBnPm2[8] = {
    0xAED33011u, 0xD3292DDBu, 0x12980A82u, 0x0CDC65FBu,
    0xEE71A49Fu, 0x46E5F25Eu, 0xFFFCF0CDu, 0xFFFFFFFFu};
// R^2 mod p: the to-Montgomery multiplier
__constant__ uint32_t kBnR2[8] = {
    0x1092B98Fu, 0xFAC8C610u, 0xD7F91154u, 0xDB90D49Cu,
    0x32BF3141u, 0x4F325FC7u, 0x0E56A005u, 0x4DE578EAu};
// R mod p: the Montgomery one
__constant__ uint32_t kBnOneM[8] = {
    0x512CCFEDu, 0x2CD6D224u, 0xED67F57Du, 0xF3239A04u,
    0x118E5B60u, 0xB91A0DA1u, 0x00030F32u, 0x00000000u};
// -p^-1 mod 2^32
constexpr uint32_t kBnP0Inv = 0x0537E5E5u;
// |u| of the curve (u < 0): the final exponentiation's three powers
constexpr uint64_t kBnAbsU = 0x6882F5C030B0A801ull;
// The Frobenius constants in Montgomery form, (Fp2 .a, .b) each: xi^((p-1)/3)
// for the Fp6 coefficient 1, xi^(2(p-1)/3) for 2, xi^((p-1)/6) for the w
// half's coefficient 0, and their products for its coefficients 1 and 2
__constant__ uint32_t kBnFrob[5][2][8] = {
    {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
     {0x84008C2Cu, 0xAC441038u, 0xF524DB81u, 0x26E76706u,
      0xB51EAFF8u, 0x49CC4E27u, 0x3C3F9CFFu, 0x26664872u}},
    {{0xD52D5C19u, 0xD91AE25Cu, 0xE28CD0FEu, 0x1A0B010Bu,
      0xC6AD0B59u, 0x02E65BC8u, 0x3C42AC32u, 0x26664872u},
     {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
    {{0x9F5752E0u, 0x77F4336Cu, 0x415EE3E9u, 0xE3BDB82Du,
      0x47E2E741u, 0x1DB98D94u, 0xC29F09A5u, 0x18511E53u},
     {0x0F7BDD33u, 0x5B34FA6Fu, 0xD1392699u, 0x291EADCDu,
      0xA68EBD5Du, 0x292C64CAu, 0x3D5DE728u, 0xE7AEE1ACu}},
    {{0x589425D3u, 0x5EDCF655u, 0xCB8ED0C3u, 0x15149D62u,
      0xD8B38DF6u, 0x1EDDC85Du, 0x803FA480u, 0x90DB7F10u},
     {0x589425D3u, 0x5EDCF655u, 0xCB8ED0C3u, 0x15149D62u,
      0xD8B38DF6u, 0x1EDDC85Du, 0x803FA480u, 0x90DB7F10u}},
    {{0xF7EB78B3u, 0xD6D129C1u, 0x0CEDB4ACu, 0xF8D25590u,
      0x20967537u, 0x3C9755F2u, 0x42DEAE25u, 0xA92C9D64u},
     {0xB6E7B760u, 0xFC580419u, 0x05AA55D5u, 0x140A106Bu,
      0xCDDB2F67u, 0x0A4E9C6Cu, 0xBD1E42A8u, 0x56D3629Bu}}};

#ifndef __CUDACC__
unsigned long long fp_products = 0;
#endif

// --- Fp: values < p in, values < p out ---------------------------------------

__device__ __forceinline__ Fp fp_load_const(const uint32_t* c) {
    Fp r;
#pragma unroll
    for (int k = 0; k < 8; ++k) r.v[k] = c[k];
    return r;
}

__device__ __forceinline__ Fp fp_zero() {
    Fp r;
#pragma unroll
    for (int k = 0; k < 8; ++k) r.v[k] = 0u;
    return r;
}

__device__ __forceinline__ bool fp_eq(const Fp& a, const Fp& b) {
    uint32_t d = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) d |= a.v[k] ^ b.v[k];
    return d == 0u;
}

// (c : t) with c in {0, 1} and value < 2p  ->  value mod p
__device__ __forceinline__ Fp fp_reduce_once(const uint32_t* t, uint32_t c) {
    Fp d, out;
    uint64_t borrow = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const uint64_t s = (uint64_t)t[k] - kBnP[k] - borrow;
        d.v[k] = (uint32_t)s;
        borrow = (s >> 63) & 1u;
    }
    // (c : t) < p exactly when the subtraction borrows out of the top word
    const uint32_t keep = (c < borrow) ? 0xFFFFFFFFu : 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) out.v[k] = (t[k] & keep) | (d.v[k] & ~keep);
    return out;
}

// Montgomery product a*b*2^-256 mod p (CIOS).  After each row t < 2p <
// 2^257, so t is 9 words with a top word of 0 or 1 (t[9] holds the row's
// carry before the shift); one masked subtraction of p reduces fully.
// It is a call on the card, not inlined: inlined into every tower
// operation, the products made the kernels' code far larger than the
// SM's instruction cache, and the kernels ran and built slower.
__device__ BN_NOINLINE Fp fp_mul(Fp a, Fp b) {
#ifndef __CUDACC__
    ++fp_products;
#endif
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
        const uint32_t m = t[0] * kBnP0Inv;
        c = ((uint64_t)t[0] + (uint64_t)m * kBnP[0]) >> 32;
#pragma unroll
        for (int j = 1; j < 8; ++j) {
            c += (uint64_t)t[j] + (uint64_t)m * kBnP[j];
            t[j - 1] = (uint32_t)c;
            c >>= 32;
        }
        c += t[8];
        t[7] = (uint32_t)c;
        t[8] = t[9] + (uint32_t)(c >> 32);
    }
    return fp_reduce_once(t, t[8]);
}

__device__ __forceinline__ Fp fp_sqr(const Fp& a) { return fp_mul(a, a); }

__device__ __forceinline__ Fp fp_add(const Fp& a, const Fp& b) {
    uint32_t s[8];
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        c += (uint64_t)a.v[k] + b.v[k];
        s[k] = (uint32_t)c;
        c >>= 32;
    }
    return fp_reduce_once(s, (uint32_t)c);
}

__device__ __forceinline__ Fp fp_sub(const Fp& a, const Fp& b) {
    Fp d, out;
    uint64_t borrow = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const uint64_t s = (uint64_t)a.v[k] - b.v[k] - borrow;
        d.v[k] = (uint32_t)s;
        borrow = (s >> 63) & 1u;
    }
    // a < b: add p back (mod 2^256)
    const uint32_t mask = borrow ? 0xFFFFFFFFu : 0u;
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        c += (uint64_t)d.v[k] + (kBnP[k] & mask);
        out.v[k] = (uint32_t)c;
        c >>= 32;
    }
    return out;
}

__device__ __forceinline__ Fp fp_neg(const Fp& a) { return fp_sub(fp_zero(), a); }

// canonical -> Montgomery, and back
__device__ __forceinline__ Fp fp_to_mont(const Fp& a) {
    return fp_mul(a, fp_load_const(kBnR2));
}

__device__ __forceinline__ Fp fp_from_mont(const Fp& a) {
    Fp one = fp_zero();
    one.v[0] = 1u;
    return fp_mul(a, one);
}

// a^(p-2) in the Montgomery domain, most significant bit first from the
// Montgomery one (0 maps to 0)
__device__ BN_NOINLINE Fp fp_inv(const Fp& a) {
    Fp acc = fp_load_const(kBnOneM);
    for (int bit = 255; bit >= 0; --bit) {
        acc = fp_sqr(acc);
        if ((kBnPm2[bit >> 5] >> (bit & 31)) & 1u) acc = fp_mul(acc, a);
    }
    return acc;
}

// --- Fp2 ----------------------------------------------------------------------

__device__ __forceinline__ Fp2 f2_add(const Fp2& x, const Fp2& y) {
    return Fp2{{fp_add(x.c[0], y.c[0]), fp_add(x.c[1], y.c[1])}};
}

__device__ __forceinline__ Fp2 f2_sub(const Fp2& x, const Fp2& y) {
    return Fp2{{fp_sub(x.c[0], y.c[0]), fp_sub(x.c[1], y.c[1])}};
}

__device__ __forceinline__ Fp2 f2_neg(const Fp2& x) {
    return Fp2{{fp_neg(x.c[0]), fp_neg(x.c[1])}};
}

__device__ __forceinline__ Fp2 f2_conj(const Fp2& x) {
    return Fp2{{x.c[0], fp_neg(x.c[1])}};
}

// Karatsuba: (t0 - t1, t2 - t0 - t1), 3 products
__device__ __forceinline__ Fp2 f2_mul(const Fp2& x, const Fp2& y) {
    const Fp t0 = fp_mul(x.c[0], y.c[0]);
    const Fp t1 = fp_mul(x.c[1], y.c[1]);
    const Fp t2 = fp_mul(fp_add(x.c[0], x.c[1]), fp_add(y.c[0], y.c[1]));
    return Fp2{{fp_sub(t0, t1), fp_sub(t2, fp_add(t0, t1))}};
}

// ((a + b)(a - b), 2ab): 2 products
__device__ __forceinline__ Fp2 f2_sqr(const Fp2& x) {
    const Fp m = fp_mul(x.c[0], x.c[1]);
    return Fp2{{fp_mul(fp_add(x.c[0], x.c[1]), fp_sub(x.c[0], x.c[1])),
                fp_add(m, m)}};
}

__device__ __forceinline__ Fp2 f2_mul_fp(const Fp2& x, const Fp& s) {
    return Fp2{{fp_mul(x.c[0], s), fp_mul(x.c[1], s)}};
}

// times xi = 1 + i: (a - b, a + b)
__device__ __forceinline__ Fp2 f2_mul_xi(const Fp2& x) {
    return Fp2{{fp_sub(x.c[0], x.c[1]), fp_add(x.c[0], x.c[1])}};
}

__device__ BN_NOINLINE Fp2 f2_inv(const Fp2& x) {
    const Fp d = fp_inv(fp_add(fp_sqr(x.c[0]), fp_sqr(x.c[1])));
    return Fp2{{fp_mul(x.c[0], d), fp_neg(fp_mul(x.c[1], d))}};
}

// --- Fp6 ----------------------------------------------------------------------

__device__ __forceinline__ Fp6 f6_add(const Fp6& x, const Fp6& y) {
    return Fp6{{f2_add(x.c[0], y.c[0]), f2_add(x.c[1], y.c[1]), f2_add(x.c[2], y.c[2])}};
}

__device__ __forceinline__ Fp6 f6_sub(const Fp6& x, const Fp6& y) {
    return Fp6{{f2_sub(x.c[0], y.c[0]), f2_sub(x.c[1], y.c[1]), f2_sub(x.c[2], y.c[2])}};
}

__device__ __forceinline__ Fp6 f6_neg(const Fp6& x) {
    return Fp6{{f2_neg(x.c[0]), f2_neg(x.c[1]), f2_neg(x.c[2])}};
}

// times v: (xi*c2, c0, c1)
__device__ __forceinline__ Fp6 f6_mul_v(const Fp6& x) {
    return Fp6{{f2_mul_xi(x.c[2]), x.c[0], x.c[1]}};
}

__device__ __forceinline__ Fp6 f6_mul_fp(const Fp6& x, const Fp& s) {
    return Fp6{{f2_mul_fp(x.c[0], s), f2_mul_fp(x.c[1], s), f2_mul_fp(x.c[2], s)}};
}

// Toom-style: 6 Fp2 products (18 Fp)
__device__ BN_NOINLINE Fp6 f6_mul(const Fp6& x, const Fp6& y) {
    const Fp2 t0 = f2_mul(x.c[0], y.c[0]);
    const Fp2 t1 = f2_mul(x.c[1], y.c[1]);
    const Fp2 t2 = f2_mul(x.c[2], y.c[2]);
    const Fp2 m12 = f2_mul(f2_add(x.c[1], x.c[2]), f2_add(y.c[1], y.c[2]));
    const Fp2 m01 = f2_mul(f2_add(x.c[0], x.c[1]), f2_add(y.c[0], y.c[1]));
    const Fp2 m02 = f2_mul(f2_add(x.c[0], x.c[2]), f2_add(y.c[0], y.c[2]));
    Fp6 r;
    r.c[0] = f2_add(f2_mul_xi(f2_sub(m12, f2_add(t1, t2))), t0);
    r.c[1] = f2_add(f2_sub(m01, f2_add(t0, t1)), f2_mul_xi(t2));
    r.c[2] = f2_add(f2_sub(m02, f2_add(t0, t2)), t1);
    return r;
}

// x * (0, b1, b2): 5 Fp2 products (15 Fp)
__device__ BN_NOINLINE Fp6 f6_mul_sparse12(const Fp6& x, const Fp2& b1, const Fp2& b2) {
    const Fp2 t1 = f2_mul(x.c[1], b1);
    const Fp2 t2 = f2_mul(x.c[2], b2);
    const Fp2 m12 = f2_mul(f2_add(x.c[1], x.c[2]), f2_add(b1, b2));
    const Fp2 m01 = f2_mul(f2_add(x.c[0], x.c[1]), b1);
    const Fp2 m02 = f2_mul(f2_add(x.c[0], x.c[2]), b2);
    Fp6 r;
    r.c[0] = f2_mul_xi(f2_sub(m12, f2_add(t1, t2)));
    r.c[1] = f2_add(f2_sub(m01, t1), f2_mul_xi(t2));
    r.c[2] = f2_add(f2_sub(m02, t2), t1);
    return r;
}

__device__ BN_NOINLINE Fp6 f6_inv(const Fp6& x) {
    const Fp2 &a0 = x.c[0], &a1 = x.c[1], &a2 = x.c[2];
    Fp6 t;
    t.c[0] = f2_sub(f2_sqr(a0), f2_mul_xi(f2_mul(a1, a2)));
    t.c[1] = f2_sub(f2_mul_xi(f2_sqr(a2)), f2_mul(a0, a1));
    t.c[2] = f2_sub(f2_sqr(a1), f2_mul(a0, a2));
    const Fp2 d = f2_add(f2_mul(a0, t.c[0]),
                         f2_add(f2_mul_xi(f2_mul(a2, t.c[1])),
                                f2_mul_xi(f2_mul(a1, t.c[2]))));
    const Fp2 di = f2_inv(d);
    return Fp6{{f2_mul(t.c[0], di), f2_mul(t.c[1], di), f2_mul(t.c[2], di)}};
}

// --- Fp12 ---------------------------------------------------------------------

__device__ __forceinline__ Fp12 f12_one() {
    Fp12 r;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) r.c[h].c[i].c[j] = fp_zero();
    r.c[0].c[0].c[0] = fp_load_const(kBnOneM);
    return r;
}

__device__ __forceinline__ Fp12 f12_conj(const Fp12& x) {
    return Fp12{{x.c[0], f6_neg(x.c[1])}};
}

// --- A lane's thread group ------------------------------------------------------
//
// The Fp12 product, square and line multiply hand their independent Fp6
// products to kGroup threads of one lane: rank r computes its part and
// puts it in the lane's exchange slots, the group meets at a barrier, and
// every rank reads all parts and combines them (the combination is adds
// only, so every rank holds the same Fp12 after every operation, and the
// code between these operations runs on every rank alike).  On the card
// a rank is a warp of the block (rank r of 32 lanes), the slots are
// shared memory, word-major with a stride of the block's 32 lanes (no
// bank conflict), two buffers used in turn so that one barrier an
// operation suffices, and the barrier is __syncthreads.  Under a host
// compiler one caller runs every rank's part in turn (FOR_MY_RANKS) and
// the slots are its own array.
constexpr int kGroup = 3;
constexpr int kF6Words = 48;
// a lane's exchange words: two buffers of kGroup Fp6 parts
constexpr int kXchWords = 2 * kGroup * kF6Words;

struct Group {
    int rank;          // this thread's rank (0 under a host compiler)
    uint32_t* xch;     // word 0 of the lane's exchange slots
    int stride;        // between one slot word and the next
    int buf;           // the buffer of the next split operation
};

#ifdef __CUDA_ARCH__
#define FOR_MY_RANKS(g, r) for (int r = (g).rank, once_ = 1; once_; once_ = 0)
#define GROUP_SYNC() __syncthreads()
#else
#define FOR_MY_RANKS(g, r) for (int r = 0; r < kGroup; ++r)
#define GROUP_SYNC()
#endif

__device__ __forceinline__ void xch_put(const Group& g, int r, const Fp6& x) {
    uint32_t* w = g.xch + (size_t)(g.buf * kGroup + r) * kF6Words * g.stride;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int k = 0; k < 8; ++k) w[(size_t)(i * 16 + j * 8 + k) * g.stride] = x.c[i].c[j].v[k];
}

__device__ __forceinline__ Fp6 xch_get(const Group& g, int r) {
    const uint32_t* w = g.xch + (size_t)(g.buf * kGroup + r) * kF6Words * g.stride;
    Fp6 x;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int k = 0; k < 8; ++k) x.c[i].c[j].v[k] = w[(size_t)(i * 16 + j * 8 + k) * g.stride];
    return x;
}

// Karatsuba over Fp6: (t0 + v*t1, (a0 + a1)(b0 + b1) - t0 - t1), 54
// products, t_r on rank r (18 each)
__device__ BN_NOINLINE Fp12 f12_mul(Group& g, const Fp12& x, const Fp12& y) {
    FOR_MY_RANKS(g, r) {
        if (r == 0)
            xch_put(g, 0, f6_mul(x.c[0], y.c[0]));
        else if (r == 1)
            xch_put(g, 1, f6_mul(x.c[1], y.c[1]));
        else
            xch_put(g, 2, f6_mul(f6_add(x.c[0], x.c[1]), f6_add(y.c[0], y.c[1])));
    }
    GROUP_SYNC();
    const Fp6 t0 = xch_get(g, 0), t1 = xch_get(g, 1), t2 = xch_get(g, 2);
    g.buf ^= 1;
    return Fp12{{f6_add(t0, f6_mul_v(t1)), f6_sub(t2, f6_add(t0, t1))}};
}

// ((a0 + a1)(a0 + v*a1) - t0 - v*t0, 2*t0) with t0 = a0*a1: 36 products,
// t0 on rank 0 and the other on rank 1 (rank 2 waits)
__device__ BN_NOINLINE Fp12 f12_sqr(Group& g, const Fp12& x) {
    FOR_MY_RANKS(g, r) {
        if (r == 0)
            xch_put(g, 0, f6_mul(x.c[0], x.c[1]));
        else if (r == 1)
            xch_put(g, 1, f6_mul(f6_add(x.c[0], x.c[1]),
                                 f6_add(x.c[0], f6_mul_v(x.c[1]))));
    }
    GROUP_SYNC();
    const Fp6 t0 = xch_get(g, 0), s = xch_get(g, 1);
    g.buf ^= 1;
    return Fp12{{f6_sub(s, f6_add(t0, f6_mul_v(t0))), f6_add(t0, t0)}};
}

// t = (a0^2 - v*a1^2)^-1; (a0*t, -(a1*t))
__device__ BN_NOINLINE Fp12 f12_inv(const Fp12& x) {
    const Fp6 t = f6_inv(f6_sub(f6_mul(x.c[0], x.c[0]),
                                f6_mul_v(f6_mul(x.c[1], x.c[1]))));
    return Fp12{{f6_mul(x.c[0], t), f6_neg(f6_mul(x.c[1], t))}};
}

// f * l for the sparse line l = yp*1 + A*(v*w) + Bxp*(v^2*w), i.e.
// l.c0 = (yp, 0, 0) and l.c1 = (0, A, Bxp):
// (a0*yp + v*(a1*l1)) + (a0*l1 + a1*yp) w, 12 + 30 = 42 products, the
// first half on rank 0 and the second on rank 1 (21 each; rank 2 waits)
__device__ BN_NOINLINE Fp12 f12_mul_line(Group& g, const Fp12& f, const Fp& yp,
                                         const Fp2& A, const Fp2& Bxp) {
    FOR_MY_RANKS(g, r) {
        if (r == 0)
            xch_put(g, 0, f6_add(f6_mul_fp(f.c[0], yp),
                                 f6_mul_v(f6_mul_sparse12(f.c[1], A, Bxp))));
        else if (r == 1)
            xch_put(g, 1, f6_add(f6_mul_sparse12(f.c[0], A, Bxp),
                                 f6_mul_fp(f.c[1], yp)));
    }
    GROUP_SYNC();
    const Fp6 c0 = xch_get(g, 0), c1 = xch_get(g, 1);
    g.buf ^= 1;
    return Fp12{{c0, c1}};
}

__device__ __forceinline__ Fp2 frob_const(int k) {
    return Fp2{{fp_load_const(kBnFrob[k][0]), fp_load_const(kBnFrob[k][1])}};
}

// x -> x^p: conjugate every Fp2 coefficient, then scale five of them
__device__ BN_NOINLINE Fp12 f12_frobenius(const Fp12& x) {
    Fp12 r;
    r.c[0].c[0] = f2_conj(x.c[0].c[0]);
    r.c[0].c[1] = f2_mul(f2_conj(x.c[0].c[1]), frob_const(0));
    r.c[0].c[2] = f2_mul(f2_conj(x.c[0].c[2]), frob_const(1));
    r.c[1].c[0] = f2_mul(f2_conj(x.c[1].c[0]), frob_const(2));
    r.c[1].c[1] = f2_mul(f2_conj(x.c[1].c[1]), frob_const(3));
    r.c[1].c[2] = f2_mul(f2_conj(x.c[1].c[2]), frob_const(4));
    return r;
}

// x == 1: the Montgomery one in coefficient 0, zero elsewhere (every value
// is fully reduced, so this compares words)
__device__ __forceinline__ bool f12_is_one(const Fp12& x) {
    const Fp12 one = f12_one();
    bool ok = true;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
                ok = ok && fp_eq(x.c[h].c[i].c[j], one.c[h].c[i].c[j]);
    return ok;
}

}  // namespace
