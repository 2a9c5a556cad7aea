// FP256BN field arithmetic for the idemix pairing kernels
// (fp256bn_pairing.cu).
//
// p = 0xfffffffffffcf0cd46e5f25eee71a49f0cdc65fb12980a82d3292ddbaed33013 (the
// BN curve of idemix, 256 bits).  An Fp element is 8 x uint32 little-endian
// words in Montgomery form with R = 2^256.  p has no special form, so the
// product is the 512-bit product of carry chains (carry_chain.cuh: 64 word
// products for a*b, 36 for a*a) and a separated-operand-scanning Montgomery
// reduction whose eight quotient rows are carry chains too (bn_reduce).
// p's top word is 0xffffffff, so there is no headroom: every product and
// every sum returns a value below p, and equality is equality of words.
//
// A lane's sums are linear forms (fp256bn_programs.cuh): signed sums of up
// to 63 values.  They accumulate in 9 words with no reduction (acc_add: a
// value, or its complement for a subtracted one) and reduce once
// (acc_reduce).  The inverse is by divsteps
// (divsteps.cuh) and one product.
//
// Each PTX block has a plain C++ twin, so g++ builds all of it: the tests
// hold each operation against Python ints.  Outside __CUDACC__ every Fp
// product raises fp_products (a square fp_squares as well) and every inverse
// fp_inverses, which the tests read to count a lane's work; the card never
// counts.

#pragma once

#include "carry_chain.cuh"
#include "divsteps.cuh"

namespace {

struct Fp {
    uint32_t v[8];
};

// p, little-endian words
__constant__ uint32_t kBnP[8] = {
    0xAED33013u, 0xD3292DDBu, 0x12980A82u, 0x0CDC65FBu,
    0xEE71A49Fu, 0x46E5F25Eu, 0xFFFCF0CDu, 0xFFFFFFFFu};
// R^2 mod p: the to-Montgomery multiplier
__constant__ uint32_t kBnR2[8] = {
    0x1092B98Fu, 0xFAC8C610u, 0xD7F91154u, 0xDB90D49Cu,
    0x32BF3141u, 0x4F325FC7u, 0x0E56A005u, 0x4DE578EAu};
// R mod p: the Montgomery one, and 2^256 mod p (below 2^210)
__constant__ uint32_t kBnOneM[8] = {
    0x512CCFEDu, 0x2CD6D224u, 0xED67F57Du, 0xF3239A04u,
    0x118E5B60u, 0xB91A0DA1u, 0x00030F32u, 0x00000000u};
// R^3 mod p: a product by it takes x^-1 R^-1 to x^-1 R
__constant__ uint32_t kBnR3[8] = {
    0x9A16D9D8u, 0x83C66E0Au, 0x6611AEFBu, 0x1C36F059u,
    0xDFA71510u, 0x97F1B5FAu, 0x2053B221u, 0x3A7E67C1u};
// 2p + 1 - 2^256: what the accumulator adds for each complemented value
__constant__ uint32_t kBnNegK[8] = {
    0x5DA66027u, 0xA6525BB7u, 0x25301505u, 0x19B8CBF6u,
    0xDCE3493Eu, 0x8DCBE4BDu, 0xFFF9E19Au, 0xFFFFFFFFu};
// p in 30-bit limbs, and p^-1 mod 2^30 (the divsteps)
__constant__ int32_t kBnP30[9] = {
    0x2ED33013, 0x0CA4B76E, 0x2980A82D, 0x37197EC4, 0x31A49F0C,
    0x17C97BB9, 0x0F0CD46E, 0x3FFFFFFF, 0x0000FFFF};
constexpr uint32_t kBnPInv30 = 0x3AC81A1Bu;
// -p^-1 mod 2^32
constexpr uint32_t kBnP0Inv = 0x0537E5E5u;
// |u| of the curve (u < 0): the final exponentiation's three powers
constexpr uint64_t kBnAbsU = 0x6882F5C030B0A801ull;

#ifndef __CUDACC__
unsigned long long fp_products = 0, fp_squares = 0, fp_inverses = 0;
#endif

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

// (c : t) with c in {0, 1} and value < 2p  ->  value mod p
__device__ __forceinline__ Fp fp_reduce_once(const uint32_t* t, uint32_t c) {
    Fp d, out;
#ifdef __CUDA_ARCH__
    uint32_t keep;     // all ones when (c : t) < p
    asm volatile(
        "sub.cc.u32 %0, %9, 0xAED33013;\n\t"
        "subc.cc.u32 %1, %10, 0xD3292DDB;\n\t"
        "subc.cc.u32 %2, %11, 0x12980A82;\n\t"
        "subc.cc.u32 %3, %12, 0x0CDC65FB;\n\t"
        "subc.cc.u32 %4, %13, 0xEE71A49F;\n\t"
        "subc.cc.u32 %5, %14, 0x46E5F25E;\n\t"
        "subc.cc.u32 %6, %15, 0xFFFCF0CD;\n\t"
        "subc.cc.u32 %7, %16, 0xFFFFFFFF;\n\t"
        "subc.u32 %8, %17, 0;"
        : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]),
          "=r"(d.v[4]), "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7]), "=r"(keep)
        : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]),
          "r"(t[6]), "r"(t[7]), "r"(c));
#else
    uint64_t borrow = 0;
    for (int k = 0; k < 8; ++k) {
        const uint64_t s = (uint64_t)t[k] - kBnP[k] - borrow;
        d.v[k] = (uint32_t)s;
        borrow = (s >> 63) & 1u;
    }
    const uint32_t keep = (c < borrow) ? 0xFFFFFFFFu : 0u;
#endif
#pragma unroll
    for (int k = 0; k < 8; ++k) out.v[k] = (t[k] & keep) | (d.v[k] & ~keep);
    return out;
}

// Montgomery reduction of the 512-bit t (t < 2^256 * p, 16 words):
// t * 2^-256 mod p.  Row i adds m_i * p at word i, m_i = t[i] * -p^-1 mod
// 2^32 (t[i] is final by then), as two carry chains of non-overlapping
// word products (p's even words, then its odd words); each row's carry out
// of word i + 8 waits in `pend` (at most 2) for the next row's chain, which
// starts at that word.  After row 7, (pend : t[8..15]) < 2p.
__device__ __forceinline__ Fp bn_reduce(uint32_t* t) {
#ifdef __CUDA_ARCH__
    constexpr uint32_t p0 = 0xAED33013u, p1 = 0xD3292DDBu, p2 = 0x12980A82u,
                       p3 = 0x0CDC65FBu, p4 = 0xEE71A49Fu, p5 = 0x46E5F25Eu,
                       p6 = 0xFFFCF0CDu, p7 = 0xFFFFFFFFu;
    uint32_t pend = 0u, e;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const uint32_t m = t[i] * kBnP0Inv;
        asm volatile(
            "mad.lo.cc.u32 %0, %10, %11, %0;\n\t"
            "madc.hi.cc.u32 %1, %10, %11, %1;\n\t"
            "madc.lo.cc.u32 %2, %10, %12, %2;\n\t"
            "madc.hi.cc.u32 %3, %10, %12, %3;\n\t"
            "madc.lo.cc.u32 %4, %10, %13, %4;\n\t"
            "madc.hi.cc.u32 %5, %10, %13, %5;\n\t"
            "madc.lo.cc.u32 %6, %10, %14, %6;\n\t"
            "madc.hi.cc.u32 %7, %10, %14, %7;\n\t"
            "addc.cc.u32 %8, %8, %15;\n\t"
            "addc.u32 %9, 0, 0;"
            : "+r"(t[i]), "+r"(t[i + 1]), "+r"(t[i + 2]), "+r"(t[i + 3]),
              "+r"(t[i + 4]), "+r"(t[i + 5]), "+r"(t[i + 6]), "+r"(t[i + 7]),
              "+r"(t[i + 8]), "=r"(e)
            : "r"(m), "r"(p0), "r"(p2), "r"(p4), "r"(p6), "r"(pend));
        asm volatile(
            "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
            "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
            "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
            "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
            "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
            "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
            "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
            "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
            "addc.u32 %8, %14, 0;"
            : "+r"(t[i + 1]), "+r"(t[i + 2]), "+r"(t[i + 3]), "+r"(t[i + 4]),
              "+r"(t[i + 5]), "+r"(t[i + 6]), "+r"(t[i + 7]), "+r"(t[i + 8]),
              "=r"(pend)
            : "r"(m), "r"(p1), "r"(p3), "r"(p5), "r"(p7), "r"(e));
    }
    return fp_reduce_once(t + 8, pend);
#else
    uint32_t x[17];
    for (int k = 0; k < 16; ++k) x[k] = t[k];
    x[16] = 0u;
    for (int i = 0; i < 8; ++i) {
        const uint32_t m = x[i] * kBnP0Inv;
        uint64_t c = 0;
        for (int j = 0; j < 8; ++j) {
            c += (uint64_t)x[i + j] + (uint64_t)m * kBnP[j];
            x[i + j] = (uint32_t)c;
            c >>= 32;
        }
        for (int k = i + 8; k < 17; ++k) {
            c += x[k];
            x[k] = (uint32_t)c;
            c >>= 32;
        }
    }
    return fp_reduce_once(x + 8, x[16]);
#endif
}

// Montgomery product a*b*2^-256 mod p (a, b < p)
__device__ __forceinline__ Fp fp_mul(const Fp& a, const Fp& b) {
#ifndef __CUDACC__
    ++fp_products;
#endif
    uint32_t t[17];
    wide_mul(a.v, b.v, t);
    return bn_reduce(t);
}

// Montgomery square a*a*2^-256 mod p (a < p): 36 word products
__device__ __forceinline__ Fp fp_sqr(const Fp& a) {
#ifndef __CUDACC__
    ++fp_products;
    ++fp_squares;
#endif
    uint32_t t[16];
    wide_sqr(a.v, t);
    return bn_reduce(t);
}

// a^-1 in the Montgomery domain (a = x R -> x^-1 R; 0 -> 0): divsteps
// give (x R)^-1, a product by R^3 moves it into the domain
__device__ __forceinline__ Fp fp_inv(const Fp& a) {
#ifndef __CUDACC__
    ++fp_inverses;
#endif
    Fp r;
    modinv_var(a.v, kBnP30, kBnPInv30, r.v);
    return fp_mul(r, fp_load_const(kBnR3));
}

// --- Linear forms ------------------------------------------------------------
//
// A form's values add into a 9-word accumulator, one carry chain a value,
// with no reduction: a subtracted value adds its complement ~x = 2^256 - 1
// - x instead, and m counts them.  (Column sums of 64 bits, eight
// independent adds a value with the carries run once, ran ~5% slower on
// the card: more instructions.)

struct Acc {
    uint32_t v[9];
    uint32_t m;
};

__device__ __forceinline__ Acc acc_zero() {
    Acc a;
#pragma unroll
    for (int k = 0; k < 9; ++k) a.v[k] = 0u;
    a.m = 0u;
    return a;
}

// a += x ^ s: s = 0 adds x, s all ones adds ~x
__device__ __forceinline__ void acc_add(Acc& a, const Fp& x, uint32_t s) {
    uint32_t y[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) y[k] = x.v[k] ^ s;
#ifdef __CUDA_ARCH__
    asm volatile(
        "add.cc.u32 %0, %0, %9;\n\t"
        "addc.cc.u32 %1, %1, %10;\n\t"
        "addc.cc.u32 %2, %2, %11;\n\t"
        "addc.cc.u32 %3, %3, %12;\n\t"
        "addc.cc.u32 %4, %4, %13;\n\t"
        "addc.cc.u32 %5, %5, %14;\n\t"
        "addc.cc.u32 %6, %6, %15;\n\t"
        "addc.cc.u32 %7, %7, %16;\n\t"
        "addc.u32 %8, %8, 0;"
        : "+r"(a.v[0]), "+r"(a.v[1]), "+r"(a.v[2]), "+r"(a.v[3]), "+r"(a.v[4]),
          "+r"(a.v[5]), "+r"(a.v[6]), "+r"(a.v[7]), "+r"(a.v[8])
        : "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]), "r"(y[5]),
          "r"(y[6]), "r"(y[7]));
#else
    uint64_t c = 0;
    for (int k = 0; k < 8; ++k) {
        c += (uint64_t)a.v[k] + y[k];
        a.v[k] = (uint32_t)c;
        c >>= 32;
    }
    a.v[8] += (uint32_t)c;
#endif
    a.m += s & 1u;
}

// The accumulated sum mod p.  The accumulator holds S + m (2^256 - 1), S
// the form's value; adding m (2p + 1 - 2^256) makes D = S + 2mp < 2^263,
// and D = D_hi 2^256 + D_lo = D_lo + D_hi (2^256 mod p) < 2^256 + 2^217 <
// 2p (mod p).  On the card both multiply-adds are carry chains of the
// constant's even words, then its odd words (2^256 mod p is below 2^224).
__device__ __forceinline__ Fp acc_reduce(const Acc& a) {
#ifdef __CUDA_ARCH__
    uint32_t d[9], top;
#pragma unroll
    for (int k = 0; k < 9; ++k) d[k] = a.v[k];
    asm volatile(
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8])
        : "r"(a.m), "r"(0x5DA66027u), "r"(0x25301505u), "r"(0xDCE3493Eu),
          "r"(0xFFF9E19Au));
    asm volatile(
        "mad.lo.cc.u32 %0, %8, %9, %0;\n\t"
        "madc.hi.cc.u32 %1, %8, %9, %1;\n\t"
        "madc.lo.cc.u32 %2, %8, %10, %2;\n\t"
        "madc.hi.cc.u32 %3, %8, %10, %3;\n\t"
        "madc.lo.cc.u32 %4, %8, %11, %4;\n\t"
        "madc.hi.cc.u32 %5, %8, %11, %5;\n\t"
        "madc.lo.cc.u32 %6, %8, %12, %6;\n\t"
        "madc.hi.u32 %7, %8, %12, %7;"
        : "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8])
        : "r"(a.m), "r"(0xA6525BB7u), "r"(0x19B8CBF6u), "r"(0x8DCBE4BDu),
          "r"(0xFFFFFFFFu));
    const uint32_t hi = d[8];
    asm volatile(
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, 0, 0;"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "=r"(top)
        : "r"(hi), "r"(0x512CCFEDu), "r"(0xED67F57Du), "r"(0x118E5B60u),
          "r"(0x00030F32u));
    asm volatile(
        "mad.lo.cc.u32 %0, %8, %9, %0;\n\t"
        "madc.hi.cc.u32 %1, %8, %9, %1;\n\t"
        "madc.lo.cc.u32 %2, %8, %10, %2;\n\t"
        "madc.hi.cc.u32 %3, %8, %10, %3;\n\t"
        "madc.lo.cc.u32 %4, %8, %11, %4;\n\t"
        "madc.hi.cc.u32 %5, %8, %11, %5;\n\t"
        "addc.cc.u32 %6, %6, 0;\n\t"
        "addc.u32 %7, %7, 0;"
        : "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(top)
        : "r"(hi), "r"(0x2CD6D224u), "r"(0xF3239A04u), "r"(0xB91A0DA1u));
    return fp_reduce_once(d, top);
#else
    uint32_t d[8], e[8];
    uint64_t c = 0;
    for (int k = 0; k < 8; ++k) {
        c += (uint64_t)a.v[k] + (uint64_t)a.m * kBnNegK[k];
        d[k] = (uint32_t)c;
        c >>= 32;
    }
    const uint32_t hi = a.v[8] + (uint32_t)c;
    c = 0;
    for (int k = 0; k < 8; ++k) {
        c += (uint64_t)d[k] + (uint64_t)hi * kBnOneM[k];
        e[k] = (uint32_t)c;
        c >>= 32;
    }
    return fp_reduce_once(e, (uint32_t)c);
#endif
}

}  // namespace
