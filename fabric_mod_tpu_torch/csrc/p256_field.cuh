// P-256 field arithmetic mod p, shared by the ladder (p256_ladder.cu) and
// the verify core's prologue and epilogue (p256_core.cu).
//
// A field element is 8 x uint32 little-endian words in Montgomery form,
// R = 2^256.  The product's rows are carry chains of 64-bit multiply-adds
// (PTX mad.lo.cc / madc.hi.cc) whose register pairs keep one alignment in
// every row; a square takes 36 word products instead of 64; the reduction
// is in closed form: -p^-1 mod 2^256 = 1 + 2^96 + 2^193 - 2^224, so the
// Montgomery multiplier is three shifted adds and the reduction a few
// carry chains, with no multiply and no word-by-word dependence.  Adds and
// subtracts are one add.cc / sub.cc chain and a masked correction.
//
// Everything here is plain C++ when compiled by a host compiler (no
// __CUDACC__): each inline PTX block has a plain C++ twin that computes
// the same values, so the tests build it with g++ and hold it against
// Python ints.

#pragma once

#include "carry_chain.cuh"

namespace {

struct Fe {
    uint32_t v[8];
};

// p = 2^256 - 2^224 + 2^192 + 2^96 - 1, little-endian words
__constant__ uint32_t kP[8] = {
    0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u,
    0x00000000u, 0x00000000u, 0x00000001u, 0xFFFFFFFFu};
// R^2 mod p (R = 2^256): to-Montgomery multiplier
__constant__ uint32_t kR2[8] = {
    0x00000003u, 0x00000000u, 0xFFFFFFFFu, 0xFFFFFFFBu,
    0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFDu, 0x00000004u};
// R mod p: Montgomery one
__constant__ uint32_t kOneM[8] = {
    0x00000001u, 0x00000000u, 0x00000000u, 0xFFFFFFFFu,
    0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFEu, 0x00000000u};

__device__ __forceinline__ Fe fe_load_const(const uint32_t* c) {
    Fe r;
#pragma unroll
    for (int k = 0; k < 8; ++k) r.v[k] = c[k];
    return r;
}

__device__ __forceinline__ Fe fe_zero() {
    Fe r;
#pragma unroll
    for (int k = 0; k < 8; ++k) r.v[k] = 0u;
    return r;
}

__device__ __forceinline__ Fe fe_sel(bool take_a, const Fe& a, const Fe& b) {
    Fe r;
#pragma unroll
    for (int k = 0; k < 8; ++k) r.v[k] = take_a ? a.v[k] : b.v[k];
    return r;
}

// --- Field arithmetic: values < p in, values < p out ----------------------
//
// Each carry chain is one asm block on the card (the carry flag does not
// survive between asm statements); the #else branch is the same
// computation in plain C++ for the host compiler.

// (c : r) with c in {0, 1} and value < 2p  ->  value mod p
__device__ __forceinline__ Fe fe_reduce_once(const uint32_t* r, uint32_t c) {
    Fe d, out;
#ifdef __CUDA_ARCH__
    uint32_t keep;     // all ones when (c : r) < p
    asm volatile(
        "sub.cc.u32 %0, %9, 0xFFFFFFFF;\n\t"
        "subc.cc.u32 %1, %10, 0xFFFFFFFF;\n\t"
        "subc.cc.u32 %2, %11, 0xFFFFFFFF;\n\t"
        "subc.cc.u32 %3, %12, 0;\n\t"
        "subc.cc.u32 %4, %13, 0;\n\t"
        "subc.cc.u32 %5, %14, 0;\n\t"
        "subc.cc.u32 %6, %15, 1;\n\t"
        "subc.cc.u32 %7, %16, 0xFFFFFFFF;\n\t"
        "subc.u32 %8, %17, 0;"
        : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]),
          "=r"(d.v[4]), "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7]), "=r"(keep)
        : "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]), "r"(r[4]), "r"(r[5]),
          "r"(r[6]), "r"(r[7]), "r"(c));
#else
    uint64_t borrow = 0;
    for (int k = 0; k < 8; ++k) {
        const uint64_t s = (uint64_t)r[k] - kP[k] - borrow;
        d.v[k] = (uint32_t)s;
        borrow = (s >> 63) & 1u;
    }
    const uint32_t keep = (c < borrow) ? 0xFFFFFFFFu : 0u;
#endif
#pragma unroll
    for (int k = 0; k < 8; ++k) out.v[k] = (r[k] & keep) | (d.v[k] & ~keep);
    return out;
}

// Montgomery reduction of the 512-bit t (t < 2^256 * p): t * 2^-256 mod p,
// in closed form.  For P-256, q = -p^-1 mod 2^256 = 1 + 2^96 + 2^193 - 2^224
// (because -p = 1 - x mod 2^256 with x = 2^96 + 2^192 - 2^224 and x^3 = 0),
// so the Montgomery multiplier M = t_lo * q mod 2^256 is three shifted
// adds of t_lo, with no multiply and no word-by-word dependence.  Then
// (t + M*p) / 2^256 = t_hi + (M*2^96 + M*2^192 + V*2^224) / 2^256 + k with
// V = M*(2^32 - 1): the low 256 bits of t + M*p are zero, and k (0..3) is
// their carry, read off the top low word exactly because the words below
// can move it by at most -1..+2.  Needs t < 2^256 * p; gives a value < p.
__device__ __forceinline__ Fe mont_reduce(uint32_t* t) {
    uint32_t M[8], V[9], Z[4], Y[7], top;
    M[0] = t[0];
    M[1] = t[1];
    M[2] = t[2];
    // t_lo << 193 and t_lo << 224 touch words 6 and 7 only
    const uint32_t s6 = t[0] << 1;
    const uint32_t s7 = ((t[1] << 1) | (t[0] >> 31)) - t[0];
#ifdef __CUDA_ARCH__
    asm volatile(
        "add.cc.u32 %0, %5, %10;\n\t"
        "addc.cc.u32 %1, %6, %11;\n\t"
        "addc.cc.u32 %2, %7, %12;\n\t"
        "addc.cc.u32 %3, %8, %13;\n\t"
        "addc.u32 %4, %9, %14;"
        : "=r"(M[3]), "=r"(M[4]), "=r"(M[5]), "=r"(M[6]), "=r"(M[7])
        : "r"(t[3]), "r"(t[4]), "r"(t[5]), "r"(t[6]), "r"(t[7]),
          "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]));
    asm volatile(
        "add.cc.u32 %0, %0, %2;\n\t"
        "addc.u32 %1, %1, %3;"
        : "+r"(M[6]), "+r"(M[7])
        : "r"(s6), "r"(s7));
    // V = (M << 32) - M
    asm volatile(
        "sub.cc.u32 %0, 0, %9;\n\t"
        "subc.cc.u32 %1, %9, %10;\n\t"
        "subc.cc.u32 %2, %10, %11;\n\t"
        "subc.cc.u32 %3, %11, %12;\n\t"
        "subc.cc.u32 %4, %12, %13;\n\t"
        "subc.cc.u32 %5, %13, %14;\n\t"
        "subc.cc.u32 %6, %14, %15;\n\t"
        "subc.cc.u32 %7, %15, %16;\n\t"
        "subc.u32 %8, %16, 0;"
        : "=r"(V[0]), "=r"(V[1]), "=r"(V[2]), "=r"(V[3]), "=r"(V[4]),
          "=r"(V[5]), "=r"(V[6]), "=r"(V[7]), "=r"(V[8])
        : "r"(M[0]), "r"(M[1]), "r"(M[2]), "r"(M[3]), "r"(M[4]), "r"(M[5]),
          "r"(M[6]), "r"(M[7]));
#else
    {
        const uint32_t add[5] = {t[0], t[1], t[2], t[3], t[4]};
        uint64_t c = 0;
        for (int w = 0; w < 5; ++w) {
            c = (uint64_t)t[3 + w] + add[w] + (c >> 32);
            M[3 + w] = (uint32_t)c;
        }
        c = (uint64_t)M[6] + s6;
        M[6] = (uint32_t)c;
        M[7] += s7 + (uint32_t)(c >> 32);
        uint64_t borrow = 0;
        for (int w = 0; w < 9; ++w) {
            const uint64_t hi = w > 0 ? M[w - 1] : 0u, lo = w < 8 ? M[w] : 0u;
            const uint64_t d = hi - lo - borrow;
            V[w] = (uint32_t)d;
            borrow = (d >> 63) & 1u;
        }
    }
#endif
    // word 7 of the low half: t7 + M4 (M << 96) + M1 (M << 192) + V0 (V << 224) - M7
    const uint32_t k = (uint32_t)(((uint64_t)t[7] + M[4] + M[1] + V[0] + 2u - M[7]) >> 32);
#ifdef __CUDA_ARCH__
    // Z = M5 + M6*2^32 + M7*2^64 + k;  Y = M[2..7] + Z;  t_hi += V[1..8]; t_hi += Y
    asm volatile(
        "add.cc.u32 %0, %4, %7;\n\t"
        "addc.cc.u32 %1, %5, 0;\n\t"
        "addc.cc.u32 %2, %6, 0;\n\t"
        "addc.u32 %3, 0, 0;"
        : "=r"(Z[0]), "=r"(Z[1]), "=r"(Z[2]), "=r"(Z[3])
        : "r"(M[5]), "r"(M[6]), "r"(M[7]), "r"(k));
    asm volatile(
        "add.cc.u32 %0, %7, %13;\n\t"
        "addc.cc.u32 %1, %8, %14;\n\t"
        "addc.cc.u32 %2, %9, %15;\n\t"
        "addc.cc.u32 %3, %10, %16;\n\t"
        "addc.cc.u32 %4, %11, 0;\n\t"
        "addc.cc.u32 %5, %12, 0;\n\t"
        "addc.u32 %6, 0, 0;"
        : "=r"(Y[0]), "=r"(Y[1]), "=r"(Y[2]), "=r"(Y[3]), "=r"(Y[4]),
          "=r"(Y[5]), "=r"(Y[6])
        : "r"(M[2]), "r"(M[3]), "r"(M[4]), "r"(M[5]), "r"(M[6]), "r"(M[7]),
          "r"(Z[0]), "r"(Z[1]), "r"(Z[2]), "r"(Z[3]));
    asm volatile(
        "add.cc.u32 %0, %0, %9;\n\t"
        "addc.cc.u32 %1, %1, %10;\n\t"
        "addc.cc.u32 %2, %2, %11;\n\t"
        "addc.cc.u32 %3, %3, %12;\n\t"
        "addc.cc.u32 %4, %4, %13;\n\t"
        "addc.cc.u32 %5, %5, %14;\n\t"
        "addc.cc.u32 %6, %6, %15;\n\t"
        "addc.cc.u32 %7, %7, %16;\n\t"
        "addc.u32 %8, 0, 0;"
        : "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]),
          "+r"(t[13]), "+r"(t[14]), "+r"(t[15]), "=r"(top)
        : "r"(V[1]), "r"(V[2]), "r"(V[3]), "r"(V[4]), "r"(V[5]), "r"(V[6]),
          "r"(V[7]), "r"(V[8]));
    asm volatile(
        "add.cc.u32 %0, %0, %9;\n\t"
        "addc.cc.u32 %1, %1, %10;\n\t"
        "addc.cc.u32 %2, %2, %11;\n\t"
        "addc.cc.u32 %3, %3, %12;\n\t"
        "addc.cc.u32 %4, %4, %13;\n\t"
        "addc.cc.u32 %5, %5, %14;\n\t"
        "addc.cc.u32 %6, %6, %15;\n\t"
        "addc.cc.u32 %7, %7, 0;\n\t"
        "addc.u32 %8, %8, 0;"
        : "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]),
          "+r"(t[13]), "+r"(t[14]), "+r"(t[15]), "+r"(top)
        : "r"(Y[0]), "r"(Y[1]), "r"(Y[2]), "r"(Y[3]), "r"(Y[4]), "r"(Y[5]),
          "r"(Y[6]));
#else
    {
        uint64_t c = (uint64_t)M[5] + k;
        Z[0] = (uint32_t)c;
        c = (uint64_t)M[6] + (c >> 32);
        Z[1] = (uint32_t)c;
        c = (uint64_t)M[7] + (c >> 32);
        Z[2] = (uint32_t)c;
        Z[3] = (uint32_t)(c >> 32);
        c = 0;
        for (int w = 0; w < 7; ++w) {
            c = (uint64_t)(w < 6 ? M[2 + w] : 0u) + (w < 4 ? Z[w] : 0u) + (c >> 32);
            Y[w] = (uint32_t)c;
        }
        c = 0;
        for (int w = 0; w < 8; ++w) {
            c = (uint64_t)t[8 + w] + V[1 + w] + (w < 7 ? Y[w] : 0u) + (c >> 32);
            t[8 + w] = (uint32_t)c;
        }
        top = (uint32_t)(c >> 32);
    }
#endif
    return fe_reduce_once(t + 8, top);
}

// Montgomery product a*b*2^-256 mod p.  Needs a < 2^256, b < p.
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
    uint32_t A[17];
    wide_mul(a.v, b.v, A);
    return mont_reduce(A);
}

// Montgomery square a*a*2^-256 mod p, a < p: 36 word products.
__device__ __forceinline__ Fe fe_sqr(const Fe& a) {
    uint32_t e[16];
    wide_sqr(a.v, e);
    return mont_reduce(e);
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
    Fe r = a;
    uint32_t c;
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
        "addc.u32 %8, 0, 0;"
        : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]),
          "+r"(r.v[4]), "+r"(r.v[5]), "+r"(r.v[6]), "+r"(r.v[7]), "=r"(c)
        : "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]),
          "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
#else
    uint64_t s = 0;
    for (int k = 0; k < 8; ++k) {
        s = (uint64_t)r.v[k] + b.v[k] + (s >> 32);
        r.v[k] = (uint32_t)s;
    }
    c = (uint32_t)(s >> 32);
#endif
    return fe_reduce_once(r.v, c);
}

// a - b, plus p when that borrows
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
    Fe d = a;
#ifdef __CUDA_ARCH__
    asm volatile(
        "{\n\t.reg .u32 m, m1;\n\t"
        "sub.cc.u32 %0, %0, %8;\n\t"
        "subc.cc.u32 %1, %1, %9;\n\t"
        "subc.cc.u32 %2, %2, %10;\n\t"
        "subc.cc.u32 %3, %3, %11;\n\t"
        "subc.cc.u32 %4, %4, %12;\n\t"
        "subc.cc.u32 %5, %5, %13;\n\t"
        "subc.cc.u32 %6, %6, %14;\n\t"
        "subc.cc.u32 %7, %7, %15;\n\t"
        "subc.u32 m, 0, 0;\n\t"
        "and.b32 m1, m, 1;\n\t"
        "add.cc.u32 %0, %0, m;\n\t"
        "addc.cc.u32 %1, %1, m;\n\t"
        "addc.cc.u32 %2, %2, m;\n\t"
        "addc.cc.u32 %3, %3, 0;\n\t"
        "addc.cc.u32 %4, %4, 0;\n\t"
        "addc.cc.u32 %5, %5, 0;\n\t"
        "addc.cc.u32 %6, %6, m1;\n\t"
        "addc.u32 %7, %7, m;\n\t}"
        : "+r"(d.v[0]), "+r"(d.v[1]), "+r"(d.v[2]), "+r"(d.v[3]),
          "+r"(d.v[4]), "+r"(d.v[5]), "+r"(d.v[6]), "+r"(d.v[7])
        : "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]),
          "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
#else
    uint64_t borrow = 0;
    for (int k = 0; k < 8; ++k) {
        const uint64_t s = (uint64_t)d.v[k] - b.v[k] - borrow;
        d.v[k] = (uint32_t)s;
        borrow = (s >> 63) & 1u;
    }
    const uint32_t mask = borrow ? 0xFFFFFFFFu : 0u;
    uint64_t c = 0;
    for (int k = 0; k < 8; ++k) {
        const uint64_t s = (uint64_t)d.v[k] + (kP[k] & mask) + c;
        d.v[k] = (uint32_t)s;
        c = s >> 32;
    }
#endif
    return d;
}

__device__ __forceinline__ Fe fe_sqr_n(Fe x, int n) {
#pragma unroll 1
    for (int i = 0; i < n; ++i) x = fe_sqr(x);
    return x;
}

// a^(p-2): the addition chain of ops/p256.inv_mont_p_chain (0 -> 0)
__device__ __forceinline__ Fe fe_inv(const Fe& a) {
    const Fe x2 = fe_mul(fe_sqr(a), a);
    const Fe x4 = fe_mul(fe_sqr_n(x2, 2), x2);
    const Fe x8 = fe_mul(fe_sqr_n(x4, 4), x4);
    const Fe x16 = fe_mul(fe_sqr_n(x8, 8), x8);
    const Fe x24 = fe_mul(fe_sqr_n(x16, 8), x8);
    const Fe x28 = fe_mul(fe_sqr_n(x24, 4), x4);
    const Fe x30 = fe_mul(fe_sqr_n(x28, 2), x2);
    const Fe x32 = fe_mul(fe_sqr_n(x30, 2), x2);
    Fe acc = fe_mul(fe_sqr_n(x32, 32), a);
    acc = fe_sqr_n(acc, 96);
    acc = fe_mul(fe_sqr_n(acc, 32), x32);
    acc = fe_mul(fe_sqr_n(acc, 32), x32);
    acc = fe_mul(fe_sqr_n(acc, 30), x30);
    acc = fe_mul(fe_sqr_n(acc, 2), a);
    return acc;
}

}  // namespace
