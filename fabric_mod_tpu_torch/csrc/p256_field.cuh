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

#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#define __device__
#define __forceinline__ inline
#define __constant__
struct uint4 {
    uint32_t x, y, z, w;
};
#endif

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

// acc[0 .. 2N] += x * (y[0] + y[1]*2^64 + ... + y[N-1]*2^(64(N-1))): the
// products' low and high words land on consecutive words, so N products
// are one carry chain of 2N multiply-adds, and the carry out lands in
// acc[2N].  The caller guarantees that acc[2N] does not overflow.
template <int N>
__device__ __forceinline__ void mac_pairs(uint32_t* acc, uint32_t x, const uint32_t* y);

#ifdef __CUDA_ARCH__
template <>
__device__ __forceinline__ void mac_pairs<1>(uint32_t* a, uint32_t x, const uint32_t* y) {
    asm volatile(
        "mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
        "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
        "addc.u32 %2, %2, 0;"
        : "+r"(a[0]), "+r"(a[1]), "+r"(a[2])
        : "r"(x), "r"(y[0]));
}
template <>
__device__ __forceinline__ void mac_pairs<2>(uint32_t* a, uint32_t x, const uint32_t* y) {
    asm volatile(
        "mad.lo.cc.u32 %0, %5, %6, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %6, %1;\n\t"
        "madc.lo.cc.u32 %2, %5, %7, %2;\n\t"
        "madc.hi.cc.u32 %3, %5, %7, %3;\n\t"
        "addc.u32 %4, %4, 0;"
        : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(a[4])
        : "r"(x), "r"(y[0]), "r"(y[1]));
}
template <>
__device__ __forceinline__ void mac_pairs<3>(uint32_t* a, uint32_t x, const uint32_t* y) {
    asm volatile(
        "mad.lo.cc.u32 %0, %7, %8, %0;\n\t"
        "madc.hi.cc.u32 %1, %7, %8, %1;\n\t"
        "madc.lo.cc.u32 %2, %7, %9, %2;\n\t"
        "madc.hi.cc.u32 %3, %7, %9, %3;\n\t"
        "madc.lo.cc.u32 %4, %7, %10, %4;\n\t"
        "madc.hi.cc.u32 %5, %7, %10, %5;\n\t"
        "addc.u32 %6, %6, 0;"
        : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(a[4]),
          "+r"(a[5]), "+r"(a[6])
        : "r"(x), "r"(y[0]), "r"(y[1]), "r"(y[2]));
}
template <>
__device__ __forceinline__ void mac_pairs<4>(uint32_t* a, uint32_t x, const uint32_t* y) {
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
        : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(a[4]),
          "+r"(a[5]), "+r"(a[6]), "+r"(a[7]), "+r"(a[8])
        : "r"(x), "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]));
}
#else
template <int N>
__device__ __forceinline__ void mac_pairs(uint32_t* a, uint32_t x, const uint32_t* y) {
    uint64_t c = 0;
    for (int k = 0; k < N; ++k) {
        const uint64_t p = (uint64_t)x * y[k];
        uint64_t s = (uint64_t)a[2 * k] + (uint32_t)p + c;
        a[2 * k] = (uint32_t)s;
        s = (uint64_t)a[2 * k + 1] + (uint32_t)(p >> 32) + (s >> 32);
        a[2 * k + 1] = (uint32_t)s;
        c = s >> 32;
    }
    a[2 * N] += (uint32_t)c;
}
#endif

// e[1..15] += o[1..15], no carry out (the caller's sum fits in 16 words)
__device__ __forceinline__ void add_odd_into_even(uint32_t* e, const uint32_t* o) {
#ifdef __CUDA_ARCH__
    uint32_t c;
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
        : "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]),
          "+r"(e[6]), "+r"(e[7]), "+r"(e[8]), "=r"(c)
        : "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]),
          "r"(o[7]), "r"(o[8]));
    // add.cc of c + 0xFFFFFFFF sets the carry flag exactly when c == 1
    asm volatile(
        "{\n\t.reg .u32 t;\n\t"
        "add.cc.u32 t, %7, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 %0, %0, %8;\n\t"
        "addc.cc.u32 %1, %1, %9;\n\t"
        "addc.cc.u32 %2, %2, %10;\n\t"
        "addc.cc.u32 %3, %3, %11;\n\t"
        "addc.cc.u32 %4, %4, %12;\n\t"
        "addc.cc.u32 %5, %5, %13;\n\t"
        "addc.u32 %6, %6, %14;\n\t}"
        : "+r"(e[9]), "+r"(e[10]), "+r"(e[11]), "+r"(e[12]), "+r"(e[13]),
          "+r"(e[14]), "+r"(e[15])
        : "r"(c), "r"(o[9]), "r"(o[10]), "r"(o[11]), "r"(o[12]), "r"(o[13]),
          "r"(o[14]), "r"(o[15]));
#else
    uint64_t c = 0;
    for (int k = 1; k < 16; ++k) {
        const uint64_t s = (uint64_t)e[k] + o[k] + c;
        e[k] = (uint32_t)s;
        c = s >> 32;
    }
#endif
}

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

// Montgomery product a*b*2^-256 mod p.  Needs a < 2^256, b < p.  Each
// row of b is two independent chains of 4 word products whose low and
// high halves tile the row without overlap.  Products that land on even
// words accumulate in A, those on odd words in B (B[i] is word i+1), so
// every 64-bit multiply-add writes a register pair of the same alignment
// in every row; A + B*2^32 is the 512-bit product.
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
    uint32_t A[17], Bs[18];
#pragma unroll
    for (int k = 0; k < 17; ++k) {
        A[k] = 0u;
        Bs[k] = 0u;
    }
    Bs[17] = 0u;
    uint32_t* B = Bs + 1;
    const uint32_t ae[4] = {a.v[0], a.v[2], a.v[4], a.v[6]};
    const uint32_t ao[4] = {a.v[1], a.v[3], a.v[5], a.v[7]};
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
        mac_pairs<4>(A + j, b.v[j], ae);
        mac_pairs<4>(B + j, b.v[j], ao);
        mac_pairs<4>(A + j + 2, b.v[j + 1], ao);
        mac_pairs<4>(B + j, b.v[j + 1], ae);
    }
    add_odd_into_even(A, Bs);
    return mont_reduce(A);
}

// Montgomery square a*a*2^-256 mod p, a < p: the 28 cross products once
// (row i: a_i times a_{i+1..7}, as two chains of non-overlapping products
// into e and o), doubled, plus the 8 squares on the diagonal: 36 word
// products.
__device__ __forceinline__ Fe fe_sqr(const Fe& a) {
    uint32_t e[16], o[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        e[k] = 0u;
        o[k] = 0u;
    }
    const uint32_t* x = a.v;
    {
        const uint32_t y0[4] = {x[1], x[3], x[5], x[7]};
        const uint32_t y1[3] = {x[2], x[4], x[6]};
        const uint32_t y2[3] = {x[3], x[5], x[7]};
        const uint32_t y3[2] = {x[4], x[6]};
        const uint32_t y4[2] = {x[5], x[7]};
        mac_pairs<4>(e + 1, x[0], y0);
        mac_pairs<3>(e + 3, x[1], y1);
        mac_pairs<3>(e + 5, x[2], y2);
        mac_pairs<2>(e + 7, x[3], y3);
        mac_pairs<2>(e + 9, x[4], y4);
        mac_pairs<1>(e + 11, x[5], x + 6);
        mac_pairs<1>(e + 13, x[6], x + 7);
    }
    {
        const uint32_t y0[3] = {x[2], x[4], x[6]};
        const uint32_t y1[3] = {x[3], x[5], x[7]};
        const uint32_t y2[2] = {x[4], x[6]};
        const uint32_t y3[2] = {x[5], x[7]};
        mac_pairs<3>(o + 2, x[0], y0);
        mac_pairs<3>(o + 4, x[1], y1);
        mac_pairs<2>(o + 6, x[2], y2);
        mac_pairs<2>(o + 8, x[3], y3);
        mac_pairs<1>(o + 10, x[4], x + 6);
        mac_pairs<1>(o + 12, x[5], x + 7);
    }
    add_odd_into_even(e, o);              // e = the cross products, < 2^511
#ifdef __CUDA_ARCH__
    asm volatile(
        "add.cc.u32 %0, %0, %0;\n\t"
        "addc.cc.u32 %1, %1, %1;\n\t"
        "addc.cc.u32 %2, %2, %2;\n\t"
        "addc.cc.u32 %3, %3, %3;\n\t"
        "addc.cc.u32 %4, %4, %4;\n\t"
        "addc.cc.u32 %5, %5, %5;\n\t"
        "addc.cc.u32 %6, %6, %6;\n\t"
        "addc.cc.u32 %7, %7, %7;\n\t"
        "addc.cc.u32 %8, %8, %8;\n\t"
        "addc.cc.u32 %9, %9, %9;\n\t"
        "addc.cc.u32 %10, %10, %10;\n\t"
        "addc.cc.u32 %11, %11, %11;\n\t"
        "addc.cc.u32 %12, %12, %12;\n\t"
        "addc.cc.u32 %13, %13, %13;\n\t"
        "addc.u32 %14, %14, %14;"
        : "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]),
          "+r"(e[6]), "+r"(e[7]), "+r"(e[8]), "+r"(e[9]), "+r"(e[10]),
          "+r"(e[11]), "+r"(e[12]), "+r"(e[13]), "+r"(e[14]), "+r"(e[15]));
    asm volatile(
        "mad.lo.cc.u32 %0, %16, %16, %0;\n\t"
        "madc.hi.cc.u32 %1, %16, %16, %1;\n\t"
        "madc.lo.cc.u32 %2, %17, %17, %2;\n\t"
        "madc.hi.cc.u32 %3, %17, %17, %3;\n\t"
        "madc.lo.cc.u32 %4, %18, %18, %4;\n\t"
        "madc.hi.cc.u32 %5, %18, %18, %5;\n\t"
        "madc.lo.cc.u32 %6, %19, %19, %6;\n\t"
        "madc.hi.cc.u32 %7, %19, %19, %7;\n\t"
        "madc.lo.cc.u32 %8, %20, %20, %8;\n\t"
        "madc.hi.cc.u32 %9, %20, %20, %9;\n\t"
        "madc.lo.cc.u32 %10, %21, %21, %10;\n\t"
        "madc.hi.cc.u32 %11, %21, %21, %11;\n\t"
        "madc.lo.cc.u32 %12, %22, %22, %12;\n\t"
        "madc.hi.cc.u32 %13, %22, %22, %13;\n\t"
        "madc.lo.cc.u32 %14, %23, %23, %14;\n\t"
        "madc.hi.u32 %15, %23, %23, %15;"
        : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]),
          "+r"(e[5]), "+r"(e[6]), "+r"(e[7]), "+r"(e[8]), "+r"(e[9]),
          "+r"(e[10]), "+r"(e[11]), "+r"(e[12]), "+r"(e[13]), "+r"(e[14]),
          "+r"(e[15])
        : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]),
          "r"(x[6]), "r"(x[7]));
#else
    uint32_t top = 0;
    for (int k = 1; k < 16; ++k) {
        const uint32_t next = e[k] >> 31;
        e[k] = (e[k] << 1) | top;
        top = next;
    }
    uint64_t c = 0;
    for (int i = 0; i < 8; ++i) {
        const uint64_t sq = (uint64_t)x[i] * x[i];
        uint64_t s = (uint64_t)e[2 * i] + (uint32_t)sq + c;
        e[2 * i] = (uint32_t)s;
        s = (uint64_t)e[2 * i + 1] + (uint32_t)(sq >> 32) + (s >> 32);
        e[2 * i + 1] = (uint32_t)s;
        c = s >> 32;
    }
#endif
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
