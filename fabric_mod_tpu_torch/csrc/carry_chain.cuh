// Carry chains of 32-bit multiply-adds for 256-bit Montgomery arithmetic,
// shared by the P-256 field (p256_field.cuh) and the FP256BN field
// (fp256bn_field.cuh): the 512-bit product and square of 8-word values,
// whose reductions each field writes for its own p.
//
// Each carry chain is one asm block on the card (the carry flag does not
// survive between asm statements); the #else branch is the same
// computation in plain C++ for the host compiler, so the tests build the
// fields with g++ and hold them against Python ints.

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

// A[0 .. 15] = a * b (A holds 17 words; A[16] ends 0).  Each row of b is
// two independent chains of 4 word products whose low and high halves
// tile the row without overlap.  Products that land on even words
// accumulate in A, those on odd words in B (B[i] is word i+1), so every
// 64-bit multiply-add writes a register pair of the same alignment in
// every row; A + B*2^32 is the 512-bit product.
__device__ __forceinline__ void wide_mul(const uint32_t* a, const uint32_t* b, uint32_t* A) {
    uint32_t Bs[18];
#pragma unroll
    for (int k = 0; k < 17; ++k) {
        A[k] = 0u;
        Bs[k] = 0u;
    }
    Bs[17] = 0u;
    uint32_t* B = Bs + 1;
    const uint32_t ae[4] = {a[0], a[2], a[4], a[6]};
    const uint32_t ao[4] = {a[1], a[3], a[5], a[7]};
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
        mac_pairs<4>(A + j, b[j], ae);
        mac_pairs<4>(B + j, b[j], ao);
        mac_pairs<4>(A + j + 2, b[j + 1], ao);
        mac_pairs<4>(B + j, b[j + 1], ae);
    }
    add_odd_into_even(A, Bs);
}

// e[0 .. 15] = x * x: the 28 cross products once (row i: x_i times
// x_{i+1..7}, as two chains of non-overlapping products into e and o),
// doubled, plus the 8 squares on the diagonal: 36 word products.
__device__ __forceinline__ void wide_sqr(const uint32_t* x, uint32_t* e) {
    uint32_t o[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        e[k] = 0u;
        o[k] = 0u;
    }
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
}

}  // namespace
