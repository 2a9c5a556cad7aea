// clock64 readings of dependent chains on one warp of an H100, for the chain
// floor of the raw lanes' SHA-256 kernel (fabric_mod_tpu_torch/csrc/sha256.cu).
// A measurement, not part of the package: chip_smoke.py builds it with nvcc
// into build/probe/ beside the package's sources and calls it in phase 2.
//
// sha256_latency_probe(out, iters, mode, stream) runs `iters` x 8 links of
// a chain on one warp, a link being
//   0  SHF -> LOP3 -> IADD3 (3 dependent instructions),
//   1  a butterfly shuffle between neighbouring threads and an add (the
//      kernel's exchange between a lane's two threads),
//   2  the round's own chain, x' = y + (rotr(x, 6) ^ rotr(x, 11) ^
//      rotr(x, 25)) + z: three SHF into a LOP3 into an IADD3,
// and thread 0 writes out[0] the cycles, out[1] the links, out[2] the
// chain's value (so that nothing is dropped).  out: 3 int64 on the card.
// Returns the launch's cudaError_t.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

// x + y + z as one IADD3, as the kernel writes the round's last add
__device__ __forceinline__ uint32_t add3(uint32_t x, uint32_t y, uint32_t z) {
    uint32_t r;
    asm("{\n\t.reg .u32 t;\n\tadd.u32 t, %1, %2;\n\tadd.u32 %0, t, %3;\n\t}"
        : "=r"(r) : "r"(x), "r"(y), "r"(z));
    return r;
}

__global__ void sha256_latency_probe_kernel(uint32_t x, uint32_t y, uint32_t z, int iters,
                                            int mode, long long* out) {
    x ^= threadIdx.x;  // a value of each thread's own, so no shuffle folds away
    const long long t0 = clock64();
    switch (mode) {
    case 0:
        for (int i = 0; i < iters; ++i) {
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                asm volatile("shf.r.wrap.b32 %0, %0, %0, 7;" : "+r"(x));
                asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;" : "+r"(x) : "r"(y), "r"(z));
                asm volatile("add.u32 %0, %0, %1;" : "+r"(x) : "r"(y));
            }
        }
        break;
    case 1:
        for (int i = 0; i < iters; ++i) {
#pragma unroll
            for (int u = 0; u < 8; ++u) x = __shfl_xor_sync(0xffffffffu, x, 1) + y;
        }
        break;
    default:
        for (int i = 0; i < iters; ++i) {
#pragma unroll
            for (int u = 0; u < 8; ++u)
                x = add3(y, rotr(x, 6) ^ rotr(x, 11) ^ rotr(x, 25), z);
        }
        break;
    }
    const long long t1 = clock64();
    if (threadIdx.x == 0) {
        out[0] = t1 - t0;
        out[1] = (long long)iters * 8;
        out[2] = x;
    }
}

}  // namespace

extern "C" int sha256_latency_probe(void* out, int iters, int mode, void* stream) {
    sha256_latency_probe_kernel<<<1, 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
            0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, iters, mode, static_cast<long long*>(out));
    return static_cast<int>(cudaGetLastError());
}
