// clock64 readings of the idemix pairing kernels' pieces on an H100, for the
// design notes of fabric_mod_tpu_torch/csrc/fp256bn_pairing.cu.  A
// measurement, not part of the package: scripts/torch_pairing_probe.py
// builds it with nvcc (it includes the kernels' source) and calls its two
// entries.
//
//   pairing_probe_products(blocks, iters, square, cyc)  a chain of `iters`
//       dependent Fp products (or squares) in each thread of `blocks`
//       one-warp blocks; cyc[b] the cycles of block b's thread 0
//   pairing_probe_program(prog, reps, cyc)  one block of kLanes lanes runs
//       program `prog` `reps` times on seeded values; cyc[0] the cycles of
//       lane 0's rank 0, cyc[1] those of writing the argument table and
//       meeting, cyc[2 + s] those of stage s (each up to its __syncwarp)
//
// Each returns the cudaError_t of its launch and synchronise.

#include "../fabric_mod_tpu_torch/csrc/fp256bn_pairing.cu"

namespace {

__device__ Fp seed_fp(uint32_t s) {
    Fp a;
    for (int k = 0; k < 8; ++k) {
        s = s * 1664525u + 1013904223u;
        a.v[k] = s;
    }
    a.v[7] &= 0x7FFFFFFFu;     // below p
    return a;
}

__global__ void probe_products(int iters, int square, long long* cyc, uint32_t* sink) {
    Fp a = seed_fp(threadIdx.x + 77 * blockIdx.x), b = seed_fp(threadIdx.x + 1000);
    __syncwarp();
    const long long t0 = clock64();
    for (int i = 0; i < iters; ++i) a = square ? fp_sqr(a) : fp_mul(a, b);
    const long long t1 = clock64();
    if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
    sink[blockIdx.x * blockDim.x + threadIdx.x] = a.v[0];
}

// `run`, with each stage timed
__device__ void run_timed(Lane ln, int prog, uint32_t d, uint32_t x, uint32_t y, uint32_t z,
                          uint32_t w, long long* t) {
    long long t0 = clock64();
    if (ln.rank == 0) {
        uint32_t* at = ln.sm + ln.area;
        at[0] = d;
        at[1] = x;
        at[2] = y;
        at[3] = z;
        at[4] = w;
        at[5] = ln.area + kArgWords;
        at[6] = kConstOff;
    }
    __syncwarp();
    t[0] += clock64() - t0;
    const uint16_t* tab = reinterpret_cast<const uint16_t*>(ln.sm);
    const BnProgram* progs = reinterpret_cast<const BnProgram*>(tab);
    const BnStage* stages = reinterpret_cast<const BnStage*>(tab + 2 * kBnPrograms);
    const BnItem* items = reinterpret_cast<const BnItem*>(tab + 2 * kBnPrograms + 3 * kBnStages);
    const uint16_t* terms = tab + 2 * kBnPrograms + 3 * kBnStages + 3 * kBnItems;
    const BnProgram p = progs[prog];
    for (int s = p.first; s < p.first + p.count; ++s) {
        t0 = clock64();
        const BnStage st = stages[s];
        for (int i = ln.rank; i < st.count; i += kGroup) {
            const BnItem it = items[st.first + i];
            const uint16_t* tt = terms + it.first;
            const int na = it.n & 255, nb = it.n >> 8;
            Fp r = eval_form(ln, tt, na);
            if (st.kind == kBnMul)
                r = fp_mul(r, eval_form(ln, tt + na, nb));
            else if (st.kind == kBnSqr)
                r = fp_sqr(r);
            else if (st.kind == kBnInv)
                r = fp_inv(r);
            fp_st(ln.sm + slot(ln, it.dst), r);
        }
        __syncwarp();
        t[1 + s - p.first] += clock64() - t0;
    }
}

// a lane's area: the argument table, the products, five Fp12 arguments
constexpr uint32_t kProbeLaneWords = kArgWords + kBnMaxTemps * 8 + 5 * kF12Words;
constexpr size_t kProbeBytes = 4 * ((size_t)kBlockHeadWords + kLanes * kProbeLaneWords);

__global__ void probe_program(int prog, int reps, long long* cyc) {
    extern __shared__ uint4 smem[];
    uint32_t* sm = reinterpret_cast<uint32_t*>(smem);
    block_head(sm, threadIdx.x, kThreads);
    __syncthreads();
    const int slot_ = threadIdx.x / kGroup;
    const uint32_t base = kBlockHeadWords + slot_ * kProbeLaneWords;
    const uint32_t x = base + kArgWords + kBnMaxTemps * 8;
    for (int w = threadIdx.x % kGroup; w < 5 * kF12Words; w += kGroup)
        sm[x + w] = seed_fp(w / 8 + 100 * slot_).v[w & 7];
    __syncwarp();
    const Lane ln = make_lane(sm, threadIdx.x % kGroup, base);
    long long t[16] = {0};
    const long long t0 = clock64();
    for (int r = 0; r < reps; ++r)
        run_timed(ln, prog, x + 4 * kF12Words, x, x + kF12Words, x + 2 * kF12Words,
                  x + 3 * kF12Words, t);
    const long long t1 = clock64();
    if (threadIdx.x == 0) {
        cyc[0] = t1 - t0;
        for (int s = 0; s < 15; ++s) cyc[1 + s] = t[s];
    }
}

}  // namespace

extern "C" int pairing_probe_products(int blocks, int iters, int square, long long* cyc,
                                      uint32_t* sink) {
    probe_products<<<blocks, 32>>>(iters, square, cyc, sink);
    return static_cast<int>(cudaDeviceSynchronize());
}

extern "C" int pairing_probe_program(int prog, int reps, long long* cyc) {
    const cudaError_t err = cudaFuncSetAttribute(
        probe_program, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kProbeBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    probe_program<<<1, kThreads, kProbeBytes>>>(prog, reps, cyc);
    return static_cast<int>(cudaDeviceSynchronize());
}
