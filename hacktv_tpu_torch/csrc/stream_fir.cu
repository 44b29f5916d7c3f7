// Stream FIR over the flat video sample stream, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels behind hacktv_tpu/ops/pallas_fir.py
// `stream_fir`: `_kernel_cplx` (real in, I and Q out: the 51-tap VSB
// "scomplex" filter) and `_kernel_real` (one output: the AM/NONE low-pass,
// the FM-video pre-emphasis and the S-Video C channel).  Both compute
//
//     y[k] = sum_{t < nt} taps[nt-1-t] * xs[k+t],   k in [0, n)
//
// with f32 accumulation in tap order, every step a fused multiply-add.
// With r = taps reversed, the first step fuses one of the two products of
// the first add and rounds the other:
//
//     acc = fma(r[1], xs[k+1], round(r[0] * xs[k]))    if r[0] < 0 < r[1]
//     acc = fma(r[0], xs[k],   round(r[1] * xs[k+1]))  otherwise
//     acc = fma(r[t], xs[k+t], acc)                    for t = 2..nt-1
//
// This is the arithmetic the JAX reference's CPU backend emits for its
// `acc = r0*x0; acc = acc + r1*x1; ...` chain (its compiler rewrites
// `a*x + (-b)*y` as a subtraction and fuses the leading product), measured
// bit-exact against hacktv_tpu's stream_fir on I, Q and the real output.
// The explicit __fmul_rn/__fmaf_rn keep that order and rounding whatever
// nvcc's contraction flags are.  The plain PyTorch version beside the
// wrapper (hacktv_tpu_torch/ops/stream_fir.py) does the same steps.
// Tensor cores cannot: a wgmma sums its products in its own order from
// TF32-rounded inputs, so this chain runs on the f32 FMA pipes.
//
// What bounds it on an H100 (3.35 TB/s HBM, 33.5 T f32 FMA/s on the CUDA
// cores): at the encoder's main-path shapes one complex launch (n =
// 28,828,800, nt = 51) moves 346 MB (0.103 ms) and issues 2.94 G FMAs
// (0.088 ms); the real launch (n = 40,960,000) moves 328 MB (0.098 ms)
// for 2.09 G FMAs (0.062 ms).  Both sit near the ridge, so the design
// streams HBM at full rate and keeps the FMA pipes nearly the only thing
// the warps issue:
//
//   - persistent blocks (as many as fit on the card) each walk a strided
//     list of tiles of kTile outputs through a kStages-deep shared-memory
//     ring: one thread loads a tile's input (kTile + nt - 1 samples) with
//     one TMA bulk copy (cp.async.bulk + mbarrier) kStages - 1 tiles
//     ahead of the one being computed, so loads overlap compute;
//   - bulk copies need 16-byte-aligned sources, and the encoder's stream
//     starts nt/2 samples into a line (an offset of 833 or 999 floats).
//     Each copy starts at the 16-byte boundary at or below its tile and
//     the kernel indexes past the skew (0-3 floats, the same for every
//     tile).  The copy reads at most 12 bytes before xs and after its last
//     sample, inside the 16-byte granules that hold them;
//   - each thread owns kPer = 11 consecutive outputs.  kPer is odd, so
//     the 32 lanes of a warp reading word (lane * kPer + c) of the tile
//     hit 32 different banks with no padding (which a bulk copy cannot
//     lay out);
//   - for the tap count of every ported filter (51) the tap loop is
//     unrolled at compile time: the sliding window of kPer samples is a
//     register ring renamed by the compiler, one shared-memory load per
//     tap feeds kPer (real) or 2 kPer (complex) FMAs, and the taps, passed
//     by value in a __grid_constant__ struct, are constant-bank operands
//     of the FMAs.  Other counts (1 to kMaxTaps) take the same kernel with
//     a run-time loop;
//   - outputs are staged in shared memory (same conflict-free stride) and
//     leave as one TMA bulk store per tile and output, coalesced and
//     asynchronous; the ragged last tile is stored by all threads.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 11;                     // consecutive outputs per thread
constexpr int kTile = kThreads * kPer;       // outputs per tile (2816)
constexpr int kStages = 3;                   // input ring depth
constexpr int kMaxTaps = 256;
constexpr int kFixedTaps = 51;               // the compile-time tap count

static_assert(kPer % 2 == 1, "kPer must be odd for conflict-free loads");
static_assert(kTile % 4 == 0, "tiles must start on 16-byte boundaries");

struct FirTaps {
    float r[kMaxTaps];      // real taps in accumulation order (reversed)
    float i[kMaxTaps];      // imaginary taps (complex kernel only)
};

__host__ __device__ constexpr int stage_floats(int nt)
{
    // the tile's samples plus the halo, after up to 3 floats of skew,
    // rounded up to whole 16-byte granules
    return (kTile + nt - 1 + 3 + 3) & ~3;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity)
{
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    }
}

// one bulk copy of `bytes` (a multiple of 16) from global to shared
// memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes)
{
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group"
                 " [%0], [%1], %2;\n"
                 :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit()
{
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until the committed bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read()
{
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all()
{
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// taps 0 and 1 of output j (see the note at the top); sw: r0 < 0 < r1
__device__ __forceinline__ float first_step(float r0, float r1, float x0,
                                            float x1, bool sw)
{
    return sw ? __fmaf_rn(r1, x1, __fmul_rn(r0, x0))
              : __fmaf_rn(r0, x0, __fmul_rn(r1, x1));
}

// The kPer outputs of one thread; w points at its first input sample.
// NT > 0: the tap count, known at compile time (loop fully unrolled);
// NT == 0: nt at run time.
template <int NOUT, int NT>
__device__ __forceinline__ void fir_thread(const float* w,
                                           const FirTaps& tp, int nt,
                                           bool sw0, bool sw1,
                                           float (&a0)[kPer],
                                           float (&a1)[kPer])
{
    float win[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j)
        win[j] = w[j];
    if (NT == 0 && nt == 1) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
            a0[j] = __fmul_rn(tp.r[0], win[j]);
            if (NOUT == 2)
                a1[j] = __fmul_rn(tp.i[0], win[j]);
        }
        return;
    }
    const float extra = w[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const float x1 = j + 1 < kPer ? win[j + 1] : extra;
        a0[j] = first_step(tp.r[0], tp.r[1], win[j], x1, sw0);
        if (NOUT == 2)
            a1[j] = first_step(tp.i[0], tp.i[1], win[j], x1, sw1);
    }
    if (NT > 0) {
        // ring: w[t + j] lives in win[(t + j) % kPer]; every index below
        // is a compile-time constant, so the ring is register renaming
        win[0] = extra;
#pragma unroll
        for (int t = 2; t < NT; ++t) {
            win[(t - 1) % kPer] = w[t + kPer - 1];
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
                a0[j] = __fmaf_rn(tp.r[t], win[(t + j) % kPer], a0[j]);
                if (NOUT == 2)
                    a1[j] = __fmaf_rn(tp.i[t], win[(t + j) % kPer], a1[j]);
            }
        }
    } else {
        // run-time tap count: the window slides by register moves
#pragma unroll
        for (int j = 0; j < kPer - 1; ++j)
            win[j] = win[j + 1];
        win[kPer - 1] = extra;
        for (int t = 2; t < nt; ++t) {
#pragma unroll
            for (int j = 0; j < kPer - 1; ++j)
                win[j] = win[j + 1];
            win[kPer - 1] = w[t + kPer - 1];
            const float cr = tp.r[t];
            const float ci = NOUT == 2 ? tp.i[t] : 0.0f;
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
                a0[j] = __fmaf_rn(cr, win[j], a0[j]);
                if (NOUT == 2)
                    a1[j] = __fmaf_rn(ci, win[j], a1[j]);
            }
        }
    }
}

// xs0: xs rounded down to 16 bytes; skew: floats from xs0 to xs.
// sw: bit 0, 1 = the first step fuses the second product (real, imag).
template <int NOUT, int NT>
__global__ void __launch_bounds__(kThreads, 3)
stream_fir_kernel(const float* __restrict__ xs0, float* __restrict__ y0,
                  float* __restrict__ y1, long long n, long long ntiles,
                  int nt_rt, int skew, int sw,
                  const __grid_constant__ FirTaps taps)
{
    const int nt = NT > 0 ? NT : nt_rt;
    const int sfl = stage_floats(nt);
    extern __shared__ __align__(128) float smem[];
    float* out_s = smem + kStages * sfl;        // [NOUT][kTile]
    __shared__ __align__(8) uint64_t bars[kStages];
    const int tid = threadIdx.x;
    const long long nxs = skew + n + nt - 1;    // floats from xs0 on

    // thread 0 copies tile `tile` into ring slot s
    auto load = [&](long long tile, int s) {
        const long long a = tile * kTile;
        const long long want = nxs - a < kTile + nt - 1 + skew
                                   ? nxs - a : kTile + nt - 1 + skew;
        const uint32_t bytes = (uint32_t)((want + 3) & ~3LL) * 4u;
        bulk_load(smem + s * sfl, xs0 + a, bytes, &bars[s]);
    };

    if (tid == 0) {
        for (int s = 0; s < kStages; ++s)
            mbar_init(&bars[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int s = 0; s < kStages; ++s) {
            const long long tile = blockIdx.x + (long long)s * gridDim.x;
            if (tile < ntiles)
                load(tile, s);
        }
    }
    __syncthreads();

    const bool sw0 = sw & 1, sw1 = (sw >> 1) & 1;
    for (int it = 0;; ++it) {
        const long long tile = blockIdx.x + (long long)it * gridDim.x;
        if (tile >= ntiles)
            break;
        const int s = it % kStages;
        mbar_wait(&bars[s], (it / kStages) & 1);

        float a0[kPer], a1[kPer];
        fir_thread<NOUT, NT>(smem + s * sfl + skew + tid * kPer, taps, nt,
                             sw0, sw1, a0, a1);

        if (tid == 0)
            bulk_wait_read();          // the last tile's store has left
        __syncthreads();               // slot s and the staging area free
        if (tid == 0) {
            const long long next = tile + (long long)kStages * gridDim.x;
            if (next < ntiles)
                load(next, s);
        }
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
            out_s[tid * kPer + j] = a0[j];
            if (NOUT == 2)
                out_s[kTile + tid * kPer + j] = a1[j];
        }
        // make the staged outputs visible to the bulk copy engine
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();

        const long long k0 = tile * kTile;
        if (k0 + kTile <= n) {
            if (tid == 0) {
                bulk_store(y0 + k0, out_s, kTile * 4);
                if (NOUT == 2)
                    bulk_store(y1 + k0, out_s + kTile, kTile * 4);
                bulk_commit();
            }
        } else {
            // the ragged last tile of the launch (no later tile reuses
            // the staging area)
            const int valid = (int)(n - k0);
            for (int q = tid; q < valid; q += kThreads) {
                y0[k0 + q] = out_s[q];
                if (NOUT == 2)
                    y1[k0 + q] = out_s[kTile + q];
            }
        }
    }
    if (tid == 0)
        bulk_wait_all();
}

// dynamic shared memory per block: the input ring and the staged outputs
constexpr size_t smem_size(int nout, int nt)
{
    return sizeof(float)
        * ((size_t)kStages * stage_floats(nt) + (size_t)nout * kTile);
}

// The persistent grid's size (SMs x resident blocks) of one kernel on one
// device with one tap count.  It is fixed for each, so it is worked out
// once, with the kernel's shared-memory limit raised on the way to what
// any tap count of the kernel needs, and looked up at every later launch.
// Returns a CUDA error code.
template <int NOUT, int NT>
int max_grid(int dev, int nt, long long* grid)
{
    static std::mutex mu;
    static std::map<std::pair<int, int>, long long> known;
    std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_pair(dev, nt);
    const auto it = known.find(key);
    if (it != known.end()) {
        *grid = it->second;
        return 0;
    }
    auto kern = stream_fir_kernel<NOUT, NT>;
    int sms = 0, per_sm = 0;
    cudaError_t err;
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem_size(NOUT, NT > 0 ? NT : kMaxTaps))) != cudaSuccess
        || (err = cudaDeviceGetAttribute(
                &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess
        || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kern, kThreads, smem_size(NOUT, nt)))
            != cudaSuccess)
        return (int)err;
    if (per_sm < 1)
        return (int)cudaErrorInvalidConfiguration;
    *grid = known[key] = (long long)sms * per_sm;
    return 0;
}

template <int NOUT, int NT>
int launch(const float* xs, const FirTaps& taps, float* y0, float* y1,
           long long n, int nt, int sw, cudaStream_t stream)
{
    int dev = 0;
    long long cap = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess)
        return (int)err;
    if (const int e = max_grid<NOUT, NT>(dev, nt, &cap))
        return e;
    const long long ntiles = (n + kTile - 1) / kTile;
    const long long grid = ntiles < cap ? ntiles : cap;
    const float* xs0 = reinterpret_cast<const float*>(
        reinterpret_cast<uintptr_t>(xs) & ~(uintptr_t)15);
    const int skew = (int)(xs - xs0);
    stream_fir_kernel<NOUT, NT>
        <<<(unsigned)grid, kThreads, smem_size(NOUT, nt), stream>>>(
        xs0, y0, y1, n, ntiles, nt, skew, sw, taps);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// taps_r, taps_i: HOST pointers to nt taps each (in filter order, as the
// JAX stream_fir takes them); they are passed to the kernel by value, so
// a launch needs no copy of them to the card.  taps_i == nullptr selects
// the real (one-output) kernel; y1 is then ignored.  xs must be 4-byte
// aligned and y0, y1 16-byte aligned (torch.empty's are).  Returns
// cudaGetLastError() after the launch (0 = success).
int stream_fir_launch(const float* xs, const float* taps_r,
                      const float* taps_i, float* y0, float* y1,
                      long long n, int nt, void* stream)
{
    if (n <= 0)
        return 0;
    if (nt < 1 || nt > kMaxTaps || (reinterpret_cast<uintptr_t>(xs) & 3))
        return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(y0) & 15)
        || (taps_i != nullptr && (reinterpret_cast<uintptr_t>(y1) & 15)))
        return (int)cudaErrorMisalignedAddress;
    if ((n + kTile - 1) / kTile > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    FirTaps taps = {};
    for (int t = 0; t < nt; ++t) {
        taps.r[t] = taps_r[nt - 1 - t];
        if (taps_i != nullptr)
            taps.i[t] = taps_i[nt - 1 - t];
    }
    const int sw = (nt > 1 && taps.r[0] < 0.0f && taps.r[1] > 0.0f ? 1 : 0)
        | (nt > 1 && taps.i[0] < 0.0f && taps.i[1] > 0.0f ? 2 : 0);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (taps_i != nullptr)
        return nt == kFixedTaps
            ? launch<2, kFixedTaps>(xs, taps, y0, y1, n, nt, sw, s)
            : launch<2, 0>(xs, taps, y0, y1, n, nt, sw, s);
    return nt == kFixedTaps
        ? launch<1, kFixedTaps>(xs, taps, y0, nullptr, n, nt, sw, s)
        : launch<1, 0>(xs, taps, y0, nullptr, n, nt, sw, s);
}

// What a launch with this complex flag and tap count runs with:
// registers per thread, dynamic shared memory per block and resident
// blocks per SM on the current device.  Returns a CUDA error code.
int stream_fir_config(int is_complex, int nt, int* regs, int* smem_bytes,
                      int* blocks_per_sm)
{
    if (nt < 1 || nt > kMaxTaps)
        return (int)cudaErrorInvalidValue;
    const void* kern = is_complex
        ? (nt == kFixedTaps ? (const void*)stream_fir_kernel<2, kFixedTaps>
                            : (const void*)stream_fir_kernel<2, 0>)
        : (nt == kFixedTaps ? (const void*)stream_fir_kernel<1, kFixedTaps>
                            : (const void*)stream_fir_kernel<1, 0>);
    const size_t smem = smem_size(is_complex ? 2 : 1, nt);
    int dev = 0;
    long long grid = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess)
        return (int)err;
    // sets the kernel's shared-memory limit, as a launch does
    const int e = is_complex
        ? (nt == kFixedTaps ? max_grid<2, kFixedTaps>(dev, nt, &grid)
                            : max_grid<2, 0>(dev, nt, &grid))
        : (nt == kFixedTaps ? max_grid<1, kFixedTaps>(dev, nt, &grid)
                            : max_grid<1, 0>(dev, nt, &grid));
    if (e)
        return e;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kern);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks_per_sm, kern, kThreads, smem);
    if (err != cudaSuccess)
        return (int)err;
    *regs = attr.numRegs;
    *smem_bytes = (int)smem;
    return 0;
}

}  // extern "C"
