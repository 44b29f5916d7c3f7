// SECAM's chroma program and line render, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs this program as XLA ops
// inside its compiled step (hacktv_tpu/video/secam.py
// `device_chroma_carrier`, `render`), and so did the port, as some 300
// elementwise torch ops a block (hacktv_tpu_torch/video/secam.py, which
// keeps them as the plain version).  Those ops moved ~30 GB a 16-frame
// block through device memory, most of it f32 <-> f64 casts, for a result
// of 41 MB.  Here each row of a window runs the whole program with the row
// in shared memory, and the block is read once and written once:
//
//   - the vertical average of the U or V plane's rows (trunc), or the
//     static field-identification row;
//   - the Q15 chroma low-pass, exact in int32 (wrapping as torch's int32);
//   - the HF pre-emphasis IIR as the plain version's doubling scan, step
//     by step with the same shifts, factors and roundings, then the
//     carried z of the previous active row (iir_prev) or of the block;
//   - the clamps and lround, the int32 prefix sum S of the chroma;
//   - the closed-form carrier phase, glibc's sinf/cosf (its fast
//     reduction below 120 rad, reduce_large above), the bell, the burst
//     window;
//   - with `luma`, render's 51-tap luma band-reject over the active
//     segment (int64 sums, exact as the plain version's f64 conv1d);
//     then the carrier added to the row.
//
// Every f32 and f64 operation is the explicit intrinsic of the plain
// version's torch op (nvcc contracts a*b + c otherwise).  synth.fma32 is
// an f64 product of two f32 values, exact, plus an f64 add, rounded to
// f32: written so here, never as __fmaf_rn, which rounds once and differs
// from it about 2^-29 of the time.
//
// A row's IIR starts from the end state of another row, which that row's
// scan gives before its carry; so two launches: pass 0 scans every row
// and writes its end state z_end[row], pass 1 runs the whole program.
// Both launch one block a row on the caller's stream, without a sync, so a
// CUDA graph captures them.
//
// What bounds it on an H100: the bytes are the block in and out (82 MB at
// 16 frames, 25 us at 3.35 TB/s) plus the U/V rows (from L2); the f64
// work (the scan's ten steps and sinf/cosf, ~1 GFLOP a block) is tens of
// us on the f64 pipes, and each fma32 adds three f32<->f64 conversions,
// which run at a quarter of that rate.  A row is some 30 barriers of
// latency over its two passes, so the design keeps rows resident side by
// side (256 threads, at most 64 registers, ~25 KB of shared memory a
// row) for the card's SMs to overlap them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChromaTaps = 15;
constexpr int kLumaTaps = 51;
constexpr int kMaxSteps = 16;
constexpr int kCH = kChromaTaps / 2;     // halo of the chroma FIR
constexpr int kLH = kLumaTaps / 2;       // halo of the luma band-reject

// the order of the host's arrays (video/secam.py `kernel_consts`)
enum FConst {
    F_U_BLACK, F_V_BLACK, F_DMIN0, F_DMIN1, F_DMAX0, F_DMAX1, F_B0, F_C1,
    F_KD, F_LVL, F_KDEV, F_FM_FREQ, F_INV_F0, F_F0, F_K126, F_DEN_NUM,
    F_HPI_INV, F_HPI_HI, F_HPI_LO, F_PI63, F_SC_C, F_SC_S = F_SC_C + 5,
    F_RR = F_SC_S + 3, F_COUNT = F_RR + kMaxSteps
};
enum IConst {
    I_W, I_H, I_FW, I_COL0, I_ACTIVE_LEFT, I_ACTIVE_END, I_HALF_WIDTH,
    I_SL, I_BURST_END, I_NSTEPS, I_SHIFT, I_CHROMA = I_SHIFT + kMaxSteps,
    I_LUMA = I_CHROMA + kChromaTaps, I_PIO4 = I_LUMA + kLumaTaps,
    I_COUNT = I_PIO4 + 24
};
enum Ptr {
    P_U, P_V, P_FID, P_R_POW, P_W0_COL, P_WIN_COL, P_DR, P_ACTIVE, P_VALID,
    P_HALF_ONLY, P_VY, P_VY_PREV, P_PREV_HAS, P_PHASE_POS, P_FIELD_ID,
    P_IIR_PREV, P_Z_PREV, P_BLK, P_OUT, P_Z_END, P_COUNT
};

struct Params {
    int B, W, H, fw, col0, active_left, active_end, half_width, sl,
        burst_end, nsteps, luma;
    int shift[kMaxSteps];
    float rr[kMaxSteps];
    int chroma_r[kChromaTaps];      // taps in accumulation order (reversed)
    int luma_r[kLumaTaps];
    float u_black, v_black, dmin[2], dmax[2], b0, c1, kd, lvl, k_dev,
        fm_freq, inv_f0, f0, k126, den_num;
    double hpi_inv, hpi_hi, hpi_lo, pi63, sc_c[5], sc_s[3];
    unsigned long long inv_pio4[24];
};

struct Ptrs {
    const float *u, *v, *fid, *r_pow, *w0_col, *win_col, *dr, *active,
        *valid, *half_only;
    const int *vy, *vy_prev;
    const float *prev_has, *phase_pos;
    const uint8_t* field_id;
    const int* iir_prev;
    const float *z_prev, *blk;
    float* out;
    float* z_end;
};

// synth.fma32: a*b + c with the exact f64 product, one f64 add, then f32
__device__ __forceinline__ float fma32(float a, float b, float c)
{
    return __double2float_rn(
        __dadd_rn((double)c, __dmul_rn((double)a, (double)b)));
}

// torch's lround of the plain version: floor(a + 0.5), or -floor(0.5 - a)
__device__ __forceinline__ float lround32(float a)
{
    return a >= 0.0f ? floorf(__fadd_rn(a, 0.5f))
                     : -floorf(__fsub_rn(0.5f, a));
}

// glibc's reduce_large (synth._reduce_large): x = n*pi/2 + r, |x| >= 120
__device__ void reduce_large(const Params& p, float x, int* n_out,
                             double* r_out)
{
    const unsigned long long M32 = 0xFFFFFFFFull;
    const uint32_t xi = __float_as_uint(x);
    const int j = (xi >> 26) & 15;
    const unsigned long long m =
        (unsigned long long)((xi & 0xFFFFFFu) | 0x800000u) << ((xi >> 23) & 7);
    const unsigned long long res0 = (m * p.inv_pio4[j]) & M32;
    const unsigned long long res1 = m * p.inv_pio4[j + 4];
    const unsigned long long res2 = m * p.inv_pio4[j + 8];
    unsigned long long lo = (res2 >> 32) + (res1 & M32);
    unsigned long long hi = (res0 + (res1 >> 32) + (lo >> 32)) & M32;
    lo &= M32;
    const unsigned long long n = ((hi + (1ull << 29)) & M32) >> 30;
    hi = (hi - (n << 30)) & M32;
    const long long his = hi >= (1ull << 31) ? (long long)hi - (1ll << 32)
                                             : (long long)hi;
    double r = __dmul_rn(__ll2double_rn(his * (1ll << 32) + (long long)lo),
                         p.pi63);
    int ni = (int)n;
    if (x < 0.0f) {
        ni = -ni;
        r = -r;
    }
    *n_out = ni;
    *r_out = r;
}

// synth._sincosf_glibc at one f32 value
__device__ void sincosf_glibc(const Params& p, float x, float* sin_out,
                              float* cos_out)
{
    int n;
    double r;
    if (fabsf(x) < 120.0f) {
        const double xd = (double)x;
        n = (__double2int_rz(__dmul_rn(xd, p.hpi_inv)) + 0x800000) >> 24;
        const double nd = (double)n;
        r = __dsub_rn(__dsub_rn(xd, __dmul_rn(nd, p.hpi_hi)),
                      __dmul_rn(nd, p.hpi_lo));
    } else {
        reduce_large(p, x, &n, &r);
    }
    const double r2 = __dmul_rn(r, r);
    const double r3 = __dmul_rn(r2, r);
    double s = __dadd_rn(__dmul_rn(r3, p.sc_s[0]), r);
    s = __dadd_rn(__dmul_rn(__dmul_rn(r3, r2),
                            __dadd_rn(__dmul_rn(r2, p.sc_s[2]), p.sc_s[1])),
                  s);
    const double r4 = __dmul_rn(r2, r2);
    double c = __dadd_rn(__dmul_rn(r4, p.sc_c[2]),
                         __dadd_rn(__dmul_rn(r2, p.sc_c[1]), p.sc_c[0]));
    c = __dadd_rn(__dmul_rn(__dmul_rn(r4, r2),
                            __dadd_rn(__dmul_rn(r2, p.sc_c[4]), p.sc_c[3])),
                  c);
    const float sf = __double2float_rn(s), cf = __double2float_rn(c);
    // quadrant n & 3: sin = (S, C, -S, -C), cos = (C, -S, -C, S)
    float sn = (n & 1) ? cf : sf;
    float cs = (n & 1) ? sf : cf;
    if (n & 2)
        sn = -sn;
    if ((n + 1) & 2)
        cs = -cs;
    *sin_out = sn;
    *cos_out = cs;
}

// inclusive prefix sum of a[0, W) in place, mod 2^32 as torch's int32
// cumsum; every thread calls it between barriers
__device__ void block_cumsum(int* a, int W, int* wsum)
{
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int per = (W + kThreads - 1) / kThreads;
    const int beg = min(tid * per, W), end = min(beg + per, W);
    uint32_t sum = 0;
    for (int i = beg; i < end; ++i) {
        sum += (uint32_t)a[i];
        a[i] = (int)sum;
    }
    uint32_t incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const uint32_t v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o)
            incl += v;
    }
    if (lane == 31)
        wsum[warp] = (int)incl;
    __syncthreads();
    if (warp == 0) {
        uint32_t w = lane < kThreads / 32 ? (uint32_t)wsum[lane] : 0u;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const uint32_t v = __shfl_up_sync(0xFFFFFFFFu, w, o);
            if (lane >= o)
                w += v;
        }
        if (lane < kThreads / 32)
            wsum[lane] = (int)w;
    }
    __syncthreads();
    const uint32_t off = incl - sum + (warp > 0 ? (uint32_t)wsum[warp - 1]
                                                : 0u);
    for (int i = beg; i < end; ++i)
        a[i] = (int)((uint32_t)a[i] + off);
}

// 32-bit words of shared memory a row takes
__host__ __device__ constexpr int smem_words(int W, bool full)
{
    // li (FIR input with halos, later S), z0, z1; full: x, luma input
    // with halos, the row of the block
    return (W + 2 * kCH) + 2 * W + (full ? W + (W + 2 * kLH) + W : 0);
}

// FULL = false: pass 0, z_end of every row; true: pass 1, the program
template <bool FULL>
__global__ void __launch_bounds__(kThreads, 4)
secam_chroma_kernel(const __grid_constant__ Params p, const Ptrs q)
{
    extern __shared__ __align__(16) int smem[];
    __shared__ int wsum[kThreads / 32];
    const int W = p.W;
    const int j = blockIdx.x;
    const int tid = threadIdx.x;
    int* li = smem;                                  // [W + 2 kCH]
    float* z0 = reinterpret_cast<float*>(li + W + 2 * kCH);
    float* z1 = z0 + W;
    float* xs = z1 + W;                              // FULL only
    int* lm = reinterpret_cast<int*>(xs + W);        // [W + 2 kLH]
    float* bf = reinterpret_cast<float*>(lm + W + 2 * kLH);

    // ---- the row's chroma line, and the block's row ---------------------
    const bool dr = q.dr[j] > 0.0f;
    const float* plane = dr ? q.v : q.u;
    const float black = dr ? p.v_black : p.u_black;
    const bool fid = q.field_id[j] != 0;
    const int vy = q.vy[j], vyp = q.vy_prev[j];
    const bool cur_in = vy >= 0 && vy < p.H, prv_in = vyp >= 0 && vyp < p.H;
    const float prev_has = q.prev_has[j];
    const int fwe = min(p.fw, W - p.col0);
    const float* blk = q.blk + (size_t)j * W;
    for (int c = tid; c < W; c += kThreads) {
        float val;
        if (fid) {
            val = q.fid[(dr ? W : 0) + c];
        } else if (c >= p.col0 && c < p.col0 + fwe) {
            const int x = c - p.col0;
            const float cur = cur_in ? plane[(size_t)vy * p.fw + x] : black;
            const float prv = __fmul_rn(
                prv_in ? plane[(size_t)vyp * p.fw + x] : black, prev_has);
            const float avg = truncf(__fmul_rn(__fadd_rn(cur, prv), 0.5f));
            val = __fadd_rn(__fsub_rn(avg, black), black);
        } else {
            val = __fadd_rn(0.0f, black);
        }
        li[kCH + c] = __float2int_rz(val);
        if (FULL) {
            const float b = blk[c];
            bf[c] = b;
            if (p.luma)
                lm[kLH + c] = c >= p.active_left ? __float2int_rz(b) : 0;
        }
    }
    if (tid < kCH) {
        li[tid] = 0;
        li[kCH + W + tid] = 0;
    }
    if (FULL && p.luma && tid < kLH) {
        lm[tid] = 0;
        lm[kLH + W + tid] = 0;
    }
    __syncthreads();

    // ---- chroma low-pass, Q15 in int32 ----------------------------------
    for (int c = tid; c < W; c += kThreads) {
        uint32_t acc = 0;
#pragma unroll
        for (int t = 0; t < kChromaTaps; ++t)
            acc += (uint32_t)p.chroma_r[t] * (uint32_t)li[c + t];
        const int a = min(max((int)acc >> 15, -32768), 32767);
        const float x = (float)a;
        z0[c] = x;
        if (FULL)
            xs[c] = x;
    }

    // ---- the IIR's doubling scan ----------------------------------------
    float* za = z0;
    float* zb = z1;
    for (int k = 0; k < p.nsteps; ++k) {
        __syncthreads();
        const int sh = p.shift[k];
        const float rr = p.rr[k];
        for (int c = tid; c < W; c += kThreads)
            zb[c] = fma32(c >= sh ? za[c - sh] : 0.0f, rr, za[c]);
        float* t = za;
        za = zb;
        zb = t;
    }
    __syncthreads();
    if (!FULL) {
        if (tid == 0)
            q.z_end[j] = za[W - 1];
        return;
    }

    // ---- the carry, y = b0 x + c1 z[n-1], the clamps ---------------------
    const int ip = q.iir_prev[j];
    const float zp = ip >= 0 ? q.z_end[min(max(ip, 0), p.B - 1)] : *q.z_prev;
    for (int c = tid; c < W; c += kThreads)
        zb[c] = fma32(q.r_pow[c], zp, za[c]);
    __syncthreads();
    const float dmin = p.dmin[dr], dmax = p.dmax[dr];
    for (int c = tid; c < W; c += kThreads) {
        const float znm1 = c == 0 ? zp : zb[c - 1];
        float y = fma32(xs[c], p.b0, __fmul_rn(znm1, p.c1));
        y = lround32(fminf(fmaxf(y, -32768.0f), 32767.0f));
        const float cl = fminf(fmaxf(y, dmin), dmax);
        za[c] = cl;
        li[c] = c >= p.sl ? __float2int_rz(cl) : 0;
    }
    __syncthreads();
    block_cumsum(li, W, wsum);
    __syncthreads();

    // ---- FM carrier, bell, window; the luma band-reject; the sum ---------
    const bool act = q.active[j] > 0.0f && q.valid[j] > 0.0f;
    const int sr = act ? (q.half_only[j] > 0.0f ? p.half_width : p.burst_end)
                       : 0;
    const float sgn = q.phase_pos[j] > 0.0f ? 1.0f : -1.0f;
    const bool seg_row = p.luma && q.active[j] > 0.0f;
    const float inv15 = 1.0f / 32768.0f;
    float* out = q.out + (size_t)j * W;
    for (int c = tid; c < W; c += kThreads) {
        float add = 0.0f;
        if (c >= p.sl && c < sr) {
            const float phase = fma32((float)li[c], p.kd, q.w0_col[c]);
            float sn, cs;
            sincosf_glibc(p, phase, &sn, &cs);
            const float pi_ = fminf(
                floorf(__fmul_rn(__fmul_rn(sgn, cs), 32768.0f)), 32767.0f);
            const float pq_ = fminf(
                floorf(__fmul_rn(__fmul_rn(sgn, sn), 32768.0f)), 32767.0f);
            const float vi = floorf(__fmul_rn(pi_, p.lvl));
            const float vq = floorf(__fmul_rn(pq_, p.lvl));
            const float f = fma32(za[c], p.k_dev, p.fm_freq);
            const float ff = fma32(f, p.inv_f0, -__fdiv_rn(p.f0, f));
            const float rq = __fmul_rn(ff, p.k126);
            const float den = __fdiv_rn(p.den_num, fma32(rq, rq, 1.0f));
            const float ff16 = __fmul_rn(ff, 16.0f);
            const float gi = lround32(__fmul_rn(fma32(ff16, rq, 1.0f), den));
            const float gq = lround32(__fmul_rn(__fsub_rn(ff16, rq), den));
            const float m = __fsub_rn(
                floorf(__fmul_rn(__fmul_rn(vi, gi), inv15)),
                floorf(__fmul_rn(__fmul_rn(vq, gq), inv15)));
            add = floorf(__fmul_rn(__fmul_rn(m, q.win_col[c]), inv15));
        }
        float base = bf[c];
        if (seg_row && c >= p.active_left && c < p.active_end) {
            long long acc = 0;
#pragma unroll
            for (int t = 0; t < kLumaTaps; ++t)
                acc += (long long)p.luma_r[t] * lm[c + t];
            acc >>= 15;
            base = (float)(acc < -32768 ? -32768 : acc > 32767 ? 32767 : acc);
        }
        out[c] = __fadd_rn(base, add);
    }
}

int g_smem_set[2] = {48 * 1024, 48 * 1024};   // dynamic smem allowed so far

template <bool FULL>
int launch_pass(const Params& p, const Ptrs& q, cudaStream_t stream)
{
    const size_t smem = sizeof(int) * (size_t)smem_words(p.W, FULL);
    int& allowed = g_smem_set[FULL];
    if ((int)smem > allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            secam_chroma_kernel<FULL>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess)
            return (int)err;
        allowed = (int)smem;
    }
    secam_chroma_kernel<FULL><<<p.B, kThreads, smem, stream>>>(p, q);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs: P_COUNT device pointers (enum Ptr); fc: F_COUNT doubles (enum
// FConst; f32 constants exactly), ic: I_COUNT integers (enum IConst), all
// HOST arrays, copied into the launches' parameters.  B rows of width
// ic[I_W]; luma: fuse render's band-reject.  Returns a CUDA error code
// (0 = success); refuses counts that differ from this file's.
int secam_chroma_launch(const void* const* ptrs, int nptrs, const double* fc,
                        int nfc, const long long* ic, int nic, long long B,
                        int luma, void* stream)
{
    if (nptrs != P_COUNT || nfc != F_COUNT || nic != I_COUNT)
        return (int)cudaErrorInvalidValue;
    if (B <= 0)
        return 0;
    Params p = {};
    p.B = (int)B;
    p.W = (int)ic[I_W];
    p.H = (int)ic[I_H];
    p.fw = (int)ic[I_FW];
    p.col0 = (int)ic[I_COL0];
    p.active_left = (int)ic[I_ACTIVE_LEFT];
    p.active_end = (int)ic[I_ACTIVE_END];
    p.half_width = (int)ic[I_HALF_WIDTH];
    p.sl = (int)ic[I_SL];
    p.burst_end = (int)ic[I_BURST_END];
    p.nsteps = (int)ic[I_NSTEPS];
    p.luma = luma != 0;
    if (B > 0x7fffffffLL || p.W <= 0 || p.nsteps < 0 || p.nsteps > kMaxSteps
        || p.col0 < 0 || p.col0 > p.W)
        return (int)cudaErrorInvalidValue;
    for (int k = 0; k < kMaxSteps; ++k) {
        p.shift[k] = (int)ic[I_SHIFT + k];
        p.rr[k] = (float)fc[F_RR + k];
    }
    for (int t = 0; t < kChromaTaps; ++t)
        p.chroma_r[t] = (int)ic[I_CHROMA + t];
    for (int t = 0; t < kLumaTaps; ++t)
        p.luma_r[t] = (int)ic[I_LUMA + t];
    for (int t = 0; t < 24; ++t)
        p.inv_pio4[t] = (unsigned long long)ic[I_PIO4 + t];
    p.u_black = (float)fc[F_U_BLACK];
    p.v_black = (float)fc[F_V_BLACK];
    p.dmin[0] = (float)fc[F_DMIN0];
    p.dmin[1] = (float)fc[F_DMIN1];
    p.dmax[0] = (float)fc[F_DMAX0];
    p.dmax[1] = (float)fc[F_DMAX1];
    p.b0 = (float)fc[F_B0];
    p.c1 = (float)fc[F_C1];
    p.kd = (float)fc[F_KD];
    p.lvl = (float)fc[F_LVL];
    p.k_dev = (float)fc[F_KDEV];
    p.fm_freq = (float)fc[F_FM_FREQ];
    p.inv_f0 = (float)fc[F_INV_F0];
    p.f0 = (float)fc[F_F0];
    p.k126 = (float)fc[F_K126];
    p.den_num = (float)fc[F_DEN_NUM];
    p.hpi_inv = fc[F_HPI_INV];
    p.hpi_hi = fc[F_HPI_HI];
    p.hpi_lo = fc[F_HPI_LO];
    p.pi63 = fc[F_PI63];
    for (int t = 0; t < 5; ++t)
        p.sc_c[t] = fc[F_SC_C + t];
    for (int t = 0; t < 3; ++t)
        p.sc_s[t] = fc[F_SC_S + t];

    Ptrs q;
    q.u = static_cast<const float*>(ptrs[P_U]);
    q.v = static_cast<const float*>(ptrs[P_V]);
    q.fid = static_cast<const float*>(ptrs[P_FID]);
    q.r_pow = static_cast<const float*>(ptrs[P_R_POW]);
    q.w0_col = static_cast<const float*>(ptrs[P_W0_COL]);
    q.win_col = static_cast<const float*>(ptrs[P_WIN_COL]);
    q.dr = static_cast<const float*>(ptrs[P_DR]);
    q.active = static_cast<const float*>(ptrs[P_ACTIVE]);
    q.valid = static_cast<const float*>(ptrs[P_VALID]);
    q.half_only = static_cast<const float*>(ptrs[P_HALF_ONLY]);
    q.vy = static_cast<const int*>(ptrs[P_VY]);
    q.vy_prev = static_cast<const int*>(ptrs[P_VY_PREV]);
    q.prev_has = static_cast<const float*>(ptrs[P_PREV_HAS]);
    q.phase_pos = static_cast<const float*>(ptrs[P_PHASE_POS]);
    q.field_id = static_cast<const uint8_t*>(ptrs[P_FIELD_ID]);
    q.iir_prev = static_cast<const int*>(ptrs[P_IIR_PREV]);
    q.z_prev = static_cast<const float*>(ptrs[P_Z_PREV]);
    q.blk = static_cast<const float*>(ptrs[P_BLK]);
    q.out = static_cast<float*>(const_cast<void*>(ptrs[P_OUT]));
    q.z_end = static_cast<float*>(const_cast<void*>(ptrs[P_Z_END]));

    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (const int e = launch_pass<false>(p, q, s))
        return e;
    return launch_pass<true>(p, q, s);
}

}  // extern "C"
