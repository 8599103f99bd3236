// Persistent 2/4-FSK demodulator frame loop for Hopper (sm_90a).
//
// Replaces the per-frame scan body of wenet_tpu/ops/fsk.py::demod_stream
// (:570-617, with _demod_frame :344 and _freq_est_step :297), which the JAX
// package ran as an XLA lax.scan rather than a Pallas kernel, and the port's
// Python frame loop (ops/fsk.demod_stream_reference, one launch-heavy step a
// frame).  Its plain version is that loop; the wrapper is
// kernels/fsk_demod.py.
//
// Design: one block of 256 threads per lane (a capture, a chunk of a fused
// slab, a trial of a sweep, an offset of the acquisition search).  The block
// walks its lane's frames in order with the whole DemodState in shared
// memory: per frame it loads the Nmem-sample window straight from the raw
// buffer (cu8, cs16 or float32 pairs, converted in the load), runs the tone
// DFT over the estimator blocks, the EMA and the first-max peak picks, the
// phase-continuous downconvert, the integrate-and-dump window sums, the
// timing line (in float64), the elastic nin and the symbol decisions, and
// writes the frame's outputs.  Samples before the lane's start or past
// n_total read as 0.0.  The first frame with pos + nin > n_valid ends the
// lane (the state is frozen there, so every later frame is invalid too):
// the rest of its frames are written invalid with zeroed fields.
//
// Bound: per frame a lane reads about Nmem samples and writes Nbits soft
// bits, Nbits hard bits and a few stats, a few kB; the work is about
// 2 * 4 * Ndft/2 * Ndft float32 operations for the DFT plus a few thousand
// for the rest, so at one lane per SM the frame loop is latency-bound: each
// frame is a chain of about ten dependent phases separated by barriers.
//
// Numerics follow the plain version operation by operation.  The build
// passes -fmad=false, so every a*b + c below rounds twice, as torch's eager
// ops do; the places where the plain version rounds a*b + c once (ops/fsk
// _fma) use fma1, which forms it in float64.  The DFT reads the exact
// float64-built cos/sin table of utils/compat._dft_matrix.  cosf/sinf (not
// the __cosf intrinsics) take angles up to ~1500 rad.  Every argmax keeps
// the first maximum.  Sums run in another order than torch's (DFT, window
// sums, means), so soft bits agree to a few float32 ulps, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_M 4

struct DemodGeom {
    long long n_total;           // samples in the raw buffer
    int lanes, num_frames, fmt;  // fmt: 0 float32 pairs, 1 cu8, 2 cs16
    int Ts, P, S, M, Nsym, Nmem, N, Ndft, half, NP, Nbits;
    int f_min_bin, f_max_bin, f_zero_bins;
    float tc, one_m_tc, bin_hz, inv_fs, two_pi, two_pi_fs, cs16_scale;
    float half_pi, pi;
    float atan_c[9];
};

struct DemodPtrs {
    const void* data;
    const long long* starts;
    const long long* n_valid;
    const float* hann;      // (Ndft,)
    const float* dft;       // (2 Ndft, 2 half): rows i < Ndft are [C | S]
    const float* spin_re;   // (NP,)
    const float* spin_im;
    const int* pos_in;
    const int* nin_in;
    const float* fft_in;    // (lanes, half)
    const float* fest_in;   // (lanes, M)
    const float* phi_in;    // (lanes, M)
    const float* norm_in;
    const float* ppm_in;
    const float* ebno_in;
    const float* snr_in;
    int* pos_out;
    int* nin_out;
    float* fft_out;
    float* fest_out;
    float* phi_out;
    float* norm_out;
    float* ppm_out;
    float* ebno_out;
    float* snr_out;
    float* soft;            // (lanes, frames, Nbits)
    uint8_t* bits;          // (lanes, frames, Nbits)
    uint8_t* valid;         // (lanes, frames)
    float* o_fest;          // (lanes, frames, M)
    float* o_ebno;          // (lanes, frames)
    float* o_norm;
    float* o_ppm;
    int* o_nin;
};

// threads that share one DFT bin (each sums a slice of the samples)
__host__ __device__ static inline int dft_groups(int half) {
    return half >= THREADS ? 1 : THREADS / half;
}

__host__ __device__ static inline size_t smem_floats(const DemodGeom& g) {
    return 2 * (size_t)g.Nmem + 2 * (size_t)g.M * g.Nmem
           + 2 * (size_t)g.M * g.NP + 2 * (size_t)g.half
           + 2 * (size_t)dft_groups(g.half) * g.half + g.Nsym;
}

static size_t smem_bytes(const DemodGeom& g) {
    return 2 * 32 * sizeof(double) + smem_floats(g) * sizeof(float);
}

// a*b + c rounded once to float32 (ops/fsk._fma: the float64 product is
// exact, the float64 sum is rounded, then the float32 result)
__device__ __forceinline__ float fma1(float a, float b, float c) {
    return __double2float_rn(
        __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

__device__ __forceinline__ void load_sample(const DemodGeom& g,
                                            const void* data, long long i,
                                            float& re, float& im) {
    if (g.fmt == 1) {
        const uint8_t* d = (const uint8_t*)data;
        re = ((float)d[2 * i] - 127.0f) * 0.0078125f;
        im = ((float)d[2 * i + 1] - 127.0f) * 0.0078125f;
    } else if (g.fmt == 2) {
        const int16_t* d = (const int16_t*)data;
        re = (float)d[2 * i] * g.cs16_scale;
        im = (float)d[2 * i + 1] * g.cs16_scale;
    } else {
        const float2 v = ((const float2*)data)[i];
        re = v.x;
        im = v.y;
    }
}

// utils/compat.atan2: the odd polynomial atan, float32 throughout
__device__ float atan2_poly(const DemodGeom& g, float y, float x) {
    const float ax = fabsf(x), ay = fabsf(y);
    const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
    const float t = lo / (hi > 0.0f ? hi : 1.0f);
    const float s = t * t;
    float p = g.atan_c[8];
    for (int k = 7; k >= 0; --k) p = p * s + g.atan_c[k];
    float r = t * p;
    if (ay > ax) r = g.half_pi - r;
    if (x < 0.0f) r = g.pi - r;
    if (y < 0.0f) r = -r;
    return hi > 0.0f ? r : 0.0f;
}

// first maximum of v[0..n) over one warp: (value, index), lowest index on
// ties; every lane returns the result
__device__ void warp_argmax(const float* v, int n, float& best, int& arg) {
    const int lane = threadIdx.x & 31;
    float b = -INFINITY;
    int a = 0x7fffffff;
    for (int k = lane; k < n; k += 32) {
        if (v[k] > b) { b = v[k]; a = k; }
    }
    for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, b, off);
        const int oa = __shfl_xor_sync(0xffffffffu, a, off);
        if (ob > b || (ob == b && oa < a)) { b = ob; a = oa; }
    }
    best = b;
    arg = a == 0x7fffffff ? 0 : a;
}

// sum over the block of two doubles; thread 0 gets the totals
__device__ void block_sum2(double& a, double& b, double* red) {
    for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_down_sync(0xffffffffu, a, off);
        b += __shfl_down_sync(0xffffffffu, b, off);
    }
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) { red[w] = a; red[32 + w] = b; }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int k = 1; k < THREADS / 32; ++k) {
            a += red[k];
            b += red[32 + k];
        }
    }
}

extern "C" __global__ void __launch_bounds__(THREADS)
fsk_demod_kernel(const DemodGeom g, const DemodPtrs p) {
    extern __shared__ double smem_d[];
    double* red = smem_d;                        // 2 x 32 doubles
    float* s_re = (float*)(smem_d + 64);         // Nmem: the frame's window
    float* s_im = s_re + g.Nmem;
    float* d_re = s_im + g.Nmem;                 // M x Nmem: downconverted
    float* d_im = d_re + g.M * g.Nmem;
    float* fi_re = d_im + g.M * g.Nmem;          // M x NP: integrators
    float* fi_im = fi_re + g.M * g.NP;
    float* fft = fi_im + g.M * g.NP;             // half: EMA of the spectrum
    float* work = fft + g.half;                  // half: peak-pick copy
    const int G = dft_groups(g.half);
    float* part = work + g.half;                 // 2 x G x half DFT partials
    float* winb = part + 2 * G * g.half;         // Nsym winning |tone|^2

    __shared__ float st_fest[MAX_M], st_phi[MAX_M];
    __shared__ float f_new[MAX_M], latched[MAX_M], theta0[MAX_M],
        phi_next[MAX_M];
    __shared__ float st_norm, st_ppm, st_ebno, st_snr;
    __shared__ float sh_norm, sh_ppm, sh_low, sh_fract, sh_high;
    __shared__ int st_pos, st_nin, sh_nin_next;

    const int lane = blockIdx.x, tid = threadIdx.x;
    const int M = g.M, Nmem = g.Nmem, half = g.half, Ndft = g.Ndft;
    const long long start = p.starts[lane], nvalid = p.n_valid[lane];

    for (int k = tid; k < half; k += THREADS)
        fft[k] = p.fft_in[lane * half + k];
    if (tid < M) {
        st_fest[tid] = p.fest_in[lane * M + tid];
        st_phi[tid] = p.phi_in[lane * M + tid];
    }
    if (tid == 0) {
        st_pos = p.pos_in[lane];
        st_nin = p.nin_in[lane];
        st_norm = p.norm_in[lane];
        st_ppm = p.ppm_in[lane];
        st_ebno = p.ebno_in[lane];
        st_snr = p.snr_in[lane];
    }
    __syncthreads();

    int f = 0;
    for (; f < g.num_frames; ++f) {
        const int pos = st_pos, nin = st_nin;
        if ((long long)pos + nin > nvalid) break;     // block-uniform
        const int nold = Nmem - nin;
        const long long frame = (long long)lane * g.num_frames + f;

        // 1. the window: lane samples pos + nin - Nmem .. pos + nin - 1
        const long long base = (long long)pos + nin - Nmem;
        for (int t = tid; t < Nmem; t += THREADS) {
            const long long li = base + t, gi = start + li;
            float re = 0.0f, im = 0.0f;
            if (li >= 0 && li < nvalid && gi >= 0 && gi < g.n_total)
                load_sample(g, p.data, gi, re, im);
            s_re[t] = re;
            s_im[t] = im;
        }
        __syncthreads();

        // 2. tone estimator: per used Ndft block, Hann window (over the
        // first nin - (j+1) Ndft samples: fsk.c's quirk), DFT, band-masked
        // magnitude, EMA.  Unwindowed samples add exact zeros, so they are
        // skipped.
        const int n_blocks = nin / Ndft;
        for (int j = 0; j < n_blocks; ++j) {
            const int fs = min(max(nin - (j + 1) * Ndft, 0), Ndft);
            const float* xr = s_re + nold + j * Ndft;
            const float* xi = s_im + nold + j * Ndft;
            if (G > 1) {
                const int k = tid % half, grp = tid / half;
                if (grp < G) {
                    const int span = (fs + G - 1) / G;
                    const int i0 = grp * span, i1 = min(fs, i0 + span);
                    float re = 0.0f, im = 0.0f;
                    for (int i = i0; i < i1; ++i) {
                        const float w = p.hann[i];
                        const float a = xr[i] * w, b = xi[i] * w;
                        const float c = p.dft[i * 2 * half + k];
                        const float s = p.dft[i * 2 * half + half + k];
                        re = re + (a * c - b * s);
                        im = im + (a * s + b * c);
                    }
                    part[grp * half + k] = re;
                    part[(G + grp) * half + k] = im;
                }
            } else {
                for (int k = tid; k < half; k += THREADS) {
                    float re = 0.0f, im = 0.0f;
                    for (int i = 0; i < fs; ++i) {
                        const float w = p.hann[i];
                        const float a = xr[i] * w, b = xi[i] * w;
                        const float c = p.dft[i * 2 * half + k];
                        const float s = p.dft[i * 2 * half + half + k];
                        re = re + (a * c - b * s);
                        im = im + (a * s + b * c);
                    }
                    part[k] = re;
                    part[half + k] = im;
                }
            }
            __syncthreads();
            for (int k = tid; k < half; k += THREADS) {
                float re = part[k], im = part[G * half + k];
                for (int grp = 1; grp < G; ++grp) {
                    re = re + part[grp * half + k];
                    im = im + part[(G + grp) * half + k];
                }
                const bool band = k >= g.f_min_bin && k < g.f_max_bin - 1;
                const float mag = sqrtf(band ? re * re + im * im : 0.0f);
                fft[k] = fft[k] * g.one_m_tc + mag * g.tc;
            }
            __syncthreads();
        }

        // 3. M first-max peak picks with +/- f_zero_bins blanking, sorted
        // ascending; latch; carrier phases (one warp)
        if (tid < 32) {
            for (int k = tid; k < half; k += 32) work[k] = fft[k];
            __syncwarp();
            int peaks[MAX_M];
            for (int r = 0; r < M; ++r) {
                float best;
                int imax;
                warp_argmax(work, half, best, imax);
                peaks[r] = imax;
                __syncwarp();
                for (int k = tid; k < half; k += 32)
                    if (k >= imax - g.f_zero_bins && k < imax + g.f_zero_bins)
                        work[k] = 0.0f;
                __syncwarp();
            }
            if (tid == 0) {
                for (int a = 1; a < M; ++a)          // insertion sort
                    for (int b = a; b > 0 && peaks[b - 1] > peaks[b]; --b) {
                        const int t = peaks[b];
                        peaks[b] = peaks[b - 1];
                        peaks[b - 1] = t;
                    }
                const bool first = st_fest[0] < 1.0f;
                const float noldf = (float)nold;
                const float ninf = (float)nin;
                const float Sf = (float)g.S;
                for (int m = 0; m < M; ++m) {
                    f_new[m] = (float)peaks[m] * g.bin_hz;
                    latched[m] = first ? f_new[m] : st_fest[m];
                }
                for (int m = 0; m < M; ++m) {
                    const float a = -((g.two_pi * (noldf - Sf)) * latched[m]);
                    theta0[m] = fma1(a, g.inv_fs, st_phi[m]);
                    const float x = fma1(
                        g.two_pi_fs,
                        fma1(latched[m], noldf, f_new[m] * (ninf - Sf)),
                        theta0[m]);
                    float r = fmodf(x, g.two_pi);    // floor-mod (jnp.mod)
                    if (r != 0.0f && ((r < 0.0f) != (g.two_pi < 0.0f)))
                        r = r + g.two_pi;
                    phi_next[m] = r;
                }
            }
        }
        __syncthreads();

        // 4. downconvert: old samples at the latched tones, new ones at this
        // frame's, phase-continuous: stream * e^{-j ang}
        {
            const float noldf = (float)nold;
            for (int idx = tid; idx < M * Nmem; idx += THREADS) {
                const int m = idx / Nmem, t = idx - m * Nmem;
                const float tf = (float)t;
                const float inner = fma1(f_new[m], fmaxf(tf - noldf, 0.0f),
                                         latched[m] * fminf(tf, noldf));
                const float ang = fma1(g.two_pi_fs, inner, theta0[m]);
                const float c = cosf(ang), s = sinf(ang);
                const float sr = s_re[t], si = s_im[t];
                d_re[idx] = sr * c + si * s;
                d_im[idx] = si * c - sr * s;
            }
        }
        __syncthreads();

        // 5. integrate-and-dump: window sums of Ts samples at stride S
        for (int idx = tid; idx < M * g.NP; idx += THREADS) {
            const int m = idx / g.NP, q = idx - m * g.NP;
            const float* xr = d_re + m * Nmem + q * g.S;
            const float* xi = d_im + m * Nmem + q * g.S;
            float re = xr[0], im = xi[0];
            for (int u = 1; u < g.Ts; ++u) {
                re = re + xr[u];
                im = im + xi[u];
            }
            fi_re[idx] = re;
            fi_im[idx] = im;
        }
        __syncthreads();

        // 6. timing: the spectral line at Rs, summed in float64
        {
            double are = 0.0, aim = 0.0;
            for (int q = tid; q < g.NP; q += THREADS) {
                float ft = 0.0f;
                for (int m = 0; m < M; ++m) {
                    const float re = fi_re[m * g.NP + q];
                    const float im = fi_im[m * g.NP + q];
                    const float v = fma1(re, re, im * im);
                    ft = m == 0 ? v : ft + v;
                }
                are += (double)ft * (double)p.spin_re[q];
                aim += (double)ft * (double)p.spin_im[q];
            }
            block_sum2(are, aim, red);
            if (tid == 0) {
                const float norm =
                    atan2_poly(g, (float)aim, (float)are) / g.two_pi;
                const float rx = norm * (float)g.P;
                const float d_norm = norm - st_norm;
                const float appm = 1e6f * d_norm / (float)g.Nsym;
                sh_ppm = fabsf(d_norm) < 0.2f ? 0.9f * st_ppm + 0.1f * appm
                                              : st_ppm;
                sh_nin_next = norm > 0.25f ? g.N + g.Ts / 2
                              : (norm < -0.25f ? g.N - g.Ts / 2 : g.N);
                const float low = floorf(rx);
                const float fract = rx - low;
                sh_norm = norm;
                sh_low = low;
                sh_fract = fract;
                sh_high = low + (fract > 0.0f ? 1.0f : 0.0f);
            }
        }
        __syncthreads();

        // 7. symbol decisions with linear interpolation between the floor
        // and ceil integrator phases
        for (int k = tid; k < g.Nsym; k += THREADS) {
            const int st = (k + 1) * g.P;
            // rx timing lies in [-P/2, P/2], so both phases are in range;
            // the clamp only keeps a NaN timing inside shared memory
            const int ilo = min(max(st + (int)sh_low, 0), g.NP - 1);
            const int ihi = min(max(st + (int)sh_high, 0), g.NP - 1);
            const float fract = sh_fract, w_lo = 1.0f - fract;
            float tmax[MAX_M];
            for (int m = 0; m < M; ++m) {
                const float* fr = fi_re + m * g.NP;
                const float* fim = fi_im + m * g.NP;
                const float tr = fr[ilo] * w_lo + fr[ihi] * fract;
                const float ti = fim[ilo] * w_lo + fim[ihi] * fract;
                tmax[m] = tr * tr + ti * ti;
            }
            float win = tmax[0];
            int sym = 0;
            for (int m = 1; m < M; ++m)
                if (tmax[m] > win) { win = tmax[m]; sym = m; }
            winb[k] = win;
            float* so = p.soft + frame * g.Nbits;
            uint8_t* bo = p.bits + frame * g.Nbits;
            if (M == 2) {
                bo[k] = tmax[1] > tmax[0] ? 1 : 0;
                so[k] = sqrtf(tmax[0]) - sqrtf(tmax[1]);
            } else {
                const float m0 = sqrtf(tmax[0]), m1 = sqrtf(tmax[1]);
                const float m2 = sqrtf(tmax[2]), m3 = sqrtf(tmax[3]);
                bo[2 * k] = (sym >> 1) & 1;
                bo[2 * k + 1] = sym & 1;
                so[2 * k] = ((-m0 - m1) + m2) + m3;
                so[2 * k + 1] = ((-m0 + m1) - m2) + m3;
            }
        }
        __syncthreads();

        // 8. Eb/N0 from the winning magnitudes; outputs and the new state
        if (tid == 0) {
            float sm = 0.0f, sw = 0.0f;
            for (int k = 0; k < g.Nsym; ++k) {
                sm = sm + sqrtf(winb[k]);
                sw = sw + winb[k];
            }
            const float meane = sm / (float)g.Nsym;
            float stde = sw / (float)g.Nsym - meane * meane;
            stde = sqrtf(fmaxf(stde, 0.0f));
            const float ebno =
                -6.0f + 20.0f * log10f((1e-6f + meane) / (1e-6f + stde));
            st_snr = 0.5f * st_snr + 0.5f * ebno;
            p.valid[frame] = 1;
            p.o_ebno[frame] = ebno;
            p.o_norm[frame] = sh_norm;
            p.o_ppm[frame] = sh_ppm;
            p.o_nin[frame] = nin;
            for (int m = 0; m < M; ++m) {
                p.o_fest[frame * M + m] = f_new[m];
                st_fest[m] = f_new[m];
                st_phi[m] = phi_next[m];
            }
            st_pos = pos + nin;
            st_nin = sh_nin_next;
            st_norm = sh_norm;
            st_ppm = sh_ppm;
            st_ebno = ebno;
        }
        __syncthreads();
    }

    // frames past the lane's end: invalid, fields zeroed
    for (int r = f; r < g.num_frames; ++r) {
        const long long frame = (long long)lane * g.num_frames + r;
        for (int k = tid; k < g.Nbits; k += THREADS) {
            p.soft[frame * g.Nbits + k] = 0.0f;
            p.bits[frame * g.Nbits + k] = 0;
        }
        if (tid < M) p.o_fest[frame * M + tid] = 0.0f;
        if (tid == 0) {
            p.valid[frame] = 0;
            p.o_ebno[frame] = 0.0f;
            p.o_norm[frame] = 0.0f;
            p.o_ppm[frame] = 0.0f;
            p.o_nin[frame] = st_nin;
        }
    }

    for (int k = tid; k < half; k += THREADS)
        p.fft_out[lane * half + k] = fft[k];
    if (tid < M) {
        p.fest_out[lane * M + tid] = st_fest[tid];
        p.phi_out[lane * M + tid] = st_phi[tid];
    }
    if (tid == 0) {
        p.pos_out[lane] = st_pos;
        p.nin_out[lane] = st_nin;
        p.norm_out[lane] = st_norm;
        p.ppm_out[lane] = st_ppm;
        p.ebno_out[lane] = st_ebno;
        p.snr_out[lane] = st_snr;
    }
}

extern "C" int fsk_demod_smem_bytes(const DemodGeom* g) {
    return (int)smem_bytes(*g);
}

extern "C" int fsk_demod_launch(const DemodGeom* g, const DemodPtrs* p,
                                void* stream) {
    if (g->M < 2 || g->M > MAX_M) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(*g);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        fsk_demod_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (g->lanes == 0) return 0;
    fsk_demod_kernel<<<g->lanes, THREADS, smem, (cudaStream_t)stream>>>(*g,
                                                                       *p);
    return (int)cudaGetLastError();
}
