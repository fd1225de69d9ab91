// recon_frame: normative intra reconstruction + quantized coefficients of
// every transform unit (TU) of F frames, in coding order, from the encoder's
// decisions (depth8 / modes4 / nxn8).
//
// Replaces the TPU kernel hevc_tpu/pipeline/recon_pallas.py::
// _build_component_call (TU body _code_one_tu, wrapper
// encode_frame_planes_pallas). It computes the same function and shares
// none of that kernel's shape. The TPU kernel ran the CTUs of a frame as a
// sequential grid (raster order = coding order), put the frame batch on the
// vector lanes, ran every mode that any frame used and masked the rest, and
// made its integer products exact with byte splits around a float matrix
// unit. Here:
//
//   * a CUDA grid has no order, so the intra dependency is carried by the
//     launches: CTUs on the anti-diagonal d = ctu_x + 2 * ctu_y only read
//     samples of CTUs on earlier diagonals (left, above, above-right), so
//     there is ONE LAUNCH PER DIAGONAL and the stream orders them. A launch
//     is a grid (CTUs of the diagonal, F frames, planes Y / Cb / Cr): the
//     three planes never read each other, so they share the launch, and a
//     diagonal takes as long as its slowest plane's chain, not the sum of
//     the luma and the chroma chains. Luma and chroma CTUs share the CTU
//     grid (a 32x32 chroma CTU under each 64x64 luma one);
//   * a thread block codes one CTU of one plane of ONE frame, so depth,
//     NxN flag and mode are uniform over the block: its threads test all
//     rows of the static step table (344 luma / 88 chroma rows,
//     depth-first = coding order) at once, keep the rows that are leaves
//     of this CTU's quadtree, in order, as a list in shared memory, and
//     the block codes those TUs one after the other, predicting the one
//     mode each TU has. The plane (blockIdx.z) is uniform
//     over the block too, so the `__syncthreads()` inside each plane's
//     branch are legal; the luma and chroma state share one shared-memory
//     union;
//   * the TU body is compiled once per TU size (code_tu<S, N, DST>: seven
//     instances): the trip counts, shifts, strides and rounding offsets are
//     constants, every per-sample loop runs a fixed number of times (4 at
//     32x32, 1 below) and the transforms' N-term dot products are unrolled;
//   * all integer arithmetic is plain int32 (every product and sum here
//     stays below 2^31), `>>` on a signed int is the arithmetic (floor)
//     shift the negative sums need;
//   * the RDOQ costs are float32 with every product and sum rounded on its
//     own (no fused multiply-add: the decisions are `<=` comparisons of
//     these costs), in the association (alpha * e) * e + lambda * bits; the
//     level-bit model reads the float's exponent and mantissa, no log2; the
//     sums over a 4x4 coefficient group add dx first, then dy, one after
//     the other, as the plain version does.
//
// Per leaf TU of size N the block runs, with __syncthreads() between the
// steps and all state in shared memory: gather the 4N+1 reference samples
// from the CTU tile / the context row and column, availability by z-order
// address and frame bounds -> substitution -> [1 2 1] filter (luma, by mode
// and size) -> prediction (planar, DC with its luma edges, angular taps
// from the mode's angle, VER/HOR luma edges) -> residual against the
// original -> forward DCT (DST for luma 4x4) with the two HM shifts ->
// RDOQ-lite or dead-zone quantisation -> levels to device memory ->
// dequantisation -> inverse transform with its two 16-bit clips ->
// clip(pred + residual, 0, 255) into the tile. A TU whose levels are all
// zero skips the inverse transform (its residual is zero). The tile goes
// to device memory once, when the CTU is done.
//
// Bound on an H100: the planes are read once and written once (1.5 bytes
// of original, 1.5 of reconstruction, 3 of levels per pixel), which is
// microseconds at 3.35 TB/s, and the arithmetic (4N multiply-adds per
// sample for the four transform stages plus prediction and quantisation) is
// tens of microseconds at the int32 rate. Neither binds a single frame:
// the dependency does. 62 diagonals at 1080p run one after the other, and
// inside a CTU the TUs run one after the other, so the time is
// diagonals x (longest TU chain of a CTU) x (time of one TU step), with at
// most 15 x F x 3 blocks on 132 SMs. The design answers with the frame
// batch (F frames fill the card F times better at the same latency), with
// the three planes side by side, with a chain that holds the leaf TUs only
// (no serial walk over the step table's rows), with skipping the inverse
// transform of all-zero TUs, and with a TU step whose loops the compiler
// sees whole.
//
// The same source builds without nvcc as plain C++ (the threads of a block
// become a loop between two synchronisation points), which is how the CPU
// tests hold this body against the plain PyTorch version.

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RF_DEVICE __device__ __forceinline__
#define RF_CONST __constant__
#define RF_UNROLL _Pragma("unroll")
// one parallel step of the block: the body runs once per thread
#define RF_THREADS { const int tid = (int)threadIdx.x;
#define RF_SYNC } __syncthreads();
#define RF_FMUL(a, b) __fmul_rn((a), (b))
#define RF_FADD(a, b) __fadd_rn((a), (b))
#define RF_FSUB(a, b) __fsub_rn((a), (b))
#else
#define RF_DEVICE static inline
#define RF_CONST static const
#define RF_UNROLL
#define RF_THREADS for (int tid = 0; tid < NT; ++tid) {
#define RF_SYNC }
#define RF_FMUL(a, b) ((float)((float)(a) * (float)(b)))
#define RF_FADD(a, b) ((float)((float)(a) + (float)(b)))
#define RF_FSUB(a, b) ((float)((float)(a) - (float)(b)))
#endif

namespace {

constexpr int NT = 256;              // threads per block

// H.265 Table 8-4 / 8-5: displacement angle of modes 2..34, inverse angle
// of modes 11..25
RF_CONST int ANGLE[33] = {32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13,
                          -17, -21, -26, -32, -26, -21, -17, -13, -9, -5,
                          -2, 0, 2, 5, 9, 13, 17, 21, 26, 32};
RF_CONST int INV_ANGLE[15] = {-4096, -1638, -910, -630, -482, -390, -315,
                              -256, -315, -390, -482, -630, -910, -1638,
                              -4096};
RF_CONST int QUANT_SCALE[6] = {26214, 23302, 20560, 18396, 16384, 14564};
RF_CONST int INV_QUANT_SCALE[6] = {40, 45, 51, 57, 64, 72};

// what differs between luma (plane 0, S = 64) and chroma (planes 1 and 2,
// S = 32)
struct Group {
    const int* steps;           // [n_steps, 8]
    int n_steps;
    int W, H;                   // coded size of the component
    int scale;                  // 1 luma, 2 chroma (4:2:0)
    int qp;
    float lam;
    float alpha[4];             // by log2(N) - 2
};

struct Args {
    const uint8_t* orig[3];     // [F, H, W] per plane Y, Cb, Cr
    uint8_t* rec[3];            // [F, H, W]
    int16_t* coef[3];           // [F, H, W]
    Group grp[2];               // luma, chroma
    const int* depth8;          // [F, h8, w8]
    const int* modes4;          // [F, 2 * h8, 2 * w8]
    const uint8_t* nxn8;        // [F, h8, w8]
    const int* t32;             // [32, 32] DCT matrix
    const int* dst4;            // [4, 4] DST matrix
    int nx, ny;                 // CTUs per row / column
    int w8, h8;                 // coded luma size in 8x8 units
    int rdoq;
    int z0;                     // plane of blockIdx.z == 0
    int diag, cy_lo;
};

template <int S>
struct Shared {
    static constexpr int NMAX = S / 2;          // largest TU of the plane
    static constexpr int RMAX = 4 * NMAX + 1;
    // rows of the plane's step table (the host's STEP_ROWS), in chunks of
    // 16 for the compaction
    static constexpr int ROWS = S == 64 ? 344 : 88;
    static constexpr int CHUNKS = (ROWS + 15) / 16;
    int t32[32 * 33];                           // row stride 33: no conflicts
    int dst4[16];
    int d8[64];
    int m4[256];
    int nxn[64];
    int ref_raw[RMAX];
    int ref_s[RMAX];
    int ref_f[RMAX];
    unsigned avail_bits[8];
    int pred[NMAX * NMAX];
    int a[NMAX * NMAX];
    int b[NMAX * NMAX];
    float cv[NMAX * NMAX];
    float cz[NMAX * NMAX];
    int zcg[64];
    int row_tu[CHUNKS * 16];                    // packed TU, or -1: no leaf
    int chunk_tus[CHUNKS];
    int tus[ROWS];                              // the CTU's leaf TUs, in order
    int n_tus;
    int dc;
    int any;
    uint8_t avail[RMAX + 3];
    uint8_t tile[S * S];
    uint8_t top[2 * S + 1 + 3];
    uint8_t left[S];
};

// one block codes one plane: the state of a luma and of a chroma CTU share
// the block's shared memory
union SharedAll {
    Shared<64> y;
    Shared<32> c;
};

RF_DEVICE int float_bits(float v) {
#ifdef __CUDACC__
    return __float_as_int(v);
#else
    int b;
    memcpy(&b, &v, 4);
    return b;
#endif
}

RF_DEVICE int high_bit(unsigned w) {     // index of the highest set bit
#ifdef __CUDACC__
    return 31 - __clz((int)w);
#else
    return 31 - __builtin_clz(w);
#endif
}

RF_DEVICE int low_bit(unsigned w) {      // index of the lowest set bit
#ifdef __CUDACC__
    return __ffs((int)w) - 1;
#else
    return __builtin_ctz(w);
#endif
}

RF_DEVICE int clip3(int lo, int hi, int v) {
    return v < lo ? lo : (v > hi ? hi : v);
}

RF_DEVICE int interleave4(int v) {
    v &= 0xF;
    v = (v | (v << 2)) & 0x33;
    v = (v | (v << 1)) & 0x55;
    return v;
}

// decode-order address of the 4x4 luma block that holds luma sample (x, y)
RF_DEVICE int zaddr(int x, int y, int n_ctu_x) {
    const int bx = x >> 2, by = y >> 2;
    const int morton = interleave4(bx & 15) | (interleave4(by & 15) << 1);
    return ((by >> 4) * n_ctu_x + (bx >> 4)) * 256 + morton;
}

// approximate bits of an absolute level: piecewise-linear log2 read from
// the float's exponent and mantissa
RF_DEVICE float level_bits(int l) {
    if (l == 0) return 1.0f;
    if (l == 1) return 2.5f;
    if (l == 2) return 4.0f;
    const int b32 = float_bits((float)(l + 1));
    const float e = (float)((b32 >> 23) - 127);
    const float m = RF_FMUL((float)(b32 & 0x7FFFFF), 1.1920928955078125e-07f);
    return RF_FADD(RF_FMUL(2.0f, RF_FADD(e, m)), 3.5f);
}

RF_DEVICE int dequant(int lv, int inv_scale, int shift) {
    return clip3(-32768, 32767, (lv * inv_scale + (1 << (shift - 1))) >> shift);
}

// index into the linear reference array r[0..4N] of entry k of the
// extended main reference of an angular mode (k < 0: projected side
// samples)
template <int N>
RF_DEVICE int main_ref(int k, bool vert, int mode) {
    constexpr int N2 = 2 * N;
    if (k >= 0) return vert ? N2 + k : N2 - k;
    const int j = ((k * INV_ANGLE[mode - 11] + 128) >> 8) - 1;
    return vert ? N2 - 1 - j : N2 + 1 + j;
}

// one predicted sample. r: substituted (and, where the mode asks, filtered)
// references: left[j] = r[2N-1-j], corner = r[2N], top[i] = r[2N+1+i].
// edge: luma and N < 32 (DC / VER / HOR boundary smoothing).
template <int N, int LOG2N>
RF_DEVICE int predict_sample(const int* r, int mode, int x, int y, bool edge,
                             int dc) {
    constexpr int N2 = 2 * N;
    if (mode == 0)
        return ((N - 1 - x) * r[N2 - 1 - y] + (x + 1) * r[N2 + 1 + N]
                + (N - 1 - y) * r[N2 + 1 + x] + (y + 1) * r[N2 - 1 - N]
                + N) >> (LOG2N + 1);
    if (mode == 1) {
        if (!edge) return dc;
        if (x == 0 && y == 0) return (r[N2 - 1] + 2 * dc + r[N2 + 1] + 2) >> 2;
        if (y == 0) return (r[N2 + 1 + x] + 3 * dc + 2) >> 2;
        if (x == 0) return (r[N2 - 1 - y] + 3 * dc + 2) >> 2;
        return dc;
    }
    if (edge) {
        if (mode == 26 && x == 0)
            return clip3(0, 255, r[N2 + 1] + ((r[N2 - 1 - y] - r[N2]) >> 1));
        if (mode == 10 && y == 0)
            return clip3(0, 255, r[N2 - 1] + ((r[N2 + 1 + x] - r[N2]) >> 1));
    }
    const bool vert = mode >= 18;
    const int u = vert ? x : y;            // along the main reference
    const int v = vert ? y : x;            // distance from it
    const int t = (v + 1) * ANGLE[mode - 2];
    const int fact = t & 31;
    const int k1 = u + (t >> 5) + 1;
    const int ia = main_ref<N>(k1, vert, mode);
    const int ib = fact ? main_ref<N>(k1 + 1, vert, mode) : ia;
    return ((32 - fact) * r[ia] + fact * r[ib] + 16) >> 5;
}

template <int N>
RF_DEVICE bool ref_filter_flag(int mode) {
    if (mode == 1 || N == 4) return false;
    const int dh = mode > 10 ? mode - 10 : 10 - mode;
    const int dv = mode > 26 ? mode - 26 : 26 - mode;
    constexpr int THRES = N == 8 ? 7 : (N == 16 ? 1 : 0);
    return (dh < dv ? dh : dv) > THRES;
}

// Code one leaf TU of size N at (x0, y0) of the CTU at (ox, oy) of a plane
// of S x S CTUs (64: luma, 32: chroma); DST: the luma 4x4 transform.
//
// Every per-sample loop visits the samples p = tid + it * NT, it < ITERS:
// 4 times at N = 32, once below (the threads from N * N on idle).
template <int S, int N, bool DST>
RF_DEVICE void code_tu(const Args& g, const Group& grp, Shared<S>& sh,
                       const uint8_t* orig, int16_t* coef, int ox, int oy,
                       int x0, int y0, int mode) {
    static_assert(N <= Shared<S>::NMAX && (!DST || N == 4), "TU size");
    constexpr bool LUMA = S == 64;
    constexpr int LOG2N = N == 4 ? 2 : (N == 8 ? 3 : (N == 16 ? 4 : 5));
    constexpr int R = 4 * N + 1;
    constexpr int NN = N * N;
    constexpr int ITERS = (NN + NT - 1) / NT;
    constexpr bool PART = NN < NT;         // some threads have no sample
    constexpr int GN = N >> 2;             // 4x4 coefficient groups per row
    // row k of the N-point DCT is row k * 32 / N of the 32-point one
    constexpr int TSTRIDE = 33 * (32 / N);
    constexpr int S1 = LOG2N - 1, S2 = LOG2N + 6;     // forward shifts
    const int gx0 = ox + x0, gy0 = oy + y0;
    const bool use_f = LUMA && ref_filter_flag<N>(mode);
    constexpr bool EDGE = LUMA && N < 32;

    // 1. references and their availability
    RF_THREADS
        if (tid == 0) sh.any = 0;
        if (tid < R) {
            const int i = tid;
            const int dx = i <= 2 * N ? -1 : i - 2 * N - 1;
            const int dy = i < 2 * N ? 2 * N - 1 - i : -1;
            const int gx = gx0 + dx, gy = gy0 + dy;
            const bool inside = gx >= 0 && gy >= 0 && gx < grp.W && gy < grp.H;
            const int zcur = zaddr(gx0 * grp.scale, gy0 * grp.scale, g.nx);
            const int zref = zaddr((gx < 0 ? 0 : gx) * grp.scale,
                                   (gy < 0 ? 0 : gy) * grp.scale, g.nx);
            const bool av = inside && zref < zcur;
            int v = 0;
            if (av) {
                const int lx = x0 + dx, ly = y0 + dy;
                if (ly < 0) v = sh.top[lx + 1];
                else if (lx < 0) v = sh.left[ly];
                else v = sh.tile[ly * S + lx];
            }
            sh.avail[i] = av ? 1 : 0;
            sh.ref_raw[i] = v;
        }
    RF_SYNC
    RF_THREADS
        if (tid < (R + 31) / 32) {
            unsigned w = 0;
            for (int b = 0; b < 32; ++b) {
                const int i = tid * 32 + b;
                if (i < R && sh.avail[i]) w |= 1u << b;
            }
            sh.avail_bits[tid] = w;
        }
    RF_SYNC
    // 2. substitution: the nearest available sample below, else the first
    // available one, else mid grey
    RF_THREADS
        if (tid < R) {
            constexpr int WORDS = (R + 31) / 32;
            int w = tid >> 5;
            unsigned m = sh.avail_bits[w] & (0xFFFFFFFFu >> (31 - (tid & 31)));
            int src = -1;
            for (;;) {
                if (m) { src = w * 32 + high_bit(m); break; }
                if (--w < 0) break;
                m = sh.avail_bits[w];
            }
            if (src < 0) {
                for (w = 0; w < WORDS; ++w) {
                    if (sh.avail_bits[w]) {
                        src = w * 32 + low_bit(sh.avail_bits[w]);
                        break;
                    }
                }
            }
            sh.ref_s[tid] = src >= 0 ? sh.ref_raw[src] : 128;
        }
    RF_SYNC
    // 3. [1 2 1] filter where the mode uses it; the DC value
    RF_THREADS
        if (tid < R && use_f) {
            const int i = tid;
            sh.ref_f[i] = (i == 0 || i == R - 1) ? sh.ref_s[i]
                : (sh.ref_s[i - 1] + 2 * sh.ref_s[i] + sh.ref_s[i + 1] + 2) >> 2;
        }
        if (tid == NT - 1 && mode == 1) {
            int sum = N;
            RF_UNROLL
            for (int i = 0; i < N; ++i)
                sum += sh.ref_s[2 * N + 1 + i] + sh.ref_s[2 * N - 1 - i];
            sh.dc = sum >> (LOG2N + 1);
        }
    RF_SYNC
    // 4. prediction and residual
    RF_THREADS
        const int* r = use_f ? sh.ref_f : sh.ref_s;
        const int dc = sh.dc;
        RF_UNROLL
        for (int it = 0; it < ITERS; ++it) {
            const int p = tid + it * NT;
            if (PART && p >= NN) break;
            const int y = p >> LOG2N, x = p & (N - 1);
            const int pr = predict_sample<N, LOG2N>(r, mode, x, y, EDGE, dc);
            const int o = orig[(long long)(gy0 + y) * grp.W + gx0 + x];
            sh.pred[p] = pr;
            sh.a[p] = o - pr;
        }
    RF_SYNC
    // 5. forward transform: columns (shift LOG2N - 1), then rows
    // (shift LOG2N + 6)
    RF_THREADS
        RF_UNROLL
        for (int it = 0; it < ITERS; ++it) {
            const int p = tid + it * NT;
            if (PART && p >= NN) break;
            const int k = p >> LOG2N, j = p & (N - 1);
            const int* row = DST ? sh.dst4 + k * 4 : sh.t32 + k * TSTRIDE;
            const int* col = sh.a + j;
            int acc = 0;
            RF_UNROLL
            for (int i = 0; i < N; ++i) acc += row[i] * col[i * N];
            sh.b[p] = (acc + (1 << (S1 - 1))) >> S1;
        }
    RF_SYNC
    RF_THREADS
        RF_UNROLL
        for (int it = 0; it < ITERS; ++it) {
            const int p = tid + it * NT;
            if (PART && p >= NN) break;
            const int k = p >> LOG2N, l = p & (N - 1);
            const int* row = DST ? sh.dst4 + l * 4 : sh.t32 + l * TSTRIDE;
            const int* src = sh.b + k * N;
            int acc = 0;
            RF_UNROLL
            for (int j = 0; j < N; ++j) acc += src[j] * row[j];
            sh.a[p] = (acc + (1 << (S2 - 1))) >> S2;
        }
    RF_SYNC
    // 6. quantisation
    const int qbits = 21 + grp.qp / 6 - LOG2N;
    const int qscale = QUANT_SCALE[grp.qp % 6];
    const int inv_scale = INV_QUANT_SCALE[grp.qp % 6] << (grp.qp / 6);
    constexpr int DSHIFT = LOG2N - 1;
    const bool cg_zero = g.rdoq && N >= 8;
    if (g.rdoq) {
        const float al = grp.alpha[LOG2N - 2];
        const float lam = grp.lam;
        RF_THREADS
            RF_UNROLL
            for (int it = 0; it < ITERS; ++it) {
                const int p = tid + it * NT;
                if (PART && p >= NN) break;
                const int c = sh.a[p];
                const int ac = c < 0 ? -c : c;
                int hi = (ac * qscale + (1 << (qbits - 1))) >> qbits;
                if (hi > 32767) hi = 32767;
                const int lo = hi > 0 ? hi - 1 : 0;
                float cost[3];
                const int cand[3] = {hi, lo, 0};
                for (int t = 0; t < 3; ++t) {
                    const float e =
                        (float)(ac - dequant(cand[t], inv_scale, DSHIFT));
                    cost[t] = RF_FADD(RF_FMUL(RF_FMUL(al, e), e),
                                      RF_FMUL(lam, level_bits(cand[t])));
                }
                int lv = (cost[1] <= cost[0] && lo > 0) ? lo : hi;
                float cvv = cost[1] < cost[0] ? cost[1] : cost[0];
                if (cost[2] <= cvv) lv = 0;
                cvv = cost[2] < cvv ? cost[2] : cvv;
                sh.b[p] = lv;
                sh.cv[p] = cvv;
                sh.cz[p] = cost[2];
            }
        RF_SYNC
        if (cg_zero) {
            // zero a whole 4x4 coefficient group where that costs less
            RF_THREADS
                if (tid < GN * GN) {
                    const int by = (tid / GN) * 4, bx = (tid % GN) * 4;
                    float keep = 0.0f, zero = 0.0f;
                    for (int dy = 0; dy < 4; ++dy) {
                        const int q = (by + dy) * N + bx;
                        float ck = sh.cv[q], cz = sh.cz[q];
                        for (int dx = 1; dx < 4; ++dx) {
                            ck = RF_FADD(ck, sh.cv[q + dx]);
                            cz = RF_FADD(cz, sh.cz[q + dx]);
                        }
                        keep = dy == 0 ? ck : RF_FADD(keep, ck);
                        zero = dy == 0 ? cz : RF_FADD(zero, cz);
                    }
                    sh.zcg[tid] = RF_FSUB(zero, lam) <= keep ? 1 : 0;
                }
            RF_SYNC
        }
    }
    // 7. levels out, dequantisation
    RF_THREADS
        const int add = 171 << (qbits - 9);
        RF_UNROLL
        for (int it = 0; it < ITERS; ++it) {
            const int p = tid + it * NT;
            if (PART && p >= NN) break;
            const int y = p >> LOG2N, x = p & (N - 1);
            const int c = sh.a[p];
            int lv;
            if (g.rdoq) {
                lv = sh.b[p];
                if (cg_zero && sh.zcg[(y >> 2) * GN + (x >> 2)]) lv = 0;
            } else {
                const int ac = c < 0 ? -c : c;
                lv = (ac * qscale + add) >> qbits;
                if (lv > 32767) lv = 32767;
            }
            if (c < 0) lv = -lv;
            coef[(long long)(gy0 + y) * grp.W + gx0 + x] = (int16_t)lv;
            if (lv != 0) sh.any = 1;
            sh.a[p] = dequant(lv, inv_scale, DSHIFT);
        }
    RF_SYNC
    // 8. inverse transform (columns, clip, rows, clip) and reconstruction
    if (sh.any) {
        RF_THREADS
            RF_UNROLL
            for (int it = 0; it < ITERS; ++it) {
                const int p = tid + it * NT;
                if (PART && p >= NN) break;
                const int i = p >> LOG2N, j = p & (N - 1);
                const int* col = sh.a + j;
                int acc = 0;
                RF_UNROLL
                for (int k = 0; k < N; ++k) {
                    const int t = DST ? sh.dst4[k * 4 + i]
                                      : sh.t32[k * TSTRIDE + i];
                    acc += t * col[k * N];
                }
                sh.b[p] = clip3(-32768, 32767, (acc + 64) >> 7);
            }
        RF_SYNC
        RF_THREADS
            RF_UNROLL
            for (int it = 0; it < ITERS; ++it) {
                const int p = tid + it * NT;
                if (PART && p >= NN) break;
                const int i = p >> LOG2N, j = p & (N - 1);
                const int* src = sh.b + i * N;
                int acc = 0;
                RF_UNROLL
                for (int l = 0; l < N; ++l) {
                    const int t = DST ? sh.dst4[l * 4 + j]
                                      : sh.t32[l * TSTRIDE + j];
                    acc += src[l] * t;
                }
                const int res = clip3(-32768, 32767, (acc + 2048) >> 12);
                sh.tile[(y0 + i) * S + x0 + j] =
                    (uint8_t)clip3(0, 255, sh.pred[p] + res);
            }
        RF_SYNC
    } else {
        RF_THREADS
            RF_UNROLL
            for (int it = 0; it < ITERS; ++it) {
                const int p = tid + it * NT;
                if (PART && p >= NN) break;
                const int i = p >> LOG2N, j = p & (N - 1);
                sh.tile[(y0 + i) * S + x0 + j] = (uint8_t)sh.pred[p];
            }
        RF_SYNC
    }
}

// Code one CTU (plane `plane` of frame `f`, CTU number `lane` of the
// diagonal g.diag); S = 64 for plane 0, 32 for planes 1 and 2.
template <int S>
RF_DEVICE void code_ctu(const Args& g, Shared<S>& sh, int lane, int f,
                        int plane) {
    constexpr bool LUMA = S == 64;
    const Group& grp = g.grp[LUMA ? 0 : 1];
    const int cy = g.cy_lo + lane, cx = g.diag - 2 * cy;
    const int ox = cx * S, oy = cy * S;
    const long long poff = (long long)f * grp.H * grp.W;
    const uint8_t* orig = g.orig[plane] + poff;
    uint8_t* rec = g.rec[plane] + poff;
    int16_t* coef = g.coef[plane] + poff;
    const long long off8 = (long long)f * g.h8 * g.w8;
    const int* d8 = g.depth8 + off8;
    const uint8_t* nxn = g.nxn8 + off8;
    const int* m4 = g.modes4 + off8 * 4;
    const int w4 = 2 * g.w8, h4 = 2 * g.h8;

    // decisions of the CTU, transform matrices, context row and column
    RF_THREADS
        for (int i = tid; i < 1024; i += NT)
            sh.t32[(i >> 5) * 33 + (i & 31)] = g.t32[i];
        if (tid < 16) sh.dst4[tid] = g.dst4[tid];
        if (tid < 64) {
            const int y = cy * 8 + (tid >> 3), x = cx * 8 + (tid & 7);
            const bool in = y < g.h8 && x < g.w8;
            sh.d8[tid] = in ? d8[y * g.w8 + x] : -1;
            sh.nxn[tid] = in ? (int)nxn[y * g.w8 + x] : 0;
        }
        {
            const int y = cy * 16 + (tid >> 4), x = cx * 16 + (tid & 15);
            sh.m4[tid] = (y < h4 && x < w4) ? m4[y * w4 + x] : 0;
        }
        for (int i = tid; i < 2 * S + 1; i += NT) {
            const int x = ox - 1 + i, y = oy - 1;
            sh.top[i] = (y >= 0 && x >= 0 && x < grp.W)
                ? rec[(long long)y * grp.W + x] : 0;
        }
        if (tid < S) {
            const int x = ox - 1, y = oy + tid;
            sh.left[tid] = (x >= 0 && y < grp.H)
                ? rec[(long long)y * grp.W + x] : 0;
        }
    RF_SYNC

    // the leaf TUs of the CTU in coding order, packed as cls | x0 << 2 |
    // y0 << 8 | mode << 14: every row of the step table is tested at once,
    // then each chunk of 16 rows writes its leaves after those of the
    // chunks before it. The TU chain below then reads shared memory only.
    constexpr int CHUNKS = Shared<S>::CHUNKS;
    RF_THREADS
        for (int s = tid; s < CHUNKS * 16; s += NT) {
            int tu = -1;
            if (s < grp.n_steps) {
                const int* st = grp.steps + s * 8;
                const int cls = st[0];
                const int n8 = st[4] * 8 + st[3];
                bool leaf = sh.d8[n8] == st[5];     // a leaf at this depth
                if (LUMA && cls == 2) leaf = leaf && !sh.nxn[n8];
                if (LUMA && cls == 3) leaf = leaf && sh.nxn[n8];
                if (leaf)
                    tu = cls | st[1] << 2 | st[2] << 8
                         | sh.m4[st[7] * 16 + st[6]] << 14;
            }
            sh.row_tu[s] = tu;
        }
    RF_SYNC
    RF_THREADS
        if (tid < CHUNKS) {
            int n = 0;
            for (int k = 0; k < 16; ++k) n += sh.row_tu[tid * 16 + k] >= 0;
            sh.chunk_tus[tid] = n;
        }
    RF_SYNC
    RF_THREADS
        if (tid < CHUNKS) {
            int at = 0;
            for (int c = 0; c < tid; ++c) at += sh.chunk_tus[c];
            for (int k = 0; k < 16; ++k) {
                const int tu = sh.row_tu[tid * 16 + k];
                if (tu >= 0) sh.tus[at++] = tu;
            }
            if (tid == CHUNKS - 1) sh.n_tus = at;
        }
    RF_SYNC

    // the TU size is a constant of each code_tu instance: luma cls 0..3 =
    // 32, 16, 8 (2Nx2N), 4 (NxN, DST); chroma cls 0..2 = 16, 8, 4
    const int n_tus = sh.n_tus;
    for (int t = 0; t < n_tus; ++t) {
        const int tu = sh.tus[t];
        const int cls = tu & 3, x0 = (tu >> 2) & 63, y0 = (tu >> 8) & 63;
        const int mode = tu >> 14;
        if constexpr (LUMA) {
            switch (cls) {
            case 0:
                code_tu<S, 32, false>(g, grp, sh, orig, coef, ox, oy, x0, y0,
                                      mode);
                break;
            case 1:
                code_tu<S, 16, false>(g, grp, sh, orig, coef, ox, oy, x0, y0,
                                      mode);
                break;
            case 2:
                code_tu<S, 8, false>(g, grp, sh, orig, coef, ox, oy, x0, y0,
                                     mode);
                break;
            default:
                code_tu<S, 4, true>(g, grp, sh, orig, coef, ox, oy, x0, y0,
                                    mode);
                break;
            }
        } else {
            switch (cls) {
            case 0:
                code_tu<S, 16, false>(g, grp, sh, orig, coef, ox, oy, x0, y0,
                                      mode);
                break;
            case 1:
                code_tu<S, 8, false>(g, grp, sh, orig, coef, ox, oy, x0, y0,
                                     mode);
                break;
            default:
                code_tu<S, 4, false>(g, grp, sh, orig, coef, ox, oy, x0, y0,
                                     mode);
                break;
            }
        }
    }

    // the part of the tile that lies inside the coded frame
    RF_THREADS
        const int hh = grp.H - oy < S ? grp.H - oy : S;
        const int ww = grp.W - ox < S ? grp.W - ox : S;
        for (int p = tid; p < S * S; p += NT) {
            const int y = p / S, x = p % S;
            if (y < hh && x < ww)
                rec[(long long)(oy + y) * grp.W + ox + x] = sh.tile[p];
        }
    RF_SYNC
}

// one block: plane 0 is a luma CTU, planes 1 and 2 chroma CTUs
RF_DEVICE void code_plane(const Args& g, SharedAll& sh, int lane, int f,
                          int plane) {
    if (plane == 0) code_ctu<64>(g, sh.y, lane, f, 0);
    else code_ctu<32>(g, sh.c, lane, f, plane);
}

// CTU rows cy_lo..cy_hi that diagonal d = cx + 2 * cy crosses
inline void diag_range(int d, int nx, int ny, int* cy_lo, int* cy_hi) {
    *cy_lo = d >= nx ? (d - nx + 2) / 2 : 0;
    *cy_hi = d / 2 < ny - 1 ? d / 2 : ny - 1;
}

#ifdef __CUDACC__
// the register budget is planned for 3 blocks per SM: 80 registers and no
// spills (1: 124 registers, 2 blocks per SM; 4: spills)
__global__ void __launch_bounds__(NT, 3)
recon_ctu_kernel(const Args g) {
    __shared__ SharedAll sh;
    code_plane(g, sh, (int)blockIdx.x, (int)blockIdx.y,
               g.z0 + (int)blockIdx.z);
}
#endif

// Planes z0 .. z0 + zc - 1 of F frames, one launch (or, built for the host,
// one pass) per non-empty diagonal. Returns the launches made, or minus the
// CUDA error of the first launch that failed.
int run_diagonals(Args g, int F, int zc, void* stream) {
    const int n_diag = g.nx + 2 * (g.ny - 1);
    int made = 0;
#ifndef __CUDACC__
    SharedAll* sh = new SharedAll;
#endif
    for (int d = 0; d < n_diag; ++d) {
        int cy_hi;
        g.diag = d;
        diag_range(d, g.nx, g.ny, &g.cy_lo, &cy_hi);
        const int lanes = cy_hi - g.cy_lo + 1;
        if (lanes <= 0) continue;
#ifdef __CUDACC__
        recon_ctu_kernel<<<dim3(lanes, F, zc), NT, 0,
                           static_cast<cudaStream_t>(stream)>>>(g);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return -(int)err;
#else
        (void)stream;
        for (int lane = 0; lane < lanes; ++lane)
            for (int f = 0; f < F; ++f)
                for (int z = 0; z < zc; ++z)
                    code_plane(g, *sh, lane, f, g.z0 + z);
#endif
        ++made;
    }
#ifndef __CUDACC__
    delete sh;
#endif
    return made;
}

void set_group(Group* c, const void* steps, int n_steps, int W, int H,
               int scale, int qp, float lam, float a4, float a8, float a16,
               float a32) {
    c->steps = static_cast<const int*>(steps);
    c->n_steps = n_steps;
    c->W = W;
    c->H = H;
    c->scale = scale;
    c->qp = qp;
    c->lam = lam;
    c->alpha[0] = a4;
    c->alpha[1] = a8;
    c->alpha[2] = a16;
    c->alpha[3] = a32;
}

}  // namespace

// Planes z0 .. z0 + zc - 1 (0 = Y, 1 = Cb, 2 = Cr) of F frames: one launch
// per wavefront diagonal that covers the selected planes, nx + 2 * (ny - 1)
// launches in all (nx, ny: CTUs per row / column, nx > 1), on `stream`;
// does not synchronise, allocates nothing. orig*/rec*/coef*: [F, H, W]
// uint8 / uint8 / int16 planes (luma H = 8 * h8, W = 8 * w8; chroma half of
// each); depth8 [F, h8, w8] int32, modes4 [F, 2*h8, 2*w8] int32, nxn8
// [F, h8, w8] uint8; steps_y [n_steps_y, 8] / steps_c [n_steps_c, 8] int32
// (cls, tux, tuy, n8x, n8y, depth, m4x, m4y); t32 [32, 32], dst4 [4, 4]
// int32. rec* must be zero-filled or hold earlier output: samples outside
// the frame are never read. qp_* is each component's QP, lam_* / a*_* the
// float32 RDOQ constants. Returns the number of launches made, or minus
// cudaGetLastError() of the first launch that failed.
extern "C" int recon_frame_launch(
        const void* orig_y, const void* orig_cb, const void* orig_cr,
        void* rec_y, void* rec_cb, void* rec_cr, void* coef_y,
        void* coef_cb, void* coef_cr, const void* depth8, const void* modes4,
        const void* nxn8, const void* steps_y, int n_steps_y,
        const void* steps_c, int n_steps_c, const void* t32,
        const void* dst4, int F, int w8, int h8, int rdoq, int z0, int zc,
        int qp_y, float lam_y, float a4_y, float a8_y, float a16_y,
        float a32_y, int qp_c, float lam_c, float a4_c, float a8_c,
        float a16_c, float a32_c, void* stream) {
    Args g;
    g.orig[0] = static_cast<const uint8_t*>(orig_y);
    g.orig[1] = static_cast<const uint8_t*>(orig_cb);
    g.orig[2] = static_cast<const uint8_t*>(orig_cr);
    g.rec[0] = static_cast<uint8_t*>(rec_y);
    g.rec[1] = static_cast<uint8_t*>(rec_cb);
    g.rec[2] = static_cast<uint8_t*>(rec_cr);
    g.coef[0] = static_cast<int16_t*>(coef_y);
    g.coef[1] = static_cast<int16_t*>(coef_cb);
    g.coef[2] = static_cast<int16_t*>(coef_cr);
    set_group(&g.grp[0], steps_y, n_steps_y, 8 * w8, 8 * h8, 1, qp_y, lam_y,
              a4_y, a8_y, a16_y, a32_y);
    set_group(&g.grp[1], steps_c, n_steps_c, 4 * w8, 4 * h8, 2, qp_c, lam_c,
              a4_c, a8_c, a16_c, a32_c);
    g.depth8 = static_cast<const int*>(depth8);
    g.modes4 = static_cast<const int*>(modes4);
    g.nxn8 = static_cast<const uint8_t*>(nxn8);
    g.t32 = static_cast<const int*>(t32);
    g.dst4 = static_cast<const int*>(dst4);
    g.nx = (w8 + 7) / 8;
    g.ny = (h8 + 7) / 8;
    g.w8 = w8;
    g.h8 = h8;
    g.rdoq = rdoq;
    g.z0 = z0;
    g.diag = 0;
    g.cy_lo = 0;
    if (n_steps_y > Shared<64>::ROWS || n_steps_c > Shared<32>::ROWS)
        return -1;                  // cudaErrorInvalidValue: not our tables
    if (F <= 0 || w8 <= 0 || h8 <= 0 || zc <= 0) return 0;
    return run_diagonals(g, F, zc, stream);
}
