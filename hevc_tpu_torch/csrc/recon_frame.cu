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
//     is a grid (CTUs of the diagonal, F frames, planes): luma launches have
//     one plane, chroma launches two (Cb, Cr). Luma and chroma never read
//     each other;
//   * a thread block codes one CTU of one plane of ONE frame, so depth,
//     NxN flag and mode are uniform over the block: it walks the static
//     step table (344 luma / 176 chroma rows, depth-first = coding order),
//     SKIPS every row that is not a leaf of this CTU's quadtree, and
//     predicts the one mode the TU has;
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
// Per leaf TU of size n the block runs, with __syncthreads() between the
// steps and all state in shared memory: gather the 4n+1 reference samples
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
// microseconds at 3.35 TB/s, and the arithmetic (4n multiply-adds per
// sample for the four transform stages plus prediction and quantisation) is
// tens of microseconds at the int32 rate. Neither binds a single frame:
// the dependency does. 62 diagonals at 1080p run one after the other, and
// inside a CTU the TUs run one after the other, so the time is
// diagonals x (longest TU chain of a CTU) x (time of one TU step), with at
// most 15 x F x planes blocks on 132 SMs. The design answers with the
// frame batch (F frames fill the card F times better at the same latency),
// with skipping non-leaf rows, and with skipping the inverse transform of
// all-zero TUs.
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
// one parallel step of the block: the body runs once per thread
#define RF_THREADS { const int tid = (int)threadIdx.x;
#define RF_SYNC } __syncthreads();
#define RF_FMUL(a, b) __fmul_rn((a), (b))
#define RF_FADD(a, b) __fadd_rn((a), (b))
#define RF_FSUB(a, b) __fsub_rn((a), (b))
#else
#define RF_DEVICE static inline
#define RF_CONST static const
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

struct Args {
    const uint8_t* orig[2];     // [F, H, W] per plane (component size)
    uint8_t* rec[2];            // [F, H, W]
    int16_t* coef[2];           // [F, H, W]
    const int* depth8;          // [F, h8, w8]
    const int* modes4;          // [F, 2 * h8, 2 * w8]
    const uint8_t* nxn8;        // [F, h8, w8]
    const int* steps;           // [n_steps, 8]
    const int* t32;             // [32, 32] DCT matrix
    const int* dst4;            // [4, 4] DST matrix
    int n_steps;
    int nx, ny;                 // CTUs per row / column
    int W, H;                   // coded size of the component
    int w8, h8;                 // coded luma size in 8x8 units
    int scale;                  // 1 luma, 2 chroma (4:2:0)
    int luma, qp, rdoq;
    float lam;
    float alpha[4];             // by log2(n) - 2
    int diag, cy_lo;
};

template <int S>
struct Shared {
    static constexpr int NMAX = S / 2;          // largest TU of the plane
    static constexpr int RMAX = 4 * NMAX + 1;
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
    int dc;
    int any;
    uint8_t avail[RMAX + 3];
    uint8_t tile[S * S];
    uint8_t top[2 * S + 1 + 3];
    uint8_t left[S];
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

// index into the linear reference array r[0..4n] of entry k of the
// extended main reference of an angular mode (k < 0: projected side
// samples)
RF_DEVICE int main_ref(int k, int n2, bool vert, int mode) {
    if (k >= 0) return vert ? n2 + k : n2 - k;
    const int j = ((k * INV_ANGLE[mode - 11] + 128) >> 8) - 1;
    return vert ? n2 - 1 - j : n2 + 1 + j;
}

// one predicted sample. r: substituted (and, where the mode asks, filtered)
// references: left[j] = r[2n-1-j], corner = r[2n], top[i] = r[2n+1+i].
// edge: luma and n < 32 (DC / VER / HOR boundary smoothing).
RF_DEVICE int predict_sample(const int* r, int mode, int n, int log2n, int x,
                             int y, bool edge, int dc) {
    const int n2 = 2 * n;
    if (mode == 0)
        return ((n - 1 - x) * r[n2 - 1 - y] + (x + 1) * r[n2 + 1 + n]
                + (n - 1 - y) * r[n2 + 1 + x] + (y + 1) * r[n2 - 1 - n]
                + n) >> (log2n + 1);
    if (mode == 1) {
        if (!edge) return dc;
        if (x == 0 && y == 0) return (r[n2 - 1] + 2 * dc + r[n2 + 1] + 2) >> 2;
        if (y == 0) return (r[n2 + 1 + x] + 3 * dc + 2) >> 2;
        if (x == 0) return (r[n2 - 1 - y] + 3 * dc + 2) >> 2;
        return dc;
    }
    if (edge) {
        if (mode == 26 && x == 0)
            return clip3(0, 255, r[n2 + 1] + ((r[n2 - 1 - y] - r[n2]) >> 1));
        if (mode == 10 && y == 0)
            return clip3(0, 255, r[n2 - 1] + ((r[n2 + 1 + x] - r[n2]) >> 1));
    }
    const bool vert = mode >= 18;
    const int u = vert ? x : y;            // along the main reference
    const int v = vert ? y : x;            // distance from it
    const int t = (v + 1) * ANGLE[mode - 2];
    const int fact = t & 31;
    const int k1 = u + (t >> 5) + 1;
    const int ia = main_ref(k1, n2, vert, mode);
    const int ib = fact ? main_ref(k1 + 1, n2, vert, mode) : ia;
    return ((32 - fact) * r[ia] + fact * r[ib] + 16) >> 5;
}

RF_DEVICE bool ref_filter_flag(int mode, int n) {
    if (mode == 1 || n == 4) return false;
    const int dh = mode > 10 ? mode - 10 : 10 - mode;
    const int dv = mode > 26 ? mode - 26 : 26 - mode;
    const int thres = n == 8 ? 7 : (n == 16 ? 1 : 0);
    return (dh < dv ? dh : dv) > thres;
}

// Code one leaf TU of size n at (x0, y0) of the CTU at (ox, oy).
template <int S>
RF_DEVICE void code_tu(const Args& g, Shared<S>& sh, const uint8_t* orig,
                       int16_t* coef, int ox, int oy, int x0, int y0, int n,
                       bool dst, int mode) {
    const int log2n = n == 4 ? 2 : (n == 8 ? 3 : (n == 16 ? 4 : 5));
    const int R = 4 * n + 1;
    const int n2 = n * n;
    const int gx0 = ox + x0, gy0 = oy + y0;
    const bool use_f = g.luma && ref_filter_flag(mode, n);
    const bool edge = g.luma && n < 32;
    const int tstride = 33 * (32 / n);     // row k of the n-point DCT is
                                           // row k * 32 / n of the 32-point

    // 1. references and their availability
    RF_THREADS
        if (tid == 0) sh.any = 0;
        if (tid < R) {
            const int i = tid;
            const int dx = i <= 2 * n ? -1 : i - 2 * n - 1;
            const int dy = i < 2 * n ? 2 * n - 1 - i : -1;
            const int gx = gx0 + dx, gy = gy0 + dy;
            const bool inside = gx >= 0 && gy >= 0 && gx < g.W && gy < g.H;
            const int zcur = zaddr(gx0 * g.scale, gy0 * g.scale, g.nx);
            const int zref = zaddr((gx < 0 ? 0 : gx) * g.scale,
                                   (gy < 0 ? 0 : gy) * g.scale, g.nx);
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
        if (tid < 5) {
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
            int w = tid >> 5;
            unsigned m = sh.avail_bits[w] & (0xFFFFFFFFu >> (31 - (tid & 31)));
            int src = -1;
            for (;;) {
                if (m) { src = w * 32 + high_bit(m); break; }
                if (--w < 0) break;
                m = sh.avail_bits[w];
            }
            if (src < 0) {
                for (w = 0; w < 5; ++w) {
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
            int sum = n;
            for (int i = 0; i < n; ++i)
                sum += sh.ref_s[2 * n + 1 + i] + sh.ref_s[2 * n - 1 - i];
            sh.dc = sum >> (log2n + 1);
        }
    RF_SYNC
    // 4. prediction and residual
    RF_THREADS
        const int* r = use_f ? sh.ref_f : sh.ref_s;
        const int dc = sh.dc;
        for (int p = tid; p < n2; p += NT) {
            const int y = p >> log2n, x = p & (n - 1);
            const int pr = predict_sample(r, mode, n, log2n, x, y, edge, dc);
            const int o = orig[(long long)(gy0 + y) * g.W + gx0 + x];
            sh.pred[p] = pr;
            sh.a[p] = o - pr;
        }
    RF_SYNC
    // 5. forward transform: columns (shift log2n - 1), then rows
    // (shift log2n + 6)
    RF_THREADS
        const int s1 = log2n - 1;
        for (int p = tid; p < n2; p += NT) {
            const int k = p >> log2n, j = p & (n - 1);
            const int* row = dst ? sh.dst4 + k * 4 : sh.t32 + k * tstride;
            int acc = 0;
            for (int i = 0; i < n; ++i) acc += row[i] * sh.a[i * n + j];
            sh.b[p] = (acc + (1 << (s1 - 1))) >> s1;
        }
    RF_SYNC
    RF_THREADS
        const int s2 = log2n + 6;
        for (int p = tid; p < n2; p += NT) {
            const int k = p >> log2n, l = p & (n - 1);
            const int* row = dst ? sh.dst4 + l * 4 : sh.t32 + l * tstride;
            int acc = 0;
            for (int j = 0; j < n; ++j) acc += sh.b[k * n + j] * row[j];
            sh.a[p] = (acc + (1 << (s2 - 1))) >> s2;
        }
    RF_SYNC
    // 6. quantisation
    const int qbits = 21 + g.qp / 6 - log2n;
    const int qscale = QUANT_SCALE[g.qp % 6];
    const int inv_scale = INV_QUANT_SCALE[g.qp % 6] << (g.qp / 6);
    const int dshift = log2n - 1;
    const bool cg_zero = g.rdoq && n >= 8;
    if (g.rdoq) {
        const float al = g.alpha[log2n - 2];
        const float lam = g.lam;
        RF_THREADS
            for (int p = tid; p < n2; p += NT) {
                const int c = sh.a[p];
                const int ac = c < 0 ? -c : c;
                int hi = (ac * qscale + (1 << (qbits - 1))) >> qbits;
                if (hi > 32767) hi = 32767;
                const int lo = hi > 0 ? hi - 1 : 0;
                float cost[3];
                const int cand[3] = {hi, lo, 0};
                for (int t = 0; t < 3; ++t) {
                    const float e =
                        (float)(ac - dequant(cand[t], inv_scale, dshift));
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
                const int gn = n >> 2;
                if (tid < gn * gn) {
                    const int by = (tid / gn) * 4, bx = (tid % gn) * 4;
                    float keep = 0.0f, zero = 0.0f;
                    for (int dy = 0; dy < 4; ++dy) {
                        const int q = (by + dy) * n + bx;
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
        const int gn = n >> 2;
        const int add = 171 << (qbits - 9);
        for (int p = tid; p < n2; p += NT) {
            const int y = p >> log2n, x = p & (n - 1);
            const int c = sh.a[p];
            int lv;
            if (g.rdoq) {
                lv = sh.b[p];
                if (cg_zero && sh.zcg[(y >> 2) * gn + (x >> 2)]) lv = 0;
            } else {
                const int ac = c < 0 ? -c : c;
                lv = (ac * qscale + add) >> qbits;
                if (lv > 32767) lv = 32767;
            }
            if (c < 0) lv = -lv;
            coef[(long long)(gy0 + y) * g.W + gx0 + x] = (int16_t)lv;
            if (lv != 0) sh.any = 1;
            sh.a[p] = dequant(lv, inv_scale, dshift);
        }
    RF_SYNC
    // 8. inverse transform (columns, clip, rows, clip) and reconstruction
    if (sh.any) {
        RF_THREADS
            for (int p = tid; p < n2; p += NT) {
                const int i = p >> log2n, j = p & (n - 1);
                int acc = 0;
                for (int k = 0; k < n; ++k) {
                    const int t = dst ? sh.dst4[k * 4 + i]
                                      : sh.t32[k * tstride + i];
                    acc += t * sh.a[k * n + j];
                }
                sh.b[p] = clip3(-32768, 32767, (acc + 64) >> 7);
            }
        RF_SYNC
        RF_THREADS
            for (int p = tid; p < n2; p += NT) {
                const int i = p >> log2n, j = p & (n - 1);
                int acc = 0;
                for (int l = 0; l < n; ++l) {
                    const int t = dst ? sh.dst4[l * 4 + j]
                                      : sh.t32[l * tstride + j];
                    acc += sh.b[i * n + l] * t;
                }
                const int res = clip3(-32768, 32767, (acc + 2048) >> 12);
                sh.tile[(y0 + i) * S + x0 + j] =
                    (uint8_t)clip3(0, 255, sh.pred[p] + res);
            }
        RF_SYNC
    } else {
        RF_THREADS
            for (int p = tid; p < n2; p += NT) {
                const int i = p >> log2n, j = p & (n - 1);
                sh.tile[(y0 + i) * S + x0 + j] = (uint8_t)sh.pred[p];
            }
        RF_SYNC
    }
}

// Code one CTU (plane `plane` of frame `f`, CTU number `lane` of the
// diagonal g.diag).
template <int S>
RF_DEVICE void code_ctu(const Args& g, Shared<S>& sh, int lane, int f,
                        int plane) {
    const int cy = g.cy_lo + lane, cx = g.diag - 2 * cy;
    const int ox = cx * S, oy = cy * S;
    const long long poff = (long long)f * g.H * g.W;
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
            sh.top[i] = (y >= 0 && x >= 0 && x < g.W)
                ? rec[(long long)y * g.W + x] : 0;
        }
        if (tid < S) {
            const int x = ox - 1, y = oy + tid;
            sh.left[tid] = (x >= 0 && y < g.H)
                ? rec[(long long)y * g.W + x] : 0;
        }
    RF_SYNC

    for (int s = 0; s < g.n_steps; ++s) {
        const int* st = g.steps + s * 8;
        const int cls = st[0];
        const int n8 = st[4] * 8 + st[3];
        if (sh.d8[n8] != st[5]) continue;          // not a leaf at this depth
        int n;
        if (g.luma) {
            if (cls == 2 && sh.nxn[n8]) continue;  // coded as four 4x4 below
            if (cls == 3 && !sh.nxn[n8]) continue;
            n = 32 >> cls;
        } else {
            n = 16 >> cls;
        }
        code_tu<S>(g, sh, orig, coef, ox, oy, st[1], st[2], n,
                   g.luma && cls == 3, sh.m4[st[7] * 16 + st[6]]);
    }

    // the part of the tile that lies inside the coded frame
    RF_THREADS
        const int hh = g.H - oy < S ? g.H - oy : S;
        const int ww = g.W - ox < S ? g.W - ox : S;
        for (int p = tid; p < S * S; p += NT) {
            const int y = p / S, x = p % S;
            if (y < hh && x < ww)
                rec[(long long)(oy + y) * g.W + ox + x] = sh.tile[p];
        }
    RF_SYNC
}

// CTU rows cy_lo..cy_hi that diagonal d = cx + 2 * cy crosses
inline void diag_range(int d, int nx, int ny, int* cy_lo, int* cy_hi) {
    *cy_lo = d >= nx ? (d - nx + 2) / 2 : 0;
    *cy_hi = d / 2 < ny - 1 ? d / 2 : ny - 1;
}

#ifdef __CUDACC__
template <int S>
__global__ void __launch_bounds__(NT) recon_ctu_kernel(const Args g) {
    __shared__ Shared<S> sh;
    code_ctu<S>(g, sh, (int)blockIdx.x, (int)blockIdx.y, (int)blockIdx.z);
}
#endif

template <int S>
int run_diagonals(Args g, int F, void* stream) {
    const int planes = g.luma ? 1 : 2;
    const int n_diag = g.nx + 2 * (g.ny - 1);
#ifndef __CUDACC__
    Shared<S>* sh = new Shared<S>;
#endif
    for (int d = 0; d < n_diag; ++d) {
        int cy_hi;
        g.diag = d;
        diag_range(d, g.nx, g.ny, &g.cy_lo, &cy_hi);
        const int lanes = cy_hi - g.cy_lo + 1;
        if (lanes <= 0) continue;
#ifdef __CUDACC__
        recon_ctu_kernel<S><<<dim3(lanes, F, planes), NT, 0,
                              static_cast<cudaStream_t>(stream)>>>(g);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
#else
        (void)stream;
        for (int lane = 0; lane < lanes; ++lane)
            for (int f = 0; f < F; ++f)
                for (int p = 0; p < planes; ++p)
                    code_ctu<S>(g, *sh, lane, f, p);
#endif
    }
#ifndef __CUDACC__
    delete sh;
#endif
    return 0;
}

}  // namespace

// One component group (luma: one plane; chroma: Cb and Cr) of F frames:
// one launch per wavefront diagonal, nx + 2 * (ny - 1) launches in all, on
// `stream`; does not synchronise, allocates nothing. orig*/rec*/coef*:
// [F, H, W] uint8 / uint8 / int16 planes of the component (plane 1 is read
// for chroma only); depth8 [F, h8, w8] int32, modes4 [F, 2*h8, 2*w8] int32,
// nxn8 [F, h8, w8] uint8; steps [n_steps, 8] int32 (cls, tux, tuy, n8x,
// n8y, depth, m4x, m4y); t32 [32, 32], dst4 [4, 4] int32. rec* must be
// zero-filled or hold earlier output: samples outside the frame are never
// read. qp is the component's QP, lam / alpha* the float32 RDOQ constants.
// Returns cudaGetLastError() of the first launch that failed (0 = ok).
extern "C" int recon_frame_launch(
        const void* orig0, const void* orig1, void* rec0, void* rec1,
        void* coef0, void* coef1, const void* depth8, const void* modes4,
        const void* nxn8, const void* steps, int n_steps, const void* t32,
        const void* dst4, int F, int W, int H, int w8, int h8, int luma,
        int qp, int rdoq, float lam, float alpha4, float alpha8,
        float alpha16, float alpha32, void* stream) {
    Args g;
    g.orig[0] = static_cast<const uint8_t*>(orig0);
    g.orig[1] = static_cast<const uint8_t*>(orig1);
    g.rec[0] = static_cast<uint8_t*>(rec0);
    g.rec[1] = static_cast<uint8_t*>(rec1);
    g.coef[0] = static_cast<int16_t*>(coef0);
    g.coef[1] = static_cast<int16_t*>(coef1);
    g.depth8 = static_cast<const int*>(depth8);
    g.modes4 = static_cast<const int*>(modes4);
    g.nxn8 = static_cast<const uint8_t*>(nxn8);
    g.steps = static_cast<const int*>(steps);
    g.t32 = static_cast<const int*>(t32);
    g.dst4 = static_cast<const int*>(dst4);
    g.n_steps = n_steps;
    g.nx = (w8 + 7) / 8;
    g.ny = (h8 + 7) / 8;
    g.W = W;
    g.H = H;
    g.w8 = w8;
    g.h8 = h8;
    g.scale = luma ? 1 : 2;
    g.luma = luma;
    g.qp = qp;
    g.rdoq = rdoq;
    g.lam = lam;
    g.alpha[0] = alpha4;
    g.alpha[1] = alpha8;
    g.alpha[2] = alpha16;
    g.alpha[3] = alpha32;
    g.diag = 0;
    g.cy_lo = 0;
    if (F <= 0 || W <= 0 || H <= 0) return 0;
    return luma ? run_diagonals<64>(g, F, stream)
                : run_diagonals<32>(g, F, stream);
}
