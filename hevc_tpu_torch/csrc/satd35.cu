// satd35: Hadamard SATD of all 35 HEVC intra modes for a batch of nodes.
//
// Replaces the TPU kernel hevc_tpu/ops/intra_mm.py::_satd_all_modes_pallas
// (entry satd_all_modes). That kernel was shaped by a matrix unit: one
// dense [2(4n+1)+1, n*n] weight matmul per (node tile, mode), the
// Hadamard as a second matmul and the per-block sums as a third. None of
// that is wanted here. This kernel computes the same function in plain
// int32 arithmetic, so there is no float exactness question at all.
//
// Predictions are formed from the references by the rules of H.265
// 8.4.4.2.6 directly, with no table:
//
//   * angular modes 2..34: one displacement per row (vertical modes 18..34)
//     or per column (horizontal modes 2..17), p = (v + 1) * angle, split
//     into an offset i = p >> 5 and a fraction f = p & 31, both the same
//     for every lane. The mode's main reference m[k] (the top row for a
//     vertical mode, the left column for a horizontal one, k = 0 the
//     corner; for a negative angle extended to k < 0 by projecting the
//     other side with the inverse angle) is copied once per mode into a
//     per-warp column of shared memory, in ascending k. Then
//       pred[v][u] = ((32 - f) * m[u + i + 1] + f * m[u + i + 2] + 16) >> 5
//     (f == 0 gives m[u + i + 1] exactly), u along the main reference.
//     A horizontal mode is computed in that frame and is the transpose of
//     the picture block; the two-sided Hadamard's sum of absolutes does
//     not change under a transpose, and the block partition maps onto
//     itself. The edge column of VER / HOR (modes 26 / 10, luma, n < 32)
//     is clip(m[1] + ((side[v] - m[0]) >> 1)), the one clip;
//   * planar (mode 0) in its closed form;
//   * DC (mode 1) with the exact arithmetic of intra_mm._dc_block
//     (floored interior reused by the edge smoothing).
//
// Filtered or unfiltered references per mode follow the plain version's
// table (intra_mm._tables: intra.ref_filter_flag(mode, n), whatever the
// component); DC always reads the unfiltered ones.
//
//   d = pred - orig; two-sided k x k Hadamard per block (k = 4 if n == 4
//   else 8) as register butterflies; s = sum |t| per block;
//   (s + 2) >> 2 (k = 8) or (s + 1) >> 1 (k = 4) PER BLOCK, then the sum
//   over blocks -> out[b][m].
//
// Layout: a block owns 32 consecutive nodes and stages their refs and
// originals transposed in shared memory ([index][node], int16), so the 32
// lanes of a warp = 32 nodes read conflict-free. A warp walks one mode at a
// time (7 warps x 5 rounds = 35 modes); within a mode every lane runs the
// same (mode, row, column) sequence, so every branch is warp-uniform and a
// lane never reads another lane's column. Each lane keeps one k x k block
// of differences in registers, runs the butterflies there and accumulates
// the rounded block sums. The ragged last block is masked here (no padding
// by the wrapper).
//
// Bound on an H100 (per launch): bytes moved B*(2(4n+1) + n*n)*4 in and
// B*35*4 out over 3.35 TB/s; integer instructions, counted per mode (an
// angular sample with a fraction: two tap multiply-adds and one fused
// shift and difference; without one, or DC: the difference; planar: 4),
// plus per sample one add per butterfly stage (log2(k*k)), the absolute
// value and half an add (chip_smoke.satd_ops_per_node), over 33.5e12
// lane-instructions/s: a sub-partition issues one warp instruction per
// clock, and the compiler spreads the adds over the ALU pipe (IADD3, LEA)
// and the float32 pipe's integer half (IMAD, IMAD.IADD), 16 lanes each. At
// the encoder's shapes the instruction count is the larger of the two by
// an order of magnitude, so the kernel is bound by operations: what the
// design does about it is to keep every intermediate in registers, to
// read the taps at offsets fixed per row (neighbouring samples share
// one), and to compute the row's offset and fraction once.
//
// The same source builds without nvcc as plain C++ (the threads of a block
// become a loop before the one barrier, warps and lanes a loop after it),
// which is how the CPU tests hold this body against the plain version.

#include <stdlib.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define S35_DEVICE __device__ __forceinline__
#define S35_CONST __constant__
#define S35_UNROLL _Pragma("unroll")
#define S35_NO_UNROLL _Pragma("unroll 1")
#else
#define S35_DEVICE static inline
#define S35_CONST static const
#define S35_UNROLL
#define S35_NO_UNROLL
#endif

namespace {

constexpr int NODES = 32;            // nodes per block = lanes of a warp
constexpr int NWARPS = 7;            // 7 warps x 5 rounds = 35 modes
constexpr int THREADS = NODES * NWARPS;
constexpr int ERR_INVALID_VALUE = 1;  // cudaErrorInvalidValue

// H.265 Table 8-4 / 8-5: displacement angle of modes 2..34, inverse angle
// of modes 11..25
S35_CONST int ANGLE[33] = {32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13,
                           -17, -21, -26, -32, -26, -21, -17, -13, -9, -5,
                           -2, 0, 2, 5, 9, 13, 17, 21, 26, 32};
S35_CONST int INV_ANGLE[15] = {-4096, -1638, -910, -630, -482, -390, -315,
                               -256, -315, -390, -482, -630, -910, -1638,
                               -4096};

// Everything a block keeps in shared memory, for node size N.
template <int N>
struct Shared {
    static constexpr int R = 4 * N + 1;     // references per node
    static constexpr int EM = 3 * N + 2;    // main reference m[-N .. 2N+1]
    short ref[2 * R * NODES];               // [r_u | r_f index][node]
    short org[N * N * NODES];               // [pixel][node]
    short em[NWARPS][EM * NODES];           // per warp: [k + N][node]
};

// Resident blocks per SM the compiler plans registers for. Measured side
// by side on an H100 (1 to 8 blocks): at the benchmark's decide sub-batch
// sizes 4 blocks (72 registers, about 100 bytes of spills at n = 16) beat
// 3 (80, none) by 5% at n = 16 and 2% at n = 8; 6 or more spill
// kilobytes and run 4x slower there. n = 4 takes 38-51 registers at any
// budget up to 8 and is flat within 2%.
template <int N>
struct Budget {
    static constexpr int BLOCKS = (N == 4) ? 6 : 4;
};

// intra.ref_filter_flag for n = 4, 8, 16
S35_DEVICE bool filtered(int mode, int n) {
    if (mode == 1 || n == 4) return false;
    const int dh = abs(mode - 10), dv = abs(mode - 26);
    return (dh < dv ? dh : dv) > (n == 8 ? 7 : 1);
}

// In-register two-sided Hadamard of a K x K block + sum of absolutes.
template <int K>
S35_DEVICE int hadamard_abs_sum(int (&d)[K * K]) {
S35_UNROLL
    for (int len = 1; len < K; len <<= 1) {          // along a row
S35_UNROLL
        for (int i = 0; i < K * K; ++i) {
            if ((i & len) == 0) {
                const int a = d[i], b = d[i + len];
                d[i] = a + b;
                d[i + len] = a - b;
            }
        }
    }
S35_UNROLL
    for (int len = K; len < K * K; len <<= 1) {      // along a column
S35_UNROLL
        for (int i = 0; i < K * K; ++i) {
            if ((i & len) == 0) {
                const int a = d[i], b = d[i + len];
                d[i] = a + b;
                d[i + len] = a - b;
            }
        }
    }
    int s = 0;
S35_UNROLL
    for (int i = 0; i < K * K; ++i) s += abs(d[i]);
    return s;
}

template <int K>
S35_DEVICE int rounded(int s) {
    return (K == 8) ? ((s + 2) >> 2) : ((s + 1) >> 1);
}

// Copy the refs and originals of the block's nodes into shared memory,
// transposed; the part of thread `tid`. Nodes past the end hold zeros.
template <int N>
S35_DEVICE void stage(Shared<N>& sh, const int* r_u, const int* r_f,
                      const int* orig, long long node0, int n_here,
                      int tid) {
    constexpr int R = Shared<N>::R;
    for (int e = tid; e < NODES * R; e += THREADS) {
        const int nd = e / R, i = e - nd * R;
        short u = 0, f = 0;
        if (nd < n_here) {
            u = (short)r_u[node0 * R + e];
            f = (short)r_f[node0 * R + e];
        }
        sh.ref[i * NODES + nd] = u;
        sh.ref[(R + i) * NODES + nd] = f;
    }
    for (int e = tid; e < NODES * N * N; e += THREADS) {
        const int nd = e / (N * N), i = e - nd * (N * N);
        short o = 0;
        if (nd < n_here) o = (short)orig[node0 * (N * N) + e];
        sh.org[i * NODES + nd] = o;
    }
}

// DC, exact. `r`, `org`: this lane's columns (stride NODES), unfiltered.
template <int N, int K>
S35_DEVICE int satd_dc(const short* r, const short* org, int dc_edge) {
    constexpr int NB = N / K;
    constexpr int LOG2N = (N == 4) ? 2 : (N == 8) ? 3 : 4;
    // left[j] = r[2N-1-j], top[i] = r[2N+1+i]
    int sum = N;
S35_UNROLL
    for (int i = 0; i < N; ++i)
        sum += r[(2 * N - 1 - i) * NODES] + r[(2 * N + 1 + i) * NODES];
    const int dc = sum >> (LOG2N + 1);
    const int l0 = r[(2 * N - 1) * NODES];
    const int t0 = r[(2 * N + 1) * NODES];
    int total = 0;
S35_NO_UNROLL
    for (int blk = 0; blk < NB * NB; ++blk) {
        const int y0 = (blk / NB) * K, x0 = (blk % NB) * K;
        int d[K * K];
S35_UNROLL
        for (int i = 0; i < K; ++i) {
S35_UNROLL
            for (int j = 0; j < K; ++j) {
                const int y = y0 + i, x = x0 + j;
                int p = dc;
                if (dc_edge) {
                    if (y == 0 && x == 0)
                        p = (l0 + 2 * dc + t0 + 2) >> 2;
                    else if (y == 0)
                        p = (r[(2 * N + 1 + x) * NODES] + 3 * dc + 2) >> 2;
                    else if (x == 0)
                        p = (r[(2 * N - 1 - y) * NODES] + 3 * dc + 2) >> 2;
                }
                d[i * K + j] = p - org[(y * N + x) * NODES];
            }
        }
        total += rounded<K>(hadamard_abs_sum<K>(d));
    }
    return total;
}

// Planar, closed form. `r`: this lane's column of the mode's references.
template <int N, int K>
S35_DEVICE int satd_planar(const short* r, const short* org) {
    constexpr int NB = N / K;
    constexpr int LOG2N = (N == 4) ? 2 : (N == 8) ? 3 : 4;
    const int tr = r[(3 * N + 1) * NODES];     // top[N]
    const int bl = r[(N - 1) * NODES];         // left[N]
    int total = 0;
S35_NO_UNROLL
    for (int blk = 0; blk < NB * NB; ++blk) {
        const int y0 = (blk / NB) * K, x0 = (blk % NB) * K;
        int d[K * K];
S35_UNROLL
        for (int i = 0; i < K; ++i) {
            const int y = y0 + i;
            const int left = r[(2 * N - 1 - y) * NODES];
            const int row = (y + 1) * bl + N;
S35_UNROLL
            for (int j = 0; j < K; ++j) {
                const int x = x0 + j;
                const int p = ((N - 1 - x) * left + (x + 1) * tr
                               + (N - 1 - y) * r[(2 * N + 1 + x) * NODES]
                               + row) >> (LOG2N + 1);
                d[i * K + j] = p - org[(y * N + x) * NODES];
            }
        }
        total += rounded<K>(hadamard_abs_sum<K>(d));
    }
    return total;
}

// Angular mode, in the frame of its main reference: v across it (the
// picture's row for a vertical mode, its column for a horizontal one), u
// along it. `em`: this lane's column of the main reference, em[(k + N) *
// NODES] = m[k], filled by the caller. `edge`: VER / HOR edge smoothing.
template <int N, int K, bool VERT>
S35_DEVICE int satd_angular(const short* r, const short* em,
                            const short* org, int angle, bool edge) {
    constexpr int NB = N / K;
    int total = 0;
S35_NO_UNROLL
    for (int blk = 0; blk < NB * NB; ++blk) {
        const int v0 = (blk / NB) * K, u0 = (blk % NB) * K;
        int d[K * K];
S35_UNROLL
        for (int i = 0; i < K; ++i) {
            const int p = (v0 + i + 1) * angle;
            const int f = p & 31;
            const short* m = em + (u0 + (p >> 5) + 1 + N) * NODES;
S35_UNROLL
            for (int j = 0; j < K; ++j) {
                const int v = v0 + i, u = u0 + j;
                const int pred = ((32 - f) * m[j * NODES]
                                  + f * m[(j + 1) * NODES] + 16) >> 5;
                d[i * K + j] = pred - org[(VERT ? v * N + u : u * N + v)
                                          * NODES];
            }
        }
        if (edge && u0 == 0) {
            const int m1 = em[(N + 1) * NODES], corner = em[N * NODES];
S35_UNROLL
            for (int i = 0; i < K; ++i) {
                const int v = v0 + i;
                const int side = r[(VERT ? 2 * N - 1 - v : 2 * N + 1 + v)
                                   * NODES];
                int p = m1 + ((side - corner) >> 1);
                p = p < 0 ? 0 : (p > 255 ? 255 : p);
                d[i * K] = p - org[(VERT ? v * N : v) * NODES];
            }
        }
        total += rounded<K>(hadamard_abs_sum<K>(d));
    }
    return total;
}

// out[node][mode] of one lane: `lane` of warp `warp`.
template <int N>
S35_DEVICE int satd_mode(Shared<N>& sh, int warp, int lane, int mode,
                         int dc_edge) {
    constexpr int K = (N == 4) ? 4 : 8;
    constexpr int R = Shared<N>::R;
    const short* org = sh.org + lane;
    if (mode == 1) return satd_dc<N, K>(sh.ref + lane, org, dc_edge);
    const short* r = sh.ref + (filtered(mode, N) ? R * NODES : 0) + lane;
    if (mode == 0) return satd_planar<N, K>(r, org);

    const int angle = ANGLE[mode - 2];
    const bool vert = mode >= 18;
    short* em = sh.em[warp] + lane;
    // m[k], k = 0 .. 2N: the top row (r[2N + k]) or the left column
    // (r[2N - k]); k = 2N + 1 is read only with weight 0
S35_NO_UNROLL
    for (int k = 0; k <= 2 * N; ++k)
        em[(k + N) * NODES] = r[(vert ? 2 * N + k : 2 * N - k) * NODES];
    em[(3 * N + 1) * NODES] = em[3 * N * NODES];
    if (angle < 0) {
        // k = (N * angle) >> 5 .. -1: the other side, projected
        const int inv = INV_ANGLE[mode - 11];
S35_NO_UNROLL
        for (int k = (N * angle) >> 5; k < 0; ++k) {
            const int j = (k * inv + 128) >> 8;
            em[(k + N) * NODES] = r[(vert ? 2 * N - j : 2 * N + j) * NODES];
        }
    }
    const bool edge = dc_edge && angle == 0;
    return vert ? satd_angular<N, K, true>(r, em, org, angle, edge)
                : satd_angular<N, K, false>(r, em, org, angle, edge);
}

#ifdef __CUDACC__
template <int N>
__global__ void __launch_bounds__(THREADS, Budget<N>::BLOCKS)
satd35_kernel(const int* __restrict__ r_u, const int* __restrict__ r_f,
              const int* __restrict__ orig, int* __restrict__ out, int B,
              int dc_edge) {
    __shared__ Shared<N> sh;
    const long long node0 = (long long)blockIdx.x * NODES;
    const int n_here = (int)min((long long)NODES, (long long)B - node0);
    stage<N>(sh, r_u, r_f, orig, node0, n_here, (int)threadIdx.x);
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int mode = warp; mode < 35; mode += NWARPS) {
        const int total = satd_mode<N>(sh, warp, lane, mode, dc_edge);
        if (lane < n_here) out[(node0 + lane) * 35 + mode] = total;
    }
}

template <int N>
int launch(const int* r_u, const int* r_f, const int* orig, int* out, int B,
           int dc_edge, void* stream) {
    const int blocks = (B + NODES - 1) / NODES;
    satd35_kernel<N><<<blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        r_u, r_f, orig, out, B, dc_edge);
    return (int)cudaGetLastError();
}
#else
// The same blocks one after the other on the host: every thread's part of
// the staging, then every (warp, lane) of the block.
template <int N>
int launch(const int* r_u, const int* r_f, const int* orig, int* out, int B,
           int dc_edge, void*) {
    Shared<N>* sh = new Shared<N>;
    for (long long node0 = 0; node0 < B; node0 += NODES) {
        const int n_here = (int)(B - node0 < NODES ? B - node0 : NODES);
        for (int tid = 0; tid < THREADS; ++tid)
            stage<N>(*sh, r_u, r_f, orig, node0, n_here, tid);
        for (int warp = 0; warp < NWARPS; ++warp)
            for (int lane = 0; lane < n_here; ++lane)
                for (int mode = warp; mode < 35; mode += NWARPS)
                    out[(node0 + lane) * 35 + mode] =
                        satd_mode<N>(*sh, warp, lane, mode, dc_edge);
    }
    delete sh;
    return 0;
}
#endif

}  // namespace

// r_u, r_f: [B, 4n+1] int32; orig: [B, n, n] int32; out: [B, 35] int32.
// Launches on `stream`, does not synchronise, allocates nothing. Returns
// cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for an n it does
// not take. Built for the host, it computes `out` before it returns.
extern "C" int satd35_launch(const void* r_u, const void* r_f,
                             const void* orig, void* out, int B, int n,
                             int dc_edge, void* stream) {
    const int* ru = static_cast<const int*>(r_u);
    const int* rf = static_cast<const int*>(r_f);
    const int* og = static_cast<const int*>(orig);
    int* o = static_cast<int*>(out);
    if (B <= 0) return 0;
    switch (n) {
        case 4:  return launch<4>(ru, rf, og, o, B, dc_edge, stream);
        case 8:  return launch<8>(ru, rf, og, o, B, dc_edge, stream);
        case 16: return launch<16>(ru, rf, og, o, B, dc_edge, stream);
        default: return ERR_INVALID_VALUE;
    }
}
