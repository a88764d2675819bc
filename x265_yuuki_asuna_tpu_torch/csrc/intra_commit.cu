// The quadtree intra commit, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference commits with XLA (the wavefront
// scan of x265_yuuki_asuna_tpu/models/qt_common.py), and the port's
// batched commit (models/qt_common.py commit_intra) ran it as one chain
// of ~45 small PyTorch ops per (wavefront diagonal, z-order position):
// up to 126 x 21 chains a 1080p frame, launch-bound on the host. This
// kernel does the same integer work in one launch per CTU wavefront
// diagonal.
//
// One launch: the CTUs (r, c) of one diagonal d = 2r + c, one CTA each.
// The CTA walks its CTU's 21 z-order positions (the CTU, its four 16x16
// blocks, each followed by its four 8x8 blocks) and commits the intra
// leaves of the per-CTU leaf table (the mode, or -1), in z-order, so each
// leaf reads the recon of the z-earlier leaves of its CTU and of the
// CTUs of earlier diagonals (earlier launches on the stream). Three
// thread groups run the three planes of a leaf side by side, luma (128
// threads) and 4:2:0 Cb and Cr (64 each), through the same phases, a
// __syncthreads() between phases:
//   A  reference samples from the recon plane, with the availability of
//      the spec's z-order rules and CTU-edge flags (block_v), and the
//      substitution of unavailable samples (8.4.4.2.2);
//   B  the [1 2 1] smoothing where the mode asks for it (luma), DC's
//      value;
//   C  the prediction of the one mode (planar, DC, angular; DC / H / V
//      edge filters for luma below 32x32) and the residual;
//   D  forward DCT rows, E  columns, then the plain rounding quant;
//   F  sign-bit hiding under the mode-dependent scan (when on);
//   G  dequant and the inverse columns (int16 clip), the levels written;
//   H  the inverse rows (int16 clip), prediction + residual clamped to
//      the peak, the recon written.
// The arithmetic is the batched path's, integer for integer: the
// transforms' float64 products there are exact integer sums, the quant
// and dequant are int32 with wrap-around, as torch's int32 ops are.
// Blocks live in shared memory with a row stride of n + 1 (no bank
// conflicts on column walks); the DCT matrix is copied there from
// constant memory once per CTA. The DCT, angle and inverse-angle tables,
// quant scales and the 4x4 scan orders are __constant__: nothing is
// uploaded per call but the frame's leaf table.
//
// Bound on an H100 SXM: a 1080p frame with every leaf intra reads the
// source and reference samples and writes rec and levels, 4 bytes a
// sample: about 1088 x 1920 x 1.5 x (4 + 8) = 38 MB, 11 us at 3.35 TB/s;
// the integer work (four n-point transform passes, ~4 x 32 x 3.1 M
// multiply-adds) is well under that on 132 SMs. What bounds it is the
// chain: 126 dependent launches at 1080p, each as long as its slowest
// CTU (at most 16 8x8 luma leaves, each with two 4x4 chroma leaves, one
// after another, ~8 phases each), with at most 34 CTAs on the card. So
// a frame costs about 126 x (launch gap + a CTU's leaves).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o build/libintra_commit.so csrc/intra_commit.cu
// Interface: plain C, driven through ctypes (ops/kernels/intra_commit.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CTU = 32;                   // luma CTU size
constexpr int NZ = 21;                    // z-order positions of a CTU
constexpr int LUMA_THREADS = 128;
constexpr int CHROMA_THREADS = 64;        // each of Cb and Cr
constexpr int THREADS = LUMA_THREADS + 2 * CHROMA_THREADS;
constexpr int DS = 33;                    // row stride of the DCT copy
constexpr int LUMA_BLK = 32 * 33;         // a padded 32x32 block
constexpr int CHROMA_BLK = 16 * 17;       // a padded 16x16 block

// The 32-point HEVC DCT matrix (H.265 8.6.4.2); the n-point matrix is
// rows 0, 32/n, 2*32/n, ... of it, first n columns.
__constant__ signed char kDct[32][32] = {
    {64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64,
     64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64},
    {90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4, -4, -13,
     -22, -31, -38, -46, -54, -61, -67, -73, -78, -82, -85, -88, -90, -90},
    {90, 87, 80, 70, 57, 43, 25, 9, -9, -25, -43, -57, -70, -80, -87, -90,
     -90, -87, -80, -70, -57, -43, -25, -9, 9, 25, 43, 57, 70, 80, 87, 90},
    {90, 82, 67, 46, 22, -4, -31, -54, -73, -85, -90, -88, -78, -61, -38, -13,
     13, 38, 61, 78, 88, 90, 85, 73, 54, 31, 4, -22, -46, -67, -82, -90},
    {89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89,
     89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89},
    {88, 67, 31, -13, -54, -82, -90, -78, -46, -4, 38, 73, 90, 85, 61, 22,
     -22, -61, -85, -90, -73, -38, 4, 46, 78, 90, 82, 54, 13, -31, -67, -88},
    {87, 57, 9, -43, -80, -90, -70, -25, 25, 70, 90, 80, 43, -9, -57, -87,
     -87, -57, -9, 43, 80, 90, 70, 25, -25, -70, -90, -80, -43, 9, 57, 87},
    {85, 46, -13, -67, -90, -73, -22, 38, 82, 88, 54, -4, -61, -90, -78, -31,
     31, 78, 90, 61, 4, -54, -88, -82, -38, 22, 73, 90, 67, 13, -46, -85},
    {83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83,
     83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83},
    {82, 22, -54, -90, -61, 13, 78, 85, 31, -46, -90, -67, 4, 73, 88, 38, -38,
     -88, -73, -4, 67, 90, 46, -31, -85, -78, -13, 61, 90, 54, -22, -82},
    {80, 9, -70, -87, -25, 57, 90, 43, -43, -90, -57, 25, 87, 70, -9, -80,
     -80, -9, 70, 87, 25, -57, -90, -43, 43, 90, 57, -25, -87, -70, 9, 80},
    {78, -4, -82, -73, 13, 85, 67, -22, -88, -61, 31, 90, 54, -38, -90, -46,
     46, 90, 38, -54, -90, -31, 61, 88, 22, -67, -85, -13, 73, 82, 4, -78},
    {75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75,
     75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75},
    {73, -31, -90, -22, 78, 67, -38, -90, -13, 82, 61, -46, -88, -4, 85, 54,
     -54, -85, 4, 88, 46, -61, -82, 13, 90, 38, -67, -78, 22, 90, 31, -73},
    {70, -43, -87, 9, 90, 25, -80, -57, 57, 80, -25, -90, -9, 87, 43, -70,
     -70, 43, 87, -9, -90, -25, 80, 57, -57, -80, 25, 90, 9, -87, -43, 70},
    {67, -54, -78, 38, 85, -22, -90, 4, 90, 13, -88, -31, 82, 46, -73, -61,
     61, 73, -46, -82, 31, 88, -13, -90, -4, 90, 22, -85, -38, 78, 54, -67},
    {64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64,
     64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64},
    {61, -73, -46, 82, 31, -88, -13, 90, -4, -90, 22, 85, -38, -78, 54, 67,
     -67, -54, 78, 38, -85, -22, 90, 4, -90, 13, 88, -31, -82, 46, 73, -61},
    {57, -80, -25, 90, -9, -87, 43, 70, -70, -43, 87, 9, -90, 25, 80, -57,
     -57, 80, 25, -90, 9, 87, -43, -70, 70, 43, -87, -9, 90, -25, -80, 57},
    {54, -85, -4, 88, -46, -61, 82, 13, -90, 38, 67, -78, -22, 90, -31, -73,
     73, 31, -90, 22, 78, -67, -38, 90, -13, -82, 61, 46, -88, 4, 85, -54},
    {50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50,
     50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50},
    {46, -90, 38, 54, -90, 31, 61, -88, 22, 67, -85, 13, 73, -82, 4, 78, -78,
     -4, 82, -73, -13, 85, -67, -22, 88, -61, -31, 90, -54, -38, 90, -46},
    {43, -90, 57, 25, -87, 70, 9, -80, 80, -9, -70, 87, -25, -57, 90, -43,
     -43, 90, -57, -25, 87, -70, -9, 80, -80, 9, 70, -87, 25, 57, -90, 43},
    {38, -88, 73, -4, -67, 90, -46, -31, 85, -78, 13, 61, -90, 54, 22, -82,
     82, -22, -54, 90, -61, -13, 78, -85, 31, 46, -90, 67, 4, -73, 88, -38},
    {36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36,
     36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36},
    {31, -78, 90, -61, 4, 54, -88, 82, -38, -22, 73, -90, 67, -13, -46, 85,
     -85, 46, 13, -67, 90, -73, 22, 38, -82, 88, -54, -4, 61, -90, 78, -31},
    {25, -70, 90, -80, 43, 9, -57, 87, -87, 57, -9, -43, 80, -90, 70, -25,
     -25, 70, -90, 80, -43, -9, 57, -87, 87, -57, 9, 43, -80, 90, -70, 25},
    {22, -61, 85, -90, 73, -38, -4, 46, -78, 90, -82, 54, -13, -31, 67, -88,
     88, -67, 31, 13, -54, 82, -90, 78, -46, 4, 38, -73, 90, -85, 61, -22},
    {18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18,
     18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18},
    {13, -38, 61, -78, 88, -90, 85, -73, 54, -31, 4, 22, -46, 67, -82, 90,
     -90, 82, -67, 46, -22, -4, 31, -54, 73, -85, 90, -88, 78, -61, 38, -13},
    {9, -25, 43, -57, 70, -80, 87, -90, 90, -87, 80, -70, 57, -43, 25, -9, -9,
     25, -43, 57, -70, 80, -87, 90, -90, 87, -80, 70, -57, 43, -25, 9},
    {4, -13, 22, -31, 38, -46, 54, -61, 67, -73, 78, -82, 85, -88, 90, -90,
     90, -90, 88, -85, 82, -78, 73, -67, 61, -54, 46, -38, 31, -22, 13, -4},
};

// intraPredAngle of modes 2..34 (table 8-5) and invAngle of the negative
// angles (table 8-6; 0 where a mode never projects)
__constant__ int kAngle[33] = {
    32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
    -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32};
__constant__ int kInvAngle[33] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, -4096, -1638, -910, -630, -482, -390, -315,
    -256, -315, -390, -482, -630, -910, -1638, -4096, 0, 0, 0, 0, 0, 0, 0,
    0, 0};
// the filterFlag threshold of luma 8x8, 16x16 and 32x32 (8.4.4.2.3)
__constant__ int kFilterThresh[3] = {7, 1, 0};
__constant__ int kQuantScale[6] = {26214, 23302, 20560, 18396, 16384, 14564};
__constant__ int kInvQuantScale[6] = {40, 45, 51, 57, 64, 72};
// raster positions of a 4x4 group in scan order: diagonal, horizontal,
// vertical (6.5.3-6.5.5)
__constant__ unsigned char kScan4[3][16] = {
    {0, 4, 1, 8, 5, 2, 12, 9, 6, 3, 13, 10, 7, 14, 11, 15},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15}};

struct Args {
    const int* table;                     // [ncu, NZ] modes, -1: no leaf
    const int* qp_y;                      // [ncu] signalled luma QPs
    const int* qp_c;                      // [ncu] chroma QPs
    const int* src[3];                    // source planes (Y, Cb, Cr)
    int* rec[3];                          // recon planes, read and written
    int* lv[3];                           // level planes, written
    int width, cols, bit_depth, intra_slice, sbh;
};

// One plane's share of a CTA: its planes, geometry, threads and shared
// buffers.
struct Part {
    const int* src;
    int* rec;
    int* lv;
    int width, ctu, tid, nth;
    bool luma;
    int *v, *vf, *pred, *res, *tmp, *du, *dc;
};

__shared__ int s_dct[32 * DS];

__device__ __forceinline__ int clamp16(int x) {
    return min(max(x, -32768), 32767);
}

// int32 arithmetic with wrap-around (torch's int32 ops)
__device__ __forceinline__ int wmul(int a, int b) {
    return (int)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int wadd(int a, int b) {
    return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
    return (int)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int wshl(int a, int s) {
    return (int)((uint32_t)a << s);
}

__device__ __forceinline__ int morton(int y, int x) {
    int z = 0;
    for (int b = 0; b < 3; ++b)           // coordinates < 8 in a CTU
        z |= ((x >> b) & 1) << (2 * b) | ((y >> b) & 1) << (2 * b + 1);
    return z;
}

// Availability of the five reference segments of the n-block at (y0, x0)
// of CTU (r, c), CTUs of `ctu` samples (qt_common.block_v): below-left,
// left, corner, top, top-right.
__device__ void availability(bool av[5], int r, int c, int cols, int y0,
                             int x0, int n, int ctu) {
    const bool al = c > 0, at = r > 0, atr = r > 0 && c < cols - 1,
               atl = r > 0 && c > 0;
    const bool below_in = y0 + 2 * n <= ctu, right_in = x0 + 2 * n <= ctu;
    const int z = morton(y0 / n, x0 / n);
    av[0] = x0 == 0 ? below_in && al
                    : below_in && morton((y0 + n) / n, (x0 - 1) / n) < z;
    av[1] = x0 == 0 ? al : true;
    av[2] = y0 == 0 ? (x0 == 0 ? atl : at) : (x0 == 0 ? al : true);
    av[3] = y0 == 0 ? at : true;
    av[4] = y0 == 0 ? (right_in ? at : atr)
                    : right_in && morton((y0 - 1) / n, (x0 + n) / n) < z;
}

// first index of segment s (below-left, left, corner, top, top-right)
__device__ __forceinline__ int seg_begin(int s, int n) {
    return s == 0 ? 0 : s == 1 ? n : s == 2 ? 2 * n : s == 3 ? 2 * n + 1
                                                              : 3 * n + 1;
}

__device__ __forceinline__ int seg_of(int k, int n) {
    return k < n ? 0 : k < 2 * n ? 1 : k == 2 * n ? 2 : k <= 3 * n ? 3 : 4;
}

// v index of the spec's ref[t] of an angular mode (intra._ref_index_to_v)
__device__ __forceinline__ int ref_to_v(int t, int n, bool vert, int inv) {
    if (t >= 0)
        return t == 0 ? 2 * n : (vert ? 2 * n + t : 2 * n - t);
    const int proj = -1 + ((t * inv + 128) >> 8);
    return vert ? 2 * n - 1 - proj : 2 * n + 1 + proj;
}

__device__ __forceinline__ bool filter_flag(int mode, int log2n) {
    if (mode == 0) return true;
    if (mode == 1) return false;
    const int d = min(abs(mode - 26), abs(mode - 10));
    return d > kFilterThresh[log2n - 3];
}

// The prediction of sample (y, x): v the substituted references, ref the
// ones the mode reads (smoothed or not), edge: the DC / H / V edge
// filters apply (luma below 32x32).
__device__ __forceinline__ int predict(const int* v, const int* ref,
                                       int mode, int n, int log2n, int y,
                                       int x, bool edge, int dc, int peak) {
    const int n2 = 2 * n;
    if (mode == 0)
        return ((n - 1 - x) * ref[n2 - 1 - y] + (x + 1) * ref[n2 + 1 + n]
                + (n - 1 - y) * ref[n2 + 1 + x] + (y + 1) * ref[n2 - 1 - n]
                + n) >> (log2n + 1);
    if (mode == 1) {
        if (!edge) return dc;
        if (y == 0 && x == 0)
            return (v[n2 - 1] + 2 * dc + v[n2 + 1] + 2) >> 2;
        if (y == 0) return (v[n2 + 1 + x] + 3 * dc + 2) >> 2;
        if (x == 0) return (v[n2 - 1 - y] + 3 * dc + 2) >> 2;
        return dc;
    }
    const int a = kAngle[mode - 2], inv = kInvAngle[mode - 2];
    const bool vert = mode >= 18;
    const int q = vert ? y : x, p = vert ? x : y;
    const int i = ((q + 1) * a) >> 5, f = ((q + 1) * a) & 31;
    const int t = p + i + 1;
    int pr = ref[ref_to_v(t, n, vert, inv)];
    if (f)
        pr = ((32 - f) * pr + f * ref[ref_to_v(t + 1, n, vert, inv)] + 16)
             >> 5;
    if (edge && mode == 26 && x == 0)
        pr = min(max(v[n2 + 1] + ((v[n2 - 1 - y] - v[n2]) >> 1), 0), peak);
    if (edge && mode == 10 && y == 0)
        pr = min(max(v[n2 - 1] + ((v[n2 + 1 + x] - v[n2]) >> 1), 0), peak);
    return pr;
}

// Commit one n x n leaf of one plane at (y0, x0) of CTU (r, c), in this
// plane's samples. Every thread of the CTA calls it, with its own plane,
// and meets the same __syncthreads() calls.
__device__ void commit_leaf(const Part& P, const Args& a, int r, int c,
                            int y0, int x0, int n, int mode, int qp) {
    const int log2n = 31 - __clz(n);
    const int L = 4 * n + 1, S = n + 1, nn = n * n, n2 = 2 * n;
    const int bd = a.bit_depth, peak = (1 << bd) - 1, W = P.width;
    const int Y0 = r * P.ctu + y0, X0 = c * P.ctu + x0;
    const int step = 32 >> log2n;         // row step in the 32-point DCT

    // A: reference samples, substituted
    bool av[5];
    availability(av, r, c, a.cols, y0, x0, n, P.ctu);
    for (int k = P.tid; k < L; k += P.nth) {
        const int s = seg_of(k, n);
        int kk = k;
        bool any = true;
        if (!av[s]) {
            int b = s - 1;
            while (b >= 0 && !av[b]) --b;
            if (b >= 0) {
                kk = seg_begin(b + 1, n) - 1;     // last of segment b
            } else {
                b = s + 1;
                while (b < 5 && !av[b]) ++b;
                any = b < 5;
                kk = any ? seg_begin(b, n) : 0;
            }
        }
        const int pos = kk < n2 ? (Y0 + n2 - 1 - kk) * W + X0 - 1
                        : kk == n2 ? (Y0 - 1) * W + X0 - 1
                                   : (Y0 - 1) * W + X0 + kk - n2 - 1;
        P.v[k] = any ? P.rec[pos] : 1 << (bd - 1);
    }
    __syncthreads();

    // B: smoothing; DC's value
    const bool filt = P.luma && filter_flag(mode, log2n);
    if (filt)
        for (int k = P.tid; k < L; k += P.nth)
            P.vf[k] = (k == 0 || k == L - 1) ? P.v[k]
                      : (P.v[k - 1] + 2 * P.v[k] + P.v[k + 1] + 2) >> 2;
    if (mode == 1 && P.tid == 0) {
        int s = n;
        for (int k = 0; k < n; ++k) s += P.v[n2 - 1 - k] + P.v[n2 + 1 + k];
        *P.dc = s >> (log2n + 1);
    }
    __syncthreads();

    // C: prediction and residual
    const int* ref = filt ? P.vf : P.v;
    const bool edge = P.luma && n < 32;
    const int dc = *P.dc;
    for (int i = P.tid; i < nn; i += P.nth) {
        const int y = i >> log2n, x = i & (n - 1);
        const int pr = predict(P.v, ref, mode, n, log2n, y, x, edge, dc,
                               peak);
        P.pred[y * S + x] = pr;
        P.res[y * S + x] = P.src[(Y0 + y) * W + X0 + x] - pr;
    }
    __syncthreads();

    // D: forward transform of the rows, tmp[k][y]
    const int s1 = log2n - 1 + (bd - 8);
    for (int i = P.tid; i < nn; i += P.nth) {
        const int k = i >> log2n, y = i & (n - 1);
        const int* T = s_dct + k * step * DS;
        const int* row = P.res + y * S;
        int acc = 0;
        for (int x = 0; x < n; ++x) acc += T[x] * row[x];
        P.tmp[k * S + y] = (acc + (1 << (s1 - 1))) >> s1;
    }
    __syncthreads();

    // E: forward transform of the columns and the quant: levels in res,
    // rounding remainders in du
    const int s2 = log2n + 6;
    const int per = qp / 6, rem = qp % 6;
    const int qbits = 14 + per + 15 - bd - log2n;
    const int add = (a.intra_slice ? 171 : 85) << (qbits - 9);
    const int scale = kQuantScale[rem];
    for (int i = P.tid; i < nn; i += P.nth) {
        const int u = i >> log2n, k = i & (n - 1);
        const int* T = s_dct + u * step * DS;
        const int* col = P.tmp + k * S;
        long long acc = 0;
        for (int y = 0; y < n; ++y) acc += (long long)T[y] * col[y];
        const int coef = (int)((acc + (1LL << (s2 - 1))) >> s2);
        const int tmp = wmul(abs(coef), scale);
        const int level = wadd(tmp, add) >> qbits;
        const int sgn = (coef > 0) - (coef < 0);
        P.res[u * S + k] = clamp16(level * sgn);
        P.du[u * S + k] = wsub(tmp, wshl(level, qbits)) >> (qbits - 8);
    }
    __syncthreads();

    // F: sign-bit hiding, one 4x4 group a thread
    if (a.sbh) {
        int scan = 0;
        if (n <= (P.luma ? 8 : 4)) {
            if (mode >= 22 && mode <= 30) scan = 1;
            else if (mode >= 6 && mode <= 14) scan = 2;
        }
        const unsigned char* sc = kScan4[scan];
        const int cgw = n >> 2;
        for (int g = P.tid; g < cgw * cgw; g += P.nth) {
            const int base = (g / cgw) * 4 * S + (g % cgw) * 4;
            int first = 16, last = -1, sum = 0, vfirst = 0;
            for (int s = 0; s < 16; ++s) {
                const int l = P.res[base + (sc[s] >> 2) * S + (sc[s] & 3)];
                if (l) {
                    if (first == 16) { first = s; vfirst = l; }
                    last = s;
                    sum += abs(l);
                }
            }
            if (last - first >= 4 && (sum & 1) != (vfirst < 0)) {
                int best = -1, pick = first;
                for (int s = first; s <= last; ++s) {
                    const int d = abs(
                        P.du[base + (sc[s] >> 2) * S + (sc[s] & 3)]);
                    if (d > best) { best = d; pick = s; }
                }
                const int o = base + (sc[pick] >> 2) * S + (sc[pick] & 3);
                P.res[o] += P.res[o] < 0 ? -1 : 1;
            }
        }
    }
    __syncthreads();

    // G: the levels written; dequant and the inverse transform of the
    // columns, tmp[v][y]
    const int dshift = bd + log2n - 9;
    const int dscale = kInvQuantScale[rem] << per;
    for (int i = P.tid; i < nn; i += P.nth) {
        const int y = i >> log2n, v = i & (n - 1);
        P.lv[(Y0 + y) * W + X0 + v] = P.res[y * S + v];
        int acc = 0;
        for (int u = 0; u < n; ++u) {
            const int c = clamp16(wadd(wmul(P.res[u * S + v], dscale),
                                       1 << (dshift - 1)) >> dshift);
            acc += c * s_dct[u * step * DS + y];
        }
        P.tmp[v * S + y] = clamp16((acc + 64) >> 7);
    }
    __syncthreads();

    // H: the inverse transform of the rows and the recon
    const int s4 = 20 - bd;
    for (int i = P.tid; i < nn; i += P.nth) {
        const int y = i >> log2n, x = i & (n - 1);
        int acc = 0;
        for (int v = 0; v < n; ++v)
            acc += P.tmp[v * S + y] * s_dct[v * step * DS + x];
        const int rr = clamp16((acc + (1 << (s4 - 1))) >> s4);
        P.rec[(Y0 + y) * W + X0 + x] =
            min(max(P.pred[y * S + x] + rr, 0), peak);
    }
    __syncthreads();
}

// z-order position k of a CTU32 tree: (y0, x0, n) in luma samples
__device__ __forceinline__ void zpos(int k, int& y0, int& x0, int& n) {
    if (k == 0) { y0 = x0 = 0; n = CTU; return; }
    const int q = (k - 1) / 5, j = (k - 1) % 5;
    y0 = (q >> 1) * 16;
    x0 = (q & 1) * 16;
    n = 16;
    if (j) {
        y0 += ((j - 1) >> 1) * 8;
        x0 += ((j - 1) & 1) * 8;
        n = 8;
    }
}

__global__ void __launch_bounds__(THREADS)
intra_commit_kernel(Args a, int diag, int r_lo) {
    __shared__ int s_modes[NZ];
    __shared__ int s_pool[4 * LUMA_BLK + 2 * 4 * CHROMA_BLK];
    __shared__ int s_v[3][4 * CTU + 1], s_vf[3][4 * CTU + 1], s_dc[3];
    const int r = r_lo + blockIdx.x, c = diag - 2 * r;
    const int ctu = r * a.cols + c;
    const int t = threadIdx.x;
    if (t < NZ) s_modes[t] = a.table[ctu * NZ + t];
    __syncthreads();
    bool any = false;
    for (int k = 0; k < NZ; ++k) any |= s_modes[k] >= 0;
    if (!any) return;                     // the same for every thread
    for (int i = t; i < 32 * 32; i += THREADS)
        s_dct[(i >> 5) * DS + (i & 31)] = kDct[i >> 5][i & 31];

    const int p = t < LUMA_THREADS ? 0
                  : t < LUMA_THREADS + CHROMA_THREADS ? 1 : 2;
    Part P;
    P.luma = p == 0;
    P.tid = p == 0 ? t : t - LUMA_THREADS - (p - 1) * CHROMA_THREADS;
    P.nth = p == 0 ? LUMA_THREADS : CHROMA_THREADS;
    P.src = a.src[p];
    P.rec = a.rec[p];
    P.lv = a.lv[p];
    P.width = p == 0 ? a.width : a.width / 2;
    P.ctu = p == 0 ? CTU : CTU / 2;
    const int bs = p == 0 ? LUMA_BLK : CHROMA_BLK;
    int* base = p == 0 ? s_pool
                       : s_pool + 4 * LUMA_BLK + (p - 1) * 4 * CHROMA_BLK;
    P.pred = base;
    P.res = base + bs;
    P.tmp = base + 2 * bs;
    P.du = base + 3 * bs;
    P.v = s_v[p];
    P.vf = s_vf[p];
    P.dc = &s_dc[p];
    const int qp = (p == 0 ? a.qp_y[ctu] : a.qp_c[ctu])
                   + 6 * (a.bit_depth - 8);
    __syncthreads();                      // the DCT copy
    for (int k = 0; k < NZ; ++k) {
        const int mode = s_modes[k];
        if (mode < 0) continue;
        int y0, x0, n;
        zpos(k, y0, x0, n);
        if (p) { y0 >>= 1; x0 >>= 1; n >>= 1; }
        commit_leaf(P, a, r, c, y0, x0, n, mode, qp);
    }
}

}  // namespace

extern "C" {

// table: [rows * cols, 21] int32 device array (each CTU's z-order
// positions: the intra mode of a leaf there, else -1); qp_y, qp_c:
// [rows * cols] int32 device arrays; src_*, rec_*, lv_*: int32 device
// planes, luma [32 rows, 32 cols] CTUs wide `width`, chroma half of it
// each way (4:2:0); bit_depth 8-12; intra_slice, sbh: 0 / 1. diags: host
// array of the ndiags diagonals to commit, ascending; one launch each on
// `stream`. Returns the first CUDA error of a launch (0 on success).
int asuna_intra_commit(const int* table, const int* qp_y, const int* qp_c,
                       const int* src_y, const int* src_u, const int* src_v,
                       int* rec_y, int* rec_u, int* rec_v, int* lv_y,
                       int* lv_u, int* lv_v, int width, int rows, int cols,
                       int bit_depth, int intra_slice, int sbh,
                       const int* diags, int ndiags, void* stream) {
    Args a;
    a.table = table;
    a.qp_y = qp_y;
    a.qp_c = qp_c;
    a.src[0] = src_y; a.src[1] = src_u; a.src[2] = src_v;
    a.rec[0] = rec_y; a.rec[1] = rec_u; a.rec[2] = rec_v;
    a.lv[0] = lv_y; a.lv[1] = lv_u; a.lv[2] = lv_v;
    a.width = width;
    a.cols = cols;
    a.bit_depth = bit_depth;
    a.intra_slice = intra_slice;
    a.sbh = sbh;
    cudaStream_t s = (cudaStream_t)stream;
    for (int i = 0; i < ndiags; ++i) {
        const int d = diags[i];
        const int r_lo = d - cols + 1 > 0 ? (d - cols + 2) / 2 : 0;
        const int r_hi = d / 2 < rows - 1 ? d / 2 : rows - 1;
        if (r_hi < r_lo) continue;
        intra_commit_kernel<<<r_hi - r_lo + 1, THREADS, 0, s>>>(a, d, r_lo);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}

}  // extern "C"
