// K1: the motion-estimation SAD sweep, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel x265_yuuki_asuna_tpu/ops/pallas/me_sad.py
// sad_block8_sweep (its pl.pallas_call) together with the XLA tail of
// sad_sweep_multi_pallas. Three entry points share one kernel template:
//   * asuna_sad_block8_sweep — the surface: for every displacement (dy, dx)
//     in [-R, R]^2 the 8x8-block sums of |ref(y+dy, x+dx) - src(y, x)|, the
//     reference edge-extended by index clamping:
//         out[dy+R, dx+R, by, bx]   int32, shape [D, D, H/8, W/8], D = 2R+1;
//   * asuna_sad_block4_sweep — the same surface of 4x4 blocks,
//     [D, D, H/4, W/4]: HME's coarse sweep over the half-resolution
//     planes, whose smallest size is 4 (the reference computes it with the
//     XLA scan of ops/me.py, which takes 4x4 bases; Pallas there needs 8);
//   * asuna_sad_sweep_best — the fused sweep and argmin: for every n x n
//     block (n = 8, 16 or 32) the key  cost << shift | (dyi*D + dxi)  of the
//     least cost = SAD + lam*(|dx| + |dy|), reduced with atomicMin into a
//     [nblocks] buffer the caller fills with all ones. The smallest key is
//     the least cost and, among equal costs, the first (dy, dx) in row-major
//     order: the first minimum the reference takes. No surface is written.
//
// Bound on an H100 SXM (3.35 TB/s; an integer abs-diff-add runs on the 64
// INT32 lanes of each SM, 64 x 132 x 1.98 GHz = 1.67e13 per second, four
// to a packed instruction on 8-bit input = 6.7e13 per second):
//   surface, ME 1088x1920 uint8 R=16: 142 MB written -> 43.7 us (bytes);
//            2.27e9 abs-diff-adds, packed -> 34.0 us;
//   fused,   ME n=16 or n=32: 34.0 us (operations; 4.3 MB moved ->
//            1.3 us; n=32 adds 2 shuffle-adds per lane, dy and dx);
//            lookahead 544x960 uint8 n=8: 8.5 us (operations);
//   4x4 surface, HME 544x960 uint8 R=16: 142 MB written -> 42.6 us
//            (bytes; 5.7e8 abs-diff-adds, packed -> 8.5 us).
//
// Design. A CTA of NWARP warps owns a tile of 32 neighbouring 8-column
// blocks (lane = block), one row of blocks (8, 16 or 32 pixel rows) and a
// run of DYRUN dy values, DYW to a warp, and at most DXS = 33 dx values
// (one slab; larger R takes more slabs). It loads the reference band it needs
// (NR + DYRUN - 1 rows x 304 columns, coordinates clamped) into shared
// memory once, with 16-byte loads where the row is in range and aligned,
// as bytes for uint8 (int32 for wider planes). Each lane keeps its source
// block in registers (uint8). The sweep is bound by the SM's integer pipe
// (the packed SAD runs there), so nothing else may run there in the inner
// loop: the CTA builds three more copies of its uint8 band, shifted by
// 1, 2 and 3 bytes (one __byte_perm per word, once), so each of the 33
// unaligned dx windows is two aligned words read with conflict-free
// LDS.64 (8-byte lane stride) instead of __byte_perm in the loop. The 33
// sums sit in registers, so for one (dy, dx) a warp stores 32 neighbouring
// int32 (128 coalesced bytes, with evict-first stores: the surface is
// larger than L2), or, fused, folds them into its running
// minimum key with a multiply-add (FMA pipe). For n = 16 a lane sums 16
// rows and adds its horizontal neighbour with __shfl_xor; for n = 32 it
// sums 32 rows and the four lanes of a block add theirs with two
// __shfl_xor steps (1, then 2), and the first of the four takes the
// atomicMin. n = 32's band (43 rows, 52 KB in either form) is past the
// default 48 KB of dynamic shared memory, so its instantiations opt in
// (cudaFuncAttributeMaxDynamicSharedMemorySize): four CTAs fit an SM's
// 228 KB. The 4x4 surface
// keeps the layout: a lane's 8 columns are two 4x4 blocks, each word of
// its source row feeds its own sum (NH = 2 sums per dx), the CTA covers 4
// pixel rows, and a warp stores 32 neighbouring int2 pairs (256
// coalesced bytes) per (dy, dx). int16/int32
// planes take the same structure unpacked (per-element __sad, one copy).
// The packed SAD is PTX vabsdiff4 with accumulate: one VABSDIFF4 per four
// bytes, where __vsadu4 adds an IADD3 and __vabsdiffu4 + __dp4a an IDP4A.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o build/libme_sad.so csrc/me_sad.cu
// Interface: plain C, driven through ctypes (ops/kernels/me_sad.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;
constexpr int NWARP = 4;
constexpr int THREADS = NWARP * LANES;
constexpr int DYW = 3;                    // dy values per warp
constexpr int DYRUN = NWARP * DYW;        // dy values per CTA
constexpr int DXS = 33;                   // dx values per CTA (one slab)
constexpr int WIN = 8 + DXS - 1;          // columns a lane reads per row
constexpr int BANDW = 8 * LANES + 48;     // band row stride: 304 >= 8*31 +
                                          // WIN + 3 (the shifted copies)
static_assert(8 * (LANES - 1) + WIN + 3 <= BANDW && BANDW % 16 == 0, "band");
static_assert(WIN % 8 == 0, "a lane's window is whole LDS.64 words");

// How a plane's elements sit in shared memory: uint8 stays packed, four to
// a 32-bit word, in NCOPY = 4 copies of the band, copy m shifted left by m
// bytes, so every dx window is made of aligned words; wider planes are
// widened to int32, one copy.
template <typename T> struct Plane {
    using S = int32_t;
    static constexpr int NCOPY = 1;
};
template <> struct Plane<uint8_t> {
    using S = uint8_t;
    static constexpr int NCOPY = 4;
};

template <typename T, int NR>
constexpr size_t band_bytes() {
    return (size_t)Plane<T>::NCOPY * (NR + DYRUN - 1) * BANDW *
           sizeof(typename Plane<T>::S);
}
static_assert(band_bytes<uint8_t, 16>() <= 48 * 1024 &&
              band_bytes<int32_t, 16>() <= 48 * 1024,
              "n <= 16: the band fits the default dynamic shared memory");
static_assert(band_bytes<uint8_t, 32>() <= 227 * 1024 &&
              band_bytes<int32_t, 32>() <= 227 * 1024,
              "n = 32: the band fits a CTA's opt-in shared memory");

// acc + the sum of the four byte-wise |a - b|
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b,
                                         uint32_t acc) {
    uint32_t d;
    asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
        : "=r"(d) : "r"(a), "r"(b), "r"(acc));
    return d;
}

// band[j][c] = ref[clamp(ys + j)][clamp(xs + c)] for j < rows, c < BANDW;
// for uint8, copy m (at band + m * cstride) then holds band[j][c + m]
template <typename T>
__device__ void load_band(typename Plane<T>::S* band, const T* ref, int rows,
                          int cstride, int H, int W, int ys, int xs) {
    using S = typename Plane<T>::S;
    constexpr int CH = 16 / sizeof(T);        // elements per 16-byte load
    constexpr int NCH = BANDW / CH;
    for (int i = threadIdx.x; i < rows * NCH; i += THREADS) {
        const int j = i / NCH, c = (i - j * NCH) * CH;
        const T* row = ref + (size_t)min(max(ys + j, 0), H - 1) * W;
        const int x = xs + c;
        S* dst = band + j * BANDW + c;
        if (x >= 0 && x + CH <= W &&
            (reinterpret_cast<uintptr_t>(row + x) & 15) == 0) {
            union { uint4 v; T e[CH]; } u;
            u.v = *reinterpret_cast<const uint4*>(row + x);
            if constexpr (sizeof(S) == sizeof(T)) {
                *reinterpret_cast<uint4*>(dst) = u.v;
            } else {
                #pragma unroll
                for (int k = 0; k < CH; ++k) dst[k] = (S)u.e[k];
            }
        } else {
            #pragma unroll
            for (int k = 0; k < CH; ++k)
                dst[k] = (S)row[min(max(x + k, 0), W - 1)];
        }
    }
    if constexpr (Plane<T>::NCOPY > 1) {
        __syncthreads();
        constexpr int NW = BANDW / 4 - 1;     // shifted words per row
        const uint32_t* b0 = reinterpret_cast<const uint32_t*>(band);
        for (int i = threadIdx.x; i < rows * NW; i += THREADS) {
            const int j = i / NW, w = j * (BANDW / 4) + i - j * NW;
            const uint32_t lo = b0[w], hi = b0[w + 1];
            #pragma unroll
            for (int m = 1; m < Plane<T>::NCOPY; ++m)
                reinterpret_cast<uint32_t*>(band + m * cstride)[w] =
                    __byte_perm(lo, hi, 0x3210 + 0x1111 * m);
        }
    }
}

// acc[h][i] = SAD of this lane's NR x 8 source block (NH = 1), or of its
// left and right NR x 4 halves (NH = 2), against the band window at column
// offset i (dx = dx0 + i - R): window word q of offset 4q + m is word q of
// copy m
template <int NR, int CSTRIDE, int NH>
__device__ __forceinline__ void sweep_u8(const uint8_t* win,
                                         const uint32_t (&s)[NR][2],
                                         uint32_t (&acc)[NH][DXS]) {
    #pragma unroll
    for (int h = 0; h < NH; ++h)
        #pragma unroll
        for (int i = 0; i < DXS; ++i) acc[h][i] = 0;
    #pragma unroll
    for (int r = 0; r < NR; ++r) {
        // copy 0 gives words 0..9, copies 1..3 words 0..8 (offset 4q + m
        // <= 36)
        uint32_t w[4][WIN / 4];
        #pragma unroll
        for (int m = 0; m < 4; ++m) {
            const uint2* p = reinterpret_cast<const uint2*>(
                win + m * CSTRIDE + r * BANDW);
            #pragma unroll
            for (int k = 0; k < WIN / 8 - 1; ++k) {
                const uint2 v = p[k];
                w[m][2 * k] = v.x;
                w[m][2 * k + 1] = v.y;
            }
            const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
            w[m][WIN / 4 - 2] = q[WIN / 4 - 2];
            if (m == 0) w[m][WIN / 4 - 1] = q[WIN / 4 - 1];
        }
        #pragma unroll
        for (int i = 0; i < DXS; ++i) {
            acc[0][i] = sad4(w[i % 4][i / 4], s[r][0], acc[0][i]);
            acc[NH - 1][i] = sad4(w[i % 4][i / 4 + 1], s[r][1],
                                  acc[NH - 1][i]);
        }
    }
}

template <typename T, int NR, int NH>
__device__ __forceinline__ void sweep_wide(const int32_t* win, const T* sp,
                                           int W, bool active,
                                           uint32_t (&acc)[NH][DXS]) {
    #pragma unroll
    for (int h = 0; h < NH; ++h)
        #pragma unroll
        for (int i = 0; i < DXS; ++i) acc[h][i] = 0;
    #pragma unroll 1
    for (int r = 0; r < NR; ++r) {
        int s[8], w[WIN];
        #pragma unroll
        for (int c = 0; c < 8; ++c)
            s[c] = active ? (int)sp[(size_t)r * W + c] : 0;
        const int4* p = reinterpret_cast<const int4*>(win + r * BANDW);
        #pragma unroll
        for (int k = 0; k < WIN / 4; ++k) {
            const int4 v = p[k];
            w[4 * k] = v.x; w[4 * k + 1] = v.y;
            w[4 * k + 2] = v.z; w[4 * k + 3] = v.w;
        }
        #pragma unroll
        for (int i = 0; i < DXS; ++i)
            #pragma unroll
            for (int c = 0; c < 8; ++c)
                acc[c * NH / 8][i] = __sad(w[i + c], s[c], acc[c * NH / 8][i]);
    }
}

// the least key acc[i] * mul + cx[i] over the first nd entries, mul =
// 2^shift; cx[i] holds dx's part of the key (see k1_kernel). A multiply-add
// runs on the FMA pipe, beside the SAD on the integer pipe.
template <typename Key, bool GUARD>
__device__ __forceinline__ Key min_key(const uint32_t (&acc)[DXS],
                                       const Key* cx, int nd, Key mul) {
    Key best = ~Key(0);
    #pragma unroll
    for (int i = 0; i < DXS; ++i) {
        if (!GUARD || i < nd) {
            const Key key = (Key)acc[i] * mul + cx[i];
            best = key < best ? key : best;
        }
    }
    return best;
}

// One kernel for all entry points. NR = pixel rows of a lane's block (8,
// 16 or 32 for the fused n = 16 / 32, 4 for the 4x4 surface); NH = sums
// per lane and
// dx (1: one 8-wide block, 2: two 4-wide ones); BEST = fused argmin into
// `keys` (else the surface into `out`); Key = uint32_t or unsigned long
// long.
template <typename T, int NR, bool BEST, typename Key, int NH = 1>
__global__ void __launch_bounds__(THREADS)
k1_kernel(const T* __restrict__ ref, const T* __restrict__ src, int H, int W,
          int R, int lam, int shift, int32_t* __restrict__ out,
          Key* __restrict__ keys) {
    using S = typename Plane<T>::S;
    constexpr int CSTRIDE = (NR + DYRUN - 1) * BANDW;   // between copies
    extern __shared__ __align__(16) unsigned char smem[];
    S* band = reinterpret_cast<S*>(smem);
    // key = cost << shift | (dyi*D + dxi)
    //     = acc * 2^shift + cx[i] + (lam*|dy| << shift) + dyi*D, with
    // cx[i] = (lam*|dx| << shift) + dx0 + i; shift leaves room for the index
    __shared__ Key cx[DXS];
    const int D = 2 * R + 1;
    const int nslab = (D + DXS - 1) / DXS;
    const int run = blockIdx.z / nslab, slab = blockIdx.z - run * nslab;
    const int dy0 = run * DYRUN, dx0 = slab * DXS;
    const int nd = min(DXS, D - dx0);
    const int hb = H / NR, wb = W / 8;
    const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
    const int bx = blockIdx.x * LANES + lane;      // this lane's 8-col block
    const bool active = bx < wb;
    const int x0 = blockIdx.x * LANES * 8, y0 = blockIdx.y * NR;
    const T* sp = src + (size_t)y0 * W + 8 * bx;

    if (BEST && threadIdx.x < DXS)
        cx[threadIdx.x] = ((Key)(lam * abs(dx0 + (int)threadIdx.x - R))
                           << shift) + (Key)(dx0 + threadIdx.x);
    load_band<T>(band, ref, NR + min(DYRUN, D - dy0) - 1, CSTRIDE, H, W,
                 y0 + dy0 - R, x0 + dx0 - R);
    uint32_t s[NR][2];
    if constexpr (sizeof(T) == 1) {
        #pragma unroll
        for (int r = 0; r < NR; ++r) {
            const uint2 v = active
                ? *reinterpret_cast<const uint2*>(sp + (size_t)r * W)
                : make_uint2(0, 0);
            s[r][0] = v.x;
            s[r][1] = v.y;
        }
    }
    __syncthreads();

    Key best = ~Key(0);
    for (int j = 0; j < DYW; ++j) {
        const int d = warp * DYW + j;               // dy within the run
        const int dyi = dy0 + d;
        if (dyi >= D) break;                        // warp-uniform
        uint32_t sums[NH][DXS];
        if constexpr (sizeof(T) == 1)
            sweep_u8<NR, CSTRIDE, NH>(band + d * BANDW + 8 * lane, s, sums);
        else
            sweep_wide<T, NR, NH>(band + d * BANDW + 8 * lane, sp, W, active,
                                  sums);
        uint32_t (&acc)[DXS] = sums[0];
        if constexpr (BEST) {
            static_assert(NH == 1, "the fused argmin takes 8-wide blocks");
            // an NR x NR block is NR / 8 neighbouring lanes
            #pragma unroll
            for (int m = 1; m < NR / 8; m *= 2) {
                #pragma unroll
                for (int i = 0; i < DXS; ++i)
                    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], m);
            }
            const Key mul = Key(1) << shift;
            const Key k = (nd == DXS ? min_key<Key, false>(acc, cx, nd, mul)
                                     : min_key<Key, true>(acc, cx, nd, mul))
                + ((Key)(lam * abs(dyi - R)) << shift) + (Key)(dyi * D);
            best = k < best ? k : best;
        } else if (active && NH == 1) {
            int32_t* o = out + ((size_t)(dyi * D + dx0) * hb + blockIdx.y) * wb
                + bx;
            const size_t plane = (size_t)hb * wb;
            #pragma unroll
            for (int i = 0; i < DXS; ++i)
                if (i < nd) __stcs(o + i * plane, (int32_t)acc[i]);
        } else if (active) {
            // the lane's two 4x4 blocks are neighbours in the W/4 row
            int2* o = reinterpret_cast<int2*>(out) +
                ((size_t)(dyi * D + dx0) * hb + blockIdx.y) * wb + bx;
            const size_t plane = (size_t)hb * wb;
            #pragma unroll
            for (int i = 0; i < DXS; ++i)
                if (i < nd)
                    __stcs(o + i * plane, make_int2((int32_t)sums[0][i],
                                                    (int32_t)sums[NH - 1][i]));
        }
    }
    if constexpr (BEST) {
        if (active && lane % (NR / 8) == 0)
            atomicMin(&keys[(size_t)blockIdx.y * (W / NR) + bx / (NR / 8)],
                      best);
    }
}

template <typename T, int NR, bool BEST, typename Key, int NH = 1>
cudaError_t launch(const void* ref, const void* src, int H, int W, int R,
                   int lam, int shift, void* out, void* keys,
                   cudaStream_t stream) {
    const int D = 2 * R + 1;
    const dim3 grid((W / 8 + LANES - 1) / LANES, H / NR,
                    ((D + DYRUN - 1) / DYRUN) * ((D + DXS - 1) / DXS));
    if constexpr (band_bytes<T, NR>() > 48 * 1024) {
        // once per instantiation: opt in past the default 48 KB
        static const cudaError_t attr = cudaFuncSetAttribute(
            k1_kernel<T, NR, BEST, Key, NH>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)band_bytes<T, NR>());
        if (attr != cudaSuccess) return attr;
    }
    k1_kernel<T, NR, BEST, Key, NH><<<grid, THREADS, band_bytes<T, NR>(),
                                      stream>>>(
        (const T*)ref, (const T*)src, H, W, R, lam, shift, (int32_t*)out,
        (Key*)keys);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_best(const void* ref, const void* src, void* keys, int H,
                        int W, int R, int n, int lam, int shift,
                        int key_bytes, cudaStream_t s) {
    using K32 = uint32_t;
    using K64 = unsigned long long;
    if (n == 8 && key_bytes == 4)
        return launch<T, 8, true, K32>(ref, src, H, W, R, lam, shift,
                                       nullptr, keys, s);
    if (n == 8 && key_bytes == 8)
        return launch<T, 8, true, K64>(ref, src, H, W, R, lam, shift,
                                       nullptr, keys, s);
    if (n == 16 && key_bytes == 4)
        return launch<T, 16, true, K32>(ref, src, H, W, R, lam, shift,
                                        nullptr, keys, s);
    if (n == 16 && key_bytes == 8)
        return launch<T, 16, true, K64>(ref, src, H, W, R, lam, shift,
                                        nullptr, keys, s);
    if (n == 32 && key_bytes == 4)
        return launch<T, 32, true, K32>(ref, src, H, W, R, lam, shift,
                                        nullptr, keys, s);
    if (n == 32 && key_bytes == 8)
        return launch<T, 32, true, K64>(ref, src, H, W, R, lam, shift,
                                        nullptr, keys, s);
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// ref, src: [H, W] device planes of one element type (dtype 0 = uint8,
// 1 = int16, 2 = int32), 16-byte aligned; out: [D, D, H/8, W/8] int32
// device buffer. H and W are multiples of 8. Launches on `stream`;
// returns the CUDA error code of the launch (0 on success).
int asuna_sad_block8_sweep(const void* ref, const void* src, void* out,
                           int H, int W, int R, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype) {
        case 0: return (int)launch<uint8_t, 8, false, uint32_t>(
                    ref, src, H, W, R, 0, 0, out, nullptr, s);
        case 1: return (int)launch<int16_t, 8, false, uint32_t>(
                    ref, src, H, W, R, 0, 0, out, nullptr, s);
        case 2: return (int)launch<int32_t, 8, false, uint32_t>(
                    ref, src, H, W, R, 0, 0, out, nullptr, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// As above, of 4x4 blocks: out is [D, D, H/4, W/4] int32; H is a
// multiple of 4 and W of 8.
int asuna_sad_block4_sweep(const void* ref, const void* src, void* out,
                           int H, int W, int R, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype) {
        case 0: return (int)launch<uint8_t, 4, false, uint32_t, 2>(
                    ref, src, H, W, R, 0, 0, out, nullptr, s);
        case 1: return (int)launch<int16_t, 4, false, uint32_t, 2>(
                    ref, src, H, W, R, 0, 0, out, nullptr, s);
        case 2: return (int)launch<int32_t, 4, false, uint32_t, 2>(
                    ref, src, H, W, R, 0, 0, out, nullptr, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// As above, but keys: [(H/n) * (W/n)] device buffer of key_bytes (4 or 8)
// each, filled with all ones by the caller, H and W multiples of n (8,
// 16 or 32); each block's key becomes the least cost << shift |
// (dyi*D + dxi).
int asuna_sad_sweep_best(const void* ref, const void* src, void* keys, int H,
                         int W, int R, int n, int lam, int shift,
                         int key_bytes, int dtype, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype) {
        case 0: return (int)launch_best<uint8_t>(
                    ref, src, keys, H, W, R, n, lam, shift, key_bytes, s);
        case 1: return (int)launch_best<int16_t>(
                    ref, src, keys, H, W, R, n, lam, shift, key_bytes, s);
        case 2: return (int)launch_best<int32_t>(
                    ref, src, keys, H, W, R, n, lam, shift, key_bytes, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
