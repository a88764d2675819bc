// HEVC encoder (PyTorch/CUDA port) — host-side sequential runtime (C++).
//
// The device side produces per-CU decision tensors; this library is the
// CABAC entropy coder + slice syntax writer consuming them (the device/host
// split mirrors the reference's WPP+SAO two-phase design, SURVEY.md §7;
// behavioral reference: encoder/entropy.cpp, studied not copied — all
// tables are H.265 spec constants).
//
// The port's copy of x265_yuuki_asuna_tpu/native/asuna_native.cpp, cut to
// the slice writers the port's sessions run: the uniform-grid I and P
// writers and the CTU32 quadtree I/P/B writer.
//
// Build: g++ -O2 -shared -fPIC -o build/libasuna.so csrc/asuna_native.cpp
// Interface: extern "C", driven through ctypes (bitstream/native.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Spec tables (H.265 9.3.4.3, table 9-46/9-47 + init tables 9-5..9-32)
// ---------------------------------------------------------------------------

static const uint8_t kLps[64][4] = {
    {128,176,208,240},{128,167,197,227},{128,158,187,216},{123,150,178,205},
    {116,142,169,195},{111,135,160,185},{105,128,152,175},{100,122,144,166},
    {95,116,137,158},{90,110,130,150},{85,104,123,142},{81,99,117,135},
    {77,94,111,128},{73,89,105,122},{69,85,100,116},{66,80,95,110},
    {62,76,90,104},{59,72,86,99},{56,69,81,94},{53,65,77,89},
    {51,62,73,85},{48,59,69,80},{46,56,66,76},{43,53,63,72},
    {41,50,59,69},{39,48,56,65},{37,45,54,62},{35,43,51,59},
    {33,41,48,56},{32,39,46,53},{30,37,43,50},{29,35,41,48},
    {27,33,39,45},{26,31,37,43},{24,30,35,41},{23,28,33,39},
    {22,27,32,37},{21,26,30,35},{20,24,29,33},{19,23,27,31},
    {18,22,26,30},{17,21,25,28},{16,20,23,27},{15,19,22,25},
    {14,18,21,24},{14,17,20,23},{13,16,19,22},{12,15,18,21},
    {12,14,17,20},{11,14,16,19},{11,13,15,18},{10,12,15,17},
    {10,12,14,16},{9,11,13,15},{9,11,12,14},{8,10,12,14},
    {8,9,11,13},{7,9,11,12},{7,9,10,12},{7,8,10,11},
    {6,8,9,11},{6,7,9,10},{6,7,8,9},{2,2,2,2}};

static const uint8_t kTransLps[64] = {
    0,0,1,2,2,4,4,5,6,7,8,9,9,11,11,12,13,13,15,15,16,16,18,18,19,19,21,21,
    22,22,23,24,24,25,26,26,27,27,28,29,29,30,30,30,31,32,32,33,33,33,34,34,
    35,35,35,36,36,36,37,37,37,38,38,63};

// context layout — MUST match bitstream/tables.py CTX_OFFSET ordering
enum CtxOffsets {
    CTX_SPLIT_CU = 0,       // 3
    CTX_SKIP = 3,           // 3
    CTX_MERGE_FLAG = 6,     // 1
    CTX_MERGE_IDX = 7,      // 1
    CTX_PART_SIZE = 8,      // 4
    CTX_PRED_MODE = 12,     // 1
    CTX_INTRA_LUMA = 13,    // 1
    CTX_INTRA_CHROMA = 14,  // 2
    CTX_DELTA_QP = 16,      // 3
    CTX_INTER_DIR = 19,     // 5
    CTX_REF_IDX = 24,       // 2
    CTX_MVD = 26,           // 2
    CTX_QT_CBF = 28,        // 7
    CTX_TRANS_SUBDIV = 35,  // 3
    CTX_QT_ROOT_CBF = 38,   // 1
    CTX_SIG_CG = 39,        // 4
    CTX_SIG = 43,           // 42
    CTX_LAST_X = 85,        // 18
    CTX_LAST_Y = 103,       // 18
    CTX_ONE = 121,          // 24
    CTX_ABS = 145,          // 6
    CTX_MVP_IDX = 151,      // 1
    CTX_SAO_MERGE = 152,    // 1
    CTX_SAO_TYPE = 153,     // 1
    CTX_TSKIP = 154,        // 2
    CTX_TQ_BYPASS = 156,    // 1
    NUM_CTX = 157
};

static const uint8_t CNU = 154;
// init rows [B, P, I] flattened per tables.py _CTX_DEFS
static const uint8_t kInit[3][NUM_CTX] = {
  { // B
    107,139,126, 197,185,201, 154, 137, 154,139,154,154, 134, 183, 152,139,
    154,154,154, 95,79,63,31,31, 153,153, 169,198,
    153,111,149,92,167,154,154, 224,167,122, 79, 121,140,61,154,
    170,154,139,153,139,123,123,63,124,166,183,140,136,153,154,166,183,140,
    136,153,154,166,183,140,136,153,154,170,153,138,138,122,121,122,121,167,
    151,183,140,151,183,140,
    125,110,124,110,95,94,125,111,111,79,125,126,111,111,79,108,123,93,
    125,110,124,110,95,94,125,111,111,79,125,126,111,111,79,108,123,93,
    154,196,167,167,154,152,167,182,182,134,149,136,153,121,136,122,169,208,
    166,167,154,152,167,182,
    107,167,91,107,107,167, 168, 153, 160, 139,139, 154 },
  { // P
    107,139,126, 197,185,201, 110, 122, 154,139,154,154, 149, 154, 152,139,
    154,154,154, 95,79,63,31,31, 153,153, 140,198,
    153,111,149,107,167,154,154, 124,138,94, 79, 121,140,61,154,
    155,154,139,153,139,123,123,63,153,166,183,140,136,153,154,166,183,140,
    136,153,154,166,183,140,136,153,154,170,153,123,123,107,121,107,121,167,
    151,183,140,151,183,140,
    125,110,94,110,95,79,125,111,110,78,110,111,111,95,94,108,123,108,
    125,110,94,110,95,79,125,111,110,78,110,111,111,95,94,108,123,108,
    154,196,196,167,154,152,167,182,182,134,149,136,153,121,136,137,169,194,
    166,167,154,167,137,182,
    107,167,91,122,107,167, 168, 153, 185, 139,139, 154 },
  { // I
    139,141,157, CNU,CNU,CNU, CNU, CNU, 184,CNU,CNU,CNU, CNU, 184, 63,139,
    154,154,154, CNU,CNU,CNU,CNU,CNU, CNU,CNU, CNU,CNU,
    111,141,94,138,182,154,154, 153,138,138, CNU, 91,171,134,141,
    111,111,125,110,110,94,124,108,124,107,125,141,179,153,125,107,125,141,
    179,153,125,107,125,141,179,153,125,140,139,182,182,152,136,152,136,153,
    136,139,111,136,139,111,
    110,110,124,125,140,153,125,127,140,109,111,143,127,111,79,108,123,63,
    110,110,124,125,140,153,125,127,140,109,111,143,127,111,79,108,123,63,
    140,92,137,138,140,152,138,139,153,74,149,92,139,107,122,152,140,179,
    166,182,140,227,122,197,
    138,153,136,167,152,152, CNU, 153, 200, 139,139, 154 }};

// scan tables (generated at init from spec 6.5.3)
struct Scans {
    std::vector<int32_t> scan[3][4];    // [scanType][log2-2] coefficient scans
    std::vector<int32_t> scanCG[3][4];  // CG scans
    int32_t scan4[3][16];
    Scans() {
        for (int st = 0; st < 3; st++) {
            for (int l = 2; l <= 5; l++)
                build(st, l);
            int32_t tmp[16];
            block(st, 4, tmp);
            memcpy(scan4[st], tmp, sizeof(tmp));
        }
    }
    static void block(int st, int n, int32_t* out) {
        int k = 0;
        if (st == 1) {          // horizontal
            for (int y = 0; y < n; y++)
                for (int x = 0; x < n; x++) out[k++] = y * n + x;
        } else if (st == 2) {   // vertical
            for (int x = 0; x < n; x++)
                for (int y = 0; y < n; y++) out[k++] = y * n + x;
        } else {                // diagonal up-right
            for (int d = 0; d < 2 * n - 1; d++) {
                int y = d < n ? d : n - 1;
                int x = d - y;
                while (y >= 0 && x < n) out[k++] = (y--) * n + (x++);
            }
        }
    }
    void build(int st, int log2) {
        int n = 1 << log2;
        std::vector<int32_t>& s = scan[st][log2 - 2];
        std::vector<int32_t>& cg = scanCG[st][log2 - 2];
        s.resize(n * n);
        if (log2 == 2) {
            block(st, 4, s.data());
            cg.assign(1, 0);
            return;
        }
        int ncg = n >> 2;
        cg.resize(ncg * ncg);
        block(st, ncg, cg.data());
        std::vector<int32_t> inner(16);
        block(st, 4, inner.data());
        int k = 0;
        for (int c = 0; c < ncg * ncg; c++) {
            int cy = cg[c] / ncg, cx = cg[c] % ncg;
            for (int i = 0; i < 16; i++) {
                int py = inner[i] / 4, px = inner[i] % 4;
                s[k++] = (cy * 4 + py) * n + cx * 4 + px;
            }
        }
    }
};
static const Scans g_scans;

static const int32_t kMinInGroup[10] = {0,1,2,3,4,6,8,12,16,24};
static int32_t kGroupIdx[32];
static const struct GroupIdxInit {
    GroupIdxInit() {
        for (int pos = 0; pos < 32; pos++) {
            int g = 0;
            while (g < 9 && kMinInGroup[g + 1] <= pos) g++;
            kGroupIdx[pos] = g;
        }
    }
} g_groupIdxInit;

static const uint8_t kSigPattern[5][16] = {
    {2,1,1,0, 1,1,0,0, 1,0,0,0, 0,0,0,0},
    {2,2,2,2, 1,1,1,1, 0,0,0,0, 0,0,0,0},
    {2,1,0,0, 2,1,0,0, 2,1,0,0, 2,1,0,0},
    {2,2,2,2, 2,2,2,2, 2,2,2,2, 2,2,2,2},
    {0,1,4,5, 2,3,4,5, 6,6,8,8, 7,7,8,8}};

// ---------------------------------------------------------------------------
// CABAC engine (HM-style low/range; byte-identical to the Python reference)
// ---------------------------------------------------------------------------

struct Cabac {
    std::vector<uint8_t> out;
    uint32_t low = 0;
    uint32_t range = 510;
    int bitsLeft = -12;
    int numBuffered = 0;
    uint32_t bufferedByte = 0xFF;
    uint8_t ctx[NUM_CTX];

    void init(int sliceType, int qp) {
        if (qp < 0) qp = 0;
        if (qp > 51) qp = 51;
        for (int i = 0; i < NUM_CTX; i++) {
            int iv = kInit[sliceType][i];
            int slope = (iv >> 4) * 5 - 45;
            int offset = ((iv & 15) << 3) - 16;
            int pre = ((slope * qp) >> 4) + offset;
            if (pre < 1) pre = 1;
            if (pre > 126) pre = 126;
            ctx[i] = pre <= 63 ? uint8_t(((63 - pre) << 1)) : uint8_t(((pre - 64) << 1) | 1);
        }
    }

    void writeOut() {
        uint32_t lead = low >> (13 + bitsLeft);
        low &= 0xFFFFFFFFu >> (19 - bitsLeft);
        bitsLeft -= 8;
        if (lead == 0xFF) {
            numBuffered++;
        } else {
            if (numBuffered > 0) {
                uint32_t carry = lead >> 8;
                out.push_back(uint8_t(bufferedByte + carry));
                uint8_t fill = uint8_t(0xFF + carry);
                for (int i = 0; i < numBuffered - 1; i++) out.push_back(fill);
            }
            numBuffered = 1;
            bufferedByte = lead & 0xFF;
        }
    }

    void encodeBin(int bin, int ci) {
        uint32_t mstate = ctx[ci];
        uint32_t state = mstate >> 1, mps = mstate & 1;
        uint32_t lps = kLps[state][(range >> 6) & 3];
        range -= lps;
        if ((uint32_t)bin != mps) {
            int nb = 1;
            while ((lps << nb) < 256) nb++;
            low = (low + range) << nb;
            range = lps << nb;
            if (state == 0) mps = 1 - mps;
            ctx[ci] = uint8_t((kTransLps[state] << 1) | mps);
            bitsLeft += nb;
        } else {
            uint32_t next = state + 1 > 62 ? 62 : state + 1;
            if (state == 63) next = 63;
            ctx[ci] = uint8_t((next << 1) | mps);
            if (range >= 256) return;
            low <<= 1;
            range <<= 1;
            bitsLeft++;
        }
        if (bitsLeft >= 0) writeOut();
    }

    void encodeBinEP(int bin) {
        low = (low << 1) + (bin ? range : 0);
        bitsLeft++;
        if (bitsLeft >= 0) writeOut();
    }

    void encodeBinsEP(uint32_t value, int nbins) {
        while (nbins > 8) {
            nbins -= 8;
            uint32_t pattern = value >> nbins;
            low = (low << 8) + range * pattern;
            value -= pattern << nbins;
            bitsLeft += 8;
            if (bitsLeft >= 0) writeOut();
        }
        low = (low << nbins) + range * value;
        bitsLeft += nbins;
        if (bitsLeft >= 0) writeOut();
    }

    void encodeBinTrm(int bin) {
        range -= 2;
        if (bin) {
            low = (low + range) << 7;
            range = 2 << 7;
            bitsLeft += 7;
        } else if (range >= 256) {
            return;
        } else {
            low <<= 1;
            range <<= 1;
            bitsLeft++;
        }
        if (bitsLeft >= 0) writeOut();
    }

    // returns (tail, tailBits) and appends buffered bytes
    void finish(uint32_t* tail, int* tailBits) {
        if (low >> (21 + bitsLeft)) {
            out.push_back(uint8_t(bufferedByte + 1));
            for (int i = 0; i < numBuffered - 1; i++) out.push_back(0x00);
            low -= 1u << (21 + bitsLeft);
        } else {
            if (numBuffered > 0) out.push_back(uint8_t(bufferedByte));
            for (int i = 0; i < numBuffered - 1; i++) out.push_back(0xFF);
        }
        *tailBits = 13 + bitsLeft;
        *tail = (low >> 8) & ((1u << *tailBits) - 1);
    }
};

// ---------------------------------------------------------------------------
// residual_coding (spec 7.3.8.11)
// ---------------------------------------------------------------------------

static int selectScan(int log2, bool luma, int intraMode) {
    if (intraMode >= 0) {
        int maxLog2 = luma ? 3 : 2;   // 4:2:0
        if (log2 <= maxLog2) {
            if (intraMode >= 22 && intraMode <= 30) return 1;
            if (intraMode >= 6 && intraMode <= 14) return 2;
        }
    }
    return 0;
}

static int firstSigCtx(int log2, bool luma, int scanType) {
    if (log2 == 2) return 0;
    if (log2 == 3) return (scanType != 0 && luma) ? 15 : 9;
    return luma ? 21 : 12;
}

static void encodeResidual(Cabac& cb, const int32_t* levels, int log2,
                           bool luma, int intraMode, bool signHiding) {
    const int n = 1 << log2;
    const int st = selectScan(log2, luma, intraMode);
    const int32_t* scan = g_scans.scan[st][log2 - 2].data();
    const int32_t* cgScan = g_scans.scanCG[st][log2 - 2].data();
    const int ncg = n > 4 ? (n >> 2) : 1;
    const int fctx = firstSigCtx(log2, luma, st);

    int32_t vals[32 * 32];
    int lastScanPos = -1;
    for (int i = 0; i < n * n; i++) {
        vals[i] = levels[scan[i]];
        if (vals[i]) lastScanPos = i;
    }
    // caller guarantees a nonzero TU
    int posLast = scan[lastScanPos];

    uint8_t cgFlags[8][8];
    memset(cgFlags, 0, sizeof(cgFlags));
    for (int i = 0; i <= lastScanPos; i++)
        if (vals[i]) {
            int p = scan[i];
            cgFlags[(p >> log2) >> 2][(p & (n - 1)) >> 2] = 1;
        }

    // ---- last position ----
    int lx = posLast & (n - 1), ly = posLast >> log2;
    if (st == 2) { int t = lx; lx = ly; ly = t; }
    int maxGroup = (log2 << 1) - 1;
    int baseX, baseY, shift;
    if (luma) {
        baseX = CTX_LAST_X + 3 * (log2 - 2) + (log2 == 5 ? 1 : 0);
        baseY = CTX_LAST_Y + 3 * (log2 - 2) + (log2 == 5 ? 1 : 0);
        shift = (log2 + 1) >> 2;
    } else {
        baseX = CTX_LAST_X + 15;
        baseY = CTX_LAST_Y + 15;
        shift = log2 - 2;
    }
    uint32_t sufBits = 0;
    int sufLen = 0;
    const int poss[2] = {lx, ly};
    const int bases[2] = {baseX, baseY};
    for (int i = 0; i < 2; i++) {
        int g = kGroupIdx[poss[i]];
        for (int j = 0; j < g; j++) cb.encodeBin(1, bases[i] + (j >> shift));
        if (g < maxGroup) cb.encodeBin(0, bases[i] + (g >> shift));
        if (g > 3) {
            int sl = (g >> 1) - 1;
            sufBits = (sufBits << sl) | uint32_t(poss[i] & ((1 << sl) - 1));
            sufLen += sl;
        }
    }
    if (sufLen) cb.encodeBinsEP(sufBits, sufLen);

    const int sigBank = CTX_SIG + (luma ? 0 : 27);
    const int cgBank = CTX_SIG_CG + (luma ? 0 : 2);
    const int oneBank = CTX_ONE + (luma ? 0 : 16);
    const int absBank = CTX_ABS + (luma ? 0 : 4);
    const int lastCG = lastScanPos >> 4;

    int c1 = 1;
    for (int cg = lastCG; cg >= 0; cg--) {
        int cgBlk = ncg > 1 ? cgScan[cg] : 0;
        int cgy = cgBlk / ncg, cgx = cgBlk % ncg;
        const int32_t* inCG = vals + cg * 16;
        int nzPos[16], numNZ = 0;
        for (int k = 0; k < 16; k++)
            if (inCG[k]) nzPos[numNZ++] = k;

        int right = cgx + 1 < ncg ? cgFlags[cgy][cgx + 1] : 0;
        int below = cgy + 1 < ncg ? cgFlags[cgy + 1][cgx] : 0;
        if (cg == lastCG || cg == 0) {
            cgFlags[cgy][cgx] = 1;
        } else {
            cb.encodeBin(numNZ ? 1 : 0, cgBank + (right | below));
            if (!numNZ) continue;
        }
        int pattern = ncg > 1 ? (right + 2 * below) : 0;

        // significance flags
        int start = cg < lastCG ? 15 : (lastScanPos & 15) - 1;
        int codedAny = cg == lastCG ? 1 : 0;
        for (int k = start; k >= 0; k--) {
            if (k == 0 && cg > 0 && cg != lastCG && codedAny == 0) break;
            int sp = cg * 16 + k;
            int sig = vals[sp] ? 1 : 0;
            int blkPos = scan[sp];
            int sctx;
            int x = blkPos & (n - 1), y = blkPos >> log2;
            if (log2 == 2)
                sctx = kSigPattern[4][(y << 2) | x];
            else if (blkPos == 0)
                sctx = 0;
            else {
                int cnt = kSigPattern[pattern][((y & 3) << 2) | (x & 3)];
                bool firstCG = x < 4 && y < 4;
                sctx = cnt + fctx + ((luma && !firstCG) ? 3 : 0);
            }
            cb.encodeBin(sig, sigBank + sctx);
            codedAny += sig;
        }
        if (!numNZ) continue;

        // levels in reverse scan order
        int absv[16], sgn[16];
        for (int i = 0; i < numNZ; i++) {
            int v = inCG[nzPos[numNZ - 1 - i]];
            absv[i] = v < 0 ? -v : v;
            sgn[i] = v < 0 ? 1 : 0;
        }
        bool hide = signHiding && (nzPos[numNZ - 1] - nzPos[0] >= 4);

        int ctxSet = ((cg > 0 && luma) ? 2 : 0) + ((c1 & 3) ? 0 : 1);
        c1 = 1;
        int base1 = oneBank + 4 * ctxSet;
        int numC1 = numNZ < 8 ? numNZ : 8;
        int firstC2 = -1;
        for (int i = 0; i < numC1; i++) {
            int sym = absv[i] > 1;
            cb.encodeBin(sym, base1 + c1);
            if (sym) {
                c1 = 0;
                if (firstC2 < 0) firstC2 = i;
            } else if (c1 > 0 && c1 < 3) {
                c1++;
            }
        }
        if (c1 == 0 && firstC2 >= 0)
            cb.encodeBin(absv[firstC2] > 2 ? 1 : 0, absBank + ctxSet);

        int nsign = numNZ - (hide ? 1 : 0);
        uint32_t signBits = 0;
        for (int i = 0; i < nsign; i++) signBits = (signBits << 1) | sgn[i];
        if (nsign) cb.encodeBinsEP(signBits, nsign);

        if (c1 == 0 || numNZ > 8) {
            int goRice = 0;
            int threshold = 3;
            int firstCoeff2 = 1;
            int startIdx = firstC2 >= 0 ? firstC2 : 0;
            for (int i = startIdx; i < numNZ; i++) {
                if (firstC2 < 0 && i < 8) continue;
                int baseLevel = i < 8 ? 2 + firstCoeff2 : 1;
                if (absv[i] >= baseLevel) {
                    uint32_t code = uint32_t(absv[i] - baseLevel);
                    if ((code >> goRice) < 3) {
                        int len = code >> goRice;
                        cb.encodeBinsEP((((1u << (len + 1)) - 2) << goRice)
                                        + (code & ((1u << goRice) - 1)),
                                        len + 1 + goRice);
                    } else {
                        uint32_t cn = (code >> goRice) - 3;
                        int len = 0;
                        while ((1u << (len + 1)) <= cn + 1) len++;
                        cn -= (1u << len) - 1;
                        cn = (cn << goRice) + (code & ((1u << goRice) - 1));
                        cb.encodeBinsEP((1u << (3 + len + 1)) - 2, 3 + len + 1);
                        cb.encodeBinsEP(cn, len + goRice);
                    }
                    if (absv[i] > threshold && goRice <= 3) {
                        goRice++;
                        threshold <<= 1;
                    }
                }
                firstCoeff2 = 0;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// intra CU syntax (uniform grid; spec 7.3.8.5-7.3.8.11 subset)
// ---------------------------------------------------------------------------

static void deriveMPM(int left, int above, int mpm[3]) {
    if (left == above) {
        if (left < 2) { mpm[0] = 0; mpm[1] = 1; mpm[2] = 26; return; }
        mpm[0] = left;
        mpm[1] = 2 + ((left + 29) % 32);
        mpm[2] = 2 + ((left - 2 + 1) % 32);
        return;
    }
    mpm[0] = left; mpm[1] = above;
    if (left != 0 && above != 0) mpm[2] = 0;
    else if (left != 1 && above != 1) mpm[2] = 1;
    else mpm[2] = 26;
}

static void encodeIntraLumaMode(Cabac& cb, int mode, const int mpm[3]) {
    int idx = mode == mpm[0] ? 0 : mode == mpm[1] ? 1 : mode == mpm[2] ? 2 : -1;
    if (idx >= 0) {
        cb.encodeBin(1, CTX_INTRA_LUMA);
        cb.encodeBinEP(idx == 0 ? 0 : 1);
        if (idx) cb.encodeBinEP(idx - 1);
    } else {
        cb.encodeBin(0, CTX_INTRA_LUMA);
        int s[3] = {mpm[0], mpm[1], mpm[2]};
        // sort descending
        for (int a = 0; a < 2; a++)
            for (int b = a + 1; b < 3; b++)
                if (s[b] > s[a]) { int t = s[a]; s[a] = s[b]; s[b] = t; }
        int rem = mode;
        for (int a = 0; a < 3; a++)
            if (rem > s[a]) rem--;
        cb.encodeBinsEP(uint32_t(rem), 5);
    }
}

static bool anyNonzero(const int32_t* p, int count) {
    for (int i = 0; i < count; i++)
        if (p[i]) return true;
    return false;
}

// ---------------------------------------------------------------------------
// SAO per-CTU syntax (spec 7.3.8.3). Params packed as int32[18] per CTU:
// [component(luma,cb,cr)] x [type(0=off,1=BO,2=EO), aux(band/eo-class),
// o0..o3]. Merge-left/up decided by full-params equality, mirroring
// bitstream/ctu_syntax.py encode_sao_ctu (golden-tested byte-identical).
// ---------------------------------------------------------------------------

static void encodeSaoCtu(Cabac& cb, const int32_t* cur, const int32_t* left,
                         const int32_t* up, int bitDepth) {
    int bd = bitDepth < 10 ? bitDepth : 10;
    int cmax = (1 << (bd - 5)) - 1;
    if (left) {
        bool m = memcmp(cur, left, 18 * sizeof(int32_t)) == 0;
        cb.encodeBin(m ? 1 : 0, CTX_SAO_MERGE);
        if (m) return;
    }
    if (up) {
        bool m = memcmp(cur, up, 18 * sizeof(int32_t)) == 0;
        cb.encodeBin(m ? 1 : 0, CTX_SAO_MERGE);
        if (m) return;
    }
    static const int GRP[2][2] = {{0, -1}, {1, 2}};
    for (int gi = 0; gi < 2; gi++) {
        int t = cur[GRP[gi][0] * 6 + 0];
        cb.encodeBin(t == 0 ? 0 : 1, CTX_SAO_TYPE);
        if (t == 0) continue;
        cb.encodeBinEP(t == 2 ? 1 : 0);
        for (int k = 0; k < 2; k++) {
            int comp = GRP[gi][k];
            if (comp < 0) break;
            int typ = cur[comp * 6 + 0];
            int aux = cur[comp * 6 + 1];
            const int32_t* offs = cur + comp * 6 + 2;
            for (int i = 0; i < 4; i++) {
                int a = offs[i] < 0 ? -offs[i] : offs[i];
                for (int j = 0; j < a; j++) cb.encodeBinEP(1);
                if (a < cmax) cb.encodeBinEP(0);
            }
            if (typ == 1) {                       // BO: signs + band position
                for (int i = 0; i < 4; i++)
                    if (offs[i] != 0) cb.encodeBinEP(offs[i] < 0 ? 1 : 0);
                cb.encodeBinsEP(uint32_t(aux), 5);
            } else if (comp == 0 || comp == 1) {  // EO class (cr inherits cb)
                cb.encodeBinsEP(uint32_t(aux), 2);
            }
        }
    }
}

// cu_qp_delta_abs + sign (spec 7.3.8.10 / 9.3.3.8): TU prefix (cMax 5) with
// ctx bin0 then ctx bin1+, EG0 bypass suffix, bypass sign.
static void encodeQpDelta(Cabac& cb, int delta) {
    int a = delta < 0 ? -delta : delta;
    int prefix = a < 5 ? a : 5;
    for (int i = 0; i < prefix; i++)
        cb.encodeBin(1, CTX_DELTA_QP + (i == 0 ? 0 : 1));
    if (prefix < 5) {
        cb.encodeBin(0, CTX_DELTA_QP + (prefix == 0 ? 0 : 1));
    } else {
        uint32_t v = uint32_t(a - 5);
        int k = 0;
        while (v >= (1u << k)) {
            cb.encodeBinEP(1);
            v -= 1u << k;
            k++;
        }
        cb.encodeBinEP(0);
        if (k) cb.encodeBinsEP(v, k);
    }
    if (a) cb.encodeBinEP(delta < 0 ? 1 : 0);
}

// Per-slice cu_qp_delta chain state: one delta per quantization group
// (QG == CTU in this encoder), coded at the first CU with a coded cbf.
struct QpChain {
    const int32_t* qpMap = nullptr;   // [ncu] intended QP per CTU, or null
    int qpPrev = 0;                   // decoder's qPY_PREV
    int ctuQp = 0;
    bool pending = false;
    void startCtu(int idx) {
        if (!qpMap) return;
        ctuQp = qpMap[idx];
        pending = true;
    }
    // call after cbf bins, before residuals; codes the delta when due
    void maybeCode(Cabac& cb, bool hasCbf) {
        if (!qpMap || !pending || !hasCbf) return;
        encodeQpDelta(cb, ctuQp - qpPrev);
        qpPrev = ctuQp;
        pending = false;
    }
};

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

// Encode a full intra slice's CTU data (uniform CU grid, 2Nx2N, DM chroma,
// one luma TU = CU). Returns number of payload bytes written to outBuf,
// with *tailValue/*tailBits the final non-byte-aligned CABAC tail.
// modes: [rows*cols]; levelsY: [rows*cols, n*n]; levelsCb/Cr:
// [rows*cols, (n >> (chroma444 ? 0 : 1))^2].
// Extras (each may be null/0): sao = int32[ncu*18] per-CTU SAO params;
// qpMap = int32[ncu] per-CTU QP (AQ/cuTree); lossless = transquant bypass
// per CU; chroma444 = 4:4:4 (chroma TU at luma size).
int asuna_encode_intra_slice(
    const int32_t* modes, const int32_t* levelsY, const int32_t* levelsCb,
    const int32_t* levelsCr, int rows, int cols, int log2cu, int qp,
    int partModeCoded, int chromaPresent, int signHiding,
    const int32_t* sao, const int32_t* qpMap, int bitDepth,
    int lossless, int chroma444,
    uint8_t* outBuf, int outCap, uint32_t* tailValue, int* tailBits)
{
    Cabac cb;
    cb.init(2, qp);   // I-slice
    const int n = 1 << log2cu;
    const int clog2 = chroma444 ? log2cu : log2cu - 1;
    const int nc = 1 << clog2;
    const int ncu = rows * cols;
    QpChain qc;
    qc.qpMap = qpMap;
    qc.qpPrev = qp;
    for (int r = 0; r < rows; r++) {
        for (int c = 0; c < cols; c++) {
            int idx = r * cols + c;
            int mode = modes[idx];
            const int32_t* ly = levelsY + (size_t)idx * n * n;
            const int32_t* lcb = levelsCb + (size_t)idx * nc * nc;
            const int32_t* lcr = levelsCr + (size_t)idx * nc * nc;

            if (sao)
                encodeSaoCtu(cb, sao + (size_t)idx * 18,
                             c > 0 ? sao + (size_t)(idx - 1) * 18 : nullptr,
                             r > 0 ? sao + (size_t)(idx - cols) * 18 : nullptr,
                             bitDepth);
            qc.startCtu(idx);
            if (lossless) cb.encodeBin(1, CTX_TQ_BYPASS);
            if (partModeCoded) cb.encodeBin(1, CTX_PART_SIZE);
            int mpm[3];
            deriveMPM(c > 0 ? modes[idx - 1] : 1, 1, mpm);
            encodeIntraLumaMode(cb, mode, mpm);
            if (chromaPresent) cb.encodeBin(0, CTX_INTRA_CHROMA);  // DM

            int cbfY = anyNonzero(ly, n * n) ? 1 : 0;
            int cbfCb = chromaPresent && anyNonzero(lcb, nc * nc) ? 1 : 0;
            int cbfCr = chromaPresent && anyNonzero(lcr, nc * nc) ? 1 : 0;
            if (chromaPresent) {
                cb.encodeBin(cbfCb, CTX_QT_CBF + 2);
                cb.encodeBin(cbfCr, CTX_QT_CBF + 2);
            }
            cb.encodeBin(cbfY, CTX_QT_CBF + 1);
            qc.maybeCode(cb, cbfY || cbfCb || cbfCr);
            if (cbfY) encodeResidual(cb, ly, log2cu, true, mode, signHiding);
            if (cbfCb) encodeResidual(cb, lcb, clog2, false, mode, signHiding);
            if (cbfCr) encodeResidual(cb, lcr, clog2, false, mode, signHiding);

            cb.encodeBinTrm(idx == ncu - 1 ? 1 : 0);
        }
    }
    cb.finish(tailValue, tailBits);
    if ((int)cb.out.size() > outCap) return -1;
    memcpy(outBuf, cb.out.data(), cb.out.size());
    return (int)cb.out.size();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// P-slice syntax (uniform 2Nx2N grid, one L0 ref) — mirrors
// bitstream/inter_syntax.py (golden-tested byte-identical).
// ---------------------------------------------------------------------------

namespace {

struct CUState {
    uint8_t decoded = 0;
    uint8_t isIntra = 0;
    uint8_t skip = 0;
    int32_t mvx = 0, mvy = 0;       // quarter-pel
    int32_t intraMode = 1;
};

struct Grid {
    std::vector<CUState> cu;
    int rows, cols;
    CUState* at(int r, int c) {
        if (r < 0 || c < 0 || r >= rows || c >= cols) return nullptr;
        CUState* s = &cu[r * cols + c];
        return s->decoded ? s : nullptr;
    }
};

static int mergeCandidates(Grid& g, int r, int c, int maxCands,
                           int32_t (*out)[2]) {
    int n = 0;
    auto interMv = [&](int rr, int cc, int32_t* mv) -> bool {
        CUState* s = g.at(rr, cc);
        if (!s || s->isIntra) return false;
        mv[0] = s->mvx; mv[1] = s->mvy;
        return true;
    };
    int32_t a1[2], b1[2], b0[2], b2[2];
    bool hasA1 = interMv(r, c - 1, a1);
    bool hasB1 = interMv(r - 1, c, b1);
    bool hasB0 = interMv(r - 1, c + 1, b0);
    bool hasB2 = interMv(r - 1, c - 1, b2);
    if (hasA1) { out[n][0] = a1[0]; out[n][1] = a1[1]; n++; }
    if (hasB1 && !(hasA1 && b1[0] == a1[0] && b1[1] == a1[1])) {
        out[n][0] = b1[0]; out[n][1] = b1[1]; n++;
    }
    if (hasB0 && !(hasB1 && b0[0] == b1[0] && b0[1] == b1[1])) {
        out[n][0] = b0[0]; out[n][1] = b0[1]; n++;
    }
    if (n < 4 && hasB2 && !(hasA1 && b2[0] == a1[0] && b2[1] == a1[1])
        && !(hasB1 && b2[0] == b1[0] && b2[1] == b1[1])) {
        out[n][0] = b2[0]; out[n][1] = b2[1]; n++;
    }
    while (n < maxCands) { out[n][0] = 0; out[n][1] = 0; n++; }
    return maxCands;
}

static void amvpCandidates(Grid& g, int r, int c, int32_t (*out)[2]) {
    int n = 0;
    auto interMv = [&](int rr, int cc, int32_t* mv) -> bool {
        CUState* s = g.at(rr, cc);
        if (!s || s->isIntra) return false;
        mv[0] = s->mvx; mv[1] = s->mvy;
        return true;
    };
    int32_t a[2], b[2];
    bool hasA = interMv(r, c - 1, a);
    if (hasA) { out[n][0] = a[0]; out[n][1] = a[1]; n++; }
    bool hasB = false;
    const int nb[3][2] = {{r - 1, c + 1}, {r - 1, c}, {r - 1, c - 1}};
    for (int i = 0; i < 3 && !hasB; i++)
        hasB = interMv(nb[i][0], nb[i][1], b);
    if (hasB && !(hasA && b[0] == a[0] && b[1] == a[1])) {
        out[n][0] = b[0]; out[n][1] = b[1]; n++;
    }
    while (n < 2) { out[n][0] = 0; out[n][1] = 0; n++; }
}

static void encodeMergeIdx(Cabac& cb, int idx, int maxCands) {
    if (maxCands <= 1) return;
    cb.encodeBin(idx > 0 ? 1 : 0, CTX_MERGE_IDX);
    if (idx > 0) {
        for (int i = 1; i < idx; i++) cb.encodeBinEP(1);
        if (idx < maxCands - 1) cb.encodeBinEP(0);
    }
}

static void writeEG1(Cabac& cb, uint32_t v) {
    int k = 1;
    while (v >= (1u << k)) {
        cb.encodeBinEP(1);
        v -= 1u << k;
        k++;
    }
    cb.encodeBinEP(0);
    cb.encodeBinsEP(v, k);
}

static void encodeMvd(Cabac& cb, int mvdx, int mvdy) {
    int gx0 = mvdx != 0, gy0 = mvdy != 0;
    cb.encodeBin(gx0, CTX_MVD);
    cb.encodeBin(gy0, CTX_MVD);
    if (gx0) cb.encodeBin(abs(mvdx) > 1 ? 1 : 0, CTX_MVD + 1);
    if (gy0) cb.encodeBin(abs(mvdy) > 1 ? 1 : 0, CTX_MVD + 1);
    const int vs[2] = {mvdx, mvdy};
    for (int i = 0; i < 2; i++) {
        int v = vs[i];
        if (v != 0) {
            if (abs(v) > 1) writeEG1(cb, uint32_t(abs(v) - 2));
            cb.encodeBinEP(v < 0 ? 1 : 0);
        }
    }
}

static void deriveMPMState(Grid& g, int r, int c, int mpm[3]) {
    CUState* left = g.at(r, c - 1);
    int cl = (left && left->isIntra) ? left->intraMode : 1;
    deriveMPM(cl, 1, mpm);
}

}  // namespace

extern "C" {

// Encode a P-slice's CTU data. Per-CU inputs (raster, [ncu]):
//   useIntra (0/1), intraModes, mvxQ, mvyQ (quarter-pel from ME),
//   levelsY [ncu, n*n], levelsCb/Cr [ncu, (n/2)^2].
// Performs the merge/AMVP/skip signaling decisions exactly like the Python
// reference (merge when the ME MV equals a candidate; skip when no
// residual), keeping the decoder-derived CU grid in sync.
int asuna_encode_p_slice(
    const uint8_t* useIntra, const int32_t* intraModes,
    const int32_t* mvxQ, const int32_t* mvyQ,
    const int32_t* levelsY, const int32_t* levelsCb, const int32_t* levelsCr,
    int rows, int cols, int log2cu, int qp, int maxMerge, int signHiding,
    const int32_t* sao, const int32_t* qpMap, int bitDepth,
    uint8_t* outBuf, int outCap, uint32_t* tailValue, int* tailBits)
{
    Cabac cb;
    cb.init(1, qp);   // P-slice ctx row
    const int n = 1 << log2cu;
    const int nc = n >> 1;
    const int ncu = rows * cols;
    Grid grid;
    grid.rows = rows; grid.cols = cols;
    grid.cu.resize(ncu);
    QpChain qc;
    qc.qpMap = qpMap;
    qc.qpPrev = qp;

    for (int r = 0; r < rows; r++) {
        for (int c = 0; c < cols; c++) {
            int idx = r * cols + c;
            const int32_t* ly = levelsY + (size_t)idx * n * n;
            const int32_t* lcb = levelsCb + (size_t)idx * nc * nc;
            const int32_t* lcr = levelsCr + (size_t)idx * nc * nc;
            bool hasResid = anyNonzero(ly, n * n) || anyNonzero(lcb, nc * nc)
                            || anyNonzero(lcr, nc * nc);
            int cbfY = anyNonzero(ly, n * n);
            int cbfCb = anyNonzero(lcb, nc * nc);
            int cbfCr = anyNonzero(lcr, nc * nc);

            if (sao)
                encodeSaoCtu(cb, sao + (size_t)idx * 18,
                             c > 0 ? sao + (size_t)(idx - 1) * 18 : nullptr,
                             r > 0 ? sao + (size_t)(idx - cols) * 18 : nullptr,
                             bitDepth);
            qc.startCtu(idx);

            // skip flag context from left/above skip states
            CUState* l = grid.at(r, c - 1);
            CUState* a = grid.at(r - 1, c);
            int sctx = (l && l->skip ? 1 : 0) + (a && a->skip ? 1 : 0);

            if (!useIntra[idx]) {
                int32_t mv[2] = {mvxQ[idx], mvyQ[idx]};
                int32_t cands[5][2];
                mergeCandidates(grid, r, c, maxMerge, cands);
                int mergeIdx = -1;
                for (int i = 0; i < maxMerge; i++)
                    if (cands[i][0] == mv[0] && cands[i][1] == mv[1]) {
                        mergeIdx = i;
                        break;
                    }
                bool isSkip = mergeIdx >= 0 && !hasResid;
                cb.encodeBin(isSkip ? 1 : 0, CTX_SKIP + sctx);
                if (isSkip) {
                    encodeMergeIdx(cb, mergeIdx, maxMerge);
                    grid.cu[idx] = {1, 0, 1, mv[0], mv[1], 1};
                    cb.encodeBinTrm(idx == ncu - 1 ? 1 : 0);
                    continue;
                }
                cb.encodeBin(0, CTX_PRED_MODE);      // inter
                cb.encodeBin(1, CTX_PART_SIZE);      // 2Nx2N
                int rqt;
                if (mergeIdx >= 0) {
                    cb.encodeBin(1, CTX_MERGE_FLAG);
                    encodeMergeIdx(cb, mergeIdx, maxMerge);
                    rqt = 1;                          // inferred for 2Nx2N merge
                } else {
                    cb.encodeBin(0, CTX_MERGE_FLAG);
                    int32_t preds[2][2];
                    amvpCandidates(grid, r, c, preds);
                    int c0 = abs(mv[0] - preds[0][0]) + abs(mv[1] - preds[0][1]);
                    int c1 = abs(mv[0] - preds[1][0]) + abs(mv[1] - preds[1][1]);
                    int flag = c0 <= c1 ? 0 : 1;
                    encodeMvd(cb, mv[0] - preds[flag][0], mv[1] - preds[flag][1]);
                    cb.encodeBin(flag, CTX_MVP_IDX);
                    rqt = hasResid ? 1 : 0;
                    cb.encodeBin(rqt, CTX_QT_ROOT_CBF);
                }
                if (rqt) {
                    cb.encodeBin(cbfCb, CTX_QT_CBF + 2);
                    cb.encodeBin(cbfCr, CTX_QT_CBF + 2);
                    if (cbfCb || cbfCr)
                        cb.encodeBin(cbfY, CTX_QT_CBF + 1);
                    qc.maybeCode(cb, cbfY || cbfCb || cbfCr);
                    if (cbfY) encodeResidual(cb, ly, log2cu, true, -1, signHiding);
                    if (cbfCb) encodeResidual(cb, lcb, log2cu - 1, false, -1, signHiding);
                    if (cbfCr) encodeResidual(cb, lcr, log2cu - 1, false, -1, signHiding);
                }
                grid.cu[idx] = {1, 0, 0, mv[0], mv[1], 1};
            } else {
                cb.encodeBin(0, CTX_SKIP + sctx);
                cb.encodeBin(1, CTX_PRED_MODE);      // intra
                cb.encodeBin(1, CTX_PART_SIZE);
                int mpm[3];
                deriveMPMState(grid, r, c, mpm);
                encodeIntraLumaMode(cb, intraModes[idx], mpm);
                cb.encodeBin(0, CTX_INTRA_CHROMA);   // DM
                cb.encodeBin(cbfCb, CTX_QT_CBF + 2);
                cb.encodeBin(cbfCr, CTX_QT_CBF + 2);
                cb.encodeBin(cbfY, CTX_QT_CBF + 1);
                qc.maybeCode(cb, cbfY || cbfCb || cbfCr);
                if (cbfY) encodeResidual(cb, ly, log2cu, true, intraModes[idx], signHiding);
                if (cbfCb) encodeResidual(cb, lcb, log2cu - 1, false, intraModes[idx], signHiding);
                if (cbfCr) encodeResidual(cb, lcr, log2cu - 1, false, intraModes[idx], signHiding);
                grid.cu[idx] = {1, 1, 0, 0, 0, intraModes[idx]};
            }
            cb.encodeBinTrm(idx == ncu - 1 ? 1 : 0);
        }
    }
    cb.finish(tailValue, tailBits);
    if ((int)cb.out.size() > outCap) return -1;
    memcpy(outBuf, cb.out.data(), cb.out.size());
    return (int)cb.out.size();
}

}  // extern "C"


// ---------------------------------------------------------------------------
// CTU32 quadtree I/P/B slices (depth 1-2): coding_quadtree per CTU with
// split_cu_flag contexts from the neighbours' depths (9.3.4.2.2), MPMs and
// merge/AMVP candidates from a cell grid of 32>>maxDepth pixels. The
// port's copy of the qt2 writer in x265_yuuki_asuna_tpu/native/
// asuna_native.cpp (asuna_encode_slice_qt2), cut to one reference per list
// and one TU per CU (no RQT), no SAO and no per-CU QP.
// ---------------------------------------------------------------------------

namespace qt2 {

// a CU's motion: dir 1 = L0, 2 = L1, 3 = bi; quarter-pel MVs
struct Motion {
    int dir = 1;
    int32_t mv0x = 0, mv0y = 0;
    int32_t mv1x = 0, mv1y = 0;
    bool sameAs(const Motion& o) const {
        if (dir != o.dir) return false;
        if ((dir & 1) && (mv0x != o.mv0x || mv0y != o.mv0y)) return false;
        if ((dir & 2) && (mv1x != o.mv1x || mv1y != o.mv1y)) return false;
        return true;
    }
};

struct QCell {
    uint8_t decoded = 0, isIntra = 0, skip = 0;
    Motion motion;
    int32_t intraMode = 1;
};

struct QGrid {
    std::vector<QCell> v;
    int gr, gc;
    const QCell* at(int y, int x) const {
        if (y < 0 || x < 0 || y >= gr || x >= gc) return nullptr;
        const QCell* p = &v[(size_t)y * gc + x];
        return p->decoded ? p : nullptr;
    }
    const Motion* inter(int y, int x) const {
        const QCell* p = at(y, x);
        return (p && !p->isIntra) ? &p->motion : nullptr;
    }
    bool interL0(int y, int x, int32_t* mv) const {
        const Motion* m = inter(y, x);
        if (!m) return false;
        mv[0] = m->mv0x; mv[1] = m->mv0y;
        return true;
    }
    void fill(int gy, int gx, int s, const QCell& cell) {
        for (int yy = gy; yy < gy + s; yy++)
            for (int xx = gx; xx < gx + s; xx++)
                v[(size_t)yy * gc + xx] = cell;
    }
};

// P-slice merge candidates (spatial A1, B1, B0, A0, B2; zero-MV fill)
static void mergeCandsP(const QGrid& g, int gy, int gx, int s, int maxCands,
                        int32_t (*out)[2]) {
    int32_t a1[2], b1[2], b0[2], a0[2], b2[2];
    bool hA1 = g.interL0(gy + s - 1, gx - 1, a1);
    bool hB1 = g.interL0(gy - 1, gx + s - 1, b1);
    bool hB0 = g.interL0(gy - 1, gx + s, b0);
    bool hA0 = g.interL0(gy + s, gx - 1, a0);
    bool hB2 = g.interL0(gy - 1, gx - 1, b2);
    auto eq = [](const int32_t* a, const int32_t* b) {
        return a[0] == b[0] && a[1] == b[1];
    };
    int n = 0;
    if (hA1) { out[n][0] = a1[0]; out[n][1] = a1[1]; n++; }
    if (hB1 && !(hA1 && eq(b1, a1))) { out[n][0] = b1[0]; out[n][1] = b1[1]; n++; }
    if (hB0 && !(hB1 && eq(b0, b1))) { out[n][0] = b0[0]; out[n][1] = b0[1]; n++; }
    if (hA0 && !(hA1 && eq(a0, a1))) { out[n][0] = a0[0]; out[n][1] = a0[1]; n++; }
    if (n < 4 && hB2 && !(hA1 && eq(b2, a1)) && !(hB1 && eq(b2, b1))) {
        out[n][0] = b2[0]; out[n][1] = b2[1]; n++;
    }
    while (n < maxCands) { out[n][0] = 0; out[n][1] = 0; n++; }
}

// P-slice AMVP candidates (A0/A1, then B0/B1/B2; zero-MV fill)
static void amvpCandsP(const QGrid& g, int gy, int gx, int s,
                       int32_t (*out)[2]) {
    int32_t a[2], b[2];
    bool hA = g.interL0(gy + s, gx - 1, a) || g.interL0(gy + s - 1, gx - 1, a);
    bool hB = g.interL0(gy - 1, gx + s, b) || g.interL0(gy - 1, gx + s - 1, b)
              || g.interL0(gy - 1, gx - 1, b);
    int n = 0;
    if (hA) { out[n][0] = a[0]; out[n][1] = a[1]; n++; }
    if (hB && !(hA && b[0] == a[0] && b[1] == a[1])) {
        out[n][0] = b[0]; out[n][1] = b[1]; n++;
    }
    while (n < 2) { out[n][0] = 0; out[n][1] = 0; n++; }
}

// B-slice merge candidates: the spatial ones, then the combined
// bi-predictive pairs (spec table 8-6 order), then bi zero-MV fill
static void mergeCandsB(const QGrid& g, int gy, int gx, int s, int maxCands,
                        Motion* out) {
    const Motion* a1 = g.inter(gy + s - 1, gx - 1);
    const Motion* b1 = g.inter(gy - 1, gx + s - 1);
    const Motion* b0 = g.inter(gy - 1, gx + s);
    const Motion* a0 = g.inter(gy + s, gx - 1);
    const Motion* b2 = g.inter(gy - 1, gx - 1);
    int n = 0;
    if (a1) out[n++] = *a1;
    if (b1 && !(a1 && b1->sameAs(*a1))) out[n++] = *b1;
    if (b0 && !(b1 && b0->sameAs(*b1))) out[n++] = *b0;
    if (a0 && !(a1 && a0->sameAs(*a1))) out[n++] = *a0;
    if (n < 4 && b2 && !(a1 && b2->sameAs(*a1)) && !(b1 && b2->sameAs(*b1)))
        out[n++] = *b2;
    static const int PAIRS[12][2] = {{0,1},{1,0},{0,2},{2,0},{1,2},{2,1},
                                     {0,3},{3,0},{1,3},{3,1},{2,3},{3,2}};
    int nOrig = n;
    int nPairs = nOrig * (nOrig - 1);
    if (nPairs > 12) nPairs = 12;
    for (int k = 0; k < nPairs && n < maxCands; k++) {
        int i = PAIRS[k][0], j = PAIRS[k][1];
        if ((out[i].dir & 1) && (out[j].dir & 2)) {
            Motion m;
            m.dir = 3;
            m.mv0x = out[i].mv0x; m.mv0y = out[i].mv0y;
            m.mv1x = out[j].mv1x; m.mv1y = out[j].mv1y;
            out[n++] = m;
        }
    }
    while (n < maxCands) {
        Motion z;
        z.dir = 3;
        out[n++] = z;
    }
}

// a neighbour's MV scaled by the POC distances tb / td (spec 8.5.3.2.7)
static void scaleMvB(int32_t mvx, int32_t mvy, int tb, int td,
                     int32_t* ox, int32_t* oy) {
    int tx = (td > 0) ? (16384 + (abs(td) >> 1)) / td
                      : -((16384 + (abs(td) >> 1)) / -td);
    int64_t dsf = (int64_t)tb * tx + 32;
    dsf >>= 6;
    if (dsf < -4096) dsf = -4096;
    if (dsf > 4095) dsf = 4095;
    auto s = [&](int32_t v) -> int32_t {
        int64_t val = dsf * v;
        int sign = val >= 0 ? 1 : -1;
        int64_t mag = (llabs(val) + 127) >> 8;
        int64_t res = sign * mag;
        if (res < -32768) res = -32768;
        if (res > 32767) res = 32767;
        return (int32_t)res;
    };
    *ox = s(mvx);
    *oy = s(mvy);
}

// B-slice AMVP candidates for list lx: left (A0, A1) unscaled then scaled,
// above (B0, B1, B2) unscaled, scaled only when no left neighbour is inter
static void amvpCandsB(const QGrid& g, int gy, int gx, int s, int lx,
                       int pocCur, int pocL0, int pocL1, int32_t (*out)[2]) {
    int pocTarget = lx == 0 ? pocL0 : pocL1;
    auto pocOf = [&](int which) { return which == 0 ? pocL0 : pocL1; };
    auto mvOf = [&](const Motion& m, int which, int32_t* v) {
        if (which == 0) { v[0] = m.mv0x; v[1] = m.mv0y; }
        else { v[0] = m.mv1x; v[1] = m.mv1y; }
    };
    auto noscale = [&](const Motion& m, int32_t* v) -> bool {
        if (m.dir & (1 << lx)) { mvOf(m, lx, v); return true; }
        int oy = 1 - lx;
        if ((m.dir & (1 << oy)) && pocOf(oy) == pocTarget) {
            mvOf(m, oy, v);
            return true;
        }
        return false;
    };
    auto scaled = [&](const Motion& m, int32_t* v) -> bool {
        for (int k = 0; k < 2; k++) {
            int which = k == 0 ? lx : 1 - lx;
            if (m.dir & (1 << which)) {
                int tb = pocCur - pocTarget;
                int td = pocCur - pocOf(which);
                if (td == 0) return false;
                int32_t raw[2];
                mvOf(m, which, raw);
                if (tb == td) { v[0] = raw[0]; v[1] = raw[1]; }
                else scaleMvB(raw[0], raw[1], tb, td, &v[0], &v[1]);
                return true;
            }
        }
        return false;
    };
    const int A_POS[2][2] = {{gy + s, gx - 1}, {gy + s - 1, gx - 1}};
    const int B_POS[3][2] = {{gy - 1, gx + s}, {gy - 1, gx + s - 1},
                             {gy - 1, gx - 1}};
    int n = 0;
    int32_t candA[2];
    bool haveA = false, leftAvail = false;
    for (int i = 0; i < 2 && !haveA; i++) {
        const Motion* m = g.inter(A_POS[i][0], A_POS[i][1]);
        if (m) {
            leftAvail = true;
            haveA = noscale(*m, candA);
        }
    }
    if (leftAvail && !haveA) {
        for (int i = 0; i < 2 && !haveA; i++) {
            const Motion* m = g.inter(A_POS[i][0], A_POS[i][1]);
            if (m) haveA = scaled(*m, candA);
        }
    }
    if (haveA) { out[n][0] = candA[0]; out[n][1] = candA[1]; n++; }
    for (int i = 0; i < 3; i++) {
        const Motion* m = g.inter(B_POS[i][0], B_POS[i][1]);
        if (m) {
            int32_t v[2];
            if (noscale(*m, v)) { out[n][0] = v[0]; out[n][1] = v[1]; n++; break; }
        }
    }
    if (!leftAvail && n < 2) {
        for (int i = 0; i < 3; i++) {
            const Motion* m = g.inter(B_POS[i][0], B_POS[i][1]);
            if (m) {
                int32_t v[2];
                if (scaled(*m, v)) { out[n][0] = v[0]; out[n][1] = v[1]; n++; break; }
            }
        }
    }
    if (n == 2 && out[0][0] == out[1][0] && out[0][1] == out[1][1]) n = 1;
    while (n < 2) { out[n][0] = 0; out[n][1] = 0; n++; }
}

// mvd_coding + mvp_lx_flag: the predictor nearer the MV (ties: the first)
static void codeMvdMvp(Cabac& cb, int32_t mx, int32_t my,
                       const int32_t (*preds)[2]) {
    int c0 = abs(mx - preds[0][0]) + abs(my - preds[0][1]);
    int c1 = abs(mx - preds[1][0]) + abs(my - preds[1][1]);
    int flag = c0 <= c1 ? 0 : 1;
    encodeMvd(cb, mx - preds[flag][0], my - preds[flag][1]);
    cb.encodeBin(flag, CTX_MVP_IDX);
}

struct SliceCtx {
    Cabac* cb;
    QGrid* grid;
    const int32_t* lvY;       // CTU-local [32*32]
    const int32_t* lvCb;      // [16*16]
    const int32_t* lvCr;
    int gy0, gx0;             // CTU origin in cells
    int cellPx, minLog2;
    int maxMerge;
    int sliceType;            // 0=B, 1=P, 2=I
    int pocCur, pocL0, pocL1;
};

static void extractLv(const int32_t* src, int srcN, int oy, int ox, int px,
                      int32_t* dst) {
    for (int yy = 0; yy < px; yy++)
        memcpy(dst + yy * px, src + (oy + yy) * srcN + ox,
               px * sizeof(int32_t));
}

static void codeIntraPart(SliceCtx& S, int gy, int gx, int s, int mode,
                          const int32_t* qly, const int32_t* qcb,
                          const int32_t* qcr, int log2cu) {
    Cabac& cb = *S.cb;
    QGrid& g = *S.grid;
    const QCell* l = g.at(gy, gx - 1);
    int cl = (l && l->isIntra) ? l->intraMode : 1;
    int ca = 1;
    int ctbCells = 32 / S.cellPx;
    if ((gy % ctbCells) != 0) {     // above outside the CTB row: DC
        const QCell* ab = g.at(gy - 1, gx);
        ca = (ab && ab->isIntra) ? ab->intraMode : 1;
    }
    int mpm[3];
    deriveMPM(cl, ca, mpm);
    if (log2cu == S.minLog2) cb.encodeBin(1, CTX_PART_SIZE);   // 2Nx2N
    encodeIntraLumaMode(cb, mode, mpm);
    cb.encodeBin(0, CTX_INTRA_CHROMA);                         // DM
    int nl = 1 << log2cu, ncr = nl >> 1;
    int cbfY = anyNonzero(qly, nl * nl);
    int cbfCb = anyNonzero(qcb, ncr * ncr);
    int cbfCr = anyNonzero(qcr, ncr * ncr);
    cb.encodeBin(cbfCb, CTX_QT_CBF + 2);
    cb.encodeBin(cbfCr, CTX_QT_CBF + 2);
    cb.encodeBin(cbfY, CTX_QT_CBF + 1);
    if (cbfY) encodeResidual(cb, qly, log2cu, true, mode, 0);
    if (cbfCb) encodeResidual(cb, qcb, log2cu - 1, false, mode, 0);
    if (cbfCr) encodeResidual(cb, qcr, log2cu - 1, false, mode, 0);
    QCell cell;
    cell.decoded = 1; cell.isIntra = 1;
    cell.intraMode = mode;
    g.fill(gy, gx, s, cell);
}

// transform_tree + transform_unit of an inter 2Nx2N CU with one TU (spec
// 7.3.8.8/7.3.8.10; max_transform_hierarchy_depth_inter = 0)
static void codeInterTransformTree(SliceCtx& S, const int32_t* qly,
                                   const int32_t* qcb, const int32_t* qcr,
                                   int log2cu) {
    Cabac& cb = *S.cb;
    const int nl = 1 << log2cu, ncr = nl >> 1;
    int cbfCb = anyNonzero(qcb, ncr * ncr);
    int cbfCr = anyNonzero(qcr, ncr * ncr);
    cb.encodeBin(cbfCb, CTX_QT_CBF + 2);
    cb.encodeBin(cbfCr, CTX_QT_CBF + 2);
    int cbfY = anyNonzero(qly, nl * nl);
    if (cbfCb || cbfCr) cb.encodeBin(cbfY, CTX_QT_CBF + 1);
    if (cbfY) encodeResidual(cb, qly, log2cu, true, -1, 0);
    if (cbfCb) encodeResidual(cb, qcb, log2cu - 1, false, -1, 0);
    if (cbfCr) encodeResidual(cb, qcr, log2cu - 1, false, -1, 0);
}

static void codeCuQt2(SliceCtx& S, int gy, int gx, int s, int isIntra,
                      int mode, const Motion& motion) {
    Cabac& cb = *S.cb;
    QGrid& g = *S.grid;
    const int px = s * S.cellPx;
    const int log2cu = 31 - __builtin_clz(px);
    const int oy = (gy - S.gy0) * S.cellPx, ox = (gx - S.gx0) * S.cellPx;
    int32_t qly[32 * 32], qcb[16 * 16], qcr[16 * 16];
    extractLv(S.lvY, 32, oy, ox, px, qly);
    extractLv(S.lvCb, 16, oy / 2, ox / 2, px / 2, qcb);
    extractLv(S.lvCr, 16, oy / 2, ox / 2, px / 2, qcr);

    if (S.sliceType == 2) {            // I slice: no skip/pred_mode syntax
        codeIntraPart(S, gy, gx, s, mode, qly, qcb, qcr, log2cu);
        return;
    }
    const int ncr = px >> 1;
    bool hasResid = anyNonzero(qly, px * px) || anyNonzero(qcb, ncr * ncr)
                    || anyNonzero(qcr, ncr * ncr);
    const QCell* l = g.at(gy, gx - 1);
    const QCell* a = g.at(gy - 1, gx);
    int sctx = (l && l->skip ? 1 : 0) + (a && a->skip ? 1 : 0);
    if (isIntra) {
        cb.encodeBin(0, CTX_SKIP + sctx);
        cb.encodeBin(1, CTX_PRED_MODE);
        codeIntraPart(S, gy, gx, s, mode, qly, qcb, qcr, log2cu);
        return;
    }
    // merge when the motion equals a candidate; skip when there is no
    // residual
    int mergeIdx = -1;
    if (S.sliceType == 1) {
        int32_t cands[5][2];
        mergeCandsP(g, gy, gx, s, S.maxMerge, cands);
        for (int i = 0; i < S.maxMerge; i++)
            if (cands[i][0] == motion.mv0x && cands[i][1] == motion.mv0y) {
                mergeIdx = i;
                break;
            }
    } else {
        Motion cands[5];
        mergeCandsB(g, gy, gx, s, S.maxMerge, cands);
        for (int i = 0; i < S.maxMerge; i++)
            if (cands[i].sameAs(motion)) {
                mergeIdx = i;
                break;
            }
    }
    QCell cell;
    cell.decoded = 1;
    cell.motion = motion;
    bool isSkip = mergeIdx >= 0 && !hasResid;
    cb.encodeBin(isSkip ? 1 : 0, CTX_SKIP + sctx);
    if (isSkip) {
        encodeMergeIdx(cb, mergeIdx, S.maxMerge);
        cell.skip = 1;
        g.fill(gy, gx, s, cell);
        return;
    }
    cb.encodeBin(0, CTX_PRED_MODE);
    cb.encodeBin(1, CTX_PART_SIZE);
    int rqt;
    if (mergeIdx >= 0) {
        cb.encodeBin(1, CTX_MERGE_FLAG);
        encodeMergeIdx(cb, mergeIdx, S.maxMerge);
        rqt = 1;                        // inferred for 2Nx2N merge
    } else {
        cb.encodeBin(0, CTX_MERGE_FLAG);
        int32_t preds[2][2];
        if (S.sliceType == 0) {
            // inter_pred_idc: bi flag (context by CU depth), then L0/L1
            cb.encodeBin(motion.dir == 3 ? 1 : 0, CTX_INTER_DIR + 5 - log2cu);
            if (motion.dir != 3)
                cb.encodeBin(motion.dir == 1 ? 0 : 1, CTX_INTER_DIR + 4);
            if (motion.dir & 1) {
                amvpCandsB(g, gy, gx, s, 0, S.pocCur, S.pocL0, S.pocL1,
                           preds);
                codeMvdMvp(cb, motion.mv0x, motion.mv0y, preds);
            }
            if (motion.dir & 2) {
                amvpCandsB(g, gy, gx, s, 1, S.pocCur, S.pocL0, S.pocL1,
                           preds);
                codeMvdMvp(cb, motion.mv1x, motion.mv1y, preds);
            }
        } else {
            amvpCandsP(g, gy, gx, s, preds);
            codeMvdMvp(cb, motion.mv0x, motion.mv0y, preds);
        }
        rqt = hasResid ? 1 : 0;
        cb.encodeBin(rqt, CTX_QT_ROOT_CBF);
    }
    if (rqt) codeInterTransformTree(S, qly, qcb, qcr, log2cu);
    g.fill(gy, gx, s, cell);
}

struct CtuData {
    int sp0;
    const uint8_t* split16;        // [4] or null (depth 1)
    int ui32, m32;
    Motion mo32;
    const uint8_t* ui4;
    const int32_t* m4;
    Motion mo4[4];
    const uint8_t* ui8;            // [4*4] or null
    const int32_t* m8;
    Motion mo8[16];
};

static void codeCtuQt2(SliceCtx& S, const CtuData& D, int r, int c,
                       std::vector<uint8_t>& depth, int g) {
    Cabac& cb = *S.cb;
    int gc = S.grid->gc;
    int gy = g * r, gx = g * c;
    S.gy0 = gy; S.gx0 = gx;
    auto splitFlag = [&](int cy, int cx, int d, int sp) {
        int ctx = (cx > 0 && depth[(size_t)cy * gc + cx - 1] > d ? 1 : 0)
                + (cy > 0 && depth[(size_t)(cy - 1) * gc + cx] > d ? 1 : 0);
        cb.encodeBin(sp, CTX_SPLIT_CU + ctx);
    };
    auto setDepth = [&](int cy, int cx, int sc, uint8_t d) {
        for (int yy = cy; yy < cy + sc; yy++)
            for (int xx = cx; xx < cx + sc; xx++)
                depth[(size_t)yy * gc + xx] = d;
    };
    static const int QOFF[4][2] = {{0,0},{0,1},{1,0},{1,1}};
    splitFlag(gy, gx, 0, D.sp0);
    if (!D.sp0) {
        codeCuQt2(S, gy, gx, g, D.ui32, D.m32, D.mo32);
        setDepth(gy, gx, g, 0);
        return;
    }
    int half = g / 2;
    for (int q = 0; q < 4; q++) {
        int cy = gy + QOFF[q][0] * half, cx = gx + QOFF[q][1] * half;
        int sub = (S.cellPx == 8) && D.split16 && D.split16[q];
        if (S.cellPx == 8) splitFlag(cy, cx, 1, sub);
        if (!sub) {
            codeCuQt2(S, cy, cx, half, D.ui4[q], D.m4[q], D.mo4[q]);
            setDepth(cy, cx, half, 1);
        } else {
            for (int sq = 0; sq < 4; sq++) {
                int sy = cy + QOFF[sq][0], sx = cx + QOFF[sq][1];
                int k = q * 4 + sq;
                codeCuQt2(S, sy, sx, 1, D.ui8[k], D.m8[k], D.mo8[k]);
                depth[(size_t)sy * gc + sx] = 2;
            }
        }
    }
}

}  // namespace qt2

// Encode a CTU32 quadtree slice's CTU data. sliceType: 0 = B, 1 = P, 2 = I.
// Per-CTU inputs in raster CTU order: split [ncu], split16 [ncu*4] (depth
// 2, else null), the CU32 (ui32, m32, pdir32, mv32x/y, mv321x/y [ncu]), the
// z-order 16x16 CUs (ui4, m4, pdir4, mv4x/y, mv41x/y [ncu*4]) and 8x8 CUs
// (ui8, m8, pdir8, mv8x/y, mv81x/y [ncu*16]). In an I slice the ui*, pdir*
// and mv* arrays may be null; in a P slice the pdir* and L1 (mv*1*) arrays
// (every CU is L0). pdir: 1 = L0, 2 = L1, 3 = bi; a list's MV is read only
// where pdir uses it. levelsY [ncu, 32*32], levelsCb/Cr [ncu, 16*16]: each
// CTU's TU levels at their positions in the CTU. pocCur/pocL0/pocL1 scale
// the B slice's AMVP candidates. Returns the payload size, -1 when outBuf
// is too small.
extern "C" int asuna_encode_slice_qt2(
    int sliceType, int maxDepth,
    const uint8_t* split, const uint8_t* split16,
    const uint8_t* ui32, const int32_t* m32,
    const int32_t* pdir32, const int32_t* mv32x, const int32_t* mv32y,
    const int32_t* mv321x, const int32_t* mv321y,
    const uint8_t* ui4, const int32_t* m4,
    const int32_t* pdir4, const int32_t* mv4x, const int32_t* mv4y,
    const int32_t* mv41x, const int32_t* mv41y,
    const uint8_t* ui8, const int32_t* m8,
    const int32_t* pdir8, const int32_t* mv8x, const int32_t* mv8y,
    const int32_t* mv81x, const int32_t* mv81y,
    const int32_t* levelsY, const int32_t* levelsCb, const int32_t* levelsCr,
    int rows, int cols, int qp, int maxMerge,
    int pocCur, int pocL0, int pocL1,
    uint8_t* outBuf, int outCap, uint32_t* tailValue, int* tailBits)
{
    using namespace qt2;
    if (sliceType < 0 || sliceType > 2) return -2;
    Cabac cb;
    cb.init(sliceType, qp);
    const int ncu = rows * cols;
    const int g = 1 << maxDepth;
    QGrid grid;
    grid.gr = g * rows; grid.gc = g * cols;
    grid.v.resize((size_t)grid.gr * grid.gc);
    std::vector<uint8_t> depth((size_t)grid.gr * grid.gc, 0);
    static const uint8_t ONES[16] = {1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1};

    SliceCtx S;
    S.cb = &cb; S.grid = &grid;
    S.cellPx = 32 / g; S.minLog2 = 5 - maxDepth;
    S.maxMerge = maxMerge;
    S.sliceType = sliceType;
    S.pocCur = pocCur; S.pocL0 = pocL0; S.pocL1 = pocL1;
    const bool intra = sliceType == 2;
    // CU i's motion: pdir (1 without a pdir array), the used lists' MVs
    auto mot = [](const int32_t* pd, const int32_t* x0, const int32_t* y0,
                  const int32_t* x1, const int32_t* y1, size_t i) {
        Motion m;
        m.dir = pd ? pd[i] : 1;
        m.mv0x = (m.dir & 1) && x0 ? x0[i] : 0;
        m.mv0y = (m.dir & 1) && y0 ? y0[i] : 0;
        m.mv1x = (m.dir & 2) && x1 ? x1[i] : 0;
        m.mv1y = (m.dir & 2) && y1 ? y1[i] : 0;
        return m;
    };
    auto off = [](const int32_t* p, size_t o) { return p ? p + o : nullptr; };
    for (int r = 0; r < rows; r++) {
        for (int c = 0; c < cols; c++) {
            size_t idx = (size_t)r * cols + c;
            CtuData D;
            D.sp0 = split[idx] ? 1 : 0;
            D.split16 = split16 ? split16 + idx * 4 : nullptr;
            D.ui32 = intra ? 1 : ui32[idx];
            D.m32 = m32[idx];
            D.mo32 = mot(pdir32, mv32x, mv32y, mv321x, mv321y, idx);
            D.ui4 = intra ? ONES : ui4 + idx * 4;
            D.m4 = m4 + idx * 4;
            for (int q = 0; q < 4; q++)
                D.mo4[q] = mot(off(pdir4, idx * 4), off(mv4x, idx * 4),
                               off(mv4y, idx * 4), off(mv41x, idx * 4),
                               off(mv41y, idx * 4), q);
            D.ui8 = maxDepth < 2 ? nullptr : intra ? ONES : ui8 + idx * 16;
            D.m8 = maxDepth < 2 ? nullptr : m8 + idx * 16;
            if (maxDepth >= 2)
                for (int k = 0; k < 16; k++)
                    D.mo8[k] = mot(off(pdir8, idx * 16), off(mv8x, idx * 16),
                                   off(mv8y, idx * 16), off(mv81x, idx * 16),
                                   off(mv81y, idx * 16), k);
            S.lvY = levelsY + idx * 32 * 32;
            S.lvCb = levelsCb + idx * 16 * 16;
            S.lvCr = levelsCr + idx * 16 * 16;
            codeCtuQt2(S, D, r, c, depth, g);
            cb.encodeBinTrm(idx == (size_t)ncu - 1 ? 1 : 0);
        }
    }
    cb.finish(tailValue, tailBits);
    if ((int)cb.out.size() > outCap) return -1;
    memcpy(outBuf, cb.out.data(), cb.out.size());
    return (int)cb.out.size();
}
