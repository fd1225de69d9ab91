// Native slice-data entropy encoder (CABAC) for hevc_tpu_torch.
//
// C++ twin of hevc_tpu_torch/entropy/{cabac,contexts,residual,slice_enc}.py —
// same standard tables (H.265 9.3), same syntax walk; parity-tested
// byte-for-byte against the Python implementation. This is the host-side
// serial stage of the pipeline; it runs overlapped with device compute.
//
// API (extern "C"):
//   int hevc_encode_slice(const int32_t* depth8, const int32_t* modes8,
//                         const int32_t* coef_y, const int32_t* coef_cb,
//                         const int32_t* coef_cr,
//                         int pad_w, int pad_h, int qp,
//                         uint8_t* out, int out_cap);
// Returns number of bytes written (slice-data RBSP, byte-aligned,
// starts at CABAC init; includes the final flush), or -1 on error.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ----- standard tables (H.265 Table 9-46/9-47) -----
static const uint8_t kRangeTabLps[64][4] = {
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

static const uint8_t kTransIdxLps[64] = {
  0,0,1,2,2,4,4,5,6,7,8,9,9,11,11,12,13,13,15,15,16,16,18,18,19,19,21,21,
  22,22,23,24,24,25,26,26,27,27,28,29,29,30,30,30,31,32,32,33,33,33,34,34,
  35,35,35,36,36,36,37,37,37,38,38,63};

// ----- context layout (must match entropy/contexts.py LAYOUT order) -----
enum {
  CTX_SAO_MERGE = 0,          // 1
  CTX_SAO_TYPE = 1,           // 1
  CTX_SPLIT_CU = 2,           // 3
  CTX_TQ_BYPASS = 5,          // 1
  CTX_SKIP = 6,               // 3
  CTX_MERGE_FLAG = 9,         // 1
  CTX_MERGE_IDX = 10,         // 1
  CTX_PART_MODE = 11,         // 4
  CTX_PRED_MODE = 15,         // 1
  CTX_PREV_INTRA = 16,        // 1
  CTX_CHROMA_PRED = 17,       // 2
  CTX_INTER_DIR = 19,         // 5
  CTX_MVD = 24,               // 2
  CTX_REF_PIC = 26,           // 2
  CTX_DQP = 28,               // 3
  CTX_QT_CBF_LUMA = 31,       // 5
  CTX_QT_CBF_CHROMA = 36,     // 5
  CTX_TRANS_SUBDIV = 41,      // 3
  CTX_SIG_CG = 44,            // 4 (luma 2, chroma 2)
  CTX_SIG = 48,               // 44 (luma 28, chroma 16)
  CTX_LAST_X = 92,            // 30 (luma 15, chroma 15)
  CTX_LAST_Y = 122,           // 30
  CTX_ONE = 152,              // 24 (luma 16, chroma 8)
  CTX_ABS = 176,              // 6 (luma 4, chroma 2)
  CTX_MVP_IDX = 182,          // 1
  CTX_TS = 183,               // 2
  CTX_CQP_ADJ_F = 185,        // 1
  CTX_CQP_ADJ_I = 186,        // 1
  CTX_QT_ROOT_CBF = 187,      // 1 (appended; see entropy/contexts.py)
  NUM_CTX = 188
};

// I-slice (initType 0) init values, same order as entropy/contexts.py.
static const uint8_t kInitI[NUM_CTX] = {
  153, 200,
  139,141,157,
  154,
  154,154,154,
  154, 154,
  184,154,154,154,
  154,
  184,
  63,139,
  154,154,154,154,154,
  154,154,
  154,154,
  154,154,154,
  111,141,154,154,154,
  94,138,182,154,154,
  153,138,138,
  91,171,134,141,
  // sig luma 28
  111,111,125,110,110,94,124,108,124,107,125,141,179,153,125,
  107,125,141,179,153,125,107,125,141,179,153,125,141,
  // sig chroma 16
  140,139,182,182,152,136,152,136,153,136,139,111,136,139,111,111,
  // last_x 30
  110,110,124,125,140,153,125,127,140,109,111,143,127,111,79,
  108,123,63,154,154,154,154,154,154,154,154,154,154,154,154,
  // last_y 30
  110,110,124,125,140,153,125,127,140,109,111,143,127,111,79,
  108,123,63,154,154,154,154,154,154,154,154,154,154,154,154,
  // one 24
  140,92,137,138,140,152,138,139,153,74,149,92,139,107,122,152,
  140,179,166,182,140,227,122,197,
  // abs 6
  138,153,136,167,152,152,
  154,
  139,139,
  154,154,
  154
};

// P-slice (initType 1) init values (entropy/contexts.py rows[1]).
static const uint8_t kInitP[NUM_CTX] = {
  153, 185,
  107,139,126,
  154,
  197,185,201,
  110, 122,
  154,139,154,154,
  149,
  154,
  152,139,
  95,79,63,31,31,
  140,198,
  153,153,
  154,154,154,
  153,111,154,154,154,
  149,107,167,154,154,
  124,138,94,
  121,140,61,154,
  // sig luma 28
  155,154,139,153,139,123,123,63,153,166,183,140,136,153,154,
  166,183,140,136,153,154,166,183,140,136,153,154,140,
  // sig chroma 16
  170,153,123,123,107,121,107,121,167,151,183,140,151,183,140,140,
  // last_x 30
  125,110,94,110,95,79,125,111,110,78,110,111,111,95,94,
  108,123,108,154,154,154,154,154,154,154,154,154,154,154,154,
  // last_y 30
  125,110,94,110,95,79,125,111,110,78,110,111,111,95,94,
  108,123,108,154,154,154,154,154,154,154,154,154,154,154,154,
  // one 24
  154,196,196,167,154,152,167,182,182,134,149,136,153,121,136,137,
  169,194,166,167,154,167,137,182,
  // abs 6
  107,167,91,122,107,167,
  168,
  139,139,
  154,154,
  79
};

// B-slice (initType 2) init values (entropy/contexts.py rows[2]).
static const uint8_t kInitB[NUM_CTX] = {
  153,160,107,139,126,154,197,185,201,154,137,154,139,154,154,134,
  183,152,139,95,79,63,31,31,169,198,153,153,154,154,154,153,
  111,154,154,154,149,92,167,154,154,224,167,122,121,140,61,154,
  170,154,139,153,139,123,123,63,124,166,183,140,136,153,154,166,
  183,140,136,153,154,166,183,140,136,153,154,140,170,153,138,138,
  122,121,122,121,167,151,183,140,151,183,140,140,125,110,124,110,
  95,94,125,111,111,79,125,126,111,111,79,108,123,93,154,154,
  154,154,154,154,154,154,154,154,154,154,125,110,124,110,95,94,
  125,111,111,79,125,126,111,111,79,108,123,93,154,154,154,154,
  154,154,154,154,154,154,154,154,154,196,167,167,154,152,167,182,
  182,134,149,136,153,121,136,122,169,208,166,167,154,152,167,182,
  107,167,91,107,107,167,168,139,139,154,154,79
};

static const int kCtxIndMap4x4[16] = {0,1,4,5,2,3,4,5,6,6,8,8,7,7,8,8};
static const int kMinInGroup[10] = {0,1,2,3,4,6,8,12,16,24};
static const int kGroupIdx[32] = {0,1,2,3,4,4,5,5,6,6,6,6,7,7,7,7,
                                  8,8,8,8,8,8,8,8,9,9,9,9,9,9,9,9};

struct BitWriter {
  std::vector<uint8_t> bytes;
  uint32_t cur = 0;
  int nbits = 0;
  void bit(int b) {
    cur = (cur << 1) | (b & 1);
    if (++nbits == 8) { bytes.push_back((uint8_t)cur); cur = 0; nbits = 0; }
  }
  void u(uint32_t v, int n) { for (int i = n - 1; i >= 0; --i) bit((v >> i) & 1); }
  void align_zero() { while (nbits) bit(0); }
};

struct Cabac {
  BitWriter& bw;
  uint32_t low = 0, range = 510;
  int bits_outstanding = 0;
  bool first_bit = true;
  uint8_t state[NUM_CTX];
  uint8_t mps[NUM_CTX];

  Cabac(BitWriter& b, int qp, const uint8_t* init_tab = kInitI) : bw(b) {
    for (int i = 0; i < NUM_CTX; ++i) {
      int iv = init_tab[i];
      int slope = (iv >> 4) * 5 - 45;
      int offset = ((iv & 15) << 3) - 16;
      int q = qp < 0 ? 0 : (qp > 51 ? 51 : qp);
      int pre = ((slope * q) >> 4) + offset;
      if (pre < 1) pre = 1; if (pre > 126) pre = 126;
      if (pre <= 63) { state[i] = 63 - pre; mps[i] = 0; }
      else { state[i] = pre - 64; mps[i] = 1; }
    }
  }
  void put_bit(int b) {
    if (first_bit) first_bit = false; else bw.bit(b);
    while (bits_outstanding > 0) { bw.bit(1 - b); --bits_outstanding; }
  }
  void renorm() {
    while (range < 256) {
      if (low < 256) put_bit(0);
      else if (low >= 512) { low -= 512; put_bit(1); }
      else { low -= 256; ++bits_outstanding; }
      range <<= 1; low <<= 1;
    }
  }
  void bin(int idx, int b) {
    int s = state[idx], m = mps[idx];
    uint32_t lps = kRangeTabLps[s][(range >> 6) & 3];
    range -= lps;
    if (b != m) {
      low += range; range = lps;
      if (s == 0) mps[idx] = 1 - m;
      state[idx] = kTransIdxLps[s];
    } else if (s < 62) state[idx] = s + 1;
    renorm();
  }
  void ep(int b) {
    low <<= 1;
    if (b) low += range;
    if (low >= 1024) { low -= 1024; put_bit(1); }
    else if (low < 512) put_bit(0);
    else { low -= 512; ++bits_outstanding; }
  }
  void eps(uint32_t v, int n) { for (int i = n - 1; i >= 0; --i) ep((v >> i) & 1); }
  void terminate(int b) {
    range -= 2;
    if (b) { low += range; range = 2; renorm(); flush(); }
    else renorm();
  }
  void flush() {
    range = 2; renorm();
    put_bit((low >> 9) & 1);
    bw.u(((low >> 7) & 3) | 1, 2);
    bw.align_zero();
  }
};

// ----- scans -----
struct Scans {
  // [scan_type][log2n-2]: grouped scan, cg scan
  std::vector<int> grouped[3][4];
  std::vector<int> cg[3][4];
  Scans() {
    for (int st = 0; st < 3; ++st)
      for (int l = 0; l < 4; ++l) {
        int n = 4 << l;
        build(st, n, grouped[st][l], cg[st][l]);
      }
  }
  static void base_scan(int st, int n, std::vector<int>& xs,
                        std::vector<int>& ys) {
    if (st == 0) {  // up-right diagonal
      int x = 0, y = 0;
      while ((int)xs.size() < n * n) {
        while (y >= 0) {
          if (x < n && y < n) { xs.push_back(x); ys.push_back(y); }
          --y; ++x;
        }
        y = x; x = 0;
      }
    } else if (st == 1) {  // horizontal
      for (int yy = 0; yy < n; ++yy) for (int xx = 0; xx < n; ++xx) {
        xs.push_back(xx); ys.push_back(yy);
      }
    } else {  // vertical
      for (int xx = 0; xx < n; ++xx) for (int yy = 0; yy < n; ++yy) {
        xs.push_back(xx); ys.push_back(yy);
      }
    }
  }
  void build(int st, int n, std::vector<int>& grouped_out,
             std::vector<int>& cg_out) {
    std::vector<int> ix, iy;
    base_scan(st, 4, ix, iy);
    int m = n / 4 > 0 ? n / 4 : 1;
    std::vector<int> cx, cy;
    base_scan(st, m, cx, cy);
    for (size_t c = 0; c < cx.size(); ++c) cg_out.push_back(cy[c] * m + cx[c]);
    if (n == 4) {
      for (int i = 0; i < 16; ++i) grouped_out.push_back(iy[i] * 4 + ix[i]);
    } else {
      for (size_t c = 0; c < cx.size(); ++c)
        for (int i = 0; i < 16; ++i) {
          int x = cx[c] * 4 + ix[i], y = cy[c] * 4 + iy[i];
          grouped_out.push_back(y * n + x);
        }
    }
  }
};
static const Scans g_scans;

static int scan_type_for(int intra_mode, int n, bool is_luma) {
  int max_size = is_luma ? 8 : 4;
  if (n > max_size) return 0;
  int d26 = intra_mode - 26; if (d26 < 0) d26 = -d26;
  int d10 = intra_mode - 10; if (d10 < 0) d10 = -d10;
  if (d26 <= 4) return 1;
  if (d10 <= 4) return 2;
  return 0;
}

static int first_sig_ctx(int n, bool is_luma, int st) {
  if (is_luma) {
    if (n == 4) return 0;
    if (n == 8) return 9 + (st != 0 ? 6 : 0);
    return 21;
  }
  if (n == 4) return 0;
  if (n == 8) return 9;
  return 12;
}

static int sig_ctx_inc(int pattern, int px, int py, int n, bool is_luma,
                       int first_ctx) {
  if (px + py == 0) return 0;
  if (n == 4) return first_ctx + kCtxIndMap4x4[4 * py + px];
  int xp = px & 3, yp = py & 3, cnt;
  if (pattern == 0) { int t = xp + yp; cnt = t >= 3 ? 0 : (t >= 1 ? 1 : 2); }
  else if (pattern == 1) cnt = yp >= 2 ? 0 : (yp >= 1 ? 1 : 2);
  else if (pattern == 2) cnt = xp >= 2 ? 0 : (xp >= 1 ? 1 : 2);
  else cnt = 2;
  bool not_first = ((px >> 2) + (py >> 2)) > 0;
  return first_ctx + ((not_first && is_luma) ? 3 : 0) + cnt;
}

// ----- per-CTU SAO parameter syntax (7.3.8.3; twin of
// entropy/sao_syntax.py code_sao_ctu). type: 0 none / 1 band / 2 edge.
struct SaoParams {
  const int32_t *type_idx, *eo_class, *band_pos, *offsets;
  int n_ctu;
  bool valid() const { return type_idx != nullptr; }
  bool same(int i, int j) const {
    for (int comp = 0; comp < 3; ++comp) {
      int a = comp * n_ctu + i, b = comp * n_ctu + j;
      if (type_idx[a] != type_idx[b]) return false;
      int t = type_idx[a];
      if (t == 2 && eo_class[a] != eo_class[b]) return false;
      if (t == 1 && band_pos[a] != band_pos[b]) return false;
      if (t != 0)
        for (int k = 0; k < 4; ++k)
          if (offsets[a * 4 + k] != offsets[b * 4 + k]) return false;
    }
    return true;
  }
};

static void code_sao_ctu(Cabac& c, const SaoParams& p, int ci, int cx,
                         int cy, int nx) {
  bool merge_left = cx > 0 && p.same(ci, ci - 1);
  if (cx > 0) c.bin(CTX_SAO_MERGE, merge_left);
  if (!merge_left && cy > 0) {
    bool merge_up = p.same(ci, ci - nx);
    c.bin(CTX_SAO_MERGE, merge_up);
    if (merge_up) return;
  }
  if (merge_left) return;
  for (int comp = 0; comp < 3; ++comp) {
    int base = comp * p.n_ctu + ci;
    int t = p.type_idx[base];
    if (comp <= 1) {  // sao_type_idx_luma / _chroma (cr copies cb)
      c.bin(CTX_SAO_TYPE, t > 0);
      if (t > 0) c.ep(t == 2);
    }
    if (t == 0) continue;
    for (int k = 0; k < 4; ++k) {  // sao_offset_abs: TR cMax=7 bypass
      int v = p.offsets[base * 4 + k];
      int a = v < 0 ? -v : v;
      for (int j = 0; j < a; ++j) c.ep(1);
      if (a < 7) c.ep(0);
    }
    if (t == 1) {  // band: signs + band position
      for (int k = 0; k < 4; ++k) {
        int v = p.offsets[base * 4 + k];
        if (v != 0) c.ep(v < 0);
      }
      c.eps((uint32_t)p.band_pos[base], 5);
    } else if (comp <= 1) {  // edge: sao_eo_class_luma / _chroma
      c.eps((uint32_t)p.eo_class[base], 2);
    }
  }
}

struct SliceEnc {
  Cabac& c;
  const int32_t *depth8, *modes8, *coef_y, *coef_cb, *coef_cr;
  int W, H, W8, Wc;
  // NxN decisions (may be null: all CUs 2Nx2N)
  const int32_t *modes4 = nullptr, *nxn8 = nullptr;

  int cu_depth_at(int x, int y) const { return depth8[(y >> 3) * W8 + (x >> 3)]; }
  int mode_at(int x, int y) const { return modes8[(y >> 3) * W8 + (x >> 3)]; }
  int mode4_at(int x, int y) const {
    if (!modes4) return mode_at(x, y);
    return modes4[(y >> 2) * (W8 * 2) + (x >> 2)];
  }
  bool nxn_at(int x, int y) const {
    return nxn8 && nxn8[(y >> 3) * W8 + (x >> 3)] != 0;
  }

  void write_remaining(int value, int rice) {
    if (value < (3 << rice)) {
      int length = value >> rice;
      c.eps((1u << (length + 1)) - 2, length + 1);
      c.eps(value & ((1 << rice) - 1), rice);
    } else {
      int length = rice;
      value -= (3 << rice);
      while (value >= (1 << length)) { value -= (1 << length); ++length; }
      c.eps((1u << (3 + length + 1 - rice)) - 2, 3 + length + 1 - rice);
      c.eps(value, length);
    }
  }

  void code_last_xy(int px, int py, int n, bool is_luma, int st) {
    if (st == 2) { int t = px; px = py; py = t; }
    int gx = kGroupIdx[px], gy = kGroupIdx[py];
    int log2n = 0; while ((1 << log2n) < n) ++log2n;
    int cw = log2n - 2, blk_off, shift, bx, by;
    if (is_luma) {
      blk_off = cw * 3 + ((cw + 1) >> 2); shift = (cw + 3) >> 2;
      bx = CTX_LAST_X; by = CTX_LAST_Y;
    } else {
      blk_off = 0; shift = cw; bx = CTX_LAST_X + 15; by = CTX_LAST_Y + 15;
    }
    int max_group = kGroupIdx[n - 1];
    for (int i = 0; i < gx; ++i) c.bin(bx + blk_off + (i >> shift), 1);
    if (gx < max_group) c.bin(bx + blk_off + (gx >> shift), 0);
    for (int i = 0; i < gy; ++i) c.bin(by + blk_off + (i >> shift), 1);
    if (gy < max_group) c.bin(by + blk_off + (gy >> shift), 0);
    if (gx > 3) {
      int count = (gx - 2) >> 1, rem = px - kMinInGroup[gx];
      for (int i = count - 1; i >= 0; --i) c.ep((rem >> i) & 1);
    }
    if (gy > 3) {
      int count = (gy - 2) >> 1, rem = py - kMinInGroup[gy];
      for (int i = count - 1; i >= 0; --i) c.ep((rem >> i) & 1);
    }
  }

  void code_residual(const int32_t* blk, int stride, int n, bool is_luma,
                     int st) {
    int lidx = 0;
    while ((4 << lidx) < n) ++lidx;
    const std::vector<int>& scan = g_scans.grouped[st][lidx];
    const std::vector<int>& cgs = g_scans.cg[st][lidx];
    int n_cg_w = n / 4 > 0 ? n / 4 : 1;

    auto val = [&](int rp) { int y = rp / n, x = rp % n; return blk[y * stride + x]; };

    int total = n * n, scan_pos_last = -1;
    std::vector<uint8_t> cg_flags(n_cg_w * n_cg_w, 0);
    for (int i = 0; i < total; ++i) {
      int rp = scan[i];
      if (val(rp) != 0) {
        scan_pos_last = i;
        int y = rp / n, x = rp % n;
        cg_flags[(y >> 2) * n_cg_w + (x >> 2)] = 1;
      }
    }
    int pos_last = scan[scan_pos_last];
    code_last_xy(pos_last % n, pos_last / n, n, is_luma, st);

    int sig_base = CTX_SIG + (is_luma ? 0 : 28);
    int first_ctx = first_sig_ctx(n, is_luma, st);
    int cg_base = CTX_SIG_CG + (is_luma ? 0 : 2);
    int last_cg = scan_pos_last >> 4;
    int c1 = 1;
    int i_scan_sig = scan_pos_last;

    for (int subset = last_cg; subset >= 0; --subset) {
      int sub_pos = subset << 4;
      int rice = 0;
      int abs_coeff[16]; int signs[16];
      int num_nonzero = 0, last_nz = -1, first_nz = 16;

      if (i_scan_sig == scan_pos_last) {
        int v = val(pos_last);
        abs_coeff[0] = v < 0 ? -v : v;
        signs[0] = v < 0;
        num_nonzero = 1; last_nz = i_scan_sig; first_nz = i_scan_sig;
        --i_scan_sig;
      }
      int cg_blk = cgs[subset];
      int cg_y = cg_blk / n_cg_w, cg_x = cg_blk % n_cg_w;
      int sig_right = (cg_x < n_cg_w - 1 && cg_flags[cg_y * n_cg_w + cg_x + 1]);
      int sig_lower = (cg_y < n_cg_w - 1 && cg_flags[(cg_y + 1) * n_cg_w + cg_x]);

      if (subset == last_cg || subset == 0) cg_flags[cg_blk] = 1;
      else c.bin(cg_base + ((sig_right + sig_lower) ? 1 : 0), cg_flags[cg_blk]);

      if (cg_flags[cg_blk]) {
        int pattern = sig_right + 2 * sig_lower;
        for (; i_scan_sig >= sub_pos; --i_scan_sig) {
          int rp = scan[i_scan_sig];
          int py = rp / n, px = rp % n;
          int v = val(rp);
          int sig = v != 0;
          if (i_scan_sig > sub_pos || subset == 0 || num_nonzero)
            c.bin(sig_base + sig_ctx_inc(pattern, px, py, n, is_luma,
                                         first_ctx), sig);
          if (sig) {
            abs_coeff[num_nonzero] = v < 0 ? -v : v;
            signs[num_nonzero] = v < 0;
            ++num_nonzero;
            if (last_nz == -1) last_nz = i_scan_sig;
            first_nz = i_scan_sig;
          }
        }
      } else i_scan_sig = sub_pos - 1;

      if (!num_nonzero) continue;

      int ctx_set, one_base, abs_base;
      if (is_luma) {
        ctx_set = (subset > 0 ? 2 : 0) + (c1 == 0 ? 1 : 0);
        one_base = CTX_ONE + ctx_set * 4;
        abs_base = CTX_ABS + ctx_set;
      } else {
        ctx_set = (c1 == 0 ? 1 : 0);
        one_base = CTX_ONE + 16 + ctx_set * 4;
        abs_base = CTX_ABS + 4 + ctx_set;
      }
      c1 = 1;
      bool escape = false;
      int num_c1 = num_nonzero < 8 ? num_nonzero : 8;
      int first_c2 = -1;
      for (int i = 0; i < num_c1; ++i) {
        int sym = abs_coeff[i] > 1;
        c.bin(one_base + c1, sym);
        if (sym) {
          c1 = 0;
          if (first_c2 == -1) first_c2 = i; else escape = true;
        } else if (c1 > 0 && c1 < 3) ++c1;
      }
      if (c1 == 0 && first_c2 != -1) {
        int sym = abs_coeff[first_c2] > 2;
        c.bin(abs_base, sym);
        if (sym) escape = true;
      }
      if (num_nonzero > 8) escape = true;
      for (int i = 0; i < num_nonzero; ++i) c.ep(signs[i]);
      if (escape) {
        int first2 = 1;
        for (int i = 0; i < num_nonzero; ++i) {
          int base_level = i < 8 ? (2 + first2) : 1;
          if (abs_coeff[i] >= base_level) {
            write_remaining(abs_coeff[i] - base_level, rice);
            if (abs_coeff[i] > (3 << rice)) rice = rice < 4 ? rice + 1 : 4;
          }
          if (abs_coeff[i] >= 2) first2 = 0;
        }
      }
    }
  }

  bool tu_cbf(int plane, int x0, int y0, int size) const {
    const int32_t* p; int stride, x, y, s;
    if (plane == 0) { p = coef_y; stride = W; x = x0; y = y0; s = size; }
    else { p = plane == 1 ? coef_cb : coef_cr; stride = Wc;
           x = x0 >> 1; y = y0 >> 1; s = size >> 1; }
    for (int yy = 0; yy < s; ++yy)
      for (int xx = 0; xx < s; ++xx)
        if (p[(y + yy) * stride + (x + xx)]) return true;
    return false;
  }

  void mpm_list(int cand_a, int cand_b, int mpm[3]) {
    if (cand_a == cand_b) {
      if (cand_a < 2) { mpm[0] = 0; mpm[1] = 1; mpm[2] = 26; }
      else { mpm[0] = cand_a; mpm[1] = 2 + ((cand_a + 29) % 32);
             mpm[2] = 2 + ((cand_a - 1) % 32); }
    } else {
      mpm[0] = cand_a; mpm[1] = cand_b;
      if (cand_a != 0 && cand_b != 0) mpm[2] = 0;
      else if (cand_a != 1 && cand_b != 1) mpm[2] = 1;
      else mpm[2] = 26;
    }
  }

  void transform_unit(int x0, int y0, int size, bool cl, bool ccb, bool ccr,
                      int mode) {
    if (!(cl || ccb || ccr)) return;
    if (cl) {
      code_residual(coef_y + y0 * W + x0, W, size, true,
                    scan_type_for(mode, size, true));
    }
    int half = size >> 1;
    if (ccb)
      code_residual(coef_cb + (y0 >> 1) * Wc + (x0 >> 1), Wc, half, false,
                    scan_type_for(mode, half, false));
    if (ccr)
      code_residual(coef_cr + (y0 >> 1) * Wc + (x0 >> 1), Wc, half, false,
                    scan_type_for(mode, half, false));
  }

  void transform_tree(int x0, int y0, int size, int mode) {
    bool split = size > 32;
    bool cbf_cb = tu_cbf(1, x0, y0, size);
    bool cbf_cr = tu_cbf(2, x0, y0, size);
    c.bin(CTX_QT_CBF_CHROMA + 0, cbf_cb);
    c.bin(CTX_QT_CBF_CHROMA + 0, cbf_cr);
    if (split) {
      int h = size >> 1;
      const int off[4][2] = {{0,0},{h,0},{0,h},{h,h}};
      for (int i = 0; i < 4; ++i) {
        int x1 = x0 + off[i][0], y1 = y0 + off[i][1];
        bool ccb = cbf_cb && tu_cbf(1, x1, y1, h);
        bool ccr = cbf_cr && tu_cbf(2, x1, y1, h);
        if (cbf_cb) c.bin(CTX_QT_CBF_CHROMA + 1, ccb);
        if (cbf_cr) c.bin(CTX_QT_CBF_CHROMA + 1, ccr);
        bool cl = tu_cbf(0, x1, y1, h);
        c.bin(CTX_QT_CBF_LUMA + 0, cl);
        transform_unit(x1, y1, h, cl, ccb, ccr, mode);
      }
    } else {
      bool cl = tu_cbf(0, x0, y0, size);
      c.bin(CTX_QT_CBF_LUMA + 1, cl);
      transform_unit(x0, y0, size, cl, cbf_cb, cbf_cr, mode);
    }
  }

  void mpm_for4(int x, int y, int mpm[3]) {
    int cand_a = x > 0 ? mode4_at(x - 1, y) : 1;
    int cand_b = 1;
    if (y > 0 && ((y - 1) >> 6) == (y >> 6)) cand_b = mode4_at(x, y - 1);
    mpm_list(cand_a, cand_b, mpm);
  }

  void code_mode_payload(int mode, const int mpm[3]) {
    int idx = mode == mpm[0] ? 0 : mode == mpm[1] ? 1 : mode == mpm[2] ? 2 : -1;
    if (idx >= 0) {
      c.ep(idx == 0 ? 0 : 1);
      if (idx) c.ep(idx - 1);
    } else {
      int rem = mode;
      for (int i = 0; i < 3; ++i)
        if (mode > mpm[i]) --rem;
      c.eps(rem, 5);
    }
  }

  void coding_unit(int x0, int y0, int size) {
    bool nxn = size == 8 && nxn_at(x0, y0);
    if (size == 8) c.bin(CTX_PART_MODE, nxn ? 0 : 1);
    if (nxn) {
      // 7.3.8.5: four prev_intra flags first, then the four payloads
      const int off[4][2] = {{0, 0}, {4, 0}, {0, 4}, {4, 4}};
      int pm[4], mpms[4][3];
      for (int i = 0; i < 4; ++i) {
        int xi = x0 + off[i][0], yi = y0 + off[i][1];
        pm[i] = mode4_at(xi, yi);
        mpm_for4(xi, yi, mpms[i]);
        bool in_mpm = pm[i] == mpms[i][0] || pm[i] == mpms[i][1] ||
                      pm[i] == mpms[i][2];
        c.bin(CTX_PREV_INTRA, in_mpm ? 1 : 0);
      }
      for (int i = 0; i < 4; ++i) code_mode_payload(pm[i], mpms[i]);
      c.bin(CTX_CHROMA_PRED, 0);  // DM (PU0)
      transform_tree_nxn(x0, y0, pm);
      return;
    }
    int mode = mode_at(x0, y0);
    int mpm[3];
    mpm_for4(x0, y0, mpm);
    int idx = mode == mpm[0] ? 0 : mode == mpm[1] ? 1 : mode == mpm[2] ? 2 : -1;
    c.bin(CTX_PREV_INTRA, idx >= 0 ? 1 : 0);
    code_mode_payload(mode, mpm);
    c.bin(CTX_CHROMA_PRED, 0);  // DM
    transform_tree(x0, y0, size, mode);
  }

  void transform_tree_nxn(int x0, int y0, const int pm[4]) {
    // 8x8 intra NxN: split inferred (IntraSplitFlag), chroma cbfs at the
    // parent, four 4x4 luma TUs, chroma residual after blkIdx==3
    bool cbf_cb = tu_cbf(1, x0, y0, 8);
    bool cbf_cr = tu_cbf(2, x0, y0, 8);
    c.bin(CTX_QT_CBF_CHROMA + 0, cbf_cb);
    c.bin(CTX_QT_CBF_CHROMA + 0, cbf_cr);
    const int off[4][2] = {{0, 0}, {4, 0}, {0, 4}, {4, 4}};
    for (int i = 0; i < 4; ++i) {
      int x1 = x0 + off[i][0], y1 = y0 + off[i][1];
      bool cl = tu_cbf(0, x1, y1, 4);
      c.bin(CTX_QT_CBF_LUMA + 0, cl);
      if (cl)
        code_residual(coef_y + y1 * W + x1, W, 4, true,
                      scan_type_for(pm[i], 4, true));
      if (i == 3) {
        int st = scan_type_for(pm[0], 4, false);
        if (cbf_cb)
          code_residual(coef_cb + (y0 >> 1) * Wc + (x0 >> 1), Wc, 4,
                        false, st);
        if (cbf_cr)
          code_residual(coef_cr + (y0 >> 1) * Wc + (x0 >> 1), Wc, 4,
                        false, st);
      }
    }
  }

  void coding_quadtree(int x0, int y0, int size, int depth) {
    bool inside = (x0 + size <= W) && (y0 + size <= H);
    int cur_depth = cu_depth_at(x0, y0);
    bool split = cur_depth > depth;
    if (inside && size > 8) {
      int inc = 0;
      if (x0 > 0) inc += cu_depth_at(x0 - 1, y0) > depth;
      if (y0 > 0) inc += cu_depth_at(x0, y0 - 1) > depth;
      c.bin(CTX_SPLIT_CU + inc, split);
    }
    if ((inside && split) || (!inside && size > 8)) {
      int h = size >> 1;
      const int off[4][2] = {{0,0},{h,0},{0,h},{h,h}};
      for (int i = 0; i < 4; ++i) {
        int x1 = x0 + off[i][0], y1 = y0 + off[i][1];
        if (x1 < W && y1 < H) coding_quadtree(x1, y1, h, depth + 1);
      }
    } else coding_unit(x0, y0, size);
  }
};


// ----- P-slice support (twin of entropy/slice_enc_p.py) -----

static inline int interleave4(int v) {
  v &= 0xF;
  v = (v | (v << 2)) & 0x33;
  v = (v | (v << 1)) & 0x55;
  return v;
}

static inline int64_t zaddr(int gx, int gy, int n_ctu_x) {
  int bx = gx >> 2, by = gy >> 2;
  int cx = bx >> 4, cy = by >> 4;
  int morton = interleave4(bx & 15) | (interleave4(by & 15) << 1);
  return (int64_t)(cy * n_ctu_x + cx) * 256 + morton;
}

// POC-distance MV scaling (8.5.3.2.8; twin of entropy/motion.scale_mv)
static inline int clip3i(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}
static void scale_mv(const int mv[2], int tb, int td, int out[2]) {
  if (tb == td) { out[0] = mv[0]; out[1] = mv[1]; return; }
  td = clip3i(-128, 127, td);
  tb = clip3i(-128, 127, tb);
  int atd = td < 0 ? -td : td;
  // floor division (num >= 0; td > 0 for past refs, general otherwise)
  int num = 16384 + (atd >> 1);
  int tx = num / td;
  if (td < 0 && tx * td != num) --tx;
  int dsf = clip3i(-4096, 4095, (tb * tx + 32) >> 6);
  for (int i = 0; i < 2; ++i) {
    long long p = (long long)dsf * mv[i];
    long long ap = p < 0 ? -p : p;
    long long s = (ap + 127) >> 8;
    out[i] = (int)clip3i(-32768, 32767, (int)(p >= 0 ? s : -s));
  }
}

struct PSliceEnc {
  Cabac& c;
  const int32_t *depth8, *mvq8, *coef_y, *coef_cb, *coef_cr;
  int W, H, W8, Wc, n_ctu_x;
  std::vector<uint8_t> skip8;  // coded-CU skip flags, 8x8 granularity
  bool is_b = false;           // low-delay B: code inter_pred_idc per PU
  // multi-reference state (twin of entropy/motion.py MotionField)
  const int32_t* ref8 = nullptr;      // L0 refIdx per 8x8 (null = all 0)
  int n_refs = 1;
  int poc = 1;
  const int32_t* ref_pocs = nullptr;  // [n_refs] POC of each L0 ref
  // intra-in-P decisions (twin of PSliceEncoder intra8/imodes4)
  const int32_t* intra8 = nullptr;    // per 8x8: CU intra-coded
  const int32_t* imodes4 = nullptr;   // per 4x4: intra mode (DC at inter)
  // rectangular-PU partition per 8x8 (0 = 2Nx2N, 1 = 2NxN, 2 = Nx2N)
  const int32_t* part8 = nullptr;
  // cu_qp_delta (LCU rate control): per-CTB QP map [ny][nx] (null =
  // off). qp_prev / dqp_pending track the 8.6.1 predictor chain with
  // diff_cu_qp_depth = 0 (QG = CTB -> predictor = previous QG's QP).
  const int32_t* qp_map = nullptr;
  int qp_prev = 0;
  bool dqp_pending = false;

  void maybe_code_dqp(int x0, int y0) {
    if (!dqp_pending) return;
    dqp_pending = false;
    int qpn = qp_map[(y0 >> 6) * n_ctu_x + (x0 >> 6)];
    int delta = qpn - qp_prev;
    qp_prev = qpn;
    int a = delta < 0 ? -delta : delta;
    int prefix = a < 5 ? a : 5;
    c.bin(CTX_DQP + 0, a > 0 ? 1 : 0);
    if (a > 0) {
      for (int i = 1; i < prefix; ++i) c.bin(CTX_DQP + 1, 1);
      if (prefix < 5) {
        c.bin(CTX_DQP + 1, 0);
      } else {                         // EG0 suffix (xWriteEpExGolomb)
        int v = a - 5, k = 0;
        while (v >= (1 << k)) { c.ep(1); v -= 1 << k; ++k; }
        c.ep(0);
        for (int i = k - 1; i >= 0; --i) c.ep((v >> i) & 1);
      }
      c.ep(delta < 0 ? 1 : 0);
    }
  }

  struct Mot { int x, y, ref; bool ok; };

  bool intra_at(int x, int y) const {
    return intra8 && intra8[(y >> 3) * W8 + (x >> 3)] != 0;
  }
  int part_at(int x, int y) const {
    return part8 ? part8[(y >> 3) * W8 + (x >> 3)] : 0;
  }

  int cu_depth_at(int x, int y) const { return depth8[(y >> 3) * W8 + (x >> 3)]; }
  void mv_at(int x, int y, int mv[2]) const {
    mv[0] = mvq8[((y >> 3) * W8 + (x >> 3)) * 2 + 0];
    mv[1] = mvq8[((y >> 3) * W8 + (x >> 3)) * 2 + 1];
  }
  int ref_at(int x, int y) const {
    return ref8 ? ref8[(y >> 3) * W8 + (x >> 3)] : 0;
  }
  bool avail(int xn, int yn, int64_t cur_z) const {
    if (xn < 0 || yn < 0 || xn >= W || yn >= H) return false;
    return zaddr(xn, yn, n_ctu_x) < cur_z;
  }
  Mot at(int xn, int yn, int64_t cur_z) const {
    if (!avail(xn, yn, cur_z)) return {0, 0, 0, false};
    if (intra_at(xn, yn)) return {0, 0, 0, false};  // 6.4.1 inter-only
    int mv[2]; mv_at(xn, yn, mv);
    return {mv[0], mv[1], ref_at(xn, yn), true};
  }
  // Same-CB PartIdx availability (6.4.2; twin of motion._pu_aware_at):
  // for PU1 of a rectangular CB, positions inside PU0 are available
  // even though their 4x4 z-scan address exceeds the current PB's.
  Mot at_pu(int xn, int yn, int64_t cur_z, int px0, int py0, int cu,
            int part_mode, int part_idx) const {
    if (part_idx == 1 && part_mode != 0) {
      int cx0 = part_mode == 2 ? px0 - (cu >> 1) : px0;
      int cy0 = part_mode == 1 ? py0 - (cu >> 1) : py0;
      if (xn >= cx0 && xn < cx0 + cu && yn >= cy0 && yn < cy0 + cu) {
        bool in_pu0 = part_mode == 1 ? (yn < cy0 + (cu >> 1))
                                     : (xn < cx0 + (cu >> 1));
        if (!in_pu0) return {0, 0, 0, false};
        int mv[2]; mv_at(xn, yn, mv);
        return {mv[0], mv[1], ref_at(xn, yn), true};
      }
    }
    return at(xn, yn, cur_z);
  }
  int ref_poc(int r) const { return ref_pocs ? ref_pocs[r] : poc - 1 - r; }

  // Two-entry AMVP list (8.5.3.2.6-8; twin of motion.amvp_candidates):
  // same-ref scans first, scaled fallbacks per the isScaledFlag rule.
  void amvp2(int x0, int y0, int w, int h, int target_ref,
             int mvp[2][2], int cu_size = 0, int part_mode = 0,
             int part_idx = 0) const {
    int64_t cur = zaddr(x0, y0, n_ctu_x);
    int tgt_poc = ref_poc(target_ref);
    int cu = cu_size ? cu_size : (w > h ? w : h);
    auto lookup = [&](int xn, int yn) {
      return at_pu(xn, yn, cur, x0, y0, cu, part_mode, part_idx);
    };
    const int a_pos[2][2] = {{x0 - 1, y0 + h}, {x0 - 1, y0 + h - 1}};
    const int b_pos[3][2] = {{x0 + w, y0 - 1}, {x0 + w - 1, y0 - 1},
                             {x0 - 1, y0 - 1}};
    auto same_ref_scan = [&](const int (*pos)[2], int np, int out[2]) {
      for (int i = 0; i < np; ++i) {
        Mot m = lookup(pos[i][0], pos[i][1]);
        if (m.ok && ref_poc(m.ref) == tgt_poc) {
          out[0] = m.x; out[1] = m.y; return true;
        }
      }
      return false;
    };
    auto scaled_scan = [&](const int (*pos)[2], int np, int out[2]) {
      for (int i = 0; i < np; ++i) {
        Mot m = lookup(pos[i][0], pos[i][1]);
        if (m.ok) {
          int tb = poc - tgt_poc, td = poc - ref_poc(m.ref);
          int mv[2] = {m.x, m.y};
          scale_mv(mv, tb, td, out);
          return true;
        }
      }
      return false;
    };
    bool is_scaled = lookup(a_pos[0][0], a_pos[0][1]).ok ||
                     lookup(a_pos[1][0], a_pos[1][1]).ok;
    int mv_a[2], mv_b[2];
    bool ha = same_ref_scan(a_pos, 2, mv_a);
    if (!ha && is_scaled) ha = scaled_scan(a_pos, 2, mv_a);
    bool hb = same_ref_scan(b_pos, 3, mv_b);
    if (!is_scaled) {
      // B promoted into the A slot, B re-derived by the scaled scan
      if (hb) { mv_a[0] = mv_b[0]; mv_a[1] = mv_b[1]; }
      ha = hb;
      hb = scaled_scan(b_pos, 3, mv_b);
    }
    int n = 0;
    if (ha) { mvp[n][0] = mv_a[0]; mvp[n][1] = mv_a[1]; ++n; }
    if (hb && !(ha && mv_b[0] == mv_a[0] && mv_b[1] == mv_a[1])) {
      mvp[n][0] = mv_b[0]; mvp[n][1] = mv_b[1]; ++n;
    }
    for (; n < 2; ++n) { mvp[n][0] = 0; mvp[n][1] = 0; }
  }

  bool tu_cbf(int plane, int x0, int y0, int size) const {
    const int32_t* pl; int stride, x, y, sN;
    if (plane == 0) { pl = coef_y; stride = W; x = x0; y = y0; sN = size; }
    else { pl = plane == 1 ? coef_cb : coef_cr; stride = Wc;
           x = x0 >> 1; y = y0 >> 1; sN = size >> 1; }
    for (int yy = 0; yy < sN; ++yy)
      for (int xx = 0; xx < sN; ++xx)
        if (pl[(y + yy) * stride + (x + xx)]) return true;
    return false;
  }

  void eg1(int v) {
    int count = 1;
    while (v >= (1 << count)) { c.ep(1); v -= (1 << count); ++count; }
    c.ep(0);
    c.eps(v, count);
  }

  void code_residual(const int32_t* blk, int stride, int n, bool is_luma) {
    SliceEnc se{c, nullptr, nullptr, coef_y, coef_cb, coef_cr, W, H, W8, Wc};
    se.code_residual(blk, stride, n, is_luma, 0);
  }

  void transform_unit(int x0, int y0, int size, bool cl, bool ccb, bool ccr) {
    if (!(cl || ccb || ccr)) return;
    maybe_code_dqp(x0, y0);
    if (cl) code_residual(coef_y + y0 * W + x0, W, size, true);
    int half = size >> 1;
    if (ccb) code_residual(coef_cb + (y0 >> 1) * Wc + (x0 >> 1), Wc, half,
                           false);
    if (ccr) code_residual(coef_cr + (y0 >> 1) * Wc + (x0 >> 1), Wc, half,
                           false);
  }

  void transform_tree(int x0, int y0, int size, bool cbf_cb, bool cbf_cr,
                      bool force_split = false) {
    bool split = size > 32 || force_split;
    c.bin(CTX_QT_CBF_CHROMA + 0, cbf_cb);
    c.bin(CTX_QT_CBF_CHROMA + 0, cbf_cr);
    if (split) {
      int h = size >> 1;
      const int off[4][2] = {{0,0},{h,0},{0,h},{h,h}};
      for (int i = 0; i < 4; ++i) {
        int x1 = x0 + off[i][0], y1 = y0 + off[i][1];
        bool ccb = cbf_cb && tu_cbf(1, x1, y1, h);
        bool ccr = cbf_cr && tu_cbf(2, x1, y1, h);
        if (cbf_cb) c.bin(CTX_QT_CBF_CHROMA + 1, ccb);
        if (cbf_cr) c.bin(CTX_QT_CBF_CHROMA + 1, ccr);
        bool cl = tu_cbf(0, x1, y1, h);
        c.bin(CTX_QT_CBF_LUMA + 0, cl);
        transform_unit(x1, y1, h, cl, ccb, ccr);
      }
    } else {
      bool cl = tu_cbf(0, x0, y0, size);
      if (cbf_cb || cbf_cr) c.bin(CTX_QT_CBF_LUMA + 1, cl);
      // else: inferred 1
      transform_unit(x0, y0, size, cl, cbf_cb, cbf_cr);
    }
  }

  // Normative merge candidate list (8.5.3.2.2), uni-L0 neighbours, TMVP
  // off (twin of entropy/motion.merge_candidates): spatial A1 B1 B0 A0
  // (+B2 when fewer than 4), pruned on full motion (mv AND refIdx),
  // zero-MV fill iterating refIdx 0..n_refs-1. In a B slice the zero
  // candidates are bi-predictive (8.5.3.2.5): they get refIdx -1, which
  // no uni-L0 PU matches, so such a PU is coded by AMVP and the motion
  // field stays uni-L0 as the deblocking and later merge lists assume.
  int merge_cands(int x0, int y0, int size, int cands[5][3],
                  int w = 0, int h = 0, int part_mode = 0,
                  int part_idx = 0) const {
    if (w == 0) w = size;
    if (h == 0) h = size;
    int64_t cur = zaddr(x0, y0, n_ctu_x);
    auto lookup = [&](int xn, int yn) {
      return at_pu(xn, yn, cur, x0, y0, size, part_mode, part_idx);
    };
    // 8.5.3.2.3 second-PU exclusions: A1 off for Nx2N PU1, B1 off for
    // 2NxN PU1 (merge must not reproduce the 2Nx2N motion)
    Mot a1 = (part_idx == 1 && part_mode == 2)
                 ? Mot{0, 0, 0, false} : lookup(x0 - 1, y0 + h - 1);
    Mot b1 = (part_idx == 1 && part_mode == 1)
                 ? Mot{0, 0, 0, false} : lookup(x0 + w - 1, y0 - 1);
    Mot b0 = lookup(x0 + w, y0 - 1);
    Mot a0 = lookup(x0 - 1, y0 + h);
    auto same = [](const Mot& a, const Mot& b) {
      return a.ok && b.ok && a.x == b.x && a.y == b.y && a.ref == b.ref;
    };
    int n = 0;
    auto push = [&](const Mot& m) {
      cands[n][0] = m.x; cands[n][1] = m.y; cands[n][2] = m.ref; ++n;
    };
    if (a1.ok) push(a1);
    if (b1.ok && !same(b1, a1)) push(b1);
    if (b0.ok && !same(b0, b1)) push(b0);
    if (a0.ok && !same(a0, a1)) push(a0);
    if (n < 4) {
      Mot b2 = lookup(x0 - 1, y0 - 1);
      if (b2.ok && !same(b2, a1) && !same(b2, b1)) push(b2);
    }
    int zero_idx = 0;
    while (n < 5) {
      int r = is_b ? -1 : zero_idx < n_refs ? zero_idx : 0;
      cands[n][0] = 0; cands[n][1] = 0; cands[n][2] = r; ++n;
      ++zero_idx;
    }
    return 5;
  }

  // ref_idx_l0: TU cMax = n_refs-1; bin0/bin1 context-coded, rest
  // bypass (HM codeRefFrmIdx; twin of PSliceEncoder._write_ref_idx)
  void write_ref_idx(int ref) {
    c.bin(CTX_REF_PIC + 0, ref > 0);
    if (ref > 0) {
      int rem = ref - 1, cmax = n_refs - 2;
      for (int i = 0; i < cmax; ++i) {
        int bit = (i == rem) ? 0 : 1;
        if (i == 0) c.bin(CTX_REF_PIC + 1, bit);
        else c.ep(bit);
        if (bit == 0) break;
      }
    }
  }

  void write_merge_idx(int idx) {
    // TU cMax = 4; first bin context-coded, rest bypass (9.3.3.7)
    c.bin(CTX_MERGE_IDX, idx > 0);
    if (idx > 0) {
      for (int i = 1; i < idx; ++i) c.ep(1);
      if (idx < 4) c.ep(0);
    }
  }

  int skip_ctx_inc(int x0, int y0) const {
    int inc = 0;
    if (x0 > 0) inc += skip8[(y0 >> 3) * W8 + ((x0 - 1) >> 3)];
    if (y0 > 0) inc += skip8[((y0 - 1) >> 3) * W8 + (x0 >> 3)];
    return inc;
  }

  void write_mvd(const int mv[2], const int* mvp) {
    int mvd[2] = {mv[0] - mvp[0], mv[1] - mvp[1]};
    int ax = mvd[0] < 0 ? -mvd[0] : mvd[0];
    int ay = mvd[1] < 0 ? -mvd[1] : mvd[1];
    c.bin(CTX_MVD + 0, ax > 0);
    c.bin(CTX_MVD + 0, ay > 0);
    if (ax > 0) c.bin(CTX_MVD + 1, ax > 1);
    if (ay > 0) c.bin(CTX_MVD + 1, ay > 1);
    if (ax > 0) {
      if (ax > 1) eg1(ax - 2);
      c.ep(mvd[0] < 0);
    }
    if (ay > 0) {
      if (ay > 1) eg1(ay - 2);
      c.ep(mvd[1] < 0);
    }
  }

  // Rectangular-PU inter CU (twin of PSliceEncoder._rect_coding_unit):
  // part_mode '01' (2NxN) / '00' (Nx2N), per-PU merge-or-AMVP motion,
  // rqt_root_cbf, inferred TU split (7.4.9.8 interSplitFlag).
  void rect_coding_unit(int x0, int y0, int size, int part) {
    c.bin(CTX_SKIP + skip_ctx_inc(x0, y0), 0);
    c.bin(CTX_PRED_MODE, 0);
    c.bin(CTX_PART_MODE + 0, 0);
    c.bin(CTX_PART_MODE + 1, part == 1);
    int h = size >> 1;
    int pus[2][4];
    if (part == 1) {
      int t0[4] = {x0, y0, size, h}, t1[4] = {x0, y0 + h, size, h};
      std::memcpy(pus[0], t0, sizeof t0);
      std::memcpy(pus[1], t1, sizeof t1);
    } else {
      int t0[4] = {x0, y0, h, size}, t1[4] = {x0 + h, y0, h, size};
      std::memcpy(pus[0], t0, sizeof t0);
      std::memcpy(pus[1], t1, sizeof t1);
    }
    for (int pidx = 0; pidx < 2; ++pidx) {
      int xp = pus[pidx][0], yp = pus[pidx][1];
      int wp = pus[pidx][2], hp = pus[pidx][3];
      int mv[2];
      mv_at(xp, yp, mv);
      int ref = ref_at(xp, yp);
      int cands[5][3];
      merge_cands(xp, yp, size, cands, wp, hp, part, pidx);
      int merge_idx = -1;
      for (int i = 0; i < 5; ++i)
        if (cands[i][0] == mv[0] && cands[i][1] == mv[1] &&
            cands[i][2] == ref) {
          merge_idx = i;
          break;
        }
      c.bin(CTX_MERGE_FLAG, merge_idx >= 0);
      if (merge_idx >= 0) {
        write_merge_idx(merge_idx);
        continue;
      }
      if (is_b) {
        int depth = 0;
        for (int s = size; s < 64; s <<= 1) ++depth;
        c.bin(CTX_INTER_DIR + depth, 0);
        c.bin(CTX_INTER_DIR + 4, 0);
      }
      if (n_refs > 1) write_ref_idx(ref);
      int mvps[2][2];
      amvp2(xp, yp, wp, hp, ref, mvps, size, part, pidx);
      int c0 = (mv[0] - mvps[0][0] < 0 ? mvps[0][0] - mv[0]
                                       : mv[0] - mvps[0][0])
             + (mv[1] - mvps[0][1] < 0 ? mvps[0][1] - mv[1]
                                       : mv[1] - mvps[0][1]);
      int c1 = (mv[0] - mvps[1][0] < 0 ? mvps[1][0] - mv[0]
                                       : mv[0] - mvps[1][0])
             + (mv[1] - mvps[1][1] < 0 ? mvps[1][1] - mv[1]
                                       : mv[1] - mvps[1][1]);
      int mvp_idx = c1 < c0 ? 1 : 0;
      write_mvd(mv, mvps[mvp_idx]);
      c.bin(CTX_MVP_IDX, mvp_idx);
    }
    bool ccb = tu_cbf(1, x0, y0, size);
    bool ccr = tu_cbf(2, x0, y0, size);
    int root = (tu_cbf(0, x0, y0, size) || ccb || ccr) ? 1 : 0;
    c.bin(CTX_QT_ROOT_CBF, root);
    if (root) transform_tree(x0, y0, size, ccb, ccr, true);
  }

  void coding_unit(int x0, int y0, int size) {
    if (intra_at(x0, y0)) {
      // intra-in-P CU (pred_mode_flag = 1, 2Nx2N; twin of
      // PSliceEncoder._intra_coding_unit). The intra syntax machinery
      // is shared with the I-slice coder via a local SliceEnc view
      // whose modes4 = imodes4 (DC at inter positions).
      c.bin(CTX_SKIP + skip_ctx_inc(x0, y0), 0);
      c.bin(CTX_PRED_MODE, 1);
      if (size == 8) c.bin(CTX_PART_MODE, 1);  // 2Nx2N at min size
      SliceEnc se{c, depth8, nullptr, coef_y, coef_cb, coef_cr,
                  W, H, W8, Wc, imodes4, nullptr};
      int mode = imodes4[(y0 >> 2) * (W8 * 2) + (x0 >> 2)];
      int mpm[3];
      se.mpm_for4(x0, y0, mpm);
      bool in_mpm = mode == mpm[0] || mode == mpm[1] || mode == mpm[2];
      c.bin(CTX_PREV_INTRA, in_mpm ? 1 : 0);
      se.code_mode_payload(mode, mpm);
      c.bin(CTX_CHROMA_PRED, 0);  // DM
      se.transform_tree(x0, y0, size, mode);
      return;
    }
    int part = part_at(x0, y0);
    if (part) {
      rect_coding_unit(x0, y0, size, part);
      return;
    }
    int mv[2];
    mv_at(x0, y0, mv);
    int ref = ref_at(x0, y0);
    int cands[5][3];
    merge_cands(x0, y0, size, cands);
    int merge_idx = -1;
    for (int i = 0; i < 5; ++i)
      if (cands[i][0] == mv[0] && cands[i][1] == mv[1] &&
          cands[i][2] == ref) {
        merge_idx = i;
        break;
      }
    bool cl = tu_cbf(0, x0, y0, size);
    bool ccb = tu_cbf(1, x0, y0, size);
    bool ccr = tu_cbf(2, x0, y0, size);
    int root = (cl || ccb || ccr) ? 1 : 0;

    bool skip = merge_idx >= 0 && !root;
    c.bin(CTX_SKIP + skip_ctx_inc(x0, y0), skip);
    if (skip) {
      write_merge_idx(merge_idx);
      for (int yy = y0 >> 3; yy < (y0 + size) >> 3; ++yy)
        for (int xx = x0 >> 3; xx < (x0 + size) >> 3; ++xx)
          skip8[yy * W8 + xx] = 1;
      return;
    }
    c.bin(CTX_PRED_MODE, 0);
    c.bin(CTX_PART_MODE, 1);
    c.bin(CTX_MERGE_FLAG, merge_idx >= 0);
    if (merge_idx >= 0) {
      write_merge_idx(merge_idx);
      // rqt_root_cbf inferred 1 for 2Nx2N merge (7.3.8.5)
      transform_tree(x0, y0, size, ccb, ccr);
      return;
    }
    if (is_b) {
      // inter_pred_idc = PRED_L0 (bin0 "bi?" at ctx CtDepth, bin1 "L1?")
      int depth = 0;
      for (int s = size; s < 64; s <<= 1) ++depth;
      c.bin(CTX_INTER_DIR + depth, 0);
      c.bin(CTX_INTER_DIR + 4, 0);
    }
    if (n_refs > 1) write_ref_idx(ref);
    int mvps[2][2];
    amvp2(x0, y0, size, size, ref, mvps);
    // single-ref keeps the historical mvp_l0_flag=0 choice (byte-compat
    // with the Python twin); multi-ref picks the cheaper predictor
    int mvp_idx = 0;
    if (n_refs > 1) {
      int c0 = (mv[0] - mvps[0][0] < 0 ? mvps[0][0] - mv[0] : mv[0] - mvps[0][0])
             + (mv[1] - mvps[0][1] < 0 ? mvps[0][1] - mv[1] : mv[1] - mvps[0][1]);
      int c1 = (mv[0] - mvps[1][0] < 0 ? mvps[1][0] - mv[0] : mv[0] - mvps[1][0])
             + (mv[1] - mvps[1][1] < 0 ? mvps[1][1] - mv[1] : mv[1] - mvps[1][1]);
      mvp_idx = c1 < c0 ? 1 : 0;
    }
    const int* mvp = mvps[mvp_idx];
    int mvd[2] = {mv[0] - mvp[0], mv[1] - mvp[1]};
    int ax = mvd[0] < 0 ? -mvd[0] : mvd[0];
    int ay = mvd[1] < 0 ? -mvd[1] : mvd[1];
    c.bin(CTX_MVD + 0, ax > 0);
    c.bin(CTX_MVD + 0, ay > 0);
    if (ax > 0) c.bin(CTX_MVD + 1, ax > 1);
    if (ay > 0) c.bin(CTX_MVD + 1, ay > 1);
    if (ax > 0) {
      if (ax > 1) eg1(ax - 2);
      c.ep(mvd[0] < 0);
    }
    if (ay > 0) {
      if (ay > 1) eg1(ay - 2);
      c.ep(mvd[1] < 0);
    }
    c.bin(CTX_MVP_IDX, mvp_idx);
    c.bin(CTX_QT_ROOT_CBF, root);
    if (root) transform_tree(x0, y0, size, ccb, ccr);
  }

  void coding_quadtree(int x0, int y0, int size, int depth) {
    bool inside = (x0 + size <= W) && (y0 + size <= H);
    bool split = cu_depth_at(x0, y0) > depth;
    if (inside && size > 8) {
      int inc = 0;
      if (x0 > 0) inc += cu_depth_at(x0 - 1, y0) > depth;
      if (y0 > 0) inc += cu_depth_at(x0, y0 - 1) > depth;
      c.bin(CTX_SPLIT_CU + inc, split);
    }
    if ((inside && split) || (!inside && size > 8)) {
      int h = size >> 1;
      const int off[4][2] = {{0,0},{h,0},{0,h},{h,h}};
      for (int i = 0; i < 4; ++i) {
        int x1 = x0 + off[i][0], y1 = y0 + off[i][1];
        if (x1 < W && y1 < H) coding_quadtree(x1, y1, h, depth + 1);
      }
    } else coding_unit(x0, y0, size);
  }
};

}  // namespace

extern "C" int hevc_encode_slice_p(const int32_t* depth8,
                                   const int32_t* mvq8,
                                   const int32_t* coef_y,
                                   const int32_t* coef_cb,
                                   const int32_t* coef_cr,
                                   int pad_w, int pad_h, int qp,
                                   uint8_t* out, int out_cap,
                                   int is_b,
                                   const int32_t* ref8,
                                   int n_refs, int poc,
                                   const int32_t* ref_pocs,
                                   const int32_t* sao_type,
                                   const int32_t* sao_eo,
                                   const int32_t* sao_band,
                                   const int32_t* sao_off,
                                   const int32_t* intra8,
                                   const int32_t* imodes4,
                                   const int32_t* part8,
                                   const int32_t* qp_map) {
  BitWriter bw;
  Cabac cab(bw, qp, is_b ? kInitB : kInitP);
  int nx = (pad_w + 63) / 64, ny = (pad_h + 63) / 64;
  int n_ctu = nx * ny;
  PSliceEnc se{cab, depth8, mvq8, coef_y, coef_cb, coef_cr,
               pad_w, pad_h, pad_w / 8, pad_w / 2, nx,
               std::vector<uint8_t>((size_t)(pad_w / 8) * (pad_h / 8), 0),
               is_b != 0, ref8, n_refs < 1 ? 1 : n_refs, poc, ref_pocs,
               intra8, imodes4, part8};
  se.qp_map = qp_map;
  se.qp_prev = qp;
  SaoParams sao{sao_type, sao_eo, sao_band, sao_off, n_ctu};
  for (int ci = 0; ci < n_ctu; ++ci) {
    int cy = ci / nx, cx = ci % nx;
    if (sao.valid()) code_sao_ctu(cab, sao, ci, cx, cy, nx);
    se.dqp_pending = qp_map != nullptr;
    se.coding_quadtree(cx * 64, cy * 64, 64, 0);
    cab.terminate(ci == n_ctu - 1 ? 1 : 0);
  }
  if ((int)bw.bytes.size() > out_cap) return -1;
  std::memcpy(out, bw.bytes.data(), bw.bytes.size());
  return (int)bw.bytes.size();
}

extern "C" int hevc_encode_slice(const int32_t* depth8, const int32_t* modes8,
                                 const int32_t* coef_y,
                                 const int32_t* coef_cb,
                                 const int32_t* coef_cr,
                                 int pad_w, int pad_h, int qp,
                                 uint8_t* out, int out_cap,
                                 const int32_t* modes4,
                                 const int32_t* nxn8,
                                 const int32_t* sao_type,
                                 const int32_t* sao_eo,
                                 const int32_t* sao_band,
                                 const int32_t* sao_off) {
  BitWriter bw;
  Cabac cab(bw, qp);
  SliceEnc se{cab, depth8, modes8, coef_y, coef_cb, coef_cr,
              pad_w, pad_h, pad_w / 8, pad_w / 2, modes4, nxn8};
  int nx = (pad_w + 63) / 64, ny = (pad_h + 63) / 64;
  int n_ctu = nx * ny;
  SaoParams sao{sao_type, sao_eo, sao_band, sao_off, n_ctu};
  for (int ci = 0; ci < n_ctu; ++ci) {
    int cy = ci / nx, cx = ci % nx;
    if (sao.valid()) code_sao_ctu(cab, sao, ci, cx, cy, nx);
    se.coding_quadtree(cx * 64, cy * 64, 64, 0);
    cab.terminate(ci == n_ctu - 1 ? 1 : 0);
  }
  if ((int)bw.bytes.size() > out_cap) return -1;
  std::memcpy(out, bw.bytes.data(), bw.bytes.size());
  return (int)bw.bytes.size();
}
