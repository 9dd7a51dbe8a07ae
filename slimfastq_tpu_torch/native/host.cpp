// Native host-side components of the TPU FASTQ codec.
//
// The reference (Infinidat/slimfastq) is a single C++ binary; in this
// TPU-native re-design the *device* does the entropy coding while the
// host owns the string-shaped work (SURVEY.md §3.5). This library is the
// production host path: FASTQ indexing/validation, tokenized read-ID
// delta modeling (bit-format-identical to models/readid.py), varint
// length/exception streams, and decode-side text assembly. The Python
// implementations remain as the behavioural oracle; tests assert byte
// equality between the two.
//
// Exposed with a plain C ABI for ctypes.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <vector>
#ifdef _OPENMP
#include <omp.h>
#endif
#ifdef __AVX2__
#include <immintrin.h>
#endif

// ---------------------------------------------------------------------------
// newline scan helpers: count + fill positions, SIMD where available.
// memchr-per-line costs a call per ~25-100 byte line; the movemask form
// processes 32 bytes per iteration (measured 5.1 -> ~1.3 ms per 15.6 MB).
// ---------------------------------------------------------------------------
static int64_t count_nl(const uint8_t* p, int64_t len) {
    int64_t cnt = 0;
    int64_t i = 0;
#ifdef __AVX2__
    const __m256i nlv = _mm256_set1_epi8('\n');
    for (; i + 32 <= len; i += 32) {
        __m256i v = _mm256_loadu_si256((const __m256i*)(p + i));
        uint32_t m = (uint32_t)_mm256_movemask_epi8(
            _mm256_cmpeq_epi8(v, nlv));
        cnt += __builtin_popcount(m);
    }
#endif
    for (; i < len; i++) cnt += (p[i] == '\n');
    return cnt;
}

static int64_t fill_nl(const uint8_t* p, int64_t len, int64_t base,
                       int64_t* out) {
    int64_t k = 0;
    int64_t i = 0;
#ifdef __AVX2__
    const __m256i nlv = _mm256_set1_epi8('\n');
    for (; i + 32 <= len; i += 32) {
        __m256i v = _mm256_loadu_si256((const __m256i*)(p + i));
        uint32_t m = (uint32_t)_mm256_movemask_epi8(
            _mm256_cmpeq_epi8(v, nlv));
        while (m) {
            out[k++] = base + i + __builtin_ctz(m);
            m &= m - 1;
        }
    }
#endif
    for (; i < len; i++)
        if (p[i] == '\n') out[k++] = base + i;
    return k;
}

// ---------------------------------------------------------------------------
// CRC32 (IEEE reflected, zlib-compatible): slice-by-8 tables + OpenMP
// chunking with a GF(2) combine. Bit-identical to zlib.crc32 — pinned by
// tests/test_native.py — so container CRCs are NOT format-affected.
// Measured ~0.4 GB/s via Python zlib on this host vs ~3 GB/s/core here.
// ---------------------------------------------------------------------------
static uint32_t crc_tab[8][256];
static bool crc_init_done = false;

static void crc_init() {
    if (crc_init_done) return;
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_tab[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
        for (int t = 1; t < 8; t++)
            crc_tab[t][i] = crc_tab[0][crc_tab[t - 1][i] & 0xFF]
                ^ (crc_tab[t - 1][i] >> 8);
    crc_init_done = true;
}

// Build the table at library load: callers may run on several pipeline
// threads at once (api.py's staged encode/decode), and a lazy first-use
// init would be a (benign but formally racy) double write.
static struct CrcInitAtLoad { CrcInitAtLoad() { crc_init(); } }
    crc_init_at_load;

static uint32_t crc32_span(uint32_t crc, const uint8_t* p, int64_t len) {
    crc = ~crc;
    int64_t i = 0;
    for (; i + 8 <= len; i += 8) {
        uint32_t lo, hi;
        memcpy(&lo, p + i, 4);
        memcpy(&hi, p + i + 4, 4);
        lo ^= crc;
        crc = crc_tab[7][lo & 0xFF] ^ crc_tab[6][(lo >> 8) & 0xFF]
            ^ crc_tab[5][(lo >> 16) & 0xFF] ^ crc_tab[4][lo >> 24]
            ^ crc_tab[3][hi & 0xFF] ^ crc_tab[2][(hi >> 8) & 0xFF]
            ^ crc_tab[1][(hi >> 16) & 0xFF] ^ crc_tab[0][hi >> 24];
    }
    for (; i < len; i++)
        crc = crc_tab[0][(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
    return ~crc;
}

// crc(A||B) from crc(A), crc(B), len(B): shift crc(A) by len(B) zero
// bytes via GF(2) matrix exponentiation (zlib crc32_combine algorithm)
static void gf2_sq(uint32_t* sq, const uint32_t* m) {
    for (int n = 0; n < 32; n++) {
        uint32_t v = m[n], s = 0;
        for (int b = 0; b < 32; b++)
            if (v & (1u << b)) s ^= m[b];
        sq[n] = s;
    }
}

static uint32_t crc32_comb(uint32_t crc1, uint32_t crc2, int64_t len2) {
    if (len2 <= 0) return crc1;
    uint32_t even[32], odd[32];
    odd[0] = 0xEDB88320u;                 // the CRC polynomial, reflected
    for (int n = 1; n < 32; n++) odd[n] = 1u << (n - 1);
    gf2_sq(even, odd);                    // 2 zero bits
    gf2_sq(odd, even);                    // 4 zero bits
    do {                                  // apply len2 zero BYTES
        gf2_sq(even, odd);
        if (len2 & 1) {
            uint32_t s = 0;
            for (int b = 0; b < 32; b++)
                if (crc1 & (1u << b)) s ^= even[b];
            crc1 = s;
        }
        len2 >>= 1;
        if (!len2) break;
        gf2_sq(odd, even);
        if (len2 & 1) {
            uint32_t s = 0;
            for (int b = 0; b < 32; b++)
                if (crc1 & (1u << b)) s ^= odd[b];
            crc1 = s;
        }
        len2 >>= 1;
    } while (len2);
    return crc1 ^ crc2;
}

extern "C" {

// zlib-compatible CRC32, chunk-parallel for large buffers
uint32_t crc32_buf(const uint8_t* p, int64_t n) {
    crc_init();
    int nt = 1;
#ifdef _OPENMP
    nt = omp_get_max_threads();
#endif
    if (n < (1 << 20) || nt == 1)
        return crc32_span(0, p, n);
    if (nt > 8) nt = 8;
    int64_t per = (n + nt - 1) / nt;
    uint32_t part[8];
    int64_t plen[8];
#pragma omp parallel for schedule(static, 1) num_threads(nt)
    for (int t = 0; t < nt; t++) {
        int64_t lo = t * per, hi = lo + per < n ? lo + per : n;
        plen[t] = hi > lo ? hi - lo : 0;
        part[t] = plen[t] ? crc32_span(0, p + lo, plen[t]) : 0;
    }
    uint32_t crc = part[0];
    for (int t = 1; t < nt; t++)
        crc = crc32_comb(crc, part[t], plen[t]);
    return crc;
}

// ---------------------------------------------------------------------------
// FASTQ indexing: split a buffer into 4-line records, validate, and emit
// per-record (offset, length) for the four fields.
// Returns number of records, or -1 on malformed input (err_pos receives the
// record index that failed).
// ---------------------------------------------------------------------------
// OpenMP team-size control for the pipelined API paths: the 3-stage
// block pipeline runs OpenMP regions from 2-3 Python threads at once
// (prep/finish pool + main); full-width teams then oversubscribe the
// cores and thrash at barriers (measured: decode wall 82-146 ms per 4
// blocks at 4 threads on 4 cores vs 72-78 ms at 2 — tools/
// profile_wall.py). api.py caps teams to ~cores/2 around the pipeline
// and restores after.
void set_omp_threads(int64_t n) {
#ifdef _OPENMP
    if (n > 0) omp_set_num_threads((int)n);
#endif
    (void)n;
}

int64_t get_omp_threads(void) {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

int64_t fastq_index(const uint8_t* data, int64_t n,
                    int64_t cap,  // max records the output arrays can hold
                    int64_t* id_off, int64_t* id_len,
                    int64_t* seq_off, int64_t* seq_len,
                    int64_t* plus_off, int64_t* plus_len,
                    int64_t* qual_off, int64_t* qual_len,
                    int64_t* err_pos) {
    if (n == 0) return 0;
    // pass 1: newline positions, chunk-parallel SIMD count then direct
    // fill into the stitched array (no per-chunk vectors)
    int nt = 1;
#ifdef _OPENMP
    nt = omp_get_max_threads();
#endif
    if (n < (1 << 20)) nt = 1;
    std::vector<int64_t> base(nt + 1, 0);
    int64_t per = (n + nt - 1) / nt;
#pragma omp parallel for schedule(static, 1) num_threads(nt)
    for (int t = 0; t < nt; t++) {
        int64_t lo = t * per, hi = lo + per < n ? lo + per : n;
        base[t + 1] = (hi > lo) ? count_nl(data + lo, hi - lo) : 0;
    }
    for (int t = 0; t < nt; t++) base[t + 1] += base[t];
    int64_t m = base[nt];
    std::vector<int64_t> nl(m);
#pragma omp parallel for schedule(static, 1) num_threads(nt)
    for (int t = 0; t < nt; t++) {
        int64_t lo = t * per, hi = lo + per < n ? lo + per : n;
        if (hi > lo)
            fill_nl(data + lo, hi - lo, lo, nl.data() + base[t]);
    }
    // structural checks: 4 lines per record, file ends with a newline
    int64_t r_total = m / 4;
    if (m % 4 != 0 || m == 0 || nl[m - 1] != n - 1) {
        *err_pos = r_total;
        return -1;
    }
    if (r_total > cap) { *err_pos = cap; return -2; }
    // pass 2: record fields from the newline array, record-parallel;
    // first malformed record reported (min over threads)
    int64_t badr = r_total;
#if defined(_OPENMP) && _OPENMP >= 201107
#pragma omp parallel for schedule(static) reduction(min:badr)
#endif
    for (int64_t r = 0; r < r_total; r++) {
        int64_t l0 = (r == 0) ? 0 : nl[4 * r - 1] + 1;
        int64_t e0 = nl[4 * r];
        int64_t l1 = e0 + 1, e1 = nl[4 * r + 1];
        int64_t l2 = e1 + 1, e2 = nl[4 * r + 2];
        int64_t l3 = e2 + 1, e3 = nl[4 * r + 3];
        if (data[l0] != '@' || data[l2] != '+' || (e1 - l1) != (e3 - l3)) {
            if (r < badr) badr = r;
            continue;
        }
        id_off[r] = l0 + 1; id_len[r] = e0 - l0 - 1;
        seq_off[r] = l1; seq_len[r] = e1 - l1;
        plus_off[r] = l2; plus_len[r] = e2 - l2;
        qual_off[r] = l3; qual_len[r] = e3 - l3;
    }
    if (badr < r_total) { *err_pos = badr; return -1; }
    return r_total;
}

// ---------------------------------------------------------------------------
// varints (LEB128 + zigzag) — format-identical to utils/bits.py
// ---------------------------------------------------------------------------
static inline void put_varint(std::vector<uint8_t>& out, uint64_t v) {
    while (true) {
        uint8_t b = v & 0x7F;
        v >>= 7;
        if (v) out.push_back(b | 0x80);
        else { out.push_back(b); return; }
    }
}

static inline uint64_t zigzag(int64_t v) {
    return (uint64_t(v) << 1) ^ uint64_t(v >> 63);
}

static inline int64_t unzigzag(uint64_t u) {
    return int64_t(u >> 1) ^ -int64_t(u & 1);
}

static inline bool get_varint(const uint8_t* buf, int64_t n, int64_t& pos,
                              uint64_t& v) {
    v = 0;
    int shift = 0;
    while (pos < n) {
        uint8_t b = buf[pos++];
        v |= uint64_t(b & 0x7F) << shift;
        if (!(b & 0x80)) return true;
        shift += 7;
        if (shift > 63) return false;
    }
    return false;
}

// ---------------------------------------------------------------------------
// LEN stream: svarint(length - prev_length). The baseline record is
// r - prev_step (frozen per container format version; matches
// pipeline.py): prev_step=1 for v1/v2, prev_step=wa for v3.
// out buffers sized by caller (max 10 bytes/record). Returns per-lane and

// ---------------------------------------------------------------------------
static inline int put_varint_raw(uint8_t* out, uint64_t v) {
    int i = 0;
    while (true) {
        uint8_t b = v & 0x7F;
        v >>= 7;
        if (v) out[i++] = b | 0x80;
        else { out[i++] = b; return i; }
    }
}

// Emit the per-lane LEN streams directly (arena: wa rows of `stride`
// bytes, per-lane sizes out). prev_step: delta baseline distance. 1 =
// globally previous record (format v1/v2); wa = aux-lane-local previous
// (format v3 — makes decode chains per-lane and therefore
// lane-parallel). v3 prologue: the first prev_step records delta
// against r-1 (global), so a small file does not pay prev_step absolute
// heads — decode runs the same short serial prologue.
int64_t lens_encode(const int64_t* lengths, int64_t n, int64_t wa,
                    int64_t prev_step,
                    uint8_t* arena, int64_t stride, int64_t* sizes) {
    for (int64_t w = 0; w < wa; w++) sizes[w] = 0;
    for (int64_t r = 0; r < n; r++) {
        int64_t w = r % wa;
        int64_t prev = (r >= prev_step) ? lengths[r - prev_step]
            : (r >= 1 ? lengths[r - 1] : 0);
        if (sizes[w] + 10 > stride) return -1;
        sizes[w] += put_varint_raw(arena + w * stride + sizes[w],
                                   zigzag(lengths[r] - prev));
    }
    return 0;
}

// Ragged per-lane payload <-> padded [W, maxlen] matrix (container
// framing). One parallel memcpy per lane — replaces the NumPy
// boolean-mask gather/scatter, which cost ~4 ms per 3 MB payload.
int64_t ragged_pack_rows(const uint8_t* mat, int64_t W, int64_t maxlen,
                         const int64_t* lens, uint8_t* out) {
    std::vector<int64_t> off(W + 1, 0);
    for (int64_t w = 0; w < W; w++) off[w + 1] = off[w] + lens[w];
#pragma omp parallel for schedule(static)
    for (int64_t w = 0; w < W; w++)
        if (lens[w])
            memcpy(out + off[w], mat + w * maxlen, (size_t)lens[w]);
    return off[W];
}

// Compacted per-lane payload + per-lane totals -> final padded payload
// with the 4 coder-flush bytes appended per active lane (twin of
// streams_jax._flush_append; the NumPy mask path cost ~7 ms/block).
void flush_append(const uint8_t* pay, int64_t W, int64_t paylen,
                  const int64_t* totals, const uint32_t* low,
                  const int64_t* counts, uint8_t* out, int64_t maxlen) {
#pragma omp parallel for schedule(static)
    for (int64_t w = 0; w < W; w++) {
        uint8_t* row = out + w * maxlen;
        if (counts[w] <= 0 || maxlen == 0) {
            memset(row, 0, (size_t)maxlen);
            continue;
        }
        int64_t t = totals[w];
        memcpy(row, pay + w * paylen, (size_t)t);
        uint32_t lo = low[w];
        row[t] = (uint8_t)(lo >> 24);
        row[t + 1] = (uint8_t)(lo >> 16);
        row[t + 2] = (uint8_t)(lo >> 8);
        row[t + 3] = (uint8_t)lo;
        if (t + 4 < maxlen) memset(row + t + 4, 0, (size_t)(maxlen - t - 4));
    }
}

void ragged_unpack_rows(const uint8_t* flat, int64_t W, int64_t maxlen,
                        const int64_t* lens, uint8_t* mat) {
    std::vector<int64_t> off(W + 1, 0);
    for (int64_t w = 0; w < W; w++) off[w + 1] = off[w] + lens[w];
#pragma omp parallel for schedule(static)
    for (int64_t w = 0; w < W; w++)
        if (lens[w])
            memcpy(mat + w * maxlen, flat + off[w], (size_t)lens[w]);
}

int64_t lens_decode(const uint8_t* const* lane_bufs,
                    const int64_t* lane_sizes, int64_t n, int64_t wa,
                    int64_t prev_step, int64_t* lengths) {
    if (prev_step > 1) {
        // format v3: serial prologue over the first wa records (each
        // deltas against r-1), then per-lane chains in parallel
        std::vector<int64_t> pos(wa, 0);
        int64_t head = n < wa ? n : wa;
        int64_t prev = 0;
        for (int64_t r = 0; r < head; r++) {
            uint64_t u;
            if (!get_varint(lane_bufs[r], lane_sizes[r], pos[r], u))
                return -1;
            prev += unzigzag(u);
            lengths[r] = prev;
        }
        int64_t bad = 0;
#pragma omp parallel for schedule(static) reduction(|:bad)
        for (int64_t w = 0; w < head; w++) {
            int64_t p = pos[w], pv = lengths[w];
            for (int64_t r = w + wa; r < n; r += wa) {
                uint64_t u;
                if (!get_varint(lane_bufs[w], lane_sizes[w], p, u)) {
                    bad = 1;
                    break;
                }
                pv += unzigzag(u);
                lengths[r] = pv;
            }
        }
        return bad ? -1 : 0;
    }
    int64_t prev = 0;
    std::vector<int64_t> pos(wa, 0);
    for (int64_t r = 0; r < n; r++) {
        int64_t w = r % wa;
        uint64_t u;
        if (!get_varint(lane_bufs[w], lane_sizes[w], pos[w], u)) return -1;
        prev += unzigzag(u);
        lengths[r] = prev;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Read-ID tokenized delta codec (mirrors models/readid.py exactly).
// ---------------------------------------------------------------------------
static const int MAX_DIGITS = 18;

struct Tok { bool digit; int64_t off, len; };

static void tokenize(const uint8_t* s, int64_t n, std::vector<Tok>& toks) {
    toks.clear();
    int64_t i = 0;
    while (i < n) {
        bool d = s[i] >= '0' && s[i] <= '9';
        int64_t j = i + 1;
        while (j < n && ((s[j] >= '0' && s[j] <= '9') == d)) j++;
        toks.push_back({d, i, j - i});
        i = j;
    }
}

static bool digit_value(const uint8_t* s, int64_t len, int64_t& v) {
    if (len > MAX_DIGITS) return false;
    v = 0;
    for (int64_t i = 0; i < len; i++) v = v * 10 + (s[i] - '0');
    return true;
}

// Token with cached numeric value (vok = digit run of <= MAX_DIGITS,
// val = its parsed value). Caching values along a delta chain avoids
// re-parsing the previous ID's digits for every record.
struct TokV { bool digit; bool vok; int32_t off, len; int64_t val; };

static void tokenize_v(const uint8_t* s, int64_t n, int64_t from,
                       std::vector<TokV>& toks) {
    int64_t i = from;
    while (i < n) {
        bool d = s[i] >= '0' && s[i] <= '9';
        int64_t j = i + 1;
        while (j < n && ((s[j] >= '0' && s[j] <= '9') == d)) j++;
        TokV t;
        t.digit = d;
        t.off = (int32_t)i;
        t.len = (int32_t)(j - i);
        t.vok = false;
        t.val = 0;
        if (d) t.vok = digit_value(s + i, j - i, t.val);
        toks.push_back(t);
        i = j;
    }
}

// length of the common byte prefix of two buffers
static int64_t common_prefix(const uint8_t* a, const uint8_t* b,
                             int64_t n) {
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t x, y;
        memcpy(&x, a + i, 8);
        memcpy(&y, b + i, 8);
        if (x != y)
            return i + (__builtin_ctzll(x ^ y) >> 3);
    }
    for (; i < n; i++)
        if (a[i] != b[i]) return i;
    return n;
}

// render value in prev token's format into out; returns rendered length or
// -1 if it cannot match
static int64_t render(const uint8_t* prev_tok, int64_t prev_len,
                      int64_t value, uint8_t* out, int64_t cap) {
    // hand-rolled decimal render (snprintf here measured ~25 ms per 64k
    // records). Semantics identical to "%0*lld"/"%lld": zero-pad to the
    // previous token's width when it had a leading zero.
    char tmp[32];
    bool neg = value < 0;
    uint64_t v = neg ? (uint64_t)(-value) : (uint64_t)value;
    int digits = 0;
    char* p = tmp + 31;
    do { *p-- = (char)('0' + v % 10); v /= 10; digits++; } while (v);
    bool pad = prev_len > 1 && prev_tok[0] == '0';
    int len = digits + (neg ? 1 : 0);
    if (pad && !neg && (int64_t)digits < prev_len) {
        while ((int64_t)digits < prev_len) { *p-- = '0'; digits++; }
        len = digits;
    } else if (pad && neg && (int64_t)(digits + 1) < prev_len) {
        // "%0*lld" puts the sign before the zeros
        while ((int64_t)(digits + 1) < prev_len) { *p-- = '0'; digits++; }
        len = digits + 1;
    }
    if (neg) *p-- = '-';
    if (len > cap) return -1;
    memcpy(out, p + 1, (size_t)len);
    return len;
}

// One record of the ID+plus encode law (shared by the strided range
// worker and the sequential v3 pass — bytes MUST be identical between
// them; tests/test_native.py pins both against models/readid.py).
// prev/pn/pt = the delta-baseline record and its cached tokens; ct is
// scratch that receives cur's tokens (caller swaps it into pt).
static inline void ids_encode_one(const uint8_t* data,
                                  const uint8_t* cur, int64_t cn,
                                  const uint8_t* prev, int64_t pn,
                                  std::vector<TokV>& pt,
                                  std::vector<TokV>& ct, int64_t dbias,
                                  const int64_t* plus_off,
                                  const int64_t* plus_len, int64_t r,
                                  std::vector<uint8_t>& db,
                                  std::vector<uint8_t>& xb,
                                  uint8_t* fo) {
    bool ok = false;
    ct.clear();
    if (prev) {
        size_t mark = db.size();
        // fast path: a token ending strictly inside the common byte
        // prefix is identical in prev and cur (its boundary byte is
        // also common), so structure/text/value carry over and a
        // parseable digit token always passes the width check and
        // emits the constant zigzag(-dbias); unparseable-but-equal
        // emits zigzag(0) exactly as the general law below
        int64_t P = common_prefix(prev, cur, pn < cn ? pn : cn);
        size_t k = 0;
        while (k < pt.size()
               && (int64_t)pt[k].off + pt[k].len < P) {
            const TokV& t = pt[k];
            if (t.digit)
                put_varint(db, t.vok ? zigzag(-dbias) : 0);
            ct.push_back(t);
            k++;
        }
        int64_t q = k ? (int64_t)pt[k - 1].off + pt[k - 1].len : 0;
        tokenize_v(cur, cn, q, ct);
        ok = pt.size() == ct.size();
        for (size_t t = k; t < pt.size() && ok; t++) {
            if (pt[t].digit != ct[t].digit) { ok = false; break; }
            if (!pt[t].digit) {
                if (pt[t].len != ct[t].len ||
                    memcmp(prev + pt[t].off, cur + ct[t].off,
                           ct[t].len) != 0) ok = false;
                continue;
            }
            if (!pt[t].vok || !ct[t].vok) {
                if (pt[t].len == ct[t].len &&
                    memcmp(prev + pt[t].off, cur + ct[t].off,
                           ct[t].len) == 0) {
                    put_varint(db, zigzag(0));
                    continue;
                }
                ok = false;
                break;
            }
            // re-renderability check without materialising the
            // render: cv >= 0 here (digit-run token), and two
            // same-length decimal strings with equal value are
            // identical, so rendered == ct iff the rendered
            // width matches. Mirrors render(): zero-pad to the
            // prev token's width when it had a leading zero.
            int64_t cv = ct[t].val;
            int64_t digits = 1;
            for (int64_t v = cv; v >= 10; v /= 10) digits++;
            bool zpad = pt[t].len > 1 && prev[pt[t].off] == '0';
            int64_t width = (zpad && digits < pt[t].len)
                ? pt[t].len : digits;
            if (width != ct[t].len) {
                ok = false;
                break;
            }
            put_varint(db, zigzag(cv - pt[t].val - dbias));
        }
        if (!ok) db.resize(mark);  // discard partial delta emission
    } else {
        tokenize_v(cur, cn, 0, ct);
    }
    if (ok) {
        fo[0] = 0;
    } else {
        fo[0] = 1;
        put_varint(xb, (uint64_t)cn);
        xb.insert(xb.end(), cur, cur + cn);
    }
    // plus line
    const uint8_t* pl = data + plus_off[r];
    int64_t pln = plus_len[r];
    if (pln == 1 && pl[0] == '+') {
        fo[1] = 1;
        fo[2] = 0;
    } else if (pln == cn + 1 && pl[0] == '+' &&
               memcmp(pl + 1, cur, cn) == 0) {
        fo[1] = 0;
        fo[2] = 1;
    } else {
        fo[1] = 0;
        fo[2] = 0;
        put_varint(xb, (uint64_t)pln);
        xb.insert(xb.end(), pl, pl + pln);
    }
}

// Worker for ids_encode: process records lo, lo+stride, ... (< hi) into
// the given per-lane buffers. The delta baseline is the raw BYTES of
// record r-stride (tokenized on the fly at the range head, cached along
// the chain), so disjoint ranges produce exactly the bytes the
// single-range pass would. stride=1: format v1/v2 global-previous,
// split into contiguous record ranges; stride=wa: format v3
// aux-lane-local previous, one call per lane (lo = lane id). Two v3
// refinements (frozen format rules): (a) the stored numeric delta for
// records r >= stride is biased by -stride — a counter that increments
// by 1 per record advances by exactly `stride` along a lane chain, so
// the common case stores zigzag(0); (b) prologue: records r < stride
// delta against the globally previous record r-1 (bias 0), so a small
// file does not pay `stride` absolute head IDs — decode mirrors with a
// short serial prologue before going lane-parallel.
// fdiv: flags for record r are written at flags_out + 3 * (r / fdiv) —
// fdiv=1 writes the global flags array directly (v1/v2 contiguous record
// ranges), fdiv=stride writes a lane-LOCAL flags buffer indexed by chain
// position (v3: adjacent records belong to different lanes/threads, so
// direct global writes false-share every cache line across all cores).
static void ids_encode_range(const uint8_t* data,
                             const int64_t* id_off, const int64_t* id_len,
                             const int64_t* plus_off,
                             const int64_t* plus_len,
                             int64_t lo, int64_t hi, int64_t stride,
                             int64_t wa, int64_t fdiv,
                             uint8_t* flags_out,
                             std::vector<std::vector<uint8_t>>& dbuf,
                             std::vector<std::vector<uint8_t>>& xbuf) {
    if (lo >= hi) return;  // empty lane (fewer records than lanes)
    std::vector<TokV> pt, ct;
    const uint8_t* prev = nullptr;
    int64_t pn = 0;
    {
        int64_t p0 = (lo >= stride) ? lo - stride : lo - 1;
        if (p0 >= 0) {
            prev = data + id_off[p0];
            pn = id_len[p0];
            tokenize_v(prev, pn, 0, pt);
        }
    }
    for (int64_t r = lo; r < hi; r += stride) {
        int64_t w = r % wa;
        const int64_t dbias = (stride > 1 && r >= stride) ? stride : 0;
        const uint8_t* cur = data + id_off[r];
        int64_t cn = id_len[r];
        ids_encode_one(data, cur, cn, prev, pn, pt, ct, dbias,
                       plus_off, plus_len, r, dbuf[w], xbuf[w],
                       flags_out + 3 * (r / fdiv));
        pt.swap(ct);  // cur tokens become prev tokens for record r+1
        prev = cur;
        pn = cn;
    }
}

// Sequential v3 worker (round 4): process the CONTIGUOUS record range
// [lo, hi) in record order, carrying one delta chain per aux lane.
// Byte-identical per lane to ids_encode_range(lane w, stride=wa) — the
// per-record law is shared (ids_encode_one) and a lane's records are
// visited in the same relative order — but the ID region is walked
// sequentially: the strided per-lane walk touched one ~11 KB-distant
// record per step and was cache-miss-bound. At a range head the lane's
// baseline record is tokenized fresh; fresh tokenization equals the
// carried tokens (token boundaries inside the common region are
// class-transition-determined), which the carry fast path already
// relies on. Per-record baseline (frozen v3 rule): prev = r - wa for
// r >= wa (dbias wa), else the global r - 1 (dbias 0). Flags are
// written straight to flags_out + 3r — sequential per thread, so the
// false-sharing that motivated the old lane-local flag merge is gone.
static void ids_encode_v3_seq(const uint8_t* data,
                              const int64_t* id_off,
                              const int64_t* id_len,
                              const int64_t* plus_off,
                              const int64_t* plus_len,
                              int64_t lo, int64_t hi, int64_t wa,
                              uint8_t* flags_out,
                              std::vector<std::vector<uint8_t>>& dbuf,
                              std::vector<std::vector<uint8_t>>& xbuf) {
    std::vector<const uint8_t*> prevs((size_t)wa, nullptr);
    std::vector<int64_t> pns((size_t)wa, 0);
    std::vector<std::vector<TokV>> pts((size_t)wa);
    std::vector<TokV> ct;
    for (int64_t r = lo; r < hi; r++) {
        int64_t w = r % wa;
        if (prevs[w] == nullptr) {
            int64_t p0 = (r >= wa) ? r - wa : r - 1;
            if (p0 >= 0) {
                prevs[w] = data + id_off[p0];
                pns[w] = id_len[p0];
                pts[w].clear();
                tokenize_v(prevs[w], pns[w], 0, pts[w]);
            }
        }
        const int64_t dbias = (r >= wa) ? wa : 0;
        const uint8_t* cur = data + id_off[r];
        int64_t cn = id_len[r];
        ids_encode_one(data, cur, cn, prevs[w], pns[w], pts[w], ct,
                       dbias, plus_off, plus_len, r, dbuf[w], xbuf[w],
                       flags_out + 3 * r);
        pts[w].swap(ct);
        prevs[w] = cur;
        pns[w] = cn;
    }
}

// Encode n record IDs + plus lines. prev_step selects the delta baseline
// (frozen per container format version): 1 = globally previous record
// r-1 (v1/v2); wa = aux-lane-local previous r-wa (v3 — decode chains
// become per-lane, hence lane-parallel). flags_out: 3 bytes/record in
// lane-stream order [id_exc, plus_plain, plus_idcopy] — identical to
// pipeline.py. Plus-line exceptions interleave with ID exceptions per
// record in the per-lane exception stream, exactly as the Python path
// writes them. OpenMP: both baselines split into contiguous record
// ranges (v1/v2: the stateless strided worker; v3: the sequential
// per-lane-carry worker above). Either way the per-lane streams are
// byte-identical to a serial pass.
int64_t ids_encode(const uint8_t* data,
                   const int64_t* id_off, const int64_t* id_len,
                   const int64_t* plus_off, const int64_t* plus_len,
                   int64_t n, int64_t wa, int64_t prev_step,
                   uint8_t* flags_out,
                   uint8_t* delta_arena, int64_t delta_stride,
                   int64_t* delta_sizes,
                   uint8_t* exc_arena, int64_t exc_stride,
                   int64_t* exc_sizes) {
    int nt = 1;
#ifdef _OPENMP
    nt = omp_get_max_threads();
#endif
    if (nt > 1 && n < 4096) nt = 1;   // below this, spawn cost dominates
    std::vector<std::vector<std::vector<uint8_t>>> dbufs(nt), xbufs(nt);
    int64_t per = (n + nt - 1) / nt;
#pragma omp parallel for schedule(static, 1) num_threads(nt)
    for (int t = 0; t < nt; t++) {
        dbufs[t].resize(wa);
        xbufs[t].resize(wa);
        int64_t lo = t * per, hi = lo + per < n ? lo + per : n;
        if (lo < hi) {
            if (prev_step > 1)
                ids_encode_v3_seq(data, id_off, id_len, plus_off,
                                  plus_len, lo, hi, wa, flags_out,
                                  dbufs[t], xbufs[t]);
            else
                ids_encode_range(data, id_off, id_len, plus_off,
                                 plus_len, lo, hi, 1, wa, 1, flags_out,
                                 dbufs[t], xbufs[t]);
        }
    }
    for (int64_t w = 0; w < wa; w++) {
        int64_t doff = 0, xoff = 0;
        for (int t = 0; t < nt; t++) {
            int64_t ds = (int64_t)dbufs[t][w].size();
            int64_t xs = (int64_t)xbufs[t][w].size();
            if (doff + ds > delta_stride || xoff + xs > exc_stride)
                return -1;
            memcpy(delta_arena + w * delta_stride + doff,
                   dbufs[t][w].data(), (size_t)ds);
            memcpy(exc_arena + w * exc_stride + xoff,
                   xbufs[t][w].data(), (size_t)xs);
            doff += ds;
            xoff += xs;
        }
        delta_sizes[w] = doff;
        exc_sizes[w] = xoff;
    }
    return 0;
}

// Per-lane decode state for the format-v3 two-phase decode: the serial
// prologue (records r < wa, global r-1 baselines) leaves each lane's
// stream positions / arena usage / last-decoded-ID here, and the
// parallel phase resumes from it.
struct LaneSt {
    const uint8_t* prev;  // last decoded ID bytes (baseline), or null
    int64_t prev_len;
    int64_t dpos, xpos;   // delta / exception stream positions
    int64_t used, pused;  // bytes used in the lane's id / plus regions
};

// Decode up to max_recs records r = r_start, r_start+wa, ... of one
// lane's streams (format v3). Baseline = st.prev (caller-provided for
// the lane's first record; record r-wa afterwards); numeric deltas are
// biased by +wa for records r >= wa (see ids_encode_range). Writes IDs
// into a private arena region (global offsets = base + local). The four
// out arrays are LANE-LOCAL, indexed by chain position r / wa (global
// strided writes false-shared every cache line across all decode
// threads); values stored are global arena offsets, merged into the
// record-order arrays by the caller. Returns 0, -1 on corrupt streams,
// -2 on arena overflow (retryable).
static int64_t ids_decode_lane(
        int64_t r_start, int64_t n, int64_t wa, int64_t max_recs,
        const uint8_t* flags,
        const uint8_t* dbuf, int64_t dsz,
        const uint8_t* xbuf, int64_t xsz,
        uint8_t* arena, int64_t cap, int64_t base,
        int64_t* out_off, int64_t* out_len,
        uint8_t* parena, int64_t pcap, int64_t pbase,
        int64_t* plus_off, int64_t* plus_len, LaneSt& st) {
    // Token-structure cache: along a delta chain, the rendered ID's token
    // list is derivable from the previous one (text bytes copied, digit
    // runs re-rendered), so tokenize + digit re-parse are needed only at
    // the chain head, after an exception record, or after a corrupt
    // stream renders a negative value (whose '-' breaks the digit-run
    // structure) — in all of which the cache is invalidated and rebuilt
    // from the actual bytes, exactly matching an uncached decode.
    std::vector<TokV> pt, nt;
    bool cached = false;
    int64_t done = 0;
    for (int64_t r = r_start; r < n && done < max_recs; r += wa, done++) {
        const int64_t dbias = (r >= wa) ? wa : 0;
        const int64_t li = r / wa;   // lane-local output index
        int64_t rec_off, rec_len;
        if (flags[3 * r] == 0) {
            if (!st.prev) return -1;
            if (!cached) {
                pt.clear();
                tokenize_v(st.prev, st.prev_len, 0, pt);
            }
            rec_off = st.used;
            int64_t len = 0;
            nt.clear();
            bool structure_ok = true;
            for (auto& t : pt) {
                if (st.used + len + t.len + 32 > cap) return -2;
                if (!t.digit) {
                    memcpy(arena + st.used + len, st.prev + t.off, t.len);
                    nt.push_back({false, false, (int32_t)len, t.len, 0});
                    len += t.len;
                    continue;
                }
                uint64_t u;
                if (!get_varint(dbuf, dsz, st.dpos, u)) return -1;
                int64_t d = unzigzag(u) + dbias;
                if (!t.vok) {
                    memcpy(arena + st.used + len, st.prev + t.off, t.len);
                    nt.push_back({true, false, (int32_t)len, t.len, 0});
                    len += t.len;
                    continue;
                }
                int64_t v = t.val + d;
                int64_t rl = render(st.prev + t.off, t.len, v,
                                    arena + st.used + len, 32);
                if (rl < 0) return -1;
                if (v < 0) structure_ok = false;
                nt.push_back({true, v >= 0 && rl <= MAX_DIGITS,
                              (int32_t)len, (int32_t)rl, v});
                len += rl;
            }
            rec_len = len;
            st.used += len;
            pt.swap(nt);
            cached = structure_ok;
        } else {
            uint64_t ln;
            if (!get_varint(xbuf, xsz, st.xpos, ln)) return -1;
            if (st.xpos + (int64_t)ln > xsz) return -1;
            if (st.used + (int64_t)ln > cap) return -2;
            memcpy(arena + st.used, xbuf + st.xpos, ln);
            st.xpos += ln;
            rec_off = st.used;
            rec_len = ln;
            st.used += ln;
            cached = false;  // exception bytes: re-tokenize next record
        }
        out_off[li] = base + rec_off;
        out_len[li] = rec_len;
        // plus line
        if (flags[3 * r + 1] == 1) {
            if (st.pused + 1 > pcap) return -2;
            parena[st.pused] = '+';
            plus_off[li] = pbase + st.pused;
            plus_len[li] = 1;
            st.pused += 1;
        } else if (flags[3 * r + 2] == 1) {
            int64_t ln = rec_len + 1;
            if (st.pused + ln > pcap) return -2;
            parena[st.pused] = '+';
            memcpy(parena + st.pused + 1, arena + rec_off, rec_len);
            plus_off[li] = pbase + st.pused;
            plus_len[li] = ln;
            st.pused += ln;
        } else {
            uint64_t ln;
            if (!get_varint(xbuf, xsz, st.xpos, ln)) return -1;
            if (st.xpos + (int64_t)ln > xsz) return -1;
            if (st.pused + (int64_t)ln > pcap) return -2;
            memcpy(parena + st.pused, xbuf + st.xpos, ln);
            st.xpos += ln;
            plus_off[li] = pbase + st.pused;
            plus_len[li] = ln;
            st.pused += ln;
        }
        st.prev = arena + rec_off;
        st.prev_len = rec_len;
    }
    return 0;
}

// Decode n record IDs + plus lines. flags: 3 bytes/record (as encoded).
// prev_step as in ids_encode (1 = global r-1, wa = lane-local r-wa; the
// lane-local format decodes all lanes in parallel). IDs land in id_arena
// (offsets/lengths out); plus lines in plus_arena. Returns bytes used in
// id_arena, -1 on corrupt streams, -2 on arena overflow (retryable with
// a bigger arena).
int64_t ids_decode(int64_t n, int64_t wa, int64_t prev_step,
                   const uint8_t* flags,
                   const uint8_t* const* delta_bufs,
                   const int64_t* delta_sizes,
                   const uint8_t* const* exc_bufs,
                   const int64_t* exc_sizes,
                   uint8_t* id_arena, int64_t arena_cap,
                   int64_t* out_off, int64_t* out_len,
                   uint8_t* plus_arena, int64_t plus_cap,
                   int64_t* plus_off, int64_t* plus_len,
                   int64_t* plus_used_out) {
    if (prev_step > 1) {
        // format v3: partition both arenas into per-lane regions sized
        // proportionally to the caller's caps, then decode lanes in
        // parallel (each lane's chain is independent)
        std::vector<int64_t> cap(wa), base(wa + 1, 0);
        std::vector<int64_t> pcap(wa), pbase(wa + 1, 0);
        int64_t slack = arena_cap, pslack = plus_cap;
        for (int64_t w = 0; w < wa; w++) {
            slack -= exc_sizes[w];
            pslack -= exc_sizes[w];
        }
        slack = slack > 0 ? slack / wa : 0;
        pslack = pslack > 0 ? pslack / wa : 0;
        for (int64_t w = 0; w < wa; w++) {
            cap[w] = exc_sizes[w] + slack;
            pcap[w] = exc_sizes[w] + pslack;
            base[w + 1] = base[w] + cap[w];
            pbase[w + 1] = pbase[w] + pcap[w];
        }
        if (base[wa] > arena_cap || pbase[wa] > plus_cap) return -2;
        // lane-local output buffers: ids_decode_lane indexes its out
        // arrays by chain position r / wa (global strided writes
        // false-shared every cache line across decode threads); values
        // are global arena offsets, merged into record order below
        int64_t rpl = (n + wa - 1) / wa;
        std::vector<int64_t> lout(4 * wa * rpl);
        int64_t* lo_off = lout.data();
        int64_t* lo_len = lo_off + wa * rpl;
        int64_t* lp_off = lo_len + wa * rpl;
        int64_t* lp_len = lp_off + wa * rpl;
        // phase 1 (serial prologue): records 0..min(wa,n)-1 delta
        // against the globally previous record r-1 (bias 0)
        int64_t head = n < wa ? n : wa;
        std::vector<LaneSt> st(wa);
        for (int64_t w = 0; w < wa; w++)
            st[w] = LaneSt{nullptr, 0, 0, 0, 0, 0};
        const uint8_t* gprev = nullptr;
        int64_t gprev_len = 0;
        for (int64_t w = 0; w < head; w++) {
            st[w].prev = gprev;
            st[w].prev_len = gprev_len;
            int64_t rc = ids_decode_lane(
                w, n, wa, 1, flags, delta_bufs[w], delta_sizes[w],
                exc_bufs[w], exc_sizes[w],
                id_arena + base[w], cap[w], base[w],
                lo_off + w * rpl, lo_len + w * rpl,
                plus_arena + pbase[w], pcap[w], pbase[w],
                lp_off + w * rpl, lp_len + w * rpl, st[w]);
            if (rc < 0) return rc;
            gprev = id_arena + lo_off[w * rpl];
            gprev_len = lo_len[w * rpl];
        }
        // phase 2: every lane's remaining chain is independent
        int64_t bad = 0;
#if defined(_OPENMP) && _OPENMP >= 201107
#pragma omp parallel for schedule(dynamic, 1) reduction(min:bad)
#endif
        for (int64_t w = 0; w < head; w++) {
            // thread-local state copy: adjacent LaneSt entries share
            // cache lines and are updated per record — in-place use
            // false-shared them into a 1x serial-speed "parallel" loop
            LaneSt ls = st[w];
            int64_t rc = ids_decode_lane(
                w + wa, n, wa, n, flags, delta_bufs[w], delta_sizes[w],
                exc_bufs[w], exc_sizes[w],
                id_arena + base[w], cap[w], base[w],
                lo_off + w * rpl, lo_len + w * rpl,
                plus_arena + pbase[w], pcap[w], pbase[w],
                lp_off + w * rpl, lp_len + w * rpl, ls);
            st[w] = ls;
            if (rc < 0 && rc < bad) bad = rc;
        }
        if (bad < 0) return bad;
        // merge lane-local chain-order outputs into record order
#pragma omp parallel for schedule(static)
        for (int64_t r = 0; r < n; r++) {
            int64_t k = (r % wa) * rpl + r / wa;
            out_off[r] = lo_off[k];
            out_len[r] = lo_len[k];
            plus_off[r] = lp_off[k];
            plus_len[r] = lp_len[k];
        }
        *plus_used_out = pbase[wa];
        return base[wa];
    }
    std::vector<Tok> pt;
    std::vector<int64_t> dpos(wa, 0), xpos(wa, 0);
    int64_t used = 0, pused = 0;
    for (int64_t r = 0; r < n; r++) {
        int64_t w = r % wa;
        if (flags[3 * r] == 0) {
            if (r < 1) return -1;
            const uint8_t* prev = id_arena + out_off[r - 1];
            int64_t pn = out_len[r - 1];
            tokenize(prev, pn, pt);
            out_off[r] = used;
            int64_t len = 0;
            for (auto& t : pt) {
                if (used + len + t.len + 32 > arena_cap) return -2;
                if (!t.digit) {
                    memcpy(id_arena + used + len, prev + t.off, t.len);
                    len += t.len;
                    continue;
                }
                uint64_t u;
                if (!get_varint(delta_bufs[w], delta_sizes[w], dpos[w], u))
                    return -1;
                int64_t d = unzigzag(u);
                int64_t pv;
                if (!digit_value(prev + t.off, t.len, pv)) {
                    memcpy(id_arena + used + len, prev + t.off, t.len);
                    len += t.len;
                    continue;
                }
                int64_t rl = render(prev + t.off, t.len, pv + d,
                                    id_arena + used + len, 32);
                if (rl < 0) return -1;
                len += rl;
            }
            out_len[r] = len;
            used += len;
        } else {
            uint64_t ln;
            if (!get_varint(exc_bufs[w], exc_sizes[w], xpos[w], ln))
                return -1;
            if (xpos[w] + (int64_t)ln > exc_sizes[w]) return -1;
            if (used + (int64_t)ln > arena_cap) return -2;
            memcpy(id_arena + used, exc_bufs[w] + xpos[w], ln);
            xpos[w] += ln;
            out_off[r] = used;
            out_len[r] = ln;
            used += ln;
        }
        // plus line
        if (flags[3 * r + 1] == 1) {
            if (pused + 1 > plus_cap) return -2;
            plus_arena[pused] = '+';
            plus_off[r] = pused;
            plus_len[r] = 1;
            pused += 1;
        } else if (flags[3 * r + 2] == 1) {
            int64_t ln = out_len[r] + 1;
            if (pused + ln > plus_cap) return -2;
            plus_arena[pused] = '+';
            memcpy(plus_arena + pused + 1, id_arena + out_off[r],
                   out_len[r]);
            plus_off[r] = pused;
            plus_len[r] = ln;
            pused += ln;
        } else {
            uint64_t ln;
            if (!get_varint(exc_bufs[w], exc_sizes[w], xpos[w], ln))
                return -1;
            if (xpos[w] + (int64_t)ln > exc_sizes[w]) return -1;
            if (pused + (int64_t)ln > plus_cap) return -2;
            memcpy(plus_arena + pused, exc_bufs[w] + xpos[w], ln);
            xpos[w] += ln;
            plus_off[r] = pused;
            plus_len[r] = ln;
            pused += ln;
        }
    }
    *plus_used_out = pused;
    return used;
}

// ---------------------------------------------------------------------------
// decode-side FASTQ text assembly:
// '@' id '\n' seq '\n' plus '\n' qual '\n' per record.
// ---------------------------------------------------------------------------
// Lane-grouped flag triples -> record order: record r (lane w = r % wa,
// chain position i = r / wa) reads grouped row base[w] + i. One parallel
// gather pass (the NumPy fancy-index scatter this replaces cost ~0.9 ms
// at 64k records).
void flags_reorder(const uint8_t* grouped, int64_t n, int64_t wa,
                   uint8_t* out) {
    std::vector<int64_t> base(wa + 1, 0);
    for (int64_t w = 0; w < wa; w++)
        base[w + 1] = base[w] + (n > w ? (n - w + wa - 1) / wa : 0);
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n; r++) {
        int64_t g = base[r % wa] + r / wa;
        out[3 * r] = grouped[3 * g];
        out[3 * r + 1] = grouped[3 * g + 1];
        out[3 * r + 2] = grouped[3 * g + 2];
    }
}

int64_t fastq_assemble(int64_t n,
                       const uint8_t* id_arena, const int64_t* id_off,
                       const int64_t* id_len,
                       const uint8_t* seq_buf, const int64_t* seq_off,
                       const uint8_t* qual_buf,
                       const int64_t* lengths,
                       const uint8_t* plus_arena, const int64_t* plus_off,
                       const int64_t* plus_len,
                       uint8_t* out, int64_t cap) {
    // serial prefix of output offsets, then record-parallel memcpy fill
    std::vector<int64_t> op(n + 1);
    op[0] = 0;
    for (int64_t r = 0; r < n; r++)
        op[r + 1] = op[r] + 1 + id_len[r] + 1 + lengths[r] + 1
            + plus_len[r] + 1 + lengths[r] + 1;
    if (op[n] > cap) return -1;
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n; r++) {
        int64_t p = op[r];
        out[p++] = '@';
        memcpy(out + p, id_arena + id_off[r], id_len[r]);
        p += id_len[r];
        out[p++] = '\n';
        memcpy(out + p, seq_buf + seq_off[r], lengths[r]);
        p += lengths[r];
        out[p++] = '\n';
        memcpy(out + p, plus_arena + plus_off[r], plus_len[r]);
        p += plus_len[r];
        out[p++] = '\n';
        memcpy(out + p, qual_buf + seq_off[r], lengths[r]);
        p += lengths[r];
        out[p++] = '\n';
    }
    return op[n];
}


// ---------------------------------------------------------------------------
// Lane packing: variable-length record ranges -> lane-major symbol matrix.
// Records are assigned round-robin (r % W) and concatenated per lane in
// record order. Output layout is [W, S] (lane-contiguous; the caller
// transposes with one vectorised copy if it needs [S, W]).
// map256: byte -> symbol map; entries of 255 count as "bad" (returned so
// the caller can run the exception path only when needed). bias is
// subtracted after mapping (e.g. min quality).
// ---------------------------------------------------------------------------
int64_t pack_lanes(const uint8_t* src, const int64_t* offs,
                   const int64_t* lens, int64_t n, int64_t W, int64_t S,
                   const uint8_t* map256, int32_t bias,
                   uint32_t* out /*[W*S]*/, int64_t* lane_totals) {
    for (int64_t w = 0; w < W; w++) lane_totals[w] = 0;
    int64_t bad = 0;
    for (int64_t r = 0; r < n; r++) {
        int64_t w = r % W;
        uint32_t* row = out + w * S + lane_totals[w];
        const uint8_t* s = src + offs[r];
        int64_t L = lens[r];
        if (map256) {
            for (int64_t i = 0; i < L; i++) {
                uint8_t v = map256[s[i]];
                bad += (v == 255);
                row[i] = (v == 255) ? 0u : (uint32_t)v;
            }
        } else {
            for (int64_t i = 0; i < L; i++)
                row[i] = (uint32_t)(int32_t(s[i]) - bias);
        }
        lane_totals[w] += L;
    }
    return bad;
}

// inverse: [W, S] lane-major matrix -> record-major byte buffer through a
// symbol->byte map (or +bias for qualities)
int64_t unpack_lanes(const uint32_t* mat /*[W*S]*/, const int64_t* lens,
                     int64_t n, int64_t W, int64_t S,
                     const uint8_t* map256, int32_t bias,
                     uint8_t* out, const int64_t* out_offs) {
    std::vector<int64_t> pos(W, 0);
    for (int64_t r = 0; r < n; r++) {
        int64_t w = r % W;
        const uint32_t* row = mat + w * S + pos[w];
        uint8_t* dst = out + out_offs[r];
        int64_t L = lens[r];
        if (map256) {
            for (int64_t i = 0; i < L; i++)
                dst[i] = map256[row[i] & 255u];
        } else {
            for (int64_t i = 0; i < L; i++)
                dst[i] = (uint8_t)(int32_t(row[i]) + bias);
        }
        pos[w] += L;
    }
    return 0;
}

// min/max over all record ranges in one pass (for quality biasing)
// ---------------------------------------------------------------------------
// Emission compaction: dense per-chunk device buffers -> per-lane payload
// rows + flush tail. Replaces the NumPy boolean-take compactor (measured
// 0.3 s/stream at NC=800, W=1024 on CPU; this is a straight memcpy pass).
// ebufs: [NC, W*CB] uint8; eptrs: [NC, W] int32 (valid bytes per chunk);
// low: uint32[W] coder state for the flush bytes; counts: int64[W]
// (lanes with counts<=0 emit nothing). payload out: [W, maxlen];
// lens out: int64[W]. Returns 0, or -1 if maxlen is too small.
// ---------------------------------------------------------------------------
int64_t compact_lanes(const uint8_t* ebufs, const int32_t* eptrs,
                      const uint32_t* low, const int64_t* counts,
                      int64_t NC, int64_t W, int64_t CB,
                      int64_t flush_bytes,
                      uint8_t* payload, int64_t maxlen, int64_t* lens) {
    int overflow = 0;   // lanes write disjoint payload rows -> parallel
#pragma omp parallel for schedule(static) reduction(|:overflow)
    for (int64_t w = 0; w < W; w++) {
        if (counts[w] <= 0) { lens[w] = 0; continue; }
        uint8_t* dst = payload + w * maxlen;
        int64_t off = 0;
        for (int64_t c = 0; c < NC; c++) {
            int32_t nb = eptrs[c * W + w];
            if (nb > 0) {
                if (off + nb > maxlen) { overflow = 1; break; }
                memcpy(dst + off, ebufs + c * (W * CB) + w * CB,
                       (size_t)nb);
                off += nb;
            }
        }
        if (off + flush_bytes > maxlen) { overflow = 1; continue; }
        uint32_t lw = low[w];
        for (int64_t j = 0; j < flush_bytes; j++)
            dst[off + j] = (uint8_t)(lw >> (24 - 8 * j));
        lens[w] = off + flush_bytes;
    }
    return overflow ? -1 : 0;
}

// ---------------------------------------------------------------------------
// pack_lanes2: OpenMP record-parallel lane packing. Writes the [W, S]
// transposed matrix (contiguous per record) + per-record non-ACGT flags;
// pair with transpose_u32 for the [S, W] kernel layout. Per-record row
// starts are a cheap serial prefix; the fill is embarrassingly parallel.
// ---------------------------------------------------------------------------
int64_t pack_lanes2(const uint8_t* src, const int64_t* offs,
                    const int64_t* lens, int64_t n, int64_t W, int64_t S,
                    const uint8_t* map256, int32_t bias,
                    uint32_t* matT /*[W*S]*/, int64_t* lane_totals,
                    int32_t* rec_bad /*[n]*/) {
    std::vector<int64_t> rec_start(n);
    for (int64_t w = 0; w < W; w++) lane_totals[w] = 0;
    for (int64_t r = 0; r < n; r++) {
        int64_t w = r % W;
        rec_start[r] = lane_totals[w];
        lane_totals[w] += lens[r];
    }
    int64_t nbad = 0;
#pragma omp parallel for schedule(static) reduction(+:nbad)
    for (int64_t r = 0; r < n; r++) {
        int64_t w = r % W;
        uint32_t* row = matT + w * S + rec_start[r];
        const uint8_t* s = src + offs[r];
        int64_t L = lens[r];
        int32_t bad = 0;
        if (map256) {
            for (int64_t i = 0; i < L; i++) {
                uint8_t v = map256[s[i]];
                bad += (v == 255);
                row[i] = (v == 255) ? 0u : (uint32_t)v;
            }
        } else {
            for (int64_t i = 0; i < L; i++)
                row[i] = (uint32_t)(int32_t(s[i]) - bias);
        }
        if (rec_bad) rec_bad[r] = bad;
        nbad += bad;
    }
    return nbad;
}

// Blocked OpenMP transpose [W, S] u32 -> [S, W] u32.
void transpose_u32(const uint32_t* in, uint32_t* out, int64_t W,
                   int64_t S) {
    const int64_t B = 64;
#pragma omp parallel for collapse(2) schedule(static)
    for (int64_t s0 = 0; s0 < S; s0 += B)
        for (int64_t w0 = 0; w0 < W; w0 += B) {
            int64_t s1 = s0 + B < S ? s0 + B : S;
            int64_t w1 = w0 + B < W ? w0 + B : W;
            for (int64_t s = s0; s < s1; s++)
                for (int64_t w = w0; w < w1; w++)
                    out[s * W + w] = in[w * S + s];
        }
}

// uint8 twins of pack_lanes2 / transpose_u32 / unpack_lanes. Every stream
// symbol fits in a byte (tree depth <= 8), so the host<->device boundary
// matrices are uint8: 4x less host memory traffic and 4x smaller PCIe /
// tunnel transfers than the uint32 layout (the device upcasts once,
// whole-array, outside the scan — KERNEL_NOTES §5).
int64_t pack_lanes2_u8(const uint8_t* src, const int64_t* offs,
                       const int64_t* lens, int64_t n, int64_t W, int64_t S,
                       const uint8_t* map256, int32_t bias,
                       uint8_t* matT /*[W*S]*/, int64_t* lane_totals,
                       int32_t* rec_bad /*[n]*/) {
    std::vector<int64_t> rec_start(n);
    for (int64_t w = 0; w < W; w++) lane_totals[w] = 0;
    for (int64_t r = 0; r < n; r++) {
        int64_t w = r % W;
        rec_start[r] = lane_totals[w];
        lane_totals[w] += lens[r];
    }
    int64_t nbad = 0;
#pragma omp parallel for schedule(static) reduction(+:nbad)
    for (int64_t r = 0; r < n; r++) {
        int64_t w = r % W;
        uint8_t* row = matT + w * S + rec_start[r];
        const uint8_t* s = src + offs[r];
        int64_t L = lens[r];
        int32_t bad = 0;
        if (map256) {
            for (int64_t i = 0; i < L; i++) {
                uint8_t v = map256[s[i]];
                bad += (v == 255);
                row[i] = (v == 255) ? 0 : v;
            }
        } else {
            for (int64_t i = 0; i < L; i++)
                row[i] = (uint8_t)(int32_t(s[i]) - bias);
        }
        if (rec_bad) rec_bad[r] = bad;
        nbad += bad;
    }
    return nbad;
}

// Blocked OpenMP transpose [A, B] u8 -> [B, A] u8.
void transpose_u8(const uint8_t* in, uint8_t* out, int64_t A, int64_t B) {
    const int64_t T = 128;
#pragma omp parallel for collapse(2) schedule(static)
    for (int64_t b0 = 0; b0 < B; b0 += T)
        for (int64_t a0 = 0; a0 < A; a0 += T) {
            int64_t b1 = b0 + T < B ? b0 + T : B;
            int64_t a1 = a0 + T < A ? a0 + T : A;
            for (int64_t b = b0; b < b1; b++)
                for (int64_t a = a0; a < a1; a++)
                    out[b * A + a] = in[a * B + b];
        }
}

// OpenMP record-parallel inverse of pack_lanes2_u8: [W, S] u8 lane-major
// matrix -> record-major byte buffer through map256 (or +bias). Each
// record writes a disjoint out range, so the fill parallelizes after a
// cheap serial per-record row-start prefix.
int64_t unpack_lanes2_u8(const uint8_t* matT /*[W*S]*/, const int64_t* lens,
                         int64_t n, int64_t W, int64_t S,
                         const uint8_t* map256, int32_t bias,
                         uint8_t* out, const int64_t* out_offs) {
    std::vector<int64_t> rec_start(n);
    std::vector<int64_t> pos(W, 0);
    for (int64_t r = 0; r < n; r++) {
        int64_t w = r % W;
        rec_start[r] = pos[w];
        pos[w] += lens[r];
    }
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n; r++) {
        int64_t w = r % W;
        const uint8_t* row = matT + w * S + rec_start[r];
        uint8_t* dst = out + out_offs[r];
        int64_t L = lens[r];
        if (map256) {
            for (int64_t i = 0; i < L; i++)
                dst[i] = map256[row[i]];
        } else {
            for (int64_t i = 0; i < L; i++)
                dst[i] = (uint8_t)(int32_t(row[i]) + bias);
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Run-length non-ACGT exception streams (container format v2; mirrors
// pipeline.stream_jobs / seqx_runs byte-for-byte), aux-lane-local.
// Per exception run: first run of a record emits varint(ordinal -
// prev_exc_ordinal[lane]) + varint(start); later runs varint(0) +
// varint(start - prev_run_end); then varint(run_len - 1) + raw char.
// arena: wa rows of `stride` bytes; sizes out per lane. Returns total
// bytes, or -1 on overflow (caller retries with a bigger stride).
// ---------------------------------------------------------------------------
int64_t seqx_encode(const uint8_t* src, const int64_t* offs,
                    const int64_t* lens, int64_t n, int64_t wa,
                    uint8_t* arena, int64_t stride, int64_t* sizes,
                    const int32_t* rec_bad /*optional [n]: skip clean recs*/) {
    // lanes are independent (record r -> lane r % wa, per-lane run state),
    // so the encode parallelizes per lane, byte-identical to a serial pass
    int64_t overflow = 0;
#pragma omp parallel for schedule(dynamic, 1) reduction(|:overflow)
    for (int64_t w = 0; w < wa; w++) {
        std::vector<uint8_t> xb;
        int64_t prev_xrec = -1;
        for (int64_t r = w; r < n; r += wa) {
            if (rec_bad && rec_bad[r] == 0) continue;
            const uint8_t* s = src + offs[r];
            int64_t L = lens[r];
            int64_t ordinal = r / wa;
            int64_t prev_end = 0;
            bool first = true;
            int64_t i = 0;
            while (i < L) {
                uint8_t c = s[i];
                if (c == 'A' || c == 'C' || c == 'G' || c == 'T') {
                    i++;
                    continue;
                }
                int64_t st = i;
                while (i < L && s[i] == c) i++;
                int64_t ln = i - st;
                if (first) {
                    put_varint(xb, (uint64_t)(ordinal - prev_xrec));
                    put_varint(xb, (uint64_t)st);
                    first = false;
                } else {
                    put_varint(xb, 0);
                    put_varint(xb, (uint64_t)(st - prev_end));
                }
                put_varint(xb, (uint64_t)(ln - 1));
                xb.push_back(c);
                prev_end = st + ln - 1;
            }
            if (!first) prev_xrec = ordinal;
        }
        int64_t sz = (int64_t)xb.size();
        if (sz > stride) {
            overflow = 1;
            continue;
        }
        if (sz) memcpy(arena + w * stride, xb.data(), (size_t)sz);
        sizes[w] = sz;
    }
    if (overflow) return -1;
    int64_t total = 0;
    for (int64_t w = 0; w < wa; w++) total += sizes[w];
    return total;
}

// Decode-side twin of seqx_encode: parse every aux lane's exception
// stream (fmt>=2 run records, fmt==1 per-base) and patch the exception
// chars straight into the record-major sequence buffer. Lanes are
// independent and every patched position is unique -> parallel over
// lanes. Returns 0, or -1 on a malformed stream / out-of-bounds patch
// (corrupt container that slipped past the CRC).
int64_t seqx_apply(const uint8_t* const* bufs, const int64_t* sizes,
                   int64_t wa, int64_t fmt, int64_t n,
                   const int64_t* rec_starts, const int64_t* rec_lens,
                   uint8_t* out) {
    int bad = 0;
#pragma omp parallel for schedule(static) reduction(|:bad)
    for (int64_t w = 0; w < wa; w++) {
        const uint8_t* b = bufs[w];
        int64_t len = sizes[w];
        int64_t p = 0, ordinal = -1, prev_end = 0, prev_pos = -1;
        while (p < len) {
            uint64_t drec, dpos, runl = 0;
            if (!get_varint(b, len, p, drec)) { bad = 1; break; }
            if (!get_varint(b, len, p, dpos)) { bad = 1; break; }
            if (fmt >= 2 && !get_varint(b, len, p, runl)) { bad = 1; break; }
            if (p >= len) { bad = 1; break; }
            uint8_t ch = b[p++];
            int64_t start;
            if (drec) {
                ordinal += (int64_t)drec;
                start = (int64_t)dpos;
            } else {
                start = (fmt >= 2 ? prev_end : prev_pos) + (int64_t)dpos;
            }
            int64_t r = w + ordinal * wa;
            if (r < 0 || r >= n || start < 0 ||
                start + (int64_t)runl >= rec_lens[r]) { bad = 1; break; }
            uint8_t* dst = out + rec_starts[r] + start;
            for (uint64_t k = 0; k <= runl; k++) dst[k] = ch;
            prev_end = start + (int64_t)runl;
            prev_pos = start;
        }
    }
    return bad ? -1 : 0;
}

// Non-ACGT census only (no packing): per-record exception-base counts +
// total. Pure read pass for the device-pack path, where the layout
// transform itself happens on the TPU and the host only needs to know
// which records feed the SEQX exception stream.
int64_t scan_bad(const uint8_t* src, const int64_t* offs,
                 const int64_t* lens, int64_t n, int32_t* rec_bad) {
    int64_t nbad = 0;
#pragma omp parallel for schedule(static) reduction(+:nbad)
    for (int64_t r = 0; r < n; r++) {
        const uint8_t* s = src + offs[r];
        int64_t L = lens[r];
        int32_t bad = 0;
        for (int64_t i = 0; i < L; i++) {
            uint8_t c = s[i];
            bad += !(c == 'A' || c == 'C' || c == 'G' || c == 'T');
        }
        rec_bad[r] = bad;
        nbad += bad;
    }
    return nbad;
}

void minmax_ranges(const uint8_t* src, const int64_t* offs,
                   const int64_t* lens, int64_t n, int64_t* mn_out,
                   int64_t* mx_out) {
    int mn = 255, mx = 0;
#if defined(_OPENMP) && _OPENMP >= 201107
#pragma omp parallel for schedule(static) reduction(min:mn) reduction(max:mx)
#endif
    for (int64_t r = 0; r < n; r++) {
        const uint8_t* s = src + offs[r];
        for (int64_t i = 0; i < lens[r]; i++) {
            int v = s[i];
            if (v < mn) mn = v;
            if (v > mx) mx = v;
        }
    }
    *mn_out = mn;
    *mx_out = mx;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Format v5 long-range read matcher — C++ twin of models/matcher.py
// (the normative NumPy implementation; tests pin bit-for-bit equality of
// the selected matches). Constants are frozen there: K=16, sample iff
// splitmix64(kmer) & 7 == 0, MAX_CAND=16 entries per kmer in insertion
// order, score = span - 8*mm, chunked index (refs from earlier
// MATCH_CHUNK=1024-record chunks only), best by (score, ref, -orient,
// -zigzag(v)) maximised.
// ---------------------------------------------------------------------------

static const int MK = 16;            // k-mer length
// A position is sampled iff mix & mask == 0, `mask` being match_find's
// `sample_mask` argument: models/matcher.sample_mask() reads
// SFQ_MATCH_SAMPLE_MASK when it is called (default 15: 1/16, round 5 —
// measured +0.16..0.23% container for -38% match_find vs 1/8) and both
// the oracle and this twin's caller take it from there, so the two
// cannot sample differently. ENCODER policy, not bit format (decode
// reads explicit descriptors).
static const int MMAXC = 16;         // index entries per kmer
static const int MPEN = 8;           // mismatch penalty
static const int64_t MCHUNK = 1024;  // index chunk (records)

static inline uint64_t mix64(uint64_t x) {
    x ^= x >> 30;
    x *= 0xBF58476D1CE4E5B9ULL;
    x ^= x >> 27;
    x *= 0x94D049BB133111EBULL;
    x ^= x >> 31;
    return x;
}

static uint8_t M_B2C0[256];
static void m_b2c0_init() {
    static bool done = false;
    if (done) return;
    memset(M_B2C0, 0, 256);
    M_B2C0['A'] = 0; M_B2C0['C'] = 1; M_B2C0['G'] = 2; M_B2C0['T'] = 3;
    done = true;
}
static const char M_C2B[4] = {'A', 'C', 'G', 'T'};

// Candidate chains are stored CONTIGUOUSLY per key (a 4-entry block
// grown once to MMAXC on the 5th insert) instead of as a linked list:
// a query probe walks 1-2 cache lines, not up to 16 scattered pool
// nodes. Entry order within a key is still insertion order (part of
// the frozen selection rule — candidates are only a SET for the
// (score, ref, -orient, -zz) max, but the cap at MMAXC keeps the FIRST
// 16, so order of arrival matters).
struct MEntry { int32_t ref; int32_t pos; };
// 8-byte slot (round 5): a K=16 kmer is exactly 2K=32 bits, so the key
// needs no u64; blk/cnt pack into the second word (bc = unit << 5 | cnt,
// bc == 0 <=> empty since occupied slots have cnt >= 1). Halving the
// slot size halves the probe-phase cache footprint of the ~16-32 MB
// table — the query walk is miss-bound, not compute-bound (measured:
// SFQ_MATCH_STATS). Hash sequence (mix64(key) >> 3) & mask and probe
// order are unchanged, so the candidate sets — and the frozen
// selection — are bit-identical.
struct MSlot { uint32_t key; uint32_t bc; };
// Candidate blocks start on multiples of MUNIT entries (the cursor
// steps by 4 and by MMAXC), so the 27-bit field counts MUNIT-entry
// units: it holds a block start below MARENA_MAX = 2^29 entries, and an
// insert that would take the cursor past that fails instead of wrapping.
static const int64_t MUNIT = 4;
static const int64_t MARENA_MAX = (int64_t)MUNIT << 27;

struct MIndex {
    std::vector<MSlot> slots;
    // Candidate arena: raw realloc'd buffer, NOT a std::vector — the
    // per-chunk worst-case slack (16 entries per pending insert) must
    // not be value-initialised on every grow (the vector memset +
    // geometric copy was a measured serial cost of the insert phase).
    MEntry* arena = nullptr;
    int64_t acap = 0, asize = 0;
    uint64_t mask;
    int64_t used = 0;  // occupied slots
    ~MIndex() { free(arena); }
    bool init(size_t expected) {
        size_t cap = 64;
        while (cap < expected * 2) cap <<= 1;
        slots.assign(cap, MSlot{0, 0});
        mask = cap - 1;
        return grow((int64_t)(expected * 5 + 64));
    }
    // false when realloc fails: the old block stays (the destructor
    // frees it) and the caller stops
    bool grow(int64_t need) {
        if (need <= acap) return true;
        int64_t nc = acap * 2 > need ? acap * 2 : need;
        MEntry* p = (MEntry*)realloc(arena, (size_t)nc * sizeof(MEntry));
        if (!p) return false;
        arena = p;
        acap = nc;
        return true;
    }
    // Room for `add` more keys at a load of at most 1/2 (linear probing
    // has no fullness check: a full table spins). Otherwise rehash into a
    // table of twice the size, or more: each occupied slot's (key, bc)
    // moves to its home under the new mask. The arena does not move, so
    // every key keeps its candidates in their order.
    void reserve(int64_t add) {
        size_t cap = (size_t)mask + 1;
        size_t need = (size_t)(used + add) * 2;
        if (need <= cap) return;
        while (cap < need) cap <<= 1;
        std::vector<MSlot> old(cap, MSlot{0, 0});
        old.swap(slots);
        mask = cap - 1;
        for (const MSlot& s : old) {
            if (s.bc == 0) continue;
            uint64_t i = home(s.key, mask);
            while (slots[i].bc != 0) i = (i + 1) & mask;
            slots[i] = s;
        }
    }
    static inline uint64_t home(uint32_t key, uint64_t mask_) {
        return (mix64(key) >> 3) & mask_;
    }
    static inline int64_t block(uint32_t bc) {
        return (int64_t)(bc >> 5) * MUNIT;
    }
    // find starting from the precomputed home slot (callers prefetch it)
    const MSlot* find_from(uint64_t i, uint32_t key) const {
        for (;;) {
            const MSlot& s = slots[i];
            if (s.bc == 0) return nullptr;
            if (s.key == key) return &s;
            i = (i + 1) & mask;
        }
    }
    // Insert with caller-managed arena allocation: `cur` is a cursor
    // into arena (pre-sized with enough slack for the batch), bumped
    // lock-free so disjoint table regions can insert in parallel. The
    // arena LAYOUT then depends on thread interleaving, but nothing
    // observable does: per-key entry order (the frozen part) is fixed
    // by who inserts the key's entries — one thread per region — and
    // candidate blocks stay contiguous per key. Returns 1 when the key
    // took a free slot, 0 when it had one, -1 (nothing written) when
    // its block would end past MARENA_MAX.
    int insert(uint32_t key, int32_t ref, int32_t pos,
               std::atomic<int64_t>& cur) {
        uint64_t i = home(key, mask);
        for (;;) {
            MSlot& s = slots[i];
            if (s.bc != 0 && s.key == key) {
                int32_t cnt = (int32_t)(s.bc & 31);
                int64_t blk = block(s.bc);
                if (cnt >= MMAXC) return 0;
                if (cnt == 4) {  // grow 4 -> MMAXC, stay contiguous
                    int64_t nb = cur.fetch_add(
                        MMAXC, std::memory_order_relaxed);
                    if (nb + MMAXC > MARENA_MAX) return -1;
                    for (int j = 0; j < 4; j++)
                        arena[nb + j] = arena[blk + j];
                    blk = nb;
                }
                arena[blk + cnt] = MEntry{ref, pos};
                s.bc = ((uint32_t)(blk / MUNIT) << 5)
                       | (uint32_t)(cnt + 1);
                return 0;
            }
            if (s.bc == 0) {
                int64_t b = cur.fetch_add(4, std::memory_order_relaxed);
                if (b + 4 > MARENA_MAX) return -1;
                arena[b] = MEntry{ref, pos};
                s.key = key;
                s.bc = ((uint32_t)(b / MUNIT) << 5) | 1u;
                return 1;
            }
            i = (i + 1) & mask;
        }
    }
};

// zigzag of a 64-bit signed value (matches utils/bits.py)
static inline uint64_t m_zz(int64_t v) {
    return ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
}

// Per-thread open-addressing candidate-dedup set with epoch tagging
// (replaces a linear std::vector scan that went O(c^2) in the candidate
// count — thousands per read on long reads). Membership semantics are
// identical to the scan: first occurrence of a (ref, orient, v) key is
// kept, duplicates skipped, so the scored candidate SET — and therefore
// the frozen (score, ref, -orient, -zz) selection — is unchanged.
struct MSeen {
    std::vector<uint64_t> keys;
    std::vector<uint32_t> epochs;
    uint64_t mask = 0;
    uint32_t epoch = 0;
    void begin(size_t expected) {
        size_t cap = 64;
        while (cap < expected * 2) cap <<= 1;
        if (cap > keys.size()) {
            keys.assign(cap, 0);
            epochs.assign(cap, 0);
            epoch = 0;
        }
        mask = (uint64_t)keys.size() - 1;
        if (++epoch == 0) {  // epoch wrap: clear tags once
            std::fill(epochs.begin(), epochs.end(), 0);
            epoch = 1;
        }
    }
    // returns true if key was newly inserted (not seen this epoch)
    bool add(uint64_t key) {
        uint64_t i = mix64(key) & mask;
        for (;;) {
            if (epochs[i] != epoch) {
                epochs[i] = epoch;
                keys[i] = key;
                return true;
            }
            if (keys[i] == key) return false;
            i = (i + 1) & mask;
        }
    }
};

// Mismatch count over [0, len) with floor-based early abort. Returns -1
// when the score upper bound span - MPEN*mm falls strictly below
// floor_s at a checkpoint — such a candidate's FINAL score is also
// below floor_s (mm only grows), so it can neither be accepted nor win
// a tie-break; the checkpoint schedule therefore cannot change the
// frozen selection (the scalar path checks every 16 bases, the AVX2
// path every 32).
static inline int64_t m_score_mm(const uint8_t* a, const uint8_t* b,
                                 int64_t len, int64_t span,
                                 int64_t floor_s) {
    int64_t mm = 0, i = 0;
#ifdef __AVX2__
    for (; i + 32 <= len; i += 32) {
        __m256i va = _mm256_loadu_si256((const __m256i*)(a + i));
        __m256i vb = _mm256_loadu_si256((const __m256i*)(b + i));
        uint32_t eq = (uint32_t)_mm256_movemask_epi8(
            _mm256_cmpeq_epi8(va, vb));
        mm += 32 - __builtin_popcount(eq);
        if (span - MPEN * mm < floor_s) return -1;
    }
#else
    for (; i + 16 <= len; i += 16) {
        for (int64_t j = 0; j < 16; j++) mm += a[i + j] != b[i + j];
        if (span - MPEN * mm < floor_s) return -1;
    }
#endif
    for (; i < len; i++) mm += a[i] != b[i];
    return mm;
}

// match_find's failures (it returns the matched count, >= 0, otherwise)
static const int64_t MF_ARENA_ALLOC = -1;   // the candidate arena's realloc
static const int64_t MF_ARENA_FIELD = -2;   // the arena passes MARENA_MAX
static const int64_t MF_BAD_ALLOC = -3;     // another allocation

static int64_t match_find_impl(const uint8_t* data, const int64_t* seq_off,
                               const int64_t* seq_len, int64_t n,
                               int64_t min_score, uint64_t smask,
                               int64_t* out_ref, uint8_t* out_orient,
                               int64_t* out_v, int64_t* out_score) {
    m_b2c0_init();
    // SFQ_MATCH_STATS=1: phase wall-time breakdown to stderr (probe tool
    // for the round-5 "put the matcher on the TPU or make it cheap" work)
    const bool mstats = std::getenv("SFQ_MATCH_STATS") != nullptr;
    double t_arena = 0, t_sample = 0, t_query = 0, t_insert = 0;
    int64_t n_probe = 0, n_cand = 0, n_scored = 0;
    auto now = [] { return std::chrono::duration<double>(
        std::chrono::steady_clock::now().time_since_epoch()).count(); };
    double t0 = now();
    // codes arena (B2C0-mapped bases, record-major)
    std::vector<int64_t> starts(n + 1, 0);
    for (int64_t r = 0; r < n; r++) starts[r + 1] = starts[r] + seq_len[r];
    std::vector<uint8_t> arena((size_t)starts[n]);
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n; r++) {
        const uint8_t* s = data + seq_off[r];
        uint8_t* d = arena.data() + starts[r];
        for (int64_t i = 0; i < seq_len[r]; i++) d[i] = M_B2C0[s[i]];
    }
    int64_t total_kmers = 0;
    for (int64_t r = 0; r < n; r++)
        if (seq_len[r] >= MK) total_kmers += seq_len[r] - MK + 1;
    MIndex index;
    if (!index.init((size_t)(total_kmers / (smask + 1) + 64)))
        return MF_ARENA_ALLOC;
    t_arena = now() - t0;

    for (int64_t r = 0; r < n; r++) out_ref[r] = -1;
    int64_t matched = 0;

    const uint64_t kmask = (1ULL << (2 * MK)) - 1;
    // per-chunk scratch, hoisted so vector capacities persist across
    // chunks (the per-chunk alloc churn was a measured serial cost).
    // kmers are 2*MK = 32 bits, stored as u32 (see MSlot).
    std::vector<std::vector<std::pair<int32_t, uint32_t>>> samp(
        (size_t)(MCHUNK < n ? MCHUNK : n));
    struct MIns { uint32_t key; int32_t ref; int32_t pos; };
    std::vector<MIns> ins, ins2;
    for (int64_t g_lo = 0; g_lo < n; g_lo += MCHUNK) {
        int64_t g_hi = g_lo + MCHUNK < n ? g_lo + MCHUNK : n;
        // sampled forward kmers of this chunk, hashed ONCE in parallel
        // and reused by both the orient-0 query walk and the serial
        // index insert below (the serial section shrinks to pure table
        // writes; same positions, same order)
        t0 = now();
        for (int64_t r = g_lo; r < g_hi; r++)
            samp[(size_t)(r - g_lo)].clear();
#pragma omp parallel for schedule(static)
        for (int64_t r = g_lo; r < g_hi; r++) {
            const uint8_t* c = arena.data() + starts[r];
            int64_t L = seq_len[r];
            if (L < MK) continue;
            auto& sv = samp[(size_t)(r - g_lo)];
            uint64_t acc = 0;
            for (int j = 0; j < MK; j++) acc = (acc << 2) | c[j];
            for (int64_t p = 0; p <= L - MK; p++) {
                if (p) acc = ((acc << 2) | c[p + MK - 1]) & kmask;
                if ((mix64(acc) & smask) == 0)
                    sv.emplace_back((int32_t)p, (uint32_t)acc);
            }
        }
        t_sample += now() - t0;
        t0 = now();
        if (g_lo) {
#pragma omp parallel
            {
                std::vector<uint8_t> rc;
                std::vector<std::pair<int32_t, uint32_t>> rcs;
                std::vector<uint64_t> homes;
                std::vector<const MSlot*> slotp;
                MSeen seen;
                int64_t l_probe = 0, l_cand = 0, l_scored = 0;
#pragma omp for schedule(dynamic, 16)
                for (int64_t r = g_lo; r < g_hi; r++) {
                    const uint8_t* c = arena.data() + starts[r];
                    int64_t L = seq_len[r];
                    if (L < MK) continue;
                    rc.resize((size_t)L);
                    for (int64_t i = 0; i < L; i++)
                        rc[i] = (uint8_t)(3 - c[L - 1 - i]);
                    const auto& sv = samp[(size_t)(r - g_lo)];
                    // orient-1 sampled list, computed up front so the
                    // dedup set can be sized by the ACTUAL probe count
                    // (content-keyed sampling means low-complexity reads
                    // — e.g. poly-A, whose kmer 0 is always sampled —
                    // can sample every position, far above the 1/8
                    // expectation; an undersized open-addressing table
                    // has no fullness check and would spin forever)
                    rcs.clear();
                    {
                        const uint8_t* arr = rc.data();
                        uint64_t acc = 0;
                        for (int j = 0; j < MK; j++)
                            acc = (acc << 2) | arr[j];
                        for (int64_t p = 0; p <= L - MK; p++) {
                            if (p) acc = ((acc << 2) | arr[p + MK - 1])
                                       & kmask;
                            if ((mix64(acc) & smask) == 0)
                                rcs.emplace_back((int32_t)p,
                                                 (uint32_t)acc);
                        }
                    }
                    // exact worst case: every probe walks a full MMAXC
                    // chain of distinct keys; begin() doubles this, so
                    // load factor stays <= 0.5 and add() cannot spin
                    seen.begin((sv.size() + rcs.size()) * MMAXC + 1);
                    // best = (score, ref, -orient, -zz) maximised
                    int64_t b_score = min_score - 1, b_ref = -1,
                            b_v = 0;
                    int b_orient = 0;
                    uint64_t b_zz = 0;
                    bool have = false;
                    auto probe = [&](const MSlot* slot, int64_t p,
                                     int orient, const uint8_t* arr) {
                        const MEntry* blk =
                            index.arena + MIndex::block(slot->bc);
                        int32_t cnt = (int32_t)(slot->bc & 31);
                        // Chain refs are non-decreasing (inserted chunk
                        // by chunk in record order), so walk BACKWARD:
                        // once best holds the maximum possible score L,
                        // every remaining entry with ref < b_ref can
                        // neither beat it (score <= span <= L) nor win
                        // the (score, ref, ...) tie-break — break out.
                        // Same-ref entries are still evaluated (orient/
                        // shift tie-breaks), and chain direction cannot
                        // change the frozen selection: a candidate key
                        // fully determines its span and score, so the
                        // evaluated key SET and per-key scores are
                        // direction-independent.
                        for (int32_t j = cnt - 1; j >= 0; j--) {
                            const MEntry en = blk[j];
                            l_cand++;
                            if (b_score == L && en.ref < b_ref) break;
                            int64_t v = (int64_t)en.pos - p;
                            int64_t lref = seq_len[en.ref];
                            int64_t lo = v < 0 ? -v : 0;
                            int64_t hi = L < lref - v ? L : lref - v;
                            if (hi - lo < MK) continue;
                            int64_t floor_s = b_score > min_score
                                ? b_score : min_score;
                            int64_t span = hi - lo;
                            // span < floor: the candidate's score can
                            // neither reach min_score nor beat OR TIE
                            // best — skip without touching ref memory
                            if (span < floor_s) continue;
                            // dedup only candidates that survive the
                            // arithmetic pruning: span and the floor
                            // monotonicity (floor only rises) make the
                            // pruning deterministic per candidate key,
                            // so the SCORED set — and the selection —
                            // are unchanged; the dedup set just stops
                            // paying for candidates arithmetic kills
                            uint64_t key = ((uint64_t)en.ref << 34) |
                                           ((uint64_t)orient << 33) |
                                           m_zz(v);
                            if (!seen.add(key)) continue;
                            const uint8_t* cr =
                                arena.data() + starts[en.ref];
                            l_scored++;
                            int64_t mm = m_score_mm(
                                arr + lo, cr + lo + v, span, span,
                                floor_s);
                            if (mm < 0) continue;
                            int64_t score = span - MPEN * mm;
                            if (score < min_score) continue;
                            uint64_t zz = m_zz(v);
                            bool better;
                            if (!have) better = true;
                            else if (score != b_score)
                                better = score > b_score;
                            else if (en.ref != b_ref)
                                better = en.ref > b_ref;
                            else if (orient != b_orient)
                                better = orient < b_orient;
                            else better = zz < b_zz;
                            if (better) {
                                have = true;
                                b_score = score;
                                b_ref = en.ref;
                                b_orient = orient;
                                b_v = v;
                                b_zz = zz;
                            }
                        }
                    };
                    // Two-sweep probe (round 5): sweep A computes every
                    // probe's home slot up front (prefetching the slot
                    // lines), resolves the slots, and prefetches each
                    // found slot's contiguous chain block; sweep B then
                    // walks chains over warm lines. Probe order (fwd
                    // samples then rc samples) and the early-break
                    // semantics are unchanged, so the candidate sets
                    // and the frozen selection are bit-identical — this
                    // only re-schedules the cache misses the old
                    // 1-ahead prefetch could not hide.
                    size_t npr = sv.size() + rcs.size();
                    homes.resize(npr);
                    slotp.resize(npr);
                    for (size_t i = 0; i < npr; i++) {
                        uint32_t key = i < sv.size()
                            ? sv[i].second : rcs[i - sv.size()].second;
                        homes[i] = MIndex::home(key, index.mask);
                        __builtin_prefetch(&index.slots[homes[i]]);
                    }
                    for (size_t i = 0; i < npr; i++) {
                        uint32_t key = i < sv.size()
                            ? sv[i].second : rcs[i - sv.size()].second;
                        const MSlot* s = index.find_from(homes[i], key);
                        slotp[i] = s;
                        if (s) {
                            const MEntry* b = index.arena
                                + MIndex::block(s->bc);
                            __builtin_prefetch(b);
                            if ((s->bc & 31) > 8)
                                __builtin_prefetch(b + 8);
                        }
                    }
                    for (size_t i = 0; i < npr; i++) {
                        l_probe++;
                        if (!slotp[i]) continue;
                        if (i < sv.size())
                            probe(slotp[i], (int64_t)sv[i].first, 0, c);
                        else
                            probe(slotp[i],
                                  (int64_t)rcs[i - sv.size()].first, 1,
                                  rc.data());
                    }
                    if (have) {
                        out_ref[r] = b_ref;
                        out_orient[r] = (uint8_t)b_orient;
                        out_v[r] = b_v;
                        out_score[r] = b_score;
                    }
                }
#pragma omp atomic
                n_probe += l_probe;
#pragma omp atomic
                n_cand += l_cand;
#pragma omp atomic
                n_scored += l_scored;
            }
            for (int64_t r = g_lo; r < g_hi; r++)
                matched += out_ref[r] >= 0;
        }
        t_query += now() - t0;
        t0 = now();
        // index this chunk's precomputed kmers (serial: insertion order
        // is part of the frozen selection rule). Inserts of DIFFERENT
        // keys commute, so a stable radix partition by table region
        // (same key -> same bucket, per-key order preserved) turns the
        // random big-table writes into 256 cache-resident passes.
        ins.clear();
        for (int64_t r = g_lo; r < g_hi; r++)
            for (const auto& pk : samp[(size_t)(r - g_lo)])
                ins.push_back(MIns{pk.second, (int32_t)r, pk.first});
        // each insert takes at most one free slot: the table is grown
        // first if they could pass half of it (homes and tbits below
        // come from the mask it then has)
        index.reserve((int64_t)ins.size());
        int tbits = 0;
        while ((index.mask >> tbits) >= 256) tbits++;
        uint32_t bcount[257] = {0};
        for (const MIns& e : ins)
            bcount[(((mix64(e.key) >> 3) & index.mask) >> tbits) + 1]++;
        for (int b = 0; b < 256; b++) bcount[b + 1] += bcount[b];
        ins2.resize(ins.size());
        for (const MIns& e : ins)
            ins2[bcount[((mix64(e.key) >> 3) & index.mask) >> tbits]++]
                = e;
        // Parallel insert (round 5): the radix buckets are disjoint
        // table regions, processed even-indexed then odd-indexed so a
        // linear-probe run spilling past a region edge (load <= 0.5,
        // kept by reserve(), keeps runs to a few dozen slots) can never
        // reach a concurrently-active region. The frozen per-key entry
        // order is preserved: a key's inserts all land in its home
        // bucket (stable partition) and one thread owns a bucket.
        // Tables whose regions hold fewer than 1,024 slots (too small
        // for the spill argument) take the serial path.
        // NB: `arena` in this scope is the CODES arena; the candidate
        // arena is index.arena (sized here with worst-case slack for
        // this chunk: one allocation of <= 16 entries per insert, never
        // past MARENA_MAX, then trimmed to the cursor)
        std::atomic<int64_t> acur(index.asize);
        int64_t need = index.asize + 16 * (int64_t)ins2.size();
        if (!index.grow(need < MARENA_MAX ? need : MARENA_MAX))
            return MF_ARENA_ALLOC;
        int64_t added = 0;
        int past = 0;
        if (index.mask + 1 >= ((uint64_t)1 << 18)) {
#pragma omp parallel reduction(+ : added) reduction(| : past)
            for (int phase = 0; phase < 2; phase++) {
                // one parallel region, two worksharing loops: the
                // implicit barrier after each `omp for` separates the
                // phases without respawning the team per phase
#pragma omp for schedule(dynamic, 4)
                for (int b = phase; b < 256; b += 2) {
                    size_t lo_i = b ? bcount[b - 1] : 0;
                    size_t hi_i = bcount[b];
                    for (size_t i = lo_i; i < hi_i; i++) {
                        if (i + 8 < hi_i)
                            __builtin_prefetch(&index.slots[
                                (mix64(ins2[i + 8].key) >> 3)
                                & index.mask], 1);
                        int k = index.insert(ins2[i].key, ins2[i].ref,
                                             ins2[i].pos, acur);
                        if (k < 0) past = 1;
                        else added += k;
                    }
                }
            }
        } else {
            for (size_t i = 0; i < ins2.size(); i++) {
                int k = index.insert(ins2[i].key, ins2[i].ref,
                                     ins2[i].pos, acur);
                if (k < 0) past = 1;
                else added += k;
            }
        }
        if (past) return MF_ARENA_FIELD;
        index.used += added;
        index.asize = acur.load();
        t_insert += now() - t0;
    }
    if (mstats)
        fprintf(stderr,
                "match_find: arena %.1fms sample %.1fms query %.1fms "
                "insert %.1fms | probes %lld cand-walks %lld scored %lld "
                "matched %lld\n",
                t_arena * 1e3, t_sample * 1e3, t_query * 1e3,
                t_insert * 1e3, (long long)n_probe, (long long)n_cand,
                (long long)n_scored, (long long)matched);
    return matched;
}

extern "C" {

// Best match per read. Outputs ref=-1 when no candidate reaches
// min_score. Deterministic and OpenMP-safe (queries are read-only per
// chunk; insertion is serial between chunks). A position is sampled iff
// mix64(kmer) & sample_mask == 0. Returns the matched count, or a
// negative MF_* code when an allocation fails or the candidate arena
// would pass what a slot's block field holds.
int64_t match_find(const uint8_t* data, const int64_t* seq_off,
                   const int64_t* seq_len, int64_t n, int64_t min_score,
                   int64_t sample_mask, int64_t* out_ref,
                   uint8_t* out_orient, int64_t* out_v, int64_t* out_score) {
    try {
        return match_find_impl(data, seq_off, seq_len, n, min_score,
                               (uint64_t)sample_mask, out_ref, out_orient,
                               out_v, out_score);
    } catch (const std::bad_alloc&) {
        return MF_BAD_ALLOC;
    }
}

// Emit the per-aux-lane MATCH descriptor streams (frozen v5 layout —
// byte-identical to models/matcher.py encode_match_lanes, pinned by
// tests): per accepted read r (ref >= 0 and score >= min_score), lane
// w = r % wa receives varint(ordinal - prev_ord), varint(r - ref),
// varint(zigzag(v) << 1 | orient). Outputs land in arena_out[w * stride
// ..] with per-lane sizes; returns -1 if any lane would overflow its
// stride (callers size stride at 30 bytes per lane record, the varint
// worst case, so this cannot fire in practice).
int64_t match_encode_lanes(const int64_t* refs, const uint8_t* orients,
                           const int64_t* vs, const int64_t* scores,
                           int64_t n, int64_t min_score, int64_t wa,
                           uint8_t* arena_out, int64_t stride,
                           int64_t* sizes) {
    std::vector<int64_t> prev((size_t)wa, -1);
    for (int64_t w = 0; w < wa; w++) sizes[w] = 0;
    for (int64_t r = 0; r < n; r++) {
        if (refs[r] < 0 || scores[r] < min_score) continue;
        int64_t w = r % wa;
        if (stride - sizes[w] < 30) return -1;
        uint8_t* dst = arena_out + w * stride + sizes[w];
        int64_t ordinal = r / wa;
        int64_t k = 0;
        k += put_varint_raw(dst + k, (uint64_t)(ordinal - prev[w]));
        k += put_varint_raw(dst + k, (uint64_t)(r - refs[r]));
        k += put_varint_raw(dst + k, (m_zz(vs[r]) << 1)
                                     | (uint64_t)orients[r]);
        sizes[w] += k;
        prev[w] = ordinal;
    }
    return 0;
}

// Build the [S, W] match-span flag matrix (seq_mflag) directly from
// match spans — the fused replacement for the numpy
// span-diff/cumsum/pack_lanes chain, which cost ~60-80 ms per 64k
// block inside the pipeline (np.add.at + a 6.5M-element cumsum + a
// full lane re-pack, three times per L4 block). Writes a [W, S]
// row-major temp (each match's span is contiguous per lane) that the
// caller transposes with transpose_mat — bit-identical to
// pack_lanes(span_flags_flat(...)). Lane layout: record r -> lane
// r % W, at the lane-local step offset given by the cumulative lengths
// of records r % W, r % W + W, ... < r (same rule as pack_lanes).
void match_mflag(const int64_t* recs, const int64_t* los,
                 const int64_t* his, int64_t m, const int64_t* lengths,
                 int64_t n, int64_t W, int64_t S, uint8_t* matT) {
    memset(matT, 0, (size_t)(W * S));
    std::vector<int64_t> sb((size_t)n);
#pragma omp parallel for schedule(static)
    for (int64_t w = 0; w < W; w++) {
        int64_t step = 0;
        for (int64_t r = w; r < n; r += W) {
            sb[r] = step;
            step += lengths[r];
        }
    }
#pragma omp parallel for schedule(static, 1024)
    for (int64_t i = 0; i < m; i++) {
        int64_t r = recs[i];
        int64_t lo = los[i], hi = his[i];
        if (hi <= lo) continue;
        uint8_t* row = matT + (r % W) * S + sb[r];
        memset(row + lo, 1, (size_t)(hi - lo));
    }
}

// e-transform rewrite: letters over matched spans become
// C2B[(B2C0[read] - pred) & 3]. Refs are read from the unmodified src.
void match_apply(uint8_t* dst, const uint8_t* src, const int64_t* seq_off,
                 const int64_t* seq_len, int64_t n, const int64_t* refs,
                 const uint8_t* orients, const int64_t* vs,
                 const int64_t* scores, int64_t min_score) {
    m_b2c0_init();
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t r = 0; r < n; r++) {
        if (refs[r] < 0 || scores[r] < min_score) continue;
        int64_t ref = refs[r], v = vs[r];
        int orient = orients[r];
        int64_t L = seq_len[r], lref = seq_len[ref];
        const uint8_t* s = src + seq_off[r];
        const uint8_t* sr = src + seq_off[ref];
        uint8_t* d = dst + seq_off[r];
        int64_t lo, hi;
        if (orient == 0) {
            lo = v < 0 ? -v : 0;
            hi = L < lref - v ? L : lref - v;
            for (int64_t i = lo; i < hi; i++)
                d[i] = M_C2B[(M_B2C0[s[i]] - M_B2C0[sr[i + v]]) & 3];
        } else {
            lo = L + v - lref > 0 ? L + v - lref : 0;
            hi = L < L + v ? L : L + v;
            for (int64_t i = lo; i < hi; i++)
                d[i] = M_C2B[(M_B2C0[s[i]]
                              - (3 - M_B2C0[sr[L - 1 + v - i]])) & 3];
        }
    }
}

// Parse the per-aux-lane MATCH descriptor streams into record-sorted
// arrays (cap n entries: at most one descriptor per record). Returns the
// descriptor count, or -1 on a corrupt stream.
int64_t match_parse(const uint8_t* const* lane_bufs,
                    const int64_t* lane_sizes, int64_t wa, int64_t n,
                    int64_t* out_rec, int64_t* out_ref,
                    uint8_t* out_orient, int64_t* out_v) {
    struct Desc { int64_t r, ref, v; int orient; };
    std::vector<Desc> ds;
    for (int64_t w = 0; w < wa; w++) {
        int64_t pos = 0, ordinal = -1;
        while (pos < lane_sizes[w]) {
            uint64_t d, rd, tok;
            if (!get_varint(lane_bufs[w], lane_sizes[w], pos, d) ||
                !get_varint(lane_bufs[w], lane_sizes[w], pos, rd) ||
                !get_varint(lane_bufs[w], lane_sizes[w], pos, tok))
                return -1;
            ordinal += (int64_t)d;
            int64_t r = w + ordinal * wa;
            if (r < 0 || r >= n || rd == 0 || (int64_t)rd > r) return -1;
            if ((int64_t)ds.size() >= n) return -1;
            uint64_t zz = tok >> 1;
            int64_t v = (zz & 1) ? -(int64_t)((zz + 1) >> 1)
                                 : (int64_t)(zz >> 1);
            ds.push_back(Desc{r, r - (int64_t)rd, v, (int)(tok & 1)});
        }
    }
    std::sort(ds.begin(), ds.end(),
              [](const Desc& a, const Desc& b) { return a.r < b.r; });
    for (size_t i = 0; i < ds.size(); i++) {
        out_rec[i] = ds[i].r;
        out_ref[i] = ds[i].ref;
        out_orient[i] = (uint8_t)ds[i].orient;
        out_v[i] = ds[i].v;
    }
    return (int64_t)ds.size();
}

// Undo the e-transform in record order, in place, from parsed
// (record-sorted) descriptor arrays.
void match_reconstruct_arrays(uint8_t* seq, const int64_t* rec_starts,
                              const int64_t* lens, const int64_t* recs,
                              const int64_t* refs, const uint8_t* orients,
                              const int64_t* vs, int64_t m) {
    m_b2c0_init();
    for (int64_t i = 0; i < m; i++) {
        int64_t r = recs[i], ref = refs[i], v = vs[i];
        int64_t L = lens[r], lref = lens[ref];
        uint8_t* s = seq + rec_starts[r];
        const uint8_t* sr = seq + rec_starts[ref];
        int64_t lo, hi;
        if (orients[i] == 0) {
            lo = v < 0 ? -v : 0;
            hi = L < lref - v ? L : lref - v;
            for (int64_t j = lo; j < hi; j++)
                s[j] = M_C2B[(M_B2C0[s[j]] + M_B2C0[sr[j + v]]) & 3];
        } else {
            lo = L + v - lref > 0 ? L + v - lref : 0;
            hi = L < L + v ? L : L + v;
            for (int64_t j = lo; j < hi; j++)
                s[j] = M_C2B[(M_B2C0[s[j]]
                              + (3 - M_B2C0[sr[L - 1 + v - j]])) & 3];
        }
    }
}

}  // extern "C"

