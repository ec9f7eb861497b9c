// mwfrt — native host runtime kernels for miniwfa_tpu.
//
// The device runs the O(n·s) wavefront; these are the O(n+s) *sequential*
// host decoders that are pointer-chases by nature (no vector parallelism
// to exploit) and would be Python-slow at 5 Mb scale:
//
//   * mwf_traceback — walk the 7-bit packed traceback rows into a packed
//     CIGAR (semantics: reference wf_traceback, miniwfa.c:329-377; our row
//     layout: row r ↔ score r+1, column = (i-k) - tb_lo[r] + m1).
//   * mwf_lis_u64 — longest strictly-increasing subsequence over uint64
//     keys (patience sort with binary search; reference mg_lis_64
//     semantics, miniwfa.c:678-697) for the k-mer chaining mode.
//
// Build: make -C native   (g++ -O3 -shared -fPIC)
// Python bridge: miniwfa_tpu/utils/native.py (ctypes); pure-Python
// fallbacks exist for both entry points.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Append one CIGAR run, merging equal ops. Returns new length or -1 on
// overflow of the output buffer.
static int64_t cig_push(uint32_t *out, int64_t n, int64_t cap, uint32_t op,
                        uint32_t len) {
    if (len == 0) return n;
    if (n > 0 && (out[n - 1] & 0xf) == op) {
        out[n - 1] += len << 4;
        return n;
    }
    if (n >= cap) return -1;
    out[n] = len << 4 | op;
    return n + 1;
}

int64_t mwf_traceback(const uint8_t *tb_bits, int64_t W, const int32_t *tb_lo,
                      int32_t m1, const char *ts, int64_t tl, const char *qs,
                      int64_t ql, int32_t s_final, int32_t last_state,
                      int32_t x_pen, int32_t o1, int32_t e1, int32_t o2,
                      int32_t e2, uint32_t *out, int64_t cap) {
    int64_t i = ql - 1, k = tl - 1;
    int64_t srow = (int64_t)s_final - 1;
    int32_t last = last_state;
    int64_t n = 0;
    while (i >= 0 && k >= 0) {
        if (last == 0) {
            int64_t k0 = k;
            while (i >= 0 && k >= 0 && qs[i] == ts[k]) --i, --k;
            if (k0 - k > 0) n = cig_push(out, n, cap, 7, (uint32_t)(k0 - k));
            if (n < 0) return -1;
            if (i < 0 || k < 0) break;
        }
        if (srow < 0) return -2;  // walked past score 0: corrupt input
        int64_t col = (i - k) - (int64_t)tb_lo[srow] + m1;
        if (col < 0 || col >= W) return -3;
        uint8_t xb = tb_bits[srow * W + col];
        int32_t state = last == 0 ? (xb & 7) : last;
        int32_t ext = state > 0 ? (xb >> (state + 2)) & 1 : 0;
        switch (state) {
            case 0: n = cig_push(out, n, cap, 8, 1); --i; --k; srow -= x_pen; break;
            case 1: n = cig_push(out, n, cap, 1, 1); --i; srow -= ext ? e1 : o1 + e1; break;
            case 3: n = cig_push(out, n, cap, 1, 1); --i; srow -= ext ? e2 : o2 + e2; break;
            case 2: n = cig_push(out, n, cap, 2, 1); --k; srow -= ext ? e1 : o1 + e1; break;
            case 4: n = cig_push(out, n, cap, 2, 1); --k; srow -= ext ? e2 : o2 + e2; break;
            default: return -4;
        }
        if (n < 0) return -1;
        last = (state > 0 && ext) ? state : 0;
    }
    if (i >= 0) n = cig_push(out, n, cap, 1, (uint32_t)(i + 1));
    else if (k >= 0) n = cig_push(out, n, cap, 2, (uint32_t)(k + 1));
    if (n < 0) return -1;
    for (int64_t a = 0, b = n - 1; a < b; ++a, --b) {  // reverse to input order
        uint32_t t = out[a];
        out[a] = out[b];
        out[b] = t;
    }
    return n;
}

// Longest strictly-increasing subsequence; writes selected indices to out,
// returns its length.
int64_t mwf_lis_u64(int64_t n, const uint64_t *a, int64_t *out) {
    if (n <= 0) return 0;
    std::vector<int64_t> M(n + 1), P(n);
    int64_t L = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t lo = 1, hi = L;
        while (lo <= hi) {
            int64_t mid = (lo + hi + 1) >> 1;
            if (a[M[mid]] < a[i]) lo = mid + 1;
            else hi = mid - 1;
        }
        P[i] = M[lo - 1];
        M[lo] = i;
        if (lo > L) L = lo;
    }
    int64_t k = M[L];
    for (int64_t j = L - 1; j >= 0; --j) {
        out[j] = k;
        k = P[k];
    }
    return L;
}

// ---- k-mer anchoring (host side of the chaining heuristic) ----------
//
// Semantics: reference mg_fc_kmer + the match-pair half of mg_chain
// (miniwfa.c:699-765): 2-bit rolling k-mers (A0 C1 G2 T3, anything else
// resets the window), combined code (kmer<<1|rid)<<32|end_pos, groups
// with 1 <= occ <= max_occ PER SIDE emit the cross product
// pos_t<<32|pos_q.  numpy does this in ~25 s at 5 Mb on one core (the
// k-wide shift loop and the group bookkeeping each make full passes
// over 10M-element arrays); this single-pass C++ runs it in well under
// a second, which is what makes chain/auto mode competitive with the
// reference at Mb scale.

static const uint8_t NT4[256] = {
    // A=0 C=1 G=2 T/U=3, else 4 (reference seq_nt4_table)
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,0,4,1,4,4,4,2,4,4,4,4,4,4,4,4, 4,4,4,4,3,3,4,4,4,4,4,4,4,4,4,4,
    4,0,4,1,4,4,4,2,4,4,4,4,4,4,4,4, 4,4,4,4,3,3,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
};

static int64_t emit_codes(const char *s, int64_t n, uint32_t rid, int32_t k,
                          uint64_t *out) {
    uint64_t x = 0, mask = (k < 32) ? ((1ull << (2 * k)) - 1) : ~0ull;
    int32_t l = 0;
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint8_t c = NT4[(uint8_t)s[i]];
        if (c < 4) {
            x = ((x << 2) | c) & mask;
            if (++l >= k)
                out[m++] = ((x << 1 | rid) << 32) | (uint64_t)(uint32_t)i;
        } else {
            l = 0;
        }
    }
    return m;
}

// LSB radix sort of uint64 keys, 8-bit digits (textbook counting sort
// per byte; stable).  ~6x faster than std::sort at the 10M scale the
// 5 Mb pairs produce.
static void radix_sort_u64(uint64_t *a, int64_t n, uint64_t *tmp) {
    uint64_t *orig = a;
    for (int pass = 0; pass < 8; ++pass) {
        int64_t cnt[257] = {0};
        int sh = pass * 8;
        for (int64_t i = 0; i < n; ++i) ++cnt[((a[i] >> sh) & 0xff) + 1];
        if (cnt[1] == n) continue;  // all-zero digit: pass is identity
        for (int i = 0; i < 256; ++i) cnt[i + 1] += cnt[i];
        for (int64_t i = 0; i < n; ++i) tmp[cnt[(a[i] >> sh) & 0xff]++] = a[i];
        uint64_t *t = a;  // ping-pong
        a = tmp;
        tmp = t;
    }
    if (a != orig) memcpy(orig, a, (size_t)n * sizeof(uint64_t));
}

// kmer codes of one sequence; out must hold n entries.  Returns count.
int64_t mwf_kmer_codes(const char *s, int64_t n, uint32_t rid, int32_t k,
                       uint64_t *out) {
    return emit_codes(s, n, rid, k, out);
}

// Sorted match pairs pos_t<<32|pos_q for k-mers in both sequences with
// per-side occurrence <= max_occ.  scratch must hold 2*(tn+qn) uint64;
// out holds cap entries.  Returns pair count, or -1 if cap exceeded.
int64_t mwf_match_pairs(const char *ts, int64_t tn, const char *qs,
                        int64_t qn, int32_t k, int32_t max_occ,
                        uint64_t *scratch, uint64_t *out, int64_t cap) {
    uint64_t *a = scratch;
    int64_t n = emit_codes(ts, tn, 0, k, a);
    n += emit_codes(qs, qn, 1, k, a + n);
    uint64_t *tmp = scratch + (tn + qn);
    // 8 passes ping-pong a <-> tmp and end back in a (even count)
    radix_sort_u64(a, n, tmp);
    int64_t m = 0;
    for (int64_t g = 0; g < n;) {
        uint64_t key = a[g] >> 33;
        int64_t h = g;
        while (h < n && (a[h] >> 33) == key) ++h;
        // rid=0 entries sort before rid=1 within a group (rid bit above pos)
        int64_t mid = g;
        while (mid < h && ((a[mid] >> 32) & 1) == 0) ++mid;
        int64_t n0 = mid - g, n1 = h - mid;
        if (n0 >= 1 && n1 >= 1 && n0 <= max_occ && n1 <= max_occ) {
            for (int64_t u = g; u < mid; ++u)
                for (int64_t v = mid; v < h; ++v) {
                    if (m >= cap) return -1;
                    out[m++] = ((a[u] & 0xffffffffull) << 32) |
                               (a[v] & 0xffffffffull);
                }
        }
        g = h;
    }
    if (m <= 2 * (tn + qn))   // scratch doubles as the radix tmp buffer
        radix_sort_u64(out, m, scratch);
    else                      // only reachable at max_occ > 2
        std::sort(out, out + m);
    return m;
}

}  // extern "C"
