// grootio: native host-IO runtime for groot_tpu.
//
// The reference's data loader is compiled Go (bufio scanners feeding
// channels, /root/reference/src/pipeline/sketch.go:41-238). Python-level
// line loops cap ingest well below device align throughput, so the hot host
// paths live here:
//
//   gio_parse_fastq  - scan a FASTQ buffer into per-record offsets
//   gio_encode       - 2-bit-class encode sequences into a padded uint8
//                      code matrix (A=0 C=1 G=2 T=3, everything else N=4),
//                      the device's expected layout
//   gio_bgzf_block   - deflate one BGZF block (BAM output)
//   gio_revcomp      - reverse-complement in the code alphabet
//
// Exposed as a C ABI consumed via ctypes (groot_tpu/io/native.py); built by
// native/Makefile (g++ -O3 -shared -fPIC, links zlib).

#include <algorithm>
#include <thread>
#include <cstdint>
#include <cstring>
#include <zlib.h>
#if defined(__AVX512BW__)
#include <immintrin.h>
#endif
#ifdef GIO_HAVE_LIBDEFLATE
#include <libdeflate.h>
#endif

extern "C" {

// ASCII -> code table (A=0 C=1 G=2 T=3, other=4), upper+lower case.
static uint8_t CODE[256];
static bool code_init = false;
static void init_code() {
    if (code_init) return;
    memset(CODE, 4, sizeof(CODE));
    CODE[(unsigned char)'A'] = 0; CODE[(unsigned char)'a'] = 0;
    CODE[(unsigned char)'C'] = 1; CODE[(unsigned char)'c'] = 1;
    CODE[(unsigned char)'G'] = 2; CODE[(unsigned char)'g'] = 2;
    CODE[(unsigned char)'T'] = 3; CODE[(unsigned char)'t'] = 3;
    code_init = true;
}

// Parse up to max_reads FASTQ records from buf[0..n). Records must be
// 4-line (no wrapping), matching the reference's FastqHandler
// (sketch.go:216-236). Returns the number of complete records parsed and
// sets *consumed to the byte offset after the last complete record.
// id/seq/qual arrays receive (offset, length) pairs per record; the id
// INCLUDES the leading '@'. Returns -1 on malformed input (ID line not
// starting with '@').
// Collect newline offsets from buf[*scan_io..n) into nls[0..cap); returns
// the count and advances *scan_io past the last byte examined. AVX-512BW
// hosts compare 64 bytes per iteration (a ~65-byte FASTQ line costs one
// block compare instead of a full memchr call); others fall back to
// memchr per line.
static int gio_scan_newlines(const char* buf, long n, long* scan_io,
                             long* nls, int cap) {
    int cnt = 0;
    long scan = *scan_io;
#if defined(__AVX512BW__)
    const __m512i NL = _mm512_set1_epi8('\n');
    while (cnt <= cap - 64 && scan + 64 <= n) {
        uint64_t m = _mm512_cmpeq_epi8_mask(
            _mm512_loadu_si512((const void*)(buf + scan)), NL);
        while (m) {
            nls[cnt++] = scan + (long)__builtin_ctzll(m);
            m &= m - 1;
        }
        scan += 64;
    }
#endif
    while (cnt < cap && scan < n) {
        const char* nl = (const char*)memchr(buf + scan, '\n', n - scan);
        if (!nl) { scan = n; break; }
        nls[cnt++] = nl - buf;
        scan = (nl - buf) + 1;
    }
    *scan_io = scan;
    return cnt;
}

long gio_parse_fastq(const char* buf, long n, long max_reads,
                     long* id_off, long* id_len,
                     long* seq_off, long* seq_len,
                     long* qual_off, long* qual_len,
                     long* consumed) {
    long count = 0;
    long pos = 0;
    *consumed = 0;
    constexpr int CAPN = 4096;
    long nls[CAPN];  // pending line-end offsets (32KB stack window)
    int nl_cnt = 0, nl_take = 0;
    long scan = 0;  // next unscanned byte
    while (count < max_reads) {
        if (nl_cnt - nl_take < 4) {
            if (nl_take) {  // compact the unconsumed tail
                for (int i = nl_take; i < nl_cnt; i++)
                    nls[i - nl_take] = nls[i];
                nl_cnt -= nl_take;
                nl_take = 0;
            }
            int got =
                gio_scan_newlines(buf, n, &scan, nls + nl_cnt, CAPN - nl_cnt);
            nl_cnt += got;
            if (nl_cnt - nl_take < 4) {
                if (got == 0) break;  // buffer exhausted mid-record
                continue;
            }
        }
        const long l1 = pos, l1e0 = nls[nl_take];
        const long l2 = l1e0 + 1, l2e0 = nls[nl_take + 1];
        const long l4 = nls[nl_take + 2] + 1, l4e0 = nls[nl_take + 3];
        nl_take += 4;
        pos = l4e0 + 1;
        if (buf[l1] != '@') return -1;
        long l1e = l1e0, l2e = l2e0, l4e = l4e0;
        if (l1e > l1 && buf[l1e - 1] == '\r') l1e--;
        if (l2e > l2 && buf[l2e - 1] == '\r') l2e--;
        if (l4e > l4 && buf[l4e - 1] == '\r') l4e--;
        id_off[count] = l1; id_len[count] = l1e - l1;
        seq_off[count] = l2; seq_len[count] = l2e - l2;
        qual_off[count] = l4; qual_len[count] = l4e - l4;
        count++;
        *consumed = pos;
    }
    return count;
}

// Encode n_reads sequences (offsets into buf) into out[n_reads][stride]
// (pre-filled by caller or padded here with 4).
void gio_encode(const char* buf, const long* seq_off, const long* seq_len,
                long n_reads, long stride, uint8_t* out) {
    init_code();
    for (long r = 0; r < n_reads; r++) {
        const char* s = buf + seq_off[r];
        long len = seq_len[r];
        if (len > stride) len = stride;
        uint8_t* row = out + r * stride;
        long i = 0;
        for (; i < len; i++) row[i] = CODE[(unsigned char)s[i]];
        for (; i < stride; i++) row[i] = 4;
    }
}

// Reverse-complement a code-alphabet row in place.
void gio_revcomp(uint8_t* codes, long len) {
    static const uint8_t RC[5] = {3, 2, 1, 0, 4};
    for (long i = 0, j = len - 1; i < j; i++, j--) {
        uint8_t a = codes[i], b = codes[j];
        codes[i] = RC[b];
        codes[j] = RC[a];
    }
    if (len & 1) codes[len / 2] = RC[codes[len / 2]];
}

// Compress one BGZF block (<= 65280 input bytes). Returns the full block
// size written to out (header + deflate + crc/isize footer), or -1.
// libdeflate at level 1: measured 2.8x zlib level 2 on BAM bytes at a
// slightly BETTER ratio (589 vs 208 MB/s, 0.08 vs 0.09); zlib fallback
// keeps the library buildable on hosts without libdeflate.
long gio_bgzf_block(const uint8_t* data, long n, uint8_t* out, long out_cap) {
    if (n > 65280) return -1;
    // header: 18 bytes with BC extra subfield
    uint8_t* hdr = out;
    const uint8_t fixed[16] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0,
                               0, 0xff, 6, 0, 0x42, 0x43, 2, 0};
    memcpy(hdr, fixed, 16);
#ifdef GIO_HAVE_LIBDEFLATE
    static thread_local struct libdeflate_compressor* comp_state = nullptr;
    if (!comp_state) {
        comp_state = libdeflate_alloc_compressor(1);
        if (!comp_state) return -1;
    }
    size_t comp = libdeflate_deflate_compress(
        comp_state, data, (size_t)n, out + 18, (size_t)(out_cap - 18 - 8));
    if (comp == 0) return -1;
    uint32_t crc = libdeflate_crc32(0, data, (size_t)n);
#else
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, 2, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK)
        return -1;
    zs.next_in = (Bytef*)data;
    zs.avail_in = (uInt)n;
    zs.next_out = out + 18;
    zs.avail_out = (uInt)(out_cap - 18 - 8);
    if (deflate(&zs, Z_FINISH) != Z_STREAM_END) {
        deflateEnd(&zs);
        return -1;
    }
    size_t comp = (size_t)zs.total_out;
    deflateEnd(&zs);
    uint32_t crc = crc32(0L, Z_NULL, 0);
    crc = crc32(crc, data, (uInt)n);
#endif
    long bsize = (long)comp + 18 + 8;
    out[16] = (uint8_t)((bsize - 1) & 0xff);
    out[17] = (uint8_t)(((bsize - 1) >> 8) & 0xff);
    uint8_t* foot = out + 18 + comp;
    foot[0] = crc & 0xff; foot[1] = (crc >> 8) & 0xff;
    foot[2] = (crc >> 16) & 0xff; foot[3] = (crc >> 24) & 0xff;
    uint32_t isize = (uint32_t)n;
    foot[4] = isize & 0xff; foot[5] = (isize >> 8) & 0xff;
    foot[6] = (isize >> 16) & 0xff; foot[7] = (isize >> 24) & 0xff;
    return bsize;
}

// ---------------------------------------------------------------------------
// gio_lsh_query_full: the t=0.99 full-equality LSH fast path
// (index/lshe.py query_batch_np): per read, a 32-bit FNV mix of all s
// sketch slots, a bucketed lookup into the sorted full-sketch signature
// table, then exact all-slot verification + the containment bound.
// Emits flat (row, window) hits; returns the count, or -1 if cap is too
// small. sig mix MUST match _mix_bands_np (lshe.py:47-60) op for op.
extern "C" long gio_lsh_query_full32(
    const uint32_t* hi, const uint32_t* lo, long B, long s,
    const double* kc, double d, double threshold,
    const uint32_t* fsig_sorted,   // [N] sorted u32 full-sketch sigs
    const int32_t* fpref,          // [65537] bucket index over sig>>16
    const int64_t* forder,         // [N] -> window id
    const uint64_t* sketches,      // [N, s] u64
    long* out_rows, long* out_wins, long cap) {
    long n_out = 0;
    for (long b = 0; b < B; b++) {
        const uint32_t* h = hi + b * s;
        const uint32_t* l = lo + b * s;
        uint32_t sig = 2166136261u;
        for (long j = 0; j < s; j++) {
            sig = (sig ^ l[j]) * 16777619u;
            sig = (sig ^ h[j]) * 16777619u;
        }
        long p0 = fpref[sig >> 16], p1 = fpref[(sig >> 16) + 1];
        // lower_bound within the bucket
        while (p0 < p1) {
            long mid = (p0 + p1) >> 1;
            if (fsig_sorted[mid] < sig) p0 = mid + 1; else p1 = mid;
        }
        const double q = kc[b];
        const double contain = (q + d) / (2.0 * q);
        if (!(contain > threshold)) continue;
        for (long i = p0;
             i < fpref[(sig >> 16) + 1] && fsig_sorted[i] == sig; i++) {
            const long win = forder[i];
            const uint64_t* sk = sketches + win * s;
            bool eq = true;
            for (long j = 0; j < s; j++) {
                const uint64_t qv = ((uint64_t)h[j] << 32) | l[j];
                if (sk[j] != qv) { eq = false; break; }
            }
            if (!eq) continue;
            if (n_out >= cap) return -1;
            out_rows[n_out] = b;
            out_wins[n_out] = win;
            n_out++;
        }
    }
    return n_out;
}

// gio_lsh_query_full64: gio_lsh_query_full32 taking the sketcher's native
// u64 [B, s] output directly (no hi/lo split round-trip). When
// `prescreened` is set the batch was sketched with the slot-0 prescreen
// (io.native.sketch): rows whose slots 1..s-1 are the all-ones sentinel
// were proven unable to match all s slots, so they skip the signature
// mix + lookup entirely (~99% of a typical metagenome).
extern "C" long gio_lsh_query_full64(
    const uint64_t* q, long B, long s,
    const double* kc, double d, double threshold,
    const uint32_t* fsig_sorted, const int32_t* fpref,
    const int64_t* forder, const uint64_t* sketches,
    long prescreened,
    long* out_rows, long* out_wins, long cap) {
    const uint64_t FULL = ~0ULL;
    long n_out = 0;
    for (long b = 0; b < B; b++) {
        const uint64_t* qq = q + b * s;
        if (prescreened && s > 1 && qq[1] == FULL) continue;
        const double qk = kc[b];
        if (!((qk + d) / (2.0 * qk) > threshold)) continue;
        uint32_t sig = 2166136261u;
        for (long j = 0; j < s; j++) {
            sig = (sig ^ (uint32_t)qq[j]) * 16777619u;
            sig = (sig ^ (uint32_t)(qq[j] >> 32)) * 16777619u;
        }
        long p0 = fpref[sig >> 16], p1 = fpref[(sig >> 16) + 1];
        while (p0 < p1) {
            long mid = (p0 + p1) >> 1;
            if (fsig_sorted[mid] < sig) p0 = mid + 1; else p1 = mid;
        }
        for (long i = p0;
             i < fpref[(sig >> 16) + 1] && fsig_sorted[i] == sig; i++) {
            const long win = forder[i];
            const uint64_t* sk = sketches + win * s;
            bool eq = true;
            for (long j = 0; j < s; j++)
                if (sk[j] != qq[j]) { eq = false; break; }
            if (!eq) continue;
            if (n_out >= cap) return -1;
            out_rows[n_out] = b;
            out_wins[n_out] = win;
            n_out++;
        }
    }
    return n_out;
}

// ---------------------------------------------------------------------------
// gio_weight_pairs: the increment_subpath weight replay
// (align/batch_host.WeightAccumulator.add_pairs): per (window, kmer_count)
// pair, scatter cn_share * kc over the window's contained-node rows; multi-
// node windows also add floor(kc) to their graph's k-mer total.
extern "C" void gio_weight_pairs(
    long n, const long* wins, const double* kc,
    const long* cn_ptr, const int32_t* cn_cnt,
    const long* cn_grow, const double* cn_share,
    const uint8_t* w_multi, const int32_t* w_gidx,
    double* node_w, double* graph_kt) {
    for (long i = 0; i < n; i++) {
        const long w = wins[i];
        const double k = kc[i];
        const long o = cn_ptr[w];
        const long c = cn_cnt[w];
        for (long j = 0; j < c; j++)
            node_w[cn_grow[o + j]] += cn_share[o + j] * k;
        if (w_multi[w]) graph_kt[w_gidx[w]] += (double)(long)k;
    }
}

// ---------------------------------------------------------------------------
// gio_gather_bytes: scatter-gather n variable-length byte ranges from buf
// into out (the payload concatenation of align_pipeline.ReadBatch.payloads,
// which cost ~0.4s/30k reads as numpy repeat/fancy-index glue).
extern "C" void gio_gather_bytes(
    const uint8_t* buf, long n, const long* src_off, const long* src_len,
    const long* dst_off, uint8_t* out) {
    for (long i = 0; i < n; i++)
        memcpy(out + dst_off[i], buf + src_off[i], src_len[i]);
}

// ---------------------------------------------------------------------------
// gio_emit_records: assemble a whole batch of BAM alignment records in one
// pass (replaces hash_join._emit_flat's oriented-gather + bam.write_groups'
// numpy scatter pipeline). Records are grouped per winning (read, graph)
// combo; records of a group share the read's name/SEQ/QUAL and differ only
// in (ref, pos, secondary flag) — the reference emits one sam.Record per
// matching path (alignment.go:113-156), MAPQ 30, CIGAR [H]M[H].
//
// Group arrays (length G): id/seq/qual (offset, len) into their byte
// buffers, rev/cs/ce orientation + clips, group_ptr [G+1] record spans.
// Record arrays (length N = group_ptr[G]): ref_id, pos.
// Returns bytes written to out, or -1 if out_cap was too small.
static inline uint16_t gio_reg2bin(long beg, long end) {
    end--;
    if (beg >> 14 == end >> 14) return (uint16_t)(4681 + (beg >> 14));
    if (beg >> 17 == end >> 17) return (uint16_t)(585 + (beg >> 17));
    if (beg >> 20 == end >> 20) return (uint16_t)(73 + (beg >> 20));
    if (beg >> 23 == end >> 23) return (uint16_t)(9 + (beg >> 23));
    if (beg >> 26 == end >> 26) return (uint16_t)(1 + (beg >> 26));
    return 0;
}

long gio_emit_records(
    long G,
    const uint8_t* idc, const long* ido, const long* idl,
    const uint8_t* sqc, const long* sqo, const long* sql,
    const uint8_t* quc, const long* quo, const long* qul,
    const uint8_t* rev, const int16_t* cs16, const int16_t* ce16,
    const long* group_ptr,
    const int32_t* ref_ids, const long* poss,
    uint8_t* out, long out_cap) {
    // ASCII -> BAM nibble, plus the reverse-complement variant
    // (complement ACGT/acgt, everything else N), matching
    // _NIB_LUT[_rc_lut[...]] on the Python side.
    static uint8_t NIBF[256], NIBR[256];
    static bool init = false;
    if (!init) {
        const char* syms = "=ACMGRSVTWYHKDBN";
        for (int i = 0; i < 256; i++) { NIBF[i] = 15; NIBR[i] = 15; }
        for (int i = 0; i < 16; i++) NIBF[(uint8_t)syms[i]] = (uint8_t)i;
        const char* fw = "ACGTacgt";
        const char* cm = "TGCATGCA";
        for (int i = 0; i < 8; i++)
            NIBR[(uint8_t)fw[i]] = NIBF[(uint8_t)cm[i]];
        init = true;
    }
    long w = 0;
    for (long g = 0; g < G; g++) {
        const long Lr = sql[g];
        const long cs = cs16[g], ce = ce16[g];
        const long olen = Lr - cs - ce;
        const long nib_len = (olen + 1) / 2;
        const long name_len = idl[g] + 1;  // + NUL
        const int ncig = 1 + (cs > 0) + (ce > 0);
        const bool rv = rev[g] != 0;
        const long r0 = group_ptr[g], r1 = group_ptr[g + 1];
        const bool multi = (r1 - r0) > 1;
        const long body = 32 + name_len + 4 * ncig + nib_len + olen;
        if (w + (r1 - r0) * (4 + body) > out_cap) return -1;

        // group-shared payload: name, packed SEQ, QUAL (oriented + clipped)
        // staged once into scratch, memcpy'd per record
        uint8_t scratch[4096];
        uint8_t* pay = (name_len + nib_len + olen <= (long)sizeof(scratch))
                           ? scratch
                           : new uint8_t[name_len + nib_len + olen];
        memcpy(pay, idc + ido[g], idl[g]);
        pay[idl[g]] = 0;
        uint8_t* nib = pay + name_len;
        const uint8_t* sq = sqc + sqo[g];
        for (long i = 0; i < nib_len; i++) nib[i] = 0;
        if (rv) {
            // reverse-complement: base i comes from Lr-1-(cs+i)
            for (long i = 0; i < olen; i++) {
                const uint8_t v = NIBR[sq[Lr - 1 - (cs + i)]];
                nib[i >> 1] |= (i & 1) ? v : (uint8_t)(v << 4);
            }
        } else {
            for (long i = 0; i < olen; i++) {
                const uint8_t v = NIBF[sq[cs + i]];
                nib[i >> 1] |= (i & 1) ? v : (uint8_t)(v << 4);
            }
        }
        uint8_t* qu = nib + nib_len;
        if (qul[g] == Lr) {
            const uint8_t* q = quc + quo[g];
            for (long i = 0; i < olen; i++) {
                const long src = rv ? (Lr - 1 - (cs + i)) : (cs + i);
                const int v = (int)q[src] - 33;
                qu[i] = (uint8_t)(v > 0 ? v : 0);
            }
        } else {
            memset(qu, 0xff, olen);
        }
        uint32_t cig[3];
        int nc = 0;
        if (cs > 0) cig[nc++] = ((uint32_t)cs << 4) | 5;
        cig[nc++] = (uint32_t)olen << 4;
        if (ce > 0) cig[nc++] = ((uint32_t)ce << 4) | 5;

        for (long r = r0; r < r1; r++) {
            uint8_t* p = out + w;
            const uint32_t bs = (uint32_t)body;
            memcpy(p, &bs, 4);
            const int32_t rid = ref_ids[r];
            memcpy(p + 4, &rid, 4);
            const int32_t pos = (int32_t)poss[r];
            memcpy(p + 8, &pos, 4);
            const uint32_t bin = gio_reg2bin(poss[r], poss[r] + olen);
            const uint32_t bmn = ((uint32_t)name_len) | (30u << 8) | (bin << 16);
            memcpy(p + 12, &bmn, 4);
            uint32_t flag = rv ? 0x10u : 0u;
            if (multi && r > r0) flag |= 0x100u;  // secondary
            const uint32_t fnc = ((uint32_t)ncig) | (flag << 16);
            memcpy(p + 16, &fnc, 4);
            const uint32_t ol32 = (uint32_t)olen;
            memcpy(p + 20, &ol32, 4);
            const int32_t neg1 = -1;
            memcpy(p + 24, &neg1, 4);  // next_refID
            memcpy(p + 28, &neg1, 4);  // next_pos
            const int32_t tlen = 0;
            memcpy(p + 32, &tlen, 4);
            memcpy(p + 36, pay, name_len);
            memcpy(p + 36 + name_len, cig, 4 * nc);
            memcpy(p + 36 + name_len + 4 * nc, nib, nib_len + olen);
            w += 4 + body;
        }
        if (pay != scratch) delete[] pay;
    }
    return w;
}

// ---------------------------------------------------------------------------
// gio_bam_scan: walk decompressed BAM records from `start`, extracting the
// fields the report stage needs (reporting.go:72-123): ref_id, pos, flag,
// and the alignment length on the reference (sum of M/D/N/=/X cigar ops,
// biogo Record.Len). Returns the record count, or -1 if cap is too small.
extern "C" long gio_bam_scan(
    const uint8_t* data, long n, long start,
    int32_t* ref_id, int32_t* pos, uint16_t* flag, int32_t* aln_len,
    long cap) {
    long o = start;
    long count = 0;
    while (o + 4 <= n) {
        uint32_t block_size;
        memcpy(&block_size, data + o, 4);
        if (o + 4 + (long)block_size > n) break;
        if (count >= cap) return -1;
        const uint8_t* r = data + o + 4;
        memcpy(&ref_id[count], r, 4);
        memcpy(&pos[count], r + 4, 4);
        const uint32_t l_name = r[8];
        uint16_t n_cigar, fl;
        memcpy(&n_cigar, r + 12, 2);
        memcpy(&fl, r + 14, 2);
        flag[count] = fl;
        const uint8_t* cig = r + 32 + l_name;
        long alen = 0;
        for (uint16_t c = 0; c < n_cigar; c++) {
            uint32_t v;
            memcpy(&v, cig + 4 * c, 4);
            const uint32_t op = v & 0xF;
            // M=0 D=2 N=3 ==7 X=8 consume reference
            if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
                alen += v >> 4;
        }
        aln_len[count] = (int32_t)alen;
        count++;
        o += 4 + block_size;
    }
    return count;
}

// Compress a run of consecutive BGZF blocks (block size bs, last block may
// be short) in one call — one GIL release for a whole batch instead of one
// Python/ctypes/queue round-trip per 64KB block. Returns total bytes
// written to out, or -1 on error / insufficient out_cap.
long gio_bgzf_many(
    const uint8_t* data, long n, long bs, uint8_t* out, long out_cap) {
    long written = 0;
    for (long off = 0; off < n; off += bs) {
        const long blk = (n - off < bs) ? (n - off) : bs;
        const long r = gio_bgzf_block(
            data + off, blk, out + written, out_cap - written);
        if (r < 0) return -1;
        written += r;
    }
    return written;
}

// Inflate pre-walked BGZF blocks (raw deflate payloads) with libdeflate
// (~3x zlib; zlib fallback without it); the caller (io.bam.bgzf_decompress)
// parses the BSIZE fields. Returns total bytes written, or -1 on a corrupt
// block / isize mismatch.
long gio_inflate_blocks(
    const uint8_t* raw, const long* off, const long* clen,
    const long* isize, long n_blocks, uint8_t* out) {
#ifdef GIO_HAVE_LIBDEFLATE
    static thread_local struct libdeflate_decompressor* d = nullptr;
    if (!d) {
        d = libdeflate_alloc_decompressor();
        if (!d) return -1;
    }
#endif
    long pos = 0;
    for (long i = 0; i < n_blocks; i++) {
        if (!isize[i]) continue;
        if (clen[i] < 0 || isize[i] < 0) return -1;  // corrupt block walk
#ifdef GIO_HAVE_LIBDEFLATE
        size_t actual = 0;
        if (libdeflate_deflate_decompress(
                d, raw + off[i], (size_t)clen[i], out + pos,
                (size_t)isize[i], &actual) != LIBDEFLATE_SUCCESS ||
            (long)actual != isize[i])
            return -1;
        pos += isize[i];
#else
        z_stream zs;
        memset(&zs, 0, sizeof(zs));
        if (inflateInit2(&zs, -15) != Z_OK) return -1;
        zs.next_in = (Bytef*)(raw + off[i]);
        zs.avail_in = (uInt)clen[i];
        zs.next_out = out + pos;
        zs.avail_out = (uInt)isize[i];
        int rc = inflate(&zs, Z_FINISH);
        long got = (long)zs.total_out;
        inflateEnd(&zs);
        if (rc != Z_STREAM_END || got != isize[i]) return -1;
        pos += isize[i];
#endif
    }
    return pos;
}

// Decompress whole-buffer gzip input (one or more concatenated members,
// the layout of .fastq.gz and bgzip files) with libdeflate — measured ~3x
// zlib's streaming inflate. Returns bytes written, -2 when out_cap is too
// small (caller grows and retries), -1 on corrupt input or when built
// without libdeflate (caller falls back to the zlib streaming path).
extern "C" long gio_gunzip(
    const uint8_t* in, long in_len, uint8_t* out, long out_cap) {
#ifdef GIO_HAVE_LIBDEFLATE
    static thread_local struct libdeflate_decompressor* d = nullptr;
    if (!d) {
        d = libdeflate_alloc_decompressor();
        if (!d) return -1;
    }
    long in_pos = 0, out_pos = 0;
    while (in_pos < in_len) {
        size_t nin = 0, nout = 0;
        enum libdeflate_result r = libdeflate_gzip_decompress_ex(
            d, in + in_pos, (size_t)(in_len - in_pos),
            out + out_pos, (size_t)(out_cap - out_pos), &nin, &nout);
        if (r == LIBDEFLATE_INSUFFICIENT_SPACE) return -2;
        if (r != LIBDEFLATE_SUCCESS || nin == 0) return -1;
        in_pos += (long)nin;
        out_pos += (long)nout;
    }
    return out_pos;
#else
    (void)in; (void)in_len; (void)out; (void)out_cap;
    return -1;
#endif
}

// Name of the deflate library this build links ("libdeflate" or "zlib").
extern "C" const char* gio_deflate_lib() {
#ifdef GIO_HAVE_LIBDEFLATE
    return "libdeflate";
#else
    return "zlib";
#endif
}

}  // extern "C"

// ---------------------------------------------------------------------------
// gio_cascade: staged winner evaluation for the hash-join aligner
// (groot_tpu/align/hash_join.py). For each (read, graph) combo, try its
// pairs in order (graphminion.go:57-99) and, per pair, the four probe
// stages of AlignRead (alignment.go:34-103) over the combo's match list;
// the first success wins and later pairs are never evaluated. Emits the
// winning (ori, stage) per combo plus the matching (row, pos) ids of the
// winning probe.
//
// match semantics are precomputed on the host (hash join): a match
// (var, row, pos) states that read-variant `var` matches path row `row` at
// `pos` (wildcards and dead-end overhangs already resolved).
// O(1) clip-variant probe for the cascade's lazy stages 3/4: does read
// b's variant v (1=f-cs 2=f-ce 4=rc-cs 5=rc-ce) exactly match path `row` at
// position q? Interior matches compare substring hashes; dead-end overhangs
// (alignment.go:229) compare the read-prefix hash at terminal-free rows;
// wildcard (N) rows fall back to a byte check with on-the-fly RC.
static inline bool gio_clip_probe(
    long b, int v, long row, long q, long Lr,
    const uint8_t* codes, long stride,
    const uint64_t* PHf, const uint64_t* PHr, uint64_t rinv1,
    const uint64_t* rinv, const uint64_t* ph, const long* ph_start,
    const int32_t* path_len, const uint8_t* tfree, const uint8_t* nrow,
    const uint8_t* flat_codes, const long* flat_start) {
    const long plen = path_len[row];
    if (q >= plen) return false;
    const long lb = Lr - 1;
    const uint64_t* php = ph + ph_start[row];
    bool ok;
    uint64_t vfull;
    switch (v) {
        case 1: vfull = (PHf[Lr] - PHf[1]) * rinv1; break;
        case 2: vfull = PHf[Lr - 1]; break;
        case 4: vfull = (PHr[Lr] - PHr[1]) * rinv1; break;
        default: vfull = PHr[Lr - 1]; break;  // 5
    }
    if (q + lb <= plen) {
        ok = (php[q + lb] - php[q]) * rinv[q] == vfull;
    } else if (tfree[row]) {
        const long qlen = plen - q;
        uint64_t vpref;
        switch (v) {
            case 1: vpref = (PHf[qlen + 1] - PHf[1]) * rinv1; break;
            case 2: vpref = PHf[qlen]; break;
            case 4: vpref = (PHr[qlen + 1] - PHr[1]) * rinv1; break;
            default: vpref = PHr[qlen]; break;
        }
        ok = (php[plen] - php[q]) * rinv[q] == vpref;
    } else {
        ok = false;
    }
    if (!ok && nrow[row]) {
        // wildcard row: byte verify, deriving RC bases on the fly
        static const uint8_t RC5[5] = {3, 2, 1, 0, 4};
        const uint8_t* cs = codes + b * stride;
        const long coff = (v % 3 == 1) ? 1 : 0;
        long in_path = plen - q;
        if (in_path > lb) in_path = lb;
        const uint8_t* path = flat_codes + flat_start[row] + q;
        ok = true;
        for (long i = 0; i < in_path; i++) {
            const uint8_t pb = path[i];
            const uint8_t sb = (v >= 3)
                ? RC5[cs[Lr - 1 - (coff + i)]]
                : cs[coff + i];
            if (pb != sb && pb != 4) { ok = false; break; }
        }
        if (ok && in_path < lb && !tfree[row]) ok = false;
    }
    return ok;
}

static long gio_cascade_range(
    // combos
    long ci0, long ci1, const long* c_mlo, const long* c_mcnt,
    const long* c_pair_start, const long* c_pair_cnt, const uint8_t* c_fb,
    // matches (combo-segmented)
    const int8_t* m_var, const int32_t* m_row, const int32_t* m_pos,
    // per-pair seed data (index = global pair id)
    const long* p_seed_grow, const int32_t* p_off, const int32_t* p_span,
    const long* p_cn_ptr, const int32_t* p_cn_cnt,
    // contained-node rows (global CSR, indexed via p_cn_ptr/p_cn_cnt)
    const long* cn_grow,
    // node -> (path row) dense position lookup
    const long* node_base, const int32_t* node_g, const long* g_first_row,
    const int32_t* npos_dense, const int32_t* node_len,
    int n_shuffles,
    // lazy stage-3/4 clip probes (see gio_clip_probe)
    const long* c_read, const uint8_t* codes, long stride,
    const long* lengths, const int32_t* ph_row,
    const uint64_t* phf_all, const uint64_t* phr_all,
    const uint64_t* rinv, const uint64_t* ph, const long* ph_start,
    const int32_t* path_len, const uint8_t* tfree, const uint8_t* nrow,
    const uint8_t* flat_codes, const long* flat_start,
    // outputs
    int32_t* combo_win,      // [nc] global pair id or -1
    int8_t* combo_ori,       // [nc]
    int8_t* combo_stage,     // [nc] 1..4
    int32_t* out_combo, int32_t* out_row, int32_t* out_pos, long out_cap) {
    long n_out = 0;
    const long BIGJ = 1L << 60;
    for (long ci = ci0; ci < ci1; ci++) {
        combo_win[ci] = -1;
        combo_ori[ci] = 0;
        combo_stage[ci] = 0;
        if (c_fb[ci]) continue;
        const long mlo = c_mlo[ci], mcnt = c_mcnt[ci];
        const long ps = c_pair_start[ci], pe = ps + c_pair_cnt[ci];
        bool done = false;
        for (long p = ps; p < pe && !done; p++) {
            const long sg = p_seed_grow[p];
            const long soff = p_off[p];
            const long span = p_span[p];
            const long slen = node_len[sg];
            const long sg_base = node_base[sg] - g_first_row[node_g[sg]];
            const bool seed_ok = soff < slen;
            for (int ori = 0; ori < 2 && !done; ori++) {
                const int8_t v_full = (int8_t)(ori * 3);
                // stage 1: min shuffle within the seed window
                long best_j = BIGJ;
                if (seed_ok) {
                    long bound = span;
                    if (slen - 1 - soff < bound) bound = slen - 1 - soff;
                    for (long m = mlo; m < mlo + mcnt; m++) {
                        if (m_var[m] != v_full) continue;
                        const int32_t spos = npos_dense[sg_base + m_row[m]];
                        if (spos < 0) continue;
                        const long j = (long)m_pos[m] - spos - soff;
                        if (j >= 0 && j <= bound && j < best_j) best_j = j;
                    }
                }
                int stage = 0;
                long win_key = 0;
                if (best_j < BIGJ) {
                    stage = 1;
                    win_key = best_j;
                } else {
                    // stage 2: contained nodes ascending x shuffles 0..10
                    long best_key = BIGJ;
                    const long cp = p_cn_ptr[p];
                    const long cn = p_cn_cnt[p];
                    for (long m = mlo; m < mlo + mcnt; m++) {
                        if (m_var[m] != v_full) continue;
                        for (long r = 0; r < cn; r++) {
                            const long g = cn_grow[cp + r];
                            const long base =
                                node_base[g] - g_first_row[node_g[g]];
                            const int32_t cpos = npos_dense[base + m_row[m]];
                            if (cpos < 0) continue;
                            const long sh = (long)m_pos[m] - cpos;
                            long b2 = n_shuffles;
                            if (node_len[g] - 1 < b2) b2 = node_len[g] - 1;
                            if (sh >= 0 && sh <= b2) {
                                const long key = r * (n_shuffles + 1) + sh;
                                if (key < best_key) best_key = key;
                            }
                        }
                    }
                    if (best_key < BIGJ) {
                        stage = 2;
                        win_key = best_key;
                    } else if (seed_ok) {
                        // stages 3/4: lazy clip probes at the seed offset
                        // (clip-variant matches are not in the match list;
                        // they are hash-checked here only when stages 1-2
                        // failed — the reference evaluates the cascade
                        // stages in exactly this order, alignment.go:73-103)
                        const long g2 = node_g[sg];
                        const long r0 = g_first_row[g2];
                        const long r1 = g_first_row[g2 + 1];
                        const long b2 = c_read[ci];
                        const long Lr2 = lengths[b2];
                        const uint64_t* PHf2 =
                            phf_all + (long)ph_row[b2] * (stride + 2);
                        const uint64_t* PHr2 =
                            phr_all + (long)ph_row[b2] * (stride + 2);
                        for (int kind = 1; kind <= 2 && !stage; kind++) {
                            const int v = ori * 3 + kind;
                            for (long row = r0; row < r1; row++) {
                                const int32_t spos =
                                    npos_dense[sg_base + row];
                                if (spos < 0) continue;
                                if (gio_clip_probe(
                                        b2, v, row, (long)spos + soff, Lr2,
                                        codes, stride, PHf2, PHr2, rinv[1],
                                        rinv, ph, ph_start, path_len, tfree,
                                        nrow, flat_codes, flat_start)) {
                                    stage = kind + 2;
                                    break;
                                }
                            }
                        }
                    }
                }
                if (!stage) continue;
                // collect ids of the winning probe
                combo_win[ci] = (int32_t)p;
                combo_ori[ci] = (int8_t)ori;
                combo_stage[ci] = (int8_t)stage;
                if (stage >= 3) {
                    // clip ids: probe every path row at its seed position
                    const int v = ori * 3 + (stage - 2);
                    const long g2 = node_g[sg];
                    const long r0 = g_first_row[g2];
                    const long r1 = g_first_row[g2 + 1];
                    const long b2 = c_read[ci];
                    const long Lr2 = lengths[b2];
                    const uint64_t* PHf2 =
                        phf_all + (long)ph_row[b2] * (stride + 2);
                    const uint64_t* PHr2 =
                        phr_all + (long)ph_row[b2] * (stride + 2);
                    for (long row = r0; row < r1; row++) {
                        const int32_t spos = npos_dense[sg_base + row];
                        if (spos < 0) continue;
                        if (gio_clip_probe(
                                b2, v, row, (long)spos + soff, Lr2, codes,
                                stride, PHf2, PHr2, rinv[1], rinv, ph,
                                ph_start, path_len, tfree, nrow, flat_codes,
                                flat_start)
                            && n_out < out_cap) {
                            out_combo[n_out] = (int32_t)ci;
                            out_row[n_out] = (int32_t)row;
                            out_pos[n_out] = (int32_t)(spos + soff);
                            n_out++;
                        }
                    }
                } else {
                  const int8_t v_want = (int8_t)(ori * 3);
                  for (long m = mlo; m < mlo + mcnt; m++) {
                    if (m_var[m] != v_want) continue;
                    bool hit = false;
                    if (stage == 1) {
                        const int32_t spos = npos_dense[sg_base + m_row[m]];
                        if (spos >= 0) {
                            const long want = spos + soff + win_key;
                            hit = (long)m_pos[m] == want;
                        }
                    } else {  // stage 2
                        const long r = win_key / (n_shuffles + 1);
                        const long sh = win_key % (n_shuffles + 1);
                        const long g = cn_grow[p_cn_ptr[p] + r];
                        const long base =
                            node_base[g] - g_first_row[node_g[g]];
                        const int32_t cpos = npos_dense[base + m_row[m]];
                        hit = cpos >= 0 && (long)m_pos[m] == cpos + sh;
                    }
                    if (hit && n_out < out_cap) {
                        out_combo[n_out] = (int32_t)ci;
                        out_row[n_out] = m_row[m];
                        out_pos[n_out] = m_pos[m];
                        n_out++;
                    }
                  }
                }
                done = true;
            }
        }
    }
    return n_out;
}

// Threaded front end for the cascade: combos are independent; the per-combo
// outputs are disjoint writes, the flat id lists concatenate (downstream
// re-sorts ids by (combo, row, pos), hash_join.process_batch).
extern "C" long gio_cascade(
    long nc, const long* c_mlo, const long* c_mcnt,
    const long* c_pair_start, const long* c_pair_cnt, const uint8_t* c_fb,
    const int8_t* m_var, const int32_t* m_row, const int32_t* m_pos,
    const long* p_seed_grow, const int32_t* p_off, const int32_t* p_span,
    const long* p_cn_ptr, const int32_t* p_cn_cnt,
    const long* cn_grow,
    const long* node_base, const int32_t* node_g, const long* g_first_row,
    const int32_t* npos_dense, const int32_t* node_len,
    int n_shuffles,
    const long* c_read, const uint8_t* codes, long stride,
    const long* lengths, const int32_t* ph_row,
    const uint64_t* phf_all, const uint64_t* phr_all,
    const uint64_t* rinv, const uint64_t* ph, const long* ph_start,
    const int32_t* path_len, const uint8_t* tfree, const uint8_t* nrow,
    const uint8_t* flat_codes, const long* flat_start,
    int32_t* combo_win, int8_t* combo_ori, int8_t* combo_stage,
    int32_t* out_combo, int32_t* out_row, int32_t* out_pos, long out_cap) {
    if (nc < 256)
        return gio_cascade_range(
            0, nc, c_mlo, c_mcnt, c_pair_start, c_pair_cnt, c_fb, m_var,
            m_row, m_pos, p_seed_grow, p_off, p_span, p_cn_ptr, p_cn_cnt,
            cn_grow, node_base, node_g, g_first_row, npos_dense, node_len,
            n_shuffles,
            c_read, codes, stride, lengths, ph_row, phf_all, phr_all,
            rinv, ph, ph_start, path_len, tfree, nrow, flat_codes,
            flat_start,
            combo_win, combo_ori, combo_stage, out_combo,
            out_row, out_pos, out_cap);
    const long mid = nc / 2;
    int32_t* t_combo = new int32_t[out_cap];
    int32_t* t_row = new int32_t[out_cap];
    int32_t* t_pos = new int32_t[out_cap];
    long n2 = 0;
    std::thread th([&]() {
        n2 = gio_cascade_range(
            mid, nc, c_mlo, c_mcnt, c_pair_start, c_pair_cnt, c_fb, m_var,
            m_row, m_pos, p_seed_grow, p_off, p_span, p_cn_ptr, p_cn_cnt,
            cn_grow, node_base, node_g, g_first_row, npos_dense, node_len,
            n_shuffles,
            c_read, codes, stride, lengths, ph_row, phf_all, phr_all,
            rinv, ph, ph_start, path_len, tfree, nrow, flat_codes,
            flat_start,
            combo_win, combo_ori, combo_stage, t_combo, t_row,
            t_pos, out_cap);
    });
    long n1 = gio_cascade_range(
        0, mid, c_mlo, c_mcnt, c_pair_start, c_pair_cnt, c_fb, m_var,
        m_row, m_pos, p_seed_grow, p_off, p_span, p_cn_ptr, p_cn_cnt,
        cn_grow, node_base, node_g, g_first_row, npos_dense, node_len,
        n_shuffles,
        c_read, codes, stride, lengths, ph_row, phf_all, phr_all,
        rinv, ph, ph_start, path_len, tfree, nrow, flat_codes,
        flat_start,
        combo_win, combo_ori, combo_stage, out_combo, out_row,
        out_pos, out_cap);
    th.join();
    long ret;
    if (n1 + n2 > out_cap) {
        ret = out_cap + 1;  // caller treats > cap as overflow
    } else {
        memcpy(out_combo + n1, t_combo, n2 * sizeof(int32_t));
        memcpy(out_row + n1, t_row, n2 * sizeof(int32_t));
        memcpy(out_pos + n1, t_pos, n2 * sizeof(int32_t));
        ret = n1 + n2;
    }
    delete[] t_combo; delete[] t_row; delete[] t_pos;
    return ret;
}

// ---------------------------------------------------------------------------
// gio_verify: wildcard-aware byte verification of candidate matches
// (hash_join._verify_candidates): candidate (b, v, row, pos) matches iff
// every variant base equals the path base or the path base is N(4), with
// overhang past the path end only at terminal-free rows.
extern "C" void gio_verify(
    long n, const long* cand_b, const int8_t* cand_v, const long* cand_row,
    const long* cand_pos,
    const uint8_t* codes, const uint8_t* rc, long has_rc,
    long stride,  // [B, stride]
    const long* lengths,
    const int32_t* path_len, const long* flat_start,
    const uint8_t* flat_codes, const uint8_t* tfree,
    uint8_t* out) {
    static const uint8_t RC5[5] = {3, 2, 1, 0, 4};
    for (long c = 0; c < n; c++) {
        const long b = cand_b[c];
        const int v = cand_v[c];
        const long Lr = lengths[b];
        const long eff = Lr - (v % 3 != 0 ? 1 : 0);
        const long cs = (v % 3 == 1) ? 1 : 0;
        const long row = cand_row[c];
        const long plen = path_len[row];
        const long pos = cand_pos[c];
        const uint8_t* path = flat_codes + flat_start[row] + pos;
        long in_path = plen - pos;
        if (in_path > eff) in_path = in_path < 0 ? 0 : eff;
        bool ok = true;
        if (v >= 3 && !has_rc) {
            // derive reverse-complement bases on the fly (no rc matrix)
            const uint8_t* cr = codes + b * stride;
            for (long i = 0; i < in_path; i++) {
                const uint8_t pb = path[i];
                const uint8_t sb = RC5[cr[Lr - 1 - (cs + i)]];
                if (pb != sb && pb != 4) { ok = false; break; }
            }
        } else {
            const uint8_t* src =
                (v >= 3 ? rc : codes) + b * stride + cs;
            for (long i = 0; i < in_path; i++) {
                const uint8_t pb = path[i];
                if (pb != src[i] && pb != 4) { ok = false; break; }
            }
        }
        if (ok && in_path < eff && !tfree[row]) ok = false;  // overhang
        out[c] = ok ? 1 : 0;
    }
}

// ---------------------------------------------------------------------------
// gio_bam_fill: assemble a batch of BAM alignment records into one buffer.
// Per-record geometry is precomputed on the host; this is the memcpy loop
// (the numpy index-array assembly cost ~60x more).
extern "C" void gio_bam_fill(
    long n_rec,
    const long* off,            // [N] record start in out
    const uint32_t* hdr,        // [N, 9] u32: block_size + 32-byte fixed
    const long* name_off, const long* name_len,  // into name_buf (incl NUL)
    const uint8_t* name_buf,
    const uint32_t* cig,        // [N, 3]
    const uint8_t* ncig,        // [N] 1..3
    const long* nib_off, const long* nib_len, const uint8_t* nib_buf,
    const long* qual_off, const long* qual_len, const uint8_t* qual_buf,
    uint8_t* out) {
    for (long r = 0; r < n_rec; r++) {
        uint8_t* p = out + off[r];
        memcpy(p, hdr + r * 9, 36);
        p += 36;
        memcpy(p, name_buf + name_off[r], name_len[r]);
        p += name_len[r];
        const uint32_t* cg = cig + r * 3;
        for (int i = 0; i < ncig[r]; i++) {
            memcpy(p, cg + i, 4);
            p += 4;
        }
        memcpy(p, nib_buf + nib_off[r], nib_len[r]);
        p += nib_len[r];
        memcpy(p, qual_buf + qual_off[r], qual_len[r]);
    }
}

// ---------------------------------------------------------------------------
// gio_sketch: canonical ntHash KHF MinHash sketching of a read batch
// (ops/nthash.py khf_sketch_np_batch, same rotate-normalised prefix-XOR
// form). out is u64 [B, s]; rows shorter than k sketch to all-ones.
static const uint64_t NT_SEEDS[5] = {
    0x3C8BFBB395C60474ULL, 0x3193C18562A02B4CULL, 0x20323ED082572324ULL,
    0x295549F54BE24456ULL, 0x0000000000000000ULL,
};
static const uint64_t NT_MULTISEED = 0x90B45D39FB6DA1FAULL;
static inline uint64_t rol64(uint64_t x, unsigned r) {
    r &= 63;
    return r ? (x << r) | (x >> (64 - r)) : x;
}

static void gio_sketch_range(
    const uint8_t* codes, long b0, long b1, long stride, const long* vlen,
    long k, long s, uint64_t* out,
    // optional slot-0 prescreen (full-equality queries only, t=0.99): if
    // the read's slot-0 min-hash is not among the index windows' slot-0
    // values, no window can match all s slots — skip the other s-1
    // multihash passes and emit sentinel slots (the query's exact
    // verification keeps correctness regardless)
    long n_s0, const uint64_t* s0_sorted, const int32_t* s0_pref) {
    static uint64_t ROTF[5][64], ROTR[5][64];
    static bool init = false;
    if (!init) {
        const int rc_of[5] = {3, 2, 1, 0, 4};
        for (int c = 0; c < 5; c++)
            for (int m = 0; m < 64; m++) {
                ROTF[c][m] = rol64(NT_SEEDS[c], (64 - m) & 63);  // ror m
                ROTR[c][m] = rol64(NT_SEEDS[rc_of[c]], m);
            }
        init = true;
    }
    const uint64_t FULL = ~0ULL;
    const uint64_t kseed = (uint64_t)k * NT_MULTISEED;
    // per-read scratch (VLA-free: allocate max stride once)
    uint64_t* X = new uint64_t[stride + 1];
    uint64_t* Y = new uint64_t[stride + 1];
    uint64_t* C = new uint64_t[stride + 1];
    for (long b = b0; b < b1; b++) {
        uint64_t* o = out + b * s;
        const long nk = vlen[b] - k + 1;
        if (nk <= 0) {
            for (long j = 0; j < s; j++) o[j] = FULL;
            continue;
        }
        const uint8_t* cs = codes + b * stride;
        X[0] = 0; Y[0] = 0;
        const long n = vlen[b];
        for (long i = 0; i < n; i++) {
            X[i + 1] = X[i] ^ ROTF[cs[i]][i & 63];
            Y[i + 1] = Y[i] ^ ROTR[cs[i]][i & 63];
        }
        // canonical k-mer hashes first, then one vectorizable min-reduce
        // pass per sketch slot (the multiply/xorshift/min loop lowers to
        // vpmullq/vpminuq lanes under -march=native)
        for (long i = 0; i < nk; i++) {
            const uint64_t fwd = rol64(X[i + k] ^ X[i], (unsigned)(i + k - 1));
            const uint64_t rev =
                rol64(Y[i + k] ^ Y[i], (unsigned)(64 - (i & 63)));
            C[i] = fwd < rev ? fwd : rev;
        }
        {
            uint64_t mn = FULL;
            for (long i = 0; i < nk; i++) mn = C[i] < mn ? C[i] : mn;
            o[0] = mn;
        }
        if (n_s0) {
            const uint64_t q = o[0];
            long lo = s0_pref[q >> 44], hi = s0_pref[(q >> 44) + 1];
            while (lo < hi) {
                long mid = (lo + hi) >> 1;
                if (s0_sorted[mid] < q) lo = mid + 1; else hi = mid;
            }
            if (lo >= n_s0 || s0_sorted[lo] != q) {
                for (long m = 1; m < s; m++) o[m] = FULL;
                continue;
            }
        }
        for (long m = 1; m < s; m++) {
            const uint64_t mult = (uint64_t)m ^ kseed;
            uint64_t mn = FULL;
            for (long i = 0; i < nk; i++) {
                uint64_t h = C[i] * mult;
                h ^= h >> 27;
                mn = h < mn ? h : mn;
            }
            o[m] = mn;
        }
    }
    delete[] X;
    delete[] Y;
    delete[] C;
}

// Threaded front end: reads are independent; halves sketch on two cores.
extern "C" void gio_sketch(
    const uint8_t* codes, long B, long stride, const long* vlen,
    long k, long s, uint64_t* out,
    long n_s0, const uint64_t* s0_sorted, const int32_t* s0_pref) {
    if (B < 64) {
        gio_sketch_range(codes, 0, B, stride, vlen, k, s, out,
                         n_s0, s0_sorted, s0_pref);
        return;
    }
    // empty range forces the one-time ROTF/ROTR table init on THIS thread
    // before both workers read it
    gio_sketch_range(codes, 0, 0, stride, vlen, k, s, out, 0, s0_sorted,
                     s0_pref);
    const long mid = B / 2;
    std::thread th([&]() {
        gio_sketch_range(codes, mid, B, stride, vlen, k, s, out,
                         n_s0, s0_sorted, s0_pref);
    });
    gio_sketch_range(codes, 0, mid, stride, vlen, k, s, out,
                     n_s0, s0_sorted, s0_pref);
    th.join();
}

// ---------------------------------------------------------------------------
// gio_find_matches: the hash-join candidate search of hash_join._find_matches
// in one pass. For each active read: polynomial prefix hashes of the read
// and its reverse complement, 4 anchor lookups (fwd/rc x full/clip-start;
// clip-end shares the full prefix), O(1) hash verification per candidate
// (interior / >=k overhang), and per-combo mini joins (<k overhangs at
// terminal-free ends, N-crossing segments, q=0 probes at path Ns) with
// wildcard byte verification. Emits matches sorted by (read, graph).
// Returns the match count, or -1 if out_cap was too small.
static inline bool gio_bverify(
    const uint8_t* var, long eff, const uint8_t* flat_codes,
    long flat_start, long plen, long pos, bool tfree) {
    long in_path = plen - pos;
    if (in_path > eff) in_path = eff;
    if (in_path < 0) in_path = 0;
    const uint8_t* path = flat_codes + flat_start + pos;
    for (long i = 0; i < in_path; i++)
        if (path[i] != var[i] && path[i] != 4) return false;
    if (in_path < eff && !tfree) return false;
    return true;
}

static long gio_fm_range(
    const uint8_t* codes, long stride, const long* lengths,
    long k,
    // combos sorted by (read, graph); only non-fallback combos passed
    long ci0, long ci1, const long* c_read, const long* c_g,
    // per-read COMPACT prefix-hash outputs [n_active, stride+2] indexed
    // via ph_row[read] (row per active read, io.native.find_matches);
    // consumed by the cascade's lazy stage-3/4 clip probes
    const int32_t* ph_row, uint64_t* phf_all, uint64_t* phr_all,
    // hash tables / path data
    const uint64_t* rpow, const uint64_t* rinv,
    const uint64_t* ph, const long* ph_start,
    const int32_t* path_len, const long* flat_start,
    const uint8_t* flat_codes,
    const uint8_t* tfree, const uint8_t* nrow, const int32_t* path_graph,
    long n_anchor, const uint64_t* anchor_hash, const int32_t* anchor_row,
    const int32_t* anchor_pos,
    long n_mini, const uint64_t* mini_hash, const int32_t* mini_row,
    const int32_t* mini_pos, const int8_t* mini_typ,
    // 16-bit-prefix bucket indexes (len 65537): search space for a key is
    // [pref[key>>48], pref[(key>>48)+1]) — one cache line instead of a
    // full-table binary search (the mini join runs 4*(k-1) lookups PER
    // COMBO; this was ~80% of gio_find_matches)
    const int32_t* anchor_pref, const int32_t* mini_pref,
    const uint64_t* len_mix, const uint64_t* g_mix,
    // q0 probes: N positions CSR by graph index
    long n_npos, const long* npos_gi, const int32_t* npos_row,
    const int32_t* npos_pos,
    long G,
    // outputs
    long* m_b, int8_t* m_var, int32_t* m_row, int32_t* m_pos,
    int64_t* m_key, long out_cap) {
    long n_out = 0;
    const long strideP = stride + 2;
    uint8_t* rc = new uint8_t[stride];
    const int rc_of[5] = {3, 2, 1, 0, 4};
    long scratch_cap = 65536;
    long* sc_var = new long[scratch_cap];
    long* sc_row = new long[scratch_cap];
    long* sc_pos = new long[scratch_cap];
    long* sc_ord = new long[scratch_cap];
    long* sc_tmp = new long[3 * scratch_cap];
    // per-read mini-join keys sans graph mix: mq[grp*k + q]
    uint64_t* mq = new uint64_t[4 * k];

    long ci = ci0;
    long overflow = 0;  // 1 = out_cap too small, 2 = per-read scratch full
    while (ci < ci1 && !overflow) {
        const long b = c_read[ci];
        long ce = ci;
        while (ce < ci1 && c_read[ce] == b) ce++;
        const long Lr = lengths[b];
        const uint8_t* cs = codes + b * stride;
        uint64_t* PHf = phf_all + (long)ph_row[b] * strideP;
        uint64_t* PHr = phr_all + (long)ph_row[b] * strideP;
        for (long i = 0; i < Lr; i++) rc[i] = rc_of[cs[Lr - 1 - i]];
        PHf[0] = 0; PHr[0] = 0;
        for (long i = 0; i < Lr; i++) {
            PHf[i + 1] = PHf[i] + (uint64_t)(cs[i] + 1) * rpow[i];
            PHr[i + 1] = PHr[i] + (uint64_t)(rc[i] + 1) * rpow[i];
        }
        const uint64_t rinv1 = rinv[1];
        // interior full-variant hashes per var 0..5
        const uint64_t vfull[6] = {
            PHf[Lr], (PHf[Lr] - PHf[1]) * rinv1, PHf[Lr - 1],
            PHr[Lr], (PHr[Lr] - PHr[1]) * rinv1, PHr[Lr - 1],
        };
        const uint64_t anch[4] = {
            PHf[k], (PHf[k + 1] - PHf[1]) * rinv1,
            PHr[k], (PHr[k + 1] - PHr[1]) * rinv1,
        };
        static const int GROUP_VARS[4][2] = {{0, 2}, {1, -1}, {3, 5}, {4, -1}};
        long n_sc = 0;
        // ---- anchor joins (full variants 0/3 only; clip variants are
        // pair-probed below) ------------------------------------------
        for (int grp = 0; grp < 4; grp += 2) {
            const uint64_t q = anch[grp];
            // lower_bound within the key's 16-bit-prefix bucket
            long lo = anchor_pref[q >> 44], hi = anchor_pref[(q >> 44) + 1];  // 20-bit buckets (io.native.PREF_BITS)
            while (lo < hi) {
                long mid = (lo + hi) >> 1;
                if (anchor_hash[mid] < q) lo = mid + 1; else hi = mid;
            }
            for (long ai = lo; ai < n_anchor && anchor_hash[ai] == q; ai++) {
                const long row = anchor_row[ai];
                const long pos = anchor_pos[ai];
                const long plen = path_len[row];
                const uint64_t* php = ph + ph_start[row];
                const uint64_t h_over =
                    (php[plen] - php[pos]) * rinv[pos];
                const long qlen = plen - pos;  // >= k
                for (int gv = 0; gv < 1; gv++) {
                    const int v = GROUP_VARS[grp][gv];
                    const long lb = Lr - (v == 0 || v == 3 ? 0 : 1);
                    bool ok;
                    if (pos + lb <= plen) {
                        const uint64_t h_int =
                            (php[pos + lb] - php[pos]) * rinv[pos];
                        ok = h_int == vfull[v];
                    } else if (tfree[row]) {
                        uint64_t vpref;
                        if (v == 0 || v == 2) vpref = PHf[qlen];
                        else if (v == 1)
                            vpref = (PHf[qlen + 1] - PHf[1]) * rinv1;
                        else if (v == 3 || v == 5) vpref = PHr[qlen];
                        else vpref = (PHr[qlen + 1] - PHr[1]) * rinv1;
                        ok = h_over == vpref;
                    } else {
                        ok = false;
                    }
                    if (!ok && nrow[row]) {
                        // wildcard path: literal hash can miss; byte check
                        const uint8_t* var =
                            (v >= 3 ? rc : cs) + (v % 3 == 1 ? 1 : 0);
                        ok = gio_bverify(
                            var, lb, flat_codes, flat_start[row], plen, pos,
                            tfree[row]);
                    }
                    if (ok && n_sc < scratch_cap) {
                        sc_var[n_sc] = v;
                        sc_row[n_sc] = row;
                        sc_pos[n_sc] = pos;
                        n_sc++;
                    }
                }
            }
        }
        // hoist the combo-invariant part of the mini-join keys
        if (n_mini)
            for (long q = 1; q < k; q++) {
                mq[0 * k + q] = PHf[q] ^ len_mix[q];
                mq[1 * k + q] = ((PHf[q + 1] - PHf[1]) * rinv1) ^ len_mix[q];
                mq[2 * k + q] = PHr[q] ^ len_mix[q];
                mq[3 * k + q] = ((PHr[q + 1] - PHr[1]) * rinv1) ^ len_mix[q];
            }
        // ---- per-combo mini joins + q0 + clip pair probes ------------
        for (long c = ci; c < ce; c++) {
            const long g = c_g[c];
            const uint64_t gmix = g_mix[g];
            if (n_mini)
                for (int grp = 0; grp < 4; grp += 2)
                    for (long q = 1; q < k; q++) {
                        const uint64_t key = mq[grp * k + q] ^ gmix;
                        long lo = mini_pref[key >> 44];
                        long hi = mini_pref[(key >> 44) + 1];
                        while (lo < hi) {
                            long mid = (lo + hi) >> 1;
                            if (mini_hash[mid] < key) lo = mid + 1;
                            else hi = mid;
                        }
                        for (long ai = lo;
                             ai < n_mini && mini_hash[ai] == key; ai++) {
                            const long row = mini_row[ai];
                            const long pos = mini_pos[ai];
                            for (int gv = 0; gv < 1; gv++) {
                                const int v = GROUP_VARS[grp][gv];
                                bool ok;
                                if (mini_typ[ai] == 0) {
                                    ok = true;  // OVER: content fully hashed
                                } else {
                                    const long lb =
                                        Lr - (v == 0 || v == 3 ? 0 : 1);
                                    const uint8_t* var =
                                        (v >= 3 ? rc : cs)
                                        + (v % 3 == 1 ? 1 : 0);
                                    ok = gio_bverify(
                                        var, lb, flat_codes,
                                        flat_start[row], path_len[row], pos,
                                        tfree[row]);
                                }
                                if (ok && n_sc < scratch_cap) {
                                    sc_var[n_sc] = v;
                                    sc_row[n_sc] = row;
                                    sc_pos[n_sc] = pos;
                                    n_sc++;
                                }
                            }
                        }
                    }
            if (n_npos) {
                // q=0 probes: starts exactly at a path N
                long lo = 0, hi = n_npos;
                while (lo < hi) {
                    long mid = (lo + hi) >> 1;
                    if (npos_gi[mid] < g) lo = mid + 1; else hi = mid;
                }
                for (long ai = lo; ai < n_npos && npos_gi[ai] == g; ai++) {
                    const long row = npos_row[ai];
                    const long pos = npos_pos[ai];
                    for (int v = 0; v < 6; v += 3) {
                        const long lb = Lr - (v == 0 || v == 3 ? 0 : 1);
                        const uint8_t* var =
                            (v >= 3 ? rc : cs) + (v % 3 == 1 ? 1 : 0);
                        if (gio_bverify(
                                var, lb, flat_codes, flat_start[row],
                                path_len[row], pos, tfree[row])
                            && n_sc < scratch_cap) {
                            sc_var[n_sc] = v;
                            sc_row[n_sc] = row;
                            sc_pos[n_sc] = pos;
                            n_sc++;
                        }
                    }
                }
            }
        }
        // ---- sort this read's matches by graph ----------------------
        {
            for (long i = 0; i < n_sc; i++) sc_ord[i] = i;
            std::stable_sort(sc_ord, sc_ord + n_sc, [&](long x, long y) {
                return path_graph[sc_row[x]] < path_graph[sc_row[y]];
            });
            for (long i = 0; i < n_sc; i++) {
                sc_tmp[i] = sc_var[sc_ord[i]];
                sc_tmp[n_sc + i] = sc_row[sc_ord[i]];
                sc_tmp[2 * n_sc + i] = sc_pos[sc_ord[i]];
            }
            memcpy(sc_var, sc_tmp, n_sc * sizeof(long));
            memcpy(sc_row, sc_tmp + n_sc, n_sc * sizeof(long));
            memcpy(sc_pos, sc_tmp + 2 * n_sc, n_sc * sizeof(long));
        }
        if (n_sc >= scratch_cap) {
            overflow = 2;
            break;
        }
        if (n_out + n_sc > out_cap) {
            overflow = 1;
            break;
        }
        for (long i = 0; i < n_sc; i++) {
            m_b[n_out] = b;
            m_var[n_out] = (int8_t)sc_var[i];
            m_row[n_out] = (int32_t)sc_row[i];
            m_pos[n_out] = (int32_t)sc_pos[i];
            m_key[n_out] = b * G + path_graph[sc_row[i]];
            n_out++;
        }
        ci = ce;
    }
    delete[] rc;
    delete[] sc_var;
    delete[] sc_row;
    delete[] sc_pos;
    delete[] sc_ord;
    delete[] sc_tmp;
    delete[] mq;
    return overflow ? -overflow : n_out;
}

// Threaded front end: combos split at a read boundary, each half searched
// on its own core (independent reads; outputs concatenated in order so the
// (read, graph) sort invariant holds). The ctypes caller releases the GIL,
// so this overlaps Python-side work too.
extern "C" long gio_find_matches(
    const uint8_t* codes, long B, long stride, const long* lengths,
    long k,
    long nc, const long* c_read, const long* c_g,
    const int32_t* ph_row, uint64_t* phf_all, uint64_t* phr_all,
    const uint64_t* rpow, const uint64_t* rinv,
    const uint64_t* ph, const long* ph_start,
    const int32_t* path_len, const long* flat_start,
    const uint8_t* flat_codes,
    const uint8_t* tfree, const uint8_t* nrow, const int32_t* path_graph,
    long n_anchor, const uint64_t* anchor_hash, const int32_t* anchor_row,
    const int32_t* anchor_pos,
    long n_mini, const uint64_t* mini_hash, const int32_t* mini_row,
    const int32_t* mini_pos, const int8_t* mini_typ,
    const int32_t* anchor_pref, const int32_t* mini_pref,
    const uint64_t* len_mix, const uint64_t* g_mix,
    long n_npos, const long* npos_gi, const int32_t* npos_row,
    const int32_t* npos_pos,
    long G,
    long* m_b, int8_t* m_var, int32_t* m_row, int32_t* m_pos,
    int64_t* m_key, long out_cap) {
    (void)B;
    long mid = nc / 2;
    // advance to a read boundary
    while (mid > 0 && mid < nc && c_read[mid] == c_read[mid - 1]) mid++;
    if (nc < 512 || mid <= 0 || mid >= nc)
        return gio_fm_range(
            codes, stride, lengths, k, 0, nc, c_read, c_g,
            ph_row, phf_all, phr_all,
            rpow, rinv, ph, ph_start, path_len, flat_start, flat_codes, tfree, nrow,
            path_graph, n_anchor, anchor_hash, anchor_row, anchor_pos,
            n_mini, mini_hash, mini_row, mini_pos, mini_typ, anchor_pref,
            mini_pref, len_mix, g_mix, n_npos, npos_gi, npos_row, npos_pos,
            G, m_b, m_var, m_row, m_pos, m_key, out_cap);
    long* t_b = new long[out_cap];
    int8_t* t_var = new int8_t[out_cap];
    int32_t* t_row = new int32_t[out_cap];
    int32_t* t_pos = new int32_t[out_cap];
    int64_t* t_key = new int64_t[out_cap];
    long n2 = 0;
    std::thread th([&]() {
        n2 = gio_fm_range(
            codes, stride, lengths, k, mid, nc, c_read, c_g,
            ph_row, phf_all, phr_all,
            rpow, rinv, ph, ph_start, path_len, flat_start, flat_codes, tfree, nrow,
            path_graph, n_anchor, anchor_hash, anchor_row, anchor_pos,
            n_mini, mini_hash, mini_row, mini_pos, mini_typ, anchor_pref,
            mini_pref, len_mix, g_mix, n_npos, npos_gi, npos_row, npos_pos,
            G, t_b, t_var, t_row, t_pos, t_key, out_cap);
    });
    long n1 = gio_fm_range(
        codes, stride, lengths, k, 0, mid, c_read, c_g,
        ph_row, phf_all, phr_all,
        rpow, rinv, ph,
        ph_start, path_len, flat_start, flat_codes, tfree, nrow, path_graph,
        n_anchor, anchor_hash, anchor_row, anchor_pos, n_mini, mini_hash,
        mini_row, mini_pos, mini_typ, anchor_pref, mini_pref, len_mix,
        g_mix, n_npos, npos_gi, npos_row, npos_pos, G, m_b, m_var, m_row,
        m_pos, m_key, out_cap);
    th.join();
    long ret;
    if (n1 < 0 || n2 < 0) {
        ret = (n1 < 0) ? n1 : n2;
    } else if (n1 + n2 > out_cap) {
        ret = -1;
    } else {
        memcpy(m_b + n1, t_b, n2 * sizeof(long));
        memcpy(m_var + n1, t_var, n2 * sizeof(int8_t));
        memcpy(m_row + n1, t_row, n2 * sizeof(int32_t));
        memcpy(m_pos + n1, t_pos, n2 * sizeof(int32_t));
        memcpy(m_key + n1, t_key, n2 * sizeof(int64_t));
        ret = n1 + n2;
    }
    delete[] t_b; delete[] t_var; delete[] t_row;
    delete[] t_pos; delete[] t_key;
    return ret;
}

// ---------------------------------------------------------------------------
// gio_window_sketch: all stride-1 window KHF sketches of padded path rows
// with run detection (index/window.py window_sketches + _change_mask).
// Per row: canonical ntHash k-mer hashes, then per sketch slot a van Herk
// sliding min over the window's m = w-k+1 k-mers; a window is emitted iff
// its sketch differs from its predecessor (run start). Returns the total
// number of run starts, or -1 if cap is too small.
extern "C" long gio_window_sketch(
    const uint8_t* codes, long R, long stride, const long* lens,
    long k, long s, long w,
    int32_t* out_row, int32_t* out_col, uint64_t* out_sk,  // [cap, s]
    long cap, long* row_counts) {
    static uint64_t ROTF[5][64], ROTR[5][64];
    static bool init = false;
    if (!init) {
        const int rc_of[5] = {3, 2, 1, 0, 4};
        for (int c = 0; c < 5; c++)
            for (int m_ = 0; m_ < 64; m_++) {
                ROTF[c][m_] = rol64(NT_SEEDS[c], (64 - m_) & 63);
                ROTR[c][m_] = rol64(NT_SEEDS[rc_of[c]], m_);
            }
        init = true;
    }
    const uint64_t kseed = (uint64_t)k * NT_MULTISEED;
    const long m = w - k + 1;
    long n_out = 0;
    uint64_t* X = new uint64_t[stride + 1];
    uint64_t* Y = new uint64_t[stride + 1];
    uint64_t* c = new uint64_t[stride];
    uint64_t* h = new uint64_t[stride + m];
    uint64_t* pref = new uint64_t[stride + m];
    uint64_t* suff = new uint64_t[stride + m];
    uint64_t* wsk = nullptr;
    long wsk_cap = 0;
    for (long r = 0; r < R; r++) {
        row_counts[r] = 0;
        const long n = lens[r];
        const long nk = n - k + 1;
        const long nw = n - w + 1;
        if (nw <= 0) continue;
        const uint8_t* cs = codes + r * stride;
        X[0] = 0; Y[0] = 0;
        for (long i = 0; i < n; i++) {
            X[i + 1] = X[i] ^ ROTF[cs[i]][i & 63];
            Y[i + 1] = Y[i] ^ ROTR[cs[i]][i & 63];
        }
        for (long i = 0; i < nk; i++) {
            const uint64_t fwd =
                rol64(X[i + k] ^ X[i], (unsigned)(i + k - 1));
            const uint64_t rev =
                rol64(Y[i + k] ^ Y[i], (unsigned)(64 - (i & 63)));
            c[i] = fwd < rev ? fwd : rev;
        }
        if (nw > wsk_cap) {
            delete[] wsk;
            wsk_cap = nw * 2;
            wsk = new uint64_t[wsk_cap * s];
        }
        const long nk_pad = ((nk + m - 1) / m) * m;
        for (long j = 0; j < s; j++) {
            if (j == 0) {
                memcpy(h, c, nk * sizeof(uint64_t));
            } else {
                const uint64_t mult = (uint64_t)j ^ kseed;
                for (long i = 0; i < nk; i++) {
                    uint64_t v = c[i] * mult;
                    h[i] = v ^ (v >> 27);
                }
            }
            for (long i = nk; i < nk_pad; i++) h[i] = ~0ULL;
            // van Herk blocks of m
            for (long b = 0; b < nk_pad; b += m) {
                pref[b] = h[b];
                for (long i = b + 1; i < b + m; i++)
                    pref[i] = h[i] < pref[i - 1] ? h[i] : pref[i - 1];
                suff[b + m - 1] = h[b + m - 1];
                for (long i = b + m - 2; i >= b; i--)
                    suff[i] = h[i] < suff[i + 1] ? h[i] : suff[i + 1];
            }
            for (long i = 0; i < nw; i++) {
                const uint64_t a = suff[i], bb = pref[i + m - 1];
                wsk[i * s + j] = a < bb ? a : bb;
            }
        }
        // run starts
        long cnt = 0;
        for (long i = 0; i < nw; i++) {
            bool start = i == 0;
            if (!start)
                start = memcmp(
                    wsk + i * s, wsk + (i - 1) * s, s * sizeof(uint64_t)
                ) != 0;
            if (start) {
                if (n_out >= cap) { n_out = -1; goto done; }
                out_row[n_out] = (int32_t)r;
                out_col[n_out] = (int32_t)i;
                memcpy(out_sk + n_out * s, wsk + i * s, s * sizeof(uint64_t));
                n_out++;
                cnt++;
            }
        }
        row_counts[r] = cnt;
    }
done:
    delete[] X; delete[] Y; delete[] c; delete[] h;
    delete[] pref; delete[] suff; delete[] wsk;
    return n_out;
}

// ---------------------------------------------------------------------------
// Device-engine collect acceleration (align/device_join.collect_pairs).
// These replace the numpy drain reduction, winner-id recovery and the
// inline stage-2 (rank x shuffle) decision — the host-side hot loops of
// the device cascade engine. Pure array passes; no allocation.

// Per-pair phase-A reduction over one seed_scan call's rows: min stage-1
// offset per orientation + clip-stage flag ORs. j1 is [n_pairs, 2] i64
// (caller-initialised to INF); s3/s4 are [n_pairs, 2] u8.
extern "C" void gio_dev_reduce(
    const int32_t* packed, const int64_t* r_pair, long n,
    int64_t* j1, uint8_t* s3, uint8_t* s4
) {
    for (long i = 0; i < n; i++) {
        const long p = r_pair[i];
        const int32_t pk = packed[i];
        const long jf = pk & 0xFF, jr = (pk >> 8) & 0xFF;
        const int fl = pk >> 16;
        if (jf != 255 && jf < j1[p * 2]) j1[p * 2] = jf;
        if (jr != 255 && jr < j1[p * 2 + 1]) j1[p * 2 + 1] = jr;
        s3[p * 2] |= fl & 1;
        s4[p * 2] |= (fl >> 1) & 1;
        s3[p * 2 + 1] |= (fl >> 2) & 1;
        s4[p * 2 + 1] |= (fl >> 3) & 1;
    }
}

// Winner-id recovery over one call's rows: for rows of winning pairs,
// emit (combo, path row, position) where the row's packed result
// matches the pair's winning (orientation, stage, offset). Returns the
// id count (cap = n is always sufficient: <= 1 id per row).
extern "C" long gio_dev_ids(
    const int32_t* packed, const int64_t* r_pair, const int32_t* r_prow,
    const int32_t* r_base, long n,
    const uint8_t* is_winner, const uint8_t* ori, const uint8_t* stage,
    const int64_t* j1pick, const int64_t* combo_of_pair,
    int64_t* out_combo, int64_t* out_row, int64_t* out_pos
) {
    long m = 0;
    for (long i = 0; i < n; i++) {
        const long p = r_pair[i];
        if (!is_winner[p]) continue;
        const int o = ori[p];
        const int st = stage[p];
        const int32_t pk = packed[i];
        const long jsel = o ? (pk >> 8) & 0xFF : pk & 0xFF;
        const int fl = pk >> 16;
        bool hit = false;
        long off = 0;
        if (st == 1) { hit = jsel == j1pick[p]; off = jsel; }
        else if (st == 3) hit = (o ? (fl >> 2) : fl) & 1;
        else if (st == 4) hit = (o ? (fl >> 3) : (fl >> 1)) & 1;
        if (hit) {
            out_combo[m] = combo_of_pair[p];
            out_row[m] = r_prow[i];
            out_pos[m] = r_base[i] + off;
            m++;
        }
    }
    return m;
}

// Inline stage-2 decision: for each selected pair, the host cascade's
// lexicographic (contained-node rank, shuffle) winner over the pair's
// candidate (path row, position) list (interior matches + overhang tail
// matches merged by the caller). First rank with any valid shuffle
// wins; min shuffle breaks ties within the rank. For every DECIDED pair
// all candidates at the winning (rank, shuffle) are emitted as ids (the
// caller filters to combo winners later). Returns the id count.
extern "C" long gio_s2_decide(
    long n_sel, const int64_t* sel_pair, const int64_t* sel_win,
    const int64_t* cand_ptr, const int64_t* cand_row,
    const int64_t* cand_pos,
    const int64_t* cn_ptr, const int32_t* cn_cnt, const int64_t* cn_grow,
    const int64_t* node_base, const int32_t* node_g,
    const int64_t* g_first_row, const int32_t* npos_dense,
    long npos_len, const int32_t* node_len, long ns,
    int64_t* best_out,
    int64_t* id_pair, int64_t* id_row, int64_t* id_pos, int64_t* id_key
) {
    long m = 0;
    for (long s = 0; s < n_sel; s++) {
        const long w = sel_win[s];
        const int nc = cn_cnt[w];
        const long c0 = cand_ptr[s], c1 = cand_ptr[s + 1];
        long best = -1, bestsh = -1;
        int bestr = -1;
        for (int r = 0; r < nc; r++) {
            const long grow = cn_grow[cn_ptr[w] + r];
            const long nb = node_base[grow];
            const long gfr = g_first_row[node_g[grow]];
            const long clen = node_len[grow];
            const long shmax = ns < clen - 1 ? ns : clen - 1;
            long minsh = -1;
            for (long c = c0; c < c1; c++) {
                const long ix = nb + cand_row[c] - gfr;
                if (ix < 0 || ix >= npos_len) continue;  // collision guard
                const long cpos = npos_dense[ix];
                if (cpos < 0) continue;
                const long sh = cand_pos[c] - cpos;
                if (sh >= 0 && sh <= shmax && (minsh < 0 || sh < minsh))
                    minsh = sh;
            }
            if (minsh >= 0) {
                bestr = r;
                bestsh = minsh;
                best = (long)r * (ns + 1) + minsh;
                break;
            }
        }
        best_out[s] = best;
        if (best < 0) continue;
        const long grow = cn_grow[cn_ptr[w] + bestr];
        const long nb = node_base[grow];
        const long gfr = g_first_row[node_g[grow]];
        for (long c = c0; c < c1; c++) {
            const long ix = nb + cand_row[c] - gfr;
            if (ix < 0 || ix >= npos_len) continue;
            const long cpos = npos_dense[ix];
            if (cpos >= 0 && cand_pos[c] - cpos == bestsh) {
                id_pair[m] = sel_pair[s];
                id_row[m] = cand_row[c];
                id_pos[m] = cand_pos[c];
                id_key[m] = best;
                m++;
            }
        }
    }
    return m;
}

// Interior stage-2 candidate enumeration: for each read, walk the
// anchor-table range of its first-k window hash (prefix16-bucketed
// binary search) and emit the TRUE full-variant interior matches
// (full-length polynomial hash equality). Returns match count, or -1 if
// cap would overflow.
extern "C" long gio_s2_enum(
    long n_reads, const uint64_t* va, const uint64_t* vfull,
    const int64_t* crl,
    long n_anchor, const uint64_t* anchor_hash,
    const int32_t* anchor_row, const int32_t* anchor_pos,
    const int32_t* apref, long pref_shift,
    const int32_t* path_len, const int64_t* ph_start,
    const uint64_t* ph, const uint64_t* rinv,
    int64_t* out_owner, int64_t* out_row, int64_t* out_pos, long cap
) {
    long m = 0;
    for (long i = 0; i < n_reads; i++) {
        const uint64_t v = va[i];
        long lo = apref[v >> pref_shift], hi = apref[(v >> pref_shift) + 1];
        // lower bound
        while (lo < hi) {
            const long mid = (lo + hi) >> 1;
            if (anchor_hash[mid] < v) lo = mid + 1; else hi = mid;
        }
        const long lb = crl[i];
        const uint64_t vf = vfull[i];
        for (long a = lo; a < n_anchor && anchor_hash[a] == v; a++) {
            const long row = anchor_row[a];
            const long pos = anchor_pos[a];
            const long plen = path_len[row];
            if (pos + lb > plen) continue;  // overhang: tail table's job
            const long s = ph_start[row];
            const uint64_t hint = (ph[s + pos + lb] - ph[s + pos])
                                  * rinv[pos];
            if (hint != vf) continue;
            if (m >= cap) return -1;
            out_owner[m] = i;
            out_row[m] = row;
            out_pos[m] = pos;
            m++;
        }
    }
    return m;
}
