/*
 * BAM decoding: BGZF inflate (libdeflate or zlib, multithreaded) + record
 * parsing into flat arrays (see instrain_io.h for the data contract).
 */
#include "instrain_io.h"

#ifdef INSTRAIN_ZLIB
#include <zlib.h>
#else
#include <libdeflate.h>
#endif

#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <chrono>
#include <thread>
#include <unordered_map>
#include <algorithm>
#include <type_traits>
#include <vector>

static thread_local std::string g_err;
extern "C" const char* bd_error(void) { return g_err.c_str(); }

namespace {

// Default-init allocator: vector<T, dinit_alloc<T>>::resize() skips the
// zero-fill. This host throttles big memory writes ~30x, so memsetting
// tens of MB of event buffers that the fill pass immediately overwrites
// dominated decode time; every rvec buffer below is fully written before
// it is read.
template <class T, class A = std::allocator<T>>
struct dinit_alloc : public A {
    template <class U>
    struct rebind {
        using other = dinit_alloc<
            U, typename std::allocator_traits<A>::template rebind_alloc<U>>;
    };
    using A::A;
    template <class U>
    void construct(U* p) noexcept(
        std::is_nothrow_default_constructible<U>::value) {
        ::new (static_cast<void*>(p)) U;
    }
    template <class U, class... Args>
    void construct(U* p, Args&&... args) {
        std::allocator_traits<A>::construct(static_cast<A&>(*this), p,
                                            std::forward<Args>(args)...);
    }
};

}  // namespace

template <class T>
using rvec = std::vector<T, dinit_alloc<T>>;

namespace {

// ---------------- BGZF ----------------

struct Block { size_t in_off; uint32_t in_len; size_t out_off; uint32_t out_len; };

bool read_file(const char* path, rvec<uint8_t>& buf) {
    FILE* f = fopen(path, "rb");
    if (!f) { g_err = std::string("cannot open ") + path; return false; }
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    buf.resize(sz);
    if (sz && fread(buf.data(), 1, sz, f) != (size_t)sz) {
        fclose(f); g_err = "short read"; return false;
    }
    fclose(f);
    return true;
}

bool bgzf_scan(const rvec<uint8_t>& in, std::vector<Block>& blocks) {
    size_t p = 0, out = 0;
    while (p + 18 <= in.size()) {
        if (in[p] != 0x1f || in[p + 1] != 0x8b) { g_err = "bad gzip magic"; return false; }
        uint16_t xlen; memcpy(&xlen, &in[p + 10], 2);
        // find BC subfield
        size_t q = p + 12, qe = q + xlen;
        uint32_t bsize = 0;
        while (q + 4 <= qe) {
            uint8_t si1 = in[q], si2 = in[q + 1];
            uint16_t slen; memcpy(&slen, &in[q + 2], 2);
            if (si1 == 66 && si2 == 67 && slen == 2) {
                uint16_t bs; memcpy(&bs, &in[q + 4], 2);
                bsize = bs + 1;
                break;
            }
            q += 4 + slen;
        }
        if (!bsize) { g_err = "missing BSIZE"; return false; }
        uint32_t isize; memcpy(&isize, &in[p + bsize - 4], 4);
        uint32_t cdata_len = bsize - xlen - 19 - 1;  // minus header(12+xlen), crc(4), isize(4)
        blocks.push_back({p + 12 + xlen, cdata_len, out, isize});
        out += isize;
        p += bsize;
    }
    return true;
}

bool bgzf_inflate(const rvec<uint8_t>& in, const std::vector<Block>& blocks,
                  rvec<uint8_t>& out, int threads) {
    size_t total = blocks.empty() ? 0 : blocks.back().out_off + blocks.back().out_len;
    out.resize(total);
    std::atomic<size_t> next{0};
    std::atomic<bool> ok{true};
#ifdef INSTRAIN_ZLIB
    auto work = [&]() {
        z_stream z{};
        if (inflateInit2(&z, -15) != Z_OK) { ok = false; return; }  // raw deflate
        for (;;) {
            size_t i = next.fetch_add(1);
            if (i >= blocks.size()) break;
            const Block& b = blocks[i];
            if (b.out_len == 0) continue;
            inflateReset(&z);
            z.next_in = const_cast<Bytef*>(in.data() + b.in_off);
            z.avail_in = b.in_len;
            z.next_out = out.data() + b.out_off;
            z.avail_out = b.out_len;
            int r = inflate(&z, Z_FINISH);
            if (r != Z_STREAM_END || z.total_out != b.out_len) ok = false;
        }
        inflateEnd(&z);
    };
#else
    auto work = [&]() {
        libdeflate_decompressor* d = libdeflate_alloc_decompressor();
        for (;;) {
            size_t i = next.fetch_add(1);
            if (i >= blocks.size()) break;
            const Block& b = blocks[i];
            if (b.out_len == 0) continue;
            size_t actual = 0;
            auto r = libdeflate_deflate_decompress(
                d, in.data() + b.in_off, b.in_len, out.data() + b.out_off,
                b.out_len, &actual);
            if (r != LIBDEFLATE_SUCCESS || actual != b.out_len) ok = false;
        }
        libdeflate_free_decompressor(d);
    };
#endif
    if (threads <= 1) {
        work();
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t) ts.emplace_back(work);
        for (auto& t : ts) t.join();
    }
    if (!ok) g_err = "bgzf inflate failure";
    return ok;
}

// ---------------- record store ----------------

enum { CMATCH = 0, CINS = 1, CDEL = 2, CREF_SKIP = 3, CSOFT = 4,
       CHARD = 5, CPAD = 6, CEQUAL = 7, CDIFF = 8 };
static inline int cg_op(uint32_t c) { return c & 0xf; }
static inline int64_t cg_len(uint32_t c) { return c >> 4; }

// BAM 4-bit seq nibble -> base code (A0 C1 T2 G3 other 4)
// nibble order: =ACMGRSVTWYHKDBN
static const uint8_t NIB2CODE[16] = {4, 0, 1, 4, 3, 4, 4, 4,
                                     2, 4, 4, 4, 4, 4, 4, 4};

}  // namespace

struct BamData {
    std::vector<std::string> ref_names;
    std::vector<int64_t> ref_lens;

    std::vector<int32_t> ref_id;
    std::vector<int32_t> pos;
    std::vector<uint16_t> flag;
    std::vector<uint8_t> mapq;
    std::vector<int32_t> nm;
    std::vector<int64_t> qname_id;
    std::vector<int32_t> qlen_infer;
    std::vector<int32_t> ref_start;
    std::vector<int32_t> ref_end;
    // mate fields, needed by the overlap-tweak eligibility rules
    // (htslib overlap_push; see bd_tweak_overlaps_ex)
    std::vector<int32_t> tlen;
    std::vector<int32_t> mate_pos;
    std::vector<int32_t> mate_ref;
    std::vector<int64_t> ev_off;
    std::vector<int32_t> ev_len;
    std::vector<uint8_t> pileup_ok;

    rvec<int32_t> ev_pos;
    rvec<uint8_t> ev_base;
    rvec<uint8_t> ev_qual;

    std::string qname_blob;
    std::vector<int64_t> qname_off;

    // retained for BAQ: per-record cigar + full seq codes + quals
    rvec<uint32_t> cig_buf;
    std::vector<int64_t> cig_off;
    std::vector<int32_t> cig_n;
    rvec<uint8_t> seq_buf;   // full query codes
    rvec<uint8_t> qual_buf;  // full query quals
    std::vector<int64_t> seq_off;
    std::vector<int32_t> seq_len;

    // per-ref record ranges (records are coordinate-sorted within ref)
    std::vector<int64_t> ref_rec_begin, ref_rec_end;
};

static void sort_records(BamData* h);

/*
 * Re-derive each event's query-base index by walking the record's cigar
 * (events are emitted in cigar order, so qpos is reconstructable and is
 * not stored — the fill pass is write-bandwidth-bound on this host).
 * Calls f(event_index_within_record, qpos) for every aligned base.
 */
template <class F>
static void walk_event_qpos(const BamData* h, int64_t r, F&& f) {
    const uint32_t* cig = &h->cig_buf[h->cig_off[r]];
    int32_t n = h->cig_n[r];
    int64_t y = 0;
    int32_t j = 0;
    for (int32_t k = 0; k < n; ++k) {
        int op = cg_op(cig[k]);
        int64_t l = cg_len(cig[k]);
        if (op == CMATCH || op == CEQUAL || op == CDIFF) {
            for (int64_t i = 0; i < l; ++i) f(j++, (int32_t)(y + i));
            y += l;
        } else if (op == CINS || op == CSOFT) {
            y += l;
        }
    }
}

static int32_t parse_nm_tag(const uint8_t* p, const uint8_t* end) {
    while (p + 3 <= end) {
        char t0 = p[0], t1 = p[1], typ = p[2];
        p += 3;
        int64_t val = 0;
        size_t sz = 0;
        switch (typ) {
            case 'A': sz = 1; break;
            case 'c': sz = 1; val = *(const int8_t*)p; break;
            case 'C': sz = 1; val = *(const uint8_t*)p; break;
            case 's': sz = 2; { int16_t v; memcpy(&v, p, 2); val = v; } break;
            case 'S': sz = 2; { uint16_t v; memcpy(&v, p, 2); val = v; } break;
            case 'i': sz = 4; { int32_t v; memcpy(&v, p, 4); val = v; } break;
            case 'I': sz = 4; { uint32_t v; memcpy(&v, p, 4); val = v; } break;
            case 'f': sz = 4; break;
            case 'Z': case 'H': {
                const uint8_t* e = (const uint8_t*)memchr(p, 0, end - p);
                if (!e) return -1;
                sz = e - p + 1;
                break;
            }
            case 'B': {
                char st = (char)p[0];
                uint32_t cnt; memcpy(&cnt, p + 1, 4);
                size_t esz = (st == 'c' || st == 'C') ? 1
                            : (st == 's' || st == 'S') ? 2 : 4;
                sz = 5 + (size_t)cnt * esz;
                break;
            }
            default: return -1;
        }
        if (t0 == 'N' && t1 == 'M' &&
            (typ == 'c' || typ == 'C' || typ == 's' || typ == 'S' ||
             typ == 'i' || typ == 'I'))
            return (int32_t)val;
        p += sz;
    }
    return -1;
}

// Set INSTRAIN_IO_TIMING=1 to print per-phase decode timings to stderr.
static bool timing_on() {
    static int v = -1;
    if (v < 0) {
        const char* e = getenv("INSTRAIN_IO_TIMING");
        v = (e && *e && *e != '0') ? 1 : 0;
    }
    return v == 1;
}

extern "C" BamData* bd_open(const char* path, int threads) {
    auto tick = std::chrono::steady_clock::now();
    auto lap = [&tick](const char* what) {
        if (!timing_on()) return;
        auto now = std::chrono::steady_clock::now();
        fprintf(stderr, "[bd_open] %-10s %.1f ms\n", what,
                std::chrono::duration<double, std::milli>(now - tick).count());
        tick = now;
    };
    rvec<uint8_t> raw;
    if (!read_file(path, raw)) return nullptr;
    lap("read");

    rvec<uint8_t> data;
    if (raw.size() >= 4 && raw[0] == 0x1f && raw[1] == 0x8b) {
        std::vector<Block> blocks;
        if (!bgzf_scan(raw, blocks)) return nullptr;
        if (!bgzf_inflate(raw, blocks, data, threads)) return nullptr;
        raw.clear(); raw.shrink_to_fit();
    } else {
        data = std::move(raw);  // uncompressed BAM
    }
    lap("inflate");

    if (data.size() < 12 || memcmp(data.data(), "BAM\1", 4) != 0) {
        g_err = "not a BAM file";
        return nullptr;
    }

    auto h = new BamData();
    // sizes are computed exactly by the count pass below - no reserves
    size_t p = 4;
    int32_t l_text; memcpy(&l_text, &data[p], 4); p += 4 + l_text;
    int32_t n_ref; memcpy(&n_ref, &data[p], 4); p += 4;
    for (int i = 0; i < n_ref; ++i) {
        int32_t l_name; memcpy(&l_name, &data[p], 4); p += 4;
        h->ref_names.emplace_back((const char*)&data[p], l_name - 1);
        p += l_name;
        int32_t l_ref; memcpy(&l_ref, &data[p], 4); p += 4;
        h->ref_lens.push_back(l_ref);
    }
    h->ref_rec_begin.assign(n_ref, -1);
    h->ref_rec_end.assign(n_ref, -1);

    // ---- parallel record parse ----
    // Pass 0 (serial): record boundaries.
    std::vector<size_t> roff;
    roff.reserve(data.size() / 256 + 64);
    {
        size_t q = p;
        while (q + 4 <= data.size()) {
            int32_t bs; memcpy(&bs, &data[q], 4);
            if (q + 4 + (size_t)bs > data.size()) break;
            roff.push_back(q);
            q += 4 + (size_t)bs;
        }
    }
    const int64_t nrec_raw = (int64_t)roff.size();
    lap("bounds");
    int T = threads;
    if (T < 1) T = 1;
    int hw = (int)std::thread::hardware_concurrency();
    if (hw >= 1 && T > hw) T = hw;
    if (T > 16) T = 16;
    if (nrec_raw < 4096) T = 1;
    const int64_t per = (nrec_raw + T - 1) / T;

    // Pass 1 (parallel): per-chunk kept-record / event / cigar / seq
    // tallies under the same skip rules as the fill pass.
    struct ChunkSz { int64_t rec = 0, ev = 0, cig = 0, seq = 0; };
    std::vector<ChunkSz> szs(T);
    auto count_work = [&](int t) {
        int64_t lo = t * per, hi = std::min(nrec_raw, (t + 1) * per);
        ChunkSz s;
        for (int64_t r = lo; r < hi; ++r) {
            const uint8_t* rec = &data[roff[r] + 4];
            int32_t refID, l_seq;
            memcpy(&refID, rec + 0, 4);
            uint8_t l_rn = rec[8];
            uint16_t n_cig, fl;
            memcpy(&n_cig, rec + 12, 2);
            memcpy(&fl, rec + 14, 2);
            memcpy(&l_seq, rec + 16, 4);
            if (refID < 0 || (fl & 0x4)) continue;
            const uint32_t* cig = (const uint32_t*)(rec + 32 + l_rn);
            int64_t ev = 0;
            for (int k = 0; k < n_cig; ++k) {
                int op = cg_op(cig[k]);
                if (op == CMATCH || op == CEQUAL || op == CDIFF)
                    ev += cg_len(cig[k]);
            }
            if (ev == 0) continue;  // no aligned bases: dropped
            s.rec += 1; s.ev += ev; s.cig += n_cig; s.seq += l_seq;
        }
        szs[t] = s;
    };
    if (T == 1) count_work(0);
    else {
        std::vector<std::thread> ts;
        for (int t = 0; t < T; ++t) ts.emplace_back(count_work, t);
        for (auto& t : ts) t.join();
    }
    lap("count");

    std::vector<ChunkSz> base(T + 1);
    for (int t = 0; t < T; ++t) {
        base[t + 1].rec = base[t].rec + szs[t].rec;
        base[t + 1].ev = base[t].ev + szs[t].ev;
        base[t + 1].cig = base[t].cig + szs[t].cig;
        base[t + 1].seq = base[t].seq + szs[t].seq;
    }
    const int64_t NR = base[T].rec, NE = base[T].ev;
    const int64_t NC = base[T].cig, NS = base[T].seq;

    h->ev_pos.resize(NE); h->ev_base.resize(NE);
    h->ev_qual.resize(NE);
    h->seq_buf.resize(NS); h->qual_buf.resize(NS);
    h->cig_buf.resize(NC);
    for (auto* v32 : {&h->ref_id, &h->pos, &h->nm, &h->qlen_infer,
                      &h->ref_start, &h->ref_end, &h->ev_len, &h->cig_n,
                      &h->seq_len, &h->tlen, &h->mate_pos, &h->mate_ref})
        v32->resize(NR);
    h->flag.resize(NR); h->mapq.resize(NR); h->pileup_ok.resize(NR);
    for (auto* v64 : {&h->qname_id, &h->ev_off, &h->cig_off, &h->seq_off})
        v64->resize(NR);
    std::vector<std::pair<const char*, uint32_t>> qview(NR);
    lap("alloc");

    // Pass 2 (parallel): full parse, writing at chunk base offsets.
    auto fill_work = [&](int t) {
        int64_t lo = t * per, hi = std::min(nrec_raw, (t + 1) * per);
        int64_t ri = base[t].rec, ei = base[t].ev;
        int64_t ci = base[t].cig, si = base[t].seq;
        for (int64_t r = lo; r < hi; ++r) {
            size_t off = roff[r];
            int32_t block_size; memcpy(&block_size, &data[off], 4);
            const uint8_t* rec = &data[off + 4];

            int32_t refID, rpos, l_seq;
            memcpy(&refID, rec + 0, 4);
            memcpy(&rpos, rec + 4, 4);
            uint8_t l_rn = rec[8], mq = rec[9];
            uint16_t n_cig, fl;
            memcpy(&n_cig, rec + 12, 2);
            memcpy(&fl, rec + 14, 2);
            memcpy(&l_seq, rec + 16, 4);
            if (refID < 0 || (fl & 0x4)) continue;

            const char* qname = (const char*)(rec + 32);
            const uint32_t* cig = (const uint32_t*)(rec + 32 + l_rn);
            const uint8_t* seq = rec + 32 + l_rn + 4 * (size_t)n_cig;
            const uint8_t* qual = seq + (l_seq + 1) / 2;
            const uint8_t* tags = qual + l_seq;
            const uint8_t* rec_end = rec + block_size;

            int64_t ev0 = ei;
            int64_t x = rpos, y = 0;
            int32_t qlen = 0, rstart = -1, rend = -1;
            for (int k = 0; k < n_cig; ++k) {
                int op = cg_op(cig[k]);
                int64_t l = cg_len(cig[k]);
                if (op == CMATCH || op == CEQUAL || op == CDIFF) {
                    for (int64_t j = 0; j < l; ++j) {
                        int64_t qi = y + j;
                        uint8_t nib = (qi & 1) ? (seq[qi >> 1] & 0xf)
                                               : (seq[qi >> 1] >> 4);
                        h->ev_pos[ei] = (int32_t)(x + j);
                        h->ev_base[ei] = NIB2CODE[nib];
                        h->ev_qual[ei] = qual[qi] == 0xff ? 0 : qual[qi];
                        ++ei;
                    }
                    if (rstart < 0) rstart = (int32_t)x;
                    rend = (int32_t)(x + l - 1);
                    x += l; y += l; qlen += l;
                } else if (op == CINS || op == CSOFT) {
                    y += l; qlen += l;
                } else if (op == CDEL || op == CREF_SKIP) {
                    x += l;
                }
            }
            if (rstart < 0) { ei = ev0; continue; }

            qview[ri] = {qname, l_rn > 0 ? (uint32_t)(l_rn - 1) : 0};
            h->ref_id[ri] = refID;
            h->pos[ri] = rpos;
            h->flag[ri] = fl;
            h->mapq[ri] = mq;
            memcpy(&h->mate_ref[ri], rec + 20, 4);
            memcpy(&h->mate_pos[ri], rec + 24, 4);
            memcpy(&h->tlen[ri], rec + 28, 4);
            h->nm[ri] = parse_nm_tag(tags, rec_end);
            h->qlen_infer[ri] = qlen;
            h->ref_start[ri] = rstart;
            h->ref_end[ri] = rend;
            h->ev_off[ri] = ev0;
            h->ev_len[ri] = (int32_t)(ei - ev0);
            bool orphan = (fl & 0x1) && !(fl & 0x2);
            h->pileup_ok[ri] = orphan ? 0 : 1;

            h->cig_off[ri] = ci;
            h->cig_n[ri] = n_cig;
            memcpy(&h->cig_buf[ci], cig, 4 * (size_t)n_cig);
            ci += n_cig;
            h->seq_off[ri] = si;
            h->seq_len[ri] = l_seq;
            for (int64_t qi = 0; qi < l_seq; ++qi) {
                uint8_t nib = (qi & 1) ? (seq[qi >> 1] & 0xf)
                                       : (seq[qi >> 1] >> 4);
                h->seq_buf[si] = NIB2CODE[nib];
                h->qual_buf[si] = qual[qi] == 0xff ? 0 : qual[qi];
                ++si;
            }
            ++ri;
        }
    };
    if (T == 1) fill_work(0);
    else {
        std::vector<std::thread> ts;
        for (int t = 0; t < T; ++t) ts.emplace_back(fill_work, t);
        for (auto& t : ts) t.join();
    }
    lap("fill");

    // Pass 3 (serial): qname intern in record order + per-ref spans.
    std::unordered_map<std::string, int64_t> qmap;
    qmap.reserve((size_t)NR);
    std::string qn;
    for (int64_t r = 0; r < NR; ++r) {
        qn.assign(qview[r].first, qview[r].second);
        auto it = qmap.find(qn);
        int64_t qid;
        if (it == qmap.end()) {
            qid = (int64_t)qmap.size();
            qmap.emplace(qn, qid);
            h->qname_off.push_back((int64_t)h->qname_blob.size());
            h->qname_blob += qn;
            h->qname_blob += '\0';
        } else {
            qid = it->second;
        }
        h->qname_id[r] = qid;
        int32_t refID = h->ref_id[r];
        if (h->ref_rec_begin[refID] < 0) h->ref_rec_begin[refID] = r;
        h->ref_rec_end[refID] = r + 1;
    }
    lap("qnames");
    // Detect non-coordinate-sorted input (pos decreasing within a ref, or
    // a ref's records interleaved with another's) and sort the record
    // table natively — the reference auto-sorts any unsorted input via
    // samtools (samtools_ops.py:13-67); every downstream pass here
    // assumes per-ref contiguous, position-ascending records.
    {
        bool sorted = true;
        // position must ascend within same-ref runs...
        for (int64_t r = 1; r < NR && sorted; ++r)
            if (h->ref_id[r] == h->ref_id[r - 1] &&
                h->pos[r] < h->pos[r - 1])
                sorted = false;
        // ...and each ref's [begin, end) span must be pure (interleaved
        // refs leave foreign records inside another ref's span)
        for (size_t ref = 0; ref < h->ref_names.size() && sorted; ++ref) {
            int64_t beg = h->ref_rec_begin[ref], end = h->ref_rec_end[ref];
            if (beg < 0) continue;
            for (int64_t r = beg; r < end && sorted; ++r)
                if (h->ref_id[r] != (int32_t)ref) sorted = false;
        }
        if (!sorted) sort_records(h);
    }
    lap("sortcheck");
    return h;
}

extern "C" void bd_free(BamData* h) { delete h; }

extern "C" void bd_apply_baq(BamData* h, int32_t ref_id,
                             const uint8_t* ref_seq, int64_t len) {
    // ref_seq is ASCII; convert to codes once
    std::vector<uint8_t> codes(len);
    for (int64_t i = 0; i < len; ++i) {
        switch (ref_seq[i]) {
            case 'A': codes[i] = 0; break;
            case 'C': codes[i] = 1; break;
            case 'T': codes[i] = 2; break;
            case 'G': codes[i] = 3; break;
            default: codes[i] = 4;
        }
    }
    int64_t beg = h->ref_rec_begin[ref_id], end = h->ref_rec_end[ref_id];
    if (beg < 0) return;

    std::atomic<int64_t> next{beg};
    int nthreads = (int)std::thread::hardware_concurrency();
    if (nthreads > 16) nthreads = 16;
    if (nthreads < 1) nthreads = 1;
    auto work = [&]() {
        std::vector<uint8_t> outq;
        for (;;) {
            int64_t r = next.fetch_add(1);
            if (r >= end) break;
            if (h->ref_id[r] != ref_id) continue;
            int l_qseq = h->seq_len[r];
            if (l_qseq <= 0) continue;
            outq.resize(l_qseq);
            const uint8_t* scodes = &h->seq_buf[h->seq_off[r]];
            const uint8_t* squal = &h->qual_buf[h->seq_off[r]];
            int rc = bd_baq_one(codes.data(), len, h->pos[r],
                                &h->cig_buf[h->cig_off[r]], h->cig_n[r],
                                scodes, squal, l_qseq, outq.data());
            if (rc != 0) continue;
            // persist to qual_buf (so overlap tweaking sees BAQ'd quals,
            // matching the BAQ-then-tweak pileup order) and to events
            memcpy(&h->qual_buf[h->seq_off[r]], outq.data(), l_qseq);
            int64_t e0 = h->ev_off[r];
            walk_event_qpos(h, r, [&](int32_t j, int32_t qi) {
                h->ev_qual[e0 + j] = outq[qi];
            });
        }
    };
    std::vector<std::thread> ts;
    for (int t = 1; t < nthreads; ++t) ts.emplace_back(work);
    work();
    for (auto& t : ts) t.join();
}

namespace {

/*
 * Emulation of the htslib (<= 1.11) overlap-removal cigar walk, including
 * its op-boundary desync quirk: when the walk exits an M run it advances to
 * the next op WITHOUT consuming that run's final base, so columns at M-run
 * boundaries (and the read's final base when the cigar ends in M after an
 * indel) are never tweaked. The reference's pileups ran through pysam
 * builds bundling that htslib, so golden outputs bake this behavior in.
 */
struct CigWalk {
    const uint32_t* cig;
    const uint32_t* cig_end;
    int64_t icig = 0, iseq = 0, iref = 0;

    // position at ref offset `target` (relative to read start);
    // returns <0 if no aligned base at/after target.
    int set(int64_t target) {
        int64_t pos = target;
        if (pos < 0) { iref = -1; return -1; }
        icig = iseq = iref = 0;
        while (cig < cig_end) {
            int op = *cig & 0xf;
            int64_t n = *cig >> 4;
            if (op == CSOFT) { ++cig; iseq += n; icig = 0; continue; }
            if (op == CHARD || op == CPAD) { ++cig; icig = 0; continue; }
            if (op == CMATCH || op == CEQUAL || op == CDIFF) {
                pos -= n;
                if (pos < 0) {
                    icig = n + pos; iseq += icig; iref += icig;
                    return 0;
                }
                ++cig; iseq += n; iref += n; icig = 0; continue;
            }
            if (op == CINS) { ++cig; iseq += n; icig = 0; continue; }
            if (op == CDEL || op == CREF_SKIP) {
                pos -= n;
                if (pos < 0) pos = 0;
                ++cig; iref += n; icig = 0; continue;
            }
            return -2;
        }
        iref = -1;
        return -1;
    }

    int next() {
        while (cig < cig_end) {
            int op = *cig & 0xf;
            int64_t n = *cig >> 4;
            if (op == CMATCH || op == CEQUAL || op == CDIFF) {
                if (icig >= n - 1) { ++cig; icig = 0; continue; }
                ++iseq; ++icig; ++iref;
                return 0;
            }
            if (op == CSOFT || op == CINS) { ++cig; icig = 0; iseq += n; continue; }
            if (op == CHARD || op == CPAD) { ++cig; icig = 0; continue; }
            if (op == CDEL || op == CREF_SKIP) { ++cig; icig = 0; iref += n; continue; }
            return -2;
        }
        iref = -1;
        return -1;
    }
};

}  // namespace

static void tweak_pair_htslib(BamData* h, int64_t a, int64_t b,
                              uint8_t* qual_a, uint8_t* qual_b) {
    CigWalk wa{&h->cig_buf[h->cig_off[a]],
               &h->cig_buf[h->cig_off[a]] + h->cig_n[a]};
    CigWalk wb{&h->cig_buf[h->cig_off[b]],
               &h->cig_buf[h->cig_off[b]] + h->cig_n[b]};
    const uint8_t* seq_a = &h->seq_buf[h->seq_off[a]];
    const uint8_t* seq_b = &h->seq_buf[h->seq_off[b]];
    int64_t pos_a = h->pos[a], pos_b = h->pos[b];

    int64_t iref = pos_b;  // overlap starts at the second read's start
    int a_ret = wa.set(iref - pos_a);
    if (a_ret < 0) return;
    int b_ret = wb.set(iref - pos_b);
    if (b_ret < 0) return;

    while (true) {
        while (wa.iref >= 0 && wa.iref < iref - pos_a) a_ret = wa.next();
        if (a_ret < 0) break;
        if (iref < wa.iref + pos_a) iref = wa.iref + pos_a;
        while (wb.iref >= 0 && wb.iref < iref - pos_b) b_ret = wb.next();
        if (b_ret < 0) break;
        if (iref < wb.iref + pos_b) iref = wb.iref + pos_b;
        ++iref;
        if (wa.iref + pos_a != wb.iref + pos_b) continue;

        int64_t ia = wa.iseq, ib = wb.iseq;
        if (ia < 0 || ia >= h->seq_len[a] || ib < 0 || ib >= h->seq_len[b])
            break;
        if (seq_a[ia] == seq_b[ib]) {
            int q = qual_a[ia] + qual_b[ib];
            qual_a[ia] = q > 200 ? 200 : (uint8_t)q;
            qual_b[ib] = 0;
        } else {
            if (qual_a[ia] >= qual_b[ib]) {
                qual_a[ia] = (uint8_t)(0.8 * qual_a[ia]);
                qual_b[ib] = 0;
            } else {
                qual_b[ib] = (uint8_t)(0.8 * qual_b[ib]);
                qual_a[ia] = 0;
            }
        }
    }
}

static void refresh_events(BamData* h, int64_t r) {
    int64_t e0 = h->ev_off[r];
    const uint8_t* q = &h->qual_buf[h->seq_off[r]];
    walk_event_qpos(h, r, [&](int32_t j, int32_t qi) {
        h->ev_qual[e0 + j] = q[qi];
    });
}

extern "C" void bd_tweak_overlaps_ex(BamData* h, int include_orphans,
                                     int legacy_walk);
extern "C" void bd_tweak_overlaps(BamData* h) {
    bd_tweak_overlaps_ex(h, 0, 1);
}
extern "C" void bd_tweak_overlaps_ex(BamData* h, int include_orphans,
                                     int legacy_walk) {
    /* Mate-overlap double-count removal, per qname within each ref:
     * agreeing bases concentrate quality on the first-encountered mate and
     * zero the second; on disagreement the higher-quality base survives at
     * 0.8x quality. Matching the observed reference behavior, non-proper
     * pairs ("orphans") are not tweaked unless include_orphans is set.
     *
     * Eligibility mirrors htslib's overlap_push "no overlap possible"
     * early-out. legacy_walk selects the htslib <= 1.9 form, which skips
     * a RECORD whenever |tlen| >= 2*l_qseq — so pairs of short (trimmed)
     * reads with a long template are never tweaked even when they DO
     * overlap; later htslib refined it to
     * (mtid != tid) || (|tlen| >= 2*l_qseq && mpos >= pos + l_qseq).
     * The reference's golden profiles were built on the legacy form:
     * with it (plus the legacy walk quirk below) the sars golden covT
     * reproduces bit-exactly at every (mm, position)
     * (tests/test_sitestats.py::TestSarsGolden). Reference pileup call:
     * profile/profile_utilities.py:150-153. */
    // pair discovery is a cheap serial hash scan; the per-pair quality
    // rewrites touch disjoint records, so they run in parallel
    std::vector<std::pair<int64_t, int64_t>> pairs;
    std::unordered_map<int64_t, int64_t> first_rec;  // qname_id -> record
    size_t nref = h->ref_names.size();
    for (size_t ref = 0; ref < nref; ++ref) {
        int64_t beg = h->ref_rec_begin[ref], end = h->ref_rec_end[ref];
        if (beg < 0) continue;
        first_rec.clear();
        for (int64_t r = beg; r < end; ++r) {
            if (h->ref_id[r] != (int32_t)ref) continue;
            uint16_t fl = h->flag[r];
            if (!(fl & 0x1)) continue;          // unpaired
            if (fl & 0x8) continue;             // mate unmapped
            if (fl & 0x900) continue;           // secondary/supplementary
            if (!include_orphans && !(fl & 0x2)) continue;  // orphan
            int64_t atl = h->tlen[r] < 0 ? -(int64_t)h->tlen[r]
                                         : (int64_t)h->tlen[r];
            if (legacy_walk) {
                if (atl >= 2 * (int64_t)h->seq_len[r]) continue;
            } else {
                if ((h->mate_ref[r] >= 0 && h->mate_ref[r] != (int32_t)ref) ||
                    (atl >= 2 * (int64_t)h->seq_len[r] &&
                     h->mate_pos[r] >= (int64_t)h->pos[r] + h->seq_len[r]))
                    continue;
            }
            auto it = first_rec.find(h->qname_id[r]);
            if (it == first_rec.end()) {
                // htslib only parks a read whose mate is still to arrive
                if (h->mate_pos[r] >= h->pos[r] ||
                    ((fl & 0x1) && h->mate_pos[r] == -1))
                    first_rec.emplace(h->qname_id[r], r);
                continue;
            }
            pairs.emplace_back(it->second, r);
            first_rec.erase(it);
        }
    }
    int T = (int)std::thread::hardware_concurrency();
    if (T > 8) T = 8;
    if (T < 1 || (int64_t)pairs.size() < 2048) T = 1;
    size_t perT = (pairs.size() + T - 1) / T;
    auto work = [&](int t) {
        size_t lo = t * perT, hi = std::min(pairs.size(), (t + 1) * perT);
        for (size_t i = lo; i < hi; ++i) {
            int64_t a = pairs[i].first, b = pairs[i].second;
            tweak_pair_htslib(h, a, b, &h->qual_buf[h->seq_off[a]],
                              &h->qual_buf[h->seq_off[b]]);
            refresh_events(h, a);
            refresh_events(h, b);
        }
    };
    if (T == 1) work(0);
    else {
        std::vector<std::thread> ts;
        for (int t = 0; t < T; ++t) ts.emplace_back(work, t);
        for (auto& t : ts) t.join();
    }
}

// ---- accessors ----
extern "C" {
int64_t bd_n_refs(BamData* h) { return (int64_t)h->ref_names.size(); }
const char* bd_ref_name(BamData* h, int64_t i) { return h->ref_names[i].c_str(); }
int64_t bd_ref_len(BamData* h, int64_t i) { return h->ref_lens[i]; }
int64_t bd_n_records(BamData* h) { return (int64_t)h->ref_id.size(); }
const int32_t* bd_rec_ref_id(BamData* h) { return h->ref_id.data(); }
const int32_t* bd_rec_pos(BamData* h) { return h->pos.data(); }
const uint16_t* bd_rec_flag(BamData* h) { return h->flag.data(); }
const uint8_t* bd_rec_mapq(BamData* h) { return h->mapq.data(); }
const int32_t* bd_rec_nm(BamData* h) { return h->nm.data(); }
const int64_t* bd_rec_qname_id(BamData* h) { return h->qname_id.data(); }
const int32_t* bd_rec_qlen_infer(BamData* h) { return h->qlen_infer.data(); }
const int32_t* bd_rec_ref_start(BamData* h) { return h->ref_start.data(); }
const int32_t* bd_rec_ref_end(BamData* h) { return h->ref_end.data(); }
const int32_t* bd_rec_tlen(BamData* h) { return h->tlen.data(); }
const int32_t* bd_rec_mate_pos(BamData* h) { return h->mate_pos.data(); }
const int32_t* bd_rec_mate_ref(BamData* h) { return h->mate_ref.data(); }
const int64_t* bd_rec_ev_off(BamData* h) { return h->ev_off.data(); }
const int32_t* bd_rec_ev_len(BamData* h) { return h->ev_len.data(); }
const uint8_t* bd_rec_pileup_ok(BamData* h) { return h->pileup_ok.data(); }
int64_t bd_n_events(BamData* h) { return (int64_t)h->ev_pos.size(); }
const int32_t* bd_ev_pos(BamData* h) { return h->ev_pos.data(); }
const uint8_t* bd_ev_base(BamData* h) { return h->ev_base.data(); }
const uint8_t* bd_ev_qual(BamData* h) { return h->ev_qual.data(); }
int64_t bd_n_qnames(BamData* h) { return (int64_t)h->qname_off.size(); }
const char* bd_qname_blob(BamData* h) { return h->qname_blob.data(); }
int64_t bd_qname_blob_len(BamData* h) { return (int64_t)h->qname_blob.size(); }
const int64_t* bd_qname_off(BamData* h) { return h->qname_off.data(); }
}

/*
 * Dense pileup-count construction, entirely in native memory: one pass
 * over the decoder's event stream scattering qual>=30 ACTG bases of
 * filtered pairs into counts[n_mm, 4, L]. Replaces a chain of large numpy
 * temporaries (index expansion + repeat + unique + bincount).
 */
extern "C" int64_t bd_build_counts(BamData* h, int32_t ref_id,
                                   const int32_t* qid2mmidx, int32_t n_mm,
                                   int64_t L, int32_t* out_counts,
                                   uint8_t min_qual) {
    int64_t beg = h->ref_rec_begin[ref_id], end = h->ref_rec_end[ref_id];
    if (beg < 0) return 0;
    int64_t n_events = 0;
    for (int64_t r = beg; r < end; ++r) {
        if (h->ref_id[r] != ref_id) continue;
        int32_t mi = qid2mmidx[h->qname_id[r]];
        if (mi < 0) continue;
        int64_t e0 = h->ev_off[r];
        int64_t e1 = e0 + h->ev_len[r];
        int64_t base_off = (int64_t)mi * 4 * L;
        for (int64_t e = e0; e < e1; ++e) {
            uint8_t b = h->ev_base[e];
            if (b >= 4 || h->ev_qual[e] < min_qual) continue;
            int64_t p = h->ev_pos[e];
            if (p < 0 || p >= L) continue;
            ++out_counts[base_off + (int64_t)b * L + p];
            ++n_events;
        }
    }
    return n_events;
}

/*
 * Padded int16 variant of bd_build_counts: scatters directly into a
 * device-transfer-ready tensor [n_kept_mm, 4, Lp] (position stride Lp,
 * caller allocates for n_mm levels), dropping mm levels with no counted
 * bases in the same pass. This removes the host-side padding copy and the
 * per-level numpy reduction, and halves the host->device transfer vs
 * int32 — the transfer link is the profiling bottleneck on this platform.
 *
 * level_events[n_mm] (out): counted events per original level.
 * level_map[n_mm] (out): original level -> kept index, or -1 if dropped.
 * Returns the number of kept levels, or -1 if any cell would overflow
 * int16 (caller falls back to the int32 path).
 */
extern "C" int32_t bd_build_counts16(BamData* h, int32_t ref_id,
                                     const int32_t* qid2mmidx, int32_t n_mm,
                                     int64_t L, int64_t Lp,
                                     int16_t* out_counts,
                                     int64_t* level_events,
                                     int32_t* level_map, uint8_t min_qual) {
    for (int32_t i = 0; i < n_mm; ++i) { level_events[i] = 0; level_map[i] = -1; }
    int64_t beg = h->ref_rec_begin[ref_id], end = h->ref_rec_end[ref_id];
    if (beg < 0) return 0;
    /* pass 1: events per level (decides which levels survive) */
    for (int64_t r = beg; r < end; ++r) {
        if (h->ref_id[r] != ref_id) continue;
        int32_t mi = qid2mmidx[h->qname_id[r]];
        if (mi < 0) continue;
        int64_t e0 = h->ev_off[r];
        int64_t e1 = e0 + h->ev_len[r];
        int64_t n = 0;
        for (int64_t e = e0; e < e1; ++e) {
            uint8_t b = h->ev_base[e];
            if (b >= 4 || h->ev_qual[e] < min_qual) continue;
            int64_t p = h->ev_pos[e];
            if (p < 0 || p >= L) continue;
            ++n;
        }
        level_events[mi] += n;
    }
    int32_t kept = 0;
    for (int32_t i = 0; i < n_mm; ++i)
        if (level_events[i] > 0) level_map[i] = kept++;
    if (kept == 0) return 0;
    /* pass 2: scatter with remapped levels + overflow detection */
    for (int64_t r = beg; r < end; ++r) {
        if (h->ref_id[r] != ref_id) continue;
        int32_t mi = qid2mmidx[h->qname_id[r]];
        if (mi < 0) continue;
        int32_t mk = level_map[mi];
        if (mk < 0) continue;
        int64_t base_off = (int64_t)mk * 4 * Lp;
        int64_t e0 = h->ev_off[r];
        int64_t e1 = e0 + h->ev_len[r];
        for (int64_t e = e0; e < e1; ++e) {
            uint8_t b = h->ev_base[e];
            if (b >= 4 || h->ev_qual[e] < min_qual) continue;
            int64_t p = h->ev_pos[e];
            if (p < 0 || p >= L) continue;
            int16_t* cell = &out_counts[base_off + (int64_t)b * Lp + p];
            if (*cell == INT16_MAX) return -1;
            ++*cell;
        }
    }
    return kept;
}


/*
 * Delta-encoded sparse pack: for each nonzero cell of the flat int16
 * tensor, emit (u16 delta from the previous emitted dense index, u8
 * value saturated at 255); cells > 255 get an int32 correction entry at
 * the dense flat index. Gaps > 65535 are chained through zero-value
 * entries (they land on zero cells by construction, so the device's
 * scatter-add of 0 is a no-op). The device decodes idx = cumsum(delta)-1
 * and scatter-adds the values — ~2x faster than the bitmap wire's
 * bit-expand + full-length cumsum + gather, with a smaller wire
 * (2+1 bytes per nonzero vs dense/8 + 1 per nonzero).
 * Caller-zeroed padding is self-neutralizing: delta 0 repeats the last
 * emitted index with value 0.
 * Returns nnz entries needed (may exceed vals_cap -> caller re-packs).
 */
extern "C" int64_t bd_pack_counts_sparse_d16(const int16_t* counts,
                                             int64_t n,
                                             uint16_t* deltas,
                                             uint8_t* vals,
                                             int64_t vals_cap,
                                             int32_t* corr_idx,
                                             int32_t* corr_val,
                                             int64_t corr_cap,
                                             int64_t* out_ncorr) {
    int64_t nnz = 0, nc = 0;
    int64_t prev = -1;
    for (int64_t i = 0; i < n; ++i) {
        int16_t c = counts[i];
        if (c == 0) continue;
        while (i - prev > 65535) {
            if (nnz < vals_cap) {
                deltas[nnz] = 65535;
                vals[nnz] = 0;
            }
            ++nnz;
            prev += 65535;
        }
        uint8_t v;
        if ((uint16_t)c <= 255) {
            v = (uint8_t)c;
        } else {
            v = 255;
            if (nc < corr_cap) {
                corr_idx[nc] = (int32_t)i;
                corr_val[nc] = (int32_t)c - 255;
            }
            ++nc;
        }
        if (nnz < vals_cap) {
            deltas[nnz] = (uint16_t)(i - prev);
            vals[nnz] = v;
        }
        ++nnz;
        prev = i;
    }
    *out_ncorr = nc;
    return nnz;
}

/*
 * Cumulative per-position coverage from an int16 count tensor
 * [n_mm, 4, Lp]: out_total[m, p] = sum over mm' <= m, bases of counts.
 * Lets the hybrid engine skip fetching the dense `total` array from the
 * device (device->host copies cost more than this one cheap host pass).
 */
extern "C" void bd_total_cum16(const int16_t* counts, int32_t n_mm,
                               int64_t Lp, int32_t* out_total) {
    for (int32_t m = 0; m < n_mm; ++m) {
        const int16_t* a = counts + (int64_t)m * 4 * Lp;
        int32_t* o = out_total + (int64_t)m * Lp;
        const int32_t* prev =
            m ? out_total + (int64_t)(m - 1) * Lp : nullptr;
        for (int64_t p = 0; p < Lp; ++p) {
            int32_t s = (int32_t)a[p] + a[Lp + p] + a[2 * Lp + p] +
                        a[3 * Lp + p];
            o[p] = s + (prev ? prev[p] : 0);
        }
    }
}

/*
 * Cumulative totals AND clonality from an int16 count tensor [n_mm,4,Lp]
 * in one pass: out_total as bd_total_cum16; out_clon[m,p] =
 * sum_b (cum_b / max(T,1))^2 in float32 where the exact level is present
 * at p and T >= min_cov, else NaN — mirroring the device kernel
 * (kernels/sitestats.py site_stats clon). Lets the hybrid/batch engines
 * skip fetching the dense clonality array from the device entirely.
 */
extern "C" void bd_clon_cum16(const int16_t* counts, int32_t n_mm,
                              int64_t Lp, int32_t min_cov,
                              int32_t* out_total, float* out_clon) {
    std::vector<int32_t> cum(4 * Lp, 0);
    const float kNaN = __builtin_nanf("");
    int32_t* c0 = cum.data();
    int32_t* c1 = cum.data() + Lp;
    int32_t* c2 = cum.data() + 2 * Lp;
    int32_t* c3 = cum.data() + 3 * Lp;
    for (int32_t m = 0; m < n_mm; ++m) {
        const int16_t* a = counts + (int64_t)m * 4 * Lp;
        int32_t* ot = out_total + (int64_t)m * Lp;
        float* oc = out_clon + (int64_t)m * Lp;
        for (int64_t p = 0; p < Lp; ++p) {
            int16_t e0 = a[p], e1 = a[Lp + p], e2 = a[2 * Lp + p],
                    e3 = a[3 * Lp + p];
            c0[p] += e0; c1[p] += e1; c2[p] += e2; c3[p] += e3;
            int32_t T = c0[p] + c1[p] + c2[p] + c3[p];
            ot[p] = T;
            if ((e0 | e1 | e2 | e3) != 0 && T >= min_cov) {
                float tf = (float)T;
                if (tf < 1.0f) tf = 1.0f;
                float p0 = (float)c0[p] / tf, p1 = (float)c1[p] / tf;
                float p2f = (float)c2[p] / tf, p3 = (float)c3[p] / tf;
                /* tree order to match XLA's 4-lane reduction */
                oc[p] = (p0 * p0 + p1 * p1) + (p2f * p2f + p3 * p3);
            } else {
                oc[p] = kNaN;
            }
        }
    }
}

/* Extract counted events at masked positions (for linkage capture):
 * fills pos/base/mm_idx/qname arrays up to `capacity`, returns the true
 * number of matching events (may exceed capacity — caller re-calls). */
extern "C" int64_t bd_select_events(BamData* h, int32_t ref_id,
                                    const int32_t* qid2mmidx,
                                    const uint8_t* pos_mask, int64_t L,
                                    uint8_t min_qual,
                                    int32_t* out_pos, uint8_t* out_base,
                                    int32_t* out_mm, int64_t* out_qname,
                                    int64_t capacity) {
    int64_t beg = h->ref_rec_begin[ref_id], end = h->ref_rec_end[ref_id];
    if (beg < 0) return 0;
    int64_t n = 0;
    for (int64_t r = beg; r < end; ++r) {
        if (h->ref_id[r] != ref_id) continue;
        int32_t mi = qid2mmidx[h->qname_id[r]];
        if (mi < 0) continue;
        int64_t e0 = h->ev_off[r];
        int64_t e1 = e0 + h->ev_len[r];
        for (int64_t e = e0; e < e1; ++e) {
            uint8_t b = h->ev_base[e];
            if (b >= 4 || h->ev_qual[e] < min_qual) continue;
            int64_t p = h->ev_pos[e];
            if (p < 0 || p >= L || !pos_mask[p]) continue;
            if (n < capacity) {
                out_pos[n] = (int32_t)p;
                out_base[n] = b;
                out_mm[n] = mi;
                out_qname[n] = h->qname_id[r];
            }
            ++n;
        }
    }
    return n;
}

/*
 * SAM text input: the reference accepts .sam via samtools conversion
 * (profile/samtools_ops.py:13-67); here the decoder parses SAM directly
 * into the same in-memory structures as BAM.
 */
namespace {

const uint8_t* CHAR2CODE_init() {
    static uint8_t t[256];
    memset(t, 4, sizeof(t));
    t['A'] = 0; t['C'] = 1; t['T'] = 2; t['G'] = 3;
    return t;
}
const uint8_t* CHAR2CODE = CHAR2CODE_init();

int cigar_char2op(char c) {
    switch (c) {
        case 'M': return CMATCH; case 'I': return CINS; case 'D': return CDEL;
        case 'N': return CREF_SKIP; case 'S': return CSOFT;
        case 'H': return CHARD; case 'P': return CPAD;
        case '=': return CEQUAL; case 'X': return CDIFF;
    }
    return -1;
}

}  // namespace

static void sort_records(BamData* h) {
    /* SAM input may be unsorted; coordinate-sort the record table (the
     * reference runs samtools sort first, samtools_ops.py:70-164). Event
     * and cigar buffers stay in place — only record-level vectors and the
     * per-ref ranges are permuted. */
    int64_t n = (int64_t)h->ref_id.size();
    std::vector<int64_t> order(n);
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        if (h->ref_id[a] != h->ref_id[b]) return h->ref_id[a] < h->ref_id[b];
        return h->pos[a] < h->pos[b];
    });
    bool sorted = true;
    for (int64_t i = 0; i < n; ++i)
        if (order[i] != i) { sorted = false; break; }
    if (sorted) return;

    auto permute = [&](auto& vec) {
        using V = typename std::remove_reference<decltype(vec)>::type;
        V out(vec.size());
        for (int64_t i = 0; i < n; ++i) out[i] = vec[order[i]];
        vec.swap(out);
    };
    permute(h->ref_id); permute(h->pos); permute(h->flag); permute(h->mapq);
    permute(h->nm); permute(h->qname_id); permute(h->qlen_infer);
    permute(h->ref_start); permute(h->ref_end); permute(h->ev_off);
    permute(h->ev_len); permute(h->pileup_ok); permute(h->cig_off);
    permute(h->cig_n); permute(h->seq_off); permute(h->seq_len);
    permute(h->tlen); permute(h->mate_pos); permute(h->mate_ref);
    for (size_t r = 0; r < h->ref_names.size(); ++r) {
        h->ref_rec_begin[r] = -1; h->ref_rec_end[r] = -1;
    }
    for (int64_t i = 0; i < n; ++i) {
        int32_t rid = h->ref_id[i];
        if (h->ref_rec_begin[rid] < 0) h->ref_rec_begin[rid] = i;
        h->ref_rec_end[rid] = i + 1;
    }
}

extern "C" BamData* bd_open_sam(const char* path) {
    /* Zero-copy record parsing: fields are (ptr,len) spans into the raw
     * buffer — no per-line std::string, no vector<string> splits, and
     * upfront event reservations. (This host's memory allocator is
     * bandwidth-throttled; the copy-heavy first version parsed at only
     * ~7k records/s.) Short strings (qname/rname) stay SSO-cheap. */
    rvec<uint8_t> raw;
    if (!read_file(path, raw)) return nullptr;
    auto h = new BamData();
    std::unordered_map<std::string, int32_t> ref_ids;
    std::unordered_map<std::string, int64_t> qmap;

    size_t i = 0, n = raw.size();
    const char* data = (const char*)raw.data();
    /* SEQ+QUAL are roughly half of each record line */
    h->ev_pos.reserve(n / 2); h->ev_base.reserve(n / 2);
    h->ev_qual.reserve(n / 2);
    h->seq_buf.reserve(n / 4); h->qual_buf.reserve(n / 4);

    auto span_int = [](const char* s, size_t l) -> int64_t {
        int64_t v = 0; bool neg = false; size_t k = 0;
        if (l && s[0] == '-') { neg = true; k = 1; }
        for (; k < l; ++k) {
            char c = s[k];
            if (c < '0' || c > '9') break;
            v = v * 10 + (c - '0');
        }
        return neg ? -v : v;
    };

    /* coordinate-sorted SAMs repeat RNAME: cache the last lookup */
    const char* last_rn = nullptr; size_t last_rn_len = 0;
    int32_t last_rid = -1;
    std::vector<uint32_t> cig;

    while (i < n) {
        size_t j = i;
        while (j < n && data[j] != '\n') ++j;
        const char* ln = data + i;
        size_t len = j - i;
        i = j + 1;
        if (len && ln[len - 1] == '\r') --len;
        if (!len) continue;
        if (ln[0] == '@') {
            std::string line(ln, len);
            if (line.rfind("@SQ", 0) == 0) {
                std::string name; int64_t rlen = 0;
                size_t p = 0;
                while (p != std::string::npos) {
                    size_t q = line.find('\t', p + 1);
                    std::string field = line.substr(
                        p + 1, q == std::string::npos ? q : q - p - 1);
                    if (field.rfind("SN:", 0) == 0) name = field.substr(3);
                    if (field.rfind("LN:", 0) == 0)
                        rlen = atoll(field.c_str() + 3);
                    p = q;
                }
                if (!name.empty()) {
                    ref_ids[name] = (int32_t)h->ref_names.size();
                    h->ref_names.push_back(name);
                    h->ref_lens.push_back(rlen);
                }
            }
            continue;
        }
        if (h->ref_rec_begin.empty()) {
            h->ref_rec_begin.assign(h->ref_names.size(), -1);
            h->ref_rec_end.assign(h->ref_names.size(), -1);
        }
        /* split the 11 mandatory fields into spans; tags are scanned
         * separately below (records can carry any number of tags) */
        const char* fp[11]; size_t fn[11]; int nf = 0;
        size_t p = 0;
        while (nf < 11) {
            size_t q = p;
            while (q < len && ln[q] != '\t') ++q;
            fp[nf] = ln + p; fn[nf] = q - p; ++nf;
            if (q >= len) break;
            p = q + 1;
        }
        if (nf < 11) continue;
        uint16_t fl = (uint16_t)span_int(fp[1], fn[1]);
        if (fl & 0x4) continue;
        int32_t refID;
        if (last_rn && fn[2] == last_rn_len &&
            memcmp(fp[2], last_rn, last_rn_len) == 0) {
            refID = last_rid;
        } else {
            auto rit = ref_ids.find(std::string(fp[2], fn[2]));
            if (rit == ref_ids.end()) continue;
            refID = rit->second;
            last_rn = fp[2]; last_rn_len = fn[2]; last_rid = refID;
        }
        int32_t rpos = (int32_t)span_int(fp[3], fn[3]) - 1;
        uint8_t mq = (uint8_t)span_int(fp[4], fn[4]);
        /* mate fields: RNEXT ('='/'*'/name), PNEXT (1-based), TLEN */
        int32_t mref = -1;
        if (fn[6] == 1 && fp[6][0] == '=') mref = refID;
        else if (!(fn[6] == 1 && fp[6][0] == '*')) {
            auto mit = ref_ids.find(std::string(fp[6], fn[6]));
            if (mit != ref_ids.end()) mref = mit->second;
        }
        int32_t mpos = (int32_t)span_int(fp[7], fn[7]) - 1;
        int32_t tl = (int32_t)span_int(fp[8], fn[8]);
        const char* seq_s = fp[9]; size_t seq_l = fn[9];
        const char* qual_s = fp[10]; size_t qual_l = fn[10];
        bool star_qual = (qual_l == 1 && qual_s[0] == '*');
        if (seq_l == 1 && seq_s[0] == '*') seq_l = 0;
        /* walk ALL optional tags after field 10 for NM:i: */
        int32_t nm = -1;
        {
            const char* tp = fp[10] + fn[10];
            const char* lend = ln + len;
            while (tp < lend) {
                ++tp;  /* skip the tab */
                const char* te = tp;
                while (te < lend && *te != '\t') ++te;
                if (te - tp >= 5 && memcmp(tp, "NM:i:", 5) == 0) {
                    nm = (int32_t)span_int(tp + 5, (size_t)(te - tp - 5));
                    break;
                }
                tp = te;
            }
        }

        /* parse cigar from its span */
        cig.clear();
        if (!(fn[5] == 1 && fp[5][0] == '*')) {
            int64_t num = 0;
            for (size_t k = 0; k < fn[5]; ++k) {
                char c = fp[5][k];
                if (c >= '0' && c <= '9') {
                    num = num * 10 + (c - '0');
                    continue;
                }
                int op = cigar_char2op(c);
                if (op < 0) { cig.clear(); break; }
                cig.push_back(((uint32_t)num << 4) | op);
                num = 0;
            }
        }

        int64_t ev0 = (int64_t)h->ev_pos.size();
        int64_t x = rpos, y = 0;
        int32_t qlen = 0, rstart = -1, rend = -1;
        for (uint32_t c : cig) {
            int op = c & 0xf;
            int64_t l = c >> 4;
            if (op == CMATCH || op == CEQUAL || op == CDIFF) {
                for (int64_t k = 0; k < l; ++k) {
                    int64_t qi = y + k;
                    h->ev_pos.push_back((int32_t)(x + k));
                    h->ev_base.push_back(
                        qi < (int64_t)seq_l
                            ? CHAR2CODE[(uint8_t)seq_s[qi]] : 4);
                    h->ev_qual.push_back(
                        star_qual || qi >= (int64_t)qual_l
                            ? 0 : (uint8_t)(qual_s[qi] - 33));
                }
                if (rstart < 0) rstart = (int32_t)x;
                rend = (int32_t)(x + l - 1);
                x += l; y += l; qlen += l;
            } else if (op == CINS || op == CSOFT) {
                y += l; qlen += l;
            } else if (op == CDEL || op == CREF_SKIP) {
                x += l;
            }
        }
        if (rstart < 0) {
            h->ev_pos.resize(ev0); h->ev_base.resize(ev0);
            h->ev_qual.resize(ev0);
            continue;
        }
        std::string qname(fp[0], fn[0]);
        auto qit = qmap.find(qname);
        int64_t qid;
        if (qit == qmap.end()) {
            qid = (int64_t)qmap.size();
            qmap.emplace(std::move(qname), qid);
            h->qname_off.push_back((int64_t)h->qname_blob.size());
            h->qname_blob.append(fp[0], fn[0]);
            h->qname_blob += '\0';
        } else {
            qid = qit->second;
        }
        int64_t ridx = (int64_t)h->ref_id.size();
        h->ref_id.push_back(refID);
        h->pos.push_back(rpos);
        h->flag.push_back(fl);
        h->mapq.push_back(mq);
        h->nm.push_back(nm);
        h->qname_id.push_back(qid);
        h->qlen_infer.push_back(qlen);
        h->ref_start.push_back(rstart);
        h->ref_end.push_back(rend);
        h->tlen.push_back(tl);
        h->mate_pos.push_back(mpos);
        h->mate_ref.push_back(mref);
        h->ev_off.push_back(ev0);
        h->ev_len.push_back((int32_t)(h->ev_pos.size() - ev0));
        bool orphan = (fl & 0x1) && !(fl & 0x2);
        h->pileup_ok.push_back(orphan ? 0 : 1);
        h->cig_off.push_back((int64_t)h->cig_buf.size());
        h->cig_n.push_back((int32_t)cig.size());
        h->cig_buf.insert(h->cig_buf.end(), cig.begin(), cig.end());
        h->seq_off.push_back((int64_t)h->seq_buf.size());
        h->seq_len.push_back((int32_t)seq_l);
        for (size_t k = 0; k < seq_l; ++k) {
            h->seq_buf.push_back(CHAR2CODE[(uint8_t)seq_s[k]]);
            h->qual_buf.push_back(
                star_qual || k >= qual_l
                    ? 0 : (uint8_t)(qual_s[k] - 33));
        }
        if (h->ref_rec_begin[refID] < 0) h->ref_rec_begin[refID] = ridx;
        h->ref_rec_end[refID] = ridx + 1;
    }
    if (h->ref_rec_begin.empty()) {
        h->ref_rec_begin.assign(h->ref_names.size(), -1);
        h->ref_rec_end.assign(h->ref_names.size(), -1);
    }
    sort_records(h);
    return h;
}

/*
 * ---- .bai-guided ranged decode ----
 *
 * Decodes ONLY the records of a requested scaffold set, using the BAM
 * index's per-ref chunk extents to bound which BGZF blocks are inflated
 * (reference analogue: pysam's indexed fetch that polymorpher.py:275-310
 * relies on for its one-pass-per-span SNV pooling extraction). The rest
 * of the file is read but never inflated or parsed.
 */

namespace {

struct RefVRange { uint64_t vbeg = UINT64_MAX, vend = 0; };

bool parse_bai(const char* path, size_t n_ref,
               std::vector<RefVRange>& out) {
    rvec<uint8_t> b;
    if (!read_file(path, b)) return false;
    if (b.size() < 8 || memcmp(b.data(), "BAI\1", 4) != 0) {
        g_err = "bad .bai magic";
        return false;
    }
    size_t p = 4;
    int32_t nr; memcpy(&nr, &b[p], 4); p += 4;
    if ((size_t)nr != n_ref) { g_err = ".bai n_ref mismatch"; return false; }
    out.assign(n_ref, RefVRange{});
    for (int32_t r = 0; r < nr; ++r) {
        if (p + 4 > b.size()) { g_err = ".bai truncated"; return false; }
        int32_t n_bin; memcpy(&n_bin, &b[p], 4); p += 4;
        for (int32_t i = 0; i < n_bin; ++i) {
            uint32_t bin; memcpy(&bin, &b[p], 4); p += 4;
            int32_t n_chunk; memcpy(&n_chunk, &b[p], 4); p += 4;
            for (int32_t c = 0; c < n_chunk; ++c) {
                uint64_t beg, end;
                memcpy(&beg, &b[p], 8); p += 8;
                memcpy(&end, &b[p], 8); p += 8;
                if (bin == 37450) continue;  // pseudo-bin: counts, not offsets
                if (beg < out[r].vbeg) out[r].vbeg = beg;
                if (end > out[r].vend) out[r].vend = end;
            }
        }
        int32_t n_intv; memcpy(&n_intv, &b[p], 4); p += 4;
        p += (size_t)n_intv * 8;
    }
    return true;
}

// inflate blocks [b0, b1) into a contiguous buffer
bool inflate_span(const rvec<uint8_t>& raw, const std::vector<Block>& blocks,
                  size_t b0, size_t b1, rvec<uint8_t>& out, int threads) {
    std::vector<Block> span(blocks.begin() + b0, blocks.begin() + b1);
    size_t base = span.empty() ? 0 : span[0].out_off;
    for (auto& s : span) s.out_off -= base;
    return bgzf_inflate(raw, span, out, threads);
}

}  // namespace

extern "C" BamData* bd_open_ranged(const char* path, int threads,
                                   const char* want_names) {
    rvec<uint8_t> raw;
    if (!read_file(path, raw)) return nullptr;
    if (!(raw.size() >= 4 && raw[0] == 0x1f && raw[1] == 0x8b)) {
        g_err = "ranged decode requires a BGZF BAM";
        return nullptr;
    }
    std::vector<Block> blocks;
    if (!bgzf_scan(raw, blocks)) return nullptr;

    // inflate leading blocks until the full header (magic, text, refs) is
    // available; headers are typically one or two blocks
    auto h = new BamData();
    rvec<uint8_t> head;
    size_t hb = 0;
    size_t header_end = 0;
    {
        bool done = false;
        while (!done) {
            if (hb >= blocks.size()) { g_err = "header truncated";
                                       delete h; return nullptr; }
            ++hb;
            if (!inflate_span(raw, blocks, 0, hb, head, threads)) {
                delete h; return nullptr;
            }
            if (head.size() < 12) continue;
            if (memcmp(head.data(), "BAM\1", 4) != 0) {
                g_err = "not a BAM file"; delete h; return nullptr;
            }
            size_t p = 4;
            int32_t l_text; memcpy(&l_text, &head[p], 4);
            p += 4 + (size_t)l_text;
            if (p + 4 > head.size()) continue;
            int32_t n_ref; memcpy(&n_ref, &head[p], 4); p += 4;
            h->ref_names.clear(); h->ref_lens.clear();
            bool ok = true;
            for (int i = 0; i < n_ref; ++i) {
                if (p + 4 > head.size()) { ok = false; break; }
                int32_t l_name; memcpy(&l_name, &head[p], 4); p += 4;
                if (p + l_name + 4 > head.size()) { ok = false; break; }
                h->ref_names.emplace_back((const char*)&head[p],
                                          l_name - 1);
                p += l_name;
                int32_t l_ref; memcpy(&l_ref, &head[p], 4); p += 4;
                h->ref_lens.push_back(l_ref);
            }
            if (!ok) continue;
            header_end = p;
            done = true;
        }
    }
    size_t n_ref = h->ref_names.size();
    h->ref_rec_begin.assign(n_ref, -1);
    h->ref_rec_end.assign(n_ref, -1);

    // index: <path>.bai or <path minus .bam>.bai
    std::vector<RefVRange> vr;
    {
        std::string bai = std::string(path) + ".bai";
        FILE* f = fopen(bai.c_str(), "rb");
        if (!f) {
            std::string base(path);
            if (base.size() > 4 &&
                base.compare(base.size() - 4, 4, ".bam") == 0)
                bai = base.substr(0, base.size() - 4) + ".bai";
            f = fopen(bai.c_str(), "rb");
        }
        if (f) fclose(f);
        else { g_err = "no .bai index"; delete h; return nullptr; }
        if (!parse_bai(bai.c_str(), n_ref, vr)) { delete h; return nullptr; }
    }

    // wanted ref ids from the '\n'-joined name list
    std::unordered_map<std::string, int32_t> name2id;
    for (size_t i = 0; i < n_ref; ++i)
        name2id.emplace(h->ref_names[i], (int32_t)i);
    std::vector<char> want(n_ref, 0);
    {
        const char* s = want_names;
        while (s && *s) {
            const char* e = strchr(s, '\n');
            std::string nm = e ? std::string(s, e - s) : std::string(s);
            auto it = name2id.find(nm);
            if (it != name2id.end()) want[it->second] = 1;
            s = e ? e + 1 : nullptr;
        }
    }

    // merge wanted refs' virtual ranges into block windows
    std::vector<std::pair<uint64_t, uint64_t>> vspans;
    for (size_t r = 0; r < n_ref; ++r)
        if (want[r] && vr[r].vbeg != UINT64_MAX)
            vspans.emplace_back(vr[r].vbeg, vr[r].vend);
    std::sort(vspans.begin(), vspans.end());
    std::vector<std::pair<uint64_t, uint64_t>> merged;
    for (auto& s : vspans) {
        if (!merged.empty() && (s.first >> 16) <=
                (merged.back().second >> 16))
            merged.back().second = std::max(merged.back().second, s.second);
        else
            merged.push_back(s);
    }

    // per-block compressed start offsets for voffset -> block lookup.
    // Block.in_off points at the cdata (after the 12+xlen gzip header);
    // block i starts where block i-1 ended (cdata + crc(4) + isize(4)).
    std::vector<size_t> c_offs(blocks.size());
    {
        size_t p0 = 0;
        for (size_t i = 0; i < blocks.size(); ++i) {
            c_offs[i] = p0;
            p0 = blocks[i].in_off + blocks[i].in_len + 8;
        }
    }

    // parse records from the merged windows, inflated in ONE combined
    // pass: per-window inflates paid a thread-pool spin-up each (16+
    // interleaved windows at metagenome scale measured SLOWER than a
    // full decode), and the single call decompresses every wanted
    // block in one parallel sweep
    std::string qn;
    std::unordered_map<std::string, int64_t> qmap;
    struct Win { size_t b0, data_off, ubeg, end_off; };
    std::vector<Win> wins;
    std::vector<Block> allspan;
    size_t tot_out = 0;
    for (auto& w : merged) {
        size_t cbeg = (size_t)(w.first >> 16);
        size_t ubeg = (size_t)(w.first & 0xffff);
        size_t cend = (size_t)(w.second >> 16);
        // [b0, b1): from the block containing cbeg through the block
        // containing cend inclusive
        size_t b0 = (size_t)(std::upper_bound(c_offs.begin(), c_offs.end(),
                                              cbeg) - c_offs.begin()) - 1;
        size_t b1 = (size_t)(std::upper_bound(c_offs.begin(), c_offs.end(),
                                              cend) - c_offs.begin());
        Win win; win.b0 = b0; win.data_off = tot_out; win.ubeg = ubeg;
        for (size_t i = b0; i < b1; ++i) {
            Block b = blocks[i];
            b.out_off = tot_out;
            tot_out += b.out_len;
            allspan.push_back(b);
        }
        win.end_off = tot_out;
        wins.push_back(win);
    }
    rvec<uint8_t> data;
    if (!bgzf_inflate(raw, allspan, data, threads)) {
        delete h; return nullptr;
    }
    // generous reserves from the known uncompressed size so the fill
    // below never reallocates (rvec reserve touches no pages; realloc
    // copies are catastrophic on this bandwidth-throttled host)
    h->ev_pos.reserve(tot_out); h->ev_base.reserve(tot_out);
    h->ev_qual.reserve(tot_out);
    h->seq_buf.reserve(tot_out); h->qual_buf.reserve(tot_out);
    h->cig_buf.reserve(tot_out / 16 + 64);
    for (auto& win : wins) {
        size_t p = win.data_off + win.ubeg;
        if (win.b0 == 0 && header_end > win.ubeg)
            p = win.data_off + header_end;
        while (p + 4 <= win.end_off) {
            int32_t bs; memcpy(&bs, &data[p], 4);
            if (bs <= 0 || p + 4 + (size_t)bs > win.end_off) break;
            const uint8_t* rec = &data[p + 4];
            p += 4 + (size_t)bs;
            int32_t refID, rpos, l_seq;
            memcpy(&refID, rec + 0, 4);
            memcpy(&rpos, rec + 4, 4);
            uint8_t l_rn = rec[8], mq = rec[9];
            uint16_t n_cig, fl;
            memcpy(&n_cig, rec + 12, 2);
            memcpy(&fl, rec + 14, 2);
            memcpy(&l_seq, rec + 16, 4);
            if (refID < 0 || (fl & 0x4)) continue;
            if (refID >= (int32_t)n_ref || !want[refID]) continue;
            int32_t mref, mpos, tl;
            memcpy(&mref, rec + 20, 4);
            memcpy(&mpos, rec + 24, 4);
            memcpy(&tl, rec + 28, 4);
            const char* qname = (const char*)(rec + 32);
            const uint32_t* cig = (const uint32_t*)(rec + 32 + l_rn);
            const uint8_t* seq = rec + 32 + l_rn + 4 * (size_t)n_cig;
            const uint8_t* qual = seq + (l_seq + 1) / 2;
            const uint8_t* tags = qual + l_seq;
            const uint8_t* rec_end = rec + bs;

            int64_t ev0 = (int64_t)h->ev_pos.size();
            int64_t x = rpos, y = 0;
            int32_t qlen = 0, rstart = -1, rend = -1;
            for (int k = 0; k < n_cig; ++k) {
                int op = cg_op(cig[k]);
                int64_t l = cg_len(cig[k]);
                if (op == CMATCH || op == CEQUAL || op == CDIFF) {
                    size_t eb = h->ev_pos.size();
                    h->ev_pos.resize(eb + (size_t)l);
                    h->ev_base.resize(eb + (size_t)l);
                    h->ev_qual.resize(eb + (size_t)l);
                    int32_t* pp = &h->ev_pos[eb];
                    uint8_t* pb = &h->ev_base[eb];
                    uint8_t* pq = &h->ev_qual[eb];
                    for (int64_t j = 0; j < l; ++j) {
                        int64_t qi = y + j;
                        uint8_t nib = (qi & 1) ? (seq[qi >> 1] & 0xf)
                                               : (seq[qi >> 1] >> 4);
                        pp[j] = (int32_t)(x + j);
                        pb[j] = NIB2CODE[nib];
                        pq[j] = qual[qi] == 0xff ? 0 : qual[qi];
                    }
                    if (rstart < 0) rstart = (int32_t)x;
                    rend = (int32_t)(x + l - 1);
                    x += l; y += l; qlen += l;
                } else if (op == CINS || op == CSOFT) {
                    y += l; qlen += l;
                } else if (op == CDEL || op == CREF_SKIP) {
                    x += l;
                }
            }
            if (rstart < 0) {
                h->ev_pos.resize(ev0); h->ev_base.resize(ev0);
                h->ev_qual.resize(ev0);
                continue;
            }
            qn.assign(qname, l_rn > 0 ? (size_t)(l_rn - 1) : 0);
            auto qit = qmap.find(qn);
            int64_t qid;
            if (qit == qmap.end()) {
                qid = (int64_t)qmap.size();
                qmap.emplace(qn, qid);
                h->qname_off.push_back((int64_t)h->qname_blob.size());
                h->qname_blob += qn;
                h->qname_blob += '\0';
            } else {
                qid = qit->second;
            }
            h->ref_id.push_back(refID);
            h->pos.push_back(rpos);
            h->flag.push_back(fl);
            h->mapq.push_back(mq);
            h->nm.push_back(parse_nm_tag(tags, rec_end));
            h->qname_id.push_back(qid);
            h->qlen_infer.push_back(qlen);
            h->ref_start.push_back(rstart);
            h->ref_end.push_back(rend);
            h->tlen.push_back(tl);
            h->mate_pos.push_back(mpos);
            h->mate_ref.push_back(mref);
            h->ev_off.push_back(ev0);
            h->ev_len.push_back((int32_t)(h->ev_pos.size() - ev0));
            bool orphan = (fl & 0x1) && !(fl & 0x2);
            h->pileup_ok.push_back(orphan ? 0 : 1);
            h->cig_off.push_back((int64_t)h->cig_buf.size());
            h->cig_n.push_back((int32_t)n_cig);
            for (int k = 0; k < n_cig; ++k) h->cig_buf.push_back(cig[k]);
            size_t sb = h->seq_buf.size();
            h->seq_off.push_back((int64_t)sb);
            h->seq_len.push_back(l_seq);
            h->seq_buf.resize(sb + (size_t)l_seq);
            h->qual_buf.resize(sb + (size_t)l_seq);
            uint8_t* sc = &h->seq_buf[sb];
            uint8_t* qc = &h->qual_buf[sb];
            for (int64_t qi = 0; qi < l_seq; ++qi) {
                uint8_t nib = (qi & 1) ? (seq[qi >> 1] & 0xf)
                                       : (seq[qi >> 1] >> 4);
                sc[qi] = NIB2CODE[nib];
                qc[qi] = qual[qi] == 0xff ? 0 : qual[qi];
            }
        }
    }
    for (int64_t r = 0; r < (int64_t)h->ref_id.size(); ++r) {
        int32_t rid = h->ref_id[r];
        if (h->ref_rec_begin[rid] < 0) h->ref_rec_begin[rid] = r;
        h->ref_rec_end[rid] = r + 1;
    }
    sort_records(h);
    return h;
}
