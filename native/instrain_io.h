/*
 * instrain_io — native BAM decoding layer for instrain_tpu.
 *
 * Decodes a whole (sorted) BAM into flat arrays ready for zero-copy numpy
 * wrapping: a per-record table (pairing/filter fields, mirroring what the
 * reference extracts via pysam in inStrain/filter_reads.py:885-955) and a
 * per-aligned-base "event" stream (ref position, base code, quality) that
 * feeds the device pileup kernels (replacing pysam's pileup engine used in
 * inStrain/profile/profile_utilities.py:150-153).
 *
 * Quality post-processing implemented here, matching the reference's pileup
 * parameters (truncate, compute_baq=True, ignore_orphans=True,
 * ignore_overlaps=True, min_base_quality=30):
 *  - BAQ: glocal-HMM base alignment quality capping (baq.cc)
 *  - overlap tweak: mate-overlap double-count removal
 *  - orphan marking: paired reads without proper-pair flag excluded from
 *    pileup (but still present in the record table for read filtering)
 */
#ifndef INSTRAIN_IO_H
#define INSTRAIN_IO_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct BamData BamData;

/* Decode a BAM file with `threads` BGZF-inflate threads.
 * Returns NULL on failure (see bd_error for message). */
BamData* bd_open(const char* path, int threads);
void bd_free(BamData* h);
const char* bd_error(void);

/* header info */
int64_t bd_n_refs(BamData* h);
const char* bd_ref_name(BamData* h, int64_t i);
int64_t bd_ref_len(BamData* h, int64_t i);

/* record table (length bd_n_records) */
int64_t bd_n_records(BamData* h);
const int32_t*  bd_rec_ref_id(BamData* h);
const int32_t*  bd_rec_pos(BamData* h);
const uint16_t* bd_rec_flag(BamData* h);
const uint8_t*  bd_rec_mapq(BamData* h);
const int32_t*  bd_rec_nm(BamData* h);
const int64_t*  bd_rec_qname_id(BamData* h);
const int32_t*  bd_rec_qlen_infer(BamData* h);
const int32_t*  bd_rec_ref_start(BamData* h);
const int32_t*  bd_rec_ref_end(BamData* h);
const int32_t*  bd_rec_tlen(BamData* h);
const int32_t*  bd_rec_mate_pos(BamData* h);
const int32_t*  bd_rec_mate_ref(BamData* h);
const int64_t*  bd_rec_ev_off(BamData* h);
const int32_t*  bd_rec_ev_len(BamData* h);
const uint8_t*  bd_rec_pileup_ok(BamData* h); /* 1 = participates in pileup */

/* event stream (length bd_n_events): one entry per aligned base (M/=/X) */
int64_t bd_n_events(BamData* h);
const int32_t* bd_ev_pos(BamData* h);
const uint8_t* bd_ev_base(BamData* h);  /* A=0 C=1 T=2 G=3 other=4 */
const uint8_t* bd_ev_qual(BamData* h);

/* qname interning: blob of NUL-terminated names + offsets */
int64_t bd_n_qnames(BamData* h);
const char* bd_qname_blob(BamData* h);
int64_t bd_qname_blob_len(BamData* h);
const int64_t* bd_qname_off(BamData* h);

/* Apply BAQ to all records of reference `ref_id` against its sequence
 * (ASCII, uppercased, length len). Modifies ev_qual in place. */
void bd_apply_baq(BamData* h, int32_t ref_id, const uint8_t* ref_seq,
                  int64_t len);

/* Apply mate-overlap quality tweaking (per qname, per ref). Modifies
 * ev_qual in place. Call after bd_apply_baq. */
void bd_tweak_overlaps(BamData* h);

/* Standalone BAQ entry point for testing: computes capped qualities for a
 * single alignment. Returns 0 on success. */
int bd_baq_one(const uint8_t* ref, int64_t ref_len, int64_t pos,
               const uint32_t* cigar, int n_cigar,
               const uint8_t* seq_codes, const uint8_t* qual, int l_qseq,
               uint8_t* out_qual);

#ifdef __cplusplus
}
#endif
#endif

#ifdef __cplusplus
extern "C" {
#endif
int64_t bd_build_counts(BamData* h, int32_t ref_id, const int32_t* qid2mmidx,
                        int32_t n_mm, int64_t L, int32_t* out_counts,
                        uint8_t min_qual);
int32_t bd_build_counts16(BamData* h, int32_t ref_id,
                          const int32_t* qid2mmidx, int32_t n_mm, int64_t L,
                          int64_t Lp, int16_t* out_counts,
                          int64_t* level_events, int32_t* level_map,
                          uint8_t min_qual);
int64_t bd_select_events(BamData* h, int32_t ref_id, const int32_t* qid2mmidx,
                         const uint8_t* pos_mask, int64_t L, uint8_t min_qual,
                         int32_t* out_pos, uint8_t* out_base, int32_t* out_mm,
                         int64_t* out_qname, int64_t capacity);
int64_t bd_pack_counts_u8(const int16_t* counts, int64_t n, uint8_t* out,
                          int32_t* corr_idx, int32_t* corr_val, int64_t cap);
void bd_total_cum16(const int16_t* counts, int32_t n_mm, int64_t Lp,
                    int32_t* out_total);
void bd_clon_cum16(const int16_t* counts, int32_t n_mm, int64_t Lp,
                   int32_t min_cov, int32_t* out_total, float* out_clon);
#ifdef __cplusplus
}
#endif

#ifdef __cplusplus
extern "C" {
#endif
BamData* bd_open_sam(const char* path);
/* .bai-guided ranged decode: only the records of the '\n'-joined scaffold
 * name list are inflated/parsed (requires <path>.bai or sibling .bai). */
BamData* bd_open_ranged(const char* path, int threads,
                        const char* want_names);
#ifdef __cplusplus
}
#endif
