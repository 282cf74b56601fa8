/* CRC-32C (Castagnoli), slice-by-8 — the kafka record-batch checksum.
 *
 * A copy of pinot_tpu/native/crc32c.c: the native analog of the reference's
 * org.apache.kafka.common.utils.Crc32C, with the record-batch walk, the value
 * splicer and the flat-JSON column decoder of the realtime consume path.
 * Built on first use by pinot_tpu_torch/native/__init__.py with the system cc.
 */
#include <stddef.h>
#include <string.h>
#include <stdlib.h>
#include <stdint.h>

static uint32_t TBL[8][256];

/* eager init at library load: a lazy `initialized` flag would race under
 * concurrent first use (the flag store can become visible before the table
 * stores, yielding wrong CRCs nondeterministically at startup) */
__attribute__((constructor)) static void init_tables(void) {
    const uint32_t poly = 0x82F63B78u; /* reflected CRC-32C polynomial */
    for (int i = 0; i < 256; i++) {
        uint32_t c = (uint32_t)i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? (poly ^ (c >> 1)) : (c >> 1);
        TBL[0][i] = c;
    }
    for (int i = 0; i < 256; i++) {
        uint32_t c = TBL[0][i];
        for (int s = 1; s < 8; s++) {
            c = TBL[0][c & 0xFF] ^ (c >> 8);
            TBL[s][i] = c;
        }
    }
}

uint32_t pinot_crc32c(const uint8_t *buf, size_t len, uint32_t crc) {
    crc ^= 0xFFFFFFFFu;
    while (len && ((uintptr_t)buf & 7)) {          /* align to 8 bytes */
        crc = TBL[0][(crc ^ *buf++) & 0xFF] ^ (crc >> 8);
        len--;
    }
    while (len >= 8) {
        uint32_t lo = crc ^ ((uint32_t)buf[0] | ((uint32_t)buf[1] << 8) |
                             ((uint32_t)buf[2] << 16) | ((uint32_t)buf[3] << 24));
        uint32_t hi = (uint32_t)buf[4] | ((uint32_t)buf[5] << 8) |
                      ((uint32_t)buf[6] << 16) | ((uint32_t)buf[7] << 24);
        crc = TBL[7][lo & 0xFF] ^ TBL[6][(lo >> 8) & 0xFF] ^
              TBL[5][(lo >> 16) & 0xFF] ^ TBL[4][lo >> 24] ^
              TBL[3][hi & 0xFF] ^ TBL[2][(hi >> 8) & 0xFF] ^
              TBL[1][(hi >> 16) & 0xFF] ^ TBL[0][hi >> 24];
        buf += 8;
        len -= 8;
    }
    while (len--) crc = TBL[0][(crc ^ *buf++) & 0xFF] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

/* v2 record-section decoder: walks `count` records from the byte span after
 * the batch header's count field, emitting per-record offset/timestamp and
 * key/value byte ranges.  Returns records decoded, or -1 on malformed input.
 * The Python wire module slices keys/values out of the original buffer —
 * the per-record varint walk was the realtime consume path's hot loop. */

static int read_varint(const uint8_t *buf, size_t len, size_t *pos,
                       int64_t *out) {
    uint64_t acc = 0;
    int shift = 0;
    while (*pos < len) {
        uint8_t b = buf[(*pos)++];
        acc |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) {
            *out = (int64_t)(acc >> 1) ^ -((int64_t)(acc & 1));
            return 0;
        }
        shift += 7;
        if (shift > 70) return -1;
    }
    return -1;
}

/* Splice record VALUES from a v2 records section into `out` separated by
 * `sep` (one byte), skipping records below min_offset: "v0<sep>v1<sep>v2".
 * The caller wraps with prefix/suffix (e.g. '[' ... ']') and hands the
 * result to ONE C-level parse — zero per-record Python objects on the
 * realtime consume hot path. Returns the record count spliced, or -1 on
 * malformed input / insufficient out_cap; *out_len gets the bytes written,
 * *last_offset the highest absolute offset spliced. */
long pinot_splice_values(const uint8_t *buf, size_t len,
                         long long base_offset, long max_records,
                         long long min_offset, uint8_t sep,
                         uint8_t *out, size_t out_cap,
                         long long *out_len, long long *last_offset) {
    size_t pos = 0, opos = 0;
    long n = 0;
    while (n < max_records && pos < len) {
        int64_t rec_len, ts_delta, off_delta, klen, vlen;
        if (read_varint(buf, len, &pos, &rec_len) || rec_len < 0) return -1;
        size_t rec_end = pos + (size_t)rec_len;
        if (rec_end > len) return -1;
        if (pos >= rec_end) return -1;
        pos++; /* record attributes */
        if (read_varint(buf, rec_end, &pos, &ts_delta)) return -1;
        if (read_varint(buf, rec_end, &pos, &off_delta)) return -1;
        if (read_varint(buf, rec_end, &pos, &klen)) return -1;
        if (klen > 0) {
            if (pos + (size_t)klen > rec_end) return -1;
            pos += (size_t)klen;
        }
        if (read_varint(buf, rec_end, &pos, &vlen)) return -1;
        if (vlen < 0) vlen = 0;
        if (pos + (size_t)vlen > rec_end) return -1;
        if (base_offset + off_delta >= min_offset) {
            size_t need = (size_t)vlen + (n ? 1 : 0);
            if (opos + need > out_cap) return -1;
            if (n) out[opos++] = sep;
            memcpy(out + opos, buf + pos, (size_t)vlen);
            opos += (size_t)vlen;
            *last_offset = base_offset + off_delta;
            n++;
        }
        pos = rec_end;
    }
    *out_len = (long long)opos;
    return n;
}

/* ------------------------------------------------------------------ */
/* Schema-directed flat-JSON columnar decode.
 *
 * Input: `buf` holds n_records comma-separated FLAT json objects (the
 * output of pinot_splice_values).  For each record r and schema column c
 * the decoder fills the COLUMN-MAJOR cell c*n_records + r:
 *   types:   0 missing | 1 double (nums) | 2 string (str_off/str_len,
 *            escape-free) | 3 true | 4 false | 5 null | 6 string with
 *            escapes (raw range incl. backslashes; caller re-decodes the
 *            cell) | 8 int64 (lints)
 * Unknown keys are skipped (scalar values and balanced nested values
 * alike).  A record whose KNOWN key holds a nested value, or whose
 * structure the decoder cannot walk, sets bad[r]=1 and the caller
 * re-parses just that record range (rec_off/rec_len) in Python.
 * Returns records walked, or -1 when the outer structure is malformed
 * (caller falls back to a whole-batch Python parse). */

static void skip_ws(const uint8_t *b, size_t len, size_t *p) {
    while (*p < len && (b[*p] == ' ' || b[*p] == '\t' || b[*p] == '\n' ||
                        b[*p] == '\r'))
        (*p)++;
}

/* scan a JSON string body starting AFTER the opening quote; returns 0 and
 * sets *end to the closing quote, *esc if any backslash was seen */
static int scan_string(const uint8_t *b, size_t len, size_t *p, int *esc) {
    *esc = 0;
    while (*p < len) {
        uint8_t c = b[(*p)++];
        if (c == '\\') {
            *esc = 1;
            if (*p < len) (*p)++;
        } else if (c == '"') {
            return 0;
        }
    }
    return -1;
}

/* skip one JSON value of any shape (nested ok); returns 0 on success */
static int skip_value(const uint8_t *b, size_t len, size_t *p) {
    int depth = 0;
    skip_ws(b, len, p);
    do {
        if (*p >= len) return -1;
        uint8_t c = b[*p];
        if (c == '"') {
            int esc;
            (*p)++;
            if (scan_string(b, len, p, &esc)) return -1;
        } else if (c == '{' || c == '[') {
            depth++;
            (*p)++;
        } else if (c == '}' || c == ']') {
            depth--;
            (*p)++;
        } else if (c == ',' && depth == 0) {
            return 0;
        } else {
            (*p)++;
        }
        if (depth == 0) {
            /* scalar done when next non-ws is , } or end */
            size_t q = *p;
            skip_ws(b, len, &q);
            if (q >= len || b[q] == ',' || b[q] == '}' || b[q] == ']') {
                *p = q;
                return 0;
            }
        }
    } while (depth > 0 || *p < len);
    return 0;
}

long pinot_json_columns(const uint8_t *buf, size_t len, long n_records,
                        const uint8_t *names, const long *name_off,
                        const long *name_len, long ncols,
                        double *nums, long long *lints, uint8_t *types,
                        long long *str_off, long long *str_len,
                        long long *rec_off, long long *rec_len,
                        uint8_t *bad) {
    size_t p = 0;
    for (long r = 0; r < n_records; r++) {
        skip_ws(buf, len, &p);
        rec_off[r] = (long long)p;
        bad[r] = 0;
        if (p >= len || buf[p] != '{') return -1;
        p++;
        int first = 1;
        for (;;) {
            skip_ws(buf, len, &p);
            if (p >= len) return -1;
            if (buf[p] == '}') { p++; break; }
            if (!first) {
                if (buf[p] != ',') return -1;
                p++;
                skip_ws(buf, len, &p);
            }
            first = 0;
            if (p >= len || buf[p] != '"') return -1;
            p++;
            size_t kstart = p;
            int kesc;
            if (scan_string(buf, len, &p, &kesc)) return -1;
            size_t kend = p - 1; /* closing quote */
            long col = -1;
            if (kesc) {
                /* an escaped KEY could name a schema column once unescaped
                 * (e.g. "clic\u006bs"): this decoder matches raw bytes
                 * only, so the record must be python-re-parsed — skipping
                 * it as unknown would silently null the column */
                bad[r] = 1;
            } else {
                long klen = (long)(kend - kstart);
                for (long c = 0; c < ncols; c++) {
                    if (name_len[c] == klen &&
                        memcmp(names + name_off[c], buf + kstart,
                               (size_t)klen) == 0) {
                        col = c;
                        break;
                    }
                }
            }
            skip_ws(buf, len, &p);
            if (p >= len || buf[p] != ':') return -1;
            p++;
            skip_ws(buf, len, &p);
            if (p >= len) return -1;
            if (col < 0) {
                if (skip_value(buf, len, &p)) return -1;
                continue;
            }
            size_t cell = (size_t)col * (size_t)n_records + (size_t)r;
            uint8_t c0 = buf[p];
            if (c0 == '"') {
                p++;
                size_t vstart = p;
                int esc;
                if (scan_string(buf, len, &p, &esc)) return -1;
                str_off[cell] = (long long)vstart;
                str_len[cell] = (long long)(p - 1 - vstart);
                types[cell] = esc ? 6 : 2;
            } else if (c0 == 't') {
                if (p + 4 > len || memcmp(buf + p, "true", 4)) return -1;
                p += 4;
                types[cell] = 3;
            } else if (c0 == 'f') {
                if (p + 5 > len || memcmp(buf + p, "false", 5)) return -1;
                p += 5;
                types[cell] = 4;
            } else if (c0 == 'n') {
                if (p + 4 > len || memcmp(buf + p, "null", 4)) return -1;
                p += 4;
                types[cell] = 5;
            } else if (c0 == '-' || (c0 >= '0' && c0 <= '9')) {
                /* number: parse int64 while it stays integral + in range,
                 * fall back to double on '.', exponent, or overflow */
                int neg = (c0 == '-');
                size_t q = p + (neg ? 1 : 0);
                size_t digits_from = q;
                long long iv = 0;
                int overflow = 0;
                size_t dstart = p;
                while (q < len && buf[q] >= '0' && buf[q] <= '9') {
                    if (iv >= (long long)922337203685477580LL) overflow = 1;
                    if (!overflow) iv = iv * 10 + (buf[q] - '0');
                    q++;
                }
                if (q == digits_from) {
                    bad[r] = 1; /* bare '-' etc: python re-parse raises */
                    p = q;
                    types[cell] = 0;
                } else if (q < len && (buf[q] == '.' || buf[q] == 'e' ||
                                buf[q] == 'E')) {
                    /* double: let strtod do the rest from dstart */
                    char tmp[64];
                    size_t dl = 0;
                    while (dstart + dl < len && dl < 63) {
                        uint8_t ch = buf[dstart + dl];
                        if (!((ch >= '0' && ch <= '9') || ch == '.' ||
                              ch == 'e' || ch == 'E' || ch == '+' ||
                              ch == '-'))
                            break;
                        tmp[dl] = (char)ch;
                        dl++;
                    }
                    tmp[dl] = 0;
                    char *endp = 0;
                    nums[cell] = strtod(tmp, &endp);
                    if (endp == tmp) return -1;
                    p = dstart + (size_t)(endp - tmp);
                    types[cell] = 1;
                } else if (overflow) {
                    bad[r] = 1; /* precision beyond int64: python decodes */
                    p = q;
                    types[cell] = 0;
                } else {
                    lints[cell] = neg ? -iv : iv;
                    p = q;
                    types[cell] = 8;
                }
            } else {
                /* nested value under a KNOWN key: python re-parses record */
                bad[r] = 1;
                if (skip_value(buf, len, &p)) return -1;
            }
        }
        rec_len[r] = (long long)p - rec_off[r];
        skip_ws(buf, len, &p);
        if (r + 1 < n_records) {
            if (p >= len || buf[p] != ',') return -1;
            p++;
        }
    }
    /* the record count is transport metadata, not producer-validated JSON:
     * trailing bytes mean a value smuggled extra top-level objects — the
     * whole batch is rejected so the caller's per-message decode isolates
     * the bad record instead of silently dropping/duplicating rows */
    skip_ws(buf, len, &p);
    if (p != len) return -1;
    return n_records;
}

long pinot_decode_records(const uint8_t *buf, size_t len,
                          long long base_offset, long long first_ts,
                          long max_records,
                          long long *offsets, long long *ts,
                          long long *key_off, long long *key_len,
                          long long *val_off, long long *val_len) {
    size_t pos = 0;
    long n = 0;
    while (n < max_records && pos < len) {
        int64_t rec_len, ts_delta, off_delta, klen, vlen, hdrs;
        if (read_varint(buf, len, &pos, &rec_len) || rec_len < 0) return -1;
        size_t rec_end = pos + (size_t)rec_len;
        if (rec_end > len) return -1;
        if (pos >= rec_end) return -1;
        pos++; /* record attributes */
        if (read_varint(buf, rec_end, &pos, &ts_delta)) return -1;
        if (read_varint(buf, rec_end, &pos, &off_delta)) return -1;
        if (read_varint(buf, rec_end, &pos, &klen)) return -1;
        if (klen >= 0) {
            if (pos + (size_t)klen > rec_end) return -1;
            key_off[n] = (long long)pos;
            key_len[n] = klen;
            pos += (size_t)klen;
        } else {
            key_off[n] = -1;
            key_len[n] = -1;
        }
        if (read_varint(buf, rec_end, &pos, &vlen)) return -1;
        if (vlen >= 0) {
            if (pos + (size_t)vlen > rec_end) return -1;
            val_off[n] = (long long)pos;
            val_len[n] = vlen;
            pos += (size_t)vlen;
        } else {
            val_off[n] = -1;
            val_len[n] = 0;
        }
        /* headers: count then (key varint+bytes, value varint+bytes) each;
         * zigzag on the count mirrors the encoder's uvarint(0) == varint 0 */
        if (read_varint(buf, rec_end, &pos, &hdrs)) return -1;
        if (hdrs < 0) hdrs = 0;
        for (int64_t h = 0; h < hdrs; h++) {
            int64_t hk, hv;
            if (read_varint(buf, rec_end, &pos, &hk) || hk < 0) return -1;
            pos += (size_t)hk;
            if (read_varint(buf, rec_end, &pos, &hv)) return -1;
            if (hv > 0) pos += (size_t)hv;
            if (pos > rec_end) return -1;
        }
        offsets[n] = base_offset + off_delta;
        ts[n] = first_ts + ts_delta;
        n++;
        pos = rec_end;
    }
    return n;
}
