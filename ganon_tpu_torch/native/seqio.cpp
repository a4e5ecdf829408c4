// Native sequence reader: FASTA/FASTQ (plain or gzip) -> dna4 rank batches.
//
// Host-side hot path of the classify pipeline (the reference runs its
// parser in a dedicated C++ thread, GanonClassify.cpp:1220-1287; here the
// parser also 2-bit-encodes straight into the pinned numpy batch buffer
// that feeds the TPU). Exposed through a C ABI consumed via ctypes.
//
// Encoding: A=0 C=1 G=2 T=3, U->T, everything else -> A (dna4 semantics,
// see ganon_tpu/ops/minimizers.py).

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

namespace {

struct Reader {
    gzFile gz = nullptr;          // zlib reads plain files transparently
    bool fastq = false;
    bool eof = false;
    std::string pending;          // lookahead line (fasta headers)
    bool has_pending = false;
    std::string pending_hdr, pending_sq;  // stashed overlong record
    bool has_pending_read = false;        // (seqio_next_batch2)
    std::vector<char> buf;
    // piece-streaming state (seqio_next_pieces)
    std::string seqbuf;           // unemitted tail of the current sequence
    bool mid_seq = false;         // inside a sequence spanning calls
    bool seq_complete = false;    // no more lines belong to this sequence
    bool emitted_any = false;     // pieces already emitted for current seq
    int64_t cur_len = 0;          // bases seen of the current sequence
    int64_t n_seqs = 0, n_skipped = 0, total_bp = 0;

    bool getline(std::string& out) {
        if (has_pending) {
            out = std::move(pending);
            has_pending = false;
            return true;
        }
        out.clear();
        char chunk[4096];
        for (;;) {
            if (gzgets(gz, chunk, sizeof(chunk)) == nullptr) {
                eof = true;
                return !out.empty();
            }
            size_t n = std::strlen(chunk);
            bool nl = n > 0 && chunk[n - 1] == '\n';
            if (nl) --n;
            if (n > 0 && chunk[n - 1] == '\r') --n;
            out.append(chunk, n);
            if (nl) return true;
        }
    }
};

uint8_t g_lut[256];

struct LutInit {
    LutInit() {
        std::memset(g_lut, 0, sizeof(g_lut));
        g_lut[(unsigned char)'C'] = g_lut[(unsigned char)'c'] = 1;
        g_lut[(unsigned char)'G'] = g_lut[(unsigned char)'g'] = 2;
        g_lut[(unsigned char)'T'] = g_lut[(unsigned char)'t'] = 3;
        g_lut[(unsigned char)'U'] = g_lut[(unsigned char)'u'] = 3;
    }
} g_lut_init;

void encode_into(const std::string& seq, uint8_t* row, int64_t max_len) {
    const int64_t n = std::min<int64_t>(seq.size(), max_len);
    for (int64_t i = 0; i < n; ++i)
        row[i] = g_lut[(unsigned char)seq[i]];
}

} // namespace

extern "C" {

// Open a sequence file; returns a handle (nullptr on failure).
void* seqio_open(const char* path) {
    gzFile gz = gzopen(path, "rb");
    if (!gz) return nullptr;
    gzbuffer(gz, 1 << 20);
    auto* r = new Reader();
    r->gz = gz;
    // detect format from the first record char
    std::string first;
    if (!r->getline(first) || first.empty()) {
        gzclose(gz);
        delete r;
        return nullptr;
    }
    r->fastq = first[0] == '@';
    if (!r->fastq && first[0] != '>') {
        gzclose(gz);
        delete r;
        return nullptr;
    }
    r->pending = std::move(first);
    r->has_pending = true;
    return r;
}

void seqio_close(void* handle) {
    auto* r = static_cast<Reader*>(handle);
    if (r) {
        gzclose(r->gz);
        delete r;
    }
}

// Read up to max_reads records. Writes dna4 codes into codes[max_reads x
// max_len] (row-major, pre-zeroed by caller or overwritten here), true
// lengths into lengths[max_reads], and ids separated by '\n' into ids_buf
// (truncated if ids_cap reached). Returns number of records read, or -1
// on error.
int64_t seqio_next_batch(void* handle, int64_t max_reads, int64_t max_len,
                         uint8_t* codes, int32_t* lengths, char* ids_buf,
                         int64_t ids_cap) {
    auto* r = static_cast<Reader*>(handle);
    if (!r) return -1;
    int64_t count = 0;
    int64_t ids_len = 0;
    std::string line, header, seq;
    while (count < max_reads) {
        if (!r->getline(header)) break;
        if (header.empty()) continue;
        seq.clear();
        if (r->fastq) {
            if (!r->getline(seq)) break;
            r->getline(line);  // +
            r->getline(line);  // qual
        } else {
            // fasta: concatenate until next header / EOF
            for (;;) {
                if (!r->getline(line)) break;
                if (!line.empty() && line[0] == '>') {
                    r->pending = std::move(line);
                    r->has_pending = true;
                    break;
                }
                seq.append(line);
                if (r->eof) break;
            }
        }
        uint8_t* row = codes + count * max_len;
        std::memset(row, 0, max_len);
        encode_into(seq, row, max_len);
        lengths[count] = (int32_t)seq.size();
        // id: header without '>'/'@'
        const char* id = header.c_str() + 1;
        int64_t idn = (int64_t)header.size() - 1;
        if (ids_len + idn + 1 < ids_cap) {
            std::memcpy(ids_buf + ids_len, id, idn);
            ids_len += idn;
            ids_buf[ids_len++] = '\n';
        }
        ++count;
    }
    if (ids_len < ids_cap) ids_buf[ids_len] = '\0';
    return count;
}

// Like seqio_next_batch, but NEVER truncates: a record longer than
// max_len is stashed inside the reader, *needed is set to its length,
// and the call returns the records read so far (possibly 0). The caller
// re-invokes with a larger max_len and the stashed record leads the next
// batch. Keeps row buffers sized to the reads actually seen instead of a
// worst-case width (a fixed 16 KB row costs ~270 MB of memset per 8K
// batch of 150 bp reads — the measured host-side classify bottleneck).
int64_t seqio_next_batch2(void* handle, int64_t max_reads, int64_t max_len,
                          uint8_t* codes, int32_t* lengths, char* ids_buf,
                          int64_t ids_cap, int64_t* needed) {
    auto* r = static_cast<Reader*>(handle);
    if (!r) return -1;
    *needed = 0;
    int64_t count = 0;
    int64_t ids_len = 0;
    std::string line, header, seq;
    while (count < max_reads) {
        if (r->has_pending_read) {
            header = std::move(r->pending_hdr);
            seq = std::move(r->pending_sq);
            r->has_pending_read = false;
        } else {
            if (!r->getline(header)) break;
            if (header.empty()) continue;
            seq.clear();
            if (r->fastq) {
                if (!r->getline(seq)) break;
                r->getline(line);  // +
                r->getline(line);  // qual
            } else {
                for (;;) {
                    if (!r->getline(line)) break;
                    if (!line.empty() && line[0] == '>') {
                        r->pending = std::move(line);
                        r->has_pending = true;
                        break;
                    }
                    seq.append(line);
                    if (r->eof) break;
                }
            }
        }
        if ((int64_t)seq.size() > max_len) {
            r->pending_hdr = std::move(header);
            r->pending_sq = std::move(seq);
            r->has_pending_read = true;
            *needed = (int64_t)r->pending_sq.size();
            break;
        }
        uint8_t* row = codes + count * max_len;
        std::memset(row, 0, max_len);
        encode_into(seq, row, max_len);
        lengths[count] = (int32_t)seq.size();
        const char* id = header.c_str() + 1;
        int64_t idn = (int64_t)header.size() - 1;
        if (ids_len + idn + 1 < ids_cap) {
            std::memcpy(ids_buf + ids_len, id, idn);
            ids_len += idn;
            ids_buf[ids_len++] = '\n';
        }
        ++count;
    }
    if (ids_len < ids_cap) ids_buf[ids_len] = '\0';
    return count;
}

// Stream encoded sequence pieces for index construction: long sequences
// are chunked to chunk_len with `overlap` bases carried between
// consecutive pieces (so every k-mer window is covered exactly once);
// sequences shorter than min_len are skipped (min_len must be <=
// chunk_len — longer sequences are always kept). Writes dna4 codes into
// codes[max_pieces x chunk_len] and true piece lengths into lens.
// Returns pieces written (0 = EOF). stats[0..2] += sequences read,
// sequences skipped, total bases.
int64_t seqio_next_pieces(void* handle, int64_t max_pieces,
                          int64_t chunk_len, int64_t overlap,
                          int64_t min_len, uint8_t* codes, int32_t* lens,
                          int64_t* stats) {
    auto* r = static_cast<Reader*>(handle);
    if (!r || overlap >= chunk_len) return -1;
    int64_t count = 0;
    std::string line, header;
    auto emit = [&](const std::string& s, int64_t take) {
        uint8_t* row = codes + count * chunk_len;
        for (int64_t i = 0; i < take; ++i)
            row[i] = g_lut[(unsigned char)s[i]];
        if (take < chunk_len)
            std::memset(row + take, 0, chunk_len - take);
        lens[count] = (int32_t)take;
        ++count;
    };
    while (count < max_pieces) {
        if (!r->mid_seq) {
            if (!r->getline(header) || header.empty()) {
                if (r->eof) break;
                continue;
            }
            r->mid_seq = true;
            r->seq_complete = false;
            r->emitted_any = false;
            r->seqbuf.clear();
            r->cur_len = 0;
            if (r->fastq) {
                r->getline(r->seqbuf);
                r->cur_len = (int64_t)r->seqbuf.size();
                r->getline(line);  // +
                r->getline(line);  // qual
                r->seq_complete = true;
            }
        }
        // emit full pieces / accumulate lines until sequence end
        for (;;) {
            if ((int64_t)r->seqbuf.size() >= chunk_len) {
                if (count >= max_pieces) return count;  // resume later
                emit(r->seqbuf, chunk_len);
                r->emitted_any = true;
                r->seqbuf.erase(0, chunk_len - overlap);
                continue;
            }
            if (r->seq_complete) break;
            if (!r->getline(line)) {  // EOF
                r->seq_complete = true;
                continue;
            }
            if (!line.empty() && line[0] == '>') {
                r->pending = std::move(line);
                r->has_pending = true;
                r->seq_complete = true;
                continue;
            }
            r->seqbuf.append(line);
            r->cur_len += (int64_t)line.size();
        }
        if (!r->seqbuf.empty() && count >= max_pieces)
            return count;  // tail needs a slot; finish on the next call
        r->mid_seq = false;
        ++r->n_seqs;
        if (!r->emitted_any && r->cur_len < min_len) {
            ++r->n_skipped;
            r->seqbuf.clear();
            continue;
        }
        r->total_bp += r->cur_len;
        if (!r->seqbuf.empty()) {
            // tail piece (or whole short sequence); a tail no longer
            // than the overlap adds no new window when pieces were
            // already emitted
            if (!(r->emitted_any &&
                  (int64_t)r->seqbuf.size() <= overlap))
                emit(r->seqbuf, (int64_t)r->seqbuf.size());
            r->seqbuf.clear();
        }
    }
    if (stats) {
        stats[0] += r->n_seqs;
        stats[1] += r->n_skipped;
        stats[2] += r->total_bp;
        r->n_seqs = r->n_skipped = r->total_bp = 0;
    }
    return count;
}

} // extern "C"
