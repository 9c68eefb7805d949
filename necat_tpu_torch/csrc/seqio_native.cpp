// Native sequence ingest: FASTA/FASTQ (plain or gzip) -> 2-bit codes.
//
// C++ replacement for the role of the reference's kseq.h parser + PackedDB
// ingest loop (reference: src/klib/kseq.h, src/common/packed_db.c:228-253
// pdb_add_one_seq): a single pass over the decompressed bytes emits the
// concatenated uint8 code array (A=0 C=1 G=2 T=3, other -> 0, matching
// nst_nt4 truncation, src/common/nst_nt4_table.h), the int64 offset table,
// and a '\n'-joined name blob. Exposed via a C ABI for ctypes.
//
// Built with kmer_index_native.cpp into build/libnecat_native.so by
// necat_tpu_torch/native.py (g++, at first use).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

struct Table {
    uint8_t t[256];
    Table() {
        memset(t, 0, sizeof(t));
        t[(int)'C'] = t[(int)'c'] = 1;
        t[(int)'G'] = t[(int)'g'] = 2;
        t[(int)'T'] = t[(int)'t'] = 3;
    }
};
const Table kTable;

// Read a whole file through zlib (gzread handles plain files transparently).
bool read_all(const char* path, std::vector<char>& out) {
    gzFile f = gzopen(path, "rb");
    if (!f) return false;
    gzbuffer(f, 1 << 20);
    const size_t chunk = 16u << 20;
    size_t used = 0;
    for (;;) {
        out.resize(used + chunk);
        int n = gzread(f, out.data() + used, (unsigned)chunk);
        if (n < 0) { gzclose(f); return false; }
        used += (size_t)n;
        if ((size_t)n < chunk) break;
    }
    out.resize(used);
    gzclose(f);
    return true;
}

}  // namespace

extern "C" {

// Parse FASTA/FASTQ(.gz). On success returns 0 and fills:
//   *bases    malloc'd uint8[*total]   2-bit codes
//   *offsets  malloc'd int64[*n_reads + 1]
//   *names    malloc'd char blob (names joined by '\n'), length *names_len
// Caller frees each with nt_free.
int nt_parse_seq_file(const char* path,
                      uint8_t** bases, int64_t* total,
                      int64_t** offsets, int64_t* n_reads,
                      char** names, int64_t* names_len) {
    std::vector<char> data;
    if (!read_all(path, data)) return 1;
    if (data.empty()) {
        *bases = (uint8_t*)malloc(1);
        *offsets = (int64_t*)malloc(sizeof(int64_t));
        (*offsets)[0] = 0;
        *total = 0; *n_reads = 0;
        *names = (char*)malloc(1); (*names)[0] = 0; *names_len = 0;
        return 0;
    }
    const char first = data[0];
    if (first != '>' && first != '@') return 2;
    const bool fastq = (first == '@');

    uint8_t* code = (uint8_t*)malloc(data.size() ? data.size() : 1);
    if (!code) return 3;
    std::vector<int64_t> offs;
    offs.push_back(0);
    std::string nameblob;
    nameblob.reserve(1 << 16);

    const char* p = data.data();
    const char* end = p + data.size();
    int64_t w = 0;

    auto parse_name = [&](const char* line_end) {
        // first whitespace-delimited token after the marker
        const char* q = p + 1;
        const char* tok_end = q;
        while (tok_end < line_end && *tok_end != ' ' && *tok_end != '\t' &&
               *tok_end != '\r')
            ++tok_end;
        if (!nameblob.empty()) nameblob.push_back('\n');
        nameblob.append(q, tok_end);
    };

    if (!fastq) {
        while (p < end) {
            // header line
            const char* nl = (const char*)memchr(p, '\n', end - p);
            if (!nl) nl = end;
            parse_name(nl);
            p = nl < end ? nl + 1 : end;
            // sequence lines until next '>'
            while (p < end && *p != '>') {
                const char* snl = (const char*)memchr(p, '\n', end - p);
                if (!snl) snl = end;
                for (const char* c = p; c < snl; ++c) {
                    unsigned char ch = (unsigned char)*c;
                    if (ch != '\r') code[w++] = kTable.t[ch];
                }
                p = snl < end ? snl + 1 : end;
            }
            offs.push_back(w);
        }
    } else {
        while (p < end) {
            if (*p != '@') return 4;
            const char* nl = (const char*)memchr(p, '\n', end - p);
            if (!nl) break;
            parse_name(nl);
            p = nl + 1;
            // sequence (single line in FASTQ)
            const char* snl = (const char*)memchr(p, '\n', end - p);
            if (!snl) snl = end;
            int64_t slen = 0;
            for (const char* c = p; c < snl; ++c) {
                unsigned char ch = (unsigned char)*c;
                if (ch != '\r') { code[w++] = kTable.t[ch]; ++slen; }
            }
            offs.push_back(w);
            p = snl < end ? snl + 1 : end;
            // '+' line
            const char* pnl = (const char*)memchr(p, '\n', end - p);
            if (!pnl) break;
            p = pnl + 1;
            // quality line: same length as sequence (may contain '@')
            int64_t q = 0;
            while (p < end && q < slen) {
                if (*p != '\n' && *p != '\r') ++q;
                ++p;
            }
            while (p < end && (*p == '\n' || *p == '\r')) ++p;
        }
    }

    int64_t nr = (int64_t)offs.size() - 1;
    int64_t* off_out = (int64_t*)malloc(sizeof(int64_t) * offs.size());
    memcpy(off_out, offs.data(), sizeof(int64_t) * offs.size());
    char* nb = (char*)malloc(nameblob.size() ? nameblob.size() : 1);
    memcpy(nb, nameblob.data(), nameblob.size());

    *bases = code;
    *total = w;
    *offsets = off_out;
    *n_reads = nr;
    *names = nb;
    *names_len = (int64_t)nameblob.size();
    return 0;
}

void nt_free(void* p) { free(p); }

}  // extern "C"
