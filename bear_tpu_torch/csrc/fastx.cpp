// Host-side streaming FASTA/FASTQ parser + 2-bit base encoder, count-TSV
// parser and formatter, and the chunk packer's row copy (the port's own copy
// of bear_tpu/counting/_fastx.cpp; same C ABI, same bytes out).
//
// One buffered pass over the input emits concatenated int8 base codes and
// per-sequence offsets with no intermediate files. Exposed via a minimal C
// ABI consumed with ctypes (bear_tpu_torch/counting/native.py); built on the
// host by bear_tpu_torch/_build.py:
//
//   g++ -O3 -std=c++17 -shared -fPIC [-DBEAR_HAS_ZLIB -lz] -o libfastx.so fastx.cpp

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#ifdef BEAR_HAS_ZLIB
#include <zlib.h>
#endif

namespace {

struct Parsed {
  std::vector<int8_t> codes;     // concatenated 2-bit base codes
  std::vector<int64_t> offsets;  // n_seqs + 1 prefix offsets into codes
};

// ASCII -> 2-bit code; anything outside ACGTacgt maps to 0 (A), matching the
// Python fallback and the reference's documented non-handling of N. The
// second table instead marks ambiguous bases with code 4 (for the counting
// engine's ambig="skip" mode, which drops transitions whose window crosses
// an ambiguous base).
int8_t kEncode[256];
int8_t kEncodeAmbig[256];

struct EncodeInit {
  EncodeInit() {
    memset(kEncode, 0, sizeof(kEncode));
    memset(kEncodeAmbig, 4, sizeof(kEncodeAmbig));
    const char* bases = "AaCcGgTt";
    for (int i = 0; i < 8; ++i) {
      kEncode[(unsigned char)bases[i]] = (int8_t)(i / 2);
      kEncodeAmbig[(unsigned char)bases[i]] = (int8_t)(i / 2);
    }
  }
} encode_init;

// Active table for the current parse (parse runs are single-threaded per
// handle; thread_local keeps concurrent parses independent).
thread_local const int8_t* g_encode = kEncode;

void append_encoded(Parsed* out, const char* s, size_t n) {
  size_t base = out->codes.size();
  out->codes.resize(base + n);
  for (size_t i = 0; i < n; ++i) {
    out->codes[base + i] = g_encode[(unsigned char)s[i]];
  }
}

// Line source over either stdio or zlib. With BEAR_HAS_ZLIB the file is
// opened through gzopen, which reads gzip members transparently and passes
// plain files through unchanged — one code path for .fastq and .fastq.gz.
struct Stream {
#ifdef BEAR_HAS_ZLIB
  gzFile f = nullptr;
  bool open(const char* path) {
    f = gzopen(path, "rb");
    if (f) gzbuffer(f, 1 << 20);
    return f != nullptr;
  }
  void close() {
    if (f) gzclose(f);
  }
  char* gets(char* buf, int n) { return gzgets(f, buf, n); }
  // gzgets returns NULL for both EOF and errors; a truncated gzip member
  // reports Z_BUF_ERROR ("unexpected end of file") and a corrupt one
  // Z_DATA_ERROR — without this check they would parse as silently shorter
  // files (the Python gzip fallback raises on the same inputs).
  bool ok() {
    int errnum = Z_OK;
    gzerror(f, &errnum);
    return errnum == Z_OK || errnum == Z_STREAM_END;
  }
#else
  FILE* f = nullptr;
  bool open(const char* path) {
    f = fopen(path, "rb");
    return f != nullptr;
  }
  void close() {
    if (f) fclose(f);
  }
  char* gets(char* buf, int n) { return fgets(buf, n, f); }
  bool ok() { return !ferror(f); }
#endif
};

// Why the last bear_fastx_parse returned nullptr: 0 none, 1 open failure,
// 2 read/decode error (truncated or corrupt input).
thread_local int g_last_error = 0;

bool read_line(Stream& f, std::string& line) {
  line.clear();
  char buf[1 << 16];
  while (f.gets(buf, sizeof(buf))) {
    size_t n = strlen(buf);
    bool eol = n > 0 && buf[n - 1] == '\n';
    if (eol) --n;
    if (n > 0 && buf[n - 1] == '\r') --n;
    line.append(buf, n);
    if (eol) return true;
  }
  return !line.empty();
}

Parsed* parse_fasta(Stream& f) {
  auto* out = new Parsed();
  out->offsets.push_back(0);
  std::string line;
  bool in_seq = false;
  while (read_line(f, line)) {
    if (line.empty()) continue;
    if (line[0] == '>') {
      if (in_seq) out->offsets.push_back((int64_t)out->codes.size());
      in_seq = true;
    } else if (in_seq) {
      append_encoded(out, line.data(), line.size());
    }
  }
  if (in_seq) out->offsets.push_back((int64_t)out->codes.size());
  return out;
}

Parsed* parse_fastq(Stream& f) {
  auto* out = new Parsed();
  out->offsets.push_back(0);
  std::string header, seq, plus, qual;
  while (read_line(f, header)) {
    if (header.empty()) continue;
    if (!read_line(f, seq)) break;
    read_line(f, plus);
    read_line(f, qual);
    append_encoded(out, seq.data(), seq.size());
    out->offsets.push_back((int64_t)out->codes.size());
  }
  return out;
}

struct TsvParsed {
  std::vector<char> kmers;     // n_rows fixed-width byte strings, no seps
  std::vector<double> counts;  // n_rows * n_groups * n_cols
  int64_t kmer_len = 0;
  int64_t n_rows = 0;
};

// One numeric field at p (within [p, end); *end is NUL). Fast path for the
// common case (plain nonnegative integers in count TSVs); strtod for
// anything with a sign/decimal/exponent. Returns false if no number starts
// at p.
inline bool parse_count(const char*& p, const char* end, double* out) {
  const char* q = p;
  uint64_t v = 0;
  int nd = 0;
  while (q < end && *q >= '0' && *q <= '9' && nd < 18) {
    v = v * 10 + (uint64_t)(*q - '0');
    ++q;
    ++nd;
  }
  if (nd > 0 &&
      (q == end || (*q != '.' && *q != 'e' && *q != 'E' &&
                    !(*q >= '0' && *q <= '9')))) {
    *out = (double)v;
    p = q;
    return true;
  }
  // strtod skips leading whitespace INCLUDING '\n' — a short row must not
  // steal fields from the next line, so only dispatch when a number starts
  // exactly at p.
  if (p == end ||
      !((*p >= '0' && *p <= '9') || *p == '-' || *p == '+' || *p == '.'))
    return false;
  char* endp;
  double d = strtod(p, &endp);  // buffer is NUL-terminated at end
  if (endp == p || endp > end) return false;
  *out = d;
  p = endp;
  return true;
}

}  // namespace

extern "C" {

// Parse a file. type: 0 = fasta, 1 = fastq. ambig: 0 = unknown bases encode
// as 0/A (reference-compatible), 1 = unknown bases encode as 4 (ambiguity
// marker for skip mode). Returns an opaque handle (nullptr on failure).
void* bear_fastx_parse2(const char* path, int type, int ambig) {
  g_last_error = 0;
  g_encode = ambig ? kEncodeAmbig : kEncode;
  Stream f;
  if (!f.open(path)) {
    g_last_error = 1;
    return nullptr;
  }
  Parsed* out = type == 1 ? parse_fastq(f) : parse_fasta(f);
  bool ok = f.ok();
  f.close();
  if (!ok) {
    delete out;
    g_last_error = 2;
    return nullptr;
  }
  return out;
}

void* bear_fastx_parse(const char* path, int type) {
  return bear_fastx_parse2(path, type, 0);
}

int bear_fastx_last_error(void) { return g_last_error; }

// 1 when the library was built against zlib (gzip inputs read natively).
int bear_fastx_supports_gzip(void) {
#ifdef BEAR_HAS_ZLIB
  return 1;
#else
  return 0;
#endif
}

int64_t bear_fastx_num_seqs(void* handle) {
  return (int64_t)((Parsed*)handle)->offsets.size() - 1;
}

int64_t bear_fastx_total_bases(void* handle) {
  return (int64_t)((Parsed*)handle)->codes.size();
}

const int8_t* bear_fastx_codes(void* handle) {
  return ((Parsed*)handle)->codes.data();
}

const int64_t* bear_fastx_offsets(void* handle) {
  return ((Parsed*)handle)->offsets.data();
}

void bear_fastx_free(void* handle) { delete (Parsed*)handle; }

// Fill a padded [B, L] chunk of base codes from a packed code buffer: one
// memcpy (or reverse-complement copy) per row. This is the hot host-side
// gather of the chunk packer (engine.chunks_from_packed) — the NumPy
// fancy-index equivalent builds multi-hundred-MB index temporaries and runs
// ~10x slower. starts[b] is the source position of row b's FIRST emitted
// base: for rc rows that is the LAST base of the forward-strand range (the
// copy walks backward emitting 3 - code). out must be zero-initialized.
void bear_fill_chunks(const int8_t* codes, const int64_t* starts,
                      const int32_t* lens, const uint8_t* rc, int64_t n_rows,
                      int64_t row_stride, int8_t* out) {
  for (int64_t b = 0; b < n_rows; ++b) {
    int8_t* dst = out + b * row_stride;
    const int32_t n = lens[b];
    if (!rc[b]) {
      memcpy(dst, codes + starts[b], (size_t)n);
    } else {
      const int8_t* p = codes + starts[b];
      for (int32_t i = 0; i < n; ++i) dst[i] = (int8_t)(3 - p[-i]);
    }
  }
}

// Format reference-style count TSV rows (engine.export_tsv):
//   "<kmer>\t[[c0,c1,c2,c3,c4],[...per group...]]\n"
// kmers: n_rows fixed-width byte strings of length kmer_len (no separators);
// counts: int64 [n_rows, n_groups, n_cols] C-contiguous. out must hold at
// least n_rows * (kmer_len + 3 + n_groups * (n_cols * 21 + 3)) bytes.
// Returns the number of bytes written. The Python np.char / str() paths
// measure ~0.1 Mrows/s; this loop formats >5 Mrows/s.
int64_t bear_format_tsv(const char* kmers, int64_t kmer_len,
                        const int64_t* counts, int64_t n_rows,
                        int64_t n_groups, int64_t n_cols, char* out) {
  char* p = out;
  const int64_t* c = counts;
  for (int64_t r = 0; r < n_rows; ++r) {
    memcpy(p, kmers + r * kmer_len, (size_t)kmer_len);
    p += kmer_len;
    *p++ = '\t';
    *p++ = '[';
    for (int64_t g = 0; g < n_groups; ++g) {
      if (g) *p++ = ',';
      *p++ = '[';
      for (int64_t k = 0; k < n_cols; ++k) {
        if (k) *p++ = ',';
        // int64 -> decimal ascii (values are nonnegative counts).
        uint64_t v = (uint64_t)*c++;
        char buf[20];
        int nd = 0;
        do {
          buf[nd++] = (char)('0' + v % 10);
          v /= 10;
        } while (v);
        while (nd) *p++ = buf[--nd];
      }
      *p++ = ']';
    }
    *p++ = ']';
    *p++ = '\n';
  }
  return (int64_t)(p - out);
}

// Parse a dense count TSV (the reference dataloader.dataloader format):
// rows "<kmer>\t[[c00,c01,...],[c10,...]]" with exactly n_groups * n_cols
// numeric fields per row and a fixed context width (set by the first data
// row). Blank lines are skipped; CRLF accepted; with skip_header the first
// line is dropped. Reads through gzopen when built with zlib, so .tsv.gz
// works transparently. Returns nullptr on ANY irregularity (ragged
// contexts, wrong field count, trailing junk) — the caller falls back to
// the tolerant Python parser, which '['-pads ragged contexts.
void* bear_tsv_parse(const char* path, int skip_header, int64_t n_groups,
                     int64_t n_cols) {
  g_last_error = 0;
  Stream f;
  if (!f.open(path)) {
    g_last_error = 1;
    return nullptr;
  }
  std::string data;
#ifdef BEAR_HAS_ZLIB
  {
    char buf[1 << 20];
    int n;
    while ((n = gzread(f.f, buf, sizeof(buf))) > 0) data.append(buf, (size_t)n);
  }
#else
  {
    char buf[1 << 20];
    size_t n;
    while ((n = fread(buf, 1, sizeof(buf), f.f)) > 0) data.append(buf, n);
  }
#endif
  bool ok = f.ok();
  f.close();
  if (!ok) {
    g_last_error = 2;
    return nullptr;
  }

  const char* p = data.data();
  const char* end = p + data.size();  // data.data()[size] is NUL (C++11)
  const int64_t fields = n_groups * n_cols;
  auto* out = new TsvParsed();
  // Reserve from the first row's byte length (cheap; vectors grow if short).
  {
    const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
    size_t row_bytes = nl ? (size_t)(nl - p) + 1 : data.size() + 1;
    size_t est = data.size() / row_bytes + 16;
    out->counts.reserve(est * (size_t)fields);
  }
  if (skip_header && p < end) {
    const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
    p = nl ? nl + 1 : end;
  }
  while (p < end) {
    // Blank (or CR-only) lines are skipped, as in the Python parser.
    if (*p == '\n') {
      ++p;
      continue;
    }
    if (*p == '\r' && p + 1 < end && p[1] == '\n') {
      p += 2;
      continue;
    }
    const char* tab = (const char*)memchr(p, '\t', (size_t)(end - p));
    if (!tab) goto fail;
    {
      int64_t klen = (int64_t)(tab - p);
      if (out->n_rows == 0) {
        out->kmer_len = klen;
        out->kmers.reserve((out->counts.capacity() / (size_t)fields) *
                           (size_t)klen);
      } else if (klen != out->kmer_len) {
        goto fail;  // ragged contexts: Python fallback '['-pads them
      }
      out->kmers.insert(out->kmers.end(), p, tab);
    }
    p = tab + 1;
    for (int64_t k = 0; k < fields; ++k) {
      while (p < end &&
             (*p == '[' || *p == ']' || *p == ',' || *p == ' ' || *p == '\r'))
        ++p;
      double v;
      if (!parse_count(p, end, &v)) goto fail;
      out->counts.push_back(v);
    }
    while (p < end &&
           (*p == '[' || *p == ']' || *p == ',' || *p == ' ' || *p == '\r'))
      ++p;
    if (p < end) {
      if (*p != '\n') goto fail;  // extra fields / junk: wrong field count
      ++p;
    }
    ++out->n_rows;
  }
  return out;
fail:
  delete out;
  g_last_error = 3;  // format mismatch: use the Python fallback
  return nullptr;
}

int64_t bear_tsv_num_rows(void* handle) { return ((TsvParsed*)handle)->n_rows; }

int64_t bear_tsv_kmer_len(void* handle) {
  return ((TsvParsed*)handle)->kmer_len;
}

const char* bear_tsv_kmers(void* handle) {
  return ((TsvParsed*)handle)->kmers.data();
}

const double* bear_tsv_counts(void* handle) {
  return ((TsvParsed*)handle)->counts.data();
}

void bear_tsv_free(void* handle) { delete (TsvParsed*)handle; }

}  // extern "C"
