// Native VCF genotype reader and imputed-VCF body writer of the PyTorch
// port: a copy of rag_snvbert_tpu/native/vcf_reader.cpp (the port builds
// and loads its own, so it imports nothing of the JAX package).  Host code,
// not a device kernel.
//
// The reference reads VCFs through scikit-allel's C backend
// (src/dataset/dataset.py:296-353); this is the equivalent native surface:
// a two-pass gzip-aware parser that fills caller-allocated numpy buffers
// with the binarized phased GT matrix.  The Python parser
// (io/vcf.py:read_vcf) stays as the reference implementation; ctypes
// bindings live in io/_native.py.
//
// Pass 1 (vcf_scan): count data rows + samples so Python can allocate
//   buffers.
// Pass 2 (vcf_parse_gt): per data line, parse POS and the first
//   colon-subfield of every sample column into gt[v, s, {0,1}] with any
//   non-'0'/'.' allele binarized to 1 (matching vcf_data[vcf_data>0]=1).
//
// Build (io/_native.py, at first use):
//   g++ -O3 -shared -fPIC vcf_reader.cpp -lz -o libvcf_reader-<hash>.so

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Buffered gzip line reader (gzgets is fine; zlib transparently reads
// uncompressed files too).
class LineReader {
 public:
  explicit LineReader(const char* path) : f_(gzopen(path, "rb")) {
    buf_.resize(1 << 20);
  }
  ~LineReader() {
    if (f_) gzclose(f_);
  }
  bool ok() const { return f_ != nullptr; }

  // Returns pointer to a NUL-terminated line (without trailing newline),
  // or nullptr at EOF.  Grows the buffer for arbitrarily long lines.
  char* next() {
    size_t len = 0;
    for (;;) {
      if (gzgets(f_, buf_.data() + len, (int)(buf_.size() - len)) == nullptr) {
        return len ? buf_.data() : nullptr;
      }
      len += strlen(buf_.data() + len);
      if (len && buf_[len - 1] == '\n') {
        buf_[len - 1] = '\0';
        return buf_.data();
      }
      if (len + 1 >= buf_.size()) buf_.resize(buf_.size() * 2);
      else return buf_.data();  // EOF without newline
    }
  }

 private:
  gzFile f_;
  std::vector<char> buf_;
};

int count_tabs_until(const char* p, int limit) {
  int tabs = 0;
  while (*p && tabs < limit) {
    if (*p == '\t') ++tabs;
    ++p;
  }
  return tabs;
}

}  // namespace

extern "C" {

// Pass 1: -1 on open failure, else 0.  n_samples from the #CHROM header,
// n_variants = number of data lines.
int vcf_scan(const char* path, int64_t* n_variants, int64_t* n_samples) {
  LineReader r(path);
  if (!r.ok()) return -1;
  int64_t nv = 0, ns = 0;
  for (char* line = r.next(); line; line = r.next()) {
    if (line[0] == '#') {
      if (line[1] == 'C') {  // #CHROM header: samples = fields - 9
        int64_t fields = 1;
        for (const char* p = line; *p; ++p)
          if (*p == '\t') ++fields;
        ns = fields - 9;
      }
      continue;
    }
    if (line[0] == '\0') continue;
    ++nv;
  }
  *n_variants = nv;
  *n_samples = ns;
  return 0;
}

// Pass 2: fill gt [n_variants * n_samples * 2] int8 and pos [n_variants]
// int64.  Returns number of variants parsed, or -1 on open failure, -2 on
// a malformed row (fewer than 9 tabs or sample-count mismatch).
int64_t vcf_parse_gt(const char* path, int8_t* gt, int64_t* pos,
                     int64_t n_variants, int64_t n_samples) {
  LineReader r(path);
  if (!r.ok()) return -1;
  int64_t v = 0;
  for (char* line = r.next(); line && v < n_variants; line = r.next()) {
    if (line[0] == '#' || line[0] == '\0') continue;

    // POS = second field
    const char* p = line;
    while (*p && *p != '\t') ++p;  // skip CHROM
    if (!*p) return -2;
    ++p;
    int64_t position = 0;
    while (*p >= '0' && *p <= '9') position = position * 10 + (*p++ - '0');
    pos[v] = position;

    // skip to the 10th field (after FORMAT)
    int tabs = 1;  // already past CHROM's tab
    while (*p && tabs < 9) {
      if (*p == '\t') ++tabs;
      ++p;
    }
    if (tabs < 9) return -2;

    int8_t* row = gt + v * n_samples * 2;
    int64_t s = 0;
    // An allele token runs to the next separator; it binarizes to 0 iff
    // it is exactly "0", "." or empty (multi-digit ALT indices like "12"
    // are 1 — matching the Python parser's `parts[i] in (".", "0", "")`).
    auto allele = [](const char*& p) -> int8_t {
      const char* start = p;
      while (*p && *p != '|' && *p != '/' && *p != ':' && *p != '\t' &&
             *p != '\r')
        ++p;
      size_t len = (size_t)(p - start);
      return (len == 0 || (len == 1 && (*start == '0' || *start == '.')))
                 ? 0
                 : 1;
    };
    while (*p && s < n_samples) {
      int8_t h0 = allele(p);
      int8_t h1 = h0;  // haploid: duplicate
      if (*p == '|' || *p == '/') {
        ++p;
        h1 = allele(p);
      }
      row[s * 2] = h0;
      row[s * 2 + 1] = h1;
      ++s;
      // skip remaining subfields of this sample column
      while (*p && *p != '\t') ++p;
      if (*p == '\t') ++p;
    }
    if (s != n_samples) return -2;
    ++v;
  }
  return v;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native VCF body writer — the serving-side emit fast path.
//
// The reference emits VCFs from Python with a per-genotype f-string
// (src/utils/utils.py:378-479, generate_vcf_efficient_optimized); at chr21
// scale (150k sites x 96 samples x 7 formatted floats) that costs more
// than the imputation itself.  Here Python pre-formats the cheap
// per-variant prefix columns (CHROM..FORMAT) and this function renders the
// GT:HDS:GP:DS sample fields with a fixed-point %.3f formatter (values are
// probabilities in [0, 2]), appending to the header Python already wrote.
// Appended gzip members are valid gzip, so .gz paths work the same way.

extern "C" {

static inline char* fmt3(char* o, float v) {
  if (v < 0.f) v = 0.f;
  int m = (int)(v * 1000.f + 0.5f);
  *o++ = (char)('0' + m / 1000);
  *o++ = '.';
  *o++ = (char)('0' + (m / 100) % 10);
  *o++ = (char)('0' + (m / 10) % 10);
  *o++ = (char)('0' + m % 10);
  return o;
}

// Returns number of variants written, or <0 on I/O error.
long long vcf_write_body(const char* path, int is_gz,
                         const char* prefixes, const int64_t* prefix_off,
                         const float* p1, const float* p2,
                         long long n_v, long long n_s) {
  gzFile zf = nullptr;
  FILE* f = nullptr;
  if (is_gz) {
    zf = gzopen(path, "ab");
    if (!zf) return -1;
  } else {
    f = fopen(path, "ab");
    if (!f) return -1;
  }
  std::vector<char> buf;
  buf.reserve(4 << 20);
  // one sample field: \t g|g : x.xxx,x.xxx : x.xxx,x.xxx,x.xxx : x.xxx
  char tmp[64];
  long long written = 0;
  for (long long v = 0; v < n_v; ++v) {
    buf.insert(buf.end(), prefixes + prefix_off[v],
               prefixes + prefix_off[v + 1]);
    const float* r1 = p1 + v * n_s;
    const float* r2 = p2 + v * n_s;
    for (long long s = 0; s < n_s; ++s) {
      float a = r1[s], b = r2[s];
      char* o = tmp;
      *o++ = '\t';
      *o++ = (char)('0' + (a >= 0.5f));
      *o++ = '|';
      *o++ = (char)('0' + (b >= 0.5f));
      *o++ = ':';
      o = fmt3(o, a);
      *o++ = ',';
      o = fmt3(o, b);
      *o++ = ':';
      float g00 = (1.f - a) * (1.f - b);
      float g11 = a * b;
      float g01 = 1.f - g00 - g11;
      o = fmt3(o, g00);
      *o++ = ',';
      o = fmt3(o, g01);
      *o++ = ',';
      o = fmt3(o, g11);
      *o++ = ':';
      o = fmt3(o, a + b);
      buf.insert(buf.end(), tmp, o);
    }
    buf.push_back('\n');
    ++written;
    if (buf.size() > (4u << 20)) {
      if (is_gz) {
        if ((size_t)gzwrite(zf, buf.data(), (unsigned)buf.size())
            != buf.size()) { gzclose(zf); return -1; }
      } else {
        if (fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
          fclose(f); return -1; }
      }
      buf.clear();
    }
  }
  if (!buf.empty()) {
    if (is_gz) {
      if ((size_t)gzwrite(zf, buf.data(), (unsigned)buf.size())
          != buf.size()) { gzclose(zf); return -1; }
    } else {
      if (fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
        fclose(f); return -1; }
    }
  }
  if (is_gz) gzclose(zf); else fclose(f);
  return written;
}

}  // extern "C"
