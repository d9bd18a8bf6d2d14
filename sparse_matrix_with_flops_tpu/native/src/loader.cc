// Native data loader: fast SNAP / MatrixMarket ingestion + COO->CSR.
//
// Counterpart of the reference's C/C++ IO layer: the NIST
// MatrixMarket reader (nlibs/tools/mm_io.cc, 859 LoC) and the SNAP edge-list
// parser with symmetric mirroring / transpose-read / default-value semantics
// (nlibs/COO.cc:48-158), plus the sort+dedup+CSR build
// (COO.cc:222-291).  Exposed as a C ABI for ctypes (no pybind11 in the
// image); the Python wrapper is io/native.py with a pure-Python fallback.
//
// Parsing is byte-level (no scanf): a single-threaded single pass over an
// fread buffer (~10x faster than the scanf-style reference parser; fast
// enough that threading has not been worth the complexity so far).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <vector>
#include <string>
#include <cctype>

namespace {

struct Parsed {
  std::vector<int32_t> row, col;
  std::vector<float> val;
  int64_t nrows = 0, ncols = 0;
  bool symmetric = false;
  bool pattern = false;
  bool have_dims = false;
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* parse_ll(const char* p, const char* end, long long* out) {
  p = skip_ws(p, end);
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) { neg = *p == '-'; ++p; }
  long long v = 0;
  while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
  *out = neg ? -v : v;
  return p;
}

inline const char* parse_f(const char* p, const char* end, double* out) {
  p = skip_ws(p, end);
  char* e = nullptr;
  *out = strtod(p, &e);
  return e ? e : p;
}

// Parse body lines [begin, end); each data line: "r c [v]".
void parse_lines(const char* begin, const char* end, bool one_based,
                 bool pattern, Parsed* out) {
  const char* p = begin;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* le = nl ? nl : end;
    const char* q = skip_ws(p, le);
    if (q < le && *q != '#' && *q != '%') {
      long long r, c;
      q = parse_ll(q, le, &r);
      q = parse_ll(q, le, &c);
      double v = 1.0;  // default weight (COO.cc:110-112)
      q = skip_ws(q, le);
      if (!pattern && q < le && *q != '\n') {
        const char* q2 = parse_f(q, le, &v);
        if (q2 == q) v = 1.0;
      }
      if (one_based) { --r; --c; }
      out->row.push_back(static_cast<int32_t>(r));
      out->col.push_back(static_cast<int32_t>(c));
      out->val.push_back(static_cast<float>(v));
    }
    p = le + 1;
  }
}

}  // namespace

extern "C" {

// Result buffers are malloc'd here; caller frees with smf_free.
// Returns 0 on success.  is_trans mirrors COO::readSNAPFile(,, isTrans)
// (COO.h:19-20): swap row/col on read for column-stochastic R-MCL.
int smf_read_graph(const char* path, int is_trans, int32_t** out_row,
                   int32_t** out_col, float** out_val, int64_t* out_nnz,
                   int64_t* out_nrows, int64_t* out_ncols) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (size > 0 && fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    return -2;
  }
  fclose(f);
  buf[size] = '\n';
  const char* p = buf.data();
  const char* end = buf.data() + size;

  Parsed ps;
  bool matrix_market = false;
  // Header scan: MatrixMarket banner (%%MatrixMarket ... [symmetric|pattern])
  // or SNAP '#' comments; the first non-comment line of an .mtx body is the
  // dims line "nrows ncols nnz" (mm_io.cc mm_read_mtx_crd_size role).
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* le = nl ? nl : end;
    const char* q = skip_ws(p, le);
    if (q >= le) { p = le + 1; continue; }
    if (*q == '%') {
      if (le - q >= 14 && memcmp(q, "%%MatrixMarket", 14) == 0) {
        matrix_market = true;
        std::string line(q, le);
        for (auto& ch : line) ch = static_cast<char>(tolower(ch));
        if (line.find("symmetric") != std::string::npos) ps.symmetric = true;
        if (line.find("pattern") != std::string::npos) ps.pattern = true;
      }
      p = le + 1;
      continue;
    }
    if (*q == '#') { p = le + 1; continue; }
    if (!ps.have_dims) {
      // First non-comment line is always a header (COO.cc:79-89):
      // "rows nnz" (2 fields, square) or "rows cols nnz" (3 fields).
      long long f0, f1, f2 = -1;
      const char* q2 = parse_ll(q, le, &f0);
      q2 = parse_ll(q2, le, &f1);
      q2 = skip_ws(q2, le);
      bool three = q2 < le && *q2 >= '0' && *q2 <= '9';
      if (three) parse_ll(q2, le, &f2);
      long long n;
      if (three) {
        ps.nrows = f0;
        ps.ncols = f1;
        n = f2;
      } else {
        ps.nrows = ps.ncols = f0;
        n = f1;
      }
      ps.have_dims = true;
      ps.row.reserve(ps.symmetric ? 2 * n : n);
      ps.col.reserve(ps.symmetric ? 2 * n : n);
      ps.val.reserve(ps.symmetric ? 2 * n : n);
      p = le + 1;
      continue;
    }
    break;  // body starts here
  }

  parse_lines(p, end, /*one_based=*/matrix_market, ps.pattern, &ps);

  int64_t nnz = static_cast<int64_t>(ps.row.size());
  // symmetric mirroring (COO.cc:92-122): emit (c, r) for off-diagonals
  if (ps.symmetric) {
    for (int64_t i = 0; i < nnz; ++i) {
      if (ps.row[i] != ps.col[i]) {
        ps.row.push_back(ps.col[i]);
        ps.col.push_back(ps.row[i]);
        ps.val.push_back(ps.val[i]);
      }
    }
    nnz = static_cast<int64_t>(ps.row.size());
  }
  // symmetric mirroring already emits both directions, so the transpose is
  // the identity on the pattern — match the Python reader / COO.cc and skip
  // the swap in that case.
  if (is_trans && !ps.symmetric) std::swap(ps.row, ps.col);

  // reject out-of-range ids (undercounting SNAP headers are common); the
  // Python fallback then surfaces a clean error
  for (int64_t i = 0; i < nnz; ++i) {
    if (ps.row[i] < 0 || ps.row[i] >= ps.nrows || ps.col[i] < 0 ||
        ps.col[i] >= ps.ncols) {
      return -4;
    }
  }

  *out_row = static_cast<int32_t*>(malloc(sizeof(int32_t) * std::max<int64_t>(nnz, 1)));
  *out_col = static_cast<int32_t*>(malloc(sizeof(int32_t) * std::max<int64_t>(nnz, 1)));
  *out_val = static_cast<float*>(malloc(sizeof(float) * std::max<int64_t>(nnz, 1)));
  if (!*out_row || !*out_col || !*out_val) return -3;
  memcpy(*out_row, ps.row.data(), sizeof(int32_t) * nnz);
  memcpy(*out_col, ps.col.data(), sizeof(int32_t) * nnz);
  memcpy(*out_val, ps.val.data(), sizeof(float) * nnz);
  *out_nnz = nnz;
  *out_nrows = ps.nrows;
  *out_ncols = ps.ncols;
  return 0;
}

// Sort by (row, col), sum duplicates, build CSR
// (COO::makeOrdered + orderedAndDuplicatesRemoving + toCSR,
//  COO.cc:222-291).  In-place on the caller's COO copy; outputs malloc'd.
int smf_coo_to_csr(const int32_t* row, const int32_t* col, const float* val,
                   int64_t nnz, int64_t nrows, int32_t** out_rowptr,
                   int32_t** out_col, float** out_val, int64_t* out_nnz) {
  // range-validate ids before building (a malformed edge list must fail
  // cleanly, not corrupt the heap)
  for (int64_t i = 0; i < nnz; ++i) {
    if (row[i] < 0 || row[i] >= nrows || col[i] < 0) return -4;
  }
  std::vector<int64_t> order(nnz);
  for (int64_t i = 0; i < nnz; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    if (row[a] != row[b]) return row[a] < row[b];
    return col[a] < col[b];
  });
  std::vector<int32_t> ucol;
  std::vector<float> uval;
  ucol.reserve(nnz);
  uval.reserve(nnz);
  std::vector<int32_t> rowptr(nrows + 1, 0);
  int32_t pr = -1, pc = -1;
  for (int64_t k = 0; k < nnz; ++k) {
    int64_t i = order[k];
    if (row[i] == pr && col[i] == pc) {
      uval.back() += val[i];
    } else {
      pr = row[i];
      pc = col[i];
      ucol.push_back(pc);
      uval.push_back(val[i]);
      rowptr[pr + 1]++;
    }
  }
  for (int64_t r = 0; r < nrows; ++r) rowptr[r + 1] += rowptr[r];
  int64_t un = static_cast<int64_t>(ucol.size());
  *out_rowptr = static_cast<int32_t*>(malloc(sizeof(int32_t) * (nrows + 1)));
  *out_col = static_cast<int32_t*>(malloc(sizeof(int32_t) * std::max<int64_t>(un, 1)));
  *out_val = static_cast<float*>(malloc(sizeof(float) * std::max<int64_t>(un, 1)));
  if (!*out_rowptr || !*out_col || !*out_val) return -3;
  memcpy(*out_rowptr, rowptr.data(), sizeof(int32_t) * (nrows + 1));
  memcpy(*out_col, ucol.data(), sizeof(int32_t) * un);
  memcpy(*out_val, uval.data(), sizeof(float) * un);
  *out_nnz = un;
  return 0;
}

void smf_free(void* p) { free(p); }

}  // extern "C"
