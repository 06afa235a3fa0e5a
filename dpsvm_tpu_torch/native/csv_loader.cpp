// Native CSV data loader / model writer for dpsvm_tpu_torch (the PyTorch
// port's copy of dpsvm_tpu/native/csv_loader.cpp, C ABI unchanged). The
// port binds the data entry points only: it writes and reads model files
// in Python, which measured faster than dpsvm_write_model and
// dpsvm_parse_model here (scripts/model_file_io.py times both).
//
// Host-side equivalent of the reference's C++ data path:
//   * parse.cpp:10-43  (populate_data: dense "label,f1,...,fd" CSV ->
//     flat row-major float x[n*d] + int y[n])
//   * svmTrainMain.cpp:386-416 (write_out_model: gamma line, b line,
//     one "alpha,y,x..." line per support vector)
//
// Exposed as a plain C ABI consumed from Python via ctypes. The wrapper in
// dpsvm_tpu_torch/native/build.py compiles this file on first use with g++
// and the loaders fall back to their pure-Python parsers when no compiler
// is available, so the port never hard-depends on the binary.
//
// Unlike the reference loader, which exits the process on a missing file
// (parse.cpp:17) and trusts the caller-supplied -a/-x shape flags, this one
// returns error codes and can discover the shape itself (dpsvm_csv_shape).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

namespace {

// Read one '\n'-terminated line of unbounded length into buf (grown as
// needed). Returns length, or -1 on EOF with nothing read, -2 on alloc
// failure. POSIX getline(3) does the buffered read + realloc dance in
// one call — the original fgetc-per-character loop made a 76 MB model
// file cost ~3 s in stdio locking alone (measured; getline reads the
// same file in tenths).
long read_line(FILE* f, char** buf, size_t* cap) {
    ssize_t len = getline(buf, cap, f);
    if (len < 0) return feof(f) ? -1 : -2;
    if (len > 0 && (*buf)[len - 1] == '\n') (*buf)[--len] = '\0';
    if (len > 0 && (*buf)[len - 1] == '\r') (*buf)[--len] = '\0';
    return (long)len;
}

bool blank(const char* s) {
    for (; *s; ++s)
        if (*s != ' ' && *s != '\t' && *s != '\r') return false;
    return true;
}

}  // namespace

extern "C" {

// Discover (rows, cols) of a dense CSV. cols includes the label column.
// Returns 0 on success, -1 if the file cannot be opened, -2 on alloc failure.
int dpsvm_csv_shape(const char* path, long* rows, long* cols) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char* buf = nullptr;
    size_t cap = 0;
    long n = 0, d = 0;
    for (;;) {
        long len = read_line(f, &buf, &cap);
        if (len == -2) { fclose(f); free(buf); return -2; }
        if (len < 0) break;
        if (blank(buf)) continue;
        if (n == 0) {
            d = 1;
            for (const char* p = buf; *p; ++p)
                if (*p == ',') ++d;
        }
        ++n;
    }
    free(buf);
    fclose(f);
    *rows = n;
    *cols = d;
    return 0;
}

// Parse up to max_rows lines of "label,f1,...,fd" into x_out (row-major
// n*d floats) and y_out (n ints). d = num_attributes (label not counted).
// Returns the number of rows parsed, or a negative error code:
//   -1 open failure, -2 alloc failure, -3 malformed row (too few fields).
long dpsvm_parse_csv(const char* path, float* x_out, int* y_out,
                     long max_rows, long num_attributes) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char* buf = nullptr;
    size_t cap = 0;
    long n = 0;
    while (n < max_rows) {
        long len = read_line(f, &buf, &cap);
        if (len == -2) { fclose(f); free(buf); return -2; }
        if (len < 0) break;
        if (blank(buf)) continue;
        char* p = buf;
        char* end = nullptr;
        // Label: the reference stores it as int (parse.cpp reads into
        // vector<int> y); accept float spellings like "1.0" or "+1".
        float label = strtof(p, &end);
        if (end == p) { fclose(f); free(buf); return -3; }
        y_out[n] = (int)label;
        p = end;
        float* row = x_out + n * num_attributes;
        for (long j = 0; j < num_attributes; ++j) {
            while (*p == ',' || *p == ' ' || *p == '\t') ++p;
            if (*p == '\0' || *p == '\r') { fclose(f); free(buf); return -3; }
            row[j] = strtof(p, &end);
            if (end == p) { fclose(f); free(buf); return -3; }
            p = end;
        }
        ++n;
    }
    free(buf);
    fclose(f);
    return n;
}

// Write a model file: gamma line, b line, then one "alpha,y,x1,...,xd" line
// per support vector (alpha > 0). Matches the (fixed) reference format of
// svmTrainMain.cpp:386-416. Returns the number of SVs written, or -1 on
// open failure.
long dpsvm_write_model(const char* path, double gamma, double b,
                       const float* alpha, const int* y, const float* x,
                       long n, long d) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    // %.9g: float32 round-trips exactly; %g (6 digits) loses
    // ~1e-5 absolute on O(1) intercepts (one-class rho).
    fprintf(f, "%.9g\n", gamma);
    fprintf(f, "%.9g\n", b);
    long n_sv = 0;
    for (long i = 0; i < n; ++i) {
        if (!(alpha[i] > 0.0f)) continue;
        fprintf(f, "%.9g,%d", alpha[i], y[i]);
        const float* row = x + i * d;
        for (long j = 0; j < d; ++j) fprintf(f, ",%.9g", row[j]);
        fputc('\n', f);
        ++n_sv;
    }
    fclose(f);
    return n_sv;
}

// --- libsvm / svmlight sparse format ("<label> idx:val idx:val ...") ---
// The reference could only consume this format via an offline Python
// convert step (scripts/convert_adult.py); the framework's loaders accept
// it natively, and this is the fast path behind data/loader.py::load_libsvm
// (the pure-Python parser remains the fallback and the source of
// line-numbered error messages). Acceptance must not be LOOSER than the
// Python parser (a file must not load with g++ present but error without),
// so the float parse is stricter than bare strtof: no leading whitespace
// (Python tokenizes on whitespace first) and no hex literals (Python's
// float() rejects "0x1A").

static int strict_double(char* p, char** end, double* out) {
    // mirrors strict_float: Python's float() rejects hex literals
    if (*p == ' ' || *p == '\t') return 0;
    double v = strtod(p, end);
    if (*end == p) return 0;
    for (char* q = p; q < *end; ++q) {
        if (*q == 'x' || *q == 'X') return 0;
    }
    *out = v;
    return 1;
}

static int strict_float(char* p, char** end, float* out) {
    if (*p == ' ' || *p == '\t') return 0;
    float v = strtof(p, end);
    if (*end == p) return 0;
    for (char* q = p; q < *end; ++q) {
        if (*q == 'x' || *q == 'X') return 0;
    }
    *out = v;
    return 1;
}

// Parse one libsvm row in place. Returns 1 on success, 0 on a malformed
// row, -1 for a blank/comment line. Shared by the scan and fill passes so
// the two cannot disagree on which rows are valid. `row` may be null
// (scan pass: only label/max_index are produced); num_attributes < 0
// means "no column bound" (scan pass).
static int parse_libsvm_row(char* buf, float* label, float* row,
                            long num_attributes, long* max_index) {
    char* p = buf;
    while (*p == ' ' || *p == '\t') ++p;
    if (*p == '\0' || *p == '\r' || *p == '#') return -1;
    char* end = nullptr;
    if (!strict_float(p, &end, label)) return 0;
    p = end;
    for (;;) {
        while (*p == ' ' || *p == '\t') ++p;
        if (*p == '\0' || *p == '\r') return 1;
        long idx = strtol(p, &end, 10);
        if (end == p || *end != ':' || idx < 1) return 0;
        p = end + 1;
        float val;
        if (!strict_float(p, &end, &val)) return 0;
        p = end;
        if (idx > *max_index) *max_index = idx;
        if (row && idx <= num_attributes) row[idx - 1] = val;
    }
}

// Scan pass: count data rows (blank lines and '#' comments skipped) and the
// maximum 1-based feature index. max_rows <= 0 means "all". Returns the row
// count, or -1 open failure, -2 alloc failure, -3 malformed line / bad index.
long dpsvm_libsvm_stats(const char* path, long max_rows, long* max_index) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char* buf = nullptr;
    size_t cap = 0;
    long n = 0, mi = 0;
    while (max_rows <= 0 || n < max_rows) {
        long len = read_line(f, &buf, &cap);
        if (len == -2) { fclose(f); free(buf); return -2; }
        if (len < 0) break;
        float label;
        int r = parse_libsvm_row(buf, &label, nullptr, -1, &mi);
        if (r == 0) { fclose(f); free(buf); return -3; }
        if (r > 0) ++n;
    }
    free(buf);
    fclose(f);
    *max_index = mi;
    return n;
}

// Fill pass: x_out must be (max_rows, num_attributes) ZEROED by the caller
// (absent features stay 0); labels land as float (the Python wrapper owns
// integer-label validation and bails back to Python for |label| >= 2^24,
// where float32 stops being exact). Features with index > num_attributes
// are dropped — the same column-narrowing semantics as the dense path and
// the reference converter (convert_adult.py:31). Returns rows parsed or
// the negative codes of dpsvm_libsvm_stats.
long dpsvm_parse_libsvm(const char* path, float* x_out, float* y_out,
                        long max_rows, long num_attributes) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char* buf = nullptr;
    size_t cap = 0;
    long n = 0, mi = 0;
    while (n < max_rows) {
        long len = read_line(f, &buf, &cap);
        if (len == -2) { fclose(f); free(buf); return -2; }
        if (len < 0) break;
        float label;
        int r = parse_libsvm_row(buf, &label, x_out + n * num_attributes,
                                 num_attributes, &mi);
        if (r == 0) { fclose(f); free(buf); return -3; }
        if (r < 0) continue;
        y_out[n] = label;
        ++n;
    }
    free(buf);
    fclose(f);
    return n;
}

// --- reference-format model reader -----------------------------------
// The common big-model case (RBF, bare-gamma header — MNIST-scale files
// are tens of MB of text): a shape pass then a fill pass, mirroring the
// writer above. Extended layouts (our "kernel ..." header, "task"/
// "svidx" lines, LIBSVM "svm_type" files) return -4 so the Python
// reader — the format authority — handles them. Acceptance here must
// not be LOOSER than models/io.py::load_model: every field must parse
// and the field COUNT per SV line must be exactly d + 2 (Python's
// len(parts) check), so a short/garbage line errors instead of loading.
//
// dpsvm_model_shape returns 0 and fills n_sv/d/has_b/gamma/b, or:
//   -1 open failure, -2 alloc failure, -3 malformed, -4 extended format.
int dpsvm_model_shape(const char* path, long* n_sv, long* d, int* has_b,
                      double* gamma_out, double* b_out) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char* buf = nullptr;
    size_t cap = 0;
    long n = 0, dd = -1;
    int state = 0, hb = 0;          // 0: want gamma, 1: maybe b, 2: SVs
    double g = 0.0, b = 0.0;
    for (;;) {
        long len = read_line(f, &buf, &cap);
        if (len == -2) { fclose(f); free(buf); return -2; }
        if (len < 0) break;
        if (blank(buf)) continue;
        if (state == 0) {
            char* end = nullptr;
            if (!strict_double(buf, &end, &g)) {
                fclose(f); free(buf); return -4;
            }
            while (*end == ' ' || *end == '\t') ++end;
            if (*end != '\0') { fclose(f); free(buf); return -4; }
            state = 1;
            continue;
        }
        if (state == 1) {
            state = 2;
            if (!strchr(buf, ',')) {        // lone scalar => b line
                char* end = nullptr;
                if (!strict_double(buf, &end, &b)) {
                    fclose(f); free(buf); return -3;
                }
                while (*end == ' ' || *end == '\t') ++end;
                if (*end != '\0') { fclose(f); free(buf); return -3; }
                hb = 1;
                continue;
            }
        }
        if (dd < 0) {
            long commas = 0;
            for (const char* p = buf; *p; ++p)
                if (*p == ',') ++commas;
            dd = commas - 1;
            if (dd < 1) { fclose(f); free(buf); return -3; }
        }
        ++n;
    }
    free(buf);
    fclose(f);
    if (n == 0) return -3;
    *n_sv = n;
    *d = dd;
    *has_b = hb;
    *gamma_out = g;
    *b_out = b;
    return 0;
}

// Fill alpha/y/x from the SV lines; n_sv/d/has_b must come from
// dpsvm_model_shape. Returns rows parsed, or a negative code as above.
long dpsvm_parse_model(const char* path, float* alpha_out, int* y_out,
                       float* x_out, long n_sv, long d, int has_b) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char* buf = nullptr;
    size_t cap = 0;
    long skip = has_b ? 2 : 1;
    long n = 0;
    while (n < n_sv) {
        long len = read_line(f, &buf, &cap);
        if (len == -2) { fclose(f); free(buf); return -2; }
        if (len < 0) break;
        if (blank(buf)) continue;
        if (skip > 0) { --skip; continue; }
        char* p = buf;
        char* end = nullptr;
        float a;
        if (!strict_float(p, &end, &a) || *end != ',') {
            fclose(f); free(buf); return -3;
        }
        alpha_out[n] = a;
        p = end + 1;
        float yv;
        if (!strict_float(p, &end, &yv)) {
            fclose(f); free(buf); return -3;
        }
        y_out[n] = (int)yv;
        p = end;
        float* row = x_out + n * d;
        for (long j = 0; j < d; ++j) {
            if (*p != ',') { fclose(f); free(buf); return -3; }
            ++p;
            if (!strict_float(p, &end, row + j)) {
                fclose(f); free(buf); return -3;
            }
            p = end;
        }
        while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
        if (*p != '\0') { fclose(f); free(buf); return -3; }
        ++n;
    }
    free(buf);
    fclose(f);
    return n;
}

}  // extern "C"
