// Fast CSV -> float64 matrix parser for the hlax_torch data loader: a copy
// of hlax/native/fastcsv.cpp (importing hlax's own binding imports JAX).
//
// The reference HL-VAE parses its 4000x1296 Health-MNIST CSVs with the
// Python csv module row by row (its read_functions.py:28-40), which
// dominates dataset construction time.  This is the native equivalent: one
// read of the whole file and a hand-rolled field loop (no locale, no malloc
// per field).  Exposed via ctypes (hlax_torch/native/io.py).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libfastcsv.so fastcsv.cpp
// (hlax_torch/native/io.py builds it into build/ at first use)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

extern "C" {

// Parse a CSV of floats. Empty fields and the literal "nan" become NaN.
// A non-numeric header row is skipped.  Returns 0 on success.
//   path      : file path
//   out       : caller buffer (rows*cols doubles) or nullptr to probe shape
//   n_rows/n_cols: in/out — probe mode fills them; fill mode validates them.
int fastcsv_parse(const char* path, double* out,
                  int64_t* n_rows, int64_t* n_cols) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    char* buf = (char*)malloc(size + 1);
    if (!buf) { fclose(f); return 2; }
    if ((long)fread(buf, 1, size, f) != size) { free(buf); fclose(f); return 3; }
    buf[size] = '\0';
    fclose(f);

    const char* p = buf;
    const char* end = buf + size;
    int64_t rows = 0, cols = 0;
    bool probing = (out == nullptr);
    int64_t cap_rows = probing ? 0 : *n_rows;
    int64_t cap_cols = probing ? 0 : *n_cols;
    double* w = out;
    bool first_line = true;

    while (p < end) {
        // skip blank lines
        if (*p == '\n' || *p == '\r') { ++p; continue; }
        const char* line_start = p;
        int64_t c = 0;
        bool numeric_line = true;
        while (p < end && *p != '\n') {
            // parse one field
            const char* fs = p;
            while (p < end && *p != ',' && *p != '\n' && *p != '\r') ++p;
            double v;
            if (p == fs) {
                v = NAN;   // empty field
            } else {
                char* endp = nullptr;
                v = strtod(fs, &endp);
                // accept trailing spaces; reject non-numeric junk
                while (endp < p && (*endp == ' ' || *endp == '\t')) ++endp;
                if (endp != p) {
                    if ((p - fs) == 3 && (fs[0] == 'n' || fs[0] == 'N')) {
                        v = NAN;   // "nan"
                    } else {
                        numeric_line = false;
                    }
                }
            }
            if (!probing && numeric_line) {
                if (rows >= cap_rows || c >= cap_cols) { free(buf); return 4; }
                w[rows * cap_cols + c] = v;
            }
            ++c;
            if (p < end && *p == ',') {
                ++p;
                if (p == end || *p == '\n' || *p == '\r') {
                    // a trailing empty field: NaN, as the csv module reads
                    // it (hlax's copy drops it and rejects the file as
                    // ragged, which sends it to the plain-Python parser)
                    if (!probing && numeric_line) {
                        if (rows >= cap_rows || c >= cap_cols) {
                            free(buf);
                            return 4;
                        }
                        w[rows * cap_cols + c] = NAN;
                    }
                    ++c;
                }
            }
            while (p < end && *p == '\r') ++p;
        }
        if (p < end) ++p;   // consume '\n'
        if (!numeric_line) {
            if (first_line) { first_line = false; continue; }   // header
            free(buf);
            return 5;
        }
        first_line = false;
        if (cols == 0) cols = c;
        else if (c != cols) { free(buf); return 6; }
        ++rows;
        (void)line_start;
    }
    free(buf);
    if (probing) {
        *n_rows = rows;
        *n_cols = cols;
    } else if (rows != cap_rows || cols != cap_cols) {
        return 7;
    }
    return 0;
}

}  // extern "C"
