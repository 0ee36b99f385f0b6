// Fast .stfs.covars parser: the framework's native data loader.
//
// The reference parses pose graphs with per-line fscanf of 16 fields
// (HitLSLAM_main.cpp:192-300). For ~1e5-row files the Python/numpy text path
// costs seconds; this single-pass strtod parser feeds a preallocated double
// buffer and runs at memory-bandwidth speed (the file read, not the float
// conversion, dominates either way). Doubles keep the native path bit-equal
// to the Python fallback, so pose-change grouping cannot depend on which
// parser ran. Exposed via ctypes
// (hitl_slam_torch/native/__init__.py) with a pure-Python fallback.
//
// Build: hitl_slam_torch/native/__init__.py runs g++ at first use (the
// Makefile beside it builds the same libraries by hand).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parses the file at `path`. Writes up to `max_rows * 16` doubles into `out`
// (row-major, 16 fields per row), the map name into `map_name`
// (name_capacity bytes), and the timestamp into `*timestamp`.
// Returns the number of rows parsed, or -1 on error. Blank lines are
// skipped. Any other line that is not 16 comma-separated numbers, or a
// timestamp line that is not one number, makes the whole parse fail (-1),
// so that the caller's Python parser decides on such a file and raises its
// error (the reference's copy of this parser skipped such rows).
static bool blank(char c) { return c == ' ' || c == '\t' || c == '\r'; }

int64_t parse_stfs_covars(const char* path, double* out, int64_t max_rows,
                          char* map_name, int64_t name_capacity,
                          double* timestamp) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* buf = (char*)malloc(size + 1);
  if (!buf) { fclose(f); return -1; }
  if (fread(buf, 1, size, f) != (size_t)size) {
    free(buf); fclose(f); return -1;
  }
  buf[size] = '\0';
  fclose(f);

  char* p = buf;
  // line 1: map name, without surrounding whitespace
  char* nl = strchr(p, '\n');
  if (!nl) { free(buf); return -1; }
  char* q = nl;
  while (p < q && (blank(*p) || *p == '\n')) ++p;
  while (q > p && blank(q[-1])) --q;
  int64_t name_len = q - p;
  if (name_len >= name_capacity) name_len = name_capacity - 1;
  memcpy(map_name, p, name_len);
  map_name[name_len] = '\0';
  p = nl + 1;
  // line 2: timestamp
  while (blank(*p)) ++p;
  char* end;
  *timestamp = strtod(p, &end);
  if (end == p || *p == '\n') { free(buf); return -1; }
  p = end;
  while (blank(*p)) ++p;
  if (*p && *p != '\n') { free(buf); return -1; }
  if (*p) ++p;

  int64_t rows = 0;
  while (*p) {
    while (blank(*p)) ++p;
    if (*p == '\n' || !*p) {  // blank line
      if (*p) ++p;
      continue;
    }
    if (rows == max_rows) { free(buf); return -1; }
    double* row = out + rows * 16;
    bool ok = true;
    for (int field = 0; field < 16 && ok; ++field) {
      while (blank(*p)) ++p;
      // strtod would skip a newline: an empty field ends the row here
      if (*p == '\n' || !*p) { ok = false; break; }
      row[field] = strtod(p, &end);
      if (end == p) { ok = false; break; }
      p = end;
      while (blank(*p)) ++p;
      if (field < 15) {
        if (*p != ',') ok = false;
        else ++p;
      }
    }
    if (!ok || (*p && *p != '\n')) { free(buf); return -1; }
    ++rows;
    if (*p) ++p;
  }
  free(buf);
  return rows;
}

// Counts data lines (upper bound on rows) so callers can size the buffer.
int64_t count_lines(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t n = 0;
  char chunk[1 << 16];
  size_t got;
  while ((got = fread(chunk, 1, sizeof(chunk), f)) > 0) {
    for (size_t i = 0; i < got; ++i) n += (chunk[i] == '\n');
  }
  fclose(f);
  return n + 1;
}

}  // extern "C"
