// Native host runtime of uf3_tpu_torch: an extended-xyz tokenizer for
// large training sets (the w-14 tungsten set is the case it is written
// for) and an O(N) host cell list, with a C ABI loaded through ctypes.
//
//  * extended xyz, in two passes over the file held in memory:
//    uf3_xyz_index finds each frame (its atom count, comment line and
//    atom lines); the caller parses the comment lines and hands back,
//    per frame, the token column of the species and the number of
//    columns that Properties declares; uf3_xyz_tokenize then reads the
//    atom lines: the species symbol through the caller's table, every
//    other column as a double.  Positions, forces and every other
//    column are placed by the caller from Properties, frame by frame,
//    so a frame without force columns has none, a position column
//    anywhere in the line is read where it stands, and an unknown
//    species is an error.
//  * cell_list_neighbors: binning in fractional coordinates, bins at
//    least r_cut wide across each cell direction, every image within
//    reach searched (more than one a side where a direction holds
//    fewer bins than the cutoff needs).
//
// Build: g++ -O3 -shared -fPIC -o libuf3native.so uf3_native.cpp

#include <cerrno>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// the error codes of the C entries
constexpr int kOk = 0;
constexpr int kIoError = 1;        // err holds strerror; errno returned too
constexpr int kUnknownSpecies = 2; // err holds the symbol
constexpr int kFormatError = 3;    // err holds the message

void set_error(char* err, int64_t len, const std::string& message) {
  if (len <= 0) return;
  size_t n = message.size() < (size_t)(len - 1) ? message.size()
                                                : (size_t)(len - 1);
  memcpy(err, message.data(), n);
  err[n] = '\0';
}

// the whitespace of Python's str.split() and str.strip() on ASCII
inline bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f' ||
         c == '\n';
}

// Python's float() of a token: digits, signs, points and exponents, or
// inf / infinity / nan with a sign, read whole and correctly rounded
// (std::from_chars where the library has it, else strtod on the
// NUL-terminated buffer; strtod alone would also take hexadecimal
// floats, which float() refuses).
bool python_float(const char* s, size_t len, double* value) {
  size_t i = (s[0] == '+' || s[0] == '-') ? 1 : 0;
  if (i < len && (s[i] == 'i' || s[i] == 'I' || s[i] == 'n' ||
                  s[i] == 'N')) {
    char w[9] = {0};
    if (len - i > 8) return false;
    for (size_t j = i; j < len; ++j) w[j - i] = (char)tolower(s[j]);
    if (strcmp(w, "inf") && strcmp(w, "infinity") && strcmp(w, "nan"))
      return false;
  } else {
    for (size_t j = i; j < len; ++j) {
      char c = s[j];
      if (!((c >= '0' && c <= '9') || c == '.' || c == 'e' || c == 'E' ||
            c == '+' || c == '-'))
        return false;
    }
  }
#if defined(__cpp_lib_to_chars)
  // from_chars takes no leading '+'
  const char* first = s + (s[0] == '+' ? 1 : 0);
  if (s[0] == '+' && len > 1 && (s[1] == '-' || s[1] == '+')) return false;
  auto res = std::from_chars(first, s + len, *value);
  return res.ec == std::errc() && res.ptr == s + len;
#else
  char* end = nullptr;
  double v = strtod(s, &end);
  if (end != s + len) return false;
  *value = v;
  return true;
#endif
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------
// extended xyz
// ---------------------------------------------------------------------
// A file held in memory and its frames.  Byte ranges index `data`; each
// frame's atom lines are its n_atoms lines after the comment line.
struct XyzIndex {
  char* data;
  int64_t size;
  int64_t n_frames;
  int64_t* n_atoms;         // (n_frames)
  int64_t* comment_start;   // (n_frames) byte range of the comment line
  int64_t* comment_end;
  int64_t* body_start;      // (n_frames) byte offset of the first atom line
  int64_t* body_end;        // (n_frames) byte offset past the last one
  int64_t* line;            // (n_frames) 1-based line of the atom count
};

static void free_index(XyzIndex* index) {
  if (!index) return;
  free(index->data);
  delete[] index->n_atoms;
  delete[] index->comment_start;
  delete[] index->comment_end;
  delete[] index->body_start;
  delete[] index->body_end;
  delete[] index->line;
  delete index;
}

void uf3_xyz_free(XyzIndex* index) { free_index(index); }

// Read `path` and find its frames as Python's reader does: blank lines
// between frames are skipped, a frame is an atom count alone on its
// line, one comment line and that many atom lines.  Returns kOk with
// *out set, or an error code with `err` filled (for kIoError, errno in
// *os_errno).
int uf3_xyz_index(const char* path, XyzIndex** out, int* os_errno,
                  char* err, int64_t err_len) {
  *out = nullptr;
  *os_errno = 0;
  FILE* f = fopen(path, "rb");
  if (!f) {
    *os_errno = errno;
    set_error(err, err_len, strerror(errno));
    return kIoError;
  }
  // the whole file, and one byte more, NUL: a number's reader stops
  // there at the latest
  fseek(f, 0, SEEK_END);
  const long file_size = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* buffer = (char*)malloc(file_size > 0 ? (size_t)file_size + 1 : 1);
  const size_t got = file_size > 0 ? fread(buffer, 1, (size_t)file_size, f)
                                   : 0;
  const bool failed = file_size < 0 || got != (size_t)file_size ||
                      ferror(f) != 0;
  fclose(f);
  if (failed) {
    free(buffer);
    *os_errno = EIO;
    set_error(err, err_len, "read error");
    return kIoError;
  }
  const int64_t size = (int64_t)got;
  buffer[size] = '\0';
  const char* data = buffer;
  std::vector<int64_t> n_atoms, c0, c1, b0, b1, lines;
  int64_t pos = 0, line_no = 0;
  // the end of the line starting at p (its '\n' or the end of data)
  auto line_end = [&](int64_t p) {
    const void* nl = memchr(data + p, '\n', (size_t)(size - p));
    return nl ? (int64_t)((const char*)nl - data) : size;
  };
  while (pos < size) {
    int64_t end = line_end(pos);
    ++line_no;
    int64_t a = pos, b = end;
    while (a < b && is_space(data[a])) ++a;
    while (b > a && is_space(data[b - 1])) --b;
    if (a == b) {  // blank line
      pos = end + 1;
      continue;
    }
    std::string count(data + a, (size_t)(b - a));
    char* stop = nullptr;
    errno = 0;
    long long n = strtoll(count.c_str(), &stop, 10);
    if (stop != count.c_str() + count.size() || errno != 0 || n < 0) {
      set_error(err, err_len, "line " + std::to_string(line_no) +
                                  ": expected an atom count, got '" +
                                  count + "'");
      free(buffer);
      return kFormatError;
    }
    const int64_t frame_line = line_no;
    pos = end + 1;
    if (pos >= size) {
      set_error(err, err_len, "line " + std::to_string(frame_line) +
                                  ": frame has no comment line");
      free(buffer);
      return kFormatError;
    }
    end = line_end(pos);
    ++line_no;
    int64_t cb = end;
    if (cb > pos && data[cb - 1] == '\r') --cb;
    c0.push_back(pos);
    c1.push_back(cb);
    pos = end + 1;
    b0.push_back(pos < size ? pos : size);
    for (long long i = 0; i < n; ++i) {
      if (pos >= size) {
        set_error(err, err_len,
                  "line " + std::to_string(frame_line) + ": frame of " +
                      std::to_string(n) + " atoms ends after " +
                      std::to_string(i) + " atom lines");
        free(buffer);
        return kFormatError;
      }
      end = line_end(pos);
      ++line_no;
      pos = end + 1;
    }
    b1.push_back(pos < size ? pos : size);
    n_atoms.push_back(n);
    lines.push_back(frame_line);
  }
  XyzIndex* index = new XyzIndex();
  index->size = size;
  index->data = buffer;
  const int64_t nf = (int64_t)n_atoms.size();
  index->n_frames = nf;
  auto copy = [nf](const std::vector<int64_t>& v) {
    int64_t* p = new int64_t[nf > 0 ? nf : 1];
    if (nf > 0) memcpy(p, v.data(), (size_t)nf * sizeof(int64_t));
    return p;
  };
  index->n_atoms = copy(n_atoms);
  index->comment_start = copy(c0);
  index->comment_end = copy(c1);
  index->body_start = copy(b0);
  index->body_end = copy(b1);
  index->line = copy(lines);
  *out = index;
  return kOk;
}

// Tokenize the atom lines of `n` frames (`frames`, indices into the
// index).  For frame i: species_col[i] is the token column of the
// species symbol, n_cols[i] the columns Properties declares (tokens past
// them are ignored, as Python's reader ignores them).  `symbols` holds
// the symbols in order of atomic number, separated by single spaces.
// Writes, frame after frame, the atomic numbers into `numbers` and the
// other n_cols - 1 columns of each line, in order, into `values`.
int uf3_xyz_tokenize(const XyzIndex* index, const int64_t* frames,
                     int64_t n, const int32_t* species_col,
                     const int32_t* n_cols, const char* symbols,
                     int64_t* numbers, double* values, char* err,
                     int64_t err_len) {
  std::unordered_map<std::string, int64_t> z_of;
  {
    const char* s = symbols;
    int64_t z = 0;
    while (*s) {
      const char* e = s;
      while (*e && *e != ' ') ++e;
      z_of.emplace(std::string(s, (size_t)(e - s)), z++);
      s = *e ? e + 1 : e;
    }
  }
  const char* data = index->data;
  int64_t atom = 0, value = 0;
  std::vector<const char*> tok_start;
  std::vector<size_t> tok_len;
  for (int64_t k = 0; k < n; ++k) {
    const int64_t f = frames[k];
    const int cols = n_cols[k], sc = species_col[k];
    int64_t pos = index->body_start[f];
    int64_t line_no = index->line[f] + 2;
    for (int64_t i = 0; i < index->n_atoms[f]; ++i, ++line_no) {
      const void* nl = memchr(data + pos, '\n',
                              (size_t)(index->body_end[f] - pos));
      const int64_t end = nl ? (int64_t)((const char*)nl - data)
                             : index->body_end[f];
      tok_start.clear();
      tok_len.clear();
      int64_t p = pos;
      while ((int)tok_start.size() < cols) {
        while (p < end && is_space(data[p])) ++p;
        if (p >= end) break;
        int64_t q = p;
        while (q < end && !is_space(data[q])) ++q;
        tok_start.push_back(data + p);
        tok_len.push_back((size_t)(q - p));
        p = q;
      }
      if ((int)tok_start.size() < cols) {
        set_error(err, err_len,
                  "line " + std::to_string(line_no) + ": " +
                      std::to_string(tok_start.size()) + " columns, " +
                      "Properties declares " + std::to_string(cols));
        return kFormatError;
      }
      for (int c = 0; c < cols; ++c) {
        if (c == sc) {
          std::string symbol(tok_start[c], tok_len[c]);
          auto found = z_of.find(symbol);
          if (found == z_of.end()) {
            set_error(err, err_len, symbol);
            return kUnknownSpecies;
          }
          numbers[atom] = found->second;
        } else {
          double v;
          if (!python_float(tok_start[c], tok_len[c], &v)) {
            set_error(err, err_len,
                      "line " + std::to_string(line_no) + ", column " +
                          std::to_string(c + 1) + ": not a number: '" +
                          std::string(tok_start[c], tok_len[c]) + "'");
            return kFormatError;
          }
          values[value++] = v;
        }
      }
      ++atom;
      pos = end + 1;
    }
  }
  return kOk;
}

// ---------------------------------------------------------------------
// cell-list neighbor construction (general cells through fractional
// coordinates)
// ---------------------------------------------------------------------
// Fills idx (n, capacity), shift (n, capacity, 3), mask (n, capacity)
// with the neighbors closer than r_cut (the atom itself at zero shift
// left out), and returns the largest neighbor count (which may exceed
// capacity; rows keep their first `capacity`).  Positions are wrapped
// into the cell along periodic directions first; a shift is the image,
// in cell vectors, of the neighbor's wrapped position.
int64_t cell_list_neighbors(const double* positions, int64_t n_atoms,
                            const double* cell, const uint8_t* pbc,
                            double r_cut, int64_t capacity,
                            int32_t* idx, double* shift, uint8_t* mask) {
  // fractional coordinates: cartesian = frac @ cell (row vectors)
  double a[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) a[i][j] = cell[3 * i + j];
  double det = a[0][0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1]) -
               a[0][1] * (a[1][0] * a[2][2] - a[1][2] * a[2][0]) +
               a[0][2] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]);
  double inv[3][3];
  inv[0][0] = (a[1][1] * a[2][2] - a[1][2] * a[2][1]) / det;
  inv[0][1] = (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det;
  inv[0][2] = (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det;
  inv[1][0] = (a[1][2] * a[2][0] - a[1][0] * a[2][2]) / det;
  inv[1][1] = (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det;
  inv[1][2] = (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det;
  inv[2][0] = (a[1][0] * a[2][1] - a[1][1] * a[2][0]) / det;
  inv[2][1] = (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det;
  inv[2][2] = (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det;
  std::vector<double> frac(3 * n_atoms);
  for (int64_t i = 0; i < n_atoms; ++i) {
    for (int d = 0; d < 3; ++d) {
      double v = 0;
      for (int k = 0; k < 3; ++k) v += positions[3 * i + k] * inv[k][d];
      if (pbc[d]) v -= floor(v);  // wrap into [0, 1)
      frac[3 * i + d] = v;
    }
  }
  // per direction: bins at least r_cut wide across it, and the bins a
  // neighbor can lie away (one, unless the cell is thinner than r_cut)
  int nb[3], reach[3];
  for (int d = 0; d < 3; ++d) {
    int e1 = (d + 1) % 3, e2 = (d + 2) % 3;
    double n_vec[3] = {
        a[e1][1] * a[e2][2] - a[e1][2] * a[e2][1],
        a[e1][2] * a[e2][0] - a[e1][0] * a[e2][2],
        a[e1][0] * a[e2][1] - a[e1][1] * a[e2][0]};
    double norm = sqrt(n_vec[0] * n_vec[0] + n_vec[1] * n_vec[1] +
                       n_vec[2] * n_vec[2]);
    double width = fabs(a[d][0] * n_vec[0] + a[d][1] * n_vec[1] +
                        a[d][2] * n_vec[2]) / (norm > 0 ? norm : 1.0);
    nb[d] = (int)floor(width / r_cut);
    if (nb[d] < 1) nb[d] = 1;
    reach[d] = (int)ceil(r_cut / (width / nb[d]));
    if (reach[d] < 1) reach[d] = 1;
    if (!pbc[d] && reach[d] > nb[d]) reach[d] = nb[d];
  }
  const int64_t n_bins = (int64_t)nb[0] * nb[1] * nb[2];
  std::vector<std::vector<int32_t>> bins(n_bins);
  auto bin_along = [&](int64_t i, int d) {
    int b = (int)(frac[3 * i + d] * nb[d]);
    if (b >= nb[d]) b = nb[d] - 1;
    if (b < 0) b = 0;
    return b;
  };
  for (int64_t i = 0; i < n_atoms; ++i) {
    int64_t b = ((int64_t)bin_along(i, 0) * nb[1] + bin_along(i, 1)) * nb[2] +
                bin_along(i, 2);
    bins[b].push_back((int32_t)i);
  }
  const double r_cut2 = r_cut * r_cut;
  int64_t max_count = 0;
  for (int64_t i = 0; i < n_atoms; ++i) {
    const int home[3] = {bin_along(i, 0), bin_along(i, 1), bin_along(i, 2)};
    int64_t count = 0;
    int step[3];
    for (step[0] = -reach[0]; step[0] <= reach[0]; ++step[0])
      for (step[1] = -reach[1]; step[1] <= reach[1]; ++step[1])
        for (step[2] = -reach[2]; step[2] <= reach[2]; ++step[2]) {
          int c[3], image[3];
          bool inside = true;
          for (int d = 0; d < 3; ++d) {
            int t = home[d] + step[d];
            // each (bin, image) pair once: distinct steps give distinct
            // pairs, as t = c + image * nb
            image[d] = (int)floor((double)t / nb[d]);
            c[d] = t - image[d] * nb[d];
            if (!pbc[d] && image[d] != 0) inside = false;
          }
          if (!inside) continue;
          for (int32_t j : bins[((int64_t)c[0] * nb[1] + c[1]) * nb[2] +
                                c[2]]) {
            double cart[3] = {0, 0, 0};
            for (int d = 0; d < 3; ++d) {
              double df = frac[3 * j + d] - frac[3 * i + d] + image[d];
              for (int k = 0; k < 3; ++k) cart[k] += df * a[d][k];
            }
            double d2 = cart[0] * cart[0] + cart[1] * cart[1] +
                        cart[2] * cart[2];
            if (d2 < r_cut2 && d2 > 1e-12) {
              if (count < capacity) {
                idx[i * capacity + count] = j;
                for (int d = 0; d < 3; ++d)
                  shift[(i * capacity + count) * 3 + d] = image[d];
                mask[i * capacity + count] = 1;
              }
              ++count;
            }
          }
        }
    if (count > max_count) max_count = count;
  }
  return max_count;
}

}  // extern "C"
