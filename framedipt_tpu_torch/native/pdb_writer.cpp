// PDB text of atom37 trajectories, formatted in C++ behind a plain C ABI
// (bound with ctypes by framedipt_tpu_torch/native/__init__.py).
//
// The output is byte-equal to the pure-Python writer:
//     "".join(to_pdb(p, model=start_model + k, add_end=False) for k, p ...)
// of framedipt_tpu_torch/data/protein.py over the frames that
// analysis/utils._as_protein builds, that is T "MODEL ... ENDMDL" blocks
// with no END record. The trajectory writer is the host's hot path of the
// batch inpainting CLI: two trajectories of 100 models a sample.
//
// Inputs (C-contiguous):
//   pos          f64 [t * n * 37 * 3]
//   res3         n three-letter residue names, 3 bytes each
//   resi         i64 [n] residue numbers
//   chains       n chain letters, 1 byte each
//   bfac         f64 [n * 37] b-factors
//   atom_fields  37 padded atom-name fields, 4 bytes each
//   elem_fields  37 padded element fields, 2 bytes each
//
// An atom is present iff sum(|xyz|) > 1e-7 in its frame, as in
// _as_protein; the test is written !(s > eps), so a NaN coordinate is
// absent there too. The ATOM records, nearly all the text, are assembled
// field by field (put_fixed rounds as printf and Python do, ~10x faster
// than snprintf's %f); the rest goes through snprintf with the C locale
// pinned on the calling thread (%f follows LC_NUMERIC, Python's float
// formatting does not). Nothing is shared, so several threads may format
// at once.

#include <clocale>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <locale.h>

namespace {

constexpr int kNumAtoms = 37;
constexpr double kMaskEps = 1e-7;  // analysis/utils.py ATOM_MASK_EPS
// Bytes of each record when every field fits its width.
constexpr int64_t kModelBytes = 15;  // "MODEL     %4d\n"
constexpr int64_t kEndmdlBytes = 7;  // "ENDMDL\n"
constexpr int64_t kTerBytes = 27;    // "TER   %5ld      %.3s %c%4lld\n"
constexpr int64_t kAtomBytes = 81;   // 80 columns and "\n"

inline bool present(const double* p) {
  return std::fabs(p[0]) + std::fabs(p[1]) + std::fabs(p[2]) > kMaskEps;
}

// Appends each record to out while it fits in cap bytes and counts the
// bytes either way, so a short buffer still yields the size it needs.
struct Writer {
  char* out;
  int64_t cap;
  int64_t len = 0;

  void put(const char* text, int64_t n) {
    if (len + n <= cap) std::memcpy(out + len, text, static_cast<size_t>(n));
    len += n;
  }

  // The MODEL and TER records; their fields are at most 20 digits wide.
  template <typename... Args>
  void printf(const char* fmt, Args... args) {
    char line[128];
    int n = std::snprintf(line, sizeof(line), fmt, args...);
    if (n > 0) put(line, n);
  }
};

// An ATOM record with its widest fields: five of put_fixed's at most 400
// bytes (DBL_MAX's %.3f has 314) and two 20-digit integers.
constexpr int kLineBytes = 2200;

inline char* put_text(char* d, const char* text, int n) {
  std::memcpy(d, text, static_cast<size_t>(n));
  return d + n;
}

// Right-aligned decimal digits of |v| after an optional sign, padded with
// spaces to width: Python's f"{v:>{width}}" for an int, printf's %{width}d.
inline char* put_digits(char* d, bool negative, unsigned long long m,
                        int width, int frac_digits) {
  char tmp[32];
  int k = 0;
  for (int f = 0; f < frac_digits; ++f) {
    tmp[k++] = static_cast<char>('0' + m % 10);
    m /= 10;
  }
  if (frac_digits > 0) tmp[k++] = '.';
  do {
    tmp[k++] = static_cast<char>('0' + m % 10);
    m /= 10;
  } while (m != 0);
  if (negative) tmp[k++] = '-';
  for (int pad = width - k; pad > 0; --pad) *d++ = ' ';
  while (k > 0) *d++ = tmp[--k];
  return d;
}

inline char* put_int(char* d, long long v, int width) {
  const unsigned long long m =
      v < 0 ? 0ULL - static_cast<unsigned long long>(v)
            : static_cast<unsigned long long>(v);
  return put_digits(d, v < 0, m, width, 0);
}

// printf's %{width}.{frac}f (frac 2 or 3), which rounds the exact binary
// value half to even, as Python's format does. x * 10^frac is rounded to an
// integer exactly: p = x * s and its error e = fma(x, s, -p) hold the exact
// product p + e, and e decides only where p lies on a half. The sign comes
// from x, so -0.0004 prints as "-0.000" as in printf and Python. NaN, inf
// and |x| >= 1e12 go through snprintf (Python prints a NaN as "nan" whatever
// its sign bit; printf prints "-nan" for one whose sign bit is set).
char* put_fixed(char* d, double x, int frac, int width) {
  if (!(std::fabs(x) < 1e12)) {
    if (std::isnan(x)) x = std::fabs(x);
    return d + std::snprintf(d, 400, "%*.*f", width, frac, x);
  }
  const double s = frac == 2 ? 100.0 : 1000.0;
  const double p = x * s;
  const double e = std::fma(x, s, -p);
  double r = std::nearbyint(p);  // half to even on p
  const double f = p - r;        // exact: |p| < 2^52
  if (f == 0.5 && e > 0) r += 1.0;
  if (f == -0.5 && e < 0) r -= 1.0;
  return put_digits(d, std::signbit(x), static_cast<unsigned long long>(std::fabs(r)),
                    width, frac);
}

}  // namespace

extern "C" {

// Bytes format_models needs when every field fits its width (a residue
// number or a coordinate wider than its column needs more; format_models
// then returns the exact size).
int64_t fdt_pdb_models_bytes(const double* pos, int64_t t, int64_t n,
                             const char* chains) {
  int64_t ters = n > 0 ? 1 : 0;
  for (int64_t i = 1; i < n; ++i) ters += chains[i] != chains[i - 1];
  int64_t atoms = 0;
  for (int64_t k = 0; k < t * n * kNumAtoms; ++k) atoms += present(pos + 3 * k);
  return t * (kModelBytes + kEndmdlBytes + ters * kTerBytes) + atoms * kAtomBytes;
}

// Writes the T MODEL blocks into out (cap bytes, no NUL written after the
// text) and returns the text's length. A return value above cap means the
// buffer was too short: out then holds a prefix and the caller formats
// again with a buffer of the returned size.
int64_t fdt_format_models(const double* pos, int64_t t, int64_t n,
                          const char* res3, const int64_t* resi,
                          const char* chains, const double* bfac,
                          const char* atom_fields, const char* elem_fields,
                          int64_t start_model, char* out, int64_t cap) {
  locale_t c_loc = newlocale(LC_NUMERIC_MASK, "C", static_cast<locale_t>(0));
  locale_t old_loc = c_loc != static_cast<locale_t>(0)
                         ? uselocale(c_loc)
                         : static_cast<locale_t>(0);
  Writer w{out, cap};
  for (int64_t frame = 0; frame < t; ++frame) {
    const double* fpos = pos + frame * n * kNumAtoms * 3;
    w.printf("MODEL     %4d\n", static_cast<int>(start_model + frame));
    long atom_index = 1;
    char last_chain = '\0';
    for (int64_t i = 0; i < n; ++i) {
      const char chain = chains[i];
      if (last_chain != '\0' && chain != last_chain) {
        w.printf("TER   %5ld      %.3s %c%4lld\n", atom_index,
                 res3 + 3 * (i - 1), last_chain,
                 static_cast<long long>(resi[i - 1]));
        ++atom_index;
      }
      last_chain = chain;
      for (int ai = 0; ai < kNumAtoms; ++ai) {
        const double* p = fpos + (i * kNumAtoms + ai) * 3;
        if (!present(p)) continue;
        // "ATOM  %5ld %.4s %.3s %c%4lld    %8.3f%8.3f%8.3f%6.2f%6.2f"
        // "          %.2s\n", field by field.
        char line[kLineBytes];
        char* d = line;
        d = put_text(d, "ATOM  ", 6);
        d = put_int(d, atom_index, 5);
        *d++ = ' ';
        d = put_text(d, atom_fields + 4 * ai, 4);
        *d++ = ' ';
        d = put_text(d, res3 + 3 * i, 3);
        *d++ = ' ';
        *d++ = chain;
        d = put_int(d, resi[i], 4);
        d = put_text(d, "    ", 4);
        d = put_fixed(d, p[0], 3, 8);
        d = put_fixed(d, p[1], 3, 8);
        d = put_fixed(d, p[2], 3, 8);
        d = put_text(d, "  1.00", 6);
        d = put_fixed(d, bfac[i * kNumAtoms + ai], 2, 6);
        d = put_text(d, "          ", 10);
        d = put_text(d, elem_fields + 2 * ai, 2);
        *d++ = '\n';
        w.put(line, d - line);
        ++atom_index;
      }
    }
    if (n > 0) {
      w.printf("TER   %5ld      %.3s %c%4lld\n", atom_index,
               res3 + 3 * (n - 1), last_chain,
               static_cast<long long>(resi[n - 1]));
    }
    w.put("ENDMDL\n", kEndmdlBytes);
  }
  if (c_loc != static_cast<locale_t>(0)) {
    uselocale(old_loc);
    freelocale(c_loc);
  }
  return w.len;
}

}  // extern "C"
