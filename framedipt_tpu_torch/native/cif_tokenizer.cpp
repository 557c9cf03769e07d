// CIF category parser behind a plain C ABI (bound with ctypes by
// framedipt_tpu_torch/native/__init__.py).
//
// The result equals parse_cif_categories_py of
// framedipt_tpu_torch/data/mmcif.py, its behavioural oracle: the same
// tokens (bare values, quoted values ending at their quote followed by a
// blank or the line's end, ';' text fields, '#' comments), the same
// grammar (data_ and global_ skipped, loop_ tags then values up to the
// next loop_, stop_, tag or data_, ragged loops cut to full rows, a tag
// and its value, ASCII-case-insensitive keywords) and the same lines:
// str.splitlines() breaks at \n, \r, \r\n, \v, \f, \x1c, \x1d, \x1e, and
// U+0085, U+2028, U+2029 (UTF-8 C2 85, E2 80 A8, E2 80 A9).
//
// The input is the CIF text as UTF-8 with no NUL byte (the caller keeps
// text holding NUL on the Python parser). The parser tokenizes in one pass
// and groups the values by (category, item), in order of first appearance,
// the order in which the Python parser fills its dicts. The caller gets
// the columns back as two NUL-separated buffers and a table of counts:
//
//   fdt_cif_parse(text, size, sizes) -> handle (nullptr on failure);
//       sizes[0] columns, sizes[1] bytes of names, sizes[2] bytes of values
//   fdt_cif_take(handle, names, values, counts): fills
//       names   "cat\0item\0" per column,
//       values  each value followed by \0, column after column,
//       counts  int64 [columns], the values of each column,
//     then frees the handle;
//   fdt_cif_free(handle) frees a handle that is not taken.

#include <cstdint>
#include <cstring>
#include <deque>
#include <new>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

inline bool is_ws(char c) { return c == ' ' || c == '\t'; }

inline char ascii_lower(char c) { return (c >= 'A' && c <= 'Z') ? char(c - 'A' + 'a') : c; }

inline bool iprefix(std::string_view s, std::string_view lower_prefix) {
  if (s.size() < lower_prefix.size()) return false;
  for (size_t i = 0; i < lower_prefix.size(); ++i) {
    if (ascii_lower(s[i]) != lower_prefix[i]) return false;
  }
  return true;
}

inline bool iequal(std::string_view s, std::string_view lower) {
  return s.size() == lower.size() && iprefix(s, lower);
}

struct Line {
  const char* b;
  const char* e;
};

// The length of the line break at p (0 when p starts none), as
// str.splitlines() reads the decoded text.
inline size_t break_length(const char* p, const char* end) {
  const auto c = static_cast<unsigned char>(*p);
  switch (c) {
    case '\n': case '\v': case '\f': case 0x1c: case 0x1d: case 0x1e:
      return 1;
    case '\r':
      return (p + 1 < end && p[1] == '\n') ? 2 : 1;
    case 0xc2:  // U+0085
      return (p + 1 < end && static_cast<unsigned char>(p[1]) == 0x85) ? 2 : 0;
    case 0xe2:  // U+2028, U+2029
      return (p + 2 < end && static_cast<unsigned char>(p[1]) == 0x80 &&
              (static_cast<unsigned char>(p[2]) == 0xa8 ||
               static_cast<unsigned char>(p[2]) == 0xa9)) ? 3 : 0;
    default:
      return 0;
  }
}

std::vector<Line> split_lines(const char* data, size_t size) {
  std::vector<Line> lines;
  const char* end = data + size;
  const char* line = data;
  for (const char* p = data; p < end;) {
    const size_t n = break_length(p, end);
    if (n) {
      lines.push_back({line, p});
      p += n;
      line = p;
    } else {
      ++p;
    }
  }
  if (line < end) lines.push_back({line, end});
  return lines;
}

// The token stream of mmcif.py::_tokenize. A token views the input, or a
// text field joined into owned_ (a deque: earlier tokens stay valid).
class TokenStream {
 public:
  TokenStream(const char* data, size_t size) : lines_(split_lines(data, size)) {}

  bool next(std::string_view* sv) {
    while (li_ < lines_.size()) {
      const Line& line = lines_[li_];
      if (pos_ == 0 && line.b != line.e && *line.b == ';') {
        std::string& block = owned_.emplace_back(line.b + 1, line.e);
        ++li_;
        while (li_ < lines_.size() &&
               !(lines_[li_].b != lines_[li_].e && *lines_[li_].b == ';')) {
          block.push_back('\n');
          block.append(lines_[li_].b, lines_[li_].e);
          ++li_;
        }
        ++li_;  // the closing ';' line
        *sv = block;
        return true;
      }
      const char* b = line.b + pos_;
      const char* e = line.e;
      while (b < e && is_ws(*b)) ++b;
      if (b >= e || *b == '#') {
        ++li_;
        pos_ = 0;
        continue;
      }
      if (*b == '\'' || *b == '"') {
        const char q = *b;
        const char* t = b + 1;
        while (t < e && !(*t == q && (t + 1 == e || is_ws(t[1])))) ++t;
        *sv = std::string_view(b + 1, size_t(t - b - 1));
        pos_ = size_t(t + 1 - line.b);  // past the line's end when unterminated
        return true;
      }
      const char* t = b;
      while (t < e && !is_ws(*t)) ++t;
      *sv = std::string_view(b, size_t(t - b));
      pos_ = size_t(t - line.b);
      return true;
    }
    return false;
  }

 private:
  std::vector<Line> lines_;
  size_t li_ = 0;
  size_t pos_ = 0;  // offset within the current line
  std::deque<std::string> owned_;
};

struct Column {
  std::string_view cat, item;
  std::vector<std::string_view> values;
};

struct Result {
  // The tokens must outlive the columns that view them.
  explicit Result(const char* data, size_t size) : tokens(data, size) {}
  TokenStream tokens;
  std::vector<Column> columns;
  std::unordered_map<std::string, size_t> index;  // "cat\0item" -> column

  // The column of cats[cat][item], made on first use (Python's setdefault:
  // a loop_ with tags and no row still makes its empty columns).
  Column& column(std::string_view tag) {
    const size_t dot = tag.find('.');
    const std::string_view cat = tag.substr(0, dot);
    const std::string_view item =
        dot == std::string_view::npos ? std::string_view() : tag.substr(dot + 1);
    std::string key(cat);
    key.push_back('\0');
    key.append(item);
    auto [it, fresh] = index.try_emplace(std::move(key), columns.size());
    if (fresh) columns.push_back({cat, item, {}});
    return columns[it->second];
  }
};

void parse(Result* r) {
  TokenStream& ts = r->tokens;
  std::string_view tok;
  bool have = ts.next(&tok);
  std::vector<std::string_view> tags, values;
  while (have) {
    if (iprefix(tok, "data_") || iprefix(tok, "global_")) {
      have = ts.next(&tok);
      continue;
    }
    if (iequal(tok, "loop_")) {
      tags.clear();
      have = ts.next(&tok);
      while (have && !tok.empty() && tok[0] == '_') {
        tags.push_back(tok);
        have = ts.next(&tok);
      }
      values.clear();
      while (have && !(iequal(tok, "loop_") || iequal(tok, "stop_") ||
                       (!tok.empty() && tok[0] == '_') || iprefix(tok, "data_"))) {
        values.push_back(tok);
        have = ts.next(&tok);
      }
      const size_t ncol = tags.size();
      const size_t nrow = ncol ? values.size() / ncol : 0;
      for (size_t ci = 0; ci < ncol; ++ci) {
        Column& col = r->column(tags[ci]);
        for (size_t row = 0; row < nrow; ++row) col.values.push_back(values[row * ncol + ci]);
      }
      continue;
    }
    if (!tok.empty() && tok[0] == '_') {
      const std::string_view tag = tok;
      std::string_view val;
      if (!ts.next(&val)) break;
      r->column(tag).values.push_back(val);
      have = ts.next(&tok);
      continue;
    }
    have = ts.next(&tok);
  }
}

}  // namespace

extern "C" {

void* fdt_cif_parse(const char* data, int64_t size, int64_t* sizes) {
  Result* r = nullptr;
  try {
    r = new Result(data, size_t(size));
    parse(r);
  } catch (const std::bad_alloc&) {
    delete r;
    return nullptr;
  }
  int64_t names = 0, bytes = 0;
  for (const Column& col : r->columns) {
    names += int64_t(col.cat.size() + col.item.size() + 2);
    for (std::string_view v : col.values) bytes += int64_t(v.size() + 1);
  }
  sizes[0] = int64_t(r->columns.size());
  sizes[1] = names;
  sizes[2] = bytes;
  return r;
}

void fdt_cif_take(void* handle, char* names, char* values, int64_t* counts) {
  Result* r = static_cast<Result*>(handle);
  for (const Column& col : r->columns) {
    std::memcpy(names, col.cat.data(), col.cat.size());
    names += col.cat.size();
    *names++ = '\0';
    std::memcpy(names, col.item.data(), col.item.size());
    names += col.item.size();
    *names++ = '\0';
    for (std::string_view v : col.values) {
      std::memcpy(values, v.data(), v.size());
      values += v.size();
      *values++ = '\0';
    }
    *counts++ = int64_t(col.values.size());
  }
  delete r;
}

void fdt_cif_free(void* handle) { delete static_cast<Result*>(handle); }

}  // extern "C"
