// Bulk relationship-text parser: text -> interned pool + int32 columns.
//
// The port's bootstrap loader (spicedb/columnar.py ColumnarSnapshot.
// from_text): a 1M-tuple bootstrap parsed in Python makes millions of
// string objects and dict probes; this parses the UTF-8 bytes in one pass
// into an interned string pool and six int32 ordinal columns without a
// Python object per tuple.
//
// Grammar (rules/relstring.py's relationship regex, every split at the
// FIRST occurrence of its delimiter):
//   resourceType ':' resourceID '#' relation '@' subjectType ':' subjectID
//   ('#' subjectRel)?  ('[expiration:' float ']')?
// subjectRel "..." normalises to "" (types.py ELLIPSIS); an empty field or
// a "{{" template is an error (types.parse_relationship).  Lines split on
// '\n' only, are stripped of ASCII whitespace, and blank and '#' lines are
// skipped (endpoints.Bootstrap.relationships()).  An expiration is what
// Python's float() takes after ASCII stripping: no hex, no underscores,
// no "nan(...)".
//
// Plain C ABI, bound with ctypes (native/__init__.py), two calls:
//   fp_parse(text, len, &n_rows, &n_pool, &pool_bytes, err, err_cap)
//     -> handle (null on a bad line, the message in err)
//   fp_fill(handle, cols, expiry, pool)
//     cols    int32 [6 * n_rows]: rtype, rid, rel, stype, sid, srel rows
//     expiry  float64 [n_rows]: NaN for none
//     pool    char [pool_bytes]: the pool's entries in order, joined by
//             '\n' (no entry holds one: lines split on it)
//   fp_free(handle)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Parsed {
  std::unordered_map<std::string_view, int32_t> index;
  std::vector<std::string_view> pool;
  std::vector<int32_t> cols[6];
  std::vector<double> expiry;
  int64_t pool_bytes = 0;

  int32_t intern(std::string_view s) {
    auto it = index.find(s);
    if (it != index.end()) return it->second;
    int32_t id = static_cast<int32_t>(pool.size());
    index.emplace(s, id);
    pool.push_back(s);
    pool_bytes += static_cast<int64_t>(s.size()) + (id ? 1 : 0);
    return id;
  }
};

inline bool ascii_space(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
         c == '\f';
}

std::string_view strip(std::string_view s) {
  size_t b = 0, e = s.size();
  while (b < e && ascii_space(s[b])) ++b;
  while (e > b && ascii_space(s[e - 1])) --e;
  return s.substr(b, e - b);
}

void fail(char* err, int64_t cap, size_t lineno, std::string_view line,
          const char* why) {
  if (err == nullptr || cap <= 0) return;
  std::string shown(line.substr(0, 200));
  std::snprintf(err, static_cast<size_t>(cap), "line %zu: %s: %s", lineno,
                why, shown.c_str());
}

// float() of an ASCII-stripped number: the whole string, no hex forms, no
// underscores and no "nan(...)" (which strtod takes and Python does not)
bool parse_float(std::string_view num, double* out) {
  if (num.empty()) return false;
  for (char c : num)
    if (c == 'x' || c == 'X' || c == '_' || c == '(' || ascii_space(c))
      return false;
  std::string s(num);
  char* end = nullptr;
  double v = std::strtod(s.c_str(), &end);
  if (end != s.c_str() + s.size()) return false;
  *out = v;
  return true;
}

bool parse_line(Parsed* p, std::string_view line, size_t lineno, char* err,
                int64_t cap) {
  double exp = std::nan("");
  if (!line.empty() && line.back() == ']') {
    size_t lb = line.rfind("[expiration:");
    if (lb != std::string_view::npos) {
      std::string_view num = strip(line.substr(lb + 12, line.size() - lb - 13));
      if (!parse_float(num, &exp)) {
        fail(err, cap, lineno, line, "bad expiration");
        return false;
      }
      line = line.substr(0, lb);
    }
  }
  size_t c1 = line.find(':');
  size_t h1 = c1 == std::string_view::npos ? c1 : line.find('#', c1 + 1);
  size_t at = h1 == std::string_view::npos ? h1 : line.find('@', h1 + 1);
  size_t c2 = at == std::string_view::npos ? at : line.find(':', at + 1);
  if (c2 == std::string_view::npos) {
    fail(err, cap, lineno, line, "malformed");
    return false;
  }
  std::string_view f[6] = {line.substr(0, c1),
                           line.substr(c1 + 1, h1 - c1 - 1),
                           line.substr(h1 + 1, at - h1 - 1),
                           line.substr(at + 1, c2 - at - 1),
                           line.substr(c2 + 1), std::string_view()};
  size_t h2 = f[4].find('#');
  if (h2 != std::string_view::npos) {
    f[5] = f[4].substr(h2 + 1);
    f[4] = f[4].substr(0, h2);
  }
  if (f[5] == "...") f[5] = std::string_view();
  for (int i = 0; i < 5; ++i) {
    if (f[i].empty()) {
      fail(err, cap, lineno, line, "malformed");
      return false;
    }
  }
  if (line.find("{{") != std::string_view::npos) {
    fail(err, cap, lineno, line, "malformed");
    return false;
  }
  for (int i = 0; i < 6; ++i) p->cols[i].push_back(p->intern(f[i]));
  p->expiry.push_back(exp);
  return true;
}

}  // namespace

extern "C" {

void* fp_parse(const char* buf, int64_t len, int64_t* n_rows, int64_t* n_pool,
               int64_t* pool_bytes, char* err, int64_t err_cap) {
  auto* p = new Parsed();
  std::string_view text(buf, static_cast<size_t>(len));
  size_t start = 0, lineno = 0;
  while (start <= text.size()) {
    size_t nl = text.find('\n', start);
    size_t end = nl == std::string_view::npos ? text.size() : nl;
    std::string_view line = strip(text.substr(start, end - start));
    start = end + 1;
    ++lineno;
    if (line.empty() || line[0] == '#') continue;
    if (!parse_line(p, line, lineno, err, err_cap)) {
      delete p;
      return nullptr;
    }
  }
  *n_rows = static_cast<int64_t>(p->expiry.size());
  *n_pool = static_cast<int64_t>(p->pool.size());
  *pool_bytes = p->pool_bytes;
  return p;
}

void fp_fill(void* handle, int32_t* cols, double* expiry, char* pool) {
  auto* p = static_cast<Parsed*>(handle);
  size_t n = p->expiry.size();
  for (int i = 0; i < 6; ++i)
    if (n) std::memcpy(cols + i * n, p->cols[i].data(), n * sizeof(int32_t));
  if (n) std::memcpy(expiry, p->expiry.data(), n * sizeof(double));
  char* o = pool;
  for (size_t i = 0; i < p->pool.size(); ++i) {
    if (i) *o++ = '\n';
    std::memcpy(o, p->pool[i].data(), p->pool[i].size());
    o += p->pool[i].size();
  }
}

void fp_free(void* handle) { delete static_cast<Parsed*>(handle); }

}  // extern "C"
