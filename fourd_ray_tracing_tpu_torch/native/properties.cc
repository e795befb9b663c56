// Native config parser: `key = value  # comment` files.
//
// The port's own copy of the JAX package's native/properties.cc, the same
// code: trim, '#' comments, later duplicates win; exposed as a C ABI for
// ctypes (native/binding.py parse_properties). The Python parser
// (utils/config.py parse_properties_text) follows the same rules.

#include <cctype>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

std::string trim(const std::string& s) {
  size_t b = 0, e = s.size();
  while (b < e && std::isspace(static_cast<unsigned char>(s[b]))) ++b;
  while (e > b && std::isspace(static_cast<unsigned char>(s[e - 1]))) --e;
  return s.substr(b, e - b);
}

// Parsed map, serialized as key\x1Fvalue\x1E... for the ctypes boundary.
std::string parse_to_record(const char* text) {
  std::map<std::string, std::string> out;
  std::vector<std::string> order;
  const char* p = text;
  while (*p) {
    const char* q = p;
    while (*q && *q != '\n') ++q;
    std::string line(p, q - p);
    p = (*q == '\n') ? q + 1 : q;

    size_t hash = line.find('#');
    if (hash != std::string::npos) line = line.substr(0, hash);
    size_t eq = line.find('=');
    if (eq == std::string::npos) continue;
    std::string key = trim(line.substr(0, eq));
    std::string value = trim(line.substr(eq + 1));
    if (key.empty()) continue;
    if (out.find(key) == out.end()) order.push_back(key);
    out[key] = value;
  }
  std::string rec;
  for (const auto& k : order) {
    rec += k;
    rec += '\x1F';
    rec += out[k];
    rec += '\x1E';
  }
  return rec;
}

}  // namespace

extern "C" {

// Returns a malloc'd record string; caller frees with fourd_free().
char* fourd_parse_properties(const char* text) {
  std::string rec = parse_to_record(text);
  char* buf = static_cast<char*>(std::malloc(rec.size() + 1));
  if (!buf) return nullptr;
  std::memcpy(buf, rec.c_str(), rec.size() + 1);
  return buf;
}

void fourd_free(char* p) { std::free(p); }

}  // extern "C"
