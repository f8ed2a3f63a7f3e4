#include "json.h"

#include <cmath>
#include <cstdio>
#include <cstring>

namespace kftpu {

namespace {

const Json kNullJson;

struct Parser {
  const char* p;
  const char* end;
  std::string* err;

  bool Fail(const std::string& what) {
    if (err) {
      char buf[64];
      std::snprintf(buf, sizeof(buf), " at byte %zd",
                    static_cast<size_t>(p - start));
      *err = what + buf;
    }
    return false;
  }

  const char* start;

  void SkipWs() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }

  bool Literal(const char* lit) {
    size_t n = std::strlen(lit);
    if (static_cast<size_t>(end - p) < n || std::memcmp(p, lit, n) != 0)
      return Fail("bad literal");
    p += n;
    return true;
  }

  static void AppendUtf8(std::string* s, uint32_t cp) {
    if (cp < 0x80) {
      s->push_back(static_cast<char>(cp));
    } else if (cp < 0x800) {
      s->push_back(static_cast<char>(0xC0 | (cp >> 6)));
      s->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
      s->push_back(static_cast<char>(0xE0 | (cp >> 12)));
      s->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
      s->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else {
      s->push_back(static_cast<char>(0xF0 | (cp >> 18)));
      s->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
      s->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
      s->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    }
  }

  bool Hex4(uint32_t* out) {
    if (end - p < 4) return Fail("truncated \\u escape");
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) {
      char c = *p++;
      v <<= 4;
      if (c >= '0' && c <= '9')
        v |= c - '0';
      else if (c >= 'a' && c <= 'f')
        v |= c - 'a' + 10;
      else if (c >= 'A' && c <= 'F')
        v |= c - 'A' + 10;
      else
        return Fail("bad hex digit");
    }
    *out = v;
    return true;
  }

  bool String(std::string* out) {
    ++p;  // opening quote
    while (p < end) {
      unsigned char c = *p;
      if (c == '"') {
        ++p;
        return true;
      }
      if (c == '\\') {
        ++p;
        if (p >= end) return Fail("truncated escape");
        char e = *p++;
        switch (e) {
          case '"': out->push_back('"'); break;
          case '\\': out->push_back('\\'); break;
          case '/': out->push_back('/'); break;
          case 'b': out->push_back('\b'); break;
          case 'f': out->push_back('\f'); break;
          case 'n': out->push_back('\n'); break;
          case 'r': out->push_back('\r'); break;
          case 't': out->push_back('\t'); break;
          case 'u': {
            uint32_t cp;
            if (!Hex4(&cp)) return false;
            if (cp >= 0xD800 && cp <= 0xDBFF) {  // high surrogate
              if (end - p < 2 || p[0] != '\\' || p[1] != 'u')
                return Fail("unpaired surrogate");
              p += 2;
              uint32_t lo;
              if (!Hex4(&lo)) return false;
              if (lo < 0xDC00 || lo > 0xDFFF)
                return Fail("bad low surrogate");
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
            }
            AppendUtf8(out, cp);
            break;
          }
          default:
            return Fail("bad escape");
        }
      } else if (c < 0x20) {
        return Fail("control char in string");
      } else {
        out->push_back(static_cast<char>(c));
        ++p;
      }
    }
    return Fail("unterminated string");
  }

  bool Value(Json* out, int depth) {
    if (depth > 256) return Fail("nesting too deep");
    SkipWs();
    if (p >= end) return Fail("unexpected end");
    switch (*p) {
      case 'n':
        if (!Literal("null")) return false;
        *out = Json();
        return true;
      case 't':
        if (!Literal("true")) return false;
        *out = Json(true);
        return true;
      case 'f':
        if (!Literal("false")) return false;
        *out = Json(false);
        return true;
      case '"': {
        std::string s;
        if (!String(&s)) return false;
        *out = Json(std::move(s));
        return true;
      }
      case '[': {
        ++p;
        JsonArray arr;
        SkipWs();
        if (p < end && *p == ']') {
          ++p;
          *out = Json(std::move(arr));
          return true;
        }
        while (true) {
          Json elem;
          if (!Value(&elem, depth + 1)) return false;
          arr.push_back(std::move(elem));
          SkipWs();
          if (p >= end) return Fail("unterminated array");
          if (*p == ',') {
            ++p;
            continue;
          }
          if (*p == ']') {
            ++p;
            *out = Json(std::move(arr));
            return true;
          }
          return Fail("expected ',' or ']'");
        }
      }
      case '{': {
        ++p;
        JsonObject obj;
        SkipWs();
        if (p < end && *p == '}') {
          ++p;
          *out = Json(std::move(obj));
          return true;
        }
        while (true) {
          SkipWs();
          if (p >= end || *p != '"') return Fail("expected object key");
          std::string key;
          if (!String(&key)) return false;
          SkipWs();
          if (p >= end || *p != ':') return Fail("expected ':'");
          ++p;
          Json val;
          if (!Value(&val, depth + 1)) return false;
          obj[std::move(key)] = std::move(val);
          SkipWs();
          if (p >= end) return Fail("unterminated object");
          if (*p == ',') {
            ++p;
            continue;
          }
          if (*p == '}') {
            ++p;
            *out = Json(std::move(obj));
            return true;
          }
          return Fail("expected ',' or '}'");
        }
      }
      default: {
        // number
        const char* num_start = p;
        if (p < end && *p == '-') ++p;
        while (p < end &&
               ((*p >= '0' && *p <= '9') || *p == '.' || *p == 'e' ||
                *p == 'E' || *p == '+' || *p == '-'))
          ++p;
        if (p == num_start) return Fail("unexpected character");
        std::string num(num_start, p - num_start);
        char* parse_end = nullptr;
        double d = std::strtod(num.c_str(), &parse_end);
        if (parse_end != num.c_str() + num.size())
          return Fail("bad number");
        *out = Json(d);
        return true;
      }
    }
  }
};

void DumpString(const std::string& s, std::string* out) {
  out->push_back('"');
  for (unsigned char c : s) {
    switch (c) {
      case '"': *out += "\\\""; break;
      case '\\': *out += "\\\\"; break;
      case '\b': *out += "\\b"; break;
      case '\f': *out += "\\f"; break;
      case '\n': *out += "\\n"; break;
      case '\r': *out += "\\r"; break;
      case '\t': *out += "\\t"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", c);
          *out += buf;
        } else {
          out->push_back(static_cast<char>(c));  // UTF-8 passthrough
        }
    }
  }
  out->push_back('"');
}

void DumpValue(const Json& j, std::string* out) {
  switch (j.type()) {
    case Json::Type::kNull:
      *out += "null";
      break;
    case Json::Type::kBool:
      *out += j.as_bool() ? "true" : "false";
      break;
    case Json::Type::kNumber: {
      double d = j.as_number();
      if (std::isfinite(d) && d == std::floor(d) && std::fabs(d) < 1e15) {
        char buf[32];
        std::snprintf(buf, sizeof(buf), "%lld",
                      static_cast<long long>(d));
        *out += buf;
      } else {
        char buf[32];
        std::snprintf(buf, sizeof(buf), "%.17g", d);
        *out += buf;
      }
      break;
    }
    case Json::Type::kString:
      DumpString(j.as_string(), out);
      break;
    case Json::Type::kArray: {
      out->push_back('[');
      bool first = true;
      for (const Json& e : j.as_array()) {
        if (!first) out->push_back(',');
        first = false;
        DumpValue(e, out);
      }
      out->push_back(']');
      break;
    }
    case Json::Type::kObject: {
      out->push_back('{');
      bool first = true;
      for (const auto& [k, v] : j.as_object()) {
        if (!first) out->push_back(',');
        first = false;
        DumpString(k, out);
        out->push_back(':');
        DumpValue(v, out);
      }
      out->push_back('}');
      break;
    }
  }
}

}  // namespace

const Json& Json::get(const std::string& key) const {
  if (!is_object()) return kNullJson;
  auto it = as_object().find(key);
  return it == as_object().end() ? kNullJson : it->second;
}

bool Json::has(const std::string& key) const {
  return is_object() && as_object().count(key) > 0;
}

std::string Json::get_string(const std::string& key,
                             const std::string& def) const {
  const Json& v = get(key);
  return v.is_string() ? v.as_string() : def;
}

std::string Json::dump() const {
  std::string out;
  DumpValue(*this, &out);
  return out;
}

bool Json::Parse(const std::string& text, Json* out, std::string* err) {
  Parser parser{text.data(), text.data() + text.size(), err};
  parser.start = text.data();
  if (!parser.Value(out, 0)) return false;
  parser.SkipWs();
  if (parser.p != parser.end) return parser.Fail("trailing garbage");
  return true;
}

}  // namespace kftpu
