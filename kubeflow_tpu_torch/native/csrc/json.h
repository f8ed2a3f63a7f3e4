// Minimal JSON DOM for the native control-plane core.
//
// The store (store.cc) keeps whole API objects as JSON and needs to
// introspect metadata (labels, finalizers, ownerReferences), so the native
// tier carries its own parser/serializer rather than depending on a
// system library (none is baked into the image). Supports the full JSON
// grammar with UTF-8 passthrough and \uXXXX escapes (incl. surrogate
// pairs). Not exported over the C ABI — internal to libkftpu_core.

#pragma once

#include <cstdint>
#include <map>
#include <memory>
#include <string>
#include <variant>
#include <vector>

namespace kftpu {

class Json;
using JsonArray = std::vector<Json>;
// std::map keeps serialization deterministic (sorted keys) — handy for
// golden tests and stable resourceVersion-independent diffing.
using JsonObject = std::map<std::string, Json>;

class Json {
 public:
  enum class Type { kNull, kBool, kNumber, kString, kArray, kObject };

  Json() : v_(nullptr) {}
  Json(std::nullptr_t) : v_(nullptr) {}
  Json(bool b) : v_(b) {}
  Json(double d) : v_(d) {}
  Json(int i) : v_(static_cast<double>(i)) {}
  Json(int64_t i) : v_(static_cast<double>(i)) {}
  Json(const char* s) : v_(std::string(s)) {}
  Json(std::string s) : v_(std::move(s)) {}
  Json(JsonArray a) : v_(std::move(a)) {}
  Json(JsonObject o) : v_(std::move(o)) {}

  Type type() const { return static_cast<Type>(v_.index()); }
  bool is_null() const { return type() == Type::kNull; }
  bool is_bool() const { return type() == Type::kBool; }
  bool is_number() const { return type() == Type::kNumber; }
  bool is_string() const { return type() == Type::kString; }
  bool is_array() const { return type() == Type::kArray; }
  bool is_object() const { return type() == Type::kObject; }

  bool as_bool() const { return std::get<bool>(v_); }
  double as_number() const { return std::get<double>(v_); }
  const std::string& as_string() const { return std::get<std::string>(v_); }
  const JsonArray& as_array() const { return std::get<JsonArray>(v_); }
  JsonArray& as_array() { return std::get<JsonArray>(v_); }
  const JsonObject& as_object() const { return std::get<JsonObject>(v_); }
  JsonObject& as_object() { return std::get<JsonObject>(v_); }

  // Object convenience: get(key) returns null Json when absent/not object.
  const Json& get(const std::string& key) const;
  bool has(const std::string& key) const;
  // get(key).as_string() with a default when absent or not a string.
  std::string get_string(const std::string& key,
                         const std::string& def = "") const;

  std::string dump() const;

  // Returns false (and fills err with position info) on malformed input.
  static bool Parse(const std::string& text, Json* out, std::string* err);

 private:
  std::variant<std::nullptr_t, bool, double, std::string, JsonArray,
               JsonObject>
      v_;
};

}  // namespace kftpu
