#include "store.h"

#include <atomic>
#include <chrono>
#include <cstdio>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <tuple>
#include <vector>

#include "json.h"

namespace {

using kftpu::Json;
using kftpu::JsonArray;
using kftpu::JsonObject;

thread_local int32_t tls_status = KFTPU_STORE_OK;
thread_local std::string tls_error;
thread_local std::string tls_result;

const char* Ok(std::string result) {
  tls_status = KFTPU_STORE_OK;
  tls_error.clear();
  tls_result = std::move(result);
  return tls_result.c_str();
}

const char* Err(int32_t code, std::string msg) {
  tls_status = code;
  tls_error = std::move(msg);
  return nullptr;
}

double NowSeconds() {
  return std::chrono::duration<double>(
             std::chrono::system_clock::now().time_since_epoch())
      .count();
}

using Key = std::tuple<std::string, std::string, std::string>;  // kind,ns,name

std::string KeyStr(const Key& k) {
  return std::get<0>(k) + " " + std::get<1>(k) + "/" + std::get<2>(k);
}

struct Event {
  int64_t seq;
  std::string type;
  Json object;
};

// Metadata accessors over the JSON doc -------------------------------------

Json& Meta(Json& obj) { return obj.as_object()["metadata"]; }

const Json& Meta(const Json& obj) { return obj.get("metadata"); }

bool ExtractKey(const Json& obj, Key* out, std::string* why) {
  if (!obj.is_object()) {
    *why = "object is not a JSON object";
    return false;
  }
  std::string kind = obj.get_string("kind");
  const Json& meta = Meta(obj);
  std::string name = meta.get_string("name");
  std::string ns = meta.get_string("namespace", "default");
  if (kind.empty() || name.empty()) {
    *why = "kind and metadata.name are required";
    return false;
  }
  *out = Key{kind, ns, name};
  return true;
}

int64_t MetaInt(const Json& obj, const std::string& field) {
  const Json& v = Meta(obj).get(field);
  return v.is_number() ? static_cast<int64_t>(v.as_number()) : 0;
}

bool HasFinalizers(const Json& obj) {
  const Json& f = Meta(obj).get("finalizers");
  return f.is_array() && !f.as_array().empty();
}

bool DeletionPending(const Json& obj) {
  return Meta(obj).get("deletionTimestamp").is_number();
}

bool LabelsMatch(const Json& obj, const Json& selector) {
  if (!selector.is_object() || selector.as_object().empty()) return true;
  const Json& labels = Meta(obj).get("labels");
  for (const auto& [k, v] : selector.as_object()) {
    const Json& have = labels.get(k);
    if (!have.is_string() || !v.is_string() ||
        have.as_string() != v.as_string())
      return false;
  }
  return true;
}

class Store {
 public:
  const char* Create(const char* obj_json) {
    Json obj;
    std::string err;
    if (!Json::Parse(obj_json ? obj_json : "", &obj, &err))
      return Err(KFTPU_STORE_BAD_OBJECT, "parse: " + err);
    Key key;
    if (!ExtractKey(obj, &key, &err))
      return Err(KFTPU_STORE_BAD_OBJECT, err);
    std::string result;
    {
      std::lock_guard<std::mutex> lock(mu_);
      if (objects_.count(key))
        return Err(KFTPU_STORE_ALREADY_EXISTS, KeyStr(key) + " already exists");
      JsonObject& meta = Meta(obj).is_object()
                             ? Meta(obj).as_object()
                             : (Meta(obj) = Json(JsonObject{})).as_object();
      char uid[32];
      std::snprintf(uid, sizeof(uid), "uid-%llu",
                    static_cast<unsigned long long>(++uid_counter_));
      meta["uid"] = Json(std::string(uid));
      meta["resourceVersion"] = Json(static_cast<int64_t>(++rv_));
      meta["generation"] = Json(1);
      meta["creationTimestamp"] = Json(NowSeconds());
      objects_[key] = obj;
      Append("ADDED", obj);
      result = obj.dump();
    }
    return Ok(std::move(result));
  }

  const char* Get(const char* kind, const char* ns, const char* name) {
    // Exact namespace match: "" IS the cluster scope (FakeApiServer
    // parity) — coercing it to "default" made cluster-scoped objects
    // (Leases, Nodes, ClusterRoles) unreachable by get/delete.
    Key key{kind ? kind : "", ns ? ns : "", name ? name : ""};
    std::lock_guard<std::mutex> lock(mu_);
    auto it = objects_.find(key);
    if (it == objects_.end())
      return Err(KFTPU_STORE_NOT_FOUND, KeyStr(key) + " not found");
    return Ok(it->second.dump());
  }

  const char* Update(const char* obj_json, bool status_only) {
    Json obj;
    std::string err;
    if (!Json::Parse(obj_json ? obj_json : "", &obj, &err))
      return Err(KFTPU_STORE_BAD_OBJECT, "parse: " + err);
    Key key;
    if (!ExtractKey(obj, &key, &err))
      return Err(KFTPU_STORE_BAD_OBJECT, err);
    std::string result;
    {
      std::lock_guard<std::mutex> lock(mu_);
      auto it = objects_.find(key);
      if (it == objects_.end())
        return Err(KFTPU_STORE_NOT_FOUND, KeyStr(key) + " not found");
      Json& stored = it->second;
      int64_t incoming_rv = MetaInt(obj, "resourceVersion");
      int64_t current_rv = MetaInt(stored, "resourceVersion");
      if (incoming_rv != 0 && incoming_rv != current_rv) {
        char msg[160];
        std::snprintf(msg, sizeof(msg),
                      "%s: stale resourceVersion %lld != %lld",
                      KeyStr(key).c_str(),
                      static_cast<long long>(incoming_rv),
                      static_cast<long long>(current_rv));
        return Err(KFTPU_STORE_CONFLICT, msg);
      }
      JsonObject& smeta = Meta(stored).as_object();
      JsonObject& sobj = stored.as_object();
      JsonObject& iobj = obj.as_object();
      if (status_only) {
        sobj["status"] = iobj.count("status") ? iobj["status"]
                                              : Json(JsonObject{});
      } else {
        Json& ispec = iobj["spec"];
        if (!ispec.is_object()) ispec = Json(JsonObject{});
        if (sobj["spec"].dump() != ispec.dump()) {
          smeta["generation"] =
              Json(MetaInt(stored, "generation") + 1);
        }
        sobj["spec"] = ispec;
        const JsonObject& imeta = Meta(obj).is_object()
                                      ? Meta(obj).as_object()
                                      : JsonObject{};
        for (const char* field :
             {"labels", "annotations", "finalizers", "ownerReferences"}) {
          auto fit = imeta.find(field);
          smeta[field] = fit == imeta.end() ? Json() : fit->second;
        }
      }
      smeta["resourceVersion"] = Json(static_cast<int64_t>(++rv_));
      if (MaybeFinalize(key)) {
        result = last_removed_.dump();
      } else {
        Append("MODIFIED", stored);
        result = stored.dump();
      }
    }
    return Ok(std::move(result));
  }

  const char* List(const char* kind, const char* ns,
                   const char* selector_json) {
    Json selector;
    if (selector_json && *selector_json) {
      std::string err;
      if (!Json::Parse(selector_json, &selector, &err))
        return Err(KFTPU_STORE_BAD_OBJECT, "selector parse: " + err);
    }
    // ns == nullptr means ALL namespaces; ns == "" is the cluster
    // scope, matched exactly like any other namespace (Get/Delete
    // semantics; FakeApiServer parity).
    JsonArray out;
    {
      std::lock_guard<std::mutex> lock(mu_);
      for (const auto& [key, obj] : objects_) {
        if (std::get<0>(key) != (kind ? kind : "")) continue;
        if (ns != nullptr && std::get<1>(key) != ns) continue;
        if (!LabelsMatch(obj, selector)) continue;
        out.push_back(obj);
      }
    }
    return Ok(Json(std::move(out)).dump());
  }

  int32_t Delete(const char* kind, const char* ns, const char* name) {
    Key key{kind ? kind : "", ns ? ns : "", name ? name : ""};
    std::lock_guard<std::mutex> lock(mu_);
    return DeleteLocked(key);
  }

  const char* Events(int64_t cursor, int64_t* new_cursor) {
    JsonArray out;
    int64_t last = cursor;
    {
      std::lock_guard<std::mutex> lock(mu_);
      for (const Event& ev : journal_) {
        if (ev.seq <= cursor) continue;
        JsonObject e;
        e["seq"] = Json(ev.seq);
        e["type"] = Json(ev.type);
        e["object"] = ev.object;
        out.push_back(Json(std::move(e)));
        last = ev.seq;
      }
    }
    if (new_cursor) *new_cursor = last;
    return Ok(Json(std::move(out)).dump());
  }

  void Trim(int64_t cursor) {
    std::lock_guard<std::mutex> lock(mu_);
    while (!journal_.empty() && journal_.front().seq <= cursor)
      journal_.pop_front();
  }

  int64_t Len() {
    std::lock_guard<std::mutex> lock(mu_);
    return static_cast<int64_t>(objects_.size());
  }

 private:
  // All helpers below run with mu_ held.

  int32_t DeleteLocked(const Key& key) {
    auto it = objects_.find(key);
    if (it == objects_.end()) {
      Err(KFTPU_STORE_NOT_FOUND, KeyStr(key) + " not found");
      return KFTPU_STORE_NOT_FOUND;
    }
    Json& obj = it->second;
    if (HasFinalizers(obj)) {
      if (!DeletionPending(obj)) {
        JsonObject& meta = Meta(obj).as_object();
        meta["deletionTimestamp"] = Json(NowSeconds());
        meta["resourceVersion"] = Json(static_cast<int64_t>(++rv_));
        Append("MODIFIED", obj);
      }
      tls_status = KFTPU_STORE_OK;
      return KFTPU_STORE_OK;
    }
    Remove(key, /*emit_delete=*/true);
    tls_status = KFTPU_STORE_OK;
    return KFTPU_STORE_OK;
  }

  bool MaybeFinalize(const Key& key) {
    Json& stored = objects_.at(key);
    if (DeletionPending(stored) && !HasFinalizers(stored)) {
      last_removed_ = stored;
      // The caller's update cleared the last finalizer of a
      // deletion-pending object: that update IS the deletion. The
      // finalizing update already bumped rv onto last_removed_, so the
      // DELETED event is journal-ordered without another bump — but it
      // must be appended BEFORE Remove() runs the owner-ref cascade:
      // cascaded children get fresh (higher) rvs, and the journal must
      // stay rv-sorted (the Python wrapper's resume bisects on rv).
      Append("DELETED", last_removed_);
      Remove(key, /*emit_delete=*/false);
      return true;
    }
    return false;
  }

  void Remove(const Key& key, bool emit_delete) {
    Json obj = objects_.at(key);
    objects_.erase(key);
    if (emit_delete) {
      // Deletion is a state transition of its own: stamp the DELETED
      // event with a FRESH rv (FakeApiServer._remove parity) so a
      // watcher resuming from the object's last-seen version still
      // observes the removal — with the stale rv, events_since(rv)
      // would silently skip it and the watcher caches the object
      // forever.
      Meta(obj).as_object()["resourceVersion"] =
          Json(static_cast<int64_t>(++rv_));
      Append("DELETED", obj);
    }
    Cascade(obj);
    if (std::get<0>(key) == "Namespace") DrainNamespace(std::get<2>(key));
  }

  void Cascade(const Json& owner) {
    std::string uid = Meta(owner).get_string("uid");
    if (uid.empty()) return;
    std::vector<Key> dependents;
    for (const auto& [key, obj] : objects_) {
      const Json& refs = Meta(obj).get("ownerReferences");
      if (!refs.is_array()) continue;
      for (const Json& ref : refs.as_array()) {
        if (ref.get_string("uid") == uid) {
          dependents.push_back(key);
          break;
        }
      }
    }
    for (const Key& key : dependents)
      if (objects_.count(key)) DeleteLocked(key);
  }

  void DrainNamespace(const std::string& ns) {
    std::vector<Key> inside;
    for (const auto& [key, obj] : objects_)
      if (std::get<1>(key) == ns) inside.push_back(key);
    for (const Key& key : inside)
      if (objects_.count(key)) DeleteLocked(key);
  }

  void Append(const std::string& type, const Json& obj) {
    journal_.push_back(Event{++seq_, type, obj});
  }

  std::mutex mu_;
  std::map<Key, Json> objects_;
  std::deque<Event> journal_;
  Json last_removed_;
  int64_t rv_ = 0;
  int64_t seq_ = 0;
  uint64_t uid_counter_ = 0;
};

}  // namespace

extern "C" {

void* kftpu_store_new() { return new Store(); }
void kftpu_store_free(void* s) { delete static_cast<Store*>(s); }

const char* kftpu_store_create(void* s, const char* obj_json) {
  return static_cast<Store*>(s)->Create(obj_json);
}

const char* kftpu_store_get(void* s, const char* kind, const char* ns,
                            const char* name) {
  return static_cast<Store*>(s)->Get(kind, ns, name);
}

const char* kftpu_store_update(void* s, const char* obj_json,
                               int32_t status_only) {
  return static_cast<Store*>(s)->Update(obj_json, status_only != 0);
}

const char* kftpu_store_list(void* s, const char* kind, const char* ns,
                             const char* selector_json) {
  return static_cast<Store*>(s)->List(kind, ns, selector_json);
}

int32_t kftpu_store_delete(void* s, const char* kind, const char* ns,
                           const char* name) {
  return static_cast<Store*>(s)->Delete(kind, ns, name);
}

const char* kftpu_store_events(void* s, int64_t cursor,
                               int64_t* new_cursor) {
  return static_cast<Store*>(s)->Events(cursor, new_cursor);
}

void kftpu_store_trim(void* s, int64_t cursor) {
  static_cast<Store*>(s)->Trim(cursor);
}

int64_t kftpu_store_len(void* s) { return static_cast<Store*>(s)->Len(); }

int32_t kftpu_store_status() { return tls_status; }

const char* kftpu_store_error() { return tls_error.c_str(); }

}  // extern "C"
