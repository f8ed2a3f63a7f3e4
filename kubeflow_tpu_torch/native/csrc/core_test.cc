// Unit tests for the native control-plane core: json, workqueue, store.
// Plain assert-style tests (no gtest in the image), run via ctest.

#include <cassert>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "json.h"
#include "store.h"
#include "wal.h"
#include "workqueue.h"

using kftpu::Json;

#define CHECK(cond)                                                    \
  do {                                                                 \
    if (!(cond)) {                                                     \
      std::fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__,     \
                   #cond);                                             \
      std::exit(1);                                                    \
    }                                                                  \
  } while (0)

#include <cstdio>
#include <cstdlib>

#include <sys/stat.h>

// A scratch directory under $TMPDIR (else /tmp).
static std::string TempDir(const char* prefix) {
  const char* base = std::getenv("TMPDIR");
  std::string tmpl = std::string(base && *base ? base : "/tmp") + "/" +
                     prefix + "XXXXXX";
  std::vector<char> buf(tmpl.begin(), tmpl.end());
  buf.push_back('\0');
  CHECK(mkdtemp(buf.data()) != nullptr);
  return std::string(buf.data());
}

static ino_t Inode(const std::string& path) {
  struct stat st;
  CHECK(::stat(path.c_str(), &st) == 0);
  return st.st_ino;
}

static void TestJsonRoundtrip() {
  std::string err;
  Json v;
  CHECK(Json::Parse(R"({"a": [1, 2.5, true, null, "xé\n"],
                        "b": {"nested": -3e2}})",
                    &v, &err));
  CHECK(v.is_object());
  CHECK(v.get("a").is_array());
  CHECK(v.get("a").as_array()[1].as_number() == 2.5);
  CHECK(v.get("a").as_array()[4].as_string() == "x\xc3\xa9\n");
  CHECK(v.get("b").get("nested").as_number() == -300.0);
  // Integers serialize without a fraction; keys sort deterministically.
  Json back;
  CHECK(Json::Parse(v.dump(), &back, &err));
  CHECK(back.dump() == v.dump());
  CHECK(Json(int64_t{42}).dump() == "42");
  // Surrogate pair.
  CHECK(Json::Parse(R"("😀")", &v, &err));
  CHECK(v.as_string() == "\xF0\x9F\x98\x80");
  // Malformed inputs fail with a message.
  CHECK(!Json::Parse("{\"a\":}", &v, &err));
  CHECK(!Json::Parse("[1,]", &v, &err));
  CHECK(!Json::Parse("01x", &v, &err));
  CHECK(!Json::Parse("\"unterminated", &v, &err));
}

static void TestWorkqueueBasics() {
  void* q = kftpu_wq_new(10, 1000);
  char buf[64];
  // Dedup: same key added twice dequeues once.
  kftpu_wq_add(q, "a");
  kftpu_wq_add(q, "a");
  kftpu_wq_add(q, "b");
  CHECK(kftpu_wq_len(q) == 2);
  CHECK(kftpu_wq_get(q, buf, sizeof(buf), 0) == 1);
  CHECK(std::strcmp(buf, "a") == 0);
  CHECK(kftpu_wq_get(q, buf, sizeof(buf), 0) == 1);
  CHECK(std::strcmp(buf, "b") == 0);
  CHECK(kftpu_wq_get(q, buf, sizeof(buf), 0) == 0);  // empty poll
  // In-flight re-add lands after done (dirty semantics).
  kftpu_wq_done(q, "b");
  kftpu_wq_add(q, "a");  // "a" still in flight
  CHECK(kftpu_wq_get(q, buf, sizeof(buf), 0) == 0);
  kftpu_wq_done(q, "a");
  CHECK(kftpu_wq_get(q, buf, sizeof(buf), 0) == 1);
  CHECK(std::strcmp(buf, "a") == 0);
  kftpu_wq_done(q, "a");
  kftpu_wq_free(q);
}

static void TestWorkqueueDelayAndBackoff() {
  void* q = kftpu_wq_new(10, 80);
  char buf[64];
  // A delayed key is not ready immediately; a sooner re-add supersedes.
  kftpu_wq_add_after(q, "k", 5000);
  CHECK(kftpu_wq_get(q, buf, sizeof(buf), 0) == 0);
  kftpu_wq_add(q, "k");
  CHECK(kftpu_wq_get(q, buf, sizeof(buf), 0) == 1);
  kftpu_wq_done(q, "k");
  // Exponential backoff: 10, 20, 40, 80, 80 (capped).
  CHECK(kftpu_wq_requeue_error(q, "k") == 10);
  CHECK(kftpu_wq_requeue_error(q, "k") == 20);
  CHECK(kftpu_wq_requeue_error(q, "k") == 40);
  CHECK(kftpu_wq_requeue_error(q, "k") == 80);
  CHECK(kftpu_wq_requeue_error(q, "k") == 80);
  kftpu_wq_forget(q, "k");
  CHECK(kftpu_wq_requeue_error(q, "k") == 10);
  // Blocking get picks the key up when the backoff matures.
  CHECK(kftpu_wq_get(q, buf, sizeof(buf), 2000) == 1);
  CHECK(std::strcmp(buf, "k") == 0);
  kftpu_wq_free(q);
}

static void TestWorkqueueThreaded() {
  void* q = kftpu_wq_new(1, 10);
  const int kKeys = 200;
  std::vector<int> seen(kKeys, 0);
  std::vector<std::thread> workers;
  for (int w = 0; w < 4; ++w) {
    workers.emplace_back([&, q] {
      char buf[64];
      while (kftpu_wq_get(q, buf, sizeof(buf), 200) == 1) {
        int idx = std::atoi(buf + 1);
        __atomic_add_fetch(&seen[idx], 1, __ATOMIC_SEQ_CST);
        kftpu_wq_done(q, buf);
      }
    });
  }
  for (int i = 0; i < kKeys; ++i) {
    char key[64];
    std::snprintf(key, sizeof(key), "k%d", i);
    kftpu_wq_add(q, key);
  }
  for (auto& t : workers) t.join();
  for (int i = 0; i < kKeys; ++i) CHECK(seen[i] >= 1);
  kftpu_wq_shutdown(q);
  kftpu_wq_free(q);
}

static Json MustParse(const char* text) {
  Json v;
  std::string err;
  CHECK(Json::Parse(text, &v, &err));
  return v;
}

static void TestStoreCrud() {
  void* s = kftpu_store_new();
  const char* out = kftpu_store_create(
      s, R"({"kind":"TpuJob","metadata":{"name":"j1","namespace":"ml",
             "labels":{"team":"a"}},"spec":{"workers":4},"status":{}})");
  CHECK(out != nullptr);
  Json stored = MustParse(out);
  CHECK(stored.get("metadata").get_string("uid") == "uid-1");
  CHECK(stored.get("metadata").get("resourceVersion").as_number() == 1);
  CHECK(stored.get("metadata").get("generation").as_number() == 1);
  // Duplicate create fails.
  CHECK(kftpu_store_create(
            s, R"({"kind":"TpuJob","metadata":{"name":"j1","namespace":"ml"}})") ==
        nullptr);
  CHECK(kftpu_store_status() == KFTPU_STORE_ALREADY_EXISTS);
  // Get.
  out = kftpu_store_get(s, "TpuJob", "ml", "j1");
  CHECK(out && MustParse(out).get("spec").get("workers").as_number() == 4);
  CHECK(kftpu_store_get(s, "TpuJob", "ml", "nope") == nullptr);
  CHECK(kftpu_store_status() == KFTPU_STORE_NOT_FOUND);
  // Cluster scope: namespace "" is a real scope of its own (Leases,
  // Nodes, ClusterRoles), NOT an alias for "default" — get/delete must
  // round-trip it exactly (FakeApiServer parity).
  CHECK(kftpu_store_create(
            s, R"({"kind":"Lease","metadata":{"name":"ha","namespace":""}})") !=
        nullptr);
  CHECK(kftpu_store_get(s, "Lease", "", "ha") != nullptr);
  CHECK(kftpu_store_get(s, "Lease", "default", "ha") == nullptr);
  CHECK(kftpu_store_status() == KFTPU_STORE_NOT_FOUND);
  // List: "" selects ONLY cluster scope; nullptr selects everything.
  out = kftpu_store_list(s, "Lease", "", nullptr);
  CHECK(out && MustParse(out).as_array().size() == 1);
  out = kftpu_store_list(s, "TpuJob", "", nullptr);
  CHECK(out && MustParse(out).as_array().size() == 0);
  out = kftpu_store_list(s, "TpuJob", nullptr, nullptr);
  CHECK(out && MustParse(out).as_array().size() == 1);
  CHECK(kftpu_store_delete(s, "Lease", "", "ha") == 0);
  // Spec update bumps generation + rv; stale rv conflicts. Metadata
  // fields are replaced from the incoming object, so labels must ride
  // along (same replace semantics as the Python store).
  out = kftpu_store_update(
      s, R"({"kind":"TpuJob","metadata":{"name":"j1","namespace":"ml",
             "labels":{"team":"a"}},"spec":{"workers":8}})",
      0);
  CHECK(out != nullptr);
  stored = MustParse(out);
  CHECK(stored.get("metadata").get("generation").as_number() == 2);
  CHECK(kftpu_store_update(
            s, R"({"kind":"TpuJob","metadata":{"name":"j1","namespace":"ml",
                   "resourceVersion":1},"spec":{"workers":9}})",
            0) == nullptr);
  CHECK(kftpu_store_status() == KFTPU_STORE_CONFLICT);
  // Status update does not bump generation.
  out = kftpu_store_update(
      s, R"({"kind":"TpuJob","metadata":{"name":"j1","namespace":"ml"},
             "status":{"phase":"Running"}})",
      1);
  CHECK(out != nullptr);
  stored = MustParse(out);
  CHECK(stored.get("metadata").get("generation").as_number() == 2);
  CHECK(stored.get("status").get_string("phase") == "Running");
  CHECK(stored.get("spec").get("workers").as_number() == 8);
  // List with label selector.
  kftpu_store_create(
      s, R"({"kind":"TpuJob","metadata":{"name":"j2","namespace":"ml",
             "labels":{"team":"b"}},"spec":{}})");
  out = kftpu_store_list(s, "TpuJob", "ml", R"({"team":"a"})");
  CHECK(out != nullptr);
  Json listed = MustParse(out);
  CHECK(listed.as_array().size() == 1);
  CHECK(listed.as_array()[0].get("metadata").get_string("name") == "j1");
  out = kftpu_store_list(s, "TpuJob", nullptr, nullptr);
  CHECK(MustParse(out).as_array().size() == 2);
  kftpu_store_free(s);
}

static void TestStoreFinalizersAndCascade() {
  void* s = kftpu_store_new();
  // Owner with finalizer.
  const char* out = kftpu_store_create(
      s, R"({"kind":"Profile","metadata":{"name":"p","namespace":"default",
             "finalizers":["cleanup"]},"spec":{}})");
  CHECK(out != nullptr);
  std::string owner_uid =
      MustParse(out).get("metadata").get_string("uid");
  // Dependent owned by it.
  std::string dep = std::string(
      R"({"kind":"Pod","metadata":{"name":"d","namespace":"default",
          "ownerReferences":[{"kind":"Profile","name":"p","uid":")") +
      owner_uid + R"("}]},"spec":{}})";
  CHECK(kftpu_store_create(s, dep.c_str()) != nullptr);
  // Delete owner: finalizer defers removal (deletionTimestamp set).
  CHECK(kftpu_store_delete(s, "Profile", "default", "p") == KFTPU_STORE_OK);
  out = kftpu_store_get(s, "Profile", "default", "p");
  CHECK(out != nullptr);
  CHECK(MustParse(out).get("metadata").get("deletionTimestamp").is_number());
  CHECK(kftpu_store_len(s) == 2);
  // Clearing the finalizer completes deletion and cascades to the pod.
  out = kftpu_store_update(
      s, R"({"kind":"Profile","metadata":{"name":"p","namespace":"default",
             "finalizers":[]},"spec":{}})",
      0);
  CHECK(out != nullptr);
  CHECK(kftpu_store_len(s) == 0);
  // Journal saw the whole story, ending in both DELETEDs.
  int64_t cursor = 0;
  out = kftpu_store_events(s, 0, &cursor);
  Json events = MustParse(out);
  size_t n = events.as_array().size();
  CHECK(n >= 4);
  int deleted = 0;
  for (const Json& ev : events.as_array())
    if (ev.get_string("type") == "DELETED") deleted++;
  CHECK(deleted == 2);
  // Trim empties the journal.
  kftpu_store_trim(s, cursor);
  int64_t cursor2 = cursor;
  out = kftpu_store_events(s, cursor, &cursor2);
  CHECK(MustParse(out).as_array().empty());
  kftpu_store_free(s);
}

static void TestStoreNamespaceDrain() {
  void* s = kftpu_store_new();
  kftpu_store_create(
      s, R"({"kind":"Namespace","metadata":{"name":"team1","namespace":"default"},"spec":{}})");
  kftpu_store_create(
      s, R"({"kind":"Notebook","metadata":{"name":"nb","namespace":"team1"},"spec":{}})");
  kftpu_store_create(
      s, R"({"kind":"Notebook","metadata":{"name":"nb2","namespace":"other"},"spec":{}})");
  CHECK(kftpu_store_delete(s, "Namespace", "default", "team1") ==
        KFTPU_STORE_OK);
  CHECK(kftpu_store_get(s, "Notebook", "team1", "nb") == nullptr);
  CHECK(kftpu_store_get(s, "Notebook", "other", "nb2") != nullptr);
  kftpu_store_free(s);
}

static void TestWalAppendSnapshotReopen() {
  std::string sub = TempDir("kftpu_wal_test_") + "/state";  // open() must mkdir it
  void* w = kftpu_wal_open(sub.c_str());
  CHECK(w != nullptr);
  CHECK(std::string(kftpu_wal_read_snapshot(w)) == "");
  CHECK(std::string(kftpu_wal_read_journal(w)) == "");
  CHECK(kftpu_wal_append(w, R"({"rv":1,"event":"ADDED"})") == 0);
  CHECK(kftpu_wal_append(w, R"({"rv":2,"event":"MODIFIED"})") == 0);
  CHECK(std::string(kftpu_wal_read_journal(w)) ==
        "{\"rv\":1,\"event\":\"ADDED\"}\n{\"rv\":2,\"event\":\"MODIFIED\"}\n");
  // Snapshot replaces atomically and truncates the WAL.
  CHECK(kftpu_wal_snapshot(w, R"({"format":1,"rv":2})") == 0);
  CHECK(std::string(kftpu_wal_read_snapshot(w)) == R"({"format":1,"rv":2})");
  CHECK(std::string(kftpu_wal_read_journal(w)) == "");
  CHECK(kftpu_wal_append(w, R"({"rv":3,"event":"DELETED"})") == 0);
  kftpu_wal_free(w);
  // A second open (the restarted-apiserver path) sees durable state and
  // appends after the existing tail, not over it.
  void* w2 = kftpu_wal_open(sub.c_str());
  CHECK(w2 != nullptr);
  CHECK(std::string(kftpu_wal_read_snapshot(w2)) == R"({"format":1,"rv":2})");
  CHECK(std::string(kftpu_wal_read_journal(w2)) ==
        "{\"rv\":3,\"event\":\"DELETED\"}\n");
  CHECK(kftpu_wal_append(w2, R"({"rv":4,"event":"ADDED"})") == 0);
  CHECK(std::string(kftpu_wal_read_journal(w2)) ==
        "{\"rv\":3,\"event\":\"DELETED\"}\n{\"rv\":4,\"event\":\"ADDED\"}\n");
  kftpu_wal_free(w2);
  // Unwritable parent fails open with a message, not a crash.
  CHECK(kftpu_wal_open("/proc/nope/state") == nullptr);
  CHECK(std::strlen(kftpu_wal_error()) > 0);
}

// The snapshot's truncate is by replacement: wal.log moves to a new
// inode, and a second handle opened before the snapshot (a deposed
// active's) appends into the orphan, never into the live log.
static void TestWalSnapshotMovesLogToNewInode() {
  std::string sub = TempDir("kftpu_wal_inode_") + "/state";
  void* w = kftpu_wal_open(sub.c_str());
  void* deposed = kftpu_wal_open(sub.c_str());
  CHECK(w != nullptr && deposed != nullptr);
  CHECK(kftpu_wal_append(w, R"({"rv":1,"event":"ADDED"})") == 0);
  const ino_t before = Inode(sub + "/wal.log");
  CHECK(kftpu_wal_snapshot(w, R"({"format":1,"rv":1})") == 0);
  CHECK(Inode(sub + "/wal.log") != before);
  CHECK(kftpu_wal_append(deposed, R"({"rv":2,"event":"ADDED"})") == 0);
  CHECK(kftpu_wal_append(w, R"({"rv":2,"event":"MODIFIED"})") == 0);
  CHECK(std::string(kftpu_wal_read_journal(w)) ==
        "{\"rv\":2,\"event\":\"MODIFIED\"}\n");
  struct stat st;
  CHECK(::stat((sub + "/wal.log.tmp").c_str(), &st) != 0);
  kftpu_wal_free(deposed);
  kftpu_wal_free(w);
}

int main() {
  TestJsonRoundtrip();
  TestWorkqueueBasics();
  TestWorkqueueDelayAndBackoff();
  TestWorkqueueThreaded();
  TestStoreCrud();
  TestStoreFinalizersAndCascade();
  TestStoreNamespaceDrain();
  TestWalAppendSnapshotReopen();
  TestWalSnapshotMovesLogToNewInode();
  std::printf("core_test: all ok\n");
  return 0;
}
