// Native API-object store — the storage core of the control plane.
//
// Implements the K8s resource-model semantics every controller's
// correctness depends on (the subset the reference leaned on envtest for,
// `profile-controller/controllers/suite_test.go:29-54`), compiled:
//
//   - optimistic concurrency (resourceVersion conflict on stale writes)
//   - spec vs status as separate update surfaces; generation bumps on
//     spec change only
//   - label-selector list
//   - finalizers: delete marks deletionTimestamp; removal happens when
//     the last finalizer is cleared
//   - owner references: cascading delete of dependents; namespace
//     deletion drains all namespaced objects
//   - a watch journal: every ADDED/MODIFIED/DELETED event is appended to
//     a cursor-addressable log that clients poll and trim
//
// Objects are whole JSON documents ({apiVersion, kind, metadata, spec,
// status}); the store introspects metadata itself (json.h). C ABI for
// ctypes. All functions are thread-safe.
//
// Result-buffer convention: calls returning `const char*` hand back a
// pointer to a thread-local buffer valid until the SAME thread's next
// store call — callers must copy (ctypes' c_char_p restype does).
// NULL means error; fetch the code/message with kftpu_store_status /
// kftpu_store_error (also thread-local).

#pragma once
#include <cstdint>

extern "C" {

// Status codes (kftpu_store_status after a NULL/negative return).
enum kftpu_store_code {
  KFTPU_STORE_OK = 0,
  KFTPU_STORE_NOT_FOUND = -1,
  KFTPU_STORE_ALREADY_EXISTS = -2,
  KFTPU_STORE_CONFLICT = -3,
  KFTPU_STORE_BAD_OBJECT = -4,  // malformed JSON / missing kind or name
};

void* kftpu_store_new();
void kftpu_store_free(void* s);

// Create; fills uid/resourceVersion/generation/creationTimestamp.
// Returns the stored object.
const char* kftpu_store_create(void* s, const char* obj_json);

// Get one object.
const char* kftpu_store_get(void* s, const char* kind, const char* ns,
                            const char* name);

// Update. status_only=1 replaces only .status; otherwise replaces spec
// (generation++ when it changed), labels, annotations, finalizers and
// ownerReferences. An incoming nonzero metadata.resourceVersion must
// match the stored one. Returns the stored object.
const char* kftpu_store_update(void* s, const char* obj_json,
                               int32_t status_only);

// List as a JSON array, sorted by (kind, ns, name). ns=NULL or "" lists
// all namespaces. selector_json is a {"label": "value", ...} object
// (NULL/empty = no filter); all pairs must match.
const char* kftpu_store_list(void* s, const char* kind, const char* ns,
                             const char* selector_json);

// Delete (finalizer-aware, cascading). Returns KFTPU_STORE_OK or a code.
int32_t kftpu_store_delete(void* s, const char* kind, const char* ns,
                           const char* name);

// Watch journal: JSON array [{"seq": N, "type": "ADDED", "object": {...}},
// ...] of events with seq > cursor; *new_cursor is set to the last seq
// returned (or cursor when none).
const char* kftpu_store_events(void* s, int64_t cursor,
                               int64_t* new_cursor);

// Drop journal entries with seq <= cursor (consumed by all pollers).
void kftpu_store_trim(void* s, int64_t cursor);

// Object count (all kinds).
int64_t kftpu_store_len(void* s);

// Thread-local status/message for the calling thread's last store call.
int32_t kftpu_store_status();
const char* kftpu_store_error();

}  // extern "C"
