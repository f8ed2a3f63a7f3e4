// Topology-aware gang scheduler for TPU slices — the native scheduling
// core of the kubeflow-tpu platform.
//
// The reference's scheduling story was "tf-operator gangs replicas but
// knows no topology" (SURVEY.md §2.2 "Gang scheduling / topology
// awareness: Minimal"); TPU slices make placement a first-class problem:
// a gang must land on ICI-adjacent hosts, all-or-nothing, and consecutive
// ranks should be physical neighbors so ring collectives (ring attention,
// reduce-scatter rings) ride single ICI hops.
//
// C ABI for ctypes consumption from the Python control plane.

#pragma once
#include <cstdint>

extern "C" {

// Opaque scheduler handle. Thread-safe.
void* kftpu_sched_new();
void kftpu_sched_free(void* s);

// Register a host: `pool` groups interchangeable nodes (accelerator type +
// topology), (x, y) are the host's coordinates in the pool's physical
// mesh, `chips` its TPU chip count. Returns 0, or -1 if the name exists.
int32_t kftpu_sched_add_node(void* s, const char* name, const char* pool,
                             int32_t x, int32_t y, int32_t chips);

// Remove a host (e.g. failure detected). Gangs holding it keep their
// reservation records; callers re-place after release. Returns 0 or -1.
int32_t kftpu_sched_remove_node(void* s, const char* name);

// Declare pool `pool`'s physical topology as a WIDTH x HEIGHT 2D TORUS:
// ring cost between hosts then uses wraparound distance per axis
// (min(d, size-d)), the way real v5e pod slices wrap their ICI links.
// A dimension of 0/1 means no wrap on that axis; undeclared pools use
// flat Manhattan distance. Returns 0, or -1 on bad args.
int32_t kftpu_sched_set_pool_topology(void* s, const char* pool,
                                      int32_t width, int32_t height);

// Atomically place a gang of `workers` workers needing `chips_per_worker`
// chips each onto pool `pool`. On success writes a ';'-separated node-name
// list (one entry per worker, rank order) into out (size out_len) and
// reserves capacity. Returns:
//   >=0  total ring cost (sum of Manhattan distances between consecutive
//        ranks — lower is better ICI locality)
//   -1   insufficient capacity (nothing reserved)
//   -2   output buffer too small
//   -3   job already placed / bad args
int64_t kftpu_sched_place_gang(void* s, const char* job, const char* pool,
                               int32_t workers, int32_t chips_per_worker,
                               char* out, int32_t out_len);

// Release a gang's reservation. Returns freed worker count, or -1.
int32_t kftpu_sched_release_gang(void* s, const char* job);

// Directly reserve `chips` on a named node for `job` — used to rebuild
// scheduler state from observed placements (existing pods' nodeName)
// rather than trusting a long-lived in-memory mirror. Returns 0, or -1 if
// the node is unknown.
int32_t kftpu_sched_reserve(void* s, const char* job, const char* node,
                            int32_t chips);

// Free chips in a pool.
int64_t kftpu_sched_free_chips(void* s, const char* pool);

}  // extern "C"
