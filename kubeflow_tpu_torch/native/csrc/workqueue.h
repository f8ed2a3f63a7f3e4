// Rate-limited delaying workqueue — the reconcile engine's heart.
//
// The reference's controllers all ride client-go's workqueue (a Go
// component; e.g. `notebook_controller.go:82` via controller-runtime).
// This is the platform's compiled equivalent: keyed dedup, delayed adds
// with supersede-by-sooner semantics, per-key exponential error backoff,
// and a blocking Get so worker threads (Python, via ctypes — which
// releases the GIL during the call) park in native code.
//
// C ABI for ctypes consumption. All functions are thread-safe.

#pragma once
#include <cstdint>

extern "C" {

// max_backoff_ms bounds the per-key exponential error backoff;
// base_backoff_ms is the first retry's delay.
void* kftpu_wq_new(int64_t base_backoff_ms, int64_t max_backoff_ms);
void kftpu_wq_free(void* q);

// Enqueue key for immediate processing. A key already queued sooner-or-
// equal is left alone; a later-scheduled pending entry is superseded
// (a fresh watch event must not wait out an old error backoff).
void kftpu_wq_add(void* q, const char* key);

// Enqueue key to become ready after delay_ms (same supersede semantics).
void kftpu_wq_add_after(void* q, const char* key, int64_t delay_ms);

// Block up to timeout_ms for a ready key; copy it into out (out_len incl.
// NUL). Returns:
//   1   a key was dequeued
//   0   timed out (or queue shut down) — out untouched
//  -2   out buffer too small (key left queued)
// timeout_ms == 0 polls without blocking: it returns a key only if one is
// ready now. A dequeued key is "in flight": re-adds while in flight are
// recorded and the key is re-queued when kftpu_wq_done is called (client-go
// dirty-set semantics — no lost wakeups, no concurrent reconciles of one
// key).
int32_t kftpu_wq_get(void* q, char* out, int32_t out_len,
                     int64_t timeout_ms);

// Mark an in-flight key finished; re-queues it if it was re-added while
// processing.
void kftpu_wq_done(void* q, const char* key);

// Record a reconcile failure: bumps the key's failure count and schedules
// a retry after the (exponential, capped) backoff. Returns the backoff ms
// used. Call INSTEAD of a plain add, then kftpu_wq_done.
int64_t kftpu_wq_requeue_error(void* q, const char* key);

// Clear a key's failure count (after a successful reconcile).
void kftpu_wq_forget(void* q, const char* key);

// Number of keys queued (ready or delayed), excluding in-flight.
int64_t kftpu_wq_len(void* q);

// Milliseconds until the earliest queued key becomes ready: 0 if one is
// ready now, -1 if the queue is empty.
int64_t kftpu_wq_next_ready_ms(void* q);

// Wake all blocked Gets (they return 0); subsequent Gets return 0
// immediately. Adds become no-ops.
void kftpu_wq_shutdown(void* q);

}  // extern "C"
