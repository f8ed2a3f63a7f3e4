// Native input pipeline: record files + a multithreaded prefetching
// loader (the port's own copy of the JAX package's record loader, the
// same file format and the same batch sequence).
//
// A compiled loader reads fixed-size records off disk with a thread
// pool, shuffles with a seeded buffer, assembles batches into
// caller-owned memory (numpy arrays, or pinned host buffers bound for
// the GPU), and prefetches ahead of the training step so host IO
// overlaps device compute. Sharding is first-class: process p of n
// reads only its records, matching the TpuJob gang contract
// (TPUJOB_PROCESS_ID / TPUJOB_NUM_PROCESSES).
//
// File format ("KFTR"): a 24-byte header
//     magic "KFTR" | u32 version | u64 record_bytes | u64 record_count
// followed by record_count raw records of record_bytes each. Fixed-size
// records keep shapes static and make random access O(1) without an
// index.
//
// C ABI for ctypes. Thread-safe per handle.

#pragma once
#include <cstdint>

extern "C" {

// -- writing ----------------------------------------------------------------

// Create a record file (truncates). Returns a handle or NULL.
void* kftpu_recwriter_open(const char* path, uint64_t record_bytes);
// Append one record (must be record_bytes long). Returns 0 or -1.
int32_t kftpu_recwriter_append(void* w, const void* data);
// Finalize header and close. Returns record count written, or -1.
int64_t kftpu_recwriter_close(void* w);

// -- inspection -------------------------------------------------------------

// Read a file's header: fills record_bytes/record_count. 0 or -1.
int32_t kftpu_recfile_stat(const char* path, uint64_t* record_bytes,
                           uint64_t* record_count);

// -- loading ----------------------------------------------------------------

// Build a loader over ';'-separated record files (same record_bytes).
//   batch_size      records per batch
//   shard_id/shards shard the record space (round-robin by global index)
//   shuffle_buffer  >0 enables seeded buffered shuffle of that size
//   seed            shuffle seed (per-epoch reseeded as seed+epoch)
//   num_threads     reader threads
//   prefetch        max assembled batches queued ahead
//   drop_remainder  1: only full batches; 0: final short batch allowed
//                   (its record count is returned by next())
//   loop_epochs     0: iterate forever; N>0: stop after N epochs
// Returns handle or NULL (bad args/unreadable file).
void* kftpu_loader_new(const char* paths, int64_t batch_size,
                       int32_t shard_id, int32_t shards,
                       int64_t shuffle_buffer, uint64_t seed,
                       int32_t num_threads, int32_t prefetch,
                       int32_t drop_remainder, int32_t loop_epochs);
void kftpu_loader_free(void* l);

// Loader geometry.
uint64_t kftpu_loader_record_bytes(void* l);
// Records in this loader's shard per epoch.
int64_t kftpu_loader_shard_records(void* l);

// Copy the next batch into out (capacity batch_size*record_bytes).
// Returns the number of records delivered (>0), 0 at end of data
// (loop_epochs exhausted), or -1 on IO error. Blocks while the pipeline
// fills (GIL is released by ctypes).
int64_t kftpu_loader_next(void* l, void* out);

// Batches delivered so far (monitoring).
int64_t kftpu_loader_batches(void* l);

}  // extern "C"
