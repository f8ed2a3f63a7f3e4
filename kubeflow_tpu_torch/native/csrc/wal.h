// Durable write-ahead log + snapshot for the control-plane store.
//
// The reference control plane rides etcd for durability (its envtest
// fixture spins a real etcd+apiserver even for unit tests,
// `profile-controller/controllers/suite_test.go:29-54`); this module is
// the compiled persistence tier our apiserver stores through instead:
//
//   <dir>/snapshot.json   full state, written atomically (tmp+rename)
//   <dir>/wal.log         one JSON record per committed write, fsync'd
//
// Crash-safety contract:
//   - append() returns only after the record is fdatasync'd.
//   - snapshot() writes tmp, fsyncs, renames over snapshot.json, fsyncs
//     the directory, and only THEN truncates the WAL, by replacement: a
//     fresh wal.log.tmp is fsync'd, renamed over wal.log and the
//     directory fsync'd before the fd is swapped, so the log moves to a
//     new inode and a deposed process's old fd appends into an orphan.
//     A crash between rename and truncate leaves pre-snapshot records in
//     the WAL; the reader must skip records at-or-below the snapshot's
//     rv (records carry their rv for exactly this reason).
//   - a torn final record (crash mid-append) is the reader's problem:
//     stop replay at the first undecodable line.
//
// C ABI for ctypes. Calls returning const char* use the store result
// convention (thread-local buffer, valid until the same thread's next
// wal call; NULL = error, message via kftpu_wal_error).

#pragma once
#include <cstdint>

extern "C" {

// Opens (creating if needed) the log directory. NULL on error.
void* kftpu_wal_open(const char* dir);
void kftpu_wal_free(void* w);

// Append one record line (no trailing newline needed) and fdatasync.
// Returns 0 on success, -1 on IO error.
int32_t kftpu_wal_append(void* w, const char* line);

// Atomically replace the snapshot with `snapshot_json`, then truncate
// the WAL by replacement (a new inode). Returns 0 on success, -1 on IO
// error.
int32_t kftpu_wal_snapshot(void* w, const char* snapshot_json);

// Full contents of snapshot.json ("" when none exists yet).
const char* kftpu_wal_read_snapshot(void* w);

// Full contents of wal.log ("" when empty/absent), newline-separated.
const char* kftpu_wal_read_journal(void* w);

// Message for the calling thread's last failed wal call.
const char* kftpu_wal_error();

}  // extern "C"
