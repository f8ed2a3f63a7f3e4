#include "wal.h"

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

#include <cerrno>
#include <cstring>
#include <mutex>
#include <string>

namespace {

thread_local std::string tls_error;
thread_local std::string tls_result;

const char* Ok(std::string result) {
  tls_error.clear();
  tls_result = std::move(result);
  return tls_result.c_str();
}

int32_t IoErr(const std::string& what) {
  tls_error = what + ": " + std::strerror(errno);
  return -1;
}

// write(2) until done (short writes are legal on regular files under
// signal interruption; loop rather than corrupt a record).
bool WriteAll(int fd, const char* data, size_t len) {
  while (len > 0) {
    ssize_t n = ::write(fd, data, len);
    if (n < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    data += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

bool ReadFile(const std::string& path, std::string* out) {
  out->clear();
  int fd = ::open(path.c_str(), O_RDONLY);
  if (fd < 0) return errno == ENOENT;  // absent = empty, not an error
  char buf[1 << 16];
  for (;;) {
    ssize_t n = ::read(fd, buf, sizeof(buf));
    if (n < 0) {
      if (errno == EINTR) continue;
      ::close(fd);
      return false;
    }
    if (n == 0) break;
    out->append(buf, static_cast<size_t>(n));
  }
  ::close(fd);
  return true;
}

class Wal {
 public:
  explicit Wal(std::string dir) : dir_(std::move(dir)) {}

  ~Wal() {
    if (wal_fd_ >= 0) ::close(wal_fd_);
    if (dir_fd_ >= 0) ::close(dir_fd_);
  }

  bool Open() {
    if (::mkdir(dir_.c_str(), 0700) != 0 && errno != EEXIST) {
      IoErr("mkdir " + dir_);
      return false;
    }
    dir_fd_ = ::open(dir_.c_str(), O_RDONLY | O_DIRECTORY);
    if (dir_fd_ < 0) {
      IoErr("open dir " + dir_);
      return false;
    }
    wal_fd_ = ::open(WalPath().c_str(), O_WRONLY | O_APPEND | O_CREAT, 0600);
    if (wal_fd_ < 0) {
      IoErr("open " + WalPath());
      return false;
    }
    // Make the wal.log DIRENT durable now: fdatasync on appends makes
    // the file's data durable, but a file created and never dir-fsynced
    // can vanish wholesale on crash — losing every acked pre-snapshot
    // write at once.
    if (::fsync(dir_fd_) != 0) {
      IoErr("fsync dir " + dir_);
      return false;
    }
    return true;
  }

  int32_t Append(const char* line) {
    std::lock_guard<std::mutex> lock(mu_);
    std::string rec = line ? line : "";
    rec.push_back('\n');
    if (!WriteAll(wal_fd_, rec.data(), rec.size()))
      return IoErr("append " + WalPath());
    if (::fdatasync(wal_fd_) != 0) return IoErr("fdatasync " + WalPath());
    return 0;
  }

  int32_t Snapshot(const char* snapshot_json) {
    std::lock_guard<std::mutex> lock(mu_);
    const std::string tmp = dir_ + "/snapshot.json.tmp";
    int fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0600);
    if (fd < 0) return IoErr("open " + tmp);
    const char* data = snapshot_json ? snapshot_json : "";
    if (!WriteAll(fd, data, std::strlen(data))) {
      ::close(fd);
      return IoErr("write " + tmp);
    }
    if (::fsync(fd) != 0) {
      ::close(fd);
      return IoErr("fsync " + tmp);
    }
    ::close(fd);
    if (::rename(tmp.c_str(), SnapPath().c_str()) != 0)
      return IoErr("rename " + tmp);
    if (::fsync(dir_fd_) != 0) return IoErr("fsync dir " + dir_);
    // Snapshot is durable; now the WAL may shrink. A crash before this
    // point leaves pre-snapshot records in the WAL — harmless, the
    // reader skips records at-or-below the snapshot rv.
    //
    // The truncate is by replacement: a fresh wal.log.tmp, fsync'd and
    // renamed over wal.log, so the live log moves to a new inode. A
    // deposed process still holding the old fd (an active-passive
    // takeover's predecessor) then appends into an orphan that no
    // restart replays; an O_TRUNC of the same path would leave that fd
    // on the live log. A crash between the two renames leaves the old
    // pre-snapshot records in place, which the reader skips by rv.
    const std::string wal_tmp = WalPath() + ".tmp";
    int fresh = ::open(wal_tmp.c_str(),
                       O_WRONLY | O_APPEND | O_CREAT | O_TRUNC, 0600);
    if (fresh < 0) return IoErr("open " + wal_tmp);
    if (::fsync(fresh) != 0) {
      ::close(fresh);
      return IoErr("fsync " + wal_tmp);
    }
    if (::rename(wal_tmp.c_str(), WalPath().c_str()) != 0) {
      ::close(fresh);
      return IoErr("rename " + wal_tmp);
    }
    if (::fsync(dir_fd_) != 0) {
      ::close(fresh);
      return IoErr("fsync dir " + dir_);
    }
    ::close(wal_fd_);
    wal_fd_ = fresh;
    return 0;
  }

  const char* ReadSnapshot() {
    std::lock_guard<std::mutex> lock(mu_);
    std::string out;
    if (!ReadFile(SnapPath(), &out)) {
      IoErr("read " + SnapPath());
      return nullptr;
    }
    return Ok(std::move(out));
  }

  const char* ReadJournal() {
    std::lock_guard<std::mutex> lock(mu_);
    std::string out;
    if (!ReadFile(WalPath(), &out)) {
      IoErr("read " + WalPath());
      return nullptr;
    }
    return Ok(std::move(out));
  }

 private:
  std::string WalPath() const { return dir_ + "/wal.log"; }
  std::string SnapPath() const { return dir_ + "/snapshot.json"; }

  std::string dir_;
  std::mutex mu_;
  int wal_fd_ = -1;
  int dir_fd_ = -1;
};

}  // namespace

extern "C" {

void* kftpu_wal_open(const char* dir) {
  auto* w = new Wal(dir ? dir : "");
  if (!w->Open()) {
    delete w;
    return nullptr;
  }
  return w;
}

void kftpu_wal_free(void* w) { delete static_cast<Wal*>(w); }

int32_t kftpu_wal_append(void* w, const char* line) {
  return static_cast<Wal*>(w)->Append(line);
}

int32_t kftpu_wal_snapshot(void* w, const char* snapshot_json) {
  return static_cast<Wal*>(w)->Snapshot(snapshot_json);
}

const char* kftpu_wal_read_snapshot(void* w) {
  return static_cast<Wal*>(w)->ReadSnapshot();
}

const char* kftpu_wal_read_journal(void* w) {
  return static_cast<Wal*>(w)->ReadJournal();
}

const char* kftpu_wal_error() { return tls_error.c_str(); }

}  // extern "C"
