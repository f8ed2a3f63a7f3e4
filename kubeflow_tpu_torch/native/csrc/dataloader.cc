#include "dataloader.h"

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr char kMagic[4] = {'K', 'F', 'T', 'R'};
constexpr uint32_t kVersion = 1;
constexpr size_t kHeaderBytes = 4 + 4 + 8 + 8;

struct Header {
  uint64_t record_bytes;
  uint64_t record_count;
};

bool WriteHeader(std::FILE* f, const Header& h) {
  if (std::fseek(f, 0, SEEK_SET) != 0) return false;
  if (std::fwrite(kMagic, 1, 4, f) != 4) return false;
  uint32_t version = kVersion;
  if (std::fwrite(&version, sizeof(version), 1, f) != 1) return false;
  if (std::fwrite(&h.record_bytes, sizeof(h.record_bytes), 1, f) != 1)
    return false;
  if (std::fwrite(&h.record_count, sizeof(h.record_count), 1, f) != 1)
    return false;
  return true;
}

bool ReadHeader(std::FILE* f, Header* h) {
  char magic[4];
  uint32_t version;
  if (std::fread(magic, 1, 4, f) != 4) return false;
  if (std::memcmp(magic, kMagic, 4) != 0) return false;
  if (std::fread(&version, sizeof(version), 1, f) != 1) return false;
  if (version != kVersion) return false;
  if (std::fread(&h->record_bytes, sizeof(h->record_bytes), 1, f) != 1)
    return false;
  if (std::fread(&h->record_count, sizeof(h->record_count), 1, f) != 1)
    return false;
  return true;
}

// -- writer -----------------------------------------------------------------

struct Writer {
  std::FILE* f;
  Header header;
};

// -- loader -----------------------------------------------------------------

struct FileSpan {
  std::string path;
  uint64_t first;  // global index of this file's record 0
  uint64_t count;
};

struct Batch {
  std::vector<char> data;
  int64_t records;
};

class Loader {
 public:
  Loader(std::vector<FileSpan> files, Header geom, int64_t batch_size,
         int32_t shard_id, int32_t shards, int64_t shuffle_buffer,
         uint64_t seed, int32_t num_threads, int32_t prefetch,
         bool drop_remainder, int32_t loop_epochs)
      : files_(std::move(files)),
        geom_(geom),
        batch_size_(batch_size),
        shard_id_(shard_id),
        shards_(shards),
        shuffle_buffer_(shuffle_buffer),
        seed_(seed),
        prefetch_(std::max(1, prefetch)),
        drop_remainder_(drop_remainder),
        loop_epochs_(loop_epochs) {
    // The shard's record indices: global round-robin by index, so every
    // process's shard interleaves across files (balanced even when files
    // differ in size).
    for (uint64_t g = shard_id_; g < geom_.record_count;
         g += static_cast<uint64_t>(shards_))
      shard_.push_back(g);
    int n = std::max(1, static_cast<int>(num_threads));
    producer_ = std::thread(&Loader::Produce, this, n);
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
      cv_.notify_all();
    }
    if (producer_.joinable()) producer_.join();
  }

  uint64_t record_bytes() const { return geom_.record_bytes; }
  int64_t shard_records() const {
    return static_cast<int64_t>(shard_.size());
  }
  int64_t batches() const { return batches_.load(); }

  int64_t Next(void* out) {
    std::unique_lock<std::mutex> lock(mu_);
    cv_.wait(lock, [&] { return !queue_.empty() || done_ || failed_; });
    if (failed_) return -1;
    if (queue_.empty()) return 0;  // done_
    Batch b = std::move(queue_.front());
    queue_.pop_front();
    cv_.notify_all();
    lock.unlock();
    std::memcpy(out, b.data.data(), b.data.size());
    batches_.fetch_add(1);
    return b.records;
  }

 private:
  // One producer thread orchestrates epochs; it fans record reads out to
  // a per-epoch worker pool (files are read with pread-style seeks, so
  // workers share no file state).
  void Produce(int num_threads) {
    std::mt19937_64 rng(seed_);
    for (int epoch = 0; loop_epochs_ == 0 || epoch < loop_epochs_;
         ++epoch) {
      std::vector<uint64_t> order = shard_;
      if (shuffle_buffer_ > 0) {
        // Buffered shuffle (tf.data semantics): windowed, so huge shards
        // never need a full permutation in memory — but for shards that
        // fit (the common case here) a buffer >= shard is a full shuffle.
        std::mt19937_64 erng(seed_ + epoch + 1);
        size_t buf = std::min<size_t>(shuffle_buffer_, order.size());
        for (size_t i = 0; i < order.size(); ++i) {
          size_t j = i + erng() % std::min(buf, order.size() - i);
          std::swap(order[i], order[j]);
        }
      }
      if (!EmitEpoch(order, num_threads)) return;
    }
    std::lock_guard<std::mutex> lock(mu_);
    done_ = true;
    cv_.notify_all();
  }

  bool EmitEpoch(const std::vector<uint64_t>& order, int num_threads) {
    for (size_t off = 0; off < order.size();
         off += static_cast<size_t>(batch_size_)) {
      size_t n = std::min<size_t>(batch_size_, order.size() - off);
      if (n < static_cast<size_t>(batch_size_) && drop_remainder_) break;
      Batch b;
      b.records = static_cast<int64_t>(n);
      b.data.resize(n * geom_.record_bytes);
      std::atomic<bool> ok{true};
      std::atomic<size_t> next{0};
      auto read_some = [&] {
        size_t i;
        while ((i = next.fetch_add(1)) < n) {
          if (!ReadRecord(order[off + i],
                          b.data.data() + i * geom_.record_bytes))
            ok = false;
        }
      };
      if (n > 1 && num_threads > 1) {
        std::vector<std::thread> pool;
        for (int t = 1; t < num_threads; ++t)
          pool.emplace_back(read_some);
        read_some();
        for (auto& t : pool) t.join();
      } else {
        read_some();
      }
      std::unique_lock<std::mutex> lock(mu_);
      if (!ok) {
        failed_ = true;
        cv_.notify_all();
        return false;
      }
      cv_.wait(lock, [&] {
        return stop_ || queue_.size() < static_cast<size_t>(prefetch_);
      });
      if (stop_) return false;
      queue_.push_back(std::move(b));
      cv_.notify_all();
    }
    return true;
  }

  bool ReadRecord(uint64_t global_index, char* dst) {
    // Locate the file holding this global index.
    const FileSpan* span = nullptr;
    for (const FileSpan& fs : files_)
      if (global_index >= fs.first && global_index < fs.first + fs.count) {
        span = &fs;
        break;
      }
    if (!span) return false;
    std::FILE* f = std::fopen(span->path.c_str(), "rb");
    if (!f) return false;
    uint64_t local = global_index - span->first;
    bool ok =
        std::fseek(f,
                   static_cast<long>(kHeaderBytes +
                                     local * geom_.record_bytes),
                   SEEK_SET) == 0 &&
        std::fread(dst, 1, geom_.record_bytes, f) == geom_.record_bytes;
    std::fclose(f);
    return ok;
  }

  std::vector<FileSpan> files_;
  Header geom_;
  int64_t batch_size_;
  int32_t shard_id_, shards_;
  int64_t shuffle_buffer_;
  uint64_t seed_;
  int32_t prefetch_;
  bool drop_remainder_;
  int32_t loop_epochs_;

  std::vector<uint64_t> shard_;
  std::deque<Batch> queue_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::thread producer_;
  bool stop_ = false;
  bool done_ = false;
  bool failed_ = false;
  std::atomic<int64_t> batches_{0};
};

std::vector<std::string> Split(const std::string& s, char sep) {
  std::vector<std::string> out;
  size_t start = 0;
  while (start <= s.size()) {
    size_t end = s.find(sep, start);
    if (end == std::string::npos) end = s.size();
    if (end > start) out.push_back(s.substr(start, end - start));
    start = end + 1;
  }
  return out;
}

}  // namespace

extern "C" {

void* kftpu_recwriter_open(const char* path, uint64_t record_bytes) {
  if (!path || record_bytes == 0) return nullptr;
  std::FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer{f, {record_bytes, 0}};
  if (!WriteHeader(f, w->header)) {  // placeholder; rewritten on close
    std::fclose(f);
    delete w;
    return nullptr;
  }
  return w;
}

int32_t kftpu_recwriter_append(void* wp, const void* data) {
  auto* w = static_cast<Writer*>(wp);
  if (std::fwrite(data, 1, w->header.record_bytes, w->f) !=
      w->header.record_bytes)
    return -1;
  w->header.record_count++;
  return 0;
}

int64_t kftpu_recwriter_close(void* wp) {
  auto* w = static_cast<Writer*>(wp);
  int64_t count = static_cast<int64_t>(w->header.record_count);
  bool ok = WriteHeader(w->f, w->header);
  ok = (std::fclose(w->f) == 0) && ok;
  delete w;
  return ok ? count : -1;
}

int32_t kftpu_recfile_stat(const char* path, uint64_t* record_bytes,
                           uint64_t* record_count) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  Header h;
  bool ok = ReadHeader(f, &h);
  std::fclose(f);
  if (!ok) return -1;
  if (record_bytes) *record_bytes = h.record_bytes;
  if (record_count) *record_count = h.record_count;
  return 0;
}

void* kftpu_loader_new(const char* paths, int64_t batch_size,
                       int32_t shard_id, int32_t shards,
                       int64_t shuffle_buffer, uint64_t seed,
                       int32_t num_threads, int32_t prefetch,
                       int32_t drop_remainder, int32_t loop_epochs) {
  if (!paths || batch_size < 1 || shards < 1 || shard_id < 0 ||
      shard_id >= shards || loop_epochs < 0)
    return nullptr;
  std::vector<FileSpan> files;
  Header geom{0, 0};
  for (const std::string& path : Split(paths, ';')) {
    std::FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) return nullptr;
    Header h;
    bool ok = ReadHeader(f, &h);
    std::fclose(f);
    if (!ok) return nullptr;
    if (geom.record_bytes == 0) geom.record_bytes = h.record_bytes;
    if (h.record_bytes != geom.record_bytes) return nullptr;
    files.push_back(FileSpan{path, geom.record_count, h.record_count});
    geom.record_count += h.record_count;
  }
  if (files.empty() || geom.record_count == 0) return nullptr;
  return new Loader(std::move(files), geom, batch_size, shard_id, shards,
                    shuffle_buffer, seed, num_threads, prefetch,
                    drop_remainder != 0, loop_epochs);
}

void kftpu_loader_free(void* l) { delete static_cast<Loader*>(l); }

uint64_t kftpu_loader_record_bytes(void* l) {
  return static_cast<Loader*>(l)->record_bytes();
}

int64_t kftpu_loader_shard_records(void* l) {
  return static_cast<Loader*>(l)->shard_records();
}

int64_t kftpu_loader_next(void* l, void* out) {
  return static_cast<Loader*>(l)->Next(out);
}

int64_t kftpu_loader_batches(void* l) {
  return static_cast<Loader*>(l)->batches();
}

}  // extern "C"
