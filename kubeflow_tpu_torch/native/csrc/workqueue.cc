#include "workqueue.h"

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstring>
#include <map>
#include <mutex>
#include <queue>
#include <set>
#include <string>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;
using Ms = std::chrono::milliseconds;

struct Entry {
  Clock::time_point ready;
  uint64_t seq;  // FIFO tiebreak among equally-ready keys
  std::string key;
  bool operator>(const Entry& o) const {
    return ready != o.ready ? ready > o.ready : seq > o.seq;
  }
};

class WorkQueue {
 public:
  WorkQueue(int64_t base_ms, int64_t max_ms)
      : base_(Ms(base_ms)), max_(Ms(max_ms)) {}

  void Add(const std::string& key, Ms delay) {
    std::lock_guard<std::mutex> lock(mu_);
    if (down_) return;
    if (inflight_.count(key)) {
      dirty_.insert(key);  // re-queue on Done()
      return;
    }
    Clock::time_point ready = Clock::now() + delay;
    auto it = queued_.find(key);
    if (it != queued_.end() && it->second <= ready) return;  // sooner wins
    queued_[key] = ready;
    heap_.push(Entry{ready, seq_++, key});
    cv_.notify_all();
  }

  // 1 = got key, 0 = timeout/shutdown, -2 = buffer too small.
  int32_t Get(char* out, int32_t out_len, Ms timeout) {
    std::unique_lock<std::mutex> lock(mu_);
    Clock::time_point deadline = Clock::now() + timeout;
    while (true) {
      if (down_) return 0;
      PruneStale();
      if (!heap_.empty()) {
        const Entry& top = heap_.top();
        Clock::time_point now = Clock::now();
        if (top.ready <= now) {
          if (static_cast<int32_t>(top.key.size()) + 1 > out_len) return -2;
          std::string key = top.key;
          heap_.pop();
          queued_.erase(key);
          inflight_.insert(key);
          std::memcpy(out, key.c_str(), key.size() + 1);
          return 1;
        }
        // Sleep until the earliest entry matures or the deadline.
        Clock::time_point until = std::min(top.ready, deadline);
        if (until <= now) return 0;
        cv_.wait_until(lock, until);
      } else {
        if (timeout.count() == 0 || Clock::now() >= deadline) return 0;
        cv_.wait_until(lock, deadline);
      }
    }
  }

  void Done(const std::string& key) {
    std::lock_guard<std::mutex> lock(mu_);
    inflight_.erase(key);
    if (dirty_.erase(key) && !down_) {
      Clock::time_point ready = Clock::now();
      auto it = queued_.find(key);
      if (it == queued_.end() || it->second > ready) {
        queued_[key] = ready;
        heap_.push(Entry{ready, seq_++, key});
        cv_.notify_all();
      }
    }
  }

  int64_t RequeueError(const std::string& key) {
    Ms backoff;
    {
      std::lock_guard<std::mutex> lock(mu_);
      int n = ++failures_[key];
      int shift = std::min(n - 1, 30);
      auto raw = base_.count() << shift;
      backoff = Ms(std::min<int64_t>(raw, max_.count()));
    }
    // Schedule the retry; bypass the in-flight dirty path so the backoff
    // applies even though the key is currently being processed: record it
    // as queued directly.
    std::lock_guard<std::mutex> lock(mu_);
    if (down_) return backoff.count();
    Clock::time_point ready = Clock::now() + backoff;
    auto it = queued_.find(key);
    if (it == queued_.end() || it->second > ready) {
      queued_[key] = ready;
      heap_.push(Entry{ready, seq_++, key});
      cv_.notify_all();
    }
    dirty_.erase(key);  // the scheduled retry covers any dirty re-add
    return backoff.count();
  }

  void Forget(const std::string& key) {
    std::lock_guard<std::mutex> lock(mu_);
    failures_.erase(key);
  }

  int64_t Len() {
    std::lock_guard<std::mutex> lock(mu_);
    return static_cast<int64_t>(queued_.size());
  }

  int64_t NextReadyMs() {
    std::lock_guard<std::mutex> lock(mu_);
    PruneStale();
    if (heap_.empty()) return -1;
    auto delta = std::chrono::duration_cast<Ms>(heap_.top().ready -
                                                Clock::now())
                     .count();
    return delta < 0 ? 0 : delta;
  }

  void Shutdown() {
    std::lock_guard<std::mutex> lock(mu_);
    down_ = true;
    cv_.notify_all();
  }

 private:
  // Drop heap entries superseded by a sooner re-add (their (key, ready)
  // no longer matches queued_). Caller holds mu_.
  void PruneStale() {
    while (!heap_.empty()) {
      const Entry& top = heap_.top();
      auto it = queued_.find(top.key);
      if (it != queued_.end() && it->second == top.ready) return;
      heap_.pop();
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> heap_;
  std::map<std::string, Clock::time_point> queued_;
  std::set<std::string> inflight_;
  std::set<std::string> dirty_;
  std::map<std::string, int> failures_;
  Ms base_, max_;
  uint64_t seq_ = 0;
  bool down_ = false;
};

}  // namespace

extern "C" {

void* kftpu_wq_new(int64_t base_backoff_ms, int64_t max_backoff_ms) {
  if (base_backoff_ms < 1) base_backoff_ms = 1;
  if (max_backoff_ms < base_backoff_ms) max_backoff_ms = base_backoff_ms;
  return new WorkQueue(base_backoff_ms, max_backoff_ms);
}

void kftpu_wq_free(void* q) { delete static_cast<WorkQueue*>(q); }

void kftpu_wq_add(void* q, const char* key) {
  static_cast<WorkQueue*>(q)->Add(key, Ms(0));
}

void kftpu_wq_add_after(void* q, const char* key, int64_t delay_ms) {
  static_cast<WorkQueue*>(q)->Add(key, Ms(delay_ms < 0 ? 0 : delay_ms));
}

int32_t kftpu_wq_get(void* q, char* out, int32_t out_len,
                     int64_t timeout_ms) {
  return static_cast<WorkQueue*>(q)->Get(out, out_len,
                                         Ms(timeout_ms < 0 ? 0 : timeout_ms));
}

void kftpu_wq_done(void* q, const char* key) {
  static_cast<WorkQueue*>(q)->Done(key);
}

int64_t kftpu_wq_requeue_error(void* q, const char* key) {
  return static_cast<WorkQueue*>(q)->RequeueError(key);
}

void kftpu_wq_forget(void* q, const char* key) {
  static_cast<WorkQueue*>(q)->Forget(key);
}

int64_t kftpu_wq_len(void* q) { return static_cast<WorkQueue*>(q)->Len(); }

int64_t kftpu_wq_next_ready_ms(void* q) {
  return static_cast<WorkQueue*>(q)->NextReadyMs();
}

void kftpu_wq_shutdown(void* q) { static_cast<WorkQueue*>(q)->Shutdown(); }

}  // extern "C"
