#include "scheduler.h"

#include <algorithm>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace {

struct Node {
  std::string name;
  std::string pool;
  int32_t x = 0;
  int32_t y = 0;
  int32_t chips = 0;
  int32_t reserved = 0;  // chips currently reserved by gangs
};

struct Scheduler {
  std::mutex mu;
  std::map<std::string, Node> nodes;
  // job -> (node name, chips) reservations, one entry per worker.
  std::map<std::string, std::vector<std::pair<std::string, int32_t>>> gangs;
  // pool -> (width, height) torus dims; absent/0 = flat on that axis.
  std::map<std::string, std::pair<int32_t, int32_t>> pool_topo;
};

// Per-axis hop count: wraparound when the pool declared a torus dim
// (real v5e pod slices wrap their ICI links — a ring crossing the seam
// is ONE hop, not width-1). Coordinates are reduced mod size so an
// out-of-range x still lands on the torus instead of going negative.
int64_t AxisDist(int64_t d, int32_t size) {
  d = std::abs(d);
  if (size > 1) {
    d %= size;
    return std::min(d, (int64_t)size - d);
  }
  return d;
}

int64_t Dist(const Scheduler& s, const Node& a, const Node& b) {
  int32_t w = 0, h = 0;
  auto it = s.pool_topo.find(a.pool);
  if (it != s.pool_topo.end()) {
    w = it->second.first;
    h = it->second.second;
  }
  return AxisDist((int64_t)a.x - b.x, w) + AxisDist((int64_t)a.y - b.y, h);
}

// A placement slot: a (node, worker capacity) pair expanded per worker.
struct Slot {
  const Node* node;
};

}  // namespace

extern "C" {

void* kftpu_sched_new() { return new Scheduler(); }

void kftpu_sched_free(void* s) { delete static_cast<Scheduler*>(s); }

int32_t kftpu_sched_add_node(void* sp, const char* name, const char* pool,
                             int32_t x, int32_t y, int32_t chips) {
  if (!sp || !name || !pool || chips < 0) return -1;
  auto* s = static_cast<Scheduler*>(sp);
  std::lock_guard<std::mutex> lock(s->mu);
  auto [it, inserted] = s->nodes.emplace(name, Node{name, pool, x, y, chips, 0});
  (void)it;
  return inserted ? 0 : -1;
}

int32_t kftpu_sched_remove_node(void* sp, const char* name) {
  if (!sp || !name) return -1;
  auto* s = static_cast<Scheduler*>(sp);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->nodes.erase(name) ? 0 : -1;
}

int32_t kftpu_sched_set_pool_topology(void* sp, const char* pool,
                                      int32_t width, int32_t height) {
  if (!sp || !pool || width < 0 || height < 0) return -1;
  auto* s = static_cast<Scheduler*>(sp);
  std::lock_guard<std::mutex> lock(s->mu);
  s->pool_topo[pool] = {width, height};
  return 0;
}

int64_t kftpu_sched_place_gang(void* sp, const char* job, const char* pool,
                               int32_t workers, int32_t chips_per_worker,
                               char* out, int32_t out_len) {
  if (!sp || !job || !pool || workers <= 0 || chips_per_worker < 0 || !out)
    return -3;
  auto* s = static_cast<Scheduler*>(sp);
  std::lock_guard<std::mutex> lock(s->mu);
  if (s->gangs.count(job)) return -3;

  // Free slots in the pool in serpentine (boustrophedon) order: row-major
  // but with odd rows reversed, so the end of each row is physically
  // adjacent to the start of the next — consecutive ranks stay one ICI
  // hop apart even across row boundaries.
  std::vector<const Node*> pool_nodes;
  for (auto& [_, n] : s->nodes)
    if (n.pool == pool) pool_nodes.push_back(&n);
  std::sort(pool_nodes.begin(), pool_nodes.end(),
            [](const Node* a, const Node* b) {
              if (a->y != b->y) return a->y < b->y;
              const bool reversed = (a->y & 1) != 0;
              if (a->x != b->x) return reversed ? a->x > b->x : a->x < b->x;
              return a->name < b->name;
            });

  std::vector<Slot> slots;
  for (const Node* n : pool_nodes) {
    int32_t cap = chips_per_worker == 0
                      ? (n->chips >= n->reserved ? workers : 0)  // cpu-only
                      : (n->chips - n->reserved) / chips_per_worker;
    for (int32_t i = 0; i < cap && (int32_t)slots.size() < workers * 2 + 1024;
         ++i)
      slots.push_back(Slot{n});
  }
  if ((int32_t)slots.size() < workers) return -1;

  // Best window: minimize the ring cost — the sum of Manhattan distances
  // between consecutive ranks. Consecutive ranks exchange the most data
  // (ring collectives), so they should be physical neighbors.
  int64_t best_cost = -1;
  size_t best_start = 0;
  for (size_t start = 0; start + workers <= slots.size(); ++start) {
    int64_t cost = 0;
    for (int32_t i = 1; i < workers; ++i)
      cost += Dist(*s, *slots[start + i - 1].node, *slots[start + i].node);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best_start = start;
    }
  }

  // Serialize assignment and reserve atomically.
  std::string result;
  for (int32_t i = 0; i < workers; ++i) {
    if (i) result += ';';
    result += slots[best_start + i].node->name;
  }
  if ((int32_t)result.size() + 1 > out_len) return -2;

  auto& gang = s->gangs[job];
  for (int32_t i = 0; i < workers; ++i) {
    // const_cast is safe: slots reference nodes owned by s->nodes.
    auto* n = const_cast<Node*>(slots[best_start + i].node);
    n->reserved += chips_per_worker;
    gang.emplace_back(n->name, chips_per_worker);
  }
  std::memcpy(out, result.c_str(), result.size() + 1);
  return best_cost;
}

int32_t kftpu_sched_reserve(void* sp, const char* job, const char* node,
                            int32_t chips) {
  if (!sp || !job || !node || chips < 0) return -1;
  auto* s = static_cast<Scheduler*>(sp);
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->nodes.find(node);
  if (it == s->nodes.end()) return -1;
  it->second.reserved += chips;
  s->gangs[job].emplace_back(node, chips);
  return 0;
}

int32_t kftpu_sched_release_gang(void* sp, const char* job) {
  if (!sp || !job) return -1;
  auto* s = static_cast<Scheduler*>(sp);
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->gangs.find(job);
  if (it == s->gangs.end()) return -1;
  for (auto& [node_name, chips] : it->second) {
    auto nit = s->nodes.find(node_name);
    if (nit != s->nodes.end()) nit->second.reserved -= chips;
  }
  int32_t n = (int32_t)it->second.size();
  s->gangs.erase(it);
  return n;
}

int64_t kftpu_sched_free_chips(void* sp, const char* pool) {
  if (!sp || !pool) return -1;
  auto* s = static_cast<Scheduler*>(sp);
  std::lock_guard<std::mutex> lock(s->mu);
  int64_t total = 0;
  for (auto& [_, n] : s->nodes)
    if (n.pool == pool) total += std::max(0, n.chips - n.reserved);
  return total;
}

}  // extern "C"
