// Native-tier unit tests (run via ctest).
#include "scheduler.h"

#include <cassert>
#include <cstdio>
#include <cstring>
#include <string>

#define CHECK(cond)                                                    \
  do {                                                                 \
    if (!(cond)) {                                                     \
      std::fprintf(stderr, "FAILED: %s (line %d)\n", #cond, __LINE__); \
      return 1;                                                        \
    }                                                                  \
  } while (0)

int main() {
  void* s = kftpu_sched_new();
  // A v5e-16 pool: 4 hosts in a row, 4 chips each.
  for (int i = 0; i < 4; ++i) {
    std::string name = "host-" + std::to_string(i);
    CHECK(kftpu_sched_add_node(s, name.c_str(), "v5e-4x4", i, 0, 4) == 0);
  }
  CHECK(kftpu_sched_add_node(s, "host-0", "v5e-4x4", 0, 0, 4) == -1);  // dup
  CHECK(kftpu_sched_free_chips(s, "v5e-4x4") == 16);

  char out[512];
  // Full-slice gang: 4 workers x 4 chips; contiguous row => ring cost 3.
  long cost = kftpu_sched_place_gang(s, "job-a", "v5e-4x4", 4, 4, out, 512);
  CHECK(cost == 3);
  CHECK(std::string(out) == "host-0;host-1;host-2;host-3");
  CHECK(kftpu_sched_free_chips(s, "v5e-4x4") == 0);

  // No capacity left: all-or-nothing refusal.
  CHECK(kftpu_sched_place_gang(s, "job-b", "v5e-4x4", 1, 4, out, 512) == -1);
  // Duplicate job id refused.
  CHECK(kftpu_sched_place_gang(s, "job-a", "v5e-4x4", 1, 4, out, 512) == -3);

  // Release frees everything.
  CHECK(kftpu_sched_release_gang(s, "job-a") == 4);
  CHECK(kftpu_sched_free_chips(s, "v5e-4x4") == 16);
  CHECK(kftpu_sched_release_gang(s, "job-a") == -1);

  // Topology preference: with a hole in the middle, placement picks the
  // contiguous pair, not the fragmented one.
  kftpu_sched_place_gang(s, "hole", "v5e-4x4", 1, 4, out, 512);
  // "hole" takes host-0 (first best single). Now 2-worker gang should pick
  // host-1,host-2 or host-2,host-3 (cost 1), never host-1,host-3 (cost 2).
  cost = kftpu_sched_place_gang(s, "pair", "v5e-4x4", 2, 4, out, 512);
  CHECK(cost == 1);

  // Multi-worker per node when chips allow: 2 workers x 2 chips on one
  // remaining 4-chip host => ring cost 0.
  CHECK(kftpu_sched_release_gang(s, "pair") == 2);
  cost = kftpu_sched_place_gang(s, "packed", "v5e-4x4", 2, 2, out, 512);
  CHECK(cost == 0);
  std::string assigned(out);
  CHECK(assigned.find(';') != std::string::npos);

  // Node removal.
  CHECK(kftpu_sched_remove_node(s, "host-3") == 0);
  CHECK(kftpu_sched_remove_node(s, "host-3") == -1);

  kftpu_sched_free(s);

  // --- Torus wraparound (v5e pod slices wrap their ICI links) -------------
  void* t = kftpu_sched_new();
  // A 6-wide ring. Free capacity at the SEAM (x=0 and x=5) plus one
  // off-row host (x=2, y=1).
  CHECK(kftpu_sched_add_node(t, "t0", "6x1", 0, 0, 4) == 0);
  CHECK(kftpu_sched_add_node(t, "t5", "6x1", 5, 0, 4) == 0);
  CHECK(kftpu_sched_add_node(t, "t2b", "6x1", 2, 1, 4) == 0);
  char tout[512];
  // WITHOUT the torus declaration (flat Manhattan) the seam pair costs 5,
  // so placement prefers t5->t2b (3+1=4): the wrong physical choice on
  // wrapped hardware.
  long flat = kftpu_sched_place_gang(t, "flat", "6x1", 2, 4, tout, 512);
  CHECK(flat == 4);
  CHECK(std::string(tout) == "t5;t2b");
  CHECK(kftpu_sched_release_gang(t, "flat") == 2);
  // WITH the torus declared, the seam pair is ONE wrap hop and wins.
  CHECK(kftpu_sched_set_pool_topology(t, "6x1", 6, 1) == 0);
  long wrapped = kftpu_sched_place_gang(t, "wrap", "6x1", 2, 4, tout, 512);
  CHECK(wrapped == 1);
  CHECK(std::string(tout) == "t0;t5");
  CHECK(kftpu_sched_set_pool_topology(t, "6x1", -1, 1) == -1);  // bad args
  kftpu_sched_free(t);

  std::printf("all native scheduler tests passed\n");
  return 0;
}
