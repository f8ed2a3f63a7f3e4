#!/usr/bin/env python3
"""How far the RL learner's trained policy beats its fresh init, on the CPU.

    python3 tools/rl_margin.py [--seeds 5]

Runs chip_smoke.py's coupled actor–learner loop (`rl_coupled`: the
bench's phase-A configuration, `rl_config`) with the learner and the
policy fleet on the CPU, once for each seed 0..N-1 (the env and the
policy's init drawn from it), and prints one JSON line per seed and a
last one with the smallest gap: the mean return of the last 20
trajectories, the fresh init's mean return on the same trajectory
indices, and their difference. chip_smoke's `RL["margin"]` is set below
the smallest gap read here. Needs no GPU; a few seconds a seed.
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, default=5)
    args = parser.parse_args()
    chip_smoke.DEVICE = "cpu"
    gaps = []
    for seed in range(args.seeds):
        with tempfile.TemporaryDirectory(prefix="kftpu_rl_margin_") as root:
            run = chip_smoke.rl_coupled(torch, chip_smoke.rl_config(seed), root, "cpu",
                                        [], seed)
        chip_smoke.rl_close(run["api"], run["router"])
        result = run["result"]
        gap = run["mean_return_last"] - run["fresh_return"]
        gaps.append(gap)
        print(json.dumps({
            "seed": seed, "mean_return_last": run["mean_return_last"],
            "fresh_return": run["fresh_return"], "gap": gap,
            "publishes": [p.version for p in result.publishes],
            "trajectories": result.trajectories, "stale_dropped": result.stale_dropped,
        }), flush=True)
    print(json.dumps({"seeds": args.seeds, "min_gap": min(gaps), "gaps": gaps,
                      "margin": chip_smoke.RL["margin"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
