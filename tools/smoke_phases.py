#!/usr/bin/env python3
"""Runs one checkout's chip_smoke.py and times its phases, for A/B runs.

    python3 tools/smoke_phases.py ROOT LOG

runs ``python3 chip_smoke.py`` from the checkout at ROOT, stamps every
line it prints with the seconds since its start as the line arrives,
writes the stamped lines (standard error's marked ``E``) to the file
LOG, and prints one JSON line: the exit code, the card (nvidia-smi's
name and power limit), the script's own ``done`` seconds, the wall
seconds, and for each phase name the seconds from the JSON line before
its own and how many lines it printed. chip_smoke prints a phase's line
as the phase ends, so that is the phase's time with whatever the script
does between two phases; where a phase prints a second line first (its
``<phase>_tier`` line), that line takes the phase's time. To compare a
change with its parent on one card, unpack both into directories that
.gitignore lists and run them back to back in one command:

    git archive HEAD | tar -x -C archive_check/parent
    git archive $(git write-tree) | tar -x -C archive_check/change
    for r in parent change; do
        python3 tools/smoke_phases.py archive_check/$r $r.phases.log
    done

Needs a CUDA device (chip_smoke.py exits 1 without one).
"""

import json
import os
import subprocess
import sys
import threading
import time


def main(root: str, log_path: str) -> int:
    root = os.path.abspath(root)
    log_path = os.path.abspath(log_path)
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    lines: list[tuple[float, str, str]] = []
    lock = threading.Lock()
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def pump(stream, mark: str) -> None:
        for line in stream:
            with lock:
                lines.append((time.perf_counter() - t0, mark, line.rstrip("\n")))

    readers = [threading.Thread(target=pump, args=(proc.stdout, "O")),
               threading.Thread(target=pump, args=(proc.stderr, "E"))]
    for reader in readers:
        reader.start()
    rc = proc.wait()
    for reader in readers:
        reader.join()
    wall = time.perf_counter() - t0

    phases: dict[str, dict] = {}
    card, done, last = None, None, 0.0
    with open(log_path, "w") as log:
        for at, mark, line in lines:
            log.write(f"{at:9.3f} {mark} {line}\n")
            if mark != "O":
                continue
            if line.startswith("NVIDIA") or line.startswith("Tesla"):
                card = line
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            name = rec.get("phase") if isinstance(rec, dict) else None
            if name is None:
                continue
            row = phases.setdefault(name, {"seconds": 0.0, "lines": 0})
            row["seconds"] += at - last
            row["lines"] += 1
            last = at
            if name == "done":
                done = rec.get("seconds")
            if name == "device":
                card = rec.get("nvidia_smi", card)
    print(json.dumps({"root": root, "rc": rc, "card": card, "done_s": done,
                      "wall_s": wall, "log": log_path,
                      "phases": {k: {"seconds": v["seconds"], "lines": v["lines"]}
                                 for k, v in phases.items()}}), flush=True)
    return rc


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(*sys.argv[1:]))
