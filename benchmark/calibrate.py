"""Readings for a cell's limits: the program against the reference on many
seeds, and the control against the reference on a few, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control tf32|bf16 --control-seeds 4,5,6] [--out file.json]

For each seed it draws the cell's pool and runs every batch of it once
through the program's served call (upload, entry, outputs to the host),
then through the reference, and prints the numbers the check compares
(``entries/<entry>.py``'s ``compare``), one JSON line a seed.  The control
(the entry's ``control``: the reference in a lower precision, or the
program's own bfloat16 path) is compared with the reference in the same
way.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def outputs(fn, pool, device) -> list[dict]:
    out = []
    with torch.no_grad():
        for x in pool:
            r = fn(x.to(device))
            out.append({k: v.cpu() for k, v in r.items()})
    return out


def readings(cell, seeds, device, control: str | None = None) -> list[dict]:
    rows = []
    program = None if control else cell.entry.Program(cell.config, cell.traffic, device)
    side = (cell.entry.control(cell.config, cell.traffic, device, control) if control
            else program)
    ref = cell.entry.reference(cell.config, cell.traffic, device)
    for seed in seeds:
        t = time.perf_counter()
        pool, sent = cell.generator.make_pool(cell.config, cell.traffic, seed, device)
        got = outputs(side, pool, device)
        want = outputs(ref, pool, device)
        numbers = cell.entry.compare(got, want, sent)
        row = {"seed": seed, "side": control or "program", **numbers,
               "seconds": time.perf_counter() - t}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default=None)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(ROOT, args.workload)
    rows = []
    if args.seeds:
        rows += readings(cell, [int(s) for s in args.seeds.split(",")], dev)
    if args.control:
        rows += readings(cell, [int(s) for s in args.control_seeds.split(",")], dev,
                         args.control)
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps({"workload": args.workload, **row}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
