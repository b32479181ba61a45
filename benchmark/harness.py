"""One run of one cell: set-up, the timed window, the traced calls and the check.

The cell is found by name, from files alone:

- ``workloads/<cell>.json``: its configuration, its traffic and the limit of
  each number that the check compares;
- ``configs/<config>.json``: the deployment (waveform, code, window);
- ``traffic/<traffic>.json``: the mix (channels or codewords a call, the
  pool of distinct batches, SNR, leads), naming its generator
  (``generators/<generator>.py``) and the entry it drives
  (``entries/<entry>.py``);
- ``BENCHMARK.json``'s ``end_to_end`` and ``per_layer`` lists: the metrics
  the cell reports, each read by ``metrics/<name>.py``: an end-to-end
  metric from the window, a per-layer one from the traced run (its traced
  calls, and its window's latencies).

The served path is a closed loop with one call outstanding, a gateway's RX
loop handing frames to the host: each call copies its batch from pinned
host memory to the card, runs the entry and copies the outputs back into
pinned host memory, then synchronises.  Set-up draws the pool from
``--seed`` and warms every shape of the cell; the window then cycles
through the pool for ``--seconds``.  Once the window has closed and the
device's peak memory has been read, the program is freed and the plain
reference (``reference/``) judges a sample of the calls drawn from the
seed: the first call on each batch of the pool and a reservoir of
:data:`KEEP` more, and holds them to what the generator sent as well.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

import torch

from benchmark import tracing

KEEP = 48                  # calls of the window kept for the check, besides each batch's first
WARM_ROUNDS = 2            # set-up calls on each batch of the pool
FORBIDDEN = ("jax", "jaxlib", "flax", "ria_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """The module in ``path`` (a name may hold dots, so it is loaded by file)."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_file_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A cell as its files give it."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    generator: ModuleType
    entry: ModuleType
    chips: int
    readers: dict = field(default_factory=dict)


def load_cell(root: Path, name: str) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    here = root / "benchmark"
    spec = load_json(here / "workloads" / f"{name}.json")
    config = load_json(here / "configs" / f"{spec['config']}.json")
    traffic = load_json(here / "traffic" / f"{spec['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    metrics = e2e + per_layer
    chips = [w["chips"] for w in bench["workloads"] if w["name"] == name]
    if not chips:
        raise SystemExit(f"BENCHMARK.json names no workload {name!r}")
    readers = {m["name"]: load_module(here / "metrics" / f"{m['name']}.py") for m in metrics}
    return Cell(name, config, traffic, spec["limits"], e2e, per_layer,
                load_module(here / "generators" / f"{traffic['generator']}.py"),
                load_module(here / "entries" / f"{traffic['entry']}.py"), chips[0], readers)


class Keeper:
    """Which calls' outputs the check judges: the first on each batch of the
    pool, and a reservoir of :data:`KEEP` more drawn from the seed."""

    def __init__(self, seed: int):
        self.rng = random.Random(f"keep-{seed}")
        self.firsts: dict[int, dict] = {}
        self.reservoir: list[tuple[int, dict]] = []
        self.seen = 0

    def offer(self, batch: int, host: dict[str, torch.Tensor]) -> None:
        if batch not in self.firsts:
            self.firsts[batch] = {k: v.clone() for k, v in host.items()}
            return
        self.seen += 1
        if len(self.reservoir) < KEEP:
            self.reservoir.append((batch, {k: v.clone() for k, v in host.items()}))
            return
        j = self.rng.randrange(self.seen)
        if j < KEEP:
            self.reservoir[j] = (batch, {k: v.clone() for k, v in host.items()})

    def kept(self) -> list[tuple[int, dict]]:
        return sorted(self.firsts.items()) + self.reservoir


@dataclass
class Window:
    """What the end-to-end readers read: the window's calls, its length on
    the host's clock, each call's latency in seconds, the entry's work a
    call and the set-up's seconds."""

    calls: int
    seconds: float
    latencies: list
    work: dict = field(default_factory=dict)
    setup_s: float = 0.0


def serve(program, pool: list[torch.Tensor], host: dict[str, torch.Tensor],
          device: torch.device, *, seconds: float | None = None,
          calls: int | None = None, keeper: Keeper | None = None,
          after_call=None) -> Window:
    """The served loop: calls one at a time, cycling the pool, for
    ``seconds`` (the call under way when they run out completes) or for
    ``calls`` calls."""
    cuda = device.type == "cuda"
    lat = []
    n = 0
    t_start = time.perf_counter()
    deadline = t_start + seconds if seconds is not None else None
    while True:
        t0 = time.perf_counter()
        b = n % len(pool)
        out = program(pool[b].to(device, non_blocking=cuda))
        for k, v in out.items():
            host[k].copy_(v, non_blocking=cuda)
        if cuda:
            torch.cuda.current_stream(device).synchronize()
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        n += 1
        if keeper is not None:
            keeper.offer(b, host)
        if after_call is not None:
            after_call(b, host)
        if (deadline is not None and t1 >= deadline) or (calls is not None and n >= calls):
            return Window(n, t1 - t_start, lat)


def host_buffers(program, x: torch.Tensor, device: torch.device) -> dict[str, torch.Tensor]:
    """Pinned host tensors shaped as the program's outputs on ``x``."""
    out = program(x.to(device))
    pin = device.type == "cuda"
    return {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=pin) for k, v in out.items()}


def judge(cell: Cell, kept: list, pool: list, sent: list,
          device: torch.device) -> dict[str, dict]:
    """Each number of the check with its limit, the reference run once on
    each batch that a kept call served; ``sent`` is what the generator sent
    in each batch."""
    ref = cell.entry.reference(cell.config, cell.traffic, device)
    answers = {}
    for b in sorted({b for b, _ in kept}):
        with torch.no_grad():
            out = ref(pool[b].to(device))
        answers[b] = {k: v.cpu() for k, v in out.items()}
    got = [o for _, o in kept]
    want = [answers[b] for b, _ in kept]
    numbers = cell.entry.compare(got, want, [sent[b] for b, _ in kept])
    return {name: {"value": numbers[name], "limit": cell.limits[name]} for name in cell.limits}


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def device_info(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(argv, t0: float, root: Path, device: str = "cuda") -> dict:
    """One run; returns the result line's object.  ``device="cpu"`` is for
    the CPU tests alone (the CLI never passes it)."""
    args = parse(argv)
    cell = load_cell(root, args.workload)
    dev = torch.device(device)
    chips = cell.chips
    if dev.type == "cuda":
        if torch.cuda.device_count() < chips:
            raise SystemExit(f"the cell needs {chips} CUDA devices, "
                             f"{torch.cuda.device_count()} present")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)

    pool, sent = cell.generator.make_pool(cell.config, cell.traffic, args.seed, dev)
    program = cell.entry.Program(cell.config, cell.traffic, dev)
    host = host_buffers(program, pool[0], dev)
    keeper = Keeper(args.seed)
    with torch.no_grad():
        serve(program, pool, host, dev, calls=WARM_ROUNDS * len(pool))
        trace = None
        if args.trace:
            n = cell.traffic["trace_calls"]
            iterations = []     # codeword-iterations of each call of the first stretch

            def note(_, out):
                if "iterations" in out and len(iterations) < n:
                    iterations.append(int(out["iterations"].sum()))

            trace = tracing.traced_calls(
                lambda: serve(program, pool, host, dev, calls=n, keeper=keeper,
                              after_call=note), dev)
            trace.iterations = iterations
            trace.work = cell.entry.work(cell.config, cell.traffic)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        gc.collect()
        gc.freeze()     # set-up's objects out of the collector's way in the window
        setup_s = time.perf_counter() - t0
        win = serve(program, pool, host, dev, seconds=args.seconds, keeper=keeper)
    gc.unfreeze()
    if trace is not None:
        trace.served_call_s = win.seconds / win.calls
        trace.latencies = win.latencies

    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules loaded in the run's process: {', '.join(found)}")
    dev_info = device_info(dev, chips)
    del program
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(cell, keeper.kept(), pool, sent, dev)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    result = {"correct": correct, "attempted": win.calls, "failed": 0}
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        dev_info["busy_s"] = trace.busy_s
        dev_info["window_s"] = trace.window_s
        result["device"] = dev_info
        result["breakdown"] = trace.breakdown()
    else:
        win.work = cell.entry.work(cell.config, cell.traffic)
        win.setup_s = setup_s
        result["metrics"] = {m["name"]: {"value": cell.readers[m["name"]].read(win),
                                         "unit": m["unit"]} for m in cell.end_to_end}
        result["device"] = dev_info
    result["checks"] = checks
    return result


def main(argv, t0: float, root: Path) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    result = run(argv, t0, root)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
