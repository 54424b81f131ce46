"""Run one cell of BENCHMARK.json once, on the GPU, and print its result.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result's JSON object; the last
lines of standard error are the numbers that decided `correct`, each with
its limit. With --trace 0 the metrics are the cell's end-to-end metrics,
with --trace 1 its per-layer metrics, read from a profiler trace of the
window's first part. Without a CUDA device, or with fewer than the cell
asks for, it exits with 2 and prints no result; it never falls back to the
CPU.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / "build" / "portbench_cache"
# kernel and extension caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
sys.path[:0] = [str(BENCH), str(ROOT)]

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              , file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    run = harness.load_run(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda:0", T_START, manifest)
    entry = importlib.import_module(
        f"portbench.entries.{run.workload['entry']}")
    outcome = entry.run(run)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    line, checks = harness.result(run, outcome)
    sys.stdout.flush()
    print("\n".join(checks), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
