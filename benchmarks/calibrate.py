"""Read the numbers that decide a cell's `correct` over many seeds, for the
limits in its workload file: the program's sound readings (the lower
ones), the fp8 control's and the faults' (the upper ones), each against
the plain f32 reference, at the cell's own sizes, in one process.

    python3 benchmarks/calibrate.py --workload <cell> --seeds 11 12 13 ... \
        [--out readings.jsonl]

Each seed prints one JSON line {"seed", "<reading>": {number: value}}, and
the last line the largest program reading and the smallest control and
fault readings of each number. It needs the GPU, as run.py does; the
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def summarize(rows: list) -> dict:
    """{reading: {number: the largest (program) or smallest (others)}}."""
    out: dict = {}
    for row in rows:
        for reading, numbers in row.items():
            if not isinstance(numbers, dict):
                continue
            pick = max if reading == "program" else min
            agg = out.setdefault(reading, {})
            for k, v in numbers.items():
                agg[k] = v if k not in agg else pick(agg[k], v)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 2
    rows = []
    for seed in args.seeds:
        run = harness.load_run(args.workload, seed, 0.0, False, "cuda:0",
                               time.perf_counter())
        entry = importlib.import_module(
            f"portbench.entries.{run.workload['entry']}")
        row = {"seed": seed, **entry.calibrate(run)}
        harness.free_device(run)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      **summarize(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
