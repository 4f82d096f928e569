"""Run one cell of ``BENCHMARK.json`` once on the card:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result; the numbers the comparison held against their limits are the last
lines of standard error. Without a CUDA card, or with fewer cards than the
cell asks for, it exits with 2 and prints no result.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}. Nothing runs on the CPU.",
              file=sys.stderr)
        return 2
    from portbench import harness

    print(f"portbench: {args.workload} seed {args.seed} on {card_line()}", file=sys.stderr, flush=True)
    result = harness.run(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), STARTED)
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
