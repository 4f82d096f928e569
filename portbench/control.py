"""The readings a cell's limits are set from, on the card at the cell's own
size, in one process:

    python3 -m portbench.control --workload <name> --seeds 11 12 ... [--control-seeds 11 12 13] [--witness]

Each seed is one run of the cell through ``harness.run`` (set-up, a short
window, the program freed, the comparison): the program's numbers are the
lower readings. On each control seed the same run then reads the control,
the plain reference computed one precision down in the program's place
(``reference.model.Precision.fp8``), with ``--witness`` the reference in
the configuration's own precision (``Precision.bf16``), and the planted
faults:

* training: the losses taken over half of each batch (``half_batch``), the
  odd variant's D step skipped (``odd_d_skipped``, from the fourth
  compared step on), a step that leaves the state unchanged (every change
  and every moment 0), and one pixel of one view a level off where the
  pipeline makes it;
* generation: one image of each sampled batch altered where it is made
  (mirrored left to right), and half of each batch left out.

Each is compared with the float32 reference by the cell's own numbers and
judged against the cell's limits (``compare.judge``), a fault's numbers
beside the program's own on the same seed where it changes only some. One
JSON line a seed and kind with its verdict, then a summary: the largest
program reading and the smallest control and fault readings of each
number, and how many seeds of each kind came out correct.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from portbench import compare, harness
from portbench.reference import model

ROOT = harness.HERE.parent


def train_faults(work, witness: bool) -> dict:
    ref, views = work.ref, work.ref_views
    out = {}
    with model.reference_mode():
        out["control"] = compare.train_gaps(work.reference(views, prec=model.Precision.fp8()), ref)
        if witness:
            bf16 = work.reference(views, prec=model.Precision.bf16())
            out["bf16_reference"] = compare.train_gaps(bf16, ref)
            for what, rows in compare.train_worst(bf16, ref).items():
                print(f"portbench.control: bf16 reference, widest {what}: "
                      + "; ".join(f"{k} {gap:.4g} ({p:.4g} vs {r:.4g})" for k, gap, p, r in rows), file=sys.stderr)
        for fault in ("half_batch", "odd_d_skipped"):
            out[fault] = compare.train_gaps(work.reference(views, fault=fault), ref)
    altered = [{k: v.copy() for k, v in b.items()} for b in work.views]
    altered[0]["image"][0, 0, 0, 0] += 2.0 / 255.0  # one view's pixel a level off
    out["altered_view"] = {"view_gap": compare.view_gap(altered, views)}
    out["unchanged"] = compare.train_gaps(compare.TrainReadings(
        ref.losses, [dict.fromkeys(g, 0.0) for g in ref.grads], dict.fromkeys(ref.changes, 0.0),
        [dict.fromkeys(c, 0.0) for c in ref.step_changes]), ref)
    return out


def gen_faults(work, witness: bool) -> dict:
    prog = [imgs for _, _, imgs in work.kept]
    out = {}
    with model.reference_mode():
        out["control"] = compare.image_gaps(work.reference(prec=model.Precision.fp8()), work.ref)
        if witness:
            out["bf16_reference"] = compare.image_gaps(work.reference(prec=model.Precision.bf16()), work.ref)
    altered = [np.concatenate([p[:1, :, ::-1], p[1:]]) for p in prog]
    out["altered_image"] = compare.image_gaps(altered, work.ref)
    out["half_batch"] = compare.image_gaps([p[: len(p) // 2] for p in prog], work.ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=4.0,
                    help="the short window (a training cell runs at least one period)")
    ap.add_argument("--witness", action="store_true",
                    help="also read the reference in the configuration's own precision (bf16) on the control seeds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(bench, args.workload)
    faults = gen_faults if cell.traffic["driver"] == "generate" else train_faults
    device = torch.device("cuda", 0)
    readings = defaultdict(lambda: defaultdict(list))
    verdicts = defaultdict(list)
    for seed in args.seeds:
        t = time.perf_counter()
        got = {}
        harness.run(bench, args.workload, seed, args.seconds, False, device, t, plant=lambda w: got.setdefault("w", w))
        work = got.pop("w")
        kinds = {"program": work.values}
        if seed in args.control_seeds:
            kinds.update(faults(work, args.witness))
        del work
        gc.collect()
        torch.cuda.empty_cache()
        for kind, values in kinds.items():
            ok = compare.judge({**kinds["program"], **values}, cell.limits)[0]
            verdicts[kind].append(ok)
            for k, v in values.items():
                readings[kind][k].append(v)
            print(json.dumps({"seed": seed, "kind": kind, "correct": ok,
                              **{k: harness.finite_json(v) for k, v in values.items()}}), flush=True)
        print(f"portbench.control: seed {seed} took {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    summary = {"workload": args.workload, "seeds": len(args.seeds), "control_seeds": len(args.control_seeds),
               "correct": {kind: f"{sum(v)} of {len(v)}" for kind, v in verdicts.items()}}
    for kind, values in readings.items():
        pick = max if kind == "program" else min
        summary[kind] = {k: harness.finite_json(pick(v)) for k, v in values.items()}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
