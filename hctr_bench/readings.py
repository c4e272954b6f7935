"""The readings that a cell's limits are set from, many seeds in one
process (one set-up): the program's numbers on each seed, or with
``--control`` the control's (the configuration's ``control``: the
program's lower precision path, or the reference in the program's place at
a lower precision). One JSON line a seed.

    python3 hctr_bench/readings.py --workload <cell> --seconds <s> \\
        --seeds 1 2 3 [--control]

``--fault altered`` plants a fault in the program first: each row's first
character moved to another class where the decode produces it;
``--fault swapped`` reverses the texts of each served batch, so that
requests get other requests' answers; ``--fault greedy`` has the LM-fused
search return the greedy reading, the LM dropped. ``--lm-int8`` serves
the LM route's LM step in int8 beside the configuration's recognizer.

Also the knee sweep of an open-loop cell: ``--rates 60 80 100`` runs one
window a rate (seed the first of ``--seeds``) and prints the p95, the
batch fill, the generator's lateness and the outstanding requests at the
window's middle and end.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

import run as bench
from manifest import Manifest


def alter_first(chars, lengths):
    """Each row's first character moved to one of the first 100 classes."""
    chars = chars.clone()
    chars[:, 0] = torch.where(lengths > 0, chars[:, 0] % 100 + 1,
                              chars[:, 0])
    return chars, lengths


def plant(fault: str) -> None:
    from handwritten_chinese_ocr_samples_torch.decode import adaptive, routes
    from handwritten_chinese_ocr_samples_torch.serve.engine import (
        ServingEngine)
    if fault == "altered":
        greedy, search = routes.greedy_decode_device, \
            adaptive.AdaptiveLMBeam.decode
        routes.greedy_decode_device = \
            lambda *a, **k: alter_first(*greedy(*a, **k))
        adaptive.AdaptiveLMBeam.decode = \
            lambda self, *a: alter_first(*search(self, *a))
    elif fault == "greedy":
        adaptive.AdaptiveLMBeam.decode = \
            lambda self, cv, ci, logits, *a: routes.greedy_decode_device(
                logits, unknown_id=self.unknown_id)
    else:
        infer = ServingEngine.infer_batch
        ServingEngine.infer_batch = lambda self, b: infer(self, b)[::-1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--rates", type=float, nargs="*", default=[])
    p.add_argument("--fault", choices=("altered", "swapped", "greedy"))
    p.add_argument("--lm-int8", action="store_true")
    p.add_argument("--check-lines", type=int,
                   help="check this many lines (all: the line set's size)")
    args = p.parse_args(argv)
    if args.fault:
        plant(args.fault)
    if not torch.cuda.is_available():
        raise SystemExit("readings: no CUDA card")
    cell = bench.Cell(Manifest.load(), args.workload,
                      torch.device("cuda", 0), control=args.control,
                      lm_int8=args.lm_int8)
    if args.check_lines:
        cell.traffic["check_lines"] = args.check_lines
    kind = cell.config["control"]["kind"]
    if args.control and kind == "reference":
        cell.state = bench.assets.load_state(cell.config["weights"])
        for seed in args.seeds:
            t0 = time.perf_counter()
            nums = cell.control_reference(seed, args.seconds)
            print(json.dumps({"seed": seed, "control": kind, **nums,
                              "check_s": time.perf_counter() - t0}),
                  flush=True)
        return 0
    cell.setup()
    for rate in args.rates:
        cell.traffic["rate_per_s"] = rate
        out = cell.window(args.seeds[0], args.seconds, False)
        lat = out["latency_s"] * 1e3
        print(json.dumps({
            "rate_per_s": rate, "attempted": out["attempted"],
            "failed": out["failed"], "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "fill": float(np.mean(out["fills"])) / cell.traffic["batch_size"],
            "lateness_ms_max": float(out["lateness_s"].max()) * 1e3,
            "outstanding_mid": out["outstanding_mid"],
            "outstanding_end": out["outstanding_end"],
            "window_s": out["window_s"]}), flush=True)
    if args.rates:
        return 0
    for seed in args.seeds:
        out = cell.window(seed, args.seconds, False)
        metrics = bench.end_to_end(cell, out, 0.0)
        picked = cell.sample(out)
        t0 = time.perf_counter()
        nums = cell.judge(picked)
        ok, checks = bench.correct_of(nums, cell.limits)
        print(json.dumps({
            "seed": seed, "control": kind if args.control else None,
            "fault": args.fault, "lm_int8": args.lm_int8,
            **nums, "check_s": time.perf_counter() - t0,
            "failed": out["failed"], "attempted": out["attempted"],
            "metric": {k: v["value"] for k, v in metrics.items()
                       if k != "setup_s"},
            "correct": ok and out["failed"] == 0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
