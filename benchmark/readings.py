"""The readings that a cell's limits are set from: the program's numbers
on each seed, and the control's.

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 3 ... --control 4 5 6 \
        [--instances 0 1 2 ...]

One process: the first reading's solve is run twice (the first warms up),
every other once, each judged as an answer of the window is: the cell's
instance in each seed's gauge, then, with ``--instances``, other
instances of its recipe (seed 0's gauge).  One JSON line per reading on
standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark import harness  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--instances", type=int, nargs="*", default=[])
    args = p.parse_args()
    cell = harness.load_cell(args.workload)
    ref_mod = harness.load_module(harness.BENCH / "reference" / f"{cell.config['reference']}.py")
    runs = [(seed, None) for seed in args.seeds] + [(0, inst) for inst in args.instances]
    for i, (seed, inst) in enumerate(runs):
        a = harness.build_matrix(cell.config, seed, recipe_seed=inst)
        rows = ref_mod.keep_rows(a)
        outside = harness.outside_of(rows, a.shape[0], "cuda")
        call = harness.make_call(a, cell.config, cell.traffic, "cuda", seed)
        try:
            for _ in range(2 if i == 0 else 1):
                t = time.perf_counter()
                res = call()
                ans = harness.keep(res.eigs, res.Q_conv, rows, outside)
                dur = time.perf_counter() - t
                conv, restarts = bool(res.converged), int(res.n_restarts)
                del res
        except Exception as exc:  # the answer never comes: a reading of its own
            print(json.dumps({"program": seed, "instance": inst, "raised": repr(exc),
                              "seconds": time.perf_counter() - t}), flush=True)
            continue
        got = ref_mod.judge(ref_mod.top_pairs(a, cell.traffic["n_wanted"]), ans["eigs"],
                            ans["kept"], ans["out_sq"])
        print(json.dumps({"program": seed, "instance": inst, "seconds": dur, "converged": conv,
                          "restarts": restarts, **got}), flush=True)
        del call, a, outside
    for seed in args.control:
        print(json.dumps({"control": seed, **harness.control_numbers(cell, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
