"""The control of a cell: the program run as a later change might be
tempted to run it, or the reference in its place in a lower precision,
which the cell's check must refuse (limits/<cell>.json "control").

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \\
        --seconds <s>

prints each seed's numbers beside their limits, and exits 1 unless every
seed's run comes out not correct. Not run by the benchmark's own runs.
"""
import argparse
import json
import sys

from . import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    run.program_env()
    import torch
    if not torch.cuda.is_available():
        run.log("[control] needs a CUDA card")
        return 2
    from .loops import control_of
    _b, cell, _c, _m = run.cell_files(args.workload)
    refused = 0
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds:
        res = run.run_cell(args.workload, seed, args.seconds, False,
                           torch.device("cuda", 0),
                           control=control_of(cell))
        refused += not res["correct"]
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "numbers": res["numbers"]}), flush=True)
    return 0 if refused == len(seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
