"""One run of one cell of the benchmark of biscuit_tpu_torch.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The cell's files are found by name: BENCHMARK.json's workload names a
config (configs/<config>.json) and a traffic mix (traffic/<mix>.json), and
each per-layer metric is read by metrics/<name>.py. The last line of
standard output is the result as one JSON object; everything else goes to
standard error. A run on a machine without the card exits 2 and prints no
result; one whose warm chunk or call, or a chunk or call of its window,
runs past its time limit (loops.WARM_LIMIT_S, loops.CHUNK_LIMIT_S) stops at
once with every thread's stack on standard error, exits 1 and prints no
result.
"""
import time

T_PROC = time.perf_counter()  # noqa: E402  (the run's set-up starts here)

import argparse
import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH_DIR)
# what may not be loaded once the window has closed: JAX and the JAX package,
# by whole top-level name (the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "biscuit_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_files(name: str, bench=None, sizes=None):
    """(BENCHMARK.json, workload, config, traffic) of cell `name`; `sizes`
    overrides keys of the config and the mix (the tests' small runs)."""
    bench = bench or load_json(REPO, "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    cfg = load_json(BENCH_DIR, "configs", cell["config"] + ".json")
    mix = load_json(BENCH_DIR, "traffic", cell["traffic"] + ".json")
    for d in (cfg, mix):
        d.update({k: v for k, v in (sizes or {}).items() if k in d})
    from .loops import align_options
    align_options(cfg.get("align_options", []))  # refused here, at load
    return bench, cell, cfg, mix


def metric_reader(name: str):
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name
                                                  .replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program_env() -> None:
    """The program at its defaults, with every build and kernel cache at a
    fixed path in the checkout."""
    for k in list(os.environ):
        if k.startswith("BISCUIT_TPU"):
            del os.environ[k]
    cache = os.path.join(BENCH_DIR, "cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")


def card() -> dict:
    """The card's name, count and power limit (nvidia-smi)."""
    import subprocess
    import torch
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1}
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        out["power_limit"] = r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out["power_limit"] = "not read"
    return out


def per_layer(bench, cell, ctx) -> dict:
    """The cell's per-layer metrics, each from its reader; a reader that
    finds nothing to read leaves its metric out."""
    reports = {m["name"] for m in bench["end_to_end"]
               if cell["name"] in m.get("workloads", [cell["name"]])}
    out = {}
    for m in bench["per_layer"]:
        if cell["name"] not in m.get("workloads", [cell["name"]]) or \
                m["moves"] not in reports:
            continue
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             bench=None, control=None, sizes=None, time_limits=None) -> dict:
    """Set up, measure and check one run of cell `name` on `device` (a CUDA
    device in a benchmark run; the CPU in the tests, which drive the plain
    versions of the kernels). Returns the result's fields and the numbers
    compared; `control` runs the cell's control in the program's place
    (limits/<cell>.json, loops.control_of); `time_limits`, (warm, chunk)
    seconds, stops the process past either (loops.time_limit; none where
    it is None)."""
    from . import loops
    bench, cell, cfg, mix = cell_files(name, bench, sizes)
    res = loops.LOOPS[mix["kind"]](cell, cfg, mix, seed, seconds, trace,
                                   device, T_PROC, control, time_limits)
    ctx = res.pop("ctx")
    if trace:
        res["metrics"] = per_layer(bench, cell, ctx)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    program_env()
    bench, cell, _cfg, _mix = cell_files(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"[benchmark] {args.workload} needs {cell['chips']} CUDA "
            f"card(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, {torch.cuda.device_count()} found")
        return 2
    dev = card()
    log(f"[benchmark] {args.workload} seed {args.seed} on {dev['kind']}, "
        f"power limit {dev['power_limit']}")
    from .loops import CHUNK_LIMIT_S, WARM_LIMIT_S
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), bench,
                   time_limits=(WARM_LIMIT_S, CHUNK_LIMIT_S))
    bad = forbidden_modules()
    if bad:
        log(f"[benchmark] loaded in this process: {', '.join(bad)}")
        return 3
    res.pop("outputs")
    dev["memory_peak_bytes"] = res.pop("memory_peak_bytes")
    dev.update(res.pop("device", {}))
    checks = res.pop("checks")
    for k, v in checks.items():
        log(f"[check] {k} {v['value']} limit {v['limit']}")
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": dev}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
