"""The traced window: `torch.profiler` over the window, and what the
per-layer metrics read from its trace.

The trace is written as Chrome trace JSON to a scratch file, read back and
deleted. Device activity is every kernel, copy and memset event; the window
is the harness's `benchmark.window` span; idle gaps are named by the
harness's span that covers their middle.
"""
import contextlib
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def span(name: str):
    """A harness span, recorded in the trace when one is taken."""
    import torch
    with torch.profiler.record_function(name):
        yield


def union(iv):
    """Merged [start, end) intervals of `iv`, sorted."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarise(events, top: int = 10) -> dict:
    """From Chrome trace events: the window's length, the device's busy
    seconds (the union of its activity) inside it, each kernel's seconds by
    name, and the breakdown (the device operations that took most time,
    the longest idle gaps by the harness span around them)."""
    win = [e for e in events if e.get("name") == "benchmark.window"
           and e.get("ph") == "X"]
    if not win:
        raise RuntimeError("the trace has no benchmark.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, by_name = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0)), w1)
        if b <= a:
            continue
        dev.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) * 1e-6
    busy = union(dev)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e["name"].startswith("benchmark.")
             and e["name"] != "benchmark.window"]
    gaps, prev = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            mid = 0.5 * (a + prev)
            inner = [s for s in spans if s[0] <= mid < s[1]]
            label = min(inner, key=lambda s: s[1] - s[0])[2] if inner \
                else "benchmark.window"
            gaps.append([label, (a - prev) * 1e-6])
        prev = max(prev, b)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernels": by_name,
            "breakdown": {"device_ops": [[k, v] for k, v in ops],
                          "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:top]}}


class Tracer:
    """torch.profiler over the window (CPU and CUDA activity)."""

    def __init__(self, device):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self._summary = None

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._summary = summarise(events)
        return False

    def summary(self) -> dict:
        return self._summary
