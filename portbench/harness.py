"""Runs one cell once: set-up, the timed window, an optional traced
window, then the comparison with the plain reference.

Everything that belongs to one configuration, traffic mix or metric is
found by name: ``BENCHMARK.json`` names the cell's configuration file and
traffic mix; a configuration's ``program`` names its modules under
``programs/``, ``reference/`` and ``counts/``; a traffic file's
``loop.kind`` names its driver under ``loops/``; each metric is read by
``metrics/<name>.py`` with the data in ``metrics/<name>.json`` and in
every ``metrics/<name>.<part>.json`` beside it (lists are joined), or, where
that data says ``same_as``, as another metric; each cell's limits are
``limits/<cell>.json``.
"""
from __future__ import annotations

import gc
import importlib
import json
import random
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import torch

from portbench import counts
from portbench.data import graph as graphs
from portbench.reference import compare

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FOREIGN = ("jax", "jaxlib", "flax", "repro")
KEEP_RANGE = 8   # the kept early forward is drawn from the first 8


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


class Cell(NamedTuple):
    name: str
    entry: dict        # the workload's entry in BENCHMARK.json
    config: dict       # its configuration file
    traffic: dict      # traffic/<traffic>.json
    limits: dict       # limits/<cell>.json
    end_to_end: list   # BENCHMARK.json metric entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str) -> Cell:
    m = load_json(ROOT / "BENCHMARK.json")
    entry = {w["name"]: w for w in m["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in m["configs"]}[entry["config"]]
    return Cell(
        name=name, entry=entry, config=load_json(ROOT / conf["file"]),
        traffic=load_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(BENCH / "limits" / f"{name}.json"),
        end_to_end=[x for x in m["end_to_end"] if _reports(x, name)],
        per_layer=[x for x in m["per_layer"] if _reports(x, name)])


def metric_spec(name: str) -> dict:
    """The metric's data: ``metrics/<name>.json`` joined with every
    ``metrics/<name>.<part>.json``."""
    spec: dict = {}
    files = [BENCH / "metrics" / f"{name}.json"]
    files += sorted((BENCH / "metrics").glob(f"{name}.*.json"))
    for f in files:
        if not f.exists():
            continue
        for k, v in load_json(f).items():
            spec[k] = spec.get(k, []) + v if isinstance(v, list) else v
    return spec


def read_metric(name: str, ctx) -> Optional[float]:
    """The metric's reader on ``ctx``; a metric whose data says
    ``{"same_as": <other>}`` is read as that other metric is."""
    spec = metric_spec(name)
    if "same_as" in spec:
        return read_metric(spec["same_as"], ctx)
    mod = importlib.import_module(f"portbench.metrics.{name}")
    return mod.read(ctx, spec)


@dataclass
class Context:
    """What the metric readers read."""
    setup_s: float
    window: dict                 # the untraced window (loops/<kind>.run)
    peak_bytes: Optional[int]    # max_memory_allocated over that window
    stages: dict                 # counts/<program>.stages(shapes)
    trace: object = None         # trace.Trace of the traced window


def configure_torch() -> None:
    """The configurations' precision is float32 with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Inputs(NamedTuple):
    x: torch.Tensor
    rows: object        # numpy int64, sorted by (row, col)
    cols: object
    weights: dict       # float32 on the device
    shapes: dict


def make_inputs(cell: Cell, seed: int, device, log: Callable) -> Inputs:
    """The graph and the float32 weights, drawn on the device from one
    generator seeded with ``seed``, and the shapes the counts read."""
    g = graphs.generator(seed, device)
    gr = graphs.make_graph(cell.traffic["graph"], g, device)
    n, e = gr.n_nodes, gr.n_edges
    sizes = {"n_feat": gr.n_feat, "n_classes": gr.n_classes,
             "hidden": int(cell.config["hidden"])}
    weights = {k: graphs.glorot(g, [sizes[a] for a in shape], device)
               for k, shape in cell.config["weights"].items()}
    loop = torch.arange(n, device=device)
    shapes = {"n": n, "f": gr.n_feat, "h": sizes["hidden"],
              "c": gr.n_classes, "nnz": e, "nnz_hat": e + n,
              "tiles": graphs.tile_count(gr.rows, gr.cols, n),
              "tiles_hat": graphs.tile_count(torch.cat([gr.rows, loop]),
                                             torch.cat([gr.cols, loop]), n)}
    log(f"graph: {n} nodes, {e} directed edges after deduplication "
        f"({cell.traffic['graph']['n_edges']} drawn), {shapes['tiles']} "
        f"4x4 tiles; {gr.n_feat} features, {gr.n_classes} classes")
    return Inputs(x=gr.x, rows=gr.rows.cpu().numpy(),
                  cols=gr.cols.cpu().numpy(), weights=weights, shapes=shapes)


def _sync(device) -> Callable:
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def start(cell: Cell, seed: int, device, log: Callable):
    """Set-up up to the window: the inputs, the program built on them, and
    the traffic's warm-up forwards; returns (inputs, program)."""
    inputs = make_inputs(cell, seed, device, log)
    program = importlib.import_module(
        f"portbench.programs.{cell.config['program']}").build(
        inputs.x, inputs.rows, inputs.cols, inputs.weights, cell.config,
        device)
    sync = _sync(device)
    for _ in range(int(cell.traffic["loop"]["warmup_forwards"])):
        program.forward()
        sync()
    return inputs, program


def judge(outputs: dict, cell: Cell, inputs: Inputs, device) -> list:
    """Every kept output against the reference's interval: one dict of
    readings an output."""
    ref_mod = importlib.import_module(
        f"portbench.reference.{cell.config['program']}")
    rows = torch.from_numpy(inputs.rows).to(device)
    cols = torch.from_numpy(inputs.cols).to(device)
    lo, hi = ref_mod.bounds(inputs.x, rows, cols, inputs.weights)
    del rows, cols
    return [compare.gaps(out, lo, hi) for out in outputs.values()]


def foreign_modules() -> list:
    """Top-level names in ``sys.modules`` that the port must not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top.intersection(FOREIGN))


def card(device) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}


def run(name: str, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: Optional[float] = None, wrap: Optional[Callable] = None,
        log: Callable = None) -> dict:
    """One run of the cell ``name``; returns the result object (its last
    key, ``checks``, holds each number compared beside its limit).
    ``wrap(forward)`` replaces the timed forward (a planted fault)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = load_cell(name)
    configure_torch()
    sync = _sync(device)
    counts_mod = importlib.import_module(
        f"portbench.counts.{cell.config['program']}")
    loop = importlib.import_module(
        f"portbench.loops.{cell.traffic['loop']['kind']}")
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from repro_torch.kernels import build, ops
        build.build_all(cell.config["libraries"])

    inputs, program = start(cell, seed, device, log)
    forward = program.forward if wrap is None else wrap(program.forward)
    gc.collect()
    keep = random.Random(seed).randrange(KEEP_RANGE)
    if on_card:
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s:.3f}")

    window = loop.run(forward, seconds, sync, keep)
    log(f"window: {window['count']} forwards in {window['window_s']:.6f} s")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    if on_card:
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        log("launches a forward (ops.launch_counts): " + ", ".join(
            f"{k} {v / window['count']:g}" for k, v in sorted(launches.items())))
    ctx = Context(setup_s=setup_s, window=window, peak_bytes=peak,
                  stages=counts_mod.stages(inputs.shapes))
    attempted = window["count"]
    if trace:
        from portbench import trace as tracing
        if on_card:
            log(f"ops.launch_stats of one forward: "
                f"{ops.launch_stats(forward)}")
        tw, ctx.trace = tracing.profile(lambda span: loop.run(
            forward, float(cell.traffic["loop"]["trace_seconds"]), sync,
            keep, span))
        attempted += tw["count"]
        del tw
        t = ctx.trace
        first = min((o[1] for o in t.device_ops), default=t.start_ns)
        last = max((o[2] for o in t.device_ops), default=t.end_ns)
        log(f"traced window: {t.forwards} forwards, {t.window_s:.6f} s, "
            f"device busy {t.busy_s:.6f} s; first device op "
            f"{(first - t.start_ns) / 1e3:.1f} us after the window opens, "
            f"last ends {(t.end_ns - last) / 1e3:.1f} us before it closes")
        for op, sec, k in ctx.trace.by_name():
            log(f"  device {sec * 1e3:.6f} ms {k:g}x a forward: {op[:160]}")
    outputs = window.pop("outputs")
    del program, forward
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    each = judge(outputs, cell, inputs, device)
    failed = sum(not compare.within(r, cell.limits) for r in each)
    readings = {k: max(r[k] for r in each) for k in each[0]}
    correct = failed == 0
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        v = read_metric(m["name"], ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = card(device)
    dev["memory_peak_bytes"] = peak
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = {k: {"value": readings.get(k), "limit": v}
                        for k, v in cell.limits.items()}
    return result
