"""Runs one cell of the benchmark of ltetrigger_tpu_torch once.

    python3 ltebench/run.py --workload <name> --seed <n> --seconds <s>
                            --trace <0|1>

from the root of a checkout.  The cell's entry in BENCHMARK.json names its
configuration (ltebench/configs/<config>.json) and its traffic mix
(ltebench/traffic/<mix>.json), whose `driver` names the module under
ltebench/drivers/ that plays it.  The driver sets up the program and its
inputs from the seed, warms up every shape the cell uses, runs the measured
window, and, once the window has closed and the peak memory is read, holds
what the timed path produced to the plain reference (ltebench/reference/).

With --trace 0 the result line carries the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, each read by ltebench/metrics/<name>.py
from the profiled slice of the window, the program's counters and spans.
The last line of standard output is one JSON object; the numbers compared
with the reference, each beside its limit, close standard error and the
result line (`checks`).

Exits 2, with no result, without a CUDA device or with fewer than the cell
asks for, and 3 if the process holds jax, jaxlib, flax or the JAX package
once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "ltetrigger_tpu")


def set_cache_dirs(root: str = ROOT) -> None:
    """Every kernel and compiler cache at a fixed path inside the checkout
    (the port builds its kernels into ltetrigger_tpu_torch/_build/)."""
    cache = os.path.join(root, ".ltebench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def load_file_module(kind: str, name: str):
    """ltebench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"ltebench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, kind: str) -> list:
    """The metrics of `kind` ("end_to_end" or "per_layer") this cell
    reports: those that list it, or list no cells."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def resolve(bench: dict, workload: str) -> tuple:
    """(cell entry, configuration, traffic mix) by the cell's name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    return cell, load_json("configs", cell["config"]), \
        load_json("traffic", cell["traffic"])


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float = T_START,
             overrides: dict | None = None, fault=None) -> dict:
    """Set-up, window and check of one cell: the result as a dict, the
    compared numbers under `checks` (last).  `overrides` replaces entries of
    the configuration and the mix (tests run a cell at a small size on the
    CPU); `fault` is handed to the driver, which breaks its timed path with
    it (tests of the check)."""
    import torch

    cell, config, traffic = resolve(bench, workload)
    for part, extra in (overrides or {}).items():
        {"config": config, "traffic": traffic}[part].update(extra)
    driver = load_file_module("drivers", traffic["driver"])
    ctx = dict(workload=workload, cell=cell, config=config, traffic=traffic,
               seed=int(seed), seconds=float(seconds), trace=bool(trace),
               device=torch.device(device), t_start=t_start, fault=fault,
               overrides=overrides)
    state = driver.setup(ctx)
    e2e = driver.window(ctx, state)
    if ctx["device"].type == "cuda":
        torch.cuda.synchronize(ctx["device"])
        mem = torch.cuda.max_memory_allocated(ctx["device"])
        kind = torch.cuda.get_device_name(ctx["device"])
        count = int(config["chips"])
        platform = "gpu"
    else:
        mem, kind, count, platform = 0, "cpu", 1, "cpu"
    driver.free(ctx, state)
    limits = load_json("limits", workload)
    checks = driver.check(ctx, state, limits)
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    info = dict(e2e.get("info", {}), ties=state.get("ties"),
                undue=state.get("undue"))

    result = dict(correct=bool(ok), attempted=int(e2e["attempted"]),
                  failed=int(e2e["failed"]))
    if trace:
        metrics = {}
        rd = dict(ctx=ctx, state=state, e2e=e2e,
                  slice=state.get("slice_result"))
        for m in cell_metrics(bench, workload, "per_layer"):
            value = load_file_module("metrics", m["name"]).read(rd)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell_metrics(bench, workload, "end_to_end")}
    result["metrics"] = metrics
    result["device"] = dict(platform=platform, kind=kind, count=count,
                            memory_peak_bytes=int(mem))
    sl = state.get("slice_result")
    if trace and sl is not None:
        result["device"].update(busy_s=sl["busy_s"], window_s=sl["window_s"])
        result["breakdown"] = dict(device_ops=sl["top_ops"],
                                   idle_gaps=sl["idle_gaps"])
    result["info"] = info
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    # the package root, not this folder, leads the search path
    sys.path[0] = ROOT
    bench = load_benchmark()
    cell, _, _ = resolve(bench, args.workload)

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"ltebench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"ltebench: the process holds {bad} after the window",
              file=sys.stderr)
        return 3
    for name, v in result.pop("info").items():
        print(f"info {name} = {v!r}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
