#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card of the machine it
is started on, and print the result as one JSON line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program
(``seamless_communication_torch``). The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``benchmark/configs/<name>.json``) and
a traffic mix (``benchmark/traffic/<name>.json``); the mix names its driver
(``benchmark/drivers/<driver>.py``). The driver builds the program with
seeded weights, warms it up (``setup_s``, counted from this process's
start), measures for ``--seconds``, and checks what the window served
against the plain reference (``benchmark/reference``) with the cell's
limits (``benchmark/limits/<workload>.json``). With ``--trace 1`` the run
goes on for the mix's ``trace_seconds`` under the profiler and prints the
per-layer metrics, each read by ``benchmark/metrics/<metric>.py``; with
``--trace 0`` it prints the end-to-end metrics.

The last lines on standard error, and the result's last key (``checks``),
give each number compared with its limit. The run exits 4 without a result
where there is no CUDA card (or fewer than the cell asks for), 5 where a
module of JAX or of the JAX package was loaded, and 1 where the driver
failed."""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "seamless_communication_tpu"}


def _environment() -> None:
    """Caches at fixed paths inside the checkout, few host threads, and no
    library's JAX backend."""
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[v] = "4"
    for p in (str(ROOT), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _metrics(spec: dict, cell: str, rec: dict, trace: bool) -> dict:
    from harness.common import load_module

    out = {}
    if not trace:
        for m in spec["end_to_end"]:
            if "workloads" in m and cell not in m["workloads"]:
                continue
            out[m["name"]] = {"value": float(rec["e2e"][m["name"]]), "unit": m["unit"]}
        return out
    reported = {m["name"] for m in spec["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]}
    for m in spec["per_layer"]:
        if cell not in m.get("workloads", [cell] if m["moves"] in reported else []):
            continue
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                             "metric_" + m["name"].replace(".", "_"))
        value = reader.read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    _environment()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness.common import benchmark_spec, config_file, limits_file, load_module
    from harness.common import traffic_file, workload
    from harness.context import Ctx

    spec = benchmark_spec()
    cell = workload(spec, args.workload)
    config = config_file(spec, cell["config"])
    mix = traffic_file(cell["traffic"])
    limits = limits_file(cell["name"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        _log(f"no result: {cell['name']} needs {cell['chips']} CUDA card(s); "
             f"available {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 4
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kind = torch.cuda.get_device_name(device)
    _log(f"{cell['name']}: seed {args.seed}, {args.seconds} s, trace {args.trace}; "
         f"{kind} ({_power_limit()}); torch {torch.__version__}")

    ctx = Ctx(workload=cell, config=config, traffic=mix, limits=limits, seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace), device=device,
              t_process=T_PROCESS, log=_log)
    driver = load_module(BENCH / "drivers" / f"{mix['driver']}.py", "driver_" + mix["driver"])
    try:
        rec = driver.run(ctx)
    except Exception:
        traceback.print_exc()
        return 1
    for note in rec.get("notes", []):
        _log(note)

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if loaded:
        _log(f"no result: modules of JAX or the JAX package were loaded: {loaded}")
        return 5

    from harness.result import judge

    correct, checks = judge(rec, limits)
    device_out = {"platform": "gpu", "kind": kind, "count": cell["chips"],
                  "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    result = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": _metrics(spec, cell["name"], rec, bool(args.trace)),
              "device": device_out}
    if args.trace:
        from harness.trace import label_gaps

        tr = rec["trace"]
        device_out["busy_s"] = tr.busy_s()
        device_out["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(10),
                               "idle_gaps": label_gaps(tr, rec["spans"] or [], 10)}
        for note in tr.notes:
            _log(note)
    result["checks"] = checks
    for name, c in checks.items():
        _log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
