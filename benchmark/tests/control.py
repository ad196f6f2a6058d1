#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card.

    python3 benchmark/tests/control.py --workload <name> \
        --control none|tf32|int4|beam --seconds <s> --seeds <n> [<n> ...]

For each seed, one run of the cell's driver with a short window (the cell's
own load) and its comparison, which prints every number compared (and the
serve cell's median score distance beside them). ``none``: the program as
the configuration states it (the lower readings). ``tf32``: the program
with torch's float32 switches on TF32, one step below the configuration's
float32 (the control). ``int4``: the program's own int4 path one step
below the configuration's int8 (the serve cell's packed-int4 KV cache, the
pool's int4 EMMA weights). ``beam``: the serve cell's beam search keeping
worse candidates (``faults.py``). One JSON line a seed on standard output.
The benchmark's own runs never run this."""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH.parent), str(BENCH)]

import faults  # noqa: E402
from run import _environment  # noqa: E402


def main(argv=None) -> int:
    _environment()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", choices=("none", "tf32", "int4", "beam"), required=True)
    args = ap.parse_args(argv)

    import torch

    from harness.common import benchmark_spec, config_file, limits_file, load_module
    from harness.common import traffic_file, workload
    from harness.context import Ctx

    spec = benchmark_spec()
    cell = workload(spec, args.workload)
    config = config_file(spec, cell["config"])
    mix = traffic_file(cell["traffic"])
    driver = load_module(BENCH / "drivers" / f"{mix['driver']}.py", "driver")
    control = None if args.control == "none" else args.control
    torch.set_num_threads(4)
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = Ctx(workload=cell, config=config, traffic=mix, limits=limits_file(cell["name"]),
                  seed=seed, seconds=args.seconds, trace=False,
                  device=torch.device("cuda", 0), control=control)
        with (faults.beam_keeps_worse() if control == "beam" else contextlib.nullcontext()):
            rec = driver.run(ctx)
        print(json.dumps({"workload": cell["name"], "control": args.control, "seed": seed,
                          "attempted": rec["attempted"],
                          "failed": rec["failed"], "checks": rec["checks"],
                          "e2e": rec["e2e"], "seconds": time.perf_counter() - t0}),
              flush=True)
        del rec
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
