"""The control at a size a test run holds: each cell's driver at the tiny
sizes of ``tiny.py`` with the program's own int4 path one step below the
configuration's int8 (the serve cell's packed-int4 KV cache, the pool's
int4 EMMA weights), judged with the cell's own limits, comes out not
correct, and the same run with int8 comes out correct. (At the cells' own
sizes on the card the readings come from ``benchmark/tests/control.py``,
in PERF.md with the limits set from them.)"""

import pytest
import torch

import tiny
from harness.common import limits_file, load_module
from harness.context import Ctx
from harness.result import judge

# cell, configuration, mix, window seconds: the pool's window holds whole
# sessions on a loaded host too
CELLS = {"serve": ("m4t_v2_large.s2tt_serve32", tiny.serve_config, tiny.serve_traffic, 5.0),
         "stream_pool": ("seamless_streaming.s2tt_pool8", tiny.stream_config,
                         tiny.stream_traffic, 10.0)}


@pytest.mark.parametrize("driver", sorted(CELLS))
def test_the_int4_control_is_refused(driver):
    cell, config, traffic, seconds = CELLS[driver]
    drv = load_module(tiny.BENCH / "drivers" / f"{driver}.py", "drv_" + driver)
    verdicts = {}
    for control in (None, "int4"):
        ctx = Ctx(workload={"name": "tiny"}, config=config(), traffic=traffic(), limits={},
                  seed=2 ** 33 + 11, seconds=seconds, trace=False, device=torch.device("cpu"),
                  log=lambda s: None, control=control)
        rec = drv.run(ctx)
        assert rec["attempted"] > 0, f"{control}: nothing finished in the window"
        verdicts[control] = judge(rec, limits_file(cell))
    assert verdicts[None][0], verdicts[None][1]
    # refused by a number over its limit, not by an empty window
    assert any(c["value"] > c["limit"] for c in verdicts["int4"][1].values()), verdicts["int4"]
