"""What the benchmark brings into a process: the harness, the drivers and
the metric readers load no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``seamless_communication_tpu``; the reference
loads none of those nor the program (``seamless_communication_torch``).
Each import runs in a fresh interpreter."""

import subprocess
import sys

import pytest

import tiny

JAX = ("jax", "jaxlib", "flax", "seamless_communication_tpu")
PROBE = """
import sys
from pathlib import Path
sys.path[:0] = [{root!r}, {bench!r}]
from harness.common import load_module
{body}
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def _top_level(body: str) -> set:
    code = PROBE.format(root=str(tiny.BENCH.parent), bench=str(tiny.BENCH), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tiny.BENCH.parent))
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_drivers_and_readers_load_no_jax():
    body = "\n".join(
        ["import harness.common, harness.context, harness.readers, harness.result",
         "import harness.trace, harness.traffic, harness.weights",
         "import counts.kernels, counts.model_flops, counts.peaks"]
        + [f"load_module(Path({str(p)!r}), 'm{i}')"
           for i, p in enumerate(sorted((tiny.BENCH / "drivers").glob("*.py"))
                                 + sorted((tiny.BENCH / "metrics").glob("*.py")))]
        + ["import run"])
    mods = _top_level(body)
    assert not mods & set(JAX), sorted(mods & set(JAX))


def test_a_driven_program_loads_no_jax():
    body = ("d = load_module(Path({!r}), 'd')\n"
            "import seamless_communication_torch.inference.serving\n"
            "import seamless_communication_torch.streaming.multi\n"
            "d.raw_weights\n").format(str(tiny.BENCH / "drivers" / "serve.py"))
    mods = _top_level(body)
    assert "seamless_communication_torch" in mods
    assert not mods & set(JAX), sorted(mods & set(JAX))


@pytest.mark.parametrize("module", ["reference.serve_check", "reference.stream_check",
                                    "reference.fbank", "reference.nn",
                                    "reference.speech_encoder", "reference.nllb_decoder",
                                    "reference.monotonic"])
def test_reference_loads_neither_jax_nor_the_program(module):
    mods = _top_level(f"import {module}")
    assert not mods & set(JAX + ("seamless_communication_torch",))
