"""The kernel build's cache key (``ops/kernels/build.py``): a library is named
by a hash of its ``.cu`` source, every local header that source includes and
the flags, so an edited header rebuilds the libraries that include it and
none other. Runs on the CPU: nothing is compiled."""

import shutil

import pytest

from seamless_communication_torch.ops.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the build reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, copy)
    monkeypatch.setattr(build, "CSRC_DIR", copy)
    return copy


def test_header_edit_changes_the_library_path(csrc):
    """Editing ``hopper.cuh`` renames the libraries of the six sources that
    include it, directly (K6; K6b, K6c; K3b) or through
    ``decode_attention.cuh`` (K1, K2, K5), and leaves the others' names as
    they were."""
    names = build.kernel_sources()
    before = {n: build.library_path(n) for n in names}
    including = {n for n in names
                 if csrc / "hopper.cuh" in build._sources(csrc / f"{n}.cu", [])}
    assert including == {"flash_attention", "flash_attention_bwd", "vocab_topk",
                         "decode_attention", "decode_attention_int4",
                         "decode_attention_indexed"}
    header = csrc / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: build.library_path(n) for n in names}
    assert {n for n in names if after[n] != before[n]} == including
    # a header included by a header counts too
    (csrc / "inner.cuh").write_text("// v1\n")
    header.write_bytes(header.read_bytes() + b'#include "inner.cuh"\n')
    nested = build.library_path("flash_attention")
    (csrc / "inner.cuh").write_text("// v2\n")
    assert build.library_path("flash_attention") != nested


def test_kernel_sources_lists_the_cu_files_only(csrc):
    """A header is no kernel source: ``kernel_sources()`` (what ``build()``
    compiles, one ``nvcc`` each) lists the ``.cu`` files alone."""
    (csrc / "extra.cuh").write_text("// a header\n")
    names = build.kernel_sources()
    assert names == sorted(p.stem for p in csrc.glob("*.cu"))
    assert "hopper" not in names and "extra" not in names
    assert {"flash_attention", "flash_attention_bwd"} <= set(names)
