"""The kernel build's library names: a library is rebuilt when its source
or any header it includes changes (``repro_torch.kernels.build``); and the
kernels' shared scratch (``repro_torch.kernels.scratch``). Runs on the
CPU: it hashes files and builds nothing."""
import torch

from repro_torch.kernels import build, scratch


def test_header_edit_changes_library_path(tmp_path, monkeypatch):
    """Editing a header two includes deep, or the source, renames the
    library; a file that is not included does not."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n#include <x.h>\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n  #  include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("// v1\n")
    (tmp_path / "other.cuh").write_text("// v1\n")
    monkeypatch.setitem(build.SOURCES, "probe", tmp_path / "k.cu")
    first = build.library_path("probe")
    assert first == build.library_path("probe")
    (tmp_path / "other.cuh").write_text("// v2\n")
    assert build.library_path("probe") == first
    (tmp_path / "g.cuh").write_text("// v2\n")
    second = build.library_path("probe")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert build.library_path("probe") not in (first, second)


def test_flash_libraries_hash_the_shared_header():
    """The two attention libraries and the Mamba2 scan include the Hopper
    helpers' one header, shared from ``kernels/csrc``, and their names
    cover it."""
    header = build.SOURCES["dense_flash"].parents[2] / "csrc" / "hopper.cuh"
    for name in ("dense_flash", "varlen_flash", "mamba_scan"):
        files = build._sources(build.SOURCES[name])
        assert [p.name for p in files] == [f"{name}.cu", "hopper.cuh"], files
        assert files[1] == header.resolve()
    assert len(build._sources(build.SOURCES["paged_decode"])) == 1


def test_stream_scratch_is_zeroed_shared_and_grows(monkeypatch):
    """One zeroed int32 buffer per (device, stream), handed to every
    kernel that asks on that stream (the varlen split counters, the scan's
    ticket and flags), replaced by a larger zeroed one when a launch needs
    more, and separate for another stream."""
    monkeypatch.setattr(scratch, "_BUFS", {})
    cpu = torch.device("cpu")
    a = scratch.stream_scratch(cpu, 7, 100)
    assert a.dtype == torch.int32 and a.numel() >= 100
    assert not a.any()
    assert scratch.stream_scratch(cpu, 7, 50) is a
    assert scratch.stream_scratch(cpu, 8, 50) is not a
    big = scratch.stream_scratch(cpu, 7, a.numel() + 1)
    assert big.numel() > a.numel() and not big.any()
    assert scratch.stream_scratch(cpu, 7, 10) is big
