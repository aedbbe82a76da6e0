"""The kernel build's library names: a library is rebuilt when its source
or any header it includes changes (``repro_torch.kernels.build``). Runs
on the CPU: it hashes files and builds nothing."""
from repro_torch.kernels import build


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
    """Both attention libraries include the Hopper helpers' header, and
    their names cover it."""
    for name in ("dense_flash", "varlen_flash"):
        files = [p.name for p in build._sources(build.SOURCES[name])]
        assert files == [f"{name}.cu", "hopper.cuh"], files
    for name in ("paged_decode", "mamba_scan"):
        assert len(build._sources(build.SOURCES[name])) == 1
