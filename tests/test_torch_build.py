"""The port's kernel build, checked without nvcc or a card: the library's
hashed name follows every file under ``csrc/`` and the flags, and the
plain version blocks its online softmax like the kernel's kv tile."""

import re
import shutil

from bigdl_tpu_torch.ops import build
from bigdl_tpu_torch.ops import flash_attention as fa


def test_library_path_changes_with_any_file_under_csrc(tmp_path,
                                                      monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    seen = {build.library_path()}
    assert build.library_path() in seen               # deterministic
    src = csrc / build.SOURCE.name
    src.write_text(src.read_text() + "\n// edited\n")
    seen.add(build.library_path())
    header = csrc / "tiles.cuh"
    header.write_text("#pragma once\n")
    seen.add(build.library_path())
    header.write_text("#pragma once\n// edited\n")
    seen.add(build.library_path())
    header.rename(csrc / "tiles2.cuh")                 # same bytes, new name
    seen.add(build.library_path())
    assert len(seen) == 5
    assert all(p.parent == build.BUILD_DIR for p in seen)


def test_library_path_changes_with_the_flags(monkeypatch):
    before = build.library_path()
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-lineinfo"])
    assert build.library_path() != before
    assert build.build_log().name == build.library_path().stem + ".log"


def test_plain_version_blocks_like_the_kernel_kv_tile():
    text = build.SOURCE.read_text()
    found = re.search(r"constexpr int BK = (\d+);", text)
    assert found, "kv-tile constant not found in the kernel source"
    assert fa.BLOCK_K == int(found.group(1))


def test_bf16_path_runs_wgmma_on_tma_stages():
    text = "".join(f.read_text() for f in sorted(build.CSRC.iterdir()))
    assert "nvcuda" not in text and "<mma.h>" not in text
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in text
    assert "cp.async.bulk.tensor.4d" in text and "mbarrier" in text
