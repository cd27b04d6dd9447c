"""The kernel build's cache key and target, on the CPU (no nvcc needed)."""

import shutil

from pytorch_operator_tpu_torch.ops import _build


def _copy_csrc(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    return csrc


def test_target_follows_shared_header(monkeypatch, tmp_path):
    """An edited header renames both libraries (so both rebuild); touching
    nothing, or only an unrelated file, keeps the name."""
    csrc = _copy_csrc(monkeypatch, tmp_path)
    header = csrc / "flash_sm90.cuh"
    assert header.exists()
    before = {n: _build._target(n) for n in ("flash_fwd", "flash_bwd")}
    assert all(t.parent == tmp_path / "kernels" for t in before.values())
    (csrc / "notes.txt").write_text("not a source")
    assert {n: _build._target(n) for n in before} == before
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._target(n) for n in before}
    assert all(after[n] != before[n] for n in before)
    header.write_text(header.read_text().removesuffix("\n// edited\n"))
    assert {n: _build._target(n) for n in before} == before


def test_target_follows_source_only_for_its_kernel(monkeypatch, tmp_path):
    csrc = _copy_csrc(monkeypatch, tmp_path)
    fwd, bwd = _build._target("flash_fwd"), _build._target("flash_bwd")
    src = csrc / "flash_fwd.cu"
    src.write_text(src.read_text() + "\n")
    assert _build._target("flash_fwd") != fwd
    assert _build._target("flash_bwd") == bwd


def test_nvcc_flags_target_sm90a():
    """wgmma and setmaxnreg exist only for sm_90a; plain sm_90 refuses them."""
    flags = list(_build.NVCC_FLAGS)
    assert flags[flags.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
