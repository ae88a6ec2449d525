"""The bounds of the generated-kernel caches of
tpu_olap_torch.kernels.cuda_build, held on the CPU: the bookkeeping needs
neither NVRTC nor a card."""

import os
from collections import OrderedDict

from tpu_olap_torch.kernels import cuda_build


def test_kernel_cache_keeps_the_most_recently_used(monkeypatch):
    made = []

    class Loaded:
        def __init__(self, source, name, threads, smem_bytes, device):
            made.append(source)

    monkeypatch.setattr(cuda_build, "CudaKernel", Loaded)
    monkeypatch.setattr(cuda_build, "_kernels", OrderedDict())
    monkeypatch.setattr(cuda_build, "MAX_KERNELS", 2)

    def get(src):
        return cuda_build.nvrtc_kernel(src, "k", 512, 0, 0)

    a, b = get("a"), get("b")
    assert get("a") is a            # a hit, and now the most recent
    get("c")                        # evicts b, the least recent
    assert len(cuda_build._kernels) == 2
    assert get("a") is a
    assert get("b") is not b
    assert made == ["a", "b", "c", "b"]


def test_cubin_cache_keeps_the_most_recently_used(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD", tmp_path)
    monkeypatch.setattr(cuda_build, "MAX_CUBINS", 2)
    for age, name in enumerate(("d", "c", "b", "a")):
        for suffix in (".cubin", ".log"):
            f = tmp_path / f"gen-{name}{suffix}"
            f.write_text(name)
            os.utime(f, (1e9 - age * 100, 1e9 - age * 100))
    cuda_build._prune_cubins()
    assert sorted(f.name for f in tmp_path.iterdir()) == [
        "gen-c.cubin", "gen-c.log", "gen-d.cubin", "gen-d.log"]


def test_cubin_cache_hit_needs_no_nvrtc_and_counts_as_use(tmp_path,
                                                          monkeypatch):
    """A cached cubin loads from disk with no compile, and the hit makes
    it the most recently used (pruned last)."""
    monkeypatch.setattr(cuda_build, "BUILD", tmp_path)

    def no_nvrtc():
        raise AssertionError("a cache hit must not reach NVRTC")

    monkeypatch.setattr(cuda_build, "nvrtc_library", no_nvrtc)
    cubin = tmp_path / f"gen-{cuda_build.source_hash('src')}.cubin"
    cubin.write_bytes(b"\x7fELF")
    cubin.with_suffix(".log").write_text("ptxas info : Used 30 registers")
    os.utime(cubin, (1e9, 1e9))
    got, log, ms, cached = cuda_build.nvrtc_compile("src", "k")
    assert (got, ms, cached) == (b"\x7fELF", 0.0, True)
    assert cuda_build.ptxas_report(log)["registers"] == 30
    assert cubin.stat().st_mtime > 1e9
