"""The kernel build's bookkeeping, which needs no nvcc: the library's name
follows the source and the shared headers, and the compiler's report kept
beside it is read back per kernel."""

from rag_snvbert_tpu_torch.ops import _build

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__4e099c32_12_attention_cu_e93656f020attention_fwd_kernelILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfif' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__4e099c32_12_attention_cu_e93656f020attention_fwd_kernelILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers
ptxas info    : Compiling entry function '_Z15l2_partial_dotsPK13__nv_bfloat16S1_Pfiii' for 'sm_90a'
ptxas info    : Function properties for _Z15l2_partial_dotsPK13__nv_bfloat16S1_Pfiii
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 92 registers, used 1 barriers
"""


def _tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    (csrc / "h.cuh").write_text("// header\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return csrc


def test_library_name_follows_the_source_and_the_shared_headers(
        tmp_path, monkeypatch):
    csrc = _tree(tmp_path, monkeypatch)
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (csrc / "h.cuh").write_text("// header, edited\n")
    second = _build.library_path("k")
    assert second != first
    (csrc / "k.cu").write_text("// kernel, edited\n")
    assert _build.library_path("k") not in (first, second)


def test_ptxas_report_is_read_back_per_kernel(tmp_path, monkeypatch):
    _tree(tmp_path, monkeypatch)
    log = _build.library_path("k").with_suffix(".log")
    log.parent.mkdir(parents=True)
    log.write_text(PTXAS)
    assert _build.ptxas_log("k") == PTXAS
    assert _build.ptxas_entries("k") == [
        ("attention_fwd_kernel<128>", 168, 0, 0),
        ("l2_partial_dots", 92, 4, 12)]
