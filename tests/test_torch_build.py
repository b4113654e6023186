"""The CUDA build's host side, with a stand-in nvcc: one compile per library,
all started together; a content-hashed library name; a cached library is
not rebuilt; compile failures and a missing nvcc raise.  Also the backend
choice and the wrappers' operand checks, which need no card."""
import os
import stat
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

FAKE_NVCC = textwrap.dedent("""\
    #!/bin/sh
    # stand-in nvcc: writes the -o target, or fails when the source says so
    out=""; src=""
    while [ $# -gt 0 ]; do
      case "$1" in
        -o) out="$2"; shift 2 ;;
        *.cu) src="$1"; shift ;;
        *) shift ;;
      esac
    done
    if grep -q FAIL "$src"; then echo "error: forced failure"; exit 2; fi
    echo "ptxas info    : Used 8 registers"
    echo built > "$out"
    echo "$src" >> "$(dirname "$out")/compiled.log"
    """)


@pytest.fixture
def fake_cuda(tmp_path, monkeypatch):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in build.SIGNATURES:
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    return tmp_path


def _compiled(tmp_path):
    log = tmp_path / "out" / "compiled.log"
    return log.read_text().split() if log.exists() else []


def test_build_compiles_each_library_once_then_caches(fake_cuda):
    info = build.build()
    assert set(info) == set(build.SIGNATURES)
    assert not any(v["cached"] for v in info.values())
    assert all("registers" in v["log"] for v in info.values())
    for name in build.SIGNATURES:
        assert build.library_path(name).is_file()
    assert len(_compiled(fake_cuda)) == len(build.SIGNATURES)
    again = build.build()
    assert all(v["cached"] for v in again.values())
    assert len(_compiled(fake_cuda)) == len(build.SIGNATURES)
    assert not list((fake_cuda / "out").glob("*.tmp"))


def test_edited_source_gets_a_new_library(fake_cuda):
    before = build.library_path("ota")
    (build.CSRC / "ota.cu").write_text("// ota, edited\n")
    after = build.library_path("ota")
    assert before != after and after.name.startswith("libota_")
    build.build(["ota"])
    assert after.is_file() and not before.exists()


def test_edited_header_gets_a_new_library(fake_cuda):
    """A header the source includes (at any depth) is part of the hash; a
    header it does not include is not."""
    csrc = build.CSRC
    (csrc / "flash_attention.cu").write_text('#include "outer.cuh"\n')
    (csrc / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("// inner\n")
    (csrc / "unrelated.cuh").write_text("// unrelated\n")
    assert [p.name for p in build.sources("flash_attention")] == [
        "flash_attention.cu", "outer.cuh", "inner.cuh"]
    before = build.library_path("flash_attention")
    (csrc / "unrelated.cuh").write_text("// unrelated, edited\n")
    assert build.library_path("flash_attention") == before
    (csrc / "inner.cuh").write_text("// inner, edited\n")
    after = build.library_path("flash_attention")
    assert after != before and after.name.startswith("libflash_attention_")
    assert build.library_path("ota") == build.library_path("ota")


def test_flags_are_part_of_the_library_name(fake_cuda, monkeypatch):
    before = build.library_path("ota")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lcuda",))
    assert build.library_path("ota") != before


def test_failed_compile_raises_with_the_log(fake_cuda):
    (build.CSRC / "admm_update.cu").write_text("// FAIL\n")
    with pytest.raises(RuntimeError, match="forced failure"):
        build.build()
    assert not build.library_path("admm_update").exists()


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nowhere"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_nvcc_command_targets_sm90a(fake_cuda):
    cmd = build.nvcc_command("ota", build.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    for flag in ("-O3", "-shared", "-std=c++17"):
        assert flag in cmd
    assert cmd[-1].endswith(os.path.join("csrc", "ota.cu"))


def test_real_sources_declare_every_entry_point():
    for lib, fns in build.SIGNATURES.items():
        src = (build.CSRC / f"{lib}.cu").read_text()
        assert "sm_90a" in src and "device-memory bytes" in src
        for fn in fns:
            assert f'extern "C" int {fn}(' in src


@pytest.mark.parametrize("device,want", [("cpu", "torch"), ("cuda", "cuda"),
                                         ("cuda:0", "cuda"),
                                         ("meta", "torch")])
def test_resolve_backend_follows_the_device(device, want):
    assert build.resolve_backend(device) == want


def test_resolve_backend_fails_fast_on_other_devices():
    with pytest.raises(ValueError, match="no OTA backend"):
        build.resolve_backend("xpu")


def test_operand_checks_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="want cuda"):
        build.check_cuda_f32("k", a=x)
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="want cuda"):
        build.check_cuda_f32("k", a=meta)


_C_TYPES = {"int64_t": build._I64, "int": build._INT, "float": build._F32}


def _c_params(src: str, fn: str):
    """The ctypes type of each parameter of ``extern "C" int fn(...)``: a
    pointer or the stream is a pointer, else by its C type."""
    decl = src.split(f'extern "C" int {fn}(', 1)[1].split(")", 1)[0]
    out = []
    for param in decl.split(","):
        words = param.replace("*", " * ").split()
        if "*" in words or words[0] == "cudaStream_t":
            out.append(build._PTR)
        else:
            out.append(_C_TYPES[words[-2]])
    return out


@pytest.mark.parametrize("lib,fn", [(lib, fn)
                                    for lib, fns in build.SIGNATURES.items()
                                    for fn in fns])
def test_signatures_match_the_c_parameter_lists(lib, fn):
    """ctypes passes each argument as SIGNATURES declares it: the list must
    be the C entry point's, type for type (an int64 passed as an int, or a
    pointer as either, would be cut)."""
    src = (build.CSRC / f"{lib}.cu").read_text()
    assert build.SIGNATURES[lib][fn] == _c_params(src, fn)
