"""K5's backward geometry (``kernel.bwd_geometry``) and the build's hash of
included headers, on the CPU: the route, shared memory, tiles and grids
the wrapper passes to ``csrc/flash_attention_bwd.cu`` for the option
shapes of chip_smoke.py (``K5_OPTIONS``, ``K5_BWD_HD256_OPTIONS``) and
the training shapes, the constants of the source that the geometry
mirrors, and the kernel names chip_smoke.py reads from a trace."""
import re
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as fk

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

CU = _build.SOURCES["flash_attention_bwd"]

# (B, S, T, H, K, hd) of chip_smoke.py's K5_OPTIONS, then llama3.2-1b's,
# qwen2-moe-a2.7b's and recurrentgemma-2b's (its local layer) training
# shapes
SHAPES = {
    "gemma2_local_cap50": (1, 1000, 1000, 4, 2, 128),
    "gemma2_global_cap50": (1, 1000, 1000, 4, 2, 128),
    "llama_gqa4_hd64": (2, 777, 777, 8, 2, 64),
    "gqa4_hd128": (1, 777, 777, 8, 2, 128),
    "mha_hd128": (1, 500, 500, 4, 4, 128),
    "cross_unmasked": (1, 300, 77, 4, 2, 64),
    "hd96_window": (1, 200, 200, 4, 1, 96),
    "hd33_element_copies": (1, 130, 130, 4, 2, 33),
    "no_key_rows_window": (1, 100, 77, 4, 2, 16),
    "no_key_rows_causal": (1, 400, 150, 2, 1, 16),
    "llama_train": (4, 4096, 4096, 32, 8, 64),
    "qwen2_moe_train": (2, 4096, 4096, 16, 16, 128),
    "recurrentgemma_train": (2, 4096, 4096, 10, 1, 256),
}
# the dQ kernel's ring (the geometry's ``stages``) by width
WGMMA_DQ_STAGES = {64: 4, 128: 4, 256: 3}


def _geometry(shape, dtype):
    B, S, T, H, K, hd = shape
    esize = torch.empty((), dtype=dtype).element_size()
    return fk.bwd_geometry(B, S, T, H, K, hd, dtype, hd * esize % 16 == 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_geometry_covers_the_shape(name, dtype):
    B, S, T, H, K, hd = SHAPES[name]
    geo = _geometry(SHAPES[name], dtype)
    if dtype == torch.float32 or name == "hd33_element_copies":
        assert geo.route == "fma"
    else:
        assert geo.route == "wgmma"
    assert hd <= geo.hd_tile and geo.hd_tile in (64, 128, 256)
    assert max(geo.dq_smem, geo.dkdv_smem) <= fk.SMEM_LIMIT == 232_448
    if geo.route == "wgmma":
        assert min(geo.dq_smem, geo.dkdv_smem) >= fk.ONE_BLOCK_SMEM
        assert geo.threads == 384
        assert geo.stages == WGMMA_DQ_STAGES[geo.hd_tile]
    # query tiles cover S and key tiles cover T with less than a tile over
    assert (geo.n_qt - 1) * geo.dq_rows < S <= geo.n_qt * geo.dq_rows
    assert (geo.n_kt - 1) * geo.dkdv_keys < T <= geo.n_kt * geo.dkdv_keys
    assert geo.dq_blocks == geo.n_qt * H * B
    assert geo.dkdv_blocks == geo.n_kt * K * B
    assert 0 < max(geo.dq_blocks, geo.dkdv_blocks) < 2 ** 31


def test_training_shapes_take_the_wgmma_route():
    assert _geometry(SHAPES["llama_train"], torch.bfloat16) == fk.BwdGeometry(
        "wgmma", 64, 128, 64, 128, 64, 4, 384, 32, 32, 4096, 1024, 118_784,
        118_784)
    assert _geometry(SHAPES["qwen2_moe_train"],
                     torch.bfloat16) == fk.BwdGeometry(
        "wgmma", 128, 128, 64, 128, 64, 4, 384, 32, 32, 1024, 1024, 197_632,
        199_680)
    # hd 256: tiles of 32 keys in a ring of 3 for dQ, 64 keys a dK/dV
    # block (a ring of 2 in its shared memory), one wave of 128 blocks
    assert _geometry(SHAPES["recurrentgemma_train"],
                     torch.bfloat16) == fk.BwdGeometry(
        "wgmma", 256, 128, 32, 64, 64, 3, 384, 32, 64, 640, 128, 230_400,
        198_656)


@pytest.mark.parametrize("hd, vec, route", [
    (128, True, "wgmma"), (136, True, "wgmma"), (256, True, "wgmma"),
    (64, False, "fma"), (256, False, "fma")])
def test_route_by_width_and_copies(hd, vec, route):
    geo = fk.bwd_geometry(1, 256, 256, 4, 2, hd, torch.bfloat16, vec)
    assert geo.route == route
    assert geo.hd_tile == (64 if hd <= 64 else 128 if hd <= 128 else 256)
    if route == "fma":
        assert (geo.dq_rows, geo.dq_keys) == {64: (64, 64), 128: (64, 32),
                                              256: (32, 16)}[geo.hd_tile]
    else:
        assert (geo.dq_keys, geo.dkdv_keys) == {
            64: (64, 128), 128: (64, 128), 256: (32, 64)}[geo.hd_tile]


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_f32_takes_the_fma_route_at_every_width(hd):
    geo = fk.bwd_geometry(2, 4096, 4096, 10, 1, hd, torch.float32, True)
    assert (geo.route, geo.hd_tile, geo.stages, geo.threads) == (
        "fma", hd, 1, 256)


@pytest.mark.parametrize("name", sorted(chip_smoke.K5_BWD_HD256_OPTIONS))
def test_hd256_options_take_the_wgmma_kernels_of_256_columns(name):
    (B, S, T, H, K, hd), *_ = chip_smoke.K5_BWD_HD256_OPTIONS[name]
    geo = fk.bwd_geometry(B, S, T, H, K, hd, torch.bfloat16, True)
    assert (geo.route, geo.hd_tile) == ("wgmma", 256)
    assert chip_smoke.bwd_kernels(geo) == [
        "flash_attention_bwd_dkdv_wgmma_kernel<256>",
        "flash_attention_bwd_dq_wgmma_kernel<256>"]


@pytest.mark.parametrize("hd, dtype, traced", [
    (64, torch.bfloat16, "flash_attention_bwd_dq_wgmma_kernel<64>(float "
                         "const*, float*, __nv_bfloat16*)"),
    (256, torch.bfloat16, "_ZN12_GLOBAL__N_137flash_attention_bwd_dq_wgmma"
                          "_kernelILi256EEEvPKfPf"),
    (256, torch.float32, "flash_attention_bwd_dq_kernel<float, 256>(float "
                         "const*)"),
    (128, torch.float32, "_ZN12_GLOBAL__N_131flash_attention_bwd_dq_kernel"
                         "IfLi128EEEvPKT_")])
def test_trace_names_carry_the_instantiation_width(hd, dtype, traced):
    geo = fk.bwd_geometry(1, 256, 256, 4, 2, hd, dtype, True)
    m = chip_smoke.BWD_KERNEL_NAME.search(traced)
    assert f"{m[1]}<{m[2] or m[3]}>" == chip_smoke.bwd_kernels(geo)[1]


def test_geometry_mirrors_the_source_constants():
    src = CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    geo = _geometry(SHAPES["llama_train"], torch.bfloat16)
    assert (geo.dq_rows, geo.dq_keys, geo.dkdv_keys, geo.dkdv_rows,
            geo.threads) == (const("kRowsDq"), const("kKeysDq"),
                             const("kKeysDkdv"), const("kRowsDkdv"),
                             const("kWgThreads"))
    assert geo.stages == fk.WGMMA_STAGES == const("kStages")
    # hd 256: the dQ kernel's tiles and ring, the dK/dV kernel's block
    # and the ring its shared memory holds (bf16 tiles, f32 L and D)
    wide = _geometry(SHAPES["recurrentgemma_train"], torch.bfloat16)
    assert (wide.dq_rows, wide.dq_keys, wide.dkdv_keys, wide.dkdv_rows,
            wide.stages) == (const("kRowsDq"), const("kKeysDq256"),
                             const("kKeysDkdv256"), const("kRowsDkdv"),
                             const("kStagesDq256"))
    ring = const("kStagesDkdv256")
    assert wide.dq_smem == 1024 + 2 * 256 * (2 * wide.dq_rows
                                             + wide.stages * 2 * wide.dq_keys)
    assert wide.dkdv_smem == (1024 + 2 * 256 * (2 * wide.dkdv_keys + ring * 2
                                                * wide.dkdv_rows)
                              + 4 * ring * 2 * wide.dkdv_rows)
    assert fk.bwd_geometry(1, 64, 64, 1, 1, 64, torch.float32,
                           True).threads == const("kThreads")
    for hd, (bq, bk) in {64: (64, 64), 128: (64, 32), 256: (32, 16)}.items():
        assert re.search(rf"struct Tiles<{hd}> {{\s*static constexpr int "
                         rf"BQ = {bq}, BK = {bk};", src)
    # the C entry takes the geometry after the 18 arguments of a call
    assert len(fk._BWD_ARGS) == 18 + len(fk.BwdGeometry._fields)


def test_bwd_source_hashes_its_header():
    files = _build.source_files("flash_attention_bwd")
    assert [f.name for f in files] == ["flash_attention_bwd.cu",
                                       "hopper_ptx.cuh"]
    assert [f.name for f in _build.source_files("flash_attention")] == [
        "flash_attention.cu"]


def test_editing_an_included_header_renames_the_library(tmp_path,
                                                        monkeypatch):
    (tmp_path / "inc").mkdir()
    cu, top, nested = (tmp_path / "x.cu", tmp_path / "top.cuh",
                       tmp_path / "inc" / "nested.cuh")
    cu.write_text('#include <cuda_runtime.h>\n#include "top.cuh"\n'
                  '// #include "commented.cuh" is no include\nint f();\n')
    top.write_text('#pragma once\n  #  include "inc/nested.cuh"\n')
    nested.write_text("// v1\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    monkeypatch.setattr(_build, "SOURCES", {"x": cu})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.source_files("x") == [cu, top, nested]
    first = _build.library_path("x")
    assert first.parent == tmp_path / "build"
    assert first.name.startswith("libx-") and first.suffix == ".so"
    (tmp_path / "other.cuh").write_text("// edited, still not included\n")
    assert _build.library_path("x") == first
    nested.write_text("// v2\n")
    second = _build.library_path("x")
    assert second != first
    top.write_text('#pragma once\n  #  include "inc/nested.cuh"\n// x\n')
    assert _build.library_path("x") not in (first, second)
