"""The port's kernel build helpers, on the CPU: the key of a build, and
the readers of nvcc's ptxas log and of ``cuobjdump -sass`` output that
``chip_smoke.py`` prints (registers, spills, shared memory, tensor-core
instructions). The builds themselves run on the card's machine only."""
import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19gmm_wgmmaE14CUtensorMap_stS0_P13__nv_bfloat16iii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19gmm_wgmmaE14CUtensorMap_stS0_P13__nv_bfloat16iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 64 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_18gmm_tileIfEEvPKT_S3_PS1_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_18gmm_tileIfEEvPKT_S3_PS1_iii
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
"""

SASS = """\
	code for sm_90a
		Function : _ZN12_GLOBAL__N_19gmm_wgmmaE14CUtensorMap_stS0_P13__nv_bfloat16iii
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                         /* 0x00000a00ff017b82 */
        /*0450*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4].tnspB, R24 ;  /* 0x0000000418187df0 */
        /*0460*/              @UP0 HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8].tnspB, R24, gsb0 ;  /* 0x0000000818187df0 */
        /*0470*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;               /* 0x00000000000079af */
		..........
		Function : _ZN12_GLOBAL__N_18gmm_tileIfEEvPKT_S3_PS1_iii
        /*0000*/                   FFMA R4, R5, R6, R4 ;                          /* 0x0000000605047223 */
        /*0010*/                   HMMA.16816.F32.BF16 R8, R12, R16, R8 ;        /* 0x000000100c08723c */
"""


def test_resources_reads_each_kernel_of_a_ptxas_log():
    got = build.resources(PTXAS_LOG)
    assert [r["kernel"].split("N_1")[1][:10] for r in got] == \
        ["9gmm_wgmma", "8gmm_tileI"]
    assert got[0] == {"kernel": got[0]["kernel"], "registers": 90,
                      "spill_stores": 0, "spill_loads": 0, "smem": 64}
    assert (got[1]["registers"], got[1]["spill_stores"],
            got[1]["spill_loads"], got[1]["smem"]) == (255, 12, 16, 0)
    assert build.resources("") == []


@pytest.mark.parametrize("opcode,want", [("HGMMA", (2, 0)),
                                         ("HMMA", (0, 1)),
                                         ("FFMA", (0, 1))])
def test_count_opcodes_counts_instructions_per_function(opcode, want):
    counts = build.count_opcodes(SASS, opcode)
    assert tuple(counts.values()) == want
    assert all(k.startswith("_ZN12_GLOBAL__N_1") for k in counts)


def test_build_key_covers_the_shared_headers(tmp_path, monkeypatch):
    """Editing a shared header (hopper.cuh, common.cuh) gives every
    kernel a new library, so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    assert (csrc / "hopper.cuh").exists()
    before = {n: build.library_path(n) for n in ("moe_gmm", "rmsnorm")}
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: build.library_path(n) for n in ("moe_gmm", "rmsnorm")}
    assert all(before[n] != after[n] for n in before)
    assert all(after[n].name.startswith(f"lib{n}_") for n in after)


# every kernel the port builds: the five TPU kernels' counterparts and
# the scorer's dense and head layers
SOURCES = ("conv_scorer", "rmsnorm", "flash_attention", "decode_attention",
           "moe_gmm", "scorer_head", "flash_attention_bwd")


@pytest.mark.parametrize("name", SOURCES)
def test_each_kernel_source_has_its_own_build(name):
    """Each source builds into its own library under ``BUILD_DIR``, named
    after it and keyed by its text: the seven keys differ."""
    assert build.source(name).exists()
    path = build.library_path(name)
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith(f"lib{name}_") and path.suffix == ".so"
    assert len({build.library_path(n) for n in SOURCES}) == len(SOURCES)
    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == sorted(SOURCES)
