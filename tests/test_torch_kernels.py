"""repro_torch.kernels on the CPU: the plain versions against the reference
package's Pallas kernels (interpret mode through ``ops``) and oracles, the
argument checks, the cost helpers, and the wrappers' dispatch.

The CUDA kernels themselves only run on a card; ``chip_smoke.py`` holds them
against these plain versions there.

Tolerances (the reference's own, tests/test_kernels.py): vai rtol=atol=2e-4
on normal inputs, because a fused multiply-add rounds once where multiply
then add rounds twice; membw rtol 1e-5 / atol 1e-4, because the order of
the sum differs. Integer-valued inputs are exact in every order, so there
the outputs must be equal bit for bit."""
import shutil

import jax  # noqa: F401  (the reference's kernels; JAX stays on the CPU)
import numpy as np
import pytest
import torch

from repro.kernels import membw_bytes as ref_membw_bytes
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels import vai_flops_bytes as ref_vai_flops_bytes
from repro_torch.kernels import build, membw_bytes, ops, ref, vai_flops_bytes
from repro_torch.kernels import membw as mb
from repro_torch.kernels import vai as vai_mod


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ints(seed, hi, *shape):
    return np.random.default_rng(seed).integers(0, hi, size=shape).astype(
        np.float32)


@pytest.mark.parametrize("rows,block_rows", [(128, 128), (512, 256),
                                             (1024, 128)])
@pytest.mark.parametrize("loopsize", [0, 1, 2, 8, 32])
def test_vai_plain_matches_reference_kernel(rows, block_rows, loopsize):
    a, b, c = (_normal(rows + loopsize + i, rows, 128) for i in range(3))
    got = ops.vai_op(*(torch.from_numpy(x) for x in (a, b, c)),
                     loopsize=loopsize, block_rows=block_rows).numpy()
    kernel = np.asarray(ref_ops.vai_op(a, b, c, loopsize=loopsize,
                                       block_rows=block_rows))
    oracle = np.asarray(ref_ref.vai_ref(a, b, c, loopsize))
    np.testing.assert_allclose(got, kernel, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)
    ours = ref.vai_ref(*(torch.from_numpy(x) for x in (a, b, c)),
                       loopsize).numpy()
    np.testing.assert_allclose(ours, oracle, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("loopsize", [0, 1, 8, 64])
def test_vai_plain_integer_inputs_exact(loopsize):
    a, b, c = (_ints(7 + i, 5, 256, 128) for i in range(3))
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    got = vai_mod.vai(ta, tb, tc, loopsize=loopsize, block_rows=64).numpy()
    kernel = np.asarray(ref_ops.vai_op(a, b, c, loopsize=loopsize,
                                       block_rows=64))
    assert np.array_equal(got, kernel)
    assert np.array_equal(got, ref.vai_ref(ta, tb, tc, loopsize).numpy())
    assert np.array_equal(got, np.asarray(ref_ref.vai_ref(a, b, c, loopsize)))


@pytest.mark.parametrize("n_chunks,chunk_rows,n_iters",
                         [(4, 64, 9), (8, 32, 16), (2, 256, 5)])
def test_membw_plain_matches_reference_kernel(n_chunks, chunk_rows, n_iters):
    x = _normal(n_chunks, n_chunks * chunk_rows, 128)
    got = ops.membw_op(torch.from_numpy(x), n_chunks=n_chunks,
                       n_iters=n_iters).numpy()
    kernel = np.asarray(ref_ops.membw_op(x, n_chunks=n_chunks,
                                         n_iters=n_iters))
    oracle = np.asarray(ref_ref.membw_ref(x, n_chunks, n_iters))
    assert got.shape == (n_iters, 128)
    np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-4)
    ours = ref.membw_ref(torch.from_numpy(x), n_chunks, n_iters).numpy()
    np.testing.assert_allclose(ours, oracle, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n_chunks", [1, 2, 8])
def test_membw_plain_integer_inputs_exact(n_chunks):
    x = _ints(3, 4, 2048, 128)
    got = mb.membw(torch.from_numpy(x), n_chunks=n_chunks, n_iters=11).numpy()
    kernel = np.asarray(ref_ops.membw_op(x, n_chunks=n_chunks, n_iters=11))
    assert np.array_equal(got, kernel)
    assert np.array_equal(got, np.asarray(ref_ref.membw_ref(x, n_chunks, 11)))


def test_vai_rejects_bad_args_like_the_reference():
    from repro.kernels.vai import vai as ref_vai
    x = np.ones((256, 128), dtype=np.float32)
    t = torch.from_numpy(x)
    for kwargs, match in ((dict(loopsize=-1), "loopsize"),
                          (dict(loopsize=2.5), "ints"),
                          (dict(loopsize=1, block_rows=0), "block_rows"),
                          (dict(loopsize=1, block_rows=100),
                           "does not tile")):
        with pytest.raises(ValueError, match=match) as ours:
            vai_mod.vai(t, t, t, **kwargs)
        with pytest.raises(ValueError, match=match) as theirs:
            ref_vai(x, x, x, **kwargs)
        assert str(ours.value) == str(theirs.value)
    # block_rows larger than the input clamps to it, as in the reference
    assert torch.equal(vai_mod.vai(t, t, t, loopsize=1, block_rows=1024),
                       torch.full((256, 128), 2.0))


def test_wrappers_reject_what_the_kernels_do_not_take():
    t = torch.ones((256, 128))
    with pytest.raises(ValueError, match="float32"):
        vai_mod.vai(t.double(), t.double(), t.double(), loopsize=1)
    with pytest.raises(ValueError, match="shape"):
        vai_mod.vai(t, t[:128], t, loopsize=1)
    with pytest.raises(ValueError, match="contiguous"):
        vai_mod.vai(t.t().contiguous().t(), t, t, loopsize=1)
    with pytest.raises(ValueError, match="does not divide"):
        mb.membw(t, n_chunks=3, n_iters=4)
    with pytest.raises(ValueError, match="positive"):
        mb.membw(t, n_chunks=0, n_iters=4)
    with pytest.raises(ValueError, match="float32"):
        mb.membw(t.double(), n_chunks=2, n_iters=4)
    with pytest.raises(ValueError, match="rows, 128"):
        mb.membw(torch.ones((256, 64)), n_chunks=2, n_iters=4)


@pytest.mark.parametrize("n,loopsize", [(1024, 0), (1024, 8), (1 << 28, 0),
                                        (1 << 28, 8192), (4096, 1)])
def test_cost_helpers_equal_the_reference(n, loopsize):
    assert vai_flops_bytes(n, loopsize) == ref_vai_flops_bytes(n, loopsize)
    assert membw_bytes(n, loopsize + 1) == ref_membw_bytes(n, loopsize + 1)


def test_cost_helpers_values_and_package_namespace():
    assert vai_flops_bytes(1024, 0) == (0, 2 * 1024 * 4)
    assert vai_flops_bytes(1024, 8) == (2 * 8 * 1024, 4 * 1024 * 4)
    assert membw_bytes(512, 4) == 2048
    import types

    import repro_torch.kernels as pkg
    assert isinstance(pkg.vai, types.ModuleType)
    assert isinstance(pkg.membw, types.ModuleType)


def test_non_cpu_tensor_never_reaches_the_plain_version(monkeypatch):
    """Dispatch: only a CPU tensor takes the plain version. A tensor on any
    other device goes to the launch path (stubbed here: this host has no
    card), and the real launch path raises for what is not a CUDA tensor
    instead of computing the result some other way."""
    def forbidden(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    meta = torch.empty((256, 128), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        vai_mod.vai(meta, meta, meta, loopsize=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mb.membw(meta, n_chunks=2, n_iters=4)

    calls = []
    monkeypatch.setattr(vai_mod, "vai_plain", forbidden)
    monkeypatch.setattr(mb, "membw_plain", forbidden)
    monkeypatch.setattr(vai_mod, "_launch",
                        lambda a, b, c, L, br: calls.append(("vai", L, br)))
    monkeypatch.setattr(mb, "_launch",
                        lambda x, n, it: calls.append(("membw", n, it)))
    vai_mod.vai(meta, meta, meta, loopsize=3, block_rows=1024)
    mb.membw(meta, n_chunks=2, n_iters=4)
    assert calls == [("vai", 3, 256), ("membw", 2, 4)]


def test_launch_counters_count_only_launches():
    ops.reset_launch_counts()
    t = torch.ones((128, 128))
    ops.vai_op(t, t, t, loopsize=2)
    ops.membw_op(t, n_chunks=1, n_iters=2)
    assert ops.launch_counts() == {"vai": 0, "membw": 0,
                                   "flash_attention": 0}
    assert not vai_mod.LAUNCHES_BY_SHAPE
    vai_mod.LAUNCHES_BY_SHAPE[(8, 256)] += 3
    ops.reset_launch_counts()
    assert not vai_mod.LAUNCHES_BY_SHAPE


def test_build_raises_where_there_is_no_compiler(monkeypatch, tmp_path):
    """No nvcc, no kernels: the build raises and nothing stands in."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if shutil.which("nvcc") or (build.Path("/usr/local/cuda/bin/nvcc")
                                .exists()):
        pytest.skip("this host has nvcc")
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(build.KernelCompileError, match="nvcc not found"):
        build.load_library()
    probe = tmp_path / "probe.cu"
    probe.write_text("// a stand-alone probe\n")
    with pytest.raises(build.KernelCompileError, match="nvcc not found"):
        build.build_probe(probe)
    assert [s.name for s in build.sources()] == [
        "flash_attention.cu", "flash_attention_f32_chunked.cu",
        "flash_attention_f32_mid.cu", "flash_attention_f32_wide.cu",
        "flash_attention_sm90.cu", "flash_attention_sm90_chunked.cu",
        "flash_attention_sm90_f16.cu", "flash_attention_sm90_f16_wide.cu",
        "flash_attention_sm90_wide.cu",
        "membw.cu", "vai.cu"]
    # the flash kernels' headers, each included by the sources that build
    # its instantiations, are hashed into the library's name with them
    assert [h.name for h in build.headers()] == [
        "flash_attention_f32.cuh", "flash_attention_sm90.cuh"]
    assert build.library_path() != build.build_dir() / (
        f"librepro_torch_kernels_{build._digest(build.sources())}.so")


@pytest.mark.parametrize("chunk_rows,n_iters", [
    (8, 1), (64, 9), (2048, 64), (65536, 64), (1 << 21, 64), (1000, 7),
    (1 << 21, 100000)])
def test_membw_slicing_covers_the_chunk(chunk_rows, n_iters):
    rows_per_slice, n_slices = mb.slicing(chunk_rows, n_iters)
    assert rows_per_slice % 8 == 0
    assert mb.MIN_SLICE_ROWS <= rows_per_slice <= mb.MAX_SLICE_ROWS
    assert n_slices * rows_per_slice >= chunk_rows
    assert (n_slices - 1) * rows_per_slice < chunk_rows
    assert mb.slicing(chunk_rows, n_iters) == (rows_per_slice, n_slices)


def _sass(*instructions):
    """Lines as ``cuobjdump -sass`` prints them: offset, instruction, and
    the encoding on the same line."""
    return "\n".join(
        f"        /*{16 * i:04x}*/                   {ins} ;"
        f"                  /* 0x000fe2000000000{i % 10} */"
        for i, ins in enumerate(instructions))


@pytest.mark.parametrize("instructions,want", [
    # three sources of one parity (a*b + z from three load quads)
    (["FFMA R12, R4, R8, R12"], dict(ffma=1, same_bank=1)),
    (["FFMA R13, R5, R9, R13"], dict(ffma=1, same_bank=1)),
    # mixed parity: b rotated by one component
    (["FFMA R12, R4, R9, R12", "FFMA R13, R5, R10, R13"],
     dict(ffma=2, same_bank=0)),
    # a*a + z reads two distinct registers
    (["FFMA R12, R4, R4, R12"], dict(ffma=1, same_bank=0)),
    # negated, absolute and predicated operands still read the bank
    (["@!P0 FFMA R12, -R6, |R10|, R14", "FFMA.FTZ R1, -|R3|, R5, R7"],
     dict(ffma=2, same_bank=2)),
    # .reuse is counted, and the parity is still read off the index
    (["FFMA R12, R4.reuse, R8, R12", "FFMA R14, R4, R9, R14"],
     dict(ffma=2, same_bank=1, reuse=1)),
    # constants, immediates, RZ and uniform registers are no bank reads
    (["FFMA R12, R4, c[0x0][0x160], R12", "FFMA R12, R4, 1.5, R12",
      "FFMA R12, R4, RZ, R12", "FFMA R12, R4, UR6, R12"],
     dict(ffma=4, same_bank=0)),
    # other instructions are not FFMAs; FMUL and FADD are counted apart
    (["IADD3 R2, R4, R6, R8", "LDG.E.128 R4, desc[UR4][R2.64]",
      "FMUL R2, R4, R6", "FADD.FTZ R2, R4, R6", "HFMA2 R2, R4, R6, R8",
      "DFMA R2, R4, R6, R8"],
     dict(ffma=0, fmul=1, fadd=1)),
])
def test_ffma_bank_counts_on_hand_written_sass(instructions, want):
    got = build.ffma_bank_counts(_sass(*instructions))
    assert got == {**dict(ffma=0, same_bank=0, reuse=0, fmul=0, fadd=0),
                   **want}


def test_ffma_bank_counts_ignore_headers_and_empty_text():
    assert build.ffma_bank_counts("") == dict(ffma=0, same_bank=0, reuse=0,
                                              fmul=0, fadd=0)
    text = ("Function : _ZN12_GLOBAL__N_114vai_fma_kernelILi4ELb1EEEvPK6\n"
            ".headerflags @\"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)\"\n"
            + _sass("FFMA R12, R4, R8, R12", "EXIT", "BRA 0x70"))
    assert build.ffma_bank_counts(text)["same_bank"] == 1


@pytest.mark.parametrize("rows,block_rows,legal", [
    (256, 8, True), (256, 128, True), (256, 256, True), (256, 1024, True),
    (512, 64, True), (24, 3, True), (256, 96, False), (256, 0, False),
    (256, -8, False), (200, 128, False)])
def test_vai_block_rows_rules(rows, block_rows, legal):
    """A ``block_rows`` that (after clamping to ``rows``) divides the row
    count takes the plain version on the CPU, bit for bit; any other is a
    ``ValueError`` before anything runs."""
    a, b, c = (torch.from_numpy(_ints(40 + i, 5, rows, 128))
               for i in range(3))
    if not legal:
        with pytest.raises(ValueError, match="block_rows"):
            vai_mod.vai(a, b, c, loopsize=2, block_rows=block_rows)
        return
    got = vai_mod.vai(a, b, c, loopsize=2, block_rows=block_rows)
    assert torch.equal(got, vai_mod.vai_plain(a, b, c, loopsize=2))
    assert torch.equal(got, c + 2 * a * b)


@pytest.mark.parametrize("shapes", [
    {},
    {(8, 256): 1},
    # the main path: tune() launches each candidate 5 times, run_sweep()
    # each unique loopsize once at the default block_rows
    {**{(L, br): 5 * (2 if L == 0 else 1)
        for L in (0, 1, 8, 256, 8192) for br in (128, 256, 512, 1024)},
     **{(L, 256): 5 * (2 if L == 0 else 1) + 1 for L in (0, 1, 8, 256, 8192)}},
])
def test_vai_main_path_loss_against_a_direct_count(shapes):
    """chip_smoke's cost of the main path's vai launches: launches, time and
    time beyond the bound, summed by loopsize, against the sums taken launch
    by launch."""
    import chip_smoke
    n_elems = 1 << 28
    wall = {f"block_rows={br},loopsize={L}": 0.5 + 0.013 * L + 1e-4 * br
            for L in (0, 1, 8, 256, 8192) for br in (128, 256, 512, 1024)}
    got = chip_smoke.vai_main_path_loss(wall, shapes, n_elems)
    launches = [(L, br) for (L, br), n in shapes.items() for _ in range(n)]
    assert got["launches"] == len(launches)
    assert got["seconds"] == pytest.approx(sum(
        wall[f"block_rows={br},loopsize={L}"] for L, br in launches) / 1e3)
    assert got["loss_seconds"] == pytest.approx(sum(
        wall[f"block_rows={br},loopsize={L}"]
        - chip_smoke.vai_bound_ms(n_elems, L)[0] for L, br in launches) / 1e3)
    for L in {L for L, _ in launches}:
        row = got["by_loopsize"][str(L)]
        assert row["launches"] == sum(1 for l, _ in launches if l == L)
    assert set(got["by_loopsize"]) == {str(L) for L, _ in launches}
