"""The port's kernel modules against ``repro``'s Pallas kernels and oracles.

On the CPU each wrapper takes its plain PyTorch version; those are held
exactly (integer math) against ``repro.kernels.ops`` in interpret mode and
against ``repro.kernels.ref`` on the ``tests/test_kernels.py`` shape grid,
one part at a time and stacked over three parts.  The CUDA kernels
themselves are held against the plain versions on a card by
``test_torch_kernels_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.kernels import build, check_tensor, on_cpu
from repro_torch.kernels._testing import SHAPES, random_stacked
from repro_torch.kernels.conflict import conflict_detect
from repro_torch.kernels.ops import local_color_d1_cuda
from repro_torch.kernels.vb_bit import vb_bit_assign
from test_torch_kernels_card import _t


@pytest.mark.parametrize("n,w,g", SHAPES)
@pytest.mark.parametrize("parts", [1, 3])
def test_vb_bit_plain_matches_pallas_and_ref(n, w, g, parts):
    per, (adj, tab, base, active, *_) = random_stacked(n, w, g, 60, n + parts, parts)
    got = vb_bit_assign(*_t(adj, tab[:, :n].copy(), base, active, tab))
    for p, (a, t, b, ac, *_) in enumerate(per):
        args = (jnp.asarray(a), jnp.asarray(t[:n]), jnp.asarray(b),
                jnp.asarray(ac), jnp.asarray(t))
        for want in (j_ops.vb_bit_assign(*args), j_ref.vb_bit_assign_ref(*args)):
            np.testing.assert_array_equal(got[0][p].numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(got[1][p].numpy(), np.asarray(want[1]))
    assert got[0].dtype == got[1].dtype == torch.int32


@pytest.mark.parametrize("n,w,g", SHAPES + [(40, 4, 0)])
@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("rd", [True, False])
def test_conflict_plain_matches_pallas_and_ref(n, w, g, parts, rd):
    per, (adj, tab, _, _, deg, gid, bd) = random_stacked(n, w, g, 6, n, parts)
    got = conflict_detect(*_t(adj, tab[:, :n].copy(), deg[:, :n].copy(),
                              gid[:, :n].copy(), bd, tab, deg, gid),
                          n, recolor_degrees=rd)
    assert got[2].shape == (parts,) and got[2].dtype == torch.int32
    for p, (a, t, _, _, d, gi, b) in enumerate(per):
        args = tuple(map(jnp.asarray, (a, t[:n], d[:n], gi[:n], b, t, d, gi)))
        for fn in (j_ops.conflict_detect, j_ref.conflict_detect_ref):
            want = fn(*args, n, recolor_degrees=rd)
            np.testing.assert_array_equal(got[0][p].numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(got[1][p].numpy(), np.asarray(want[1]))
            assert int(got[2][p]) == int(want[2])


@pytest.mark.parametrize("recolor_degrees", [True, False])
def test_local_color_d1_cuda_plain_matches_pallas(recolor_degrees):
    from repro.core.distributed import build_device_state
    from repro.graph.generators import rmat
    from repro.graph.partition import partition_graph

    pg = partition_graph(rmat(7, 5, seed=9), 2)
    st = build_device_state(pg, "d1")
    tab0 = np.zeros((2, pg.n_local + pg.n_ghost + 1), np.int32)
    arrays = (st["adj_cidx"], tab0, st["active0"], st["deg_tab"], st["gid_tab"])
    got = local_color_d1_cuda(*_t(*arrays), recolor_degrees=recolor_degrees)
    for p in range(2):
        want = j_ops.local_color_d1_pallas(
            *(jnp.asarray(a[p]) for a in arrays), recolor_degrees=recolor_degrees)
        np.testing.assert_array_equal(got[p].numpy(), np.asarray(want))


def test_wrappers_refuse_mixed_devices():
    _, (adj, tab, base, active, *_) = random_stacked(16, 3, 8, 6, 0, 1)
    meta = torch.empty(tab.shape, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="all lie on the CPU"):
        vb_bit_assign(*_t(adj, tab[:, :16].copy(), base, active), meta)
    assert on_cpu(*_t(adj, tab))


def test_check_tensor_rejects_bad_arguments():
    x = torch.zeros((3, 8), dtype=torch.int32)
    assert check_tensor(x, "x", torch.int32, (3, 8)) == 8
    assert check_tensor(torch.zeros((3, 10), dtype=torch.int32)[:, :8],
                        "x", torch.int32, (3, 8)) == 10
    with pytest.raises(TypeError):
        check_tensor(x.to(torch.int64), "x", torch.int32, (3, 8))
    with pytest.raises(ValueError, match="shape"):
        check_tensor(x, "x", torch.int32, (3, 9))
    with pytest.raises(ValueError, match="last axis"):
        check_tensor(x.t().contiguous().t(), "x", torch.int32, (3, 8))
    with pytest.raises(ValueError, match="contiguous"):
        check_tensor(torch.zeros((3, 10), dtype=torch.int32)[:, :8], "x",
                     torch.int32, (3, 8), contiguous=True)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "nvcc_path", lambda: None)
    monkeypatch.setenv(build.BUILD_DIR_ENV, str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def test_build_dir_is_the_checkout_or_the_env(monkeypatch, tmp_path):
    monkeypatch.delenv(build.BUILD_DIR_ENV, raising=False)
    root = build.CSRC.parents[2]
    assert (root / "pyproject.toml").is_file()
    assert build.build_dir() == root / "build"
    monkeypatch.setenv(build.BUILD_DIR_ENV, str(tmp_path))
    assert build.build_dir() == tmp_path
    # Installed outside a checkout, with no directory named: refuse.
    monkeypatch.delenv(build.BUILD_DIR_ENV)
    monkeypatch.setattr(build, "CSRC", tmp_path / "site-packages" / "repro_torch" / "csrc")
    with pytest.raises(RuntimeError, match=build.BUILD_DIR_ENV):
        build.build_dir()


def test_build_names_carry_a_source_hash():
    paths = {name: build._lib_path(name) for name in build.SOURCES}
    assert len(set(paths.values())) == len(build.SOURCES)
    for name, path in paths.items():
        assert path.parent == build.build_dir()
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
        assert (build.CSRC / f"{name}.cu").is_file()
