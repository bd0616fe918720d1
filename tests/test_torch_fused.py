"""The port's fused round and ``cuda_fused`` backend against ``repro``.

``fused_round`` takes its plain version on CPU tensors, the decomposed
``_detect_part`` → zero losers → ``_recolor_part`` round of the
``reference`` backend; that is held exactly against ``repro``'s Pallas
``fused_round`` in interpret mode, part by part.  The ``cuda_fused``
backend's rounds are held against the decomposed ones here, and
``d1_2gl``, which every kernel backend runs as decomposed rounds, against
``repro``'s simulate engine in every field; ``test_torch_distributed.py``
holds ``cuda_fused`` d1 end to end, and ``test_torch_d2.py`` d2 and pd2.  The
CUDA kernel itself is held to the plain version on a card by
``test_torch_kernels_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as j_dist
from repro.graph import generators as j_gen
from repro.graph.partition import partition_graph as j_partition
from repro.kernels import ops as j_ops
from repro_torch.core import distributed as t_dist
from repro_torch.core.backend import (
    BACKENDS, CudaBackend, CudaFusedBackend, ReferenceBackend, get_backend,
)
from repro_torch.core.validate import is_proper_d1
from repro_torch.graph import generators as t_gen
from repro_torch.graph.partition import partition_graph as t_partition
from repro_torch.kernels.fused_round import fused_round, fused_round_ref
from repro_torch.launch import color as t_cli
from test_torch_d2 import GRAPHS, _graphs
from test_torch_distributed import assert_same_result

ROUND_KEYS = ("adj_cidx", "deg_tab", "gid_tab", "is_boundary")


def _round_state(problem, seed=3, parts=3):
    """Every part of tests/test_kernels.py::_part0_state: a real partitioned
    graph's device state and random colors and ghost colors."""
    g = (j_gen.bipartite_random(70, 35, 3, seed=seed) if problem == "pd2"
         else j_gen.rmat(7, 5, seed=seed))
    pg = j_partition(g, parts, strategy="edge_balanced",
                     second_layer=problem != "d1")
    st = j_dist.build_device_state(pg, problem)
    rng = np.random.default_rng(seed + 1)
    colors = rng.integers(0, 7, (parts, pg.n_local)).astype(np.int32)
    ghost = rng.integers(0, 7, (parts, pg.n_ghost)).astype(np.int32)
    return st, colors, ghost


@pytest.mark.parametrize("problem", ["d1", "d2", "pd2"])
@pytest.mark.parametrize("parts", [1, 3])
def test_fused_round_plain_matches_pallas(problem, parts):
    st, colors, ghost = _round_state(problem, parts=parts)
    if parts == 1:
        assert ghost.shape == (1, 1)            # the one pad ghost slot
    th = st.get("two_hop_cidx")
    args = [torch.from_numpy(st[k]) for k in ROUND_KEYS]
    got = fused_round(args[0], torch.from_numpy(colors), torch.from_numpy(ghost),
                      *args[1:], None if th is None else torch.from_numpy(th),
                      problem=problem)
    for a, b in zip(got, fused_round_ref(args[0], torch.from_numpy(colors),
                                         torch.from_numpy(ghost), *args[1:],
                                         None if th is None else torch.from_numpy(th),
                                         problem=problem)):
        assert torch.equal(a, b)
    assert [x.dtype for x in got] == [torch.int32, torch.bool, torch.bool, torch.int32]
    for p in range(parts):
        want = j_ops.fused_round(
            jnp.asarray(st["adj_cidx"][p]), jnp.asarray(colors[p]),
            jnp.asarray(ghost[p]), jnp.asarray(st["deg_tab"][p]),
            jnp.asarray(st["gid_tab"][p]), jnp.asarray(st["is_boundary"][p]),
            two_hop_cidx=None if th is None else jnp.asarray(th[p]),
            problem=problem, tile=64)
        for name, a, b in zip(("colors", "lose_v", "lose_ghost", "count"), got, want):
            np.testing.assert_array_equal(a[p].numpy(), np.asarray(b),
                                          err_msg=f"{problem}/{name}")
    if parts == 3:
        assert int(got[3].sum()) > 0 and got[1].any()


@pytest.mark.parametrize("problem", ["d1", "d2", "pd2"])
def test_fused_backend_round_matches_decomposed(problem):
    st_np, colors, ghost = _round_state(problem, seed=5)
    st = t_dist.state_to_torch(st_np, "cpu")
    c, g = torch.from_numpy(colors), torch.from_numpy(ghost)
    kw = dict(problem=problem, recolor_degrees=True)
    want = ReferenceBackend().round(st, c, g, **kw)
    for backend in (CudaBackend(), CudaFusedBackend()):
        for a, b in zip(backend.round(st, c, g, **kw), want):
            assert torch.equal(a, b)


def test_fused_round_refuses_what_it_cannot_run():
    st, colors, ghost = _round_state("d1")
    args = [torch.from_numpy(st[k]) for k in ROUND_KEYS]
    c, g = torch.from_numpy(colors), torch.from_numpy(ghost)
    with pytest.raises(ValueError, match="d1_2gl"):
        fused_round(args[0], c, g, *args[1:], problem="d1_2gl")
    with pytest.raises(ValueError, match="requires two_hop_cidx"):
        fused_round(args[0], c, g, *args[1:], problem="d2")


@pytest.mark.parametrize("gname", list(GRAPHS))
@pytest.mark.parametrize("parts", [1, 3, 8])
def test_d1_2gl_matches_simulate(gname, parts):
    jg, tg = _graphs(GRAPHS[gname])
    kw = dict(strategy="edge_balanced", second_layer=True)
    jpg, tpg = j_partition(jg, parts, **kw), t_partition(tg, parts, **kw)
    want = j_dist.color_distributed(jpg, problem="d1_2gl", engine="simulate",
                                    cache=False)
    for backend in ("reference", "cuda", "cuda_fused"):
        got = t_dist.color_distributed(tpg, problem="d1_2gl", backend=backend,
                                       device="cpu")
        assert (got.backend, got.problem) == (backend, "d1_2gl")
        assert_same_result(got, want)
        assert got.converged and is_proper_d1(tg, got.colors)


def test_backend_registry():
    assert BACKENDS.names() == ["cuda", "cuda_fused", "reference"]
    assert isinstance(get_backend("cuda_fused"), CudaFusedBackend)
    assert isinstance(get_backend("cuda_fused"), CudaBackend)


@pytest.mark.parametrize("problem,graph,want_bytes", [
    ("d1", "hex:8,6,6", "[864, 864]"),
    ("d2", "hex:8,6,6", "[1152, 1152, 1152, 1152]"),
    ("pd2", "bip:120,60,3", "[720, 720, 720, 720, 720]"),
    ("d1_2gl", "hex:8,6,6", "[1152, 1152]"),
])
def test_cli_problems_on_cpu(capsys, problem, graph, want_bytes):
    t_cli.main(["--graph", graph, "--parts", "3", "--device", "cpu",
                "--backend", "cuda_fused", "--problem", problem, "--repeat", "2"])
    out = capsys.readouterr().out
    assert f"[color] {problem} parts=3 backend=cuda_fused" in out
    assert "proper=True" in out and "repeat=2" in out
    assert f"comm_bytes_by_round={want_bytes}" in out
