"""The port's own copies of the numpy graph layer against ``repro``'s.

``repro_torch`` keeps its own copies of ``graph/*``, ``core/validate.py``,
``core/registry.py`` and ``build_device_state`` (it imports nothing of
``repro``).  These tests hold every array they produce byte-equal, dtype
included, to the reference package on the same inputs.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import registry as j_registry
from repro.core import validate as j_validate
from repro.core.distributed import build_device_state as j_build_state
from repro.graph import csr as j_csr
from repro.graph import generators as j_gen
from repro.graph import partition as j_part
from repro_torch.core import registry as t_registry
from repro_torch.core import validate as t_validate
from repro_torch.core.distributed import build_device_state as t_build_state
from repro_torch.core.distributed import state_to_torch
from repro_torch.graph import csr as t_csr
from repro_torch.graph import generators as t_gen
from repro_torch.graph import partition as t_part

# The graphs of tests/test_coloring.py::GRAPHS, as (generator, args, kwargs).
GRAPHS = {
    "hex": ("hex_mesh", (8, 6, 6), {}),
    "grid": ("grid_2d", (20, 20), {}),
    "rmat": ("rmat", (8, 6), {"seed": 3}),
    "myc": ("mycielskian", (8,), {}),
}
MORE_GRAPHS = {
    "rgg": ("random_geometric", (300, 0.1), {"seed": 2}),
    "er": ("erdos_renyi", (200, 6.0), {"seed": 4}),
    "bip": ("bipartite_random", (40, 30, 3), {"seed": 1}),
    # hex_mesh writes its CSR directly, repro's builds it from the edge list:
    # degenerate axes included.
    **{"hex_" + "x".join(map(str, shape)): ("hex_mesh", shape, {})
       for shape in [(1, 1, 1), (1, 1, 5), (1, 4, 1), (3, 1, 1), (2, 3, 1), (5, 1, 4),
                     (7, 3, 2), (24, 8, 8), (32, 32, 32)]},
}


def _pair(spec):
    fn, args, kw = spec
    return getattr(j_gen, fn)(*args, **kw), getattr(t_gen, fn)(*args, **kw)


def assert_bytes_equal(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("gname", list(GRAPHS) + list(MORE_GRAPHS))
def test_generators_byte_equal(gname):
    jg, tg = _pair({**GRAPHS, **MORE_GRAPHS}[gname])
    assert (jg.n, jg.name) == (tg.n, tg.name)
    assert_bytes_equal(jg.offsets, tg.offsets, "offsets")
    assert_bytes_equal(jg.targets, tg.targets, "targets")
    assert_bytes_equal(j_csr.to_ell(jg), t_csr.to_ell(tg), "ell")


@pytest.mark.parametrize("gname", list(GRAPHS))
@pytest.mark.parametrize("parts", [1, 3, 8])
@pytest.mark.parametrize("second_layer", [False, True])
def test_partition_and_device_state_byte_equal(gname, parts, second_layer):
    jg, tg = _pair(GRAPHS[gname])
    jp = j_part.partition_graph(jg, parts, strategy="edge_balanced",
                                second_layer=second_layer)
    tp = t_part.partition_graph(tg, parts, strategy="edge_balanced",
                                second_layer=second_layer)
    for f in dataclasses.fields(jp):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert_bytes_equal(a, b, f.name)
        else:
            assert a == b, f.name
    assert jp.signature == tp.signature
    problems = ("d1", "d1_2gl", "d2", "pd2") if second_layer else ("d1",)
    for problem in problems:
        js, ts = j_build_state(jp, problem), t_build_state(tp, problem)
        assert sorted(js) == sorted(ts)
        for k in js:
            assert_bytes_equal(js[k], ts[k], f"{problem}:{k}")


def test_two_level_partition_byte_equal():
    jg, tg = _pair(GRAPHS["rmat"])
    jp = j_part.two_level_partition(jg, 2, 3)
    tp = t_part.two_level_partition(tg, 2, 3)
    assert jp.signature == tp.signature


def test_state_to_torch_keeps_values_and_dtypes():
    _, tg = _pair(GRAPHS["hex"])
    st = t_build_state(t_part.partition_graph(tg, 3), "d1")
    tt = state_to_torch(st, "cpu")
    for k, v in st.items():
        assert tt[k].dtype == {np.dtype(np.int32): torch.int32,
                               np.dtype(bool): torch.bool}[v.dtype], k
        assert_bytes_equal(v, tt[k].numpy(), k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_validators_match(seed):
    jg, tg = _pair(GRAPHS["rmat"])
    rng = np.random.default_rng(seed)
    for colors in (rng.integers(0, 4, jg.n).astype(np.int32),
                   np.arange(1, jg.n + 1, dtype=np.int32)):
        for name in ("is_proper_d1", "is_proper_d2", "is_proper_pd2",
                     "count_conflicts_d1"):
            assert (getattr(j_validate, name)(jg, colors)
                    == getattr(t_validate, name)(tg, colors)), name
        assert j_validate.num_colors(colors) == t_validate.num_colors(colors)
        assert j_validate.is_balanced(colors) == t_validate.is_balanced(colors)
        assert_bytes_equal(j_validate.color_histogram(colors),
                           t_validate.color_histogram(colors))


def test_registry_copy_behaves_the_same():
    regs = [mod.Registry("thing", {"a": int}, instantiate=True, default="a")
            for mod in (j_registry, t_registry)]
    for reg in regs:
        assert reg.names() == ["a"] and reg.resolve(None) == 0
        with pytest.raises(ValueError, match="unknown thing 'zz'; registered: \\['a'\\]"):
            reg.resolve("zz")
        with pytest.raises(TypeError):
            reg.register("", int)
