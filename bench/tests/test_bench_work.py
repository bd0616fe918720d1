"""``coloring_roofline_share``'s byte count, checked by hand."""
import numpy as np

from bench.reference import work
from bench.reference.coloring import Topology

# The path 0 - 1 - 2 - 3 in two parts {0, 1} and {2, 3}, two lanes a row.
PATH = np.array([[1, -1], [0, 2], [1, 3], [2, -1]], dtype=np.int32)


def test_path_graph_bytes_by_hand():
    topo = Topology(PATH, 2, "d1", second_layer=False)
    res = topo.color()
    # First pass: all 4 rows colored: adjacency 4 rows x 2 lanes x 4 B,
    # color and degree of 4 vertices x 8 B, 4 colors written x 4 B.
    # Each part's first iteration gives both its vertices color 1; the
    # degree-1 end loses and takes 2.  1 and 2 then share color 1 across
    # the cut: one round recolors the loser (color 3), one more finds none.
    assert res.rounds == 1 and res.total_conflicts == 2
    first, resolve, last = (work.pass_bytes(topo, ps) for ps in res.passes)
    assert first == 4 * 2 * 4 + 8 * 4 + 4 * 4 == 80
    # Rows 1 and 2 checked, one of them recolored; they read all 4 vertices.
    assert resolve == 2 * 2 * 4 + 8 * 4 + 4 * 1 == 52
    assert last == 2 * 2 * 4 + 8 * 4 == 48
    assert work.request_bytes(topo, res) == 180
    assert sorted(res.colors.tolist()) == [1, 2, 2, 3]


def test_distance_two_reads_the_neighbours_rows():
    topo = Topology(PATH, 1, "d2", second_layer=True)
    res = topo.color()
    assert res.rounds == 0 and len(res.passes) == 2
    # One part: every row colored; the adjacency of every row and of its
    # neighbours (all 4), color and degree of all 4; nothing checked later.
    assert work.pass_bytes(topo, res.passes[0]) == 4 * 2 * 4 + 8 * 4 + 4 * 4
    assert work.pass_bytes(topo, res.passes[1]) == 0
    assert len(set(res.colors.tolist())) == 3       # a path needs 3 at distance 2
