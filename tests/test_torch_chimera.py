"""Port vs reference: Chimera graphs and their slot tables, array-equal."""
import dataclasses

import numpy as np
import pytest

from repro.core import chimera as ref_chimera
from repro_torch.core import chimera as port_chimera

GRAPHS = {
    "cell_1x1": dict(rows=1, cols=1),
    "square_2x2": dict(rows=2, cols=2),
    "masked_3x3": dict(rows=3, cols=3, masked_cells=[(1, 1)]),
    "masked_3x4": dict(rows=3, cols=4, masked_cells=[(0, 3), (2, 0)]),
    "k2_2x3": dict(rows=2, cols=3, k=2),
}


def _pair(name):
    if name == "chip":
        return ref_chimera.make_chip_graph(), port_chimera.make_chip_graph()
    kw = GRAPHS[name]
    return ref_chimera.make_chimera(**kw), port_chimera.make_chimera(**kw)


NAMES = list(GRAPHS) + ["chip"]


@pytest.mark.parametrize("name", NAMES)
def test_graph_fields_equal(name):
    ref, port = _pair(name)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert ref.n_edges == port.n_edges and ref.n_cells == port.n_cells
    assert port.validate_two_coloring()


@pytest.mark.parametrize("name", NAMES)
def test_slot_tables_equal(name):
    ref, port = _pair(name)
    r_idx, r_mask = ref.neighbor_table()
    p_idx, p_mask = port.neighbor_table()
    assert r_idx.dtype == p_idx.dtype
    np.testing.assert_array_equal(r_idx, p_idx)
    np.testing.assert_array_equal(r_mask, p_mask)
    for a, b in zip(ref.edge_slots(r_idx), port.edge_slots(p_idx)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ref.adjacency(), port.adjacency())
    np.testing.assert_array_equal(ref.degree(), port.degree())
    np.testing.assert_array_equal(ref.coord_lut(), port.coord_lut())
    assert ref.edge_index() == port.edge_index()


def test_chip_graph_is_the_papers():
    g = port_chimera.make_chip_graph()
    assert g.n_nodes == 440 and g.masked_cells == ((6, 7),)
    assert g.neighbor_table()[0].shape == (6, 440)


@pytest.mark.parametrize("name", NAMES)
def test_colour_classes_are_independent_sets(name):
    """What lets the CUDA kernel update a colour in place: no node has a
    real (non-padding) slot pointing into its own colour class — also on
    masked graphs, and also after removing clamped nodes (a subset of an
    independent set is one)."""
    _, g = _pair(name)
    idx, mask = g.neighbor_table()
    same = g.color[idx] == g.color[None, :]
    assert not np.any(same & mask)
    # padding slots point at the node itself
    assert np.all(idx[~mask] == np.broadcast_to(
        np.arange(g.n_nodes), idx.shape)[~mask])
