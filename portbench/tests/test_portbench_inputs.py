"""The inputs: deterministic in the seed, the specification's key sampler,
seeds past 32 bits, and the order of the ``search_keys`` traffic kind."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import inputs  # noqa: E402
from portbench.bench.spec import Benchmark  # noqa: E402


def _graph(seed, scale=9):
    return inputs.kronecker_edges(seed, scale, 16, 0.57, 0.19, 0.19, "cpu")


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345, 2**40 + 3])
def test_same_seed_same_edges_and_keys(seed):
    s1, d1 = _graph(seed)
    s2, d2 = _graph(seed)
    assert torch.equal(s1, s2) and torch.equal(d1, d2)
    assert s1.dtype == torch.int32 and s1.numel() == 16 << 9
    assert int(s1.min()) >= 0 and int(s1.max()) < 1 << 9
    k1 = inputs.search_keys(seed, s1, d1, 1 << 9, 16)
    k2 = inputs.search_keys(seed, s2, d2, 1 << 9, 16)
    assert torch.equal(k1, k2)


def test_other_seed_other_graph():
    s1, _ = _graph(1)
    s2, _ = _graph(2)
    assert not torch.equal(s1, s2)


def test_keys_are_distinct_with_an_edge_that_is_no_self_loop():
    n = 1 << 9
    src, dst = _graph(5)
    keys = inputs.search_keys(5, src, dst, n, 32)
    assert len(set(keys.tolist())) == 32
    loops = src == dst
    deg = (torch.bincount(src[~loops].long(), minlength=n)
           + torch.bincount(dst[~loops].long(), minlength=n))
    assert bool((deg[keys] > 0).all())
    with pytest.raises(ValueError):
        inputs.search_keys(5, src, dst, n, int((deg > 0).sum()) + 1)


def test_the_sampler_takes_every_vertex_with_an_edge_on_a_hand_made_graph():
    # 0-1-2 and 3-4 are two components; 5 has a self loop only; 6 is alone
    src = torch.tensor([0, 1, 3, 5], dtype=torch.int32)
    dst = torch.tensor([1, 2, 4, 5], dtype=torch.int32)
    keys = inputs.search_keys(11, src, dst, 8, 5)
    assert sorted(keys.tolist()) == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError):
        inputs.search_keys(11, src, dst, 8, 6)


@pytest.mark.parametrize("seed", [0, 2**31 + 9, 2**62 + 1])
def test_the_checked_graph_is_drawn_from_the_run_seed(seed):
    g = inputs.checked_graph_seed(seed)
    assert 0 <= g < 2**63
    assert g == inputs.checked_graph_seed(seed)
    assert g != inputs.checked_graph_seed(seed + 1)
    s1, _ = _graph(g)
    s2, _ = _graph(inputs.checked_graph_seed(seed + 1))
    assert not torch.equal(s1, s2)


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_the_order_is_a_permutation_fixed_by_the_seed(seed):
    kind = Benchmark(ROOT).kind("search_keys")
    order = kind.key_order(64, seed)
    assert sorted(order) == list(range(64))
    assert order == kind.key_order(64, seed)
    assert order != kind.key_order(64, seed + 1)
