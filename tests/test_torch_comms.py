"""The port's monitor collectives, wire codec and host partitioner against
the JAX package.

``encode_delta`` / ``decode_delta`` are held against JAX's on the same words
(every threshold; empty, full, sparse and dense inputs; corrupted triples
too).  The two-phase collectives run on virtual CPU meshes and must equal a
flat OR / min over the shards, for widths ``member`` divides and does not.
``shard_graph``, ``owner_local_of`` and ``partition_permutation`` equal
JAX's arrays.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.comms import hierarchical as jhier
from repro.core import distributed_bfs as jdist
from repro.core import faults as jfaults
from repro_torch.comms import hierarchical as hier
from repro_torch.comms.mesh import VertexComm, make_mesh
from repro_torch.core import distributed_bfs as dist
from repro_torch.core import faults

torch.set_num_threads(2)


def as_torch(words_u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(words_u32, np.uint32).view(np.int32).copy())


def word_sets(w=64):
    rng = np.random.default_rng(3)
    sparse = np.zeros(w, np.uint32)
    sparse[[0, 7, w - 1]] = [1, 0x80000000, 0x00010001]
    dense = rng.integers(0, 2**32, w, dtype=np.uint64).astype(np.uint32)
    return {"empty": np.zeros(w, np.uint32), "full": np.full(w, 0xFFFFFFFF, np.uint32),
            "sparse": sparse, "dense": dense}


# ---------------------------------------------------------------------------
# The wire codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("threshold", [None, 0, 1, 4, 40, 64, 10**6])
@pytest.mark.parametrize("kind", ["empty", "full", "sparse", "dense"])
def test_encode_decode_equal_to_jax(kind, threshold):
    words = word_sets()[kind]
    jm, jp, jc = jhier.encode_delta(jnp.asarray(words), threshold=threshold)
    m, p, c = hier.encode_delta(as_torch(words), threshold=threshold)
    assert int(m) == int(jm) and int(c) == int(jc)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    out = hier.decode_delta(m, p, c)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), words)


@pytest.mark.parametrize("fault_kw", [
    dict(site="codec", kind="payload_flip", word=1, seed=3),
    dict(site="codec", kind="payload_flip", word=0, seed=0),
    dict(site="codec", kind="trunc_count"),
    dict(site="codec", kind="wrong_mode"),
])
@pytest.mark.parametrize("kind", ["sparse", "dense", "full"])
def test_decode_of_corrupted_triples_equal_to_jax(kind, fault_kw):
    # out-of-range, negative and repeated indices decode as JAX decodes them
    words = word_sets()[kind]
    jf, tf = jfaults.FaultSpec(**fault_kw), faults.FaultSpec(**fault_kw)
    jt = jfaults.corrupt_encoded(jf, *jhier.encode_delta(jnp.asarray(words)), level=0)
    tt = faults.corrupt_encoded(tf, *hier.encode_delta(as_torch(words)), level=0)
    assert int(tt[0]) == int(jt[0]) and int(tt[2]) == int(jt[2])
    np.testing.assert_array_equal(tt[1].numpy(), np.asarray(jt[1]))
    np.testing.assert_array_equal(hier.decode_delta(*tt).numpy().view(np.uint32),
                                  np.asarray(jhier.decode_delta(*jt)))


def test_encode_rejects_non_int32():
    with pytest.raises(TypeError, match="int32"):
        hier.encode_delta(torch.zeros(4, dtype=torch.int64))


# ---------------------------------------------------------------------------
# The two-phase collectives on virtual meshes
# ---------------------------------------------------------------------------

def shard_inputs(comm, width, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    if dtype == torch.int32:
        return [torch.randint(-2**31, 2**31, (width,), generator=gen, dtype=torch.int64)
                .to(torch.int32) & torch.randint(0, 2, (width,), generator=gen,
                                                 dtype=torch.int32).neg()
                for _ in comm.local]
    return [torch.randint(0, hier.INF_U32 + 1, (width,), generator=gen, dtype=torch.int64)
            for _ in comm.local]


@pytest.mark.parametrize("width", [64, 66])
@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (2, 4), (1, 4)])
def test_two_phase_collectives_equal_flat(shape, width):
    comm = VertexComm(make_mesh(shape, ("group", "member"), device="cpu", virtual=True))
    xs = shard_inputs(comm, width, torch.int32, 5)
    flat_or = xs[0]
    for x in xs[1:]:
        flat_or = flat_or | x
    for out in (hier.hierarchical_por(comm, xs),
                hier.compressed_hierarchical_por(comm, xs),
                hier.compressed_hierarchical_por(comm, xs, threshold=3),
                hier._or_all_reduce(comm, xs, "flat")):
        assert len(out) == len(xs)
        for o in out:
            assert torch.equal(o, flat_or)
    known = [xs[0]] * len(xs)
    for o in hier.compressed_hierarchical_por(comm, xs, known=known):
        assert torch.equal(o, flat_or & ~xs[0])
    ds = shard_inputs(comm, width, torch.int64, 6)
    flat_min = torch.stack(ds).amin(0)
    for out in (hier.hierarchical_pmin(comm, ds), hier._min_all_reduce(comm, ds, "flat")):
        for o in out:
            assert torch.equal(o, flat_min)
    # the gathers reassemble the blocks in (group, member) order
    blocks = [torch.full((3,), d, dtype=torch.int32) for d in comm.local]
    want = torch.cat(blocks)
    for o in hier.hierarchical_all_gather(comm, blocks) + hier.flat_all_gather(comm, blocks):
        assert torch.equal(o, want)


def test_inter_group_drop_keeps_group_zero_on_the_receivers_it_fires_on():
    comm = VertexComm(make_mesh((2, 2), ("group", "member"), device="cpu", virtual=True))
    xs = [torch.tensor([1 << d, 16 << d], dtype=torch.int32) for d in comm.local]
    fault = faults.FaultSpec(site="inter_group", kind="drop", device=3)
    out = hier.hierarchical_por(comm, xs, fault=fault, level=0, root=0)
    # the monitor of block 1 in group 1 keeps group 0's contribution alone;
    # the delivery gather hands its block to both members of group 1
    assert out[0].tolist() == out[1].tolist() == [15, 15 * 16]
    assert out[2].tolist() == out[3].tolist() == [15, 3 * 16]
    with pytest.raises(TypeError, match="integer"):
        hier.hierarchical_por(comm, [x.float() for x in xs])


# ---------------------------------------------------------------------------
# The host partitioner
# ---------------------------------------------------------------------------

def edge_planes(scale=9):
    from repro.core import build_csr, edge_view, generate_edges
    from repro.core.bfs_steps import with_edge_weights
    ev = with_edge_weights(edge_view(build_csr(generate_edges(5, scale))), seed=2)
    return ev, tuple(np.asarray(t) for t in (ev.src, ev.dst, ev.valid, ev.weight))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("partition", ["block", "word_cyclic"])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_shard_graph_equal_to_jax(p, partition, weighted):
    ev, (src, dst, valid, weight) = edge_planes()
    w = weight if weighted else None
    want = jdist.shard_graph(src, dst, valid, ev.num_vertices, p, 16,
                             partition=partition, weight=w)
    got = dist.shard_graph(torch.tensor(src), torch.tensor(dst),
                           torch.tensor(valid), ev.num_vertices, p, 16,
                           partition=partition, weight=w, device="cpu")
    for f in ("src", "dst_local", "valid", "src_lo", "src_hi", "degree_local"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("num_vertices", "v_orig", "n_devices", "n_chunks", "chunk_size", "w_loc",
              "partition"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.n_active == int(want.n_active)
    if weighted:
        np.testing.assert_array_equal(got.weight.numpy(), np.asarray(want.weight))
    else:
        assert got.weight is None and want.weight is None


@pytest.mark.parametrize("partition", ["block", "word_cyclic"])
def test_owner_map_and_permutation_equal_to_jax(partition):
    ids = np.arange(0, 8 * 64 * 32, 7)
    for p, w_loc in ((1, 64), (4, 16), (8, 8), (3, 11)):
        o, l = dist.owner_local_of(ids, p, w_loc, partition)
        jo, jl = jdist.owner_local_of(ids, p, w_loc, partition)
        np.testing.assert_array_equal(o, jo)
        np.testing.assert_array_equal(l, jl)
        to, tl = dist.owner_local_of(torch.from_numpy(ids), p, w_loc, partition)
        np.testing.assert_array_equal(to.numpy(), jo)
        np.testing.assert_array_equal(tl.numpy(), jl)
        np.testing.assert_array_equal(dist.partition_permutation(p, w_loc, partition),
                                      jdist.partition_permutation(p, w_loc, partition))
    with pytest.raises(ValueError, match="unknown partition"):
        dist.owner_local_of(ids, 2, 4, "hash")
