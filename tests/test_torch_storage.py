"""The port's storage types and in-memory engine (``nornicdb_tpu_torch.storage``)
and ``embed.queue.build_embedding_text`` against the JAX package's, on the CPU.

The same scripted operations run on a JAX ``MemoryEngine`` and on the
port's; the event sequences (kind, entity type, id and the fields the
search service reads) must be identical, and so must the reads. Pure
Python: no tolerance, everything is compared for equality.
"""

import numpy as np
import pytest

from nornicdb_tpu.embed.queue import build_embedding_text as jax_text
from nornicdb_tpu.errors import AlreadyExistsError as JaxAlreadyExists
from nornicdb_tpu.errors import NotFoundError as JaxNotFound
from nornicdb_tpu.storage import MemoryEngine as JaxEngine
from nornicdb_tpu.storage.types import Edge as JaxEdge
from nornicdb_tpu.storage.types import Node as JaxNode
from nornicdb_tpu_torch.embed.queue import build_embedding_text
from nornicdb_tpu_torch.errors import AlreadyExistsError, NotFoundError
from nornicdb_tpu_torch.storage import Edge, MemoryEngine, Node


def _event(kind, entity):
    if hasattr(entity, "start_node"):
        return (kind, "edge", entity.id, entity.start_node, entity.end_node,
                entity.type, dict(entity.properties))
    emb = None if entity.embedding is None else entity.embedding.tolist()
    return (kind, "node", entity.id, list(entity.labels),
            dict(entity.properties), emb, entity.access_count)


def _script(engine, node_cls, edge_cls, not_found, exists):
    """One fixed run of operations; returns what the reads gave."""
    rng = np.random.default_rng(7)
    reads = []
    for i in range(6):
        engine.create_node(node_cls(
            id=f"n{i}", labels=["Doc"],
            properties={"content": f"text {i}", "rank": i},
            embedding=rng.standard_normal(4).astype(np.float32)))
    with pytest.raises(exists):
        engine.create_node(node_cls(id="n0"))
    for i, (a, b) in enumerate([(0, 1), (0, 2), (1, 2), (3, 0), (4, 4)]):
        engine.create_edge(edge_cls(id=f"e{i}", start_node=f"n{a}",
                                    end_node=f"n{b}", type="RELATED_TO"))
    with pytest.raises(not_found):
        engine.create_edge(edge_cls(id="bad", start_node="n0",
                                    end_node="missing"))
    # an update of the text, a touch (access count only), an embedding drop
    n1 = engine.get_node("n1")
    n1.properties["content"] = "changed text"
    engine.update_node(n1)
    n2 = engine.get_node("n2")
    n2.access_count += 1
    engine.update_node(n2)
    n3 = engine.get_node("n3")
    n3.embedding = None
    engine.update_node(n3)
    e1 = engine.get_edge("e1")
    e1.properties["w"] = 2
    engine.update_edge(e1)
    engine.delete_edge("e2")
    engine.delete_node("n0")  # cascades e0, e1, e3
    with pytest.raises(not_found):
        engine.get_node("n0")
    with pytest.raises(not_found):
        engine.delete_node("n0")
    with pytest.raises(not_found):
        engine.update_node(node_cls(id="n0"))
    reads.append(sorted(n.id for n in engine.all_nodes()))
    reads.append(sorted(e.id for e in engine.get_outgoing_edges("n4")))
    reads.append(sorted(e.id for e in engine.get_incoming_edges("n4")))
    reads.append(sorted(e.id for e in engine.get_outgoing_edges("n1")))
    reads.append((engine.node_count(), engine.edge_count()))
    reads.append(engine.get_node("n1").properties)
    return reads


def test_event_sequence_and_reads_match_jax():
    seen = {"jax": [], "port": []}
    jax_eng, port_eng = JaxEngine(), MemoryEngine()
    jax_eng.on_event(lambda k, e: seen["jax"].append(_event(k, e)))
    port_eng.on_event(lambda k, e: seen["port"].append(_event(k, e)))
    want = _script(jax_eng, JaxNode, JaxEdge, JaxNotFound, JaxAlreadyExists)
    got = _script(port_eng, Node, Edge, NotFoundError, AlreadyExistsError)
    assert got == want
    assert seen["port"] == seen["jax"]
    kinds = [e[0] for e in seen["port"]]
    assert kinds.count("node_created") == 6
    assert kinds.count("node_updated") == 3
    assert kinds[-1] == "node_deleted"  # after its cascaded edge deletions
    assert kinds.count("edge_deleted") == 4


def test_reads_and_writes_are_copies():
    eng = MemoryEngine()
    node = Node(id="a", properties={"content": "x"},
                embedding=np.ones(3, np.float32))
    created = eng.create_node(node)
    node.properties["content"] = "mutated"
    node.embedding[0] = 9.0
    created.properties["content"] = "also mutated"
    got = eng.get_node("a")
    assert got.properties["content"] == "x" and got.embedding[0] == 1.0
    got.embedding[1] = 5.0
    assert eng.get_node("a").embedding[1] == 1.0


def test_update_keeps_created_at_and_off_event_unsubscribes():
    eng = MemoryEngine()
    events = []
    cb = lambda k, e: events.append(k)  # noqa: E731
    eng.on_event(cb)
    first = eng.create_node(Node(id="a"))
    later = eng.get_node("a")
    later.created_at = 0.0
    updated = eng.update_node(later)
    assert updated.created_at == first.created_at
    eng.off_event(cb)
    eng.off_event(cb)  # a second unsubscribe is a no-op
    eng.delete_node("a")
    assert events == ["node_created", "node_updated"]


def test_failing_listener_does_not_break_the_write():
    eng = MemoryEngine()
    seen = []

    def broken(kind, entity):
        raise RuntimeError("listener failed")

    eng.on_event(broken)
    eng.on_event(lambda k, e: seen.append(e.id))
    eng.create_node(Node(id="a"))
    assert eng.node_count() == 1 and seen == ["a"]


@pytest.mark.parametrize("props", [
    {"content": "  body  ", "title": "T"},
    {"title": "only title", "name": "", "summary": "sum"},
    {"description": "d", "text": "t", "content": "c", "name": "n"},
    {"zeta": "z", "alpha": " a ", "count": 3},
    {"count": 3, "content": 5},
    {},
])
def test_build_embedding_text_matches_jax(props):
    assert build_embedding_text(Node(properties=props)) == jax_text(
        JaxNode(properties=props))
