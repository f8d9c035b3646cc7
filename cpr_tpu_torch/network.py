"""Network topology model + GraphML round-trip (port of
cpr_tpu/network.py).

Reference counterpart: simulator/lib/network.ml — the topology record
(nodes with compute + delay-distribution links, :3-33), constructors
symmetric_clique / two_agents / selfish_mining (:36-105), and the
GraphML round-trip used by graphml_runner and the igraph topology
studies (:115-232; experiments/simulate-topology/igraph.ml).

In the JAX package custom topologies also execute on the C++ oracle
(`simulate`); the port has no copy of the oracle yet (ROADMAP item 9),
so its `simulate` raises. The netsim engines (`cpr_tpu_torch.netsim`)
run any of these topologies on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from xml.etree import ElementTree as ET

from cpr_tpu_torch import distributions as dist


@dataclass
class Link:
    dest: int
    delay: dist.Distribution


@dataclass
class NetNode:
    compute: float
    links: list[Link] = field(default_factory=list)


@dataclass
class Network:
    nodes: list[NetNode]
    activation_delay: float = 1.0
    dissemination: str = "simple"


def symmetric_clique(n: int, *, activation_delay: float,
                     propagation_delay: float) -> Network:
    """network.ml:36-48."""
    d = dist.constant(propagation_delay)
    return Network(
        nodes=[NetNode(1.0 / n, [Link(j, d) for j in range(n) if j != i])
               for i in range(n)],
        activation_delay=activation_delay)


def two_agents(*, alpha: float, activation_delay: float) -> Network:
    """network.ml:50-59."""
    z = dist.constant(0.0)
    return Network(nodes=[NetNode(alpha, [Link(1, z)]),
                          NetNode(1.0 - alpha, [Link(0, z)])],
                   activation_delay=activation_delay)


def selfish_mining(*, alpha: float, gamma: float, defenders: int,
                   activation_delay: float,
                   propagation_delay: float) -> Network:
    """network.ml:61-105: gamma emulated by uniform attacker delays."""
    assert defenders >= 2
    d = defenders
    if gamma > (d - 1) / d:
        raise ValueError("gamma must not exceed (defenders-1)/defenders")
    g = max(gamma, 1e-6)  # see the oracle's gamma-0 note
    atk = dist.uniform(0.0, (d - 1) / d * propagation_delay / g)
    prop = dist.constant(propagation_delay)
    zero = dist.constant(0.0)
    nodes = [NetNode(alpha, [Link(j, atk) for j in range(1, d + 1)])]
    for i in range(1, d + 1):
        links = [Link(0, zero)]
        links += [Link(j, prop) for j in range(1, d + 1) if j != i]
        nodes.append(NetNode((1.0 - alpha) / d, links))
    return Network(nodes=nodes, activation_delay=activation_delay)


def random_regular(n: int, degree: int, *, activation_delay: float,
                   delay: dist.Distribution, compute=None,
                   seed: int = 0) -> Network:
    """Random connected degree-regular-ish topology — the stand-in for
    the reference's R/igraph-generated networks
    (experiments/simulate-topology/igraph.ml:1-50): a ring guarantees
    connectivity, random chords raise the degree; links are
    bidirectional."""
    import random as _random

    assert n >= 3 and degree >= 2
    rng = _random.Random(seed)
    # connected ring, normalized (a < b) so dedup sees every edge
    edges = {(min(i, (i + 1) % n), max(i, (i + 1) % n)) for i in range(n)}
    degs = [2] * n
    deficient = sum(1 for d in degs if d < degree)

    tries = 0
    while deficient > 0 and tries < n * degree * 10:
        tries += 1
        a, b = rng.randrange(n), rng.randrange(n)
        if a == b:
            continue
        e = (min(a, b), max(a, b))
        if e in edges or degs[a] >= degree or degs[b] >= degree:
            continue
        edges.add(e)
        for v in (a, b):
            degs[v] += 1
            if degs[v] == degree:
                deficient -= 1
    if compute is None:
        compute = [1.0 / n] * n
    nodes = [NetNode(c) for c in compute]
    for a, b in sorted(edges):
        nodes[a].links.append(Link(b, delay))
        nodes[b].links.append(Link(a, delay))
    # sparse graphs need relaying to converge (simulator.ml:494-507)
    return Network(nodes=nodes, activation_delay=activation_delay,
                   dissemination="flooding")


def preferential_attachment(n: int, m: int = 2, *,
                            distribution: str = "constant",
                            seed: int = 0) -> Network:
    """Barabási–Albert topology with the reference generator's node and
    edge attributes (experiments/simulate-topology/create-networks.R):
    exponential per-node solving rates normalized into compute shares,
    edge distances uniform in [1, 10], per-edge delay distribution keyed
    on the distance (constant / uniform +-50% / exponential with the
    distance as mean), flooding dissemination, and activation_delay set
    to 2x the mean compute-weighted distance (`net_bias`) so block
    intervals sit just above the expected message delay."""
    import random as _random

    assert n >= m + 1 and m >= 1
    rng = _random.Random(seed)
    # igraph sample_pa shape: grow from one vertex; each new vertex
    # attaches m edges to distinct existing vertices with probability
    # proportional to degree + 1 (zero-appeal keeps isolated targets
    # reachable)
    edges: set[tuple[int, int]] = set()
    degs = [0] * n
    for i in range(1, n):
        pool = list(range(i))
        weights = [degs[j] + 1 for j in pool]
        targets: set[int] = set()
        while len(targets) < min(m, i):
            (j,) = rng.choices(pool, weights=weights)
            targets.add(j)
        for j in targets:
            edges.add((j, i))
            degs[i] += 1
            degs[j] += 1

    rates = [rng.expovariate(1.0) for _ in range(n)]
    total = sum(rates)
    nodes = [NetNode(r / total) for r in rates]
    for a, b in sorted(edges):
        distance = rng.uniform(1.0, 10.0)
        if distribution == "constant":
            d = dist.constant(distance)
        elif distribution == "uniform":
            d = dist.uniform(0.5 * distance, 1.5 * distance)
        elif distribution == "exponential":
            d = dist.exponential(distance)
        else:
            raise ValueError(f"unknown distribution '{distribution}'")
        nodes[a].links.append(Link(b, d))
        nodes[b].links.append(Link(a, d))
    net = Network(nodes=nodes, dissemination="flooding")
    net.activation_delay = 2.0 * sum(
        s["net_bias"] for s in topology_stats(net)) / n
    return net


def topology_stats(net: Network) -> list[dict]:
    """Per-node farness / closeness / net_bias over expected link
    delays (create-networks.R:36-41): farness is the mean shortest-path
    distance to the other nodes, closeness its inverse, and net_bias
    the compute-weighted distance — the generator's measure of how far
    a node sits from the hash power."""
    import numpy as np
    from scipy.sparse.csgraph import shortest_path

    n = len(net.nodes)
    w = np.full((n, n), np.inf)
    np.fill_diagonal(w, 0.0)
    for i, nd in enumerate(net.nodes):
        for ln in nd.links:
            # scipy's dense csgraph reads 0 as "no edge" (and its
            # conversion flattens values below ~1e-8 to 0), so a
            # genuine zero-delay link (two_agents/selfish_mining) must
            # carry an epsilon — 1e-6 is six orders below real link
            # distances (1-10) yet survives the conversion
            ev = max(ln.delay.ev, 1e-6)
            w[i, ln.dest] = min(w[i, ln.dest], ev)
    d = shortest_path(w, method="D")
    compute = np.array([nd.compute for nd in net.nodes])
    out = []
    for i in range(n):
        farness = float(d[i].sum() / max(n - 1, 1))
        out.append({
            "farness": farness,
            "closeness": 1.0 / farness if farness > 0 else float("inf"),
            "net_bias": float((compute * d[i]).sum()),
        })
    return out


def write_topology_batch(outdir: str, *, count: int = 10, n: int = 13,
                         m: int = 2,
                         distributions=("constant", "uniform",
                                        "exponential"),
                         seed: int = 42) -> list[str]:
    """The create-networks.R batch: `count` preferential-attachment
    topologies per delay distribution, written as GraphML into
    `outdir` (consumed by experiments.graphml_runner / Network
    simulate)."""
    import os

    from cpr_tpu_torch.resilience import atomic_write_text

    os.makedirs(outdir, exist_ok=True)
    paths = []
    tag = {"constant": "cns", "uniform": "uni", "exponential": "exp"}
    for di, distribution in enumerate(distributions):
        for i in range(count):
            net = preferential_attachment(
                n, m, distribution=distribution,
                seed=seed + i * 31 + di * 1009)
            path = os.path.join(
                outdir, f"{i + 1:03d}-{tag[distribution]}-graphml.xml")
            atomic_write_text(path, to_graphml(net))
            paths.append(path)
    return paths


# -- GraphML round-trip ------------------------------------------------------


def to_graphml(net: Network) -> str:
    """network.ml:115-170 analog: nodes carry compute, edges carry the
    link-delay distribution string; graph data holds activation delay
    and dissemination."""
    root = ET.Element("graphml",
                      xmlns="http://graphml.graphdrawing.org/xmlns")
    for kid, name, typ, dom in [
            ("d0", "activation_delay", "double", "graph"),
            ("d1", "dissemination", "string", "graph"),
            ("d2", "compute", "double", "node"),
            ("d3", "delay", "string", "edge")]:
        el = ET.SubElement(root, "key", id=kid)
        el.set("for", dom)
        el.set("attr.name", name)
        el.set("attr.type", typ)
    graph = ET.SubElement(root, "graph", edgedefault="directed")
    ET.SubElement(graph, "data", key="d0").text = \
        repr(net.activation_delay)
    ET.SubElement(graph, "data", key="d1").text = net.dissemination
    for i, node in enumerate(net.nodes):
        el = ET.SubElement(graph, "node", id=f"n{i}")
        ET.SubElement(el, "data", key="d2").text = repr(node.compute)
    for i, node in enumerate(net.nodes):
        for link in node.links:
            el = ET.SubElement(graph, "edge", source=f"n{i}",
                               target=f"n{link.dest}")
            ET.SubElement(el, "data", key="d3").text = \
                link.delay.to_string()
    return ET.tostring(root, encoding="unicode")


def of_graphml(xml: str) -> Network:
    root = ET.fromstring(xml)

    def strip(tag):
        return tag.rsplit("}", 1)[-1]

    keys = {}
    for el in root:
        if strip(el.tag) == "key":
            keys[el.get("id")] = el.get("attr.name")
    graph = next(el for el in root if strip(el.tag) == "graph")
    undirected = graph.get("edgedefault") == "undirected"
    activation_delay, dissemination = 1.0, "simple"
    node_ids: dict[str, int] = {}
    nodes: list[NetNode] = []
    for el in graph:
        tag = strip(el.tag)
        if tag == "data":
            name = keys.get(el.get("key"))
            if name == "activation_delay":
                activation_delay = float(el.text)
            elif name == "dissemination":
                dissemination = el.text.strip()
        elif tag == "node":
            compute = 0.0
            for d in el:
                if keys.get(d.get("key")) == "compute":
                    compute = float(d.text)
            node_ids[el.get("id")] = len(nodes)
            nodes.append(NetNode(compute))
    for el in graph:
        if strip(el.tag) == "edge":
            delay = dist.constant(0.0)
            for d in el:
                if keys.get(d.get("key")) == "delay":
                    delay = dist.of_string(d.text)
            src = node_ids[el.get("source")]
            dst = node_ids[el.get("target")]
            nodes[src].links.append(Link(dst, delay))
            if undirected:
                nodes[dst].links.append(Link(src, delay))
    return Network(nodes=nodes, activation_delay=activation_delay,
                   dissemination=dissemination)


# -- execution on the oracle -------------------------------------------------


def simulate(net: Network, *, protocol: str = "nakamoto", k: int = 0,
             scheme: str = "", activations: int, seed: int = 0):
    """The JAX package runs an arbitrary topology on its C++ oracle
    here; the port has no copy of the oracle yet."""
    del net, protocol, k, scheme, activations, seed
    raise NotImplementedError(
        "network.simulate runs the C++ oracle, which the port does not "
        "carry yet (ROADMAP item 9); cpr_tpu_torch.netsim.Engine runs "
        "the topology on the card")
