"""Tiny graph utilities of the runtime lock-order sanitizer
(``locksan.py``): the JAX package's ``utils/graphs.py``."""

from __future__ import annotations

from typing import Iterable, Mapping


def strongly_connected_components(
    graph: Mapping[str, Iterable[str]],
) -> list[list[str]]:
    """SCCs with more than one node (i.e. cycle witnesses) in a directed
    graph, each as its sorted member list, deterministically ordered.

    Recursive Tarjan — fine for lock graphs (tens of nodes); not meant
    for graphs anywhere near the interpreter recursion limit.
    """
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    out: list[list[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        for w in graph.get(v, ()):
            if w not in index:
                strongconnect(w)
                low[v] = min(low[v], low[w])
            elif w in on_stack:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on_stack.discard(w)
                comp.append(w)
                if w == v:
                    break
            if len(comp) > 1:
                out.append(sorted(comp))

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)
    return out
