"""The few pytree verbs the training path needs, over the port's trees:
dicts, lists (a stage's per-layer units), tuples and NamedTuples, with
tensors (or None, for a gradient that autograd did not reach) as
leaves."""

from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_map(fn: Callable, tree, *rest) -> Any:
    """`fn` over the leaves of `tree` and the matching leaves of `rest`
    (which share its structure); the result has `tree`'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):            # a NamedTuple
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def leaves(tree) -> Iterator:
    """The leaves of `tree` in `tree_map`'s order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def unflatten(tree, values) -> Any:
    """`tree`'s structure with its leaves replaced, in order, by
    `values`."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)


def stacked_groups(tree) -> list[list[int]]:
    """The leaves (indices in `leaves` order) that make one leaf of the
    JAX package's tree: a list of per-layer units is one stacked ``(R,
    ...)`` leaf per key path, so its units' leaves at one key path form a
    group; every other leaf is a group of its own."""
    counter = iter(range(1 << 62))

    def walk(t) -> list[list[int]]:
        if isinstance(t, dict):
            return [g for v in t.values() for g in walk(v)]
        if isinstance(t, list):
            per_unit = [walk(u) for u in t]
            return [sum(same, []) for same in zip(*per_unit)]
        if isinstance(t, tuple):
            return [g for v in t for g in walk(v)]
        return [[next(counter)]]

    return walk(tree)
