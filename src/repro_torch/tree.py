"""Nested containers of tensors, flattened in ``jax.tree.flatten``'s
order, so that the port's leaf lists line up with the reference's:
dict keys sorted, tuple and NamedTuple fields in their order, ``None``
no leaf, anything else a leaf. The checkpoint files of both packages
depend on this order (``checkpoint/manager.py``)."""
from __future__ import annotations



class _Leaf:
    def __repr__(self):
        return "*"


_LEAF = _Leaf()      # a leaf's place in a treedef; str(treedef) reads well


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def flatten(tree) -> tuple[list, object]:
    """-> (leaves, treedef); ``unflatten(treedef, leaves)`` rebuilds it."""
    leaves: list = []

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*[walk(x) for x in t])
        if isinstance(t, (tuple, list)):
            return type(t)([walk(x) for x in t])
        leaves.append(t)
        return _LEAF

    return leaves, walk(tree)


def unflatten(treedef, leaves):
    leaves = list(leaves)
    pos = 0

    def build(d):
        nonlocal pos
        if d is None:
            return None
        if d is _LEAF:
            if pos == len(leaves):
                raise ValueError(f"{len(leaves)} leaves are too few for "
                                 f"the tree {treedef}")
            pos += 1
            return leaves[pos - 1]
        if isinstance(d, dict):
            return {k: build(v) for k, v in d.items()}
        if _is_namedtuple(d):
            return type(d)(*[build(x) for x in d])
        return type(d)([build(x) for x in d])

    out = build(treedef)
    if pos != len(leaves):
        raise ValueError(f"{len(leaves)} leaves are too many for the tree "
                         f"{treedef}")
    return out


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    flat, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])

