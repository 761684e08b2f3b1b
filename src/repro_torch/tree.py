"""Parameter and optimizer-state trees: nested dicts, lists, tuples and
named tuples of tensors, flattened in the JAX package's order.

``jax.tree.flatten`` visits a dict's keys in sorted order, a list's or a
tuple's items in order, a named tuple's fields in order, and treats
``None`` as an empty subtree.  The optimizers, the global norm, the
training step and the checkpoint files walk trees in that order, so that
a leaf's index and a sum over leaves are the reference's.
"""
from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves(tree) -> list:
    """The leaves of ``tree``, in the JAX package's order."""
    out = []
    _collect(tree, out)
    return out


def _collect(tree, out: list) -> None:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _collect(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _collect(x, out)
    else:
        out.append(tree)


def unflatten(like, new_leaves) -> object:
    """A tree of ``like``'s structure holding ``new_leaves`` in order."""
    it = iter(new_leaves)
    tree = _rebuild(like, it)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return tree


def _rebuild(like, it):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(x, it) for x in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, it) for x in like)
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer leaves than the tree holds") from None


def map_tree(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of each tree of ``rest``
    (same structure), leaf by leaf."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *others,
                                                  strict=True)])
