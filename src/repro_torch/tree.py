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


def _never(x) -> bool:
    return False


def leaves(tree, is_leaf=_never) -> list:
    """The leaves of ``tree``, in the JAX package's order; ``is_leaf`` stops
    the walk at a node (a partition spec is a tuple)."""
    return [x for _, x in leaves_with_paths(tree, is_leaf)]


def leaves_with_paths(tree, is_leaf=_never) -> list:
    """(path, leaf) pairs in ``leaves`` order.  A path is the keys from the
    root: a dict's key, a sequence's index, a named tuple's field as
    '.name' (the JAX package's key-path spelling)."""
    out = []
    _collect(tree, (), out, is_leaf)
    return out


def _collect(tree, path: tuple, out: list, is_leaf) -> None:
    if tree is None:
        return
    if is_leaf(tree):
        out.append((path, tree))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _collect(tree[k], path + (k,), out, is_leaf)
    elif _is_namedtuple(tree):
        for f, x in zip(tree._fields, tree):
            _collect(x, path + (f".{f}",), out, is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            _collect(x, path + (i,), out, is_leaf)
    else:
        out.append((path, tree))


def unflatten(like, new_leaves, is_leaf=_never) -> object:
    """A tree of ``like``'s structure holding ``new_leaves`` in order."""
    it = iter(new_leaves)
    tree = _rebuild(like, it, is_leaf)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return tree


def _rebuild(like, it, is_leaf):
    if like is None:
        return None
    if is_leaf(like):
        pass
    elif isinstance(like, dict):
        return {k: _rebuild(like[k], it, is_leaf) for k in sorted(like)}
    elif _is_namedtuple(like):
        return type(like)(*(_rebuild(x, it, is_leaf) for x in like))
    elif isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, it, is_leaf) for x in like)
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
