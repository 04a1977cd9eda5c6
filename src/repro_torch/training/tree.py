"""The parameter and optimizer trees of the port: nested dicts (and
tuples / NamedTuples, such as ``(params, AdamWState)``) with tensors as
leaves.  Leaves are ordered as ``jax.tree.flatten`` orders the
reference's trees (dict keys sorted; tuple fields in order; ``None`` an
empty subtree), so a checkpoint's ``arrays/<i>.npy`` means the same leaf
in both packages."""

from __future__ import annotations


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}  # keep the caller's key order
        if isinstance(t, (tuple, list)):
            parts = [build(x) for x in t]
            return type(t)(*parts) if hasattr(t, "_fields") \
                else type(t)(parts)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree has")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and trees of its shape."""
    leaves = [tree_leaves(t) for t in (tree, *rest)]
    if any(len(x) != len(leaves[0]) for x in leaves):
        raise ValueError("tree_map: trees of different structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)])
