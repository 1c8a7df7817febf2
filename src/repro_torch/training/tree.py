"""Parameter trees of the port: nested dicts of tensors, walked in JAX's
order (each dict's keys sorted, as ``jax.tree_util`` flattens them), so
that sums over leaves and checkpoint files follow the JAX package's."""
from __future__ import annotations


def flatten(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} in sorted key order (``checkpoint._flatten`` of the
    JAX package, over the sorted tree ``jax.device_get`` returns)."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k in sorted(tree):
        out.update(flatten(tree[k], f"{prefix}{k}/"))
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def leaves(tree) -> list:
    return list(flatten(tree).values())


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, keeping ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
