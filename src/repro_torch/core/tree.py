"""Trees: nested dicts and lists (or tuples) with tensors, or other values,
at the leaves, the port's counterpart of a JAX pytree. Param, optimizer and
KV-cache trees all walk through here."""

from __future__ import annotations

from typing import Callable, List, Tuple


def tree_map_with_path(fn: Callable, tree, *rest, path: str = ""):
    """``fn(path, leaf, *others)`` over ``tree``'s leaves, keeping its
    containers. The trees in ``rest`` follow ``tree``'s containers, and
    whatever they hold where ``tree`` has a leaf (a tensor, or a dict such
    as an int8 optimizer state) is passed as it is (the reference's
    ``flatten_up_to``). A path reads like the reference's ``keystr``:
    ``['params']['layers'][0]['attn']['wq']['w']``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, *(r[i] for r in rest),
                                             path=f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *others)`` over ``tree``'s leaves, as
    ``tree_map_with_path`` without the path."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_paths(tree) -> List[Tuple[str, object]]:
    """(path, leaf) pairs in ``tree_map``'s order."""
    out = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def tree_leaves(tree) -> list:
    """The leaves in ``tree_map``'s order."""
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
