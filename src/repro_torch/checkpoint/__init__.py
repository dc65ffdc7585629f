"""Checkpoints in the reference's msgpack layout, and tree checks that name
the leaf at fault (mirrors ``repro/checkpoint``)."""
from .msgpack_ckpt import load_pytree, save_pytree  # noqa: F401
from .treecheck import (assert_tree_compatible, named_leaves,  # noqa: F401
                        nodes_at_leaves, tree_mismatches, with_leaves)
