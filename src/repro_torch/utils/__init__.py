from repro_torch.utils.tree import (
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
    tree_size,
    tree_to_matrix,
    tree_to_vector,
    vector_to_tree,
)

__all__ = ["tree_leaves", "tree_leaves_with_path", "tree_map", "tree_size", "tree_to_matrix",
           "tree_to_vector", "vector_to_tree"]
