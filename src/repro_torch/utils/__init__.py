from repro_torch.utils.tree import (
    tree_axis_mean,
    tree_cast,
    tree_l2_norm,
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
    tree_select,
    tree_size,
    tree_to_matrix,
    tree_to_vector,
    vector_to_tree,
)
from repro_torch.utils.prng import key_fold, split_like

__all__ = ["key_fold", "split_like", "tree_axis_mean", "tree_cast",
           "tree_l2_norm", "tree_leaves", "tree_leaves_with_path",
           "tree_map", "tree_select", "tree_size", "tree_to_matrix",
           "tree_to_vector", "vector_to_tree"]
