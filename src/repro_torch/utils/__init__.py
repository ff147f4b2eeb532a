from repro_torch.utils.device import resolve_device, upload
from repro_torch.utils.tree import (
    flatten_with_names,
    tree_bytes,
    tree_flatten,
    tree_flatten_with_path,
    tree_leaves,
    tree_map,
    tree_size,
    tree_to,
    tree_unflatten,
)
