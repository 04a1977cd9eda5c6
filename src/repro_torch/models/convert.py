"""Load a reference parameter (or cache) tree into the port.

The port keeps the reference's tree: the same names (``layers/scan/pos0/
attn/wq``, ...), the ``(in, out)`` matrix layout and the stacking over
layer periods.  So a tree exported from ``repro`` as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)``) converts by copying
each leaf, with no transposes.  bfloat16 leaves (numpy's ml_dtypes
``bfloat16``) cross as their raw 16-bit words.
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch(arr, device="cuda"):
    """One numpy array -> tensor on ``device`` with the same dtype."""
    arr = np.array(arr)  # a writable copy: the port updates caches in place
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def from_numpy_tree(tree, device="cuda"):
    """Nested dicts of numpy arrays -> the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    return to_torch(tree, device)


def to_numpy_tree(tree):
    """Nested dicts of tensors -> numpy (bfloat16 widened to float32)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
