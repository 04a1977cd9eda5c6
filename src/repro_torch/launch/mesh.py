"""Production mesh construction (PyTorch port of ``repro.launch.mesh``).

Functions, not module-level constants, so importing this module touches
no process group; the dry-run starts a fake process group of 256 or 512
ranks before it builds one.

Mesh layout (H100 nodes of 8 cards joined by NVLink):
  256 cards:  (32, 8)      axes ("data", "model")
  512 cards:  (2, 32, 8)   axes ("pod", "data", "model")
The "model" axis carries TP / EP / SP and stays inside one node's NVLink
domain; "data" and "pod" carry DP across nodes (the gradient all-reduce
crosses the inter-node network, which is what the int8 gradient
compression targets).
"""

from __future__ import annotations

PRODUCTION_SHAPE = (32, 8)
PRODUCTION_AXES = ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The production ``DeviceMesh`` over the current process group (256
    ranks, or 512 with ``multi_pod``)."""
    shape = ((2,) + PRODUCTION_SHAPE) if multi_pod else PRODUCTION_SHAPE
    axes = (("pod",) + PRODUCTION_AXES) if multi_pod else PRODUCTION_AXES
    return make_debug_mesh(shape, axes, device_type=device_type)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    device_type="cuda"):
    """A ``DeviceMesh`` of ``shape`` over whatever process group exists
    (its world size must be the product of ``shape``)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


# NVIDIA H100 SXM5 data sheet figures (dense, per card), for the dry-run's
# roofline terms; the inter-node figure is a ConnectX-7 NDR InfiniBand
# port's line rate (one 400 Gb/s port per card, as in NVIDIA's DGX H100
# reference design).
HW = {
    "peak_flops_bf16": 989e12,   # FLOP/s per card
    "hbm_bw": 3.35e12,           # bytes/s per card
    "hbm_bytes": 80e9,           # 80 GB per card
    "nvlink_bw": 450e9,          # bytes/s each way per card (NVLink 4)
    "internode_bw": 50e9,        # bytes/s each way per card (400 Gb/s)
}
