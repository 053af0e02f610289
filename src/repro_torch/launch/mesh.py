"""Device meshes over the process group's world (torch port of
``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process group and no device.  Every mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over ranks 0..n-1 of the
default group, which the caller has initialised (``init_process_group``
with its address, world size and rank).  The device type is "cuda" unless
the caller asks for "cpu".
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

# the model (tensor-parallel) axis stays on one node's NVLink domain
MAX_MODEL_AXIS = 8


def _mesh(shape: tuple, names: tuple, device_type: str):
    n, size = dist.get_world_size(), math.prod(shape)
    if size != n:
        raise ValueError(f"a {shape} mesh needs {size} ranks, the world has "
                         f"{n}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The production mesh of H100 nodes (not the reference's TPU 16x16
    and 2x16x16): ("data", "model") with the model axis over one node's
    cards (the cards this process sees, at most ``MAX_MODEL_AXIS`` on
    NVLink) and the data axis over the nodes; with ``multi_pod`` the nodes
    split into two pods, ("pod", "data", "model").  On the CPU a "node" is
    ``MAX_MODEL_AXIS`` processes."""
    n = dist.get_world_size()
    per_node = (torch.cuda.device_count() if device_type == "cuda"
                else MAX_MODEL_AXIS)
    model = min(MAX_MODEL_AXIS, per_node, n)
    pods = 2 if multi_pod else 1
    if n % (pods * model):
        raise ValueError(f"{n} ranks do not split into {pods} pod(s) of "
                         f"nodes of {model} cards")
    data = n // (pods * model)
    if multi_pod:
        return _mesh((pods, data, model), ("pod", "data", "model"),
                     device_type)
    return _mesh((data, model), ("data", "model"), device_type)


def make_smoke_mesh(n_devices: int | None = None, pods: int = 1,
                    device_type="cuda"):
    """A small mesh (the reference's rule): the model axis is 2 when the
    per-pod rank count is even, else 1."""
    n = n_devices or dist.get_world_size()
    if pods > 1:
        per = n // pods
        model = 2 if per % 2 == 0 else 1
        return _mesh((pods, per // model, model), ("pod", "data", "model"),
                     device_type)
    model = 2 if n % 2 == 0 else 1
    return _mesh((n // model, model), ("data", "model"), device_type)
