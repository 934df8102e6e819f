"""Production meshes of the port (H100 target) over a fake process group.

The twin of the reference's ``repro.launch.mesh``: the same 16x16
``("data", "model")`` single-pod and 2x16x16 ``("pod", "data",
"model")`` multi-pod meshes, built as ``DeviceMesh`` es over torch's
fake process group, which runs every collective as a no-op. So one
process can lay out and run a step on 256 or 512 ranks' local shards
(meta tensors: no device memory), which is what the dry run does.

A process group is global to its process: each mesh maker needs a
process with no other group (it creates the group and fails loudly if
one exists). ``repro_torch.launch.dryrun`` runs every combination in a
child process of its own.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# Hardware constants of one NVIDIA H100 SXM5 80GB (datasheet figures),
# used by the roofline bound of the dry-run records.
PEAK_FLOPS_BF16 = 989e12      # dense bf16 tensor-core FLOP/s (no sparsity)
HBM_BW = 3.35e12              # HBM3 bytes/s
HBM_BYTES = 80 * 10**9        # 80 GB of HBM3
# Per-GPU network: one 400 Gb/s NDR InfiniBand port per GPU (DGX H100).
# The production mesh's 16-wide axes span nodes of 8 GPUs, so its
# collectives are bounded by this, not by NVLink (900 GB/s in a node).
NET_BW = 50e9

_FAKE = "fake"


def _create_fake_pg(*args):
    """Backend creator for both registration APIs: extended
    ``(common_opts, backend_opts)`` and plain ``(store, rank, size,
    timeout)``."""
    from torch._C._distributed_c10d import FakeProcessGroup
    if len(args) == 2:
        common, opts = args
        return FakeProcessGroup._create_internal(
            common.group_rank, common.group_size, opts)
    _store, rank, size, _timeout = args
    if hasattr(FakeProcessGroup, "_create_internal"):
        return FakeProcessGroup._create_internal(rank, size)
    return FakeProcessGroup(rank, size)


def register_fake_backend() -> None:
    """Register torch's ``FakeProcessGroup`` as the ``"fake"`` backend
    (idempotent). A torch without it raises ``RuntimeError``."""
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this "
                           "torch build: the dry run needs it")
    try:
        from torch._C._distributed_c10d import FakeProcessGroup  # noqa: F401
    except ImportError as e:
        raise RuntimeError("this torch has no FakeProcessGroup "
                           f"(torch {torch.__version__}): {e}") from e
    plugins = getattr(dist.Backend, "_plugins", {})
    if _FAKE.upper() in plugins or _FAKE in plugins:
        return
    try:
        dist.Backend.register_backend(_FAKE, _create_fake_pg,
                                      extended_api=True,
                                      devices=["cpu", "cuda"])
    except TypeError:         # an older signature: no extended API
        dist.Backend.register_backend(_FAKE, _create_fake_pg,
                                      devices=["cpu", "cuda"])


def init_fake_group(world_size: int) -> None:
    """A ``world_size``-rank fake group with this process as rank 0."""
    if dist.is_initialized():
        raise RuntimeError("a process group exists already: build a mesh "
                           "in a process of its own")
    register_fake_backend()
    dist.init_process_group(_FAKE, store=dist.HashStore(), rank=0,
                            world_size=world_size)


def make_mesh(shape: tuple, axes: tuple, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a new fake group
    of prod(shape) ranks; ``device`` is the mesh's device type."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    init_fake_group(n)
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks).
    Needs a process with no other process group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, device="cuda"):
    """Small ``("data", "model")`` mesh for tests. Needs a process with
    no other process group."""
    return make_mesh((n_data, n_model), ("data", "model"), device)


def destroy() -> None:
    """Tear the process group down (tests that make a mesh in-process)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def chips(mesh) -> int:
    return mesh.size()
