"""Production mesh factory (torch port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process group.  Each builds a ``DeviceMesh`` with ``init_device_mesh``
over the current default process group, whose world size must be the
mesh's size: NCCL or gloo ranks on real devices, or the ``"fake"``
backend of :func:`repro_torch.launch.dryrun.fake_process_group` for the
dry-run.  Build the mesh before entering ``FakeTensorMode``: inside it,
``init_device_mesh`` reads data that fake tensors do not have.
"""

from __future__ import annotations

__all__ = ["make_production_mesh", "make_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 single-pod (256 devices) or 2x16x16 two-pod (512 devices)
    mesh.

    Axes: ``pod`` = pure data parallelism across pods, ``data`` = FSDP +
    batch sharding, ``model`` = TP/EP.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str = "cuda"):
    """Elastic variant: any shape whose axis names are drawn from
    (``pod``, ``data``, ``model``); ``device_type`` is ``"cuda"`` unless
    the caller passes ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
