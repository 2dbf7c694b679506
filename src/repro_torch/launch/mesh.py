"""The ``(data, model)`` grids of the port: the JAX package's
``launch/mesh.py``.

The JAX package builds a ``jax.sharding.Mesh`` over its visible devices.
The port runs one process per rank (``distributed/runtime.py``), so a mesh
here is a plan: the grid's shape and, for each rank in the mesh's
row-major order, its device and the backend that joins them, both as
:func:`runtime.plan` places them (one card each where there are enough,
else sharing ``cuda:0`` over gloo, or the CPU).  The validation and its
messages are the reference's.  ``make_test_mesh`` takes ``shape=(dp, tp)``
(default ``(1, n)``: every rank on ``"model"``, as in the reference).
``make_production_mesh`` needs one card per rank.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.device import resolve_device
from repro_torch.distributed import runtime

AXES = ("data", "model")


@dataclass(frozen=True)
class MeshPlan:
    """A grid's shape over ``axes``, and each rank's device (row-major over
    the axes) and the backend of their process group."""

    shape: Tuple[int, ...]
    devices: Tuple[str, ...]
    backend: str
    axes: Tuple[str, ...] = AXES


def _validate_shape(shape, devices, *, what):
    """Raise a readable error before a grid of the wrong size is spawned."""
    n = len(devices)
    want = math.prod(shape)
    if any(s <= 0 for s in shape):
        raise ValueError(f"{what}: mesh shape {shape} has a non-positive axis")
    if want != n:
        raise ValueError(
            f"{what}: mesh shape {shape} needs {want} devices but "
            f"{n} are available; pick (dp, tp) with dp*tp == {n}"
        )


def make_production_mesh(shape=(16, 16)) -> MeshPlan:
    """Data x model grid over one card per rank; default 16x16.

    ``shape`` is the explicit ``(dp, tp)`` pair; it is validated against
    ``torch.cuda.device_count()``, so a mismatch raises a clear error."""
    shape = tuple(shape)
    if len(shape) != len(AXES):
        raise ValueError(
            f"make_production_mesh: shape {shape} must have {len(AXES)} axes {AXES}"
        )
    _validate_shape(shape, range(torch.cuda.device_count()),
                    what="make_production_mesh")
    return MeshPlan(shape, *_placed(shape, "cuda"))


def make_test_mesh(devices: Optional[Sequence[str]] = None, shape=None, *,
                   device="cuda") -> MeshPlan:
    """Small ("data", "model") grid (the shared card, CPU tests).

    Default shape is ``(1, n)``, n the number of ``devices`` (one rank
    without them): all ranks on the model axis.  Pass an explicit
    ``(dp, tp)`` to split them; the product must match the device count
    (without ``devices``, the shape sets it).  The ranks are placed by
    :func:`runtime.plan` on the type of ``devices``, else of ``device``:
    the card by default, which raises without one (pass
    ``device="cpu"``)."""
    if devices is None:
        device = str(resolve_device(device))
        devices = [device] * (1 if shape is None else math.prod(shape))
    n = len(devices)
    if shape is None:
        shape = (1, n)
    shape = tuple(shape)
    if len(shape) != 2:
        raise ValueError(f"make_test_mesh: shape {shape} must be (dp, tp)")
    _validate_shape(shape, devices, what="make_test_mesh")
    return MeshPlan(shape, *_placed(shape, devices[0]))


def _placed(shape, device) -> Tuple[Tuple[str, ...], str]:
    """(each rank's device, the backend), as :func:`runtime.plan` places a
    grid of ``shape`` on ``device``'s type."""
    backend, devices = runtime.plan(shape, device)
    return tuple(devices), backend
