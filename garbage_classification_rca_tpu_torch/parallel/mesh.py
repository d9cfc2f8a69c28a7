"""The device mesh: the mesh arithmetic of the JAX package's
``parallel/mesh.py`` and one rank's view of it.

JAX drives N chips from one process over a ``Mesh`` of named axes; the
port runs one process per GPU, so the mesh is laid over the ranks of the
process group and a ``DataMesh`` is one rank's view of it: its rank, the
world size, its device, the named axes (``data``, ``model``, ``seq``) in
spec order, and for each axis of more than one rank the process group of
the ranks that differ from it only along that axis. Rank order is JAX's
``np.reshape`` of the devices in spec order: at ``data:D,model:M`` a rank
is ``d * M + m``. ``local_rows(global_b)`` gives the rows of a global
batch the rank holds, a contiguous ascending block along the data axis
only (JAX's ``P("data")``); the ranks of one model or seq group hold the
same rows. The batch-size arithmetic (``mesh_for_batch``'s divisor rule,
``round_up_batch``, ``clamp_eval_batch``, ``pad_batch_to_multiple``) is
the JAX package's, on the data-axis size instead of a ``Mesh``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


def parse_mesh_shape(spec: str, n_devices: int) -> Dict[str, int]:
    """Parse "data:-1" / "data:4,model:2" into an axis -> size dict; a
    single -1 axis absorbs all remaining devices."""
    axes: Dict[str, int] = {}
    for part in spec.split(","):
        name, _, size = part.strip().partition(":")
        axes[name] = int(size) if size else -1
    fixed = int(np.prod([s for s in axes.values() if s > 0])) if axes else 1
    for name, size in axes.items():
        if size == -1:
            axes[name] = max(n_devices // max(fixed, 1), 1)
    return axes


def shrink_data_axis(data: int, batch_size: int) -> int:
    """The JAX package's divisor rule: the largest divisor of the data
    axis that divides `batch_size` (the axis itself when it does)."""
    if batch_size > 0 and data > 1 and batch_size % data != 0:
        return max(d for d in range(1, data + 1)
                   if data % d == 0 and batch_size % d == 0)
    return data


def mesh_for_batch(spec: str, batch_size: int,
                   n_devices: int) -> Dict[str, int]:
    """``parse_mesh_shape`` with the data axis shrunk by
    ``shrink_data_axis``; prints the JAX package's note when it shrinks."""
    axes = parse_mesh_shape(spec, n_devices)
    data = axes.get(DATA_AXIS, 1)
    new = shrink_data_axis(data, batch_size)
    if new != data:
        print(f"mesh data axis {data} does not divide batch_size "
              f"{batch_size}; using data:{new}")
        axes[DATA_AXIS] = new
    return axes


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank's view of the mesh. World 1 with no process group is the
    plain one-process run. `axes`: ((name, size), ...) in spec order, the
    sizes multiplying to the world; None is the data axis alone
    (``data:world``). `groups`: {axis: process group} for each axis of
    more than one rank and fewer than the world (None: the world's
    group), from ``multihost.make_mesh``."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    axes: Optional[Tuple[Tuple[str, int], ...]] = None
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict,
                                               compare=False, repr=False)

    @property
    def distributed(self) -> bool:
        return self.world > 1

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes or ((DATA_AXIS, self.world),))

    def size(self, axis: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        """This rank's index along `axis` (row-major over the axes in
        spec order, as JAX reshapes its devices)."""
        r, out = self.rank, 0
        for name, n in reversed(list(self.shape.items())):
            if name == axis:
                out = r % n
            r //= n
        return out

    def root(self, axis: str) -> int:
        """The global rank of this rank's group member at index 0 along
        `axis` (the source of a broadcast over the axis)."""
        stride = 1
        for name, n in reversed(list(self.shape.items())):
            if name == axis:
                return self.rank - self.coord(axis) * stride
            stride *= n
        return self.rank

    def group(self, axis: str):
        """The process group of this rank's ranks along `axis` (None: the
        whole world, which is the group when the axis spans it)."""
        return self.groups.get(axis)

    def local_rows(self, global_b: int) -> np.ndarray:
        """The global rows (ascending) this rank holds of a batch of
        `global_b` rows, which the data axis must divide."""
        n_data = self.size(DATA_AXIS)
        if global_b % n_data:
            raise ValueError(f"a batch of {global_b} rows does not split "
                             f"over {n_data} ranks")
        n = global_b // n_data
        d = self.coord(DATA_AXIS)
        return np.arange(d * n, (d + 1) * n, dtype=np.int64)


def round_up_batch(batch_size: int, mesh: Optional[DataMesh]) -> int:
    """Smallest batch >= batch_size divisible by the data-axis size."""
    n = 1 if mesh is None else mesh.size(DATA_AXIS)
    return ((batch_size + n - 1) // n) * n


def clamp_eval_batch(batch_size: int, n_samples: int,
                     mesh: Optional[DataMesh]) -> int:
    """Eval batch for a dataset of n_samples: no bigger than the dataset,
    divisible by the data axis, at least 1 sample (the tail padding is
    masked by ``valid``, so the numbers do not change)."""
    return round_up_batch(max(1, min(batch_size, n_samples)), mesh)


def pad_batch_to_multiple(arrays: Dict[str, np.ndarray], multiple: int):
    """Pad the leading dim of every array of a dict to a multiple (zeros).
    Returns (padded dict, valid count)."""
    if not arrays:
        return arrays, 0
    n = next(iter(arrays.values())).shape[0]
    pad = ((n + multiple - 1) // multiple) * multiple - n

    def _pad(a):
        if pad == 0:
            return a
        return np.pad(np.asarray(a), [(0, pad)] + [(0, 0)] * (a.ndim - 1))

    return {k: _pad(v) for k, v in arrays.items()}, n
