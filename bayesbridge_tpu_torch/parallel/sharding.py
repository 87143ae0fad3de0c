"""Scaling over several devices on a 1-d observation mesh.

Port of ``bayesbridge_tpu/parallel/sharding.py`` for its 1-d mesh: the
design's rows are split over the mesh's devices and the p-length chain
state stays whole on the home device, so X v is row-local and X' u ends
in a sum of the shards' partials. The JAX package gets the sum from
GSPMD; here :class:`..design.sharded.ShardedDesignMatrix` makes it,
below the design's interface, in a fixed shard order (that module's
docstring). Rows are split into blocks of ceil(n / s) rows, the last
shorter: an uneven count needs no zero padding (the JAX ``_put_pad`` is
a ``device_put`` artefact).

A :class:`Mesh` may repeat a device (``[cuda:0] * 4``; ``[cpu] * 4`` in
the tests, the counterpart of the JAX suite's virtual CPU devices): its
shards then share the card, each a row view of the stored blocks.

A hybrid design's packed int4 block placed on a device that cannot run
the int4 tier is widened to int8 first (``_demote_unsupported``, the
JAX package's, with its warning): the same values at twice the bytes.
An int4 design's row-block shards are row views of the packed block.

Not ported: the 2-d obs x pred mesh (``make_mesh((r, c))``,
``pred_axis=``; ROADMAP item 15b), which raises.
"""

import copy
import warnings

import torch

from ..design import sparse as _sparse
from ..design.sharded import ShardedDesignMatrix
from ..kernels import layout

SHARD_AXIS = 'shard'
PRED_AXIS = 'pred'

_TWO_D = ("the 2-d obs x pred mesh is not ported (ROADMAP.md item 15b); "
          "the 1-d observation mesh is")


def _rank():
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


class Mesh:
    """A 1-d array of devices with an axis name.

    devices : the mesh's devices in shard order (a device may repeat;
        another process's entries are labels, for ``distributed``)
    axis_names : (name,)
    process_ids : the process of each entry (default: all this one's)
    group : the process group over the entries' processes, or None
    """

    def __init__(self, devices, axis_names=(SHARD_AXIS,), process_ids=None,
                 group=None):
        if len(axis_names) != 1:
            raise NotImplementedError(_TWO_D)
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs a device")
        self.axis_names = tuple(axis_names)
        self.process_ids = tuple(process_ids) if process_ids is not None \
            else (_rank(),) * len(self.devices)
        self.group = group

    @property
    def shape(self):
        """{axis name: size}, as ``mesh.shape[axis]`` reads in JAX."""
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self):
        return len(self.devices)

    def local_indices(self):
        """Positions of this process's entries."""
        me = _rank() if self.group is not None else self.process_ids[0]
        return [i for i, p in enumerate(self.process_ids) if p == me]

    @property
    def home(self):
        """This process's first device: it holds the chain state."""
        return self.devices[self.local_indices()[0]]

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names})")


def make_mesh(n_devices=None, devices=None, axis_name=SHARD_AXIS):
    """The 1-d device mesh (sharding.py:52-69).

    n_devices : int or None (every device of `devices`); a tuple (the 2-d
        mesh) raises
    devices : the devices, by default every visible CUDA device (none
        raises); a device may repeat
    """
    if isinstance(n_devices, tuple):
        raise NotImplementedError(_TWO_D)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices= (e.g. [torch.device('cpu')] * 4)")
        devices = [torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked, {len(devices)} "
                             f"given")
        devices = devices[:n_devices]
    return Mesh(devices, (axis_name,))


def _check_axes(mesh, axis_name, pred_axis):
    if pred_axis is not None:
        raise NotImplementedError(_TWO_D)
    if axis_name not in mesh.axis_names:
        raise ValueError(f"no axis {axis_name!r} in {mesh}")


def _demote_unsupported(design, device):
    """`design`, or, where it is a hybrid design with a packed int4 block
    that `device` cannot run (``design.sparse._int4_supported``), a copy
    with the block widened to int8 (sharding.py:213-230): numerically the
    same at twice the bytes, where the first product would otherwise fail
    on the device."""
    if getattr(design, 'backend', None) != 'hybrid' \
            or not layout.is_int4(design.X_exact) \
            or _sparse._int4_supported(device):
        return design
    warnings.warn(
        "place_model: widening a packed-s4 (int4) array to int8 — the "
        "target device platform {!r} cannot execute S4 operands. The "
        "design keeps exact semantics at 2x the storage bytes."
        .format(torch.device(device).type))
    return design.with_exact_tier('int8')


def shard_design(design, mesh, axis_name=SHARD_AXIS, pred_axis=None):
    """The design split by rows over `mesh` (sharding.py:120-191): a
    :class:`ShardedDesignMatrix` whose shards are the design's row blocks
    on the mesh's devices (this process's entries only, in a process
    group), a packed int4 block widened first where a mesh device cannot
    run it. Works for every backend; `pred_axis` (the 2-d mesh)
    raises."""
    _check_axes(mesh, axis_name, pred_axis)
    if isinstance(design, ShardedDesignMatrix):
        raise ValueError("the design is sharded already")
    for i in mesh.local_indices():
        design = _demote_unsupported(design, mesh.devices[i])
    ranks = mesh.process_ids if mesh.group is not None else None
    return ShardedDesignMatrix.from_design(
        design, mesh.devices, local=mesh.local_indices(), group=mesh.group,
        ranks=ranks)


def _move_outcomes(model, source, device):
    """`model`'s own tensors (outcomes, Cox risk sets) those of `source`
    moved to `device`."""
    for name, val in vars(source).items():
        if torch.is_tensor(val):
            setattr(model, name, val.to(device))


def shard_model(model, mesh, axis_name=SHARD_AXIS, pred_axis=None):
    """Shard the model's design over `mesh` (sharding.py:234-249); its
    outcome vectors (and the Cox model's risk-set index arrays) stay
    whole on the mesh's home device, as the JAX package keeps the Cox
    arrays replicated. Returns the model, changed in place."""
    model.design = shard_design(model.design, mesh, axis_name, pred_axis)
    _move_outcomes(model, model, mesh.home)
    return model


def place_model(model, device):
    """A copy of `model` with every tensor on `device` (sharding.py
    :194-210): the design's stored arrays (its rows 0:n as a design on
    `device`, ``row_block``; the same tensors where they are there
    already; a packed int4 block widened to int8 where `device` cannot
    run it), the outcome vectors and the Cox index arrays. The design
    gets counters of its own. A sharded design raises: placing it on one
    device would undo the sharding."""
    if isinstance(model.design, ShardedDesignMatrix):
        raise ValueError("place_model: the model's design is sharded; "
                         "placing it on one device would un-shard it")
    device = torch.device(device)
    placed = copy.copy(model)
    placed.design = _demote_unsupported(model.design.row_block(
        0, model.design.shape[0], device), device)
    _move_outcomes(placed, model, device)
    return placed
