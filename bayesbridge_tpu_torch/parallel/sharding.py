"""Scaling over several devices: the 1-d observation mesh and the 2-d
obs x pred mesh.

Port of ``bayesbridge_tpu/parallel/sharding.py``. On the 1-d mesh the
design's rows are split over the mesh's devices and the p-length chain
state stays whole on the home device, so X v is row-local and X' u ends
in a sum of the shards' partials. On the 2-d mesh (``make_mesh((r,
c))``, ``shard_design(..., pred_axis='pred')``) mesh row i holds row
block i and mesh column j column piece j of the design: X v sums its
pieces' partials over ``pred``, X' u over ``obs``. The JAX package gets
the sums from GSPMD; here :class:`..design.sharded.ShardedDesignMatrix`
makes them, below the design's interface, in a fixed order, and holds
the pieces' layout per backend (that module's docstring). Rows are split
into blocks of ceil(n / r) rows, the last shorter, and columns into
near-equal pieces at each backend's storage unit: an uneven count needs
no zero padding (the JAX ``_put_pad`` is a ``device_put`` artefact).

A :class:`Mesh` may repeat a device (``[cuda:0] * 4``, as 4 x 1 or 2 x
2; ``[cpu] * 8`` in the tests, the counterpart of the JAX suite's
virtual CPU devices): its pieces then share the card; a row block of the
1-d mesh is a row view of the stored blocks, a column piece a copy.

A hybrid design's packed int4 block placed on a device that cannot run
the int4 tier is widened to int8 first (``_demote_unsupported``, the
JAX package's, with its warning): the same values at twice the bytes.
An int4 design's row-block shards are row views of the packed block;
its column pieces start at multiples of 32 columns (whole bytes).
"""

import copy
import warnings

import torch

from ..design import sparse as _sparse
from ..design.sharded import ShardedDesignMatrix
from ..kernels import layout

SHARD_AXIS = 'shard'
PRED_AXIS = 'pred'

def _rank():
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


class Mesh:
    """A 1-d or 2-d array of devices with axis names.

    Its entries are kept in one order, row-major: entry i * c + j is mesh
    row i, column j, and mesh row i holds the design's row block i (a
    1-d mesh of s devices is the s x 1 grid).

    devices : the devices in shard order (1-d), or r rows of c devices
        each (2-d); a device may repeat, and another process's entries
        are labels, for ``distributed``
    axis_names : (name,), or (obs name, pred name) for the 2-d mesh
    process_ids : the process of each entry, row-major (default: all
        this one's)
    group : the process group over the entries' processes, or None
    """

    def __init__(self, devices, axis_names=(SHARD_AXIS,), process_ids=None,
                 group=None):
        if len(axis_names) not in (1, 2):
            raise ValueError(f"a mesh has 1 or 2 axes, not {axis_names}")
        rows = [list(r) for r in devices] if len(axis_names) == 2 \
            else [[d] for d in devices]
        if not rows or not rows[0]:
            raise ValueError("a mesh needs a device")
        if len({len(r) for r in rows}) != 1:
            raise ValueError("the rows of a 2-d mesh must be as long")
        self.grid = (len(rows), len(rows[0]))
        self.devices = tuple(torch.device(d) for r in rows for d in r)
        self.axis_names = tuple(axis_names)
        self.process_ids = tuple(process_ids) if process_ids is not None \
            else (_rank(),) * len(self.devices)
        if len(self.process_ids) != len(self.devices):
            raise ValueError("one process id an entry")
        self.group = group

    @property
    def shape(self):
        """{axis name: size}, as ``mesh.shape[axis]`` reads in JAX."""
        return dict(zip(self.axis_names, self.grid))

    @property
    def row_devices(self):
        """The first device of each mesh row (of the ``obs`` axis)."""
        return self.devices[::self.grid[1]]

    def column(self, j=0):
        """Mesh column j as a 1-d mesh over the ``obs`` axis."""
        c = self.grid[1]
        return Mesh(self.devices[j::c], self.axis_names[:1],
                    self.process_ids[j::c], self.group)

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
                f"axis_names={self.axis_names}, grid={self.grid})")


def make_mesh(n_devices=None, devices=None, axis_name=SHARD_AXIS,
              pred_axis=PRED_AXIS):
    """The device mesh (sharding.py:52-69).

    n_devices : int or None (every device of `devices`): the 1-d mesh; an
        (r, c) tuple: the 2-d obs x pred mesh of the first r * c devices,
        row-major (r observation blocks, c predictor pieces)
    devices : the devices, by default every visible CUDA device (none
        raises); a device may repeat
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices= (e.g. [torch.device('cpu')] * 4)")
        devices = [torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if isinstance(n_devices, tuple):
        r, c = n_devices
        if r < 1 or c < 1 or r * c > len(devices):
            raise ValueError(f"a {r} x {c} mesh needs {r * c} devices, "
                             f"{len(devices)} given")
        return Mesh([devices[i * c:(i + 1) * c] for i in range(r)],
                    (axis_name, pred_axis))
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked, {len(devices)} "
                             f"given")
        devices = devices[:n_devices]
    return Mesh(devices, (axis_name,))


def _check_axes(mesh, axis_name, pred_axis):
    if axis_name != mesh.axis_names[0]:
        raise ValueError(f"no observation axis {axis_name!r} in {mesh}")
    if pred_axis is not None and pred_axis not in mesh.axis_names[1:]:
        raise ValueError(f"no predictor axis {pred_axis!r} in {mesh}")


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
    """The design split over `mesh` (sharding.py:120-191): a
    :class:`ShardedDesignMatrix` whose pieces are the design's row blocks
    on a 1-d mesh, and with `pred_axis` (the 2-d mesh's second axis) its
    rows over ``obs`` and its columns over ``pred``; on this process's
    entries only, in a process group; a packed int4 block widened first
    where a mesh device cannot run it. Works for every backend. A 2-d
    mesh without `pred_axis` splits the rows over its first column, as
    does the winell backend, which warns (sharding.py:146-149)."""
    _check_axes(mesh, axis_name, pred_axis)
    if isinstance(design, ShardedDesignMatrix):
        raise ValueError("the design is sharded already")
    if pred_axis is not None and getattr(design, 'backend', None) \
            == 'winell':
        warnings.warn("shard_design: the 'winell' backend shards along "
                      "the observation axis only; the predictor mesh "
                      "axis replicates its arrays.")
        pred_axis = None
    if pred_axis is None and mesh.grid[1] > 1:
        mesh = mesh.column(0)
    for i in mesh.local_indices():
        design = _demote_unsupported(design, mesh.devices[i])
    ranks = mesh.process_ids[::mesh.grid[1]] if mesh.group is not None \
        else None
    return ShardedDesignMatrix.from_design(
        design, mesh.devices, local=mesh.local_indices(), group=mesh.group,
        ranks=ranks, grid=mesh.grid)


def _move_outcomes(model, source, device):
    """`model`'s own tensors (outcomes, Cox risk sets) those of `source`
    moved to `device`."""
    for name, val in vars(source).items():
        if torch.is_tensor(val):
            setattr(model, name, val.to(device))


def shard_model(model, mesh, axis_name=SHARD_AXIS, pred_axis=None):
    """Shard the model's design over `mesh` (sharding.py:234-249; with
    `pred_axis` over the 2-d mesh's rows and columns); its outcome
    vectors (and the Cox model's risk-set index arrays) stay whole on the
    mesh's home device, as the JAX package keeps the Cox arrays
    replicated. `model.design` is replaced: on a predictor split the
    pieces are copies, and the source design can be dropped. Returns the
    model, changed in place."""
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
