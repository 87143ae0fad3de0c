"""The multi-process entry point.

Port of ``bayesbridge_tpu/parallel/distributed.py`` on
``torch.distributed``. Each process calls :func:`initialize_multihost`
once, builds the mesh over every process's devices with
:func:`global_mesh`, and hands over only its own rows
(:func:`host_local_to_global`); the Gibbs step then runs the same on
every process. The sharded design (:mod:`..design.sharded`) gathers the
other processes' partials and rows with ``all_gather`` and every process
combines them in the same global shard order, so each process holds the
same bits and runs the same chain.

Typical launch (one process per card; the address, the process count and
each process's rank given, or MASTER_ADDR / MASTER_PORT / WORLD_SIZE /
RANK in the environment)::

    from bayesbridge_tpu_torch.parallel import distributed
    distributed.initialize_multihost('tcp://host0:29500', n_proc, rank)
    mesh = distributed.global_mesh()
    design = distributed.host_local_to_global(my_row_block, mesh)
    y = distributed.host_local_to_global(my_y, mesh)
    bridge = BayesBridge(LinearModel(y, design), prior)
    bridge.gibbs(...)                       # the same on every process

A process's row block is a design of this package over that process's
rows with the whole design's column layout (``design.row_block(r0, r1)``
of the design over every row, or a design carried from the JAX
package's arrays by :mod:`..convert`); the processes' blocks follow one
another in rank order.

Single-process runs need none of this: with no arguments and no such
environment :func:`initialize_multihost` does nothing.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from .sharding import PRED_AXIS, SHARD_AXIS, Mesh, make_mesh
from ..design.abstract import AbstractDesignMatrix
from ..design.sharded import ShardedDesignMatrix, row_bounds
from ..utils.dtypes import resolve_device

_ENV = ('MASTER_ADDR', 'WORLD_SIZE', 'RANK')
_STATE = {}  # 'device': this process's device once initialized


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None, device='cuda', **kwargs):
    """Join the job's process group (distributed.py:38-73): a thin,
    idempotent wrapper over ``torch.distributed.init_process_group``.

    coordinator_address : 'tcp://host:port' (or 'host:port') of rank 0;
        None reads MASTER_ADDR / MASTER_PORT ('env://')
    num_processes, process_id : the world size and this process's rank
        (None: WORLD_SIZE and RANK from the environment)
    device : this process's device; 'cuda' takes the NCCL backend (the
        card of index rank % device_count unless one is named), 'cpu'
        gloo. A CUDA request without a card raises: nothing moves to
        gloo quietly
    kwargs : passed to ``init_process_group`` (e.g. ``timeout``)

    With no address, no process count and none of MASTER_ADDR /
    WORLD_SIZE / RANK in the environment it does nothing (a single
    process); called again in a job, it returns.
    """
    if dist.is_initialized():
        return
    env_driven = any(key in os.environ for key in _ENV)
    if coordinator_address is None and num_processes is None \
            and not env_driven:
        return
    device = resolve_device(device)
    if coordinator_address is None:
        init_method = 'env://'
    elif '://' in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = 'tcp://' + coordinator_address
    world = -1 if num_processes is None else int(num_processes)
    rank = -1 if process_id is None else int(process_id)
    if device.type == 'cuda':
        if device.index is None:
            local = rank if rank >= 0 else int(os.environ.get('RANK', 0))
            device = torch.device('cuda', local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group('nccl' if device.type == 'cuda' else 'gloo',
                            init_method=init_method, world_size=world,
                            rank=rank, **kwargs)
    _STATE['device'] = device


def global_mesh(pred_shards=1, axis_name=SHARD_AXIS, pred_axis=PRED_AXIS,
                local_devices=None):
    """The mesh over every process's devices, in rank order
    (distributed.py:77-94): with ``pred_shards`` = 1 the 1-d mesh, with k
    > 1 the 2-d obs x pred mesh of the devices as (-1, k), which raises
    where k does not divide their number. `local_devices` are this
    process's (default: the device :func:`initialize_multihost` took).
    Outside a process group, :func:`.make_mesh` over `local_devices`
    (default every CUDA device). A design sharded over the 2-d mesh of a
    process group needs each process's entries to be whole mesh rows
    (``host_local_to_global`` says so where they are not)."""
    if not dist.is_initialized():
        devices = list(local_devices) if local_devices is not None else None
        if pred_shards == 1:
            return make_mesh(devices=devices, axis_name=axis_name)
        if devices is None:
            devices = make_mesh().devices
        return make_mesh(_grid(len(devices), pred_shards), devices,
                         axis_name, pred_axis)
    local = [str(d) for d in (local_devices or [_STATE['device']])]
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, local)
    if len({len(devs) for devs in everyone}) != 1:
        raise ValueError("every process must bring as many devices")
    devices = [d for devs in everyone for d in devs]
    ranks = [r for r, devs in enumerate(everyone) for _ in devs]
    if pred_shards == 1:
        return Mesh(devices, (axis_name,), ranks, group=dist.group.WORLD)
    r, c = _grid(len(devices), pred_shards)
    return Mesh([devices[i * c:(i + 1) * c] for i in range(r)],
                (axis_name, pred_axis), ranks, group=dist.group.WORLD)


def _grid(n_devices, pred_shards):
    if pred_shards < 1 or n_devices % pred_shards:
        raise ValueError(f"{n_devices} devices do not divide into "
                         f"{pred_shards} predictor shards.")
    return n_devices // pred_shards, pred_shards


def _gather_rows(rows, group):
    """This process's rows (leading axis) all_gathered from every process
    in rank order, on `rows`' device."""
    counts = [None] * dist.get_world_size(group)
    dist.all_gather_object(counts, int(rows.shape[0]), group=group)
    pad = torch.zeros((max(counts),) + tuple(rows.shape[1:]),
                      dtype=rows.dtype, device=rows.device)
    pad[:rows.shape[0]] = rows
    got = [torch.empty_like(pad) for _ in counts]
    dist.all_gather(got, pad, group=group)
    return torch.cat([g[:c] for g, c in zip(got, counts)])


def _layout_key(design):
    """What every process's row block must share: kind, width, dtype,
    flags and the column layout's bytes."""
    arrays = [getattr(design, name) for name in
              ('exact_cols', 'float_cols', 'bin_cols', 'column_offset')
              if torch.is_tensor(getattr(design, name, None))]
    return (type(design).__name__, getattr(design, 'backend', None),
            design.shape[1], str(design.dtype), design.intercept_added,
            design.centered, tuple(a.cpu().numpy().tobytes()
                                   for a in arrays))


def host_local_to_global(local_rows, mesh, axis_name=SHARD_AXIS):
    """Assemble the processes' row blocks (distributed.py:97-108): each
    process passes only its own, in rank order.

    A design (this process's rows, with the whole design's column layout)
    becomes the :class:`ShardedDesignMatrix` over `mesh`: this process's
    rows cut into its mesh rows' blocks, and on a 2-d mesh each of those
    into its column pieces, on its devices; the others' pieces stay with
    them. On a 2-d mesh each process's entries must be whole mesh rows
    (a row block's pieces are cut from the rows one process holds), and
    an ell design, whose col-ELL pieces hold every row, raises: hand the
    whole design to ``shard_design`` on every process. The processes'
    layouts are compared, and a difference raises.

    An array or tensor of per-observation values (an outcome vector)
    becomes the whole of it, every process's rows gathered in rank order
    (the chain state is whole on every process): numpy in, numpy out; a
    tensor comes back on the mesh's home device.

    Outside a process group, a design is sharded as ``shard_design``
    does and an array comes back as it is.
    """
    if axis_name not in mesh.axis_names:
        raise ValueError(f"no axis {axis_name!r} in {mesh}")
    group = mesh.group
    if isinstance(local_rows, AbstractDesignMatrix):
        if isinstance(local_rows, ShardedDesignMatrix):
            raise ValueError("the design is sharded already")
        r, c = mesh.grid
        if group is None:
            return ShardedDesignMatrix.from_design(local_rows, mesh.devices,
                                                   grid=mesh.grid)
        local = mesh.local_indices()
        rows = sorted({i // c for i in local})
        if sorted(local) != [i * c + j for i in rows for j in range(c)]:
            raise ValueError(
                "host_local_to_global: on a 2-d mesh each process's "
                "entries must be whole mesh rows, since a process cuts "
                "its own rows into their column pieces; bring a multiple "
                f"of {c} devices a process (global_mesh(pred_shards={c}))")
        if c > 1 and local_rows.is_sparse and local_rows.backend == 'ell':
            raise ValueError(
                "host_local_to_global: an ell design's col-ELL pieces on "
                "a 2-d mesh hold every row; pass the whole design to "
                "shard_design on every process")
        # Each process's (layout, rows, stored entries).
        keys = [None] * dist.get_world_size(group)
        nnz = local_rows.nnz if local_rows.is_sparse else None
        dist.all_gather_object(keys, (_layout_key(local_rows),
                                      local_rows.shape[0], nnz),
                               group=group)
        if len({k[0] for k in keys}) != 1:
            raise ValueError("the processes' row blocks have different "
                             "column layouts")
        part = ShardedDesignMatrix.from_design(
            local_rows, [mesh.devices[i] for i in local],
            grid=(len(rows), c))
        row_ranks = list(mesh.process_ids[::c])
        bounds, start = [], 0
        for rank, (_, count, _) in enumerate(keys):
            bounds += [(start + a, start + b) for a, b in
                       row_bounds(count, row_ranks.count(rank))]
            start += count
        live = len(part.col_pieces)
        shards = [None] * (r * live)
        shards[rows[0] * live:(rows[-1] + 1) * live] = part.shards
        counts = [k[2] for k in keys]
        return ShardedDesignMatrix(
            shards, bounds, mesh.home, local_rows,
            None if None in counts else sum(counts), group, row_ranks,
            part.col_pieces)
    if group is None:
        return local_rows
    as_numpy = not torch.is_tensor(local_rows)
    rows = torch.as_tensor(np.asarray(local_rows)) if as_numpy \
        else local_rows
    whole = _gather_rows(rows.to(mesh.home), group)
    return whole.cpu().numpy() if as_numpy else whole

