"""Several devices: the 1-d observation mesh (:mod:`.sharding`) and the
multi-process entry point (:mod:`.distributed`)."""

from .sharding import (
    PRED_AXIS, SHARD_AXIS, Mesh, make_mesh, place_model, shard_design,
    shard_model,
)
from . import distributed

__all__ = ['PRED_AXIS', 'SHARD_AXIS', 'Mesh', 'make_mesh', 'place_model',
           'shard_design', 'shard_model', 'distributed']
