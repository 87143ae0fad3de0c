"""A design split by rows over the devices of a 1-d observation mesh.

Counterpart of the JAX package's sharded designs
(``bayesbridge_tpu/parallel/sharding.py``; ``design/sparse.py``
``_fused_sharded_call``, ``shard_bitpack``, ``shard_winell``). The JAX
package places its arrays with ``NamedSharding`` and GSPMD inserts the
``psum`` collectives into the jitted step. This package runs eagerly,
so the split lives one layer down, in the design: every caller reaches X
only through the design's interface (`dot`, `Tdot`, `quad_matvec`,
`quad_matvec_blockorder`, `cg_blockorder_ctx`, `fused_ne_mode`,
`fused_link_grad`, `presolve_reductions`, the Fisher products), and
:class:`ShardedDesignMatrix` implements it over a list of ordinary
designs, shard i the rows of block i on mesh device i
(``SparseDesignMatrix.row_block`` / ``DenseDesignMatrix.row_block``):

- every output of length n is the shards' outputs concatenated in shard
  order on the home device (the mesh's first device of this process);
- every output of length p, and every scalar, is the shards' partials
  summed in shard order on the home device, one addition after another.

With that fixed order a result has the same bits whether the shards sit
on one card, on several, or in several processes: in a process group
(``parallel.distributed``) each process holds only its own shards, and
the partials and row outputs of the others arrive by ``all_gather``
before every process combines them in the same global order.

The chain state stays on the home device, whole (replicated in the JAX
sense): coef, the scales, the n-vectors, the Cox risk sets. Inputs of
length n are cut into the shards' rows; inputs of length p and chain
batches (a leading axis of k chains) go to every shard as they are.

Each shard keeps the whole design's column layout (the hybrid
exact / float split, the bitpack binary mask, the centering offsets) and
its own intercept column, so the partial sums add up to the whole
design's products. The hybrid shards run the fused kernels on their own
rows wherever the policy fuses, as the JAX package's ``shard_map`` does
on the 1-d mesh; a sharded dense design never fuses (the JAX dense
design's ``_sharded``). The ell shards hold the dual ELL of their rows:
the JAX package shards its col-ELL along the predictor axis instead, and
row blocks compute the same X' u up to the order of the sum. Each ell
shard's col-ELL rows are about 1/s as long, so the windowed traversal's
dispatch (``kernels.ell.takes_window``) decides per shard on the shard's
shape; :meth:`ShardedDesignMatrix.traversals` says what it picked.

The matvec counters count one product per call, as the unsharded design
does (the first local shard's counts, not their sum), so ``n_cg_iter``
and the HMC counts read the same. On a CUDA shard the kernels run or the
call raises; nothing falls back to the plain versions or to the CPU.
"""

import contextlib
import logging

import torch

from .abstract import AbstractDesignMatrix, memoized_dot
from .dense import DenseDesignMatrix
from ..utils.dtypes import full_float32

_log = logging.getLogger(__name__)


def row_bounds(n, n_shards):
    """[(r0, r1)] of `n_shards` blocks of ceil(n / n_shards) rows, the
    last shorter; every block holds a row."""
    size = -(-n // n_shards)
    bounds = [(i * size, min(n, (i + 1) * size)) for i in range(n_shards)]
    if bounds[-1][0] >= n:
        raise ValueError(f"{n} rows do not fill {n_shards} shards of "
                         f"{size} rows")
    return bounds


def on_device(device):
    """The CUDA device context of `device` (kernel launches and
    allocations land on its current stream); nothing on the CPU."""
    device = torch.device(device)
    if device.type == 'cuda':
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ShardedDesignMatrix(AbstractDesignMatrix):
    """The design interface over row-block shards (module docstring).

    Parameters
    ----------
    shards : one entry per mesh position, in row order: the shard design
        where this process holds it, else None
    bounds : [(r0, r1)] of each shard's rows
    home : the device that holds the chain state and every combined
        output
    like : a design of the same kind and layout (the source design, or a
        local shard), read for the metadata
    nnz : the whole design's stored entries (None where unknown)
    group : the process group whose processes hold the other shards, or
        None (every shard is this process's)
    ranks : the process of each shard (with `group`)
    """

    def __init__(self, shards, bounds, home, like, nnz=None, group=None,
                 ranks=None):
        super().__init__()
        # Calls of _sum and _cat, the steps that gather and combine the
        # shards' outputs (read by chip_smoke.py to price them).
        self.combine_count = 0
        self.shards = list(shards)
        self.bounds = [tuple(b) for b in bounds]
        self.device = torch.device(home)
        self.group = group
        self.ranks = None if ranks is None else list(ranks)
        self._local = [i for i, s in enumerate(self.shards) if s is not None]
        if not self._local:
            raise ValueError("this process holds no shard")
        self._n = self.bounds[-1][1]
        self._p = like.shape[1]
        self._dtype = like.dtype
        self._nnz = nnz
        self._is_sparse = like.is_sparse
        self.intercept_added = like.intercept_added
        self.fused_policy = like.fused_policy
        self.backend = getattr(like, 'backend', None)
        if group is not None:
            per = [self.ranks.count(r) for r in sorted(set(self.ranks))]
            if len(set(per)) != 1:
                raise ValueError("every process must hold as many shards")
            n_rank = {}
            for r, (r0, r1) in zip(self.ranks, self.bounds):
                n_rank[r] = n_rank.get(r, 0) + r1 - r0
            self._rows_of_rank = [n_rank[r] for r in sorted(n_rank)]

    @classmethod
    def from_design(cls, design, devices, local=None, group=None,
                    ranks=None):
        """Shard `design` by rows over `devices` (one shard per entry, in
        row order; the same device may repeat): the shards at positions
        `local` (default all) are built here, the others are another
        process's."""
        bounds = row_bounds(design.shape[0], len(devices))
        local = range(len(devices)) if local is None else local
        dense = isinstance(design, DenseDesignMatrix)
        shards = [None] * len(devices)
        for i in local:
            shard = design.row_block(*bounds[i], device=devices[i])
            # A sharded dense design never fuses (dense.py `_sharded`).
            shards[i] = shard.with_policy('0') if dense else shard
        sharded = cls(shards, bounds, devices[min(local)], design, design.nnz
                      if design.is_sparse else None, group, ranks)
        if sharded.backend == 'ell':
            _log.info("ell shards' col-ELL traversal for one vector: %s",
                      sharded.traversals())
        return sharded

    # -- metadata -------------------------------------------------------- #

    @property
    def shape(self):
        return (self._n, self._p)

    @property
    def dtype(self):
        return self._dtype

    @property
    def is_sparse(self):
        return self._is_sparse

    @property
    def nnz(self):
        return self._nnz

    @property
    def n_shards(self):
        return len(self.shards)

    def local_shards(self):
        """[(i, shard)] of the shards this process holds."""
        return [(i, self.shards[i]) for i in self._local]

    def storage_bytes(self):
        """Device bytes of this process's shards' stored arrays (a row
        view counts its rows' bytes)."""
        return sum(s.storage_bytes() for _, s in self.local_shards())

    def traversals(self, k=1):
        """Per local ell shard, the col-ELL traversal a launch of k
        vectors takes: 'windowed', 'first' or 'plain' (a CPU shard)."""
        out = []
        for _, s in self.local_shards():
            lay = getattr(s, 'col_layout', None)
            if s.device.type != 'cuda':
                out.append('plain')
            else:
                out.append('windowed' if lay is not None
                           and lay.windowed(s.dtype, k) else 'first')
        return out

    def with_policy(self, fused):
        """The same shards (stored arrays shared) under another fused
        policy, counters at zero; a dense design's shards stay
        composed."""
        shards = [None if s is None else
                  s if isinstance(s, DenseDesignMatrix) else
                  s.with_policy(fused) for s in self.shards]
        other = ShardedDesignMatrix(
            shards, self.bounds, self.device, self, self._nnz, self.group,
            self.ranks)
        other.fused_policy = fused
        return other

    def _as_tensor(self, x):
        return torch.as_tensor(x, dtype=self._dtype, device=self.device)

    # -- splitting and combining ----------------------------------------- #

    def _each(self, fn, *row_args, whole=()):
        """fn(shard, *its rows of `row_args`, *whole) for each local shard
        in shard order, under the shard's device; `row_args` are cut
        over their last axis (None passes through), `whole` go to the
        shard's device as they are. The matvec counters advance by the
        first local shard's."""
        first = self.shards[self._local[0]]
        d0, t0 = first.dot_count, first.Tdot_count
        outs = []
        for i in self._local:
            shard = self.shards[i]
            r0, r1 = self.bounds[i]
            dev = shard.device
            rows = [None if a is None else a[..., r0:r1].to(dev).contiguous()
                    for a in row_args]
            rest = [a.to(dev) if torch.is_tensor(a) else a for a in whole]
            with on_device(dev):
                outs.append(fn(shard, *rows, *rest))
        self.dot_count += first.dot_count - d0
        self.Tdot_count += first.Tdot_count - t0
        return outs

    def _sum(self, parts):
        """Every shard's partial (this process's `parts`, the others'
        gathered) summed in shard order on the home device."""
        self.combine_count += 1
        parts = [q.to(self.device) for q in parts]
        if self.group is not None:
            parts = self._gather_partials(parts)
        total = parts[0]
        for q in parts[1:]:
            total = total + q
        return total

    def _cat(self, parts, dim=-1):
        """Every shard's rows (this process's `parts`, the others'
        gathered) concatenated along `dim` in shard order on the home
        device."""
        self.combine_count += 1
        parts = [q.to(self.device) for q in parts]
        if self.group is not None:
            return self._gather_rows(torch.cat(parts, dim), dim)
        return torch.cat(parts, dim)

    def _sum_tuples(self, tuples):
        return tuple(self._sum(list(col)) for col in zip(*tuples))

    def _gather_partials(self, parts):
        """Each process's local partials, all_gathered: every shard's, in
        shard order (a process's shards are consecutive)."""
        mine = torch.stack(parts)
        got = [torch.empty_like(mine) for _ in self._rows_of_rank]
        torch.distributed.all_gather(got, mine.contiguous(),
                                     group=self.group)
        return [q for block in got for q in block]

    def _gather_rows(self, mine, dim):
        """Each process's rows along `dim`, all_gathered and
        concatenated in process order (padded to the longest for the
        collective, cut after it)."""
        mine = mine.movedim(dim, -1)
        width = max(self._rows_of_rank)
        pad = torch.zeros(mine.shape[:-1] + (width,), dtype=mine.dtype,
                          device=mine.device)
        pad[..., :mine.shape[-1]] = mine
        got = [torch.empty_like(pad) for _ in self._rows_of_rank]
        torch.distributed.all_gather(got, pad, group=self.group)
        out = torch.cat([g[..., :m] for g, m in zip(got, self._rows_of_rank)],
                        -1)
        return out.movedim(-1, dim)

    # -- products -------------------------------------------------------- #

    @memoized_dot
    def dot(self, v):
        """X v, or X v_c for each row of v (k, p): (k, n)."""
        v = self._as_tensor(v)
        return self._cat(self._each(lambda s, vv: s.dot(vv), whole=(v,)))

    def Tdot(self, u):
        """X' u, or X' u_c for each row of u (k, n): (k, p)."""
        return self._sum(self._each(lambda s, uu: s.Tdot(uu),
                                    self._as_tensor(u)))

    def quad_matvec(self, v, weight, return_t=False):
        """X' (weight * (X v)), each shard's by its own policy (fused on
        its rows, or composed), the partials summed; with `return_t`
        also t = X v, the shards' rows concatenated."""
        outs = self._each(
            lambda s, w, vv: s.quad_matvec(vv, w, return_t),
            self._as_tensor(weight), whole=(self._as_tensor(v),))
        if not return_t:
            return self._sum(outs)
        return (self._sum([o for o, _ in outs]),
                self._cat([t for _, t in outs]))

    def cg_blockorder_ctx(self):
        """The shards' common block order (every shard has the whole
        design's column split), on the home device."""
        ctx = self.shards[self._local[0]].cg_blockorder_ctx()
        return None if ctx is None else tuple(t.to(self.device)
                                              for t in ctx)

    def quad_matvec_blockorder(self, v_bo, weight, offset_bo,
                               return_t=False):
        outs = self._each(
            lambda s, w, vv, off: s.quad_matvec_blockorder(vv, w, off,
                                                           return_t),
            self._as_tensor(weight),
            whole=(self._as_tensor(v_bo), self._as_tensor(offset_bo)))
        if not return_t:
            return self._sum(outs)
        return (self._sum([o for o, _ in outs]),
                self._cat([t for _, t in outs]))

    def fused_ne_mode(self, kind='quad'):
        return self.shards[self._local[0]].fused_ne_mode(kind)

    def has_presolve_reductions(self):
        return self.shards[self._local[0]].has_presolve_reductions()

    def fused_link_grad(self, v, a, b, mid):
        """(loglik, gradient): each shard's over its rows, both summed;
        None where the shards compose 'link'."""
        if self.fused_ne_mode('link') is None:
            return None
        outs = self._each(
            lambda s, aa, bb, vv: s.fused_link_grad(vv, aa, bb, mid),
            None if a is None else self._as_tensor(a), self._as_tensor(b),
            whole=(self._as_tensor(v),))
        return self._sum_tuples(outs)

    def presolve_reductions(self, u1, u2, u3, u4=None):
        us = [self._as_tensor(u) for u in (u1, u2, u3)]
        us.append(None if u4 is None else self._as_tensor(u4))
        return self._sum_tuples(self._each(
            lambda s, a, b, c, d: s.presolve_reductions(a, b, c, d), *us))

    def compute_fisher_diag(self, weight):
        return self._sum(self._each(lambda s, w: s.compute_fisher_diag(w),
                                    self._as_tensor(weight)))

    def compute_fisher_info(self, weight, diag_only=False):
        return self._sum(self._each(
            lambda s, w: s.compute_fisher_info(w, diag_only),
            self._as_tensor(weight)))

    def compute_transposed_fisher_info(self, weight, include_intrcpt=False):
        """X diag(weight) X' over predictors (n x n, small designs only),
        from the whole design gathered on the home device."""
        weight = self._as_tensor(weight)
        X = self.extract_matrix()
        X_main = X[:, 1:] if self.intercept_added else X
        weight_main = weight[1:] if include_intrcpt else weight
        with full_float32():
            result = (X_main * weight_main[None, :]) @ X_main.T
        if include_intrcpt:
            result = result + weight[0]
        return result

    def extract_matrix(self, order=None):
        """The whole design (intercept and centering included), dense, on
        the home device; guarded by each shard, for small designs."""
        return self._cat(self._each(lambda s: s.extract_matrix()), dim=0)

    def toarray(self):
        parts = [torch.from_numpy(s.toarray()) for _, s in
                 self.local_shards()]
        return self._cat(parts, dim=0).cpu().numpy()
