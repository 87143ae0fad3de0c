"""A design split over the devices of a mesh: by rows over a 1-d
observation mesh, by rows and columns over a 2-d obs x pred mesh.

Counterpart of the JAX package's sharded designs
(``bayesbridge_tpu/parallel/sharding.py``; ``design/sparse.py``
``_fused_sharded_call``, ``shard_bitpack``, ``shard_winell``). The JAX
package places its arrays with ``NamedSharding`` and GSPMD inserts the
``psum`` collectives into the jitted step. This package runs eagerly,
so the split lives one layer down, in the design: every caller reaches X
only through the design's interface (`dot`, `Tdot`, `quad_matvec`,
`quad_matvec_blockorder`, `cg_blockorder_ctx`, `fused_ne_mode`,
`fused_link_grad`, `presolve_reductions`, the Fisher products), and
:class:`ShardedDesignMatrix` implements it over ordinary designs, its
pieces.

The grid. Mesh row i holds the observations of row block i (blocks of
ceil(n / r) rows, the last shorter; :func:`row_bounds`); mesh column j
holds column piece j (``design.column_pieces``, :mod:`.pieces`). Piece
(i, j) is ``design.block(r0, r1, piece j)`` on mesh entry (i, j). On a
1-d mesh (or a 2-d one with one column) the one column piece is the whole
design and a piece is a row block (``row_block``); on the design's device
its blocks are row views, not copies. The layouts per backend
(``column_pieces``, ``block``):

- hybrid: each stored block's columns cut into c near-equal ranges, the
  exact block's at multiples of 32 columns (an int8 block where its int4
  packing would be cut, so that both tiers give the same pieces), the
  float block's at multiples of 4; each piece a copy, its rows whole
  16-byte units, a design of its columns alone with the whole design's
  exact / float split, offsets and int4 flags restricted to them;
- dense: the stored columns (intercept and centering in them) in
  16-byte units;
- bitpack: the binary columns at whole byte-groups of bits_col (8
  columns), each piece with its own bitmap plans; the float side block
  split like the hybrid's float block;
- ell: not a grid. The row-ELL's pieces go by rows, one per mesh row on
  its first device (``ell_row_piece``: X v and the Gram), the col-ELL's
  by predictors, one per mesh column on this process's first mesh row
  (``ell_col_piece``, each over every row: X' u and the Fisher
  diagonal), as the JAX package shards ``col_idx`` over ``pred``. So X v
  sums nothing over ``pred`` and X' u nothing over ``obs``. Each piece
  runs once; each col-ELL piece decides its traversal on its own shape
  (:meth:`ShardedDesignMatrix.traversals`);
- winell: over ``obs`` only, the grid's first column (the JAX package's
  warning is ``parallel.shard_design``'s).

The combine, in one fixed order on the home device (the mesh's first
device of this process):

- an output of length n: for each row block, its pieces' partials summed
  in ``pred`` order, then the blocks concatenated in ``obs`` order;
- an output of length p: for each column piece, its partials summed in
  ``obs`` order, then placed at the piece's columns (``cols``);
- the Gram of a predictor split (``compute_fisher_info``, the Cholesky
  sampler's): for each row block, its pieces' rows brought in row chunks
  to the first device of its mesh row (each piece's stored columns
  widened to the working dtype: 4 (float32) or 8 (float64) bytes a
  row and column of a piece off that device, none on it), the row
  block's Gram there, then the blocks' Grams summed in ``obs`` order and
  the centering and intercept applied once.

A (r, 1) mesh thus gives the 1-d mesh's bits, and a result has the same
bits whether the pieces sit on one card, on several, or in several
processes: in a process group (``parallel.distributed``) each process
holds whole mesh rows, and the others' partials and rows arrive by
``all_gather`` in the global order before every process combines them.

On the 1-d mesh the hybrid shards run the fused kernels on their own
rows wherever the policy fuses, as the JAX package's ``shard_map`` does;
the composed CG operator runs block-ordered (``cg_blockorder_ctx``). A
predictor split composes every call site (``fused_ne_mode`` is None for
'quad', 'presolve' and 'link'; ``cg_blockorder_ctx`` is None), as the
JAX package's 2-d hybrid does (``sparse.py:1050``): the fused kernels
would need a collective between their two phases. The pre-solve
reductions and the Fisher diagonal run per piece. A sharded dense design
never fuses (the JAX dense design's ``_sharded``).

The chain state stays on the home device, whole (replicated in the JAX
sense): coef, the scales, the n-vectors, the Cox risk sets. Inputs of
length n are cut into the pieces' rows; inputs of length p go to each
piece as their entries at its ``cols`` (every piece is a design of its
own columns, :mod:`.pieces`); chain batches (a leading axis of k
chains) go along.

The matvec counters count one product per call, as the unsharded design
does (the first local piece's counts, not their sum), so ``n_cg_iter``
and the HMC counts read the same. On a CUDA piece the kernels run or the
call raises; nothing falls back to the plain versions or to the CPU.
"""

import contextlib
import logging

import torch

from .abstract import AbstractDesignMatrix, memoized_dot
from .dense import DenseDesignMatrix
from .gram import chunked_gram
from .pieces import WHOLE, main_columns
from .sparse import _DENSE_FISHER_MAX_ELEMS, fisher_from_moments
from ..utils.chains import per_chain
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
    """The design interface over a mesh's pieces (module docstring).

    Parameters
    ----------
    shards : the pieces, mesh row by mesh row (row i's at i * c ... i * c
        + c - 1 for c column pieces; of an ell design's predictor split,
        one row-ELL piece a mesh row), each the piece where this process
        holds it, else None
    bounds : [(r0, r1)] of each mesh row's observations
    home : the device that holds the chain state and every combined
        output
    like : a design of the same kind and layout (the source design, or
        another sharded design of it), read for the metadata
    nnz : the whole design's stored entries (None where unknown)
    group : the process group whose processes hold the other mesh rows,
        or None (every piece is this process's)
    ranks : the process of each mesh row (with `group`)
    col_pieces : the column pieces (:mod:`.pieces`), default ``[WHOLE]``
    col_shards : of an ell design's predictor split, the col-ELL pieces,
        one a column piece; else None
    """

    def __init__(self, shards, bounds, home, like, nnz=None, group=None,
                 ranks=None, col_pieces=(WHOLE,), col_shards=None):
        super().__init__()
        # Calls of _sum and _cat, the steps that gather and combine the
        # pieces' outputs (read by chip_smoke.py to price them).
        self.combine_count = 0
        self.shards = list(shards)
        self.bounds = [tuple(b) for b in bounds]
        self.col_pieces = list(col_pieces)
        self.col_shards = None if col_shards is None else list(col_shards)
        self.device = torch.device(home)
        self.group = group
        self.ranks = None if ranks is None else list(ranks)
        per = len(self.shards) // len(self.bounds)
        self._local = [i for i in range(len(self.bounds))
                       if self.shards[i * per] is not None]
        if not self._local:
            raise ValueError("this process holds no shard")
        if any(s is None for i in self._local
               for s in self.shards[i * per:(i + 1) * per]):
            raise ValueError("a process must hold whole mesh rows: every "
                             "column piece of each of its row blocks")
        self._n = self.bounds[-1][1]
        self._p = like.shape[1]
        self._dtype = like.dtype
        self._nnz = nnz
        self._is_sparse = like.is_sparse
        self.intercept_added = like.intercept_added
        self.centered = like.centered
        self.column_offset = getattr(like, 'column_offset', None)
        if self.column_offset is not None:
            self.column_offset = self.column_offset.to(self.device)
        self.fused_policy = like.fused_policy
        self.backend = getattr(like, 'backend', None)
        self._presolve = like.has_presolve_reductions()
        self._dense = isinstance(like, DenseDesignMatrix) or (
            isinstance(like, ShardedDesignMatrix) and like._dense)
        # A predictor split composes everything; one column piece is the
        # 1-d mesh.
        self._whole = len(self.col_pieces) == 1
        if self.col_shards is None:
            c = len(self.col_pieces)
            self._dot_jobs = [(self.shards[i * c + j], self.bounds[i], cp)
                              for i in self._local
                              for j, cp in enumerate(self.col_pieces)]
            self._tdot_jobs = [(self.shards[i * c + j], self.bounds[i], cp)
                               for j, cp in enumerate(self.col_pieces)
                               for i in self._local]
        else:  # the ell predictor split: row-ELL and col-ELL pieces
            self._dot_jobs = [(self.shards[i], self.bounds[i], WHOLE)
                              for i in self._local]
            self._tdot_jobs = [(s, (0, self._n), cp) for s, cp
                               in zip(self.col_shards, self.col_pieces)]
        if group is not None:
            per_rank = [self.ranks.count(r) for r in sorted(set(self.ranks))]
            if len(set(per_rank)) != 1:
                raise ValueError("every process must hold as many shards")
            n_rank = {}
            for r, (r0, r1) in zip(self.ranks, self.bounds):
                n_rank[r] = n_rank.get(r, 0) + r1 - r0
            self._rows_of_rank = [n_rank[r] for r in sorted(n_rank)]

    @classmethod
    def from_design(cls, design, devices, local=None, group=None,
                    ranks=None, grid=None):
        """Shard `design` over `devices`, an r x c grid in row-major order
        (`grid` = (r, c); default one column: the 1-d mesh; a device may
        repeat): the pieces of the mesh rows whose entries are in `local`
        (default all) are built here, the others are another process's.
        `ranks`: the process of each mesh row."""
        r, c = grid or (len(devices), 1)
        if r * c != len(devices):
            raise ValueError(f"{len(devices)} devices for a {r} x {c} grid")
        local = list(range(len(devices)) if local is None else local)
        rows = sorted({i // c for i in local})
        if sorted(local) != [i * c + j for i in rows for j in range(c)]:
            raise ValueError("a process's mesh entries must be whole mesh "
                             "rows")
        home = devices[min(local)]
        bounds = row_bounds(design.shape[0], r)
        pieces = design.column_pieces(c, home) if c > 1 else [WHOLE]
        dense = isinstance(design, DenseDesignMatrix)
        col_shards = None
        if design.is_sparse and design.backend == 'ell' and len(pieces) > 1:
            shards = [None] * r
            for i in rows:
                shards[i] = design.ell_row_piece(*bounds[i],
                                                 device=devices[i * c])
            col_shards = [design.ell_col_piece(cp, devices[rows[0] * c + j])
                          for j, cp in enumerate(pieces)]
        else:
            live = len(pieces)
            shards = [None] * (r * live)
            for i in rows:
                for j, cp in enumerate(pieces):
                    piece = design.block(*bounds[i], cp, devices[i * c + j])
                    # A sharded dense design never fuses (dense.py
                    # `_sharded`).
                    shards[i * live + j] = piece.with_policy('0') if dense \
                        else piece
        sharded = cls(shards, bounds, home, design,
                      design.nnz if design.is_sparse else None, group,
                      ranks, pieces, col_shards)
        if sharded.backend == 'ell':
            _log.info("ell pieces' col-ELL traversal for one vector: %s",
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
        """[(position, piece)] of the pieces this process holds, in the
        order of `shards` (an ell predictor split's col-ELL pieces are
        `col_shards`)."""
        return [(i, s) for i, s in enumerate(self.shards) if s is not None]

    def _pieces(self):
        """This process's pieces, the col-ELL pieces included."""
        return [s for _, s in self.local_shards()] + (self.col_shards or [])

    def storage_bytes(self):
        """Device bytes of this process's pieces' stored arrays (a row
        view counts its rows' bytes)."""
        return sum(s.storage_bytes() for s in self._pieces())

    def counters(self):
        """Its own counters, `combine_count` and its pieces'."""
        return super().counters() + [(self, 'combine_count')] + [
            c for s in self._pieces() for c in s.counters()]

    def devices(self):
        """Its pieces' devices; None with a process group."""
        if self.group is not None:
            return None
        return set().union(*(s.devices() for s in self._pieces()))

    def traversals(self, k=1):
        """Per local piece that holds a col-ELL (the row blocks of a 1-d
        mesh, or the col-ELL pieces of a predictor split), the traversal
        a launch of k vectors takes: 'windowed', 'first' or 'plain' (a
        CPU piece)."""
        out = []
        for s in self.col_shards or [s for _, s in self.local_shards()]:
            lay = getattr(s, 'col_layout', None)
            if s.device.type != 'cuda':
                out.append('plain')
            else:
                out.append('windowed' if lay is not None
                           and lay.windowed(s.dtype, k) else 'first')
        return out

    def with_policy(self, fused):
        """The same pieces (stored arrays shared) under another fused
        policy, counters at zero; a dense design's pieces, and the pieces
        of a predictor split, stay composed."""
        shards = self.shards
        if self._whole:
            shards = [None if s is None else
                      s if isinstance(s, DenseDesignMatrix) else
                      s.with_policy(fused) for s in shards]
        other = ShardedDesignMatrix(
            shards, self.bounds, self.device, self, self._nnz, self.group,
            self.ranks, self.col_pieces, self.col_shards)
        other.fused_policy = fused
        return other

    def has_presolve_reductions(self):
        return self._presolve

    def _as_tensor(self, x):
        return torch.as_tensor(x, dtype=self._dtype, device=self.device)

    # -- splitting and combining ----------------------------------------- #

    def _each(self, jobs, fn, *row_args, whole=()):
        """fn(piece, *its rows of `row_args`, *its part of `whole`) for
        each (piece, (r0, r1), column piece) of `jobs`, under the piece's
        device; `row_args` are cut over their last axis (None passes
        through), `whole` (length p; other values pass through) to the
        column piece's ``cols``. The matvec counters advance by the first
        job's piece's."""
        first = jobs[0][0]
        d0, t0 = first.dot_count, first.Tdot_count
        outs = []
        for piece, (r0, r1), cp in jobs:
            dev = piece.device
            rows = [None if a is None else a[..., r0:r1].to(dev).contiguous()
                    for a in row_args]
            rest = [a[..., cp.cols].to(dev) if torch.is_tensor(a) else a
                    for a in whole]
            with on_device(dev):
                outs.append(fn(piece, *rows, *rest))
        self.dot_count += first.dot_count - d0
        self.Tdot_count += first.Tdot_count - t0
        return outs

    def _sum(self, parts, gather=True):
        """Every mesh row's partial (this process's `parts`, the others'
        gathered where `gather`) summed in row order on the home
        device."""
        self.combine_count += 1
        parts = [q.to(self.device) for q in parts]
        if self.group is not None and gather:
            parts = self._gather_partials(parts)
        total = parts[0]
        for q in parts[1:]:
            total = total + q
        return total

    def _cat(self, parts, dim=-1):
        """Every mesh row's rows (this process's `parts`, the others'
        gathered) concatenated along `dim` in row order on the home
        device."""
        self.combine_count += 1
        parts = [q.to(self.device) for q in parts]
        if self.group is not None:
            return self._gather_rows(torch.cat(parts, dim), dim)
        return torch.cat(parts, dim)

    def _place(self, sums, pieces):
        """The full-width output (last axis) of column pieces' results
        `sums`, each piece's at its ``cols``."""
        if len(pieces) == 1 and pieces[0].spans is None:
            return sums[0]
        s0 = sums[0]
        out = torch.zeros(s0.shape[:-1] + (self._p,), dtype=s0.dtype,
                          device=self.device)
        for cp, s in zip(pieces, sums):
            out[..., cp.cols] = s.to(self.device)
        return out

    def _by_rows(self, parts, dim=-1):
        """The n-output of the `_dot_jobs` results `parts`: each mesh
        row's pieces summed in column order, the rows concatenated."""
        per = len(parts) // len(self._local)
        rows = []
        for k in range(0, len(parts), per):
            total = parts[k].to(self.device)
            for q in parts[k + 1:k + per]:
                total = total + q.to(self.device)
            rows.append(total)
        return self._cat(rows, dim)

    def _by_cols(self, parts):
        """The p-output of the `_tdot_jobs` results `parts` (tensors, or
        tuples of them): each column piece's partials summed in row
        order, then placed."""
        if isinstance(parts[0], tuple):
            return tuple(self._by_cols(list(col)) for col in zip(*parts))
        per = len(parts) // len(self.col_pieces)
        sums = [self._sum(parts[k:k + per], gather=self.col_shards is None)
                for k in range(0, len(parts), per)]
        return self._place(sums, self.col_pieces)

    def _gather_partials(self, parts):
        """Each process's local partials, all_gathered: every mesh row's,
        in row order (a process's rows are consecutive)."""
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
        return self._by_rows(self._each(self._dot_jobs,
                                        lambda s, vv: s.dot(vv), whole=(v,)))

    def Tdot(self, u):
        """X' u, or X' u_c for each row of u (k, n): (k, p)."""
        return self._by_cols(self._each(self._tdot_jobs,
                                        lambda s, uu: s.Tdot(uu),
                                        self._as_tensor(u)))

    def quad_matvec(self, v, weight, return_t=False):
        """X' (weight * (X v)). On the 1-d mesh each shard's by its own
        policy (fused on its rows, or composed), the partials summed;
        with `return_t` also t = X v, the shards' rows concatenated. A
        predictor split composes: `dot`, then `Tdot`."""
        weight = self._as_tensor(weight)
        v = self._as_tensor(v)
        if not self._whole:
            return super().quad_matvec(v, weight, return_t)
        outs = self._each(
            self._dot_jobs, lambda s, w, vv: s.quad_matvec(vv, w, return_t),
            weight, whole=(v,))
        if not return_t:
            return self._sum(outs)
        return (self._sum([o for o, _ in outs]),
                self._cat([t for _, t in outs]))

    def cg_blockorder_ctx(self):
        """On the 1-d mesh, the shards' common block order (every shard
        has the whole design's column split), on the home device; None
        on a predictor split, as in the JAX package."""
        if not self._whole:
            return None
        ctx = self._dot_jobs[0][0].cg_blockorder_ctx()
        return None if ctx is None else tuple(t.to(self.device)
                                              for t in ctx)

    def quad_matvec_blockorder(self, v_bo, weight, offset_bo,
                               return_t=False):
        outs = self._each(
            self._dot_jobs,
            lambda s, w, vv, off: s.quad_matvec_blockorder(vv, w, off,
                                                           return_t),
            self._as_tensor(weight),
            whole=(self._as_tensor(v_bo), self._as_tensor(offset_bo)))
        if not return_t:
            return self._sum(outs)
        return (self._sum([o for o, _ in outs]),
                self._cat([t for _, t in outs]))

    def fused_ne_mode(self, kind='quad'):
        if not self._whole:
            return None
        return self._dot_jobs[0][0].fused_ne_mode(kind)

    def fused_link_grad(self, v, a, b, mid):
        """(loglik, gradient): each shard's over its rows, both summed;
        None where the shards compose 'link' (and on a predictor
        split)."""
        if self.fused_ne_mode('link') is None:
            return None
        outs = self._each(
            self._dot_jobs,
            lambda s, aa, bb, vv: s.fused_link_grad(vv, aa, bb, mid),
            None if a is None else self._as_tensor(a), self._as_tensor(b),
            whole=(self._as_tensor(v),))
        return tuple(self._sum(list(col)) for col in zip(*outs))

    def presolve_reductions(self, u1, u2, u3, u4=None):
        us = [self._as_tensor(u) for u in (u1, u2, u3)]
        us.append(None if u4 is None else self._as_tensor(u4))
        return self._by_cols(self._each(
            self._tdot_jobs,
            lambda s, a, b, c, d: s.presolve_reductions(a, b, c, d), *us))

    def compute_fisher_diag(self, weight):
        return self._by_cols(self._each(
            self._tdot_jobs, lambda s, w: s.compute_fisher_diag(w),
            self._as_tensor(weight)))

    def compute_fisher_info(self, weight, diag_only=False):
        """X' W X, or its diagonal. Where every piece holds whole rows
        (the 1-d mesh; an ell design's row-ELL pieces) the pieces' own,
        summed in row order; on a predictor split the route of the
        module docstring."""
        weight = self._as_tensor(weight)
        if diag_only:
            return self.compute_fisher_diag(weight)
        if self._whole or self.col_shards is not None:
            return self._sum(self._each(
                self._dot_jobs, lambda s, w: s.compute_fisher_info(w),
                weight))
        return self._grid_gram(weight)

    def _grid_gram(self, weight):
        if weight.dim() == 2:
            return per_chain(self._grid_gram, weight)
        if not self._dense and self._p ** 2 > _DENSE_FISHER_MAX_ELEMS:
            raise MemoryError(
                "Refusing to build a {:d} x {:d} dense Fisher information "
                "matrix; use the CG sampler.".format(self._p, self._p))
        c = len(self.col_pieces)
        grams, sums = [], []
        for i in self._local:
            pieces = self.shards[i * c:(i + 1) * c]
            r0, r1 = self.bounds[i]
            dev = pieces[0].device
            w = weight[r0:r1].to(dev)
            if self._dense:  # the stored columns, in order
                def chunk(start, size):
                    return torch.cat([s.X_main[start:start + size].to(dev)
                                      for s in pieces], 1)
                width = self._p
            else:  # each piece's stored columns, as whole-design columns
                own = torch.cat([
                    main_columns(cp, self.intercept_added).to(dev)[
                        s._own_cols().to(dev)]
                    for s, cp in zip(pieces, self.col_pieces)])

                def chunk(start, size):
                    return torch.cat([s._main_panel(start, size).to(dev)
                                      for s in pieces], 1)
                width = own.numel()
            with on_device(dev):
                G, s1 = chunked_gram(chunk, r1 - r0, width, w, self._dtype)
                if not self._dense:
                    inv = torch.argsort(own)
                    G, s1 = G[inv][:, inv], s1[inv]
            grams.append(G)
            sums.append(s1)
        G = self._sum(grams)
        if self._dense:
            return G
        return fisher_from_moments(G, self._sum(sums), weight.sum(),
                                   self.column_offset, self.centered,
                                   self.intercept_added)

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

    def _assemble_rows(self, fn):
        """The whole design from fn(piece) of every row piece (an (m, w)
        tensor of the piece's output columns), placed and concatenated
        on the home device."""
        parts = self._each(self._dot_jobs, fn)
        per = len(parts) // len(self._local)
        rows = [self._place([q.to(self.device) for q in parts[k:k + per]],
                            [cp for _, _, cp in self._dot_jobs[k:k + per]])
                for k in range(0, len(parts), per)]
        return self._cat(rows, dim=0)

    def extract_matrix(self, order=None):
        """The whole design (intercept and centering included), dense, on
        the home device; guarded by each piece, for small designs."""
        return self._assemble_rows(lambda s: s.extract_matrix())

    def toarray(self):
        return self._assemble_rows(
            lambda s: torch.from_numpy(s.toarray())).cpu().numpy()
