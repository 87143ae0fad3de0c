"""Column pieces: a design's predictors cut for the predictor axis of a
2-d obs x pred mesh (:mod:`.sharded`).

A :class:`ColumnPiece` says how the sharded design talks to the designs
built for one column piece (one per mesh row, ``design.block``). Every
piece is a design of its own columns alone, in the whole design's
order, its intercept (where the design has one) the first column of
piece 0: its input is a full-width input's entries at ``cols`` (the
last axis, intercept first), and its output goes to the same entries of
a full-width output. A dense piece and an ell column piece hold a
contiguous range of columns (``cols`` a slice); a hybrid or bitpack
piece holds a range of each stored block's columns, which interleave
in the whole design (``cols`` an index tensor).

:data:`WHOLE` is the one piece of a design that is not split (the 1-d
mesh).
"""

import collections

import torch

ColumnPiece = collections.namedtuple('ColumnPiece', 'spans first cols')
ColumnPiece.__doc__ = """One column piece.

spans : the backend's column ranges of the piece (positions in its
    stored blocks), read by ``design.block``; None for :data:`WHOLE`
first : whether it is piece 0, the one that holds the intercept
cols : the piece's positions in a full-width input or output, in the
    piece's column order (a slice or a long tensor)
"""

WHOLE = ColumnPiece(None, True, slice(None))


def split_units(n, c, unit):
    """[(start, end)] of `c` pieces of n positions cut at multiples of
    `unit`, each ceil(ceil(n / unit) / c) units long, the last ones
    shorter or empty."""
    size = -(-(-(-n // unit)) // c) * unit
    return [(min(n, j * size), min(n, (j + 1) * size)) for j in range(c)]


def renumber(*cols):
    """(main, [local]): the sorted union `main` of the main column index
    tensors `cols` (disjoint), and each one's positions in it."""
    main = torch.sort(torch.cat(cols))[0]
    return main, [torch.searchsorted(main, c) for c in cols]


def indexed_piece(spans, first, main, design_intercept, device):
    """The :class:`ColumnPiece` of a piece whose main columns are the
    sorted index tensor `main`; piece 0 (`first`) holds the intercept
    where the design has one."""
    d = int(design_intercept)
    head = torch.zeros(d if first else 0, dtype=main.dtype,
                       device=main.device)
    return ColumnPiece(spans, first, torch.cat((head, main + d)).to(device))


def main_columns(piece, design_intercept):
    """The main column indices (of the design without its intercept) of
    an :func:`indexed_piece`."""
    d = int(design_intercept)
    return piece.cols[d if piece.first else 0:] - d
