"""Helpers for tensors that carry a leading chain axis.

Several Markov chains run as one batched step (``multichain``): every
per-chain vector is a row of a (k, m) tensor. Chain c of a batch must
compute what chain c alone computes, draw for draw, so that a batch is
only a faster way to run its chains. Elementwise arithmetic is the same
per element however the rows are laid out; sums over a row are not,
since a reduction's plan (its split across threads and blocks) depends on
the tensor's shape and, on the GPU, on where the row starts. :func:`rsum`,
:func:`rdot` and :func:`rnorm` therefore reduce each chain's row on its
own, as the one-chain vector it is (a row that does not start on a
16-byte boundary is copied first): one reduction launch per chain, each
the single-vector reduction of that chain. On the CPU, PyTorch's pow and
softplus run a vector routine on whole vector widths and the scalar libm
on a tensor's tail, which can differ in the last bit, so where an
element falls would change its value; :func:`pow_pos` and
:func:`softplus` are written with exp, log and log1p, whose tails take
the vector routine too.
"""

import torch


def _rows(x):
    """The rows of a (k, m) tensor, each starting on a 16-byte boundary."""
    return [r if r.data_ptr() % 16 == 0 else r.clone() for r in x]


def rsum(x):
    """Sum over the last axis: x.sum() of a vector, each row's alone of
    a (k, m) tensor."""
    if x.dim() == 1:
        return x.sum()
    return torch.stack([r.sum() for r in _rows(x)])


def rdot(a, b):
    """Dot products over the last axis: torch.dot of vectors, each row's
    alone for (k, m) operands (a vector broadcast to every row)."""
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    k = a.shape[0] if a.dim() == 2 else b.shape[0]
    ra = _rows(a) if a.dim() == 2 else [a] * k
    rb = _rows(b) if b.dim() == 2 else [b] * k
    return torch.stack([torch.dot(x, y) for x, y in zip(ra, rb)])


def rnorm(x):
    """Euclidean norm over the last axis, each row's alone."""
    if x.dim() == 1:
        return torch.linalg.vector_norm(x)
    return torch.stack([torch.linalg.vector_norm(r) for r in _rows(x)])


def pow_pos(x, a):
    """x ** a for x >= 0, as exp(a log x)."""
    return torch.exp(a * torch.log(x))


def softplus(x):
    """log(1 + e^x), written stably."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def per_chain(fn, *args):
    """fn on each chain's slices of the (k, ...) tensor arguments (None
    passes through as None), the results stacked along a leading chain
    axis (tuples element by element)."""
    k = next(a.shape[0] for a in args if a is not None)
    outs = [fn(*(None if a is None else a[i] for a in args))
            for i in range(k)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)
