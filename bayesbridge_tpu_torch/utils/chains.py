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


_RUN = 1024  # elements a prefix sum scans in one run


def prefix_sum(x):
    """Inclusive prefix sum of the vector x, in an order fixed by its
    length: runs of ``_RUN`` elements each scanned on its own (the rows of
    a 2-d scan), then each run offset by the prefix sum of the runs'
    totals (the same, recursively). On the card this gives the same bits
    every run; the scan of one long vector there (CUB's, whose tiles look
    back at their predecessors' sums as those become ready) may not: a
    Cox chain on 100,000 rows did not resume exactly with it."""
    n = x.shape[0]
    if n <= _RUN:
        return torch.cumsum(x, 0)
    runs = -(-n // _RUN)
    padded = torch.zeros(runs * _RUN, dtype=x.dtype, device=x.device)
    padded[:n] = x
    scanned = torch.cumsum(padded.view(runs, _RUN), 1)
    before = prefix_sum(scanned[:, -1])
    offsets = torch.cat((torch.zeros(1, dtype=x.dtype, device=x.device),
                         before[:-1]))
    return (scanned + offsets[:, None]).view(-1)[:n]


def rcumsum(x):
    """Cumulative sum over the last axis (:func:`prefix_sum`), each row's
    alone of a (k, m) tensor."""
    if x.dim() == 1:
        return prefix_sum(x)
    return torch.stack([prefix_sum(r) for r in _rows(x)])


def sigmoid(x):
    """1 / (1 + e^-x), written with exp (as the JAX package writes it)."""
    return 1.0 / (1.0 + torch.exp(-x))


def take(x, rows):
    """The chains `rows` (a LongTensor) of a per-chain tensor (leading
    chain axis); x itself where rows is None or x is not a tensor."""
    if rows is None or not torch.is_tensor(x) or x.dim() == 0:
        return x
    return x[rows]


# -- chains that run their own loops side by side -------------------------- #
#
# A sampler whose loop length depends on the chain (a leapfrog trajectory
# that stops when it turns or diverges, a power iteration that stops at
# its tolerance) is written as a Python generator per chain, in the order
# one chain alone computes. It yields a request and is sent the answer:
#
#     ('eval', x)  x a vector of the chain; the answer is the chain's row
#                  of the target at x (a tensor or a tuple of tensors);
#     ('host', t)  t a tensor on the device; the answer is t.tolist().
#
# run_lockstep answers every chain's 'host' requests with one transfer,
# then evaluates the target once for every chain that waits on 'eval'
# (the design's products read X once for the batch); a chain whose loop
# has ended leaves the batch. drive runs one chain against a target of
# one vector. LOCKSTEP counts run_lockstep's host transfers and target
# calls (the chip smoke reads them per iteration).

LOCKSTEP = {'host': 0, 'eval': 0}


def _answer(res, j):
    """Row j of a batched result (a tensor or a tuple of tensors), each
    row starting on a 16-byte boundary."""
    if isinstance(res, tuple):
        return tuple(_answer(r, j) for r in res)
    row = res[j]
    return row if row.dim() == 0 or row.data_ptr() % 16 == 0 \
        else row.clone()


def run_lockstep(coros, evaluate):
    """Run one generator per chain (see above) to its end; evaluate(X,
    rows) gives the target's rows for the stacked vectors X (m, ...) of
    the chains `rows` (a LongTensor into the batch). Returns each chain's
    return value."""
    results = [None] * len(coros)
    pending = {}

    def advance(c, answer):
        try:
            pending[c] = coros[c].send(answer)
        except StopIteration as stop:
            results[c] = stop.value
            pending.pop(c, None)

    for c in range(len(coros)):
        advance(c, None)
    while pending:
        host = [c for c, req in pending.items() if req[0] == 'host']
        if host:
            flat = [pending[c][1].reshape(-1) for c in host]
            values = torch.cat(flat).tolist()
            LOCKSTEP['host'] += 1
            start = 0
            for c, f in zip(host, flat):
                n = f.numel()
                one = pending[c][1].dim() == 0
                advance(c, values[start] if one
                        else values[start:start + n])
                start += n
            continue
        chains = sorted(pending)
        X = torch.stack([pending[c][1] for c in chains])
        rows = torch.as_tensor(chains, device=X.device)
        res = evaluate(X, rows)
        LOCKSTEP['eval'] += 1
        for j, c in enumerate(chains):
            advance(c, _answer(res, j))
    return results


def drive(coro, f):
    """Run one chain's generator with f(x) answering its 'eval' requests
    (x a vector of the chain). Returns its return value."""
    answer = None
    while True:
        try:
            kind, x = coro.send(answer)
        except StopIteration as stop:
            return stop.value
        answer = f(x) if kind == 'eval' else x.tolist()
