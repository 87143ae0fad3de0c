"""Random-state facade for the Gibbs sampler.

Port of ``bayesbridge_tpu/random/basic.py``: all randomness flows from
one ``torch.Generator`` on the model's device (Philox on CUDA). Its
state is the checkpoint, so a resumed chain equals an uninterrupted one.
JAX's threefry keys and torch's generators give different numbers from
the same seed; the two packages agree in distribution, not in bits.
Several chains take one generator each (:meth:`BasicRandom.spawn`).
"""

import numpy as np
import torch

from .polya_gamma import sample_polya_gamma
from .tilted_stable import sample_tilted_stable


def generator_state(gen):
    """A generator's state as a host uint8 array (the checkpoint)."""
    return gen.get_state().cpu().numpy().copy()


def generator_from_state(state, device):
    """A generator on `device` restored from :func:`generator_state`."""
    gen = torch.Generator(device=torch.device(device))
    gen.set_state(torch.from_numpy(np.asarray(state, np.uint8).copy()))
    return gen


class BasicRandom:
    """Owns the generator and exposes the sampler kernels; draws come in
    `dtype` (the chain's)."""

    def __init__(self, device, seed=None, dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = torch.Generator(device=self.device)
        self.set_seed(seed)

    def set_seed(self, seed):
        if seed is None:
            seed = int(np.random.SeedSequence().entropy % (2 ** 63))
        self.gen.manual_seed(int(seed))

    def get_state(self):
        return {'torch_generator_state': generator_state(self.gen)}

    def set_state(self, state):
        self.gen.set_state(torch.from_numpy(
            np.asarray(state['torch_generator_state'], np.uint8).copy()))

    def spawn(self, n):
        """`n` generators, one per Markov chain, seeded from the next
        n + 1 draws of this one, which is then reseeded with the last:
        later draws never repeat a chain's stream (the JAX package splits
        n + 1 keys and keeps the last, multichain.py:211-216)."""
        seeds = torch.randint(0, 2 ** 62, (n + 1,), generator=self.gen,
                              device=self.device).tolist()
        self.gen.manual_seed(seeds[n])
        return [torch.Generator(device=self.device).manual_seed(s)
                for s in seeds[:n]]

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x, np.float64),
                               dtype=self.dtype, device=self.device)

    # Eager convenience wrappers for chain initialization (host out); the
    # Gibbs step calls the functional samplers directly with `gen`.

    def polya_gamma(self, shape, tilt):
        tilt = tilt if isinstance(tilt, torch.Tensor) else self._tensor(tilt)
        return sample_polya_gamma(self.gen, shape, tilt).cpu().numpy()

    def tilted_stable(self, char_exponent, tilt):
        return sample_tilted_stable(self.gen, char_exponent,
                                    self._tensor(tilt)).cpu().numpy()

    def normal(self, size):
        """`size` standard normal draws (basic.py:62-63), numpy."""
        return torch.randn((size,), generator=self.gen, dtype=self.dtype,
                           device=self.device).cpu().numpy()

    def uniform(self, size=()):
        """Uniform(0, 1) draws of shape `size` (basic.py:65-66), numpy."""
        return torch.rand(size, generator=self.gen, dtype=self.dtype,
                          device=self.device).cpu().numpy()

    def gamma(self, a, size=()):
        """Gamma(a, 1) draws of shape `size` (basic.py:68-69), numpy (a
        0-d array for the default size)."""
        size = tuple(int(s) for s in np.atleast_1d(size)) \
            if np.size(size) else ()
        draw = torch._standard_gamma(
            torch.full(size or (1,), float(a), dtype=self.dtype,
                       device=self.device), generator=self.gen)
        return draw.reshape(size).cpu().numpy()
