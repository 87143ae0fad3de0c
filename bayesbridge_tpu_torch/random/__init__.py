from .basic import BasicRandom
from .polya_gamma import sample_polya_gamma, sample_unit_shape_polya_gamma
from .tilted_stable import sample_tilted_stable

__all__ = ['BasicRandom', 'sample_polya_gamma',
           'sample_unit_shape_polya_gamma', 'sample_tilted_stable']
