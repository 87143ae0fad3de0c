from .factory import RegressionModel
from .linear import LinearModel
from .logistic import LogisticModel

__all__ = ['RegressionModel', 'LinearModel', 'LogisticModel']
