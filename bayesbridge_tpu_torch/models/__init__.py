from .factory import RegressionModel
from .logistic import LogisticModel

__all__ = ['RegressionModel', 'LogisticModel']
