from .abstract import AbstractDesignMatrix
from .dense import DenseDesignMatrix
from .sparse import SparseDesignMatrix

__all__ = ['AbstractDesignMatrix', 'DenseDesignMatrix', 'SparseDesignMatrix']
