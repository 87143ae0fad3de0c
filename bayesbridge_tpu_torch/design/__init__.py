from .abstract import AbstractDesignMatrix
from .sparse import SparseDesignMatrix

__all__ = ['AbstractDesignMatrix', 'SparseDesignMatrix']
