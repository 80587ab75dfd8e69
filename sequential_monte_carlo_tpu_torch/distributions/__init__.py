from .core import (
    LogNormal,
    Normal,
    Product,
    TruncatedNormal,
    TupleProduct,
    Uniform,
    product_distribution,
)
from .mvnormal import MvNormal

__all__ = [
    "LogNormal",
    "MvNormal",
    "Normal",
    "Product",
    "TruncatedNormal",
    "TupleProduct",
    "Uniform",
    "product_distribution",
]
