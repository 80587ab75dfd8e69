from .core import Normal, Product, TupleProduct, Uniform, product_distribution

__all__ = ["Normal", "Product", "TupleProduct", "Uniform", "product_distribution"]
