from .dataframe import DataFrame, Row

__all__ = ["DataFrame", "Row"]
