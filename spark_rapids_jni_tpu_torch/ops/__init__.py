"""The columnar op library of the port: the counterparts of the JAX
package's ``ops`` modules that TPC-H Q1 and its neighbours need (filter,
sort, the string-key subset of strings, decimal128, groupby, reductions,
copying, hashing)."""

from . import decimal128, hashing, strings  # noqa: F401
from .copying import concat_tables, slice_table  # noqa: F401
from .filter import (apply_boolean_mask, fill_null, gather,  # noqa: F401
                     isin, mask_table)
from .groupby import distinct, groupby_aggregate  # noqa: F401
from .reductions import max_, mean, min_, sum_, valid_count  # noqa: F401
from .sort import order_by, sort_table  # noqa: F401
