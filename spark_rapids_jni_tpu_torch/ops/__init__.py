"""The columnar op library of the port: the counterparts of the JAX
package's ``ops`` modules, every one of them (cast, filter, sort,
strings, decimal128, groupby with its grouping sets, reductions, scans,
windows, copying, hashing, and the join engine: ``join`` and
``join_plan``), exported under the JAX package's names."""

from . import decimal128, hashing, strings, window  # noqa: F401
from .cast import cast  # noqa: F401
from .filter import (apply_boolean_mask, fill_null, gather,  # noqa: F401
                     isin, mask_table)
from .copying import concat_tables, slice_table  # noqa: F401
from .groupby import (distinct, groupby_aggregate,  # noqa: F401
                      groupby_cube, groupby_grouping_sets, groupby_nunique,
                      groupby_rollup)
from .join import (anti_join, full_outer_join, inner_join,  # noqa: F401
                   join_indices, left_join, right_join, semi_join)
from . import join_plan  # noqa: F401
from .join_plan import join_aggregate  # noqa: F401
from .scan import (cumulative_count, cumulative_max,  # noqa: F401
                   cumulative_min, cumulative_sum)
from .reductions import max_, mean, min_, sum_, valid_count  # noqa: F401
from .sort import order_by, sort_table  # noqa: F401
