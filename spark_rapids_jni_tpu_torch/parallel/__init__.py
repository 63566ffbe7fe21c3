"""Multi-device execution of the PyTorch port: meshes, the row shuffle,
the distributed star aggregate and the repartition join (the port's
copy of the JAX package's ``parallel/``; see ``mesh.py`` for how a
single-controller SPMD program maps onto torch devices)."""

from .mesh import Mesh, make_2d_mesh, make_mesh  # noqa: F401
from .shuffle import all_to_all_shuffle, bucketize_rows  # noqa: F401
from .repartition_join import (JoinAggSpec,  # noqa: F401
                               repartition_join_agg,
                               repartition_join_agg_auto)
