"""JCUDF row ↔ column conversion (the port's counterpart of
``spark_rapids_jni_tpu.rowconv``)."""

from .layout import (  # noqa: F401
    JCUDF_ROW_ALIGNMENT, MAX_ROW_SIZE, MAX_BATCH_BYTES,
    RowLayout, compute_row_layout, build_batches,
)
from .convert import convert_to_rows, convert_from_rows, RowBatch  # noqa: F401
